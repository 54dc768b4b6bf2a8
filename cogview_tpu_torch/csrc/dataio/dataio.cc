// Native corpus reader + batch assembler (C++17).
//
// Counterpart of cogview_tpu_torch/data/{datasets,loader}.py for the
// CompactBinary format (fixed-length int32 rows: 64 text ids padded with
// -1, then 1024 image codes — the reference's production training format,
// data_utils/datasets.py:63-81).  mmap's the corpus and assembles padded
// {text, loss_mask} training batches with the TextCode template expansion
// ([ROI1] text [SIZE][BOI1] code [EOI1] [PAD]...), multithreaded across
// samples.  The Python BatchIterator drives it with precomputed shuffled
// indices, writing straight into numpy-owned buffers (zero copies).

#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Corpus {
  const int32_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t n_samples = 0;
  int length_per_sample = 0;
  int fd = -1;
};

struct TemplateIds {
  int32_t roi1, boi1, eoi1, pad;
  int32_t size_base;  // [BASE]/[BIG]... picked by code length
};

void fill_one(const Corpus& c, int64_t sample_idx, int text_region, int max_len,
              const TemplateIds& t, int32_t* text_out, float* mask_out) {
  const int32_t* row = c.data + sample_idx * c.length_per_sample;
  int code_len = c.length_per_sample - text_region;

  int pos = 0;
  text_out[pos++] = t.roi1;
  for (int i = 0; i < text_region && pos < max_len; ++i) {
    if (row[i] > -1) text_out[pos++] = row[i];
  }
  if (pos < max_len) text_out[pos++] = t.size_base;
  if (pos < max_len) text_out[pos++] = t.boi1;
  for (int i = 0; i < code_len && pos < max_len; ++i)
    text_out[pos++] = row[text_region + i];
  if (pos < max_len) text_out[pos++] = t.eoi1;

  for (int i = 0; i < pos; ++i) mask_out[i] = 1.0f;
  for (int i = pos; i < max_len; ++i) {
    text_out[i] = t.pad;
    mask_out[i] = 0.0f;
  }
}

}  // namespace

extern "C" {

void* dio_open(const char* path, int length_per_sample) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(p, st.st_size, MADV_RANDOM);
  auto* c = new Corpus();
  c->data = static_cast<const int32_t*>(p);
  c->file_bytes = size_t(st.st_size);
  c->length_per_sample = length_per_sample;
  c->n_samples = int64_t(st.st_size / sizeof(int32_t)) / length_per_sample;
  c->fd = fd;
  return c;
}

int64_t dio_num_samples(void* h) { return static_cast<Corpus*>(h)->n_samples; }

// Assemble a batch.  indices: [batch] sample ids; outputs text[batch,max_len]
// int32 and mask[batch,max_len] float32 (caller-allocated, C-contiguous).
// Returns 0 on success.
int dio_fill_batch(void* h, const int64_t* indices, int batch, int text_region,
                   int max_len, int32_t roi1, int32_t size_base, int32_t boi1,
                   int32_t eoi1, int32_t pad, int32_t* text_out,
                   float* mask_out, int n_threads) {
  auto* c = static_cast<Corpus*>(h);
  TemplateIds t{roi1, boi1, eoi1, pad, size_base};
  for (int b = 0; b < batch; ++b)
    if (indices[b] < 0 || indices[b] >= c->n_samples) return -1;

  auto work = [&](int start, int stride) {
    for (int b = start; b < batch; b += stride)
      fill_one(*c, indices[b], text_region, max_len, t,
               text_out + int64_t(b) * max_len, mask_out + int64_t(b) * max_len);
  };
  if (n_threads <= 1 || batch < 4) {
    work(0, 1);
  } else {
    std::vector<std::thread> ts;
    for (int i = 0; i < n_threads; ++i) ts.emplace_back(work, i, n_threads);
    for (auto& th : ts) th.join();
  }
  return 0;
}

void dio_close(void* h) {
  auto* c = static_cast<Corpus*>(h);
  if (c->data) munmap(const_cast<int32_t*>(c->data), c->file_bytes);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"
