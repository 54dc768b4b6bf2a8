// Self-contained SentencePiece BPE runtime (C++17, no external deps).
//
// Native counterpart of cogview_tpu_torch/tokenization/{spm_proto,normalizer,
// bpe}.py — same algorithms, byte-identical ids — built for preprocessing
// throughput (the Python agenda BPE tops out around 10^5 chars/s; this
// runs tens of MB/s).  The reference consumed Google's C++ sentencepiece
// library (data_utils/sp_tokenizer.py:98-127); this replaces it without
// the dependency.
//
// Exposed via a minimal C ABI (ctypes-friendly): spm_load / spm_encode /
// spm_decode / spm_piece_to_id / spm_vocab_size / spm_free.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <memory>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------------ //
// protobuf wire-format reading (just what ModelProto needs)
// ------------------------------------------------------------------ //

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t r = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      r |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return r;
      shift += 7;
    }
    ok = false;
    return 0;
  }
};

constexpr int kPieceNormal = 1;
constexpr int kPieceUnknown = 2;
constexpr int kPieceControl = 3;
constexpr int kPieceUserDefined = 4;

struct Model {
  std::vector<std::string> pieces;
  std::vector<float> scores;
  std::vector<int> types;
  std::unordered_map<std::string, int> piece_to_id;  // first occurrence
  // merge candidates: NORMAL pieces only -> (score, id)
  std::unordered_map<std::string, std::pair<float, int>> merges;
  std::vector<int> user_defined;  // ids, longest piece first
  int unk_id = 0;

  // normalizer
  std::vector<uint32_t> trie;
  std::string pool;
  bool add_dummy_prefix = true;
  bool remove_extra_ws = true;
  bool escape_ws = true;
};

void parse_piece(Model& m, const uint8_t* p, const uint8_t* end) {
  Reader r{p, end};
  std::string piece;
  float score = 0.f;
  int type = kPieceNormal;
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    int fnum = int(key >> 3), wt = int(key & 7);
    if (wt == 0) {
      uint64_t v = r.varint();
      if (fnum == 3) type = int(v);
    } else if (wt == 2) {
      uint64_t len = r.varint();
      if (fnum == 1) piece.assign(reinterpret_cast<const char*>(r.p), len);
      r.p += len;
    } else if (wt == 5) {
      float f;
      std::memcpy(&f, r.p, 4);
      if (fnum == 2) score = f;
      r.p += 4;
    } else if (wt == 1) {
      r.p += 8;
    } else {
      return;
    }
  }
  int id = int(m.pieces.size());
  m.pieces.push_back(piece);
  m.scores.push_back(score);
  m.types.push_back(type);
  m.piece_to_id.emplace(piece, id);
  if (type == kPieceNormal) m.merges.emplace(std::move(piece), std::make_pair(score, id));
}

void parse_trainer(Model& m, const uint8_t* p, const uint8_t* end) {
  Reader r{p, end};
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    int fnum = int(key >> 3), wt = int(key & 7);
    if (wt == 0) {
      uint64_t v = r.varint();
      if (fnum == 40) m.unk_id = int(v);
    } else if (wt == 2) {
      r.p += r.varint();
    } else if (wt == 5) {
      r.p += 4;
    } else if (wt == 1) {
      r.p += 8;
    } else {
      return;
    }
  }
}

void parse_normalizer(Model& m, const uint8_t* p, const uint8_t* end) {
  Reader r{p, end};
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    int fnum = int(key >> 3), wt = int(key & 7);
    if (wt == 0) {
      uint64_t v = r.varint();
      if (fnum == 3) m.add_dummy_prefix = v;
      if (fnum == 4) m.remove_extra_ws = v;
      if (fnum == 5) m.escape_ws = v;
    } else if (wt == 2) {
      uint64_t len = r.varint();
      if (fnum == 2 && len >= 4) {
        uint32_t trie_size;
        std::memcpy(&trie_size, r.p, 4);
        size_t n_units = trie_size / 4;
        m.trie.resize(n_units);
        std::memcpy(m.trie.data(), r.p + 4, trie_size);
        m.pool.assign(reinterpret_cast<const char*>(r.p + 4 + trie_size),
                      len - 4 - trie_size);
      }
      r.p += len;
    } else if (wt == 5) {
      r.p += 4;
    } else if (wt == 1) {
      r.p += 8;
    } else {
      return;
    }
  }
}

// ------------------------------------------------------------------ //
// normalization (darts-clone commonPrefixSearch + nmt whitespace rules)
// ------------------------------------------------------------------ //

// returns matched byte length (0 = no match); *repl -> replacement c-str
int longest_prefix(const Model& m, const char* data, size_t len, const char** repl,
                   size_t* repl_len) {
  if (m.trie.empty()) return 0;
  uint32_t node_pos = 0;
  uint32_t unit = m.trie[node_pos];
  node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6);
  int best_len = 0;
  uint32_t best_val = 0;
  for (size_t i = 0; i < len; ++i) {
    uint8_t c = uint8_t(data[i]);
    node_pos ^= c;
    unit = m.trie[node_pos];
    if ((unit & (0x80000000u | 0xFFu)) != c) break;
    node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6);
    if ((unit >> 8) & 1) {
      best_len = int(i + 1);
      best_val = m.trie[node_pos] & 0x7FFFFFFFu;
    }
  }
  if (best_len == 0) return 0;
  const char* s = m.pool.data() + best_val;
  *repl = s;
  *repl_len = strnlen(s, m.pool.size() - best_val);
  return best_len;
}

int utf8_len(uint8_t b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0b110) return 2;
  if ((b >> 4) == 0b1110) return 3;
  if ((b >> 3) == 0b11110) return 4;
  return 1;
}

const char kSpaceSym[] = "\xe2\x96\x81";  // U+2581

std::string normalize(const Model& m, const std::string& in) {
  std::string flat;
  flat.reserve(in.size() + 8);
  size_t i = 0;
  while (i < in.size()) {
    const char* repl;
    size_t rlen;
    int mlen = longest_prefix(m, in.data() + i, in.size() - i, &repl, &rlen);
    if (mlen > 0) {
      flat.append(repl, rlen);
      i += mlen;
    } else {
      int cl = utf8_len(uint8_t(in[i]));
      flat.append(in, i, cl);
      i += cl;
    }
  }
  // whitespace policy
  std::string out;
  out.reserve(flat.size() + 4);
  if (m.remove_extra_ws) {
    // collapse runs of ' ' and strip both ends
    std::string c;
    c.reserve(flat.size());
    bool prev_sp = true;  // strips leading
    for (char ch : flat) {
      if (ch == ' ') {
        if (!prev_sp) c.push_back(' ');
        prev_sp = true;
      } else {
        c.push_back(ch);
        prev_sp = false;
      }
    }
    while (!c.empty() && c.back() == ' ') c.pop_back();
    flat.swap(c);
  }
  if (flat.empty()) return out;  // empty input -> no pieces (spm behavior)
  if (m.add_dummy_prefix) flat.insert(flat.begin(), ' ');
  if (m.escape_ws) {
    for (char ch : flat) {
      if (ch == ' ')
        out.append(kSpaceSym, 3);
      else
        out.push_back(ch);
    }
    return out;
  }
  return flat;
}

// ------------------------------------------------------------------ //
// agenda BPE
// ------------------------------------------------------------------ //

struct Agenda {
  float score;
  int left;
  uint32_t size_l, size_r;  // revalidation stamps
  bool operator<(const Agenda& o) const {
    // priority_queue pops the largest: highest score, then leftmost
    if (score != o.score) return score < o.score;
    return left > o.left;
  }
};

void encode_ids(const Model& m, const std::string& text, std::vector<int>& out) {
  std::string norm = normalize(m, text);
  if (norm.empty()) return;

  // initial symbols: user-defined longest-match, else single utf8 chars
  struct Sym {
    uint32_t start, len;
    int prev, next;
    bool alive;
  };
  std::vector<Sym> syms;
  syms.reserve(norm.size());
  {
    size_t i = 0;
    while (i < norm.size()) {
      int adv = 0;
      for (int ud : m.user_defined) {
        const std::string& piece = m.pieces[ud];
        if (piece.size() <= norm.size() - i &&
            std::memcmp(piece.data(), norm.data() + i, piece.size()) == 0) {
          adv = int(piece.size());
          break;
        }
      }
      if (adv == 0) adv = utf8_len(uint8_t(norm[i]));
      syms.push_back({uint32_t(i), uint32_t(adv), int(syms.size()) - 1,
                      int(syms.size()) + 1, true});
      i += adv;
    }
    if (!syms.empty()) syms.back().next = -1;
  }

  std::priority_queue<Agenda> heap;
  std::string buf;
  auto try_pair = [&](int l) {
    int r = syms[l].next;
    if (r < 0) return;
    buf.assign(norm, syms[l].start, syms[l].len + syms[r].len);
    auto it = m.merges.find(buf);
    if (it != m.merges.end())
      heap.push({it->second.first, l, syms[l].len, syms[r].len});
  };
  for (int i = 0; i + 1 < int(syms.size()); ++i) try_pair(i);

  while (!heap.empty()) {
    Agenda a = heap.top();
    heap.pop();
    Sym& L = syms[a.left];
    if (!L.alive || L.len != a.size_l) continue;
    int r = L.next;
    if (r < 0 || !syms[r].alive || syms[r].len != a.size_r) continue;
    // merge r into left
    L.len += syms[r].len;
    syms[r].alive = false;
    L.next = syms[r].next;
    if (L.next >= 0) syms[L.next].prev = a.left;
    if (L.prev >= 0) try_pair(L.prev);
    try_pair(a.left);
  }

  for (int i = 0; i != -1; i = syms[i].next) {
    if (!syms[i].alive) continue;
    buf.assign(norm, syms[i].start, syms[i].len);
    auto it = m.piece_to_id.find(buf);
    out.push_back(it != m.piece_to_id.end() ? it->second : m.unk_id);
  }
}

std::string decode_ids(const Model& m, const int* ids, int n) {
  std::string joined;
  for (int i = 0; i < n; ++i) {
    int t = ids[i];
    if (t < 0 || t >= int(m.pieces.size())) continue;
    int ty = m.types[t];
    if (ty == kPieceControl) continue;
    if (ty == kPieceUnknown) {
      joined += " \xe2\x81\x87 ";  // " ⁇ " default unk surface
    } else {
      joined += m.pieces[t];
    }
  }
  // U+2581 -> ' ', strip one leading space
  std::string out;
  out.reserve(joined.size());
  size_t i = 0;
  while (i < joined.size()) {
    if (i + 2 < joined.size() && std::memcmp(joined.data() + i, kSpaceSym, 3) == 0) {
      out.push_back(' ');
      i += 3;
    } else {
      out.push_back(joined[i]);
      ++i;
    }
  }
  if (!out.empty() && out[0] == ' ') out.erase(out.begin());
  return out;
}

}  // namespace

// ------------------------------------------------------------------ //
// C ABI
// ------------------------------------------------------------------ //

extern "C" {

void* spm_load(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  std::string blob((std::istreambuf_iterator<char>(f)),
                   std::istreambuf_iterator<char>());
  auto m = std::make_unique<Model>();
  Reader r{reinterpret_cast<const uint8_t*>(blob.data()),
           reinterpret_cast<const uint8_t*>(blob.data()) + blob.size()};
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    int fnum = int(key >> 3), wt = int(key & 7);
    if (wt == 2) {
      uint64_t len = r.varint();
      const uint8_t* sub = r.p;
      if (fnum == 1)
        parse_piece(*m, sub, sub + len);
      else if (fnum == 2)
        parse_trainer(*m, sub, sub + len);
      else if (fnum == 3)
        parse_normalizer(*m, sub, sub + len);
      r.p += len;
    } else if (wt == 0) {
      r.varint();
    } else if (wt == 5) {
      r.p += 4;
    } else if (wt == 1) {
      r.p += 8;
    } else {
      break;
    }
  }
  // user-defined pieces sorted longest-first for greedy prefix matching
  for (int i = 0; i < int(m->pieces.size()); ++i)
    if (m->types[i] == kPieceUserDefined) m->user_defined.push_back(i);
  std::sort(m->user_defined.begin(), m->user_defined.end(),
            [&](int a, int b) { return m->pieces[a].size() > m->pieces[b].size(); });
  return m.release();
}

int spm_vocab_size(void* model) {
  return int(static_cast<Model*>(model)->pieces.size());
}

// returns number of ids (may exceed max_out; only max_out are written)
int spm_encode(void* model, const char* text, int32_t* out_ids, int max_out) {
  std::vector<int> ids;
  encode_ids(*static_cast<Model*>(model), text, ids);
  int n = int(ids.size());
  for (int i = 0; i < n && i < max_out; ++i) out_ids[i] = ids[i];
  return n;
}

// returns bytes written (excl. NUL); buffer always NUL-terminated
int spm_decode(void* model, const int32_t* ids, int n, char* out, int max_out) {
  std::string s = decode_ids(*static_cast<Model*>(model), ids, n);
  int w = int(s.size() < size_t(max_out - 1) ? s.size() : size_t(max_out - 1));
  std::memcpy(out, s.data(), w);
  out[w] = 0;
  return int(s.size());
}

int spm_piece_to_id(void* model, const char* piece) {
  auto* m = static_cast<Model*>(model);
  auto it = m->piece_to_id.find(piece);
  return it != m->piece_to_id.end() ? it->second : -1;
}

void spm_free(void* model) { delete static_cast<Model*>(model); }

}  // extern "C"
