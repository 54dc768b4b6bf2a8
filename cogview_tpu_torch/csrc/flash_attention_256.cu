// Flash attention, forward and backward, at the tile width 256, with the
// head dim and the copy width at run time: the kernels of
// flash_attention.cuh, the C entry points of flash_attention_api.cuh.  A
// library of its own, so that its nvcc runs beside the other flash
// libraries' (ops/_kernels.py build_all).

#include "flash_attention.cuh"

namespace {

// whether this library holds the kernels for D == the tile width with
// 16-byte copies (ops/flash_attention.py EXACT_LIBRARY) or the run-time ones
constexpr bool EXACT_TILES = false;

// f(std::integral_constant<int, DT>) for the tile widths this library is
// built for (ops/flash_attention.py LIBRARIES; a CPU test parses this
// switch)
template <typename F>
cudaError_t with_tile_width(int tile, F&& f) {
  switch (tile) {
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#include "flash_attention_api.cuh"
