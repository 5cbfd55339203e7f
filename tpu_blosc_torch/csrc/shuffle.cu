// Per-block byte shuffle and unshuffle for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels byte_plane_split and byte_plane_merge
// (tpu_blosc/filters/pallas_kernels.py:292-333), and with them the XLA
// SWAR and u8 shuffle bodies of tpu_blosc/filters/batched.py, which carry
// type sizes 8, 16 and odd sizes on the TPU.  One kernel serves every
// type size from 2 up to the block size.
//
// For each block b of bs bytes, element i < bs/ts and byte c < ts:
//
//     shuffle:    dst[b*bs + c*(bs/ts) + i] = src[b*bs + i*ts + c]
//     unshuffle:  the inverse; a block whose keep_raw[b] is non-zero is
//                 copied verbatim (it was stored raw in the frame).
//
// Both are a batched byte transpose: shuffle transposes each block seen as
// an (bs/ts) x ts byte matrix, unshuffle each block seen as ts x (bs/ts).
//
// What bounds it: it computes nothing, so device-memory bytes bound it,
// 2*n bytes per pass (each byte read once and written once).  A naive
// element loop reads or writes with a stride of ts or bs/ts bytes and
// wastes most of every 32-byte sector.  So a thread block stages a tile of
// up to 16 KiB in shared memory: it loads the tile's rows, which lie
// contiguous in device memory, and stores its columns, which lie contiguous
// in the output, so both sides are coalesced.  The row pitch in shared
// memory is odd, which spreads a column's bytes over the banks.  The tile
// is at most 256 bytes along the type-size axis, so any ts fits in under
// 48 KiB of shared memory without an opt-in; ragged tiles at a block's
// edge are masked.  Offsets are 64-bit: a frame may pass 2^31 bytes.
//
// Each launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTileBytes = 16384;
constexpr int64_t kMaxEdge = 256;
constexpr int64_t kMaxGrid = int64_t{1} << 20;

// Matrix b (of nb) is rows x cols bytes at src + b*rows*cols, row-major;
// its transpose (cols x rows) goes to dst + b*rows*cols.  Tiles of
// tr x tc bytes; grid-stride over all tiles of all matrices.
__global__ void __launch_bounds__(kThreads)
transpose_blocks(const uint8_t *__restrict__ src, uint8_t *__restrict__ dst,
                 const uint8_t *__restrict__ keep_raw, int64_t nb,
                 int64_t rows, int64_t cols, int tr, int tc) {
  extern __shared__ uint8_t tile[];
  const int pitch = tc | 1;
  const int64_t tiles_c = (cols + tc - 1) / tc;
  const int64_t per_mat = ((rows + tr - 1) / tr) * tiles_c;
  const int64_t mat = rows * cols;
  for (int64_t t = blockIdx.x; t < nb * per_mat; t += gridDim.x) {
    const int64_t b = t / per_mat;
    const int64_t rem = t - b * per_mat;
    const int64_t r0 = rem / tiles_c * tr;
    const int64_t c0 = rem % tiles_c * tc;
    const int h = rows - r0 < tr ? (int)(rows - r0) : tr;
    const int w = cols - c0 < tc ? (int)(cols - c0) : tc;
    const int n = h * w;
    const uint8_t *s = src + b * mat;
    uint8_t *d = dst + b * mat;
    if (keep_raw != nullptr && keep_raw[b]) {
      // a raw block: this tile's bytes pass through in place (b is the
      // same for the whole thread block, so no thread skips a barrier)
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int64_t i = (r0 + k / w) * cols + c0 + k % w;
        d[i] = s[i];
      }
      continue;
    }
    // load: k walks the tile row by row (contiguous in src)
    {
      int r = threadIdx.x / w, c = threadIdx.x % w;
      const int dr = blockDim.x / w, dc = blockDim.x % w;
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        tile[r * pitch + c] = s[(r0 + r) * cols + c0 + c];
        r += dr;
        c += dc;
        if (c >= w) {
          c -= w;
          ++r;
        }
      }
    }
    __syncthreads();
    // store: k walks the tile column by column (contiguous in dst)
    {
      int c = threadIdx.x / h, r = threadIdx.x % h;
      const int dc = blockDim.x / h, dr = blockDim.x % h;
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        d[(c0 + c) * rows + r0 + r] = tile[r * pitch + c];
        c += dc;
        r += dr;
        if (r >= h) {
          r -= h;
          ++c;
        }
      }
    }
    __syncthreads();
  }
}

int launch(const void *src, void *dst, const void *keep_raw, int64_t nb,
           int64_t rows, int64_t cols, int64_t tr, int64_t tc,
           void *stream) {
  const int64_t tiles = nb * ((rows + tr - 1) / tr) * ((cols + tc - 1) / tc);
  const unsigned grid = (unsigned)std::min(tiles, kMaxGrid);
  const size_t smem = (size_t)tr * (size_t)(tc | 1);
  transpose_blocks<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t *)src, (uint8_t *)dst, (const uint8_t *)keep_raw, nb,
      rows, cols, (int)tr, (int)tc);
  return (int)cudaGetLastError();
}

bool bad_geometry(int64_t nb, int64_t bs, int64_t ts) {
  return nb < 0 || ts < 2 || bs < ts || bs % ts != 0;
}

}  // namespace

extern "C" {

// src, dst: nb*bs bytes on the device, not overlapping.
int tpbt_shuffle_blocks(const void *src, void *dst, int64_t nb, int64_t bs,
                        int64_t ts, void *stream) {
  if (bad_geometry(nb, bs, ts)) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const int64_t ne = bs / ts;
  const int64_t tc = std::min(ts, kMaxEdge);
  const int64_t tr = std::min(ne, kTileBytes / tc);
  return launch(src, dst, nullptr, nb, ne, ts, tr, tc, stream);
}

// keep_raw: nb bytes on the device (non-zero = copy block b verbatim), or
// null when no block was stored raw.
int tpbt_unshuffle_blocks(const void *src, void *dst, const void *keep_raw,
                          int64_t nb, int64_t bs, int64_t ts, void *stream) {
  if (bad_geometry(nb, bs, ts)) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const int64_t ne = bs / ts;
  const int64_t tr = std::min(ts, kMaxEdge);
  const int64_t tc = std::min(ne, kTileBytes / tr);
  return launch(src, dst, keep_raw, nb, ts, ne, tr, tc, stream);
}

}  // extern "C"
