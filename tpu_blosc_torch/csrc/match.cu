// Literal mask of the match strategy for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel match_select_open_nibble (_make_match_kernel,
// tpu_blosc/filters/pallas_kernels.py:343-497).  For each row r of nseg
// filtered segments of seg bytes, with the row's chosen match offset
// d = row_d[r] >= 1, tail forced literals and minimum run length T:
//
//     eq[p]    = x[p] == x[p-d]          for d <= p < seg - tail, else 0
//     er[p]    = AND_{s<T} eq[p+s]       (erosion; eq past seg is 0)
//     match[p] = OR_{s<T}  er[p-s]       (dilation; er before 0 is 0)
//     out[r*seg/4 + j] bit t = !match[4j+t], t < 4 (one nibble a word)
//
// A row with d < 1 has no matches (every byte literal).
//
// The TPU kernel computes eq for all 20 candidate offsets and selects one
// with `where`, because Mosaic needs static shifts; it builds each shift
// from lane-slice concatenations and gates on seg % 16384 == 0 and
// d <= 2044.  Here d is a runtime value read by each thread block, so eq
// is computed for that one offset, and any seg % 4 == 0 and any d work.
//
// What bounds it: bytes.  Each input byte is read twice (x[p] and
// x[p-d], the second mostly from L1/L2) and a quarter byte is written.
// A thread block takes one tile of kTile positions of one row, computes eq
// over the tile plus a halo of kHalo >= T-1 on both sides into shared
// memory, then the erosion into shared memory, then writes one nibble per
// 4 positions.  Consecutive threads touch consecutive bytes on every
// global access, so loads and stores coalesce.  Tiles are independent:
// the grid strides over (row, tile) pairs, so no launch dimension limits
// nseg, and offsets are 64-bit.
//
// The launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // positions of one row per tile
constexpr int kHalo = 8;     // >= T - 1 on each side
constexpr int kMaxT = kHalo + 1;
constexpr int64_t kMaxGrid = int64_t{1} << 20;

__global__ void __launch_bounds__(kThreads)
match_nibble(const uint8_t *__restrict__ segs, const int32_t *__restrict__ row_d,
             uint8_t *__restrict__ out, int64_t nseg, int64_t seg, int64_t tail,
             int T) {
  __shared__ uint8_t eq[kTile + 2 * kHalo];
  __shared__ uint8_t er[kTile + kHalo];
  const int64_t tiles = (seg + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < nseg * tiles; t += gridDim.x) {
    const int64_t r = t / tiles;
    const int64_t p0 = (t - r * tiles) * kTile;
    const uint8_t *x = segs + r * seg;
    const int64_t d = row_d[r];
    const int64_t lim = seg - tail;
    // eq at p = p0 - kHalo + k
    for (int k = threadIdx.x; k < kTile + 2 * kHalo; k += kThreads) {
      const int64_t p = p0 - kHalo + k;
      eq[k] = d >= 1 && p >= d && p < lim && x[p] == x[p - d];
    }
    __syncthreads();
    // er at p = p0 - kHalo + k reads eq[k .. k+T-1]
    for (int k = threadIdx.x; k < kTile + kHalo; k += kThreads) {
      uint8_t a = 1;
      for (int s = 0; s < T; ++s) a &= eq[k + s];
      er[k] = a;
    }
    __syncthreads();
    // match at q = p0 + j reads er[kHalo + j - s], s < T
    const int nq = seg - p0 < kTile ? (int)(seg - p0) : kTile;
    uint8_t *o = out + r * (seg / 4) + p0 / 4;
    for (int i = threadIdx.x; i < nq / 4; i += kThreads) {
      unsigned nib = 0;
      for (int b = 0; b < 4; ++b) {
        const int j = kHalo + 4 * i + b;
        uint8_t m = 0;
        for (int s = 0; s < T; ++s) m |= er[j - s];
        nib |= (unsigned)(m == 0) << b;
      }
      o[i] = (uint8_t)nib;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// segs: nseg*seg bytes on the device; row_d: nseg int32 on the device;
// out: nseg*seg/4 bytes on the device.  seg % 4 == 0, 1 <= T <= 9.
int tpbt_match_nibble(const void *segs, const void *row_d, void *out,
                      int64_t nseg, int64_t seg, int64_t tail, int64_t T,
                      void *stream) {
  if (nseg < 0 || seg < 4 || seg % 4 != 0 || tail < 0 || T < 1 || T > kMaxT)
    return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  const int64_t tiles = nseg * ((seg + kTile - 1) / kTile);
  const unsigned grid = (unsigned)std::min(tiles, kMaxGrid);
  match_nibble<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)segs, (const int32_t *)row_d, (uint8_t *)out, nseg,
      seg, tail, (int)T);
  return (int)cudaGetLastError();
}

}  // extern "C"
