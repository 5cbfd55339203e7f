// The device half of the rle strategy for NVIDIA Hopper (sm_90a): the run
// count of every filtered segment, and the run records of chosen segments.
//
// Rows are nseg filtered segments of seg bytes.  A byte starts a run when
// it is a row's first byte or differs from the byte before it in its row,
// so runs never join across a row edge.
//
// tpbt_seg_run_counts replaces the count of _device_filter_seg_counts
// (tpu_blosc/device.py:165-181), an XLA compare-and-sum over the filtered
// batch (the filter before it is the shuffle or the bit-shuffle kernel):
//
//     counts[r] = #{p : p == 0 or x[r, p] != x[r, p-1]}
//
// tpbt_rows_rle replaces _device_rows_rle (tpu_blosc/device.py:184-207), an
// XLA gather, nonzero(size=cap) and diff.  For the k chosen rows, in the
// order given, every run's byte and length:
//
//     vals[bases[j] + g] = x[rows[j], s_g]       s_g: the row's g-th start
//     lens[bases[j] + g] = s_{g+1} - s_g         the last run ends at seg
//
// bases[j] is the exclusive sum of the chosen rows' run counts, which the
// caller has from the count kernel; bases has k + 1 entries.  The TPU
// program pads the row list to a power of two and the records to a
// compile-time cap; here the counts give every row its place, so nothing
// is padded.  A row whose starts are not bases[j+1] - bases[j] sets *bad
// and writes no record outside its place.
//
// Both kernels turn 16 bytes into 16 start bits with word arithmetic: the
// word against itself shifted up one byte (the byte before it shifted in),
// an exact non-zero-byte test, and one multiply that folds the four flags
// into a nibble.
//
// What bounds the count kernel: bytes (the stream read once, 4 bytes a row
// written).  One thread block takes a tile of 16384 bytes of one row, four
// 16-byte loads a thread straight from device memory (neighbouring
// threads, neighbouring addresses; nothing is read twice but the one byte
// before each 16, a cache hit), a popcount, one warp reduction and one
// atomic add per warp into the zeroed counts.
//
// What bounds the rows kernel: bytes too (the chosen rows read once, 5
// bytes a run written), but a row is one dependency chain: a run's place
// depends on every start before it.  One thread block walks one row in
// tiles of 4096 bytes: flag the starts, scan the per-thread counts in the
// block (shuffles within a warp, eight warp sums through shared memory;
// no library scan), carry the row's count from tile to tile, and write
// each start's byte to vals and its position to lens.  A run that crosses
// a tile edge needs the next tile's first start, so the lengths are made
// in a second sweep over the row's compacted positions, in place:
// lens[g] = lens[g+1] - lens[g].  Rows run in parallel, one block each.
//
// Each launcher takes one of two paths, which the caller names
// (filters/kernels.py rle_path):
//
// vec16: seg % 16 == 0 and the rows on 16-byte boundaries: 16-byte loads.
// generic: any seg >= 1 and any alignment: byte loads into the same words.
//
// Each launcher checks the named path's preconditions and returns
// cudaErrorInvalidValue when they do not hold (it never takes the other
// path instead), runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

enum Path { kGeneric = 0, kVec16 = 1 };

constexpr int kThreads = 256;
constexpr int kChunk = 16;                      // bytes a thread takes at once
constexpr int kRowsTile = kThreads * kChunk;    // the rows kernel's tile
constexpr int kCountChunks = 4;                 // chunks a thread, count kernel
constexpr int kCountTile = kCountChunks * kRowsTile;
constexpr int64_t kMaxGrid = int64_t{1} << 20;

// Bit b = byte b of w differs from the byte before it; the byte before
// byte 0 is prev (in bits 0..7).
__device__ __forceinline__ uint32_t differs(uint32_t w, uint32_t prev) {
  const uint32_t x = w ^ ((w << 8) | prev);
  // 0x80 in each non-zero byte of x (exact), folded to bits 0..3: the
  // products of 2^7, 2^15, 2^23 and 2^31 with 2^21, 2^14, 2^7 and 1 fall
  // on different bits, those at bits 28..31 are the four wanted
  const uint32_t nz = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (nz * 0x00204081u) >> 28;
}

// Bit i = position p + i of the row x starts a run, for the positions of
// [p, p + 16) below seg; 0 <= p < seg.  On the vec16 path p, seg and x are
// multiples of 16.
template <bool kVec>
__device__ __forceinline__ uint32_t start_flags(const uint8_t *x, int p,
                                                int seg) {
  const int live = min(seg - p, kChunk);
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  if (kVec) {
    const uint4 v = *(const uint4 *)(x + p);
    w0 = v.x, w1 = v.y, w2 = v.z, w3 = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const uint32_t b = i < live ? (uint32_t)x[p + i] << (8 * (i & 3)) : 0u;
      if (i < 4)
        w0 |= b;
      else if (i < 8)
        w1 |= b;
      else if (i < 12)
        w2 |= b;
      else
        w3 |= b;
    }
  }
  // a row's first byte starts a run: the byte before it is made unlike it
  const uint32_t prev = p > 0 ? (uint32_t)x[p - 1] : (~w0 & 0xffu);
  const uint32_t flags = differs(w0, prev) | differs(w1, w0 >> 24) << 4 |
                         differs(w2, w1 >> 24) << 8 |
                         differs(w3, w2 >> 24) << 12;
  return live >= kChunk ? flags : flags & ((1u << live) - 1u);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
seg_run_counts(const uint8_t *__restrict__ segs, int32_t *__restrict__ counts,
               int64_t nseg, int seg) {
  const int tid = threadIdx.x;
  const int64_t tiles = (seg + kCountTile - 1) / kCountTile;
  for (int64_t t = blockIdx.x; t < nseg * tiles; t += gridDim.x) {
    const int64_t r = t / tiles;
    const int p0 = (int)(t - r * tiles) * kCountTile;
    const uint8_t *x = segs + r * seg;
    int c = 0;
#pragma unroll
    for (int k = 0; k < kCountChunks; ++k) {
      const int p = p0 + (k * kThreads + tid) * kChunk;
      if (p < seg) c += __popc(start_flags<kVec>(x, p, seg));
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if ((tid & 31) == 0 && c != 0) atomicAdd(&counts[r], c);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rows_rle(const uint8_t *__restrict__ segs, const int64_t *__restrict__ rows,
         const int64_t *__restrict__ bases, uint8_t *vals, int32_t *lens,
         int32_t *bad, int64_t nseg, int seg, int64_t k) {
  __shared__ int warp_sum[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int64_t j = blockIdx.x; j < k; j += gridDim.x) {
    const int64_t r = rows[j];
    const int64_t base = bases[j];
    const int64_t room = bases[j + 1] - base;  // the runs the row is said to have
    if (r < 0 || r >= nseg || room < 0) {
      if (tid == 0) atomicExch(bad, 1);
      continue;
    }
    const uint8_t *x = segs + r * seg;
    int64_t seen = 0;  // the starts of the tiles before this one
    for (int p0 = 0; p0 < seg; p0 += kRowsTile) {
      const int p = p0 + tid * kChunk;
      uint32_t flags = p < seg ? start_flags<kVec>(x, p, seg) : 0u;
      const int mine = __popc(flags);
      int upto = mine;  // the starts of this warp's threads up to this one
#pragma unroll
      for (int s = 1; s < 32; s *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, upto, s);
        if (lane >= s) upto += v;
      }
      if (lane == 31) warp_sum[warp] = upto;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) {
        const int s = warp_sum[i];
        if (i < warp) before += s;
        total += s;
      }
      __syncthreads();  // every warp_sum is read before the next tile's
      int64_t g = seen + before + upto - mine;
      while (flags) {
        const int i = __ffs(flags) - 1;
        flags &= flags - 1;
        if (g < room) {
          vals[base + g] = x[p + i];
          lens[base + g] = p + i;
        }
        ++g;
      }
      seen += total;
    }
    if (seen != room && tid == 0) atomicExch(bad, 1);
    __syncthreads();  // the row's start positions are all written
    // lens[g] = the next start, or the row's end, less this start; a thread
    // reads both before any thread of its sweep writes
    const int64_t n = seen < room ? seen : room;
    for (int64_t g0 = 0; g0 < n; g0 += kThreads) {
      const int64_t g = g0 + tid;
      int a = 0, b = 0;
      if (g < n) {
        a = lens[base + g];
        b = g + 1 < n ? lens[base + g + 1] : seg;
      }
      __syncthreads();
      if (g < n) lens[base + g] = b - a;
    }
  }
}

// 0 when the geometry and the path may be launched, else the error code
int refuse(const void *segs, int64_t nseg, int64_t seg, int path) {
  // positions are 32-bit, and a tile may reach kCountTile past the row
  const bool geometry =
      nseg >= 0 && seg >= 1 && seg <= INT32_MAX - 2 * kCountTile;
  const bool fits = path == kGeneric || (path == kVec16 && seg % 16 == 0 &&
                                         (uintptr_t)segs % 16 == 0);
  return geometry && fits ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// segs: nseg*seg bytes on the device; counts: nseg int32 on the device,
// zeroed by the caller.  path: 0 generic, 1 vec16.
int tpbt_seg_run_counts(const void *segs, void *counts, int64_t nseg,
                        int64_t seg, int path, void *stream) {
  if (const int rc = refuse(segs, nseg, seg, path)) return rc;
  if (counts == nullptr) return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  const int64_t tiles = (seg + kCountTile - 1) / kCountTile;
  const unsigned grid = (unsigned)std::min(nseg * tiles, kMaxGrid);
  auto kernel = path == kVec16 ? seg_run_counts<true> : seg_run_counts<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)segs, (int32_t *)counts, nseg, (int)seg);
  return (int)cudaGetLastError();
}

// segs: nseg*seg bytes on the device; rows: k int64 on the device, each a
// row of segs; bases: k+1 int64 on the device, ascending from 0, bases[j]
// the first record of rows[j]; vals and lens: bases[k] bytes and int32 on
// the device; bad: one int32 on the device, zeroed by the caller, set to 1
// when a row's runs are not bases[j+1] - bases[j].  path: 0 generic, 1 vec16.
int tpbt_rows_rle(const void *segs, const void *rows, const void *bases,
                  void *vals, void *lens, void *bad, int64_t nseg, int64_t seg,
                  int64_t k, int path, void *stream) {
  if (const int rc = refuse(segs, nseg, seg, path)) return rc;
  if (k < 0 || bad == nullptr) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const unsigned grid = (unsigned)std::min(k, kMaxGrid);
  auto kernel = path == kVec16 ? rows_rle<true> : rows_rle<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)segs, (const int64_t *)rows, (const int64_t *)bases,
      (uint8_t *)vals, (int32_t *)lens, (int32_t *)bad, nseg, (int)seg, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
