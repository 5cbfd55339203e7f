// The device half of the records decode for NVIDIA Hopper (sm_90a): the
// filtered stream rebuilt from literal records.
//
// tpbt_match_fill replaces the scatter and the forward fill of
// _device_match_decode (tpu_blosc/device.py:1248-1357).  Rows are nseg
// segments of seg bytes; row r has one match offset d = row_d[r], and the
// records pos[row_first[r] .. row_first[r+1]) with their bytes in vals:
// sorted, unique, flat positions of its literals.  Then
//
//     out[r, i] = the literal at i           where there is one
//               = out[r, i - d]              elsewhere, 0 for i < d
//
// (positions below d are literal in every stream an encoder writes; the
// zero only keeps the function total, as the TPU program's zeroed grid
// does).  The TPU program scatters 0x100 | byte into a two-byte grid in
// device memory, fills the whole grid once for every offset present, with
// a cummax of (index + 1) << 8 | byte keys down the columns of a
// (ceil(seg / d), d) view padded to a multiple of d, and selects each
// row's own fill.  Here a row needs only its own d and the grid never
// exists: a tile's literal flags live in shared memory.
//
// What bounds it: bytes (5 bytes a record read, the stream written once),
// but a row is a dependency chain along stride d.  One thread block
// walks one row in tiles of 8192 bytes, rows in parallel.  Per tile:
// clear the flags; place the row's records that fall in the tile (the
// records are sorted, so they are the next ones: 256 at a time until one
// lies past the tile); fill; write the tile out; keep its last 1024 bytes
// as the next tile's left halo, so the predecessor of position i < d is
// halo[i - d] whatever d is: no residue arithmetic, and no padding when d
// does not divide seg or the tile.
//
// The fill sees the tile as columns i, i + d, i + 2d, ...  With d >= 256 a
// thread walks a whole column.  With d < 256 a column would leave threads
// idle (d = 1 is one chain of 8192), so 256 / d threads share a column,
// each a contiguous stretch: each finds the last literal of its stretch,
// a thread takes as its incoming byte the last literal of the nearest
// stretch before it that has one (else the halo's), and then fills its
// stretch.  It carries bytes, not keys, so no index can overflow however
// long the row.
//
// Two paths, which the caller names (filters/kernels.py fill_path): vec16
// writes the tile in 16-byte stores (seg % 16 == 0, out on a 16-byte
// boundary), generic in bytes.  The launcher checks the named path's
// preconditions and returns cudaErrorInvalidValue when they do not hold,
// runs on the stream it is given, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

enum Path { kGeneric = 0, kVec16 = 1 };

constexpr int kThreads = 256;
constexpr int kTile = 8192;   // positions of one row per tile
constexpr int kMaxD = 1024;   // the largest offset; the halo's bytes
constexpr int64_t kMaxGrid = int64_t{1} << 20;
static_assert(kTile >= kMaxD, "the halo is cut from one tile");
static_assert(kTile % (16 * kThreads) == 0 && kMaxD % (4 * kThreads) == 0,
              "whole vectors a thread");

// 8 blocks a multiprocessor (32 registers a thread): 1056 rows in flight on
// the card's 132, so 1024 rows of a 256 MiB stream run in one wave
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
match_fill(const int32_t *__restrict__ pos, const uint8_t *__restrict__ vals,
           const int64_t *__restrict__ row_first,
           const int32_t *__restrict__ row_d, uint8_t *__restrict__ out,
           int64_t nseg, int seg) {
  // val[kMaxD + i] is position p0 + i of the row, val[0 .. kMaxD) the
  // kMaxD positions before the tile; lit[i] != 0: position p0 + i is literal
  __shared__ __align__(16) uint8_t val[kMaxD + kTile];
  __shared__ __align__(16) uint8_t lit[kTile];
  __shared__ uint8_t part_has[kThreads], part_val[kThreads];
  uint8_t *cur_tile = val + kMaxD;
  const int tid = threadIdx.x;
  for (int64_t r = blockIdx.x; r < nseg; r += gridDim.x) {
    const int64_t row0 = r * seg;
    const int d = row_d[r];
    const bool fills = d >= 1 && d <= kMaxD;
    int64_t next = row_first[r];  // the row's first record not yet placed
    const int64_t end = row_first[r + 1];
    for (int i = 4 * tid; i < kMaxD; i += 4 * kThreads)
      *(uint32_t *)(val + i) = 0u;  // nothing precedes a row
    for (int p0 = 0; p0 < seg; p0 += kTile) {
      const int n = min(kTile, seg - p0);
      for (int i = 16 * tid; i < kTile; i += 16 * kThreads)
        *(uint4 *)(lit + i) = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();

      // place the records of [p0, p0 + n): a prefix of those left
      const int64_t tile0 = row0 + p0;
      for (;;) {
        const int64_t idx = next + tid;
        bool take = false;
        if (idx < end) {
          const int64_t q = (int64_t)pos[idx] - tile0;
          take = q < n;
          if (take && q >= 0) {
            cur_tile[q] = vals[idx];
            lit[q] = 1;
          }
        }
        const int took = __syncthreads_count(take);
        next += took;
        if (took < kThreads) break;
      }

      if (!fills) {
        for (int i = tid; i < n; i += kThreads)
          if (!lit[i]) cur_tile[i] = 0;
      } else if (d >= kThreads) {
        for (int c = tid; c < d && c < n; c += kThreads) {
          uint8_t v = cur_tile[c - d];
          for (int i = c; i < n; i += d) {
            if (lit[i])
              v = cur_tile[i];
            else
              cur_tile[i] = v;
          }
        }
      } else {
        const int sharers = kThreads / d;           // threads a column
        const int longest = (n + d - 1) / d;        // positions of column 0
        const int stretch = (longest + sharers - 1) / sharers;
        const int c = tid % d, s = tid / d;
        const bool active = s < sharers;
        const int first = c + s * stretch * d;
        const int last = min(first + stretch * d, n);  // one past, stride d
        uint8_t has = 0, v = 0;
        if (active)
          for (int i = first; i < last; i += d)
            if (lit[i]) {
              has = 1;
              v = cur_tile[i];
            }
        part_has[tid] = has;
        part_val[tid] = v;
        __syncthreads();
        if (active) {
          int before = s - 1;
          while (before >= 0 && !part_has[before * d + c]) --before;
          v = before >= 0 ? part_val[before * d + c] : cur_tile[c - d];
          for (int i = first; i < last; i += d) {
            if (lit[i])
              v = cur_tile[i];
            else
              cur_tile[i] = v;
          }
        }
      }
      __syncthreads();

      uint8_t *o = out + tile0;
      if (kVec) {
        for (int i = 16 * tid; i < n; i += 16 * kThreads)
          *(uint4 *)(o + i) = *(const uint4 *)(cur_tile + i);
      } else {
        for (int i = tid; i < n; i += kThreads) o[i] = cur_tile[i];
      }
      // the next tile's halo: this tile's last kMaxD bytes (n == kTile
      // whenever another tile follows), which lie past the halo's place
      if (p0 + kTile < seg)
        for (int i = 4 * tid; i < kMaxD; i += 4 * kThreads)
          *(uint32_t *)(val + i) = *(const uint32_t *)(val + kTile + i);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// pos: the records' flat positions, int32 on the device, sorted and
// unique; vals: their bytes; row_first: nseg+1 int64 on the device, row
// r's records are [row_first[r], row_first[r+1]); row_d: nseg int32 on the
// device, 1 <= d <= 1024 (a row with another d gets its literals and
// zeros); out: nseg*seg bytes on the device.  nseg*seg < 2**31.  path: 0
// generic, 1 vec16.
int tpbt_match_fill(const void *pos, const void *vals, const void *row_first,
                    const void *row_d, void *out, int64_t nseg, int64_t seg,
                    int path, void *stream) {
  const bool geometry = nseg >= 0 && seg >= 1 && seg <= INT32_MAX - kTile &&
                        nseg <= INT32_MAX / seg;
  const bool fits = path == kGeneric || (path == kVec16 && seg % 16 == 0 &&
                                         (uintptr_t)out % 16 == 0);
  if (!geometry || !fits || row_first == nullptr || row_d == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  const unsigned grid = (unsigned)std::min(nseg, kMaxGrid);
  auto kernel = path == kVec16 ? match_fill<true> : match_fill<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)pos, (const uint8_t *)vals, (const int64_t *)row_first,
      (const int32_t *)row_d, (uint8_t *)out, nseg, (int)seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
