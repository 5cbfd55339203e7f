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
// exists: a tile's literal flags live in shared memory, as bits.
//
// What bounds it: bytes (5 bytes a record read, the stream written once:
// 256 MiB of output is 0.08 ms of the card's memory rate, and a kernel that
// only stores the tiles in this order takes 0.088 ms on an H100 80GB HBM3
// at 700 W), but a row is a dependency chain along stride d, so one thread
// block walks one row in tiles of 8192 bytes and a 256 MiB stream is only
// 1024 chains.  They run in one wave: 8 blocks a multiprocessor, 1056 in
// flight on the card's 132.  What is left to win is the length of a tile's
// own chain (place the records, fill, store), since a multiprocessor has
// only its 8 rows to overlap it with.  A block is 128 threads, so that a
// thread may have 64 registers: at 256 threads and 32 registers the same
// code spills 120 bytes a thread and takes 1.2 to 1.9 times as long at
// every offset (tune_fill.py builds and times such variants).  ptxas: 64
// registers, no spill, 22,016 bytes of shared memory, so 8 blocks fit a
// multiprocessor's registers (65,536) and its 227 KB.
//
// The design, point by point:
//
// - Flags as bits.  A tile's literal flags are a bitmap of 1 KB.  A thread
//   that places a record stores the byte and sets its bit with atomicOr.
//   Two bitmaps take turns, so the next tile's is cleared while this
//   tile's records are placed.
// - Records owned by threads.  Thread j places the row's records j, j +
//   128, ...: the records are sorted, so the thread places its next ones
//   until one lies past the tile.  No count is agreed on between the
//   threads, and a thread holds its next kAhead records in registers, so a
//   record was asked of device memory a few tiles before its turn.
// - The fill in words.  The tile is seen as columns i, i + d, i + 2d, ...
//   A thread owns a column of units of U bytes and walks down it: load the
//   unit, widen its U flag bits to a byte mask, keep the literal bytes and
//   carry the others, store.  No branch, and U bytes a step:
//       d % 16 == 0  U = 16 (uint4): 16, 32, 48, 64, 96, 128, 192, 256,
//                    384, 512, 768, 1024 of the match strategy's candidates
//       d %  4 == 0  U = 4 (one word): 4, 8, 12, 24 of them
//       any other d  U = 1 (bytes): 1, 2, 3, 6 of them
// - A log-step look-back.  A column of fewer than kShareRows rows (d = 256
//   in uint4: 16 columns of 32 rows) has one thread: there the two passes
//   below cost more than the steps they save.  A longer column is shared
//   by several threads, each a stretch of rows.  What a stretch hands on
//   is (flags of the byte columns that saw a literal, their last bytes),
//   and joining two stretches (the right one's bytes where it has a flag,
//   else the left one's) is associative.  So a thread first folds its
//   stretch without storing, the sharers scan their states, and each then
//   fills its stretch from the state before it.  With at most 32 units a
//   column, a warp holds whole groups of sharers, the scan runs in log2
//   steps of shuffles inside the warp, and the warps' totals (at most 3
//   before a thread's own) are joined from shared memory; wider columns
//   have at most 3 sharers, joined the same way.  Stretches are an odd
//   number of rows, so that the sharers of one warp fall into different
//   shared-memory banks, and at least kMinStretch rows.
// - Overlap inside the block.  Two tile buffers lie one after the other
//   behind a 1 KB halo: the even tiles' tail is the odd tiles' halo where
//   it lies, and an odd tile's last 1 KB is copied to the halo in front.
//   So the predecessor of position i < d is tile[i - d] whatever d is: no
//   residue arithmetic, and no padding when d does not divide seg or the
//   tile.  On the vec16 path a tile leaves through one bulk asynchronous
//   store that one thread starts; the block waits for it only a tile
//   later, before the buffer after it is filled.  Three barriers a tile:
//   after placing, inside the scan, after the fill (two where no column is
//   shared).
//
// It carries bytes, not keys, so no index can overflow however long the
// row.
//
// Two paths, which the caller names (filters/kernels.py fill_path): vec16
// stores a tile with cp.async.bulk (seg % 16 == 0, out on a 16-byte
// boundary), generic with ordinary stores, of words where the tile starts
// on a 4-byte boundary and of bytes elsewhere.  The launcher checks the
// named path's preconditions and returns cudaErrorInvalidValue when they
// do not hold, runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

enum Path { kGeneric = 0, kVec16 = 1 };

constexpr int kThreads = 128;
constexpr int kAhead = 4;     // records a thread holds ahead of their turn
constexpr int kTile = 8192;   // positions of one row per tile
constexpr int kMaxD = 1024;   // the largest offset; the halo's bytes
constexpr int kShareRows = 64;  // a column of fewer rows has one thread
constexpr int kMinStretch = 8;  // rows a sharer takes at least
constexpr int kWarps = kThreads / 32;
constexpr int kFlagWords = kTile / 32;
constexpr int64_t kMaxGrid = int64_t{1} << 20;
static_assert(kTile >= kMaxD, "the halo is cut from one tile");
static_assert(kTile % 32 == 0 && kMaxD % 16 == 0, "whole flag words, aligned units");

// U bytes of a column: a uint4, a word, or a byte in a word
template <int U>
struct Unit {
  uint32_t w[U >= 4 ? U / 4 : 1];
};

template <int U>
__device__ __forceinline__ Unit<U> load_unit(const uint8_t *p) {
  Unit<U> u;
  if constexpr (U == 16) {
    const uint4 q = *(const uint4 *)p;
    u.w[0] = q.x, u.w[1] = q.y, u.w[2] = q.z, u.w[3] = q.w;
  } else if constexpr (U == 4) {
    u.w[0] = *(const uint32_t *)p;
  } else {
    u.w[0] = *p;
  }
  return u;
}

template <int U>
__device__ __forceinline__ void store_unit(uint8_t *p, const Unit<U> &u) {
  if constexpr (U == 16) {
    *(uint4 *)p = make_uint4(u.w[0], u.w[1], u.w[2], u.w[3]);
  } else if constexpr (U == 4) {
    *(uint32_t *)p = u.w[0];
  } else {
    *p = (uint8_t)u.w[0];
  }
}

// four flag bits widened to a mask of four bytes
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u & 0x01010101u) * 0xFFu;
}

// the bytes of a where their flag is set, those of b elsewhere
template <int U>
__device__ __forceinline__ Unit<U> select(uint32_t bits, const Unit<U> &a,
                                          const Unit<U> &b) {
  Unit<U> r;
  if constexpr (U == 1) {
    r.w[0] = bits ? a.w[0] : b.w[0];
  } else {
#pragma unroll
    for (int k = 0; k < U / 4; ++k) {
      const uint32_t m = spread4(bits >> (4 * k));
      r.w[k] = (a.w[k] & m) | (b.w[k] & ~m);
    }
  }
  return r;
}

// the flags of the unit at byte i of the tile (i % U == 0)
template <int U>
__device__ __forceinline__ uint32_t flags(const uint32_t *bm, int i) {
  return (bm[i >> 5] >> (i & 31)) & ((1u << U) - 1u);
}

template <int U>
__device__ __forceinline__ Unit<U> shfl_up(const Unit<U> &u, int delta) {
  Unit<U> r;
#pragma unroll
  for (int k = 0; k < (U >= 4 ? U / 4 : 1); ++k)
    r.w[k] = __shfl_up_sync(0xFFFFFFFFu, u.w[k], delta);
  return r;
}

// How a tile of n bytes at offset d is split among the threads: C units a
// row of the (rows, C) view, column c and sharer s of this thread, S
// sharers a column of `stretch` rows each.  A thread with s >= S idles.
struct Split {
  int C, c, s, S, stretch, rows, units;
};

__device__ __forceinline__ Split split_tile(int U, int d, int n, int tid) {
  Split g;
  g.C = d / U;
  g.units = (n + U - 1) / U;
  g.rows = (g.units + g.C - 1) / g.C;
  int cap;
  if (g.C <= 32) {
    // whole groups of C lanes a warp, sharer after sharer; the lanes
    // past the last whole group idle
    const int groups = 32 / g.C, lane = tid & 31, group = lane / g.C;
    g.c = lane - group * g.C;
    g.s = group < groups ? (tid >> 5) * groups + group : kThreads;
    cap = kWarps * groups;
  } else if (g.C < kThreads) {
    g.s = tid / g.C;
    g.c = tid - g.s * g.C;
    cap = kThreads / g.C;
  } else {
    g.s = 0, g.c = tid, cap = 1;
  }
  g.S = g.rows < kShareRows ? 1 : min(cap, max(1, g.rows / kMinStretch));
  g.stretch = ((g.rows + g.S - 1) / g.S) | 1;
  return g;
}

// Walk down a column from unit u0 to below u1, C units a step: v carries
// the column's last literal bytes and m gathers the flags seen; with
// kStore the carried unit is stored.  In uint4 a step's unit and flags are
// loaded a step ahead, before the store that the compiler would not move
// them across; in words and bytes that reads slower than the plain loop.
template <int U, bool kStore>
__device__ __forceinline__ void walk(uint8_t *tile, const uint32_t *bm, int u0,
                                     int u1, int C, Unit<U> &v, uint32_t &m) {
  if constexpr (U == 16) {
    if (u0 >= u1) return;
    uint32_t bits = flags<U>(bm, u0 * U);
    Unit<U> w = load_unit<U>(tile + u0 * U);
#pragma unroll 2
    for (int u = u0; u < u1; u += C) {
      const int un = min(u + C, u1 - 1);  // the last step loads a unit again
      const uint32_t bits_next = flags<U>(bm, un * U);
      const Unit<U> w_next = load_unit<U>(tile + un * U);
      v = select<U>(bits, w, v);
      m |= bits;
      if (kStore) store_unit<U>(tile + u * U, v);
      bits = bits_next, w = w_next;
    }
  } else {
#pragma unroll 4
    for (int u = u0; u < u1; u += C) {
      const int i = u * U;
      const uint32_t bits = flags<U>(bm, i);
      if (kStore || U > 1 || bits) {
        v = select<U>(bits, load_unit<U>(tile + i), v);
        m |= bits;
      }
      if (kStore) store_unit<U>(tile + i, v);
    }
  }
}

// Fill one tile in place: tile[i] stays where its flag is set and becomes
// tile[i - d] elsewhere, for i in [0, n); tile[-kMaxD .. 0) is the halo.
template <int U>
__device__ __forceinline__ void fill_tile(uint8_t *tile, const uint32_t *bm,
                                          int d, const Split &g, uint4 *part_v,
                                          uint32_t *part_m, int tid) {
  const int C = g.C;
  if (g.S == 1) {
    // a thread walks whole columns
    for (int c = tid; c < C; c += kThreads) {
      Unit<U> v = load_unit<U>(tile + c * U - d);
      uint32_t seen = 0;
      walk<U, true>(tile, bm, c, g.units, C, v, seen);
    }
    return;
  }

  const bool active = g.s < g.S;
  const int first = active ? g.s * g.stretch : 0;
  const int last = active ? min(g.rows, first + g.stretch) : 0;  // one past
  const int u0 = first * C + g.c;
  const int u1 = min(last * C, g.units);

  // fold the stretch: the flags it saw and their last bytes
  uint32_t m = 0;
  Unit<U> v = {};
  walk<U, false>(tile, bm, u0, u1, C, v, m);

  // the state of the sharers before this one: inside the warp by
  // shuffles (groups of C lanes), across warps (or, with C > 32, across
  // sharers) from shared memory
  Unit<U> *part = (Unit<U> *)part_v;
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t em = 0;  // the earlier sharers of this warp
  Unit<U> ev = {};
  int before, stride;  // states to join from shared memory, and their step
  if (C <= 32) {
    for (int delta = C; delta < 32; delta <<= 1) {
      const uint32_t pm = __shfl_up_sync(0xFFFFFFFFu, m, delta);
      const Unit<U> pv = shfl_up<U>(v, delta);
      if (lane >= delta) {
        v = select<U>(m, v, pv);
        m |= pm;
      }
    }
    em = __shfl_up_sync(0xFFFFFFFFu, m, C & 31);
    ev = shfl_up<U>(v, C & 31);
    if (lane < C) em = 0;
    // the warp's last whole group holds the warp's totals
    if (lane >= (32 / C - 1) * C && lane < (32 / C) * C) {
      part_m[warp * 32 + g.c] = m;
      part[warp * 32 + g.c] = v;
    }
    before = warp, stride = 32;
  } else {
    part_m[tid] = m;
    part[tid] = v;
    before = active ? g.s : 0, stride = C;
  }
  __syncthreads();
  uint32_t am = 0;
  Unit<U> av = {};
  for (int k = 0; k < before; ++k) {
    const uint32_t pm = part_m[k * stride + g.c];
    av = select<U>(pm, part[k * stride + g.c], av);
    am |= pm;
  }
  av = select<U>(em, ev, av);
  am |= em;

  if (u0 < u1) {
    // where no sharer before saw a literal, the byte d before the tile's
    // row 0: the halo's
    v = select<U>(am, av, load_unit<U>(tile + g.c * U - d));
    walk<U, true>(tile, bm, u0, u1, C, v, m);
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one bulk asynchronous copy of `bytes` (a multiple of 16, both ends on
// 16-byte boundaries) from shared to device memory, as a group of its own
__device__ __forceinline__ void bulk_store(uint8_t *gmem, const uint8_t *smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(__cvta_generic_to_global(gmem)),
      "r"((uint32_t)__cvta_generic_to_shared(smem)), "r"(bytes)
      : "memory");
}

// wait until every bulk store of this thread has read its shared memory
__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 8 blocks a multiprocessor (64 registers a thread): 1056 rows in flight on
// the card's 132, so 1024 rows of a 256 MiB stream run in one wave
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
match_fill(const int32_t *__restrict__ pos, const uint8_t *__restrict__ vals,
           const int64_t *__restrict__ row_first,
           const int32_t *__restrict__ row_d, uint8_t *__restrict__ out,
           int64_t nseg, int seg) {
  // val[0 .. kMaxD) is the halo, then the even tiles' buffer, then the odd
  // tiles'; lit[t] has bit i set: position i of the tile in buffer t is
  // literal
  __shared__ __align__(128) uint8_t val[kMaxD + 2 * kTile];
  __shared__ uint32_t lit[2][kFlagWords];
  __shared__ __align__(16) uint4 part_v[kThreads];
  __shared__ uint32_t part_m[kThreads];
  const int tid = threadIdx.x;
  for (int64_t r = blockIdx.x; r < nseg; r += gridDim.x) {
    const int row0 = (int)(r * seg);  // nseg * seg < 2**31
    const int d = row_d[r];
    const bool fills = d >= 1 && d <= kMaxD;
    const int U = d % 16 == 0 ? 16 : d % 4 == 0 ? 4 : 1;
    // Thread j places the row's records j, j + kThreads, ...: it holds the
    // next kAhead of them (INT32_MAX: none left), so a record is on its way
    // from device memory a few tiles before its turn
    const int32_t *row_pos = pos + row_first[r];
    const uint8_t *row_vals = vals + row_first[r];
    const int count = (int)(row_first[r + 1] - row_first[r]);
    int rec[kAhead];
    uint8_t rec_val[kAhead];
    int own = tid;  // the record loaded last
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      own = tid + k * kThreads;
      rec[k] = own < count ? __ldg(row_pos + own) : INT32_MAX;
      rec_val[k] = own < count ? __ldg(row_vals + own) : 0;
    }
    // the last row's stores have read both buffers
    if (kVec && tid == 0) bulk_stores_read();
    for (int i = 4 * tid; i < kMaxD; i += 4 * kThreads)
      *(uint32_t *)(val + i) = 0u;  // nothing precedes a row
    for (int i = tid; i < kFlagWords; i += kThreads) lit[0][i] = 0u;
    __syncthreads();

    Split g;
    int split_n = 0;  // the tile length g was made for
    int t = 0;
    for (int p0 = 0; p0 < seg; p0 += kTile, t ^= 1) {
      const int n = min(kTile, seg - p0);
      const int tile0 = row0 + p0;
      uint8_t *tile = val + kMaxD + t * kTile;
      uint32_t *bm = lit[t];
      for (int i = tid; i < kFlagWords; i += kThreads) lit[t ^ 1][i] = 0u;

      // place this thread's records of the tile (tile0 + n <= INT32_MAX)
      while (rec[0] - tile0 < n) {
        const int q = rec[0] - tile0;
        tile[q] = rec_val[0];
        atomicOr(&bm[q >> 5], 1u << (q & 31));
#pragma unroll
        for (int k = 0; k + 1 < kAhead; ++k)
          rec[k] = rec[k + 1], rec_val[k] = rec_val[k + 1];
        own += kThreads;
        rec[kAhead - 1] = own < count ? __ldg(row_pos + own) : INT32_MAX;
        rec_val[kAhead - 1] = own < count ? __ldg(row_vals + own) : 0;
      }
      __syncthreads();

      if (!fills) {
        for (int i = 4 * tid; i < n; i += 4 * kThreads)
          *(uint32_t *)(tile + i) &= spread4(flags<4>(bm, i));
      } else {
        if (n != split_n) {
          g = split_tile(U, d, n, tid);
          split_n = n;
        }
        if (U == 16)
          fill_tile<16>(tile, bm, d, g, part_v, part_m, tid);
        else if (U == 4)
          fill_tile<4>(tile, bm, d, g, part_v, part_m, tid);
        else
          fill_tile<1>(tile, bm, d, g, part_v, part_m, tid);
      }

      uint8_t *o = out + tile0;
      if (kVec) {
        // the tile as the bulk copy will see it; the store of the tile
        // before has read the other buffer, which the next tile fills
        fence_proxy_async();
        if (tid == 0) bulk_stores_read();
        __syncthreads();
        if (tid == 0) bulk_store(o, tile, (uint32_t)n);
      } else {
        __syncthreads();
        if ((uintptr_t)o % 4 == 0) {
          for (int i = 4 * tid; i + 4 <= n; i += 4 * kThreads)
            *(uint32_t *)(o + i) = *(const uint32_t *)(tile + i);
          if (tid < n % 4) o[n - n % 4 + tid] = tile[n - n % 4 + tid];
        } else {
          for (int i = tid; i < n; i += kThreads) o[i] = tile[i];
        }
      }
      // an even tile's halo: the odd tile's last kMaxD bytes (n == kTile
      // whenever another tile follows); an odd tile's lies where it is
      if (t == 1 && p0 + kTile < seg)
        for (int i = 4 * tid; i < kMaxD; i += 4 * kThreads)
          *(uint32_t *)(val + i) = *(const uint32_t *)(tile + kTile - kMaxD + i);
    }
  }
  if (kVec && tid == 0) bulk_stores_read();
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
