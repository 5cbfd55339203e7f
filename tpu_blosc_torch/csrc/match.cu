// The device half of the match strategy for NVIDIA Hopper (sm_90a): the
// count kernel that picks each row's match offset, and the literal-mask
// kernel that opens the equality runs at that offset.
//
// Rows are nseg filtered segments of seg bytes (seg % 4 == 0).
//
// tpbt_match_count replaces the count phase of _device_match_core_fused
// and _device_match_core (tpu_blosc/device.py:303-335, :403-415), an XLA
// fori_loop of one compare-and-reduce pass per candidate offset, kept
// outside the Pallas kernel because Mosaic compiles per-row reductions
// badly.  For each row r and each of n <= 32 candidate offsets d_i,
// 1 <= d_i < seg:
//
//     c[r, i] = #{p : d_i <= p < seg, x[p] == x[p - d_i]}
//     best[r] = the first i with the largest c[r, i]; 0 when all are 0
//
// tpbt_match_nibble replaces match_select_open_nibble (_make_match_kernel,
// tpu_blosc/filters/pallas_kernels.py:343-497).  With the row's chosen
// offset d = row_d[r], tail forced literals and minimum run length T:
//
//     eq[p]    = x[p] == x[p-d]          for d <= p < seg - tail, else 0
//     er[p]    = AND_{s<T} eq[p+s]       (erosion; eq past seg is 0)
//     match[p] = OR_{s<T}  er[p-s]       (dilation; er before 0 is 0)
//     out[r*seg/4 + j] bit t = !match[4j+t], t < 4 (one nibble a word)
//
// tpbt_match_mask is the same kernel writing what the strategy ships
// instead: the literal bits packed 8 to a byte, and each row's literal
// count (the XLA popcount and nibble-pair pack of device.py:341-348).
//
// A row with d < 1 or d >= seg - tail has no matches (every byte literal).
// The TPU kernel computes eq for all 20 candidate offsets and selects one
// with `where`, because Mosaic needs static shifts, and gates on
// seg % 16384 == 0 and d <= 2044.  Here d is a runtime value, so eq is
// computed for that one offset, and any seg % 4 == 0 and any d work.
//
// Both kernels take one tile of 16384 positions of one row per thread
// block, staged once into shared memory with a left halo of kHalo = 1024
// bytes (the largest default offset), so device memory is read once (plus
// the halo, 6%) and every partner x[p-d] with d <= kHalo is a shared-memory
// word.  The halo of a row's first tile is never loaded and never counted:
// the bytes before a row belong to the previous row.  Consecutive threads
// take consecutive 32-bit words, so no offset causes a bank conflict: for
// d % 4 == 0 the partner is one aligned word, otherwise a funnel shift of
// two neighbouring words.  An offset above kHalo takes its partner bytes
// from device memory (no default offset does).
//
// What bounds the count kernel: the instruction rate, not bytes.  A word
// costs 6 instructions per offset (load, xor, a 3-instruction exact
// zero-byte test, one dp4a that adds the four flags to the accumulator),
// 20 offsets a word; then one warp reduction (redux.sync) and one
// shared-memory atomic per warp and offset, and one device-memory atomic
// per tile and offset into the zeroed (nseg, n) int32 buffer the caller
// provides.  Integer atomics keep the counts exact whatever their order.
// A second small kernel takes the first arg-max of each row as a 64-bit
// index.
//
// What bounds the mask kernel: bytes (seg read once, seg/4 or seg/8
// written).  eq is kept as bits.  Phase 1 folds the zero-byte flags of
// each word into a nibble (one multiply) and masks it with the head
// (p >= d) and tail (p < seg - tail) conditions; the nibbles go to shared
// memory.  Phase 2 gives each thread 64 positions: 16 nibble bytes in one
// 16-byte load, plus the 8 positions on either side (T - 1 <= 8), as one
// 80-bit window in three words.  Erosion and dilation are funnel shifts of
// that window, doubling (for T = 8: by 1, 2 and 4), so no thread needs
// another's result, and the 16 nibble bytes leave in one 16-byte store
// (or the 8 packed bytes in one 8-byte store, with a popcount that one
// warp reduction and one atomic per warp add to the row's count).
//
// Each launcher takes one of two paths, which the caller names
// (filters/kernels.py match_path):
//
// vec16: seg % 64 == 0 and the row and output pointers on 16-byte
//   boundaries (every default block).  Tiles are staged with 16-byte
//   cp.async copies and the mask leaves in 16-byte stores.
// generic: any seg % 4 == 0 and any alignment: byte loads into the same
//   shared-memory layout, byte stores of the mask.
//
// Each launcher checks the named path's preconditions and returns
// cudaErrorInvalidValue when they do not hold (it never takes the other
// path instead), runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launches were accepted).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

enum Path { kGeneric = 0, kVec16 = 1 };

constexpr int kThreads = 256;
constexpr int kTile = 16384;         // positions of one row per tile
constexpr int kTileWords = kTile / 4;
constexpr int kWordsPerThread = kTileWords / kThreads;
constexpr int kHalo = 1024;          // bytes staged left of a tile
constexpr int kMaxOffsets = 32;
constexpr int kMaxT = 9;
constexpr int kEdge = 16;            // bytes staged beyond that: >= kMaxT - 1
constexpr int kEqPad = 16;           // eq nibbles kept on either side of a tile's
constexpr int64_t kMaxGrid = int64_t{1} << 20;
static_assert(kTileWords / 16 <= kThreads, "one chunk of 64 positions a thread");

__device__ __forceinline__ void cp_async16(uint32_t smem, const void *gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage bytes [a, b) of the row x (positions relative to the row; a may be
// negative) to s[0 .. b-a), and wait for every thread.  Positions outside
// [0, seg) are not read and their bytes in s keep what they held: every use
// is masked.  On the vec16 path a, b, seg, x and s are multiples of 16.
template <bool kVec>
__device__ __forceinline__ void load_span(uint8_t *s, const uint8_t *x, int a,
                                          int b, int seg) {
  if (kVec) {
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(s);
    const int c0 = a / 16;
    for (int c = c0 + (int)threadIdx.x; c < b / 16; c += kThreads)
      if (c >= 0 && 16 * c < seg) cp_async16(s0 + 16 * (c - c0), x + 16 * c);
    cp_async_wait_all();
  } else {
    for (int i = a + (int)threadIdx.x; i < b; i += kThreads)
      if (i >= 0 && i < seg) s[i - a] = x[i];
  }
  __syncthreads();
}

// 0x80 in each byte where a and b hold the same byte, 0 elsewhere (exact).
__device__ __forceinline__ uint32_t eq_flags(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// The word of partners x[p-d .. p-d+3] of the word at index w of the staged
// words sw, for d = 4q + r: one word when r == 0, else the last r bytes of
// word w-q-1 below the first 4-r bytes of word w-q (little-endian words).
__device__ __forceinline__ uint32_t partner(const uint32_t *sw, int w, int q,
                                            int r) {
  if (r == 0) return sw[w - q];
  return __funnelshift_r(sw[w - q - 1], sw[w - q], 8 * (4 - r));
}

// The flags of eq_flags, at bits 7, 15, 23 and 31, as bits 0..3: the
// products of 2^7, 2^15, 2^23 and 2^31 with 2^21, 2^14, 2^7 and 1 fall on
// different bits, those at bits 28..31 are the four wanted.
__device__ __forceinline__ uint32_t fold_flags(uint32_t t) {
  return (t * 0x00204081u) >> 28;
}

// ---- the count kernel ------------------------------------------------

// Equal bytes of this thread's words against their partners at offset
// d <= kHalo.  kHead: the tile is the row's first, so positions below d
// are masked out; they lie in the first kThreads words, one a thread.
// kFull: the tile has all its kTileWords words.
static_assert(kHalo <= 4 * kThreads, "a head mask for the first word of a thread only");

template <bool kHead, bool kFull, bool kAligned>
__device__ __forceinline__ uint32_t count_words(const uint32_t *sw,
                                                const uint32_t *xw, int nw,
                                                int d) {
  // the partner of word w = k * kThreads + tid starts at pw[k * kThreads]
  // (d % 4 == 0) or sh bits into the word before it
  const uint32_t *pw = sw + kHalo / 4 - (d >> 2) + threadIdx.x;
  const int sh = 8 * (4 - (d & 3));
  uint32_t acc = 0;  // 128 for every equal byte
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int w = k * kThreads + (int)threadIdx.x;
    if (!kFull && w >= nw) break;
    const uint32_t other =
        kAligned ? pw[k * kThreads]
                 : __funnelshift_r(pw[k * kThreads - 1], pw[k * kThreads], sh);
    uint32_t t = eq_flags(xw[k], other);
    if (kHead && k == 0) {
      const int below = d - 4 * w;  // bytes of the word at positions < d
      if (below >= 4)
        t = 0;
      else if (below > 0)
        t &= 0xffffffffu << (8 * below);
    }
    acc = __dp4a(t, 0x01010101u, acc);
  }
  return acc >> 7;
}

template <bool kHead, bool kFull>
__device__ __forceinline__ uint32_t count_near(const uint32_t *sw,
                                               const uint32_t *xw, int nw,
                                               int d) {
  return d % 4 == 0 ? count_words<kHead, kFull, true>(sw, xw, nw, d)
                    : count_words<kHead, kFull, false>(sw, xw, nw, d);
}

// The same for an offset above the halo: partner bytes from device memory.
__device__ __forceinline__ uint32_t count_far(const uint8_t *x,
                                              const uint32_t *xw, int nw,
                                              int p0, int d) {
  uint32_t c = 0;
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int w = k * kThreads + (int)threadIdx.x;
    if (w >= nw) break;
    for (int b = 0; b < 4; ++b) {
      const int p = p0 + 4 * w + b;
      if (p >= d) c += ((xw[k] >> (8 * b)) & 0xff) == x[p - d];
    }
  }
  return c;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
match_count(const uint8_t *__restrict__ segs, const int32_t *__restrict__ offsets,
            int n, int32_t *__restrict__ counts, int64_t nseg, int seg) {
  __shared__ __align__(16) uint8_t xs[kHalo + kTile];
  __shared__ int offs[kMaxOffsets];
  __shared__ int cnt[kMaxOffsets];
  const uint32_t *sw = (const uint32_t *)xs;
  const int tid = threadIdx.x;
  const int64_t tiles = (seg + kTile - 1) / kTile;
  if (tid < n) offs[tid] = offsets[tid];
  for (int64_t t = blockIdx.x; t < nseg * tiles; t += gridDim.x) {
    const int64_t r = t / tiles;
    const int p0 = (int)(t - r * tiles) * kTile;
    const uint8_t *x = segs + r * seg;
    const int end = min(p0 + kTile, seg);
    const int nw = (end - p0) / 4;
    if (tid < n) cnt[tid] = 0;
    load_span<kVec>(xs, x, p0 - kHalo, end, seg);
    uint32_t xw[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int w = k * kThreads + tid;
      xw[k] = w < nw ? sw[kHalo / 4 + w] : 0;
    }
    for (int i = 0; i < n; ++i) {
      const int d = offs[i];
      uint32_t c = 0;
      if (d < 1)
        c = 0;
      else if (d > kHalo)
        c = count_far(x, xw, nw, p0, d);
      else if (p0 == 0)
        c = nw == kTileWords ? count_near<true, true>(sw, xw, nw, d)
                             : count_near<true, false>(sw, xw, nw, d);
      else
        c = nw == kTileWords ? count_near<false, true>(sw, xw, nw, d)
                             : count_near<false, false>(sw, xw, nw, d);
      c = __reduce_add_sync(0xffffffffu, c);
      if ((tid & 31) == 0 && c != 0) atomicAdd(&cnt[i], (int)c);
    }
    __syncthreads();
    if (tid < n && cnt[tid] != 0) atomicAdd(&counts[r * n + tid], cnt[tid]);
  }
}

// best[r] = the first index of the largest count of row r; 0 when all are 0.
__global__ void __launch_bounds__(kThreads)
match_argmax(const int32_t *__restrict__ counts, int n, int64_t nseg,
             int64_t *__restrict__ best) {
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < nseg;
       r += (int64_t)gridDim.x * kThreads) {
    int best_c = 0, best_i = 0;
    for (int i = 0; i < n; ++i) {
      const int c = counts[r * n + i];
      if (c > best_c) {
        best_c = c;
        best_i = i;
      }
    }
    best[r] = best_i;
  }
}

// ---- the literal-mask kernel -----------------------------------------

// Bits 0..95 of a window of positions, 32 to a word.
struct Window {
  uint32_t w0, w1, w2;
  __device__ __forceinline__ Window shr(int s) const {  // 1 <= s < 32
    return {__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s), w2 >> s};
  }
  __device__ __forceinline__ Window shl(int s) const {
    return {w0 << s, __funnelshift_l(w0, w1, s), __funnelshift_l(w1, w2, s)};
  }
  __device__ __forceinline__ Window operator&(const Window &o) const {
    return {w0 & o.w0, w1 & o.w1, w2 & o.w2};
  }
  __device__ __forceinline__ Window operator|(const Window &o) const {
    return {w0 | o.w0, w1 | o.w1, w2 | o.w2};
  }
};

// er[i] = AND_{s<T} w[i+s], by doubling
__device__ __forceinline__ Window erode(Window w, int T) {
  int k = 1;
  for (; 2 * k <= T; k *= 2) w = w & w.shr(k);
  if (k < T) w = w & w.shr(T - k);
  return w;
}

// m[i] = OR_{s<T} w[i-s]
__device__ __forceinline__ Window dilate(Window w, int T) {
  int k = 1;
  for (; 2 * k <= T; k *= 2) w = w | w.shl(k);
  if (k < T) w = w | w.shl(T - k);
  return w;
}

// The low nibbles of the four bytes of w as 16 bits, and back.
__device__ __forceinline__ uint32_t pack_nibbles(uint32_t w) {
  const uint32_t v = (w | (w >> 4)) & 0x00ff00ffu;
  return (v | (v >> 8)) & 0xffffu;
}

__device__ __forceinline__ uint32_t unpack_nibbles(uint32_t v) {
  const uint32_t w = (v & 0xffu) | ((v & 0xff00u) << 8);
  return (w & 0x000f000fu) | ((w & 0x00f000f0u) << 4);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
match_nibble(const uint8_t *__restrict__ segs, const int32_t *__restrict__ row_d,
             uint8_t *__restrict__ out, uint8_t *__restrict__ packed,
             int32_t *__restrict__ lit_counts, int64_t nseg, int seg, int tail,
             int T) {
  // xs[i] is position p0 - kLeft + i; eqn[kEqPad + j] the eq nibble of
  // the word at positions p0 + 4j ..
  constexpr int kLeft = kHalo + kEdge;
  __shared__ __align__(16) uint8_t xs[kLeft + kTile + kEdge];
  __shared__ __align__(16) uint8_t eqn[kEqPad + kTileWords + kEqPad];
  const uint32_t *sw = (const uint32_t *)xs;
  const int tid = threadIdx.x;
  const int64_t tiles = (seg + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < nseg * tiles; t += gridDim.x) {
    const int64_t r = t / tiles;
    const int p0 = (int)(t - r * tiles) * kTile;
    const uint8_t *x = segs + r * seg;
    // its barrier also ends the last tile's phase 2
    load_span<kVec>(xs, x, p0 - kLeft, min(p0 + kTile + kEdge, seg), seg);
    const int d = row_d[r];
    // eq can hold at positions lo <= p < hi only
    const int hi = d >= 1 ? seg - tail : 0;
    const int lo = d >= 1 ? d : 0;
    const bool near = d <= kHalo;
    const int q = d >> 2, rem = d & 3;
    const int nw = (min(p0 + kTile, seg) - p0) / 4;  // words of this tile
    const int nchunks = (nw + 15) / 16;               // 64 positions each

    // phase 1: the eq nibble of every word a chunk of this tile looks at;
    // clear: each of them lies at or past d and before the tail (no masks)
    const int jend = 16 * nchunks + 2;
    const bool clear = near && lo <= p0 - 8 && p0 + 4 * jend <= hi;
    for (int j = tid - 2; j < jend; j += kThreads) {
      const int w = kLeft / 4 + j;
      uint32_t nib = 0;
      if (clear) {
        nib = fold_flags(eq_flags(sw[w], partner(sw, w, q, rem)));
      } else {
        const int pw = p0 + 4 * j;
        const int a = min(max(lo - pw, 0), 4), e = min(max(hi - pw, 0), 4);
        const uint32_t valid = ((1u << e) - 1u) & ~((1u << a) - 1u);
        if (valid) {
          uint32_t other;
          if (near) {
            other = partner(sw, w, q, rem);
          } else {
            other = 0;
            for (int b = a; b < e; ++b)
              other |= (uint32_t)x[pw + b - d] << (8 * b);
          }
          nib = fold_flags(eq_flags(sw[w], other)) & valid;
        }
      }
      eqn[kEqPad + j] = (uint8_t)nib;
    }
    __syncthreads();

    // phase 2: one chunk a thread; window bit i is position p0 + 64c - 8 + i
    int literals = 0;
    if (tid < nchunks) {
      const int c = tid;
      const uint8_t *e = eqn + kEqPad + 16 * c;
      const uint4 v = *(const uint4 *)e;
      const uint32_t left = pack_nibbles(*(const uint16_t *)(e - 2));
      const uint32_t right = pack_nibbles(*(const uint16_t *)(e + 16));
      const uint32_t e0 = pack_nibbles(v.x), e1 = pack_nibbles(v.y);
      const uint32_t e2 = pack_nibbles(v.z), e3 = pack_nibbles(v.w);
      Window w = {left | (e0 << 8) | (e1 << 24),
                  (e1 >> 8) | (e2 << 8) | (e3 << 24), (e3 >> 8) | (right << 8)};
      w = dilate(erode(w, T), T);
      // literal bits of positions 0..31 and 32..63 of the chunk; those past
      // the row's end are cleared
      const int live = 4 * nw - 64 * c;
      const uint32_t lit0 = ~__funnelshift_r(w.w0, w.w1, 8) &
                            (live >= 32 ? 0xffffffffu : (1u << live) - 1u);
      const uint32_t lit1 =
          live <= 32 ? 0u
                     : ~__funnelshift_r(w.w1, w.w2, 8) &
                           (live >= 64 ? 0xffffffffu : (1u << (live - 32)) - 1u);
      if (out != nullptr) {
        const uint4 o = make_uint4(
            unpack_nibbles(lit0 & 0xffffu), unpack_nibbles(lit0 >> 16),
            unpack_nibbles(lit1 & 0xffffu), unpack_nibbles(lit1 >> 16));
        uint8_t *dst = out + r * (seg / 4) + p0 / 4 + 16 * c;
        if (kVec) {
          *(uint4 *)dst = o;
        } else {
          const uint32_t words[4] = {o.x, o.y, o.z, o.w};
          for (int b = 0; b < 16 && 16 * c + b < nw; ++b)
            dst[b] = (uint8_t)(words[b >> 2] >> (8 * (b & 3)));
        }
      }
      if (packed != nullptr) {
        // bit i of byte j = position 8j+i is literal: the bits as they are
        uint8_t *dst = packed + r * (seg / 8) + p0 / 8 + 8 * c;
        if (kVec) {
          *(uint2 *)dst = make_uint2(lit0, lit1);
        } else {
          for (int b = 0; b < 8 && 8 * b < live; ++b)
            dst[b] = (uint8_t)((b < 4 ? lit0 : lit1) >> (8 * (b & 3)));
        }
        literals = __popc(lit0) + __popc(lit1);
      }
    }
    if (lit_counts != nullptr) {
      literals = __reduce_add_sync(0xffffffffu, literals);
      if ((tid & 31) == 0 && literals != 0) atomicAdd(&lit_counts[r], literals);
    }
  }
}

// 0 when the geometry and the path may be launched, else the error code;
// out is null for a kernel whose output needs no alignment
int refuse(const void *segs, const void *out, int64_t nseg, int64_t seg,
           int path) {
  // positions are 32-bit, and a tile may reach kTile + kEdge past the row
  const bool geometry =
      nseg >= 0 && seg >= 4 && seg % 4 == 0 && seg <= INT32_MAX - 2 * kTile;
  const bool fits =
      path == kGeneric ||
      (path == kVec16 && seg % 64 == 0 && (uintptr_t)segs % 16 == 0 &&
       (uintptr_t)out % 16 == 0);
  return geometry && fits ? 0 : (int)cudaErrorInvalidValue;
}

unsigned tile_grid(int64_t nseg, int64_t seg) {
  return (unsigned)std::min(nseg * ((seg + kTile - 1) / kTile), kMaxGrid);
}

int launch_nibble(const void *segs, const void *row_d, void *out, void *packed,
                  void *lit_counts, int64_t nseg, int64_t seg, int64_t tail,
                  int64_t T, int path, void *stream) {
  if (const int rc = refuse(segs, out != nullptr ? out : packed, nseg, seg, path))
    return rc;
  if (tail < 0 || T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  const unsigned grid = tile_grid(nseg, seg);
  const int tail_in_row = (int)std::min(tail, seg);
  auto kernel = path == kVec16 ? match_nibble<true> : match_nibble<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)segs, (const int32_t *)row_d, (uint8_t *)out,
      (uint8_t *)packed, (int32_t *)lit_counts, nseg, (int)seg, tail_in_row,
      (int)T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// segs: nseg*seg bytes on the device; offsets: n int32 on the device, each
// 1 <= d < seg; counts: nseg*n int32 on the device, zeroed by the caller;
// best: nseg int64 on the device.  seg % 4 == 0, 1 <= n <= 32.  path: 0
// generic, 1 vec16.
int tpbt_match_count(const void *segs, const void *offsets, void *counts,
                     void *best, int64_t nseg, int64_t seg, int64_t n, int path,
                     void *stream) {
  if (const int rc = refuse(segs, nullptr, nseg, seg, path)) return rc;
  if (n < 1 || n > kMaxOffsets) return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  const unsigned grid = tile_grid(nseg, seg);
  if (path == kVec16)
    match_count<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)segs, (const int32_t *)offsets, (int)n,
        (int32_t *)counts, nseg, (int)seg);
  else
    match_count<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)segs, (const int32_t *)offsets, (int)n,
        (int32_t *)counts, nseg, (int)seg);
  if (const int rc = (int)cudaGetLastError()) return rc;
  const unsigned rows_grid =
      (unsigned)std::min((nseg + kThreads - 1) / kThreads, kMaxGrid);
  match_argmax<<<rows_grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)counts, (int)n, nseg, (int64_t *)best);
  return (int)cudaGetLastError();
}

// segs: nseg*seg bytes on the device; row_d: nseg int32 on the device;
// out: nseg*seg/4 bytes on the device.  seg % 4 == 0, 1 <= T <= 9.
// path: 0 generic, 1 vec16.
int tpbt_match_nibble(const void *segs, const void *row_d, void *out,
                      int64_t nseg, int64_t seg, int64_t tail, int64_t T,
                      int path, void *stream) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return launch_nibble(segs, row_d, out, nullptr, nullptr, nseg, seg, tail, T,
                       path, stream);
}

// The same mask in the form the match strategy ships: packed, nseg*seg/8
// bytes on the device, bit i of byte j of a row = byte 8j+i is literal;
// lit_counts, nseg int32 on the device, zeroed by the caller, gets each
// row's literal count.  seg % 8 == 0.
int tpbt_match_mask(const void *segs, const void *row_d, void *packed,
                    void *lit_counts, int64_t nseg, int64_t seg, int64_t tail,
                    int64_t T, int path, void *stream) {
  if (packed == nullptr || lit_counts == nullptr || seg % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_nibble(segs, row_d, nullptr, packed, lit_counts, nseg, seg,
                       tail, T, path, stream);
}

}  // extern "C"
