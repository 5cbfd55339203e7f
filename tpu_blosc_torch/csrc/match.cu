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
// the halo, 6%) and every partner x[p-d] with d <= kHalo is in shared
// memory.  The halo of a row's first tile is never loaded and never
// counted: the bytes before a row belong to the previous row.  An offset
// above kHalo takes its partner bytes from device memory (no default
// offset does).
//
// What bounds the count kernel: integer instructions, not bytes (256 MiB
// read once is 0.08 ms on the H100).  Comparing a word of 4 positions at a
// time (an exact zero-byte test and a dp4a: 6-7 instructions per 4
// positions and offset) is held at the integer instruction rate, so the
// kernel stores the tile as bit planes, and one logic instruction compares
// 32 positions:
//
// - Staging: 16-byte chunks (cp.async on vec16; on generic, 4-byte words
//   of aligned loads and a funnel shift) at swizzled slots (swizzle), so 8
//   neighbouring threads reading the same chunk of their units hit 8 bank
//   quads.  Once a tile's bytes are planes, the block stages its next tile
//   into the same buffer, so the copy runs under the counts (vec16).
// - Planes, once per tile for every offset: 128 threads, thread t owns
//   the unit of 128 positions p0 + 128 t, four groups of 32; each group's
//   32 bytes become its 8 planes (plane k bit l = bit k of byte l) by two
//   4x4 byte transposes and three bit-block swaps (bit_planes, 76
//   instructions).  The planes stay in registers and go to shared memory
//   laid out [plane][group], so a unit's plane is one 16-byte word and
//   neighbouring threads' units are neighbouring words.  The halo's 32
//   groups are one a lane of warp 0.
// - Compare: p and p - d (d = 32q + r) hold the same byte when all 8
//   planes agree.  The partner plane of group j is funnelshift_l(plane of
//   group j-q-1, plane of group j-q, r), the mismatch word M = OR_k
//   (P_k ^ Q_k): 8 three-input logic instructions (plus 8 funnel shifts
//   when r != 0) per 32 positions, and the count popc(~M & valid).  For
//   d < 64 (11 of the 20 default offsets) every partner plane is in the
//   thread's registers (its unit and the two groups before it); from 64 to
//   kHalo (the other 9, all multiples of 32) a plane's partners for the
//   unit are one or two 16-byte shared-memory words.
// - valid clears positions below d (the first tile), past the row's end
//   (seg % 32 != 0) and past a short last tile's end; whole units in the
//   clear count 128 - popc(M) with no mask.
// - Per offset, one warp reduction (redux.sync) that every lane stores to
//   the warp's slot; per tile and offset, one device-memory atomic of the
//   4 warps' sum into the zeroed (nseg, n) int32 buffer the caller
//   provides.  Integer atomics keep the counts exact whatever their order.
//   A second small kernel takes the first arg-max of each row as a 64-bit
//   index.
//
// Per 32 positions that is about 76 instructions of planes and 9-18 per
// offset (plus the loop's own), against 48-56 per offset by words.  80
// registers and 35.5 KB of shared memory a block let 6 blocks share an SM.
// The popcount, a quarter-rate instruction, does not set the pace.
//
// What bounds the mask kernel: bytes (seg read once, seg/4 or seg/8
// written).  Its threads take consecutive 32-bit words, so no offset causes
// a bank conflict: for d % 4 == 0 the partner is one aligned word,
// otherwise a funnel shift of two neighbouring words.  eq is kept as bits.
// Phase 1 folds the zero-byte flags of each word into a nibble (one
// multiply) and masks it with the head (p >= d) and tail (p < seg - tail)
// conditions; the nibbles go to shared memory.  Phase 2 gives each thread
// 64 positions: 16 nibble bytes in one 16-byte load, plus the 8 positions
// on either side (T - 1 <= 8), as one 80-bit window in three words.
// Erosion and dilation are funnel shifts of that window, doubling (for
// T = 8: by 1, 2 and 4), so no thread needs another's result, and the 16
// nibble bytes leave in one 16-byte store (or the 8 packed bytes in one
// 8-byte store, with a popcount that one warp reduction and one atomic per
// warp add to the row's count).
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// A block takes one tile of a row, as the mask kernel does, with 128
// threads: thread t owns the unit of kUnit positions p0 + kUnit t, four
// groups of 32.  A group is kept as its 8 bit planes, one word each: bit
// l of plane k is bit k of the group's byte l.
constexpr int kCountThreads = 128;
constexpr int kUnit = 128;
constexpr int kGroups = kUnit / 32;
constexpr int kSpanGroups = (kHalo + kTile) / 32;  // groups of the staged span
static_assert(kTile == kCountThreads * kUnit, "one unit a thread");
static_assert(kGroups == 4, "a unit's plane is one 16-byte word");
static_assert(kHalo / 32 <= 32, "the halo's groups, one a lane of the first warp");

// Chunk slot of the 16-byte chunk c of a staged span: the 8 chunks of a
// unit (128 bytes) stay in its 128 bytes, turned so that the chunk m of 8
// neighbouring units lies in 8 different bank quads.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 7); }

// Stage bytes [a, b) of the row x (positions relative to the row; a may be
// negative) to the chunks of s at their swizzled slots.  Positions outside
// [0, seg) are not read.  a, b and seg are multiples of 4, so a word of 4
// positions lies wholly inside or outside the row; on the vec16 path they,
// x and s are multiples of 16.  vec16 starts 16-byte cp.async copies and
// returns (wait_staged waits for them); the generic path reads the aligned
// words of device memory that hold a row word, one or two (each holds a
// byte of the row), funnel-shifts them and stores them.
template <bool kVec>
__device__ __forceinline__ void stage_count(uint8_t *s, const uint8_t *x, int a,
                                            int b, int seg) {
  if (kVec) {
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(s);
    const int c0 = a / 16;
    for (int c = c0 + (int)threadIdx.x; c < b / 16; c += kCountThreads)
      if (c >= 0 && 16 * c < seg) cp_async16(s0 + 16 * swizzle(c - c0), x + 16 * c);
    cp_async_commit();
  } else {
    const int mis = (int)((uintptr_t)x & 3);
    const uint32_t *xw = (const uint32_t *)(x - mis);  // word i/4 holds x[i - mis]
    for (int k = 4 * (int)threadIdx.x; k < b - a; k += 4 * kCountThreads) {
      const int i = a + k;
      if (i < 0 || i >= seg) continue;
      const uint32_t lo = xw[i / 4];
      const uint32_t w = mis ? __funnelshift_r(lo, xw[i / 4 + 1], 8 * mis) : lo;
      *(uint32_t *)(s + 16 * swizzle(k >> 4) + (k & 15)) = w;
    }
  }
}

// Wait for this thread's staging copies, then for every thread.
template <bool kVec>
__device__ __forceinline__ void wait_staged() {
  if (kVec) cp_async_wait();
  __syncthreads();
}

// Swap the bits of x that mask << s selects with the bits of y that mask
// selects.
__device__ __forceinline__ void swap_bits(uint32_t &x, uint32_t &y, int s,
                                          uint32_t mask) {
  const uint32_t t = ((x >> s) ^ y) & mask;
  y ^= t;
  x ^= t << s;
}

// The 8 bit planes p of 32 bytes w (word i holds bytes 4i .. 4i+3).  A bit
// is (word i, byte m, bit k) with i = (i2 i1 i0), m = (m1 m0); the planes
// want it at (word k, bit 4i + m).  Two 4x4 byte transposes move i2 i1 into
// the byte index and m into the word index; three swaps of bit blocks
// between words exchange i0, m0 and m1 with k2, k0 and k1.  76 integer
// instructions a group, paid once for every offset.
__device__ __forceinline__ void bit_planes(const uint32_t (&w)[8], uint32_t (&p)[8]) {
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // byte a of v[2m + e] = byte m of w[2a + e]
    const uint32_t x0 = __byte_perm(w[e], w[2 + e], 0x5140);
    const uint32_t x1 = __byte_perm(w[e], w[2 + e], 0x7362);
    const uint32_t x2 = __byte_perm(w[4 + e], w[6 + e], 0x5140);
    const uint32_t x3 = __byte_perm(w[4 + e], w[6 + e], 0x7362);
    v[e] = __byte_perm(x0, x2, 0x5410);
    v[2 + e] = __byte_perm(x0, x2, 0x7632);
    v[4 + e] = __byte_perm(x1, x3, 0x5410);
    v[6 + e] = __byte_perm(x1, x3, 0x7632);
  }
  // word (m1 m0 i0), bit (i2 i1 k2 k1 k0)
#pragma unroll
  for (int a = 0; a < 4; ++a) swap_bits(v[2 * a], v[2 * a + 1], 4, 0x0f0f0f0fu);
  // word (m1 m0 k2), bit (i2 i1 i0 k1 k0)
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int i = (h & 1) | ((h & 2) << 1);  // 0, 1, 4, 5
    swap_bits(v[i], v[i + 2], 1, 0x55555555u);
  }
  // word (m1 k0 k2), bit (i2 i1 i0 k1 m0)
#pragma unroll
  for (int i = 0; i < 4; ++i) swap_bits(v[i], v[i + 4], 2, 0x33333333u);
  // word (k1 k0 k2), bit (i2 i1 i0 m1 m0)
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = v[((k & 3) << 1) | (k >> 2)];
}

// The planes of group h of the staged bytes xs (unit h / 4, chunks at
// their swizzled slots).  Plane k of group h is planes[k * kSpanGroups + h]:
// a unit's plane is one 16-byte word, and neighbouring threads' units are
// neighbouring words.
__device__ __forceinline__ void group_planes(const uint8_t *xs, int h, uint32_t (&p)[8]) {
  const uint4 *s4 = (const uint4 *)xs;
  const int u = h / kGroups, j = h % kGroups;
  const uint4 a = s4[8 * u + ((2 * j) ^ (u & 7))];
  const uint4 b = s4[8 * u + ((2 * j + 1) ^ (u & 7))];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  bit_planes(w, p);
}

// m[j] bit l = 1 where position l of the thread's group j differs from its
// partner at offset d (= 32q + r): every plane of the group XOR its partner
// plane, ORed together.  g[2 + j] holds the planes of group j, g[0] and
// g[1] those of the two groups before the unit.  The partner plane is
// funnelshift_l(plane of group j - q - 1, plane of group j - q, r).
//
// d < 64: the partners are in registers.
__device__ __forceinline__ void mismatch_near(const uint32_t (&g)[kGroups + 2][8],
                                              int d, uint32_t (&m)[kGroups]) {
  const int r = d & 31;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) m[j] = 0;
  if (d < 32) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[j] |= g[j + 2][k] ^ __funnelshift_l(g[j + 1][k], g[j + 2][k], r);
  } else if (r == 0) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) m[j] |= g[j + 2][k] ^ g[j + 1][k];
  } else {
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[j] |= g[j + 2][k] ^ __funnelshift_l(g[j][k], g[j + 1][k], r);
  }
}

// 64 <= d <= kHalo: the partners are planes in shared memory.  The
// groups h0 - q - 1 .. h0 - q + 3 of the thread's unit at group h0 lie in
// the 8 groups from the 16-byte word w0, at kM = 3 - q % 4 and after; a
// plane takes one 16-byte load when q % 4 == 0 and r == 0 (6 of the 9
// default offsets of this range: the word before is not needed), two
// otherwise.
template <int kQ4, bool kShift>
__device__ __forceinline__ void mismatch_window(const uint32_t *planes, int h0,
                                                const uint32_t (&g)[kGroups + 2][8],
                                                int d, uint32_t (&m)[kGroups]) {
  constexpr int kM = 3 - kQ4;
  constexpr bool kLow = kShift || kQ4 != 0;  // the first word is read
  const int q = d >> 5, r = d & 31;
  const uint32_t *w0 = planes + h0 - q - 1 - kM;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) m[j] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 a = kLow ? *(const uint4 *)(w0 + k * kSpanGroups) : make_uint4(0, 0, 0, 0);
    const uint4 b = *(const uint4 *)(w0 + k * kSpanGroups + 4);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const uint32_t partner =
          kShift ? __funnelshift_l(w[kM + j], w[kM + 1 + j], r) : w[kM + 1 + j];
      m[j] |= g[j + 2][k] ^ partner;
    }
  }
}

template <bool kShift>
__device__ __forceinline__ void mismatch_shared(const uint32_t *planes, int h0,
                                                const uint32_t (&g)[kGroups + 2][8],
                                                int d, uint32_t (&m)[kGroups]) {
  switch ((d >> 5) & 3) {
    case 0: mismatch_window<0, kShift>(planes, h0, g, d, m); break;
    case 1: mismatch_window<1, kShift>(planes, h0, g, d, m); break;
    case 2: mismatch_window<2, kShift>(planes, h0, g, d, m); break;
    default: mismatch_window<3, kShift>(planes, h0, g, d, m); break;
  }
}

// The lowest b bits, for any b.
__device__ __forceinline__ uint32_t bits_below(int b) {
  return b <= 0 ? 0u : b >= 32 ? 0xffffffffu : (1u << b) - 1u;
}

// Positions p of the unit at pu with lo <= p < hi and a 0 in m.  The
// masks clear what lies before the offset on a row's first tile (the
// halo there is never loaded) and past the row's or the tile's end.
__device__ __forceinline__ uint32_t count_equal(const uint32_t (&m)[kGroups], int pu,
                                                int lo, int hi) {
  uint32_t c = 0;
  if (pu >= lo && pu + kUnit <= hi) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) c += __popc(m[j]);
    return kUnit - c;
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int pg = pu + 32 * j;
    c += __popc(~m[j] & bits_below(hi - pg) & ~bits_below(lo - pg));
  }
  return c;
}

// An offset above the halo: byte by byte, partners from device memory.
__device__ __forceinline__ uint32_t count_far_bytes(const uint8_t *x, int pu, int end,
                                                    int d) {
  uint32_t c = 0;
  const int stop = min(pu + kUnit, end);
  for (int p = max(pu, d); p < stop; ++p) c += x[p] == x[p - d];
  return c;
}

// kCountBlocks blocks an SM: 6 x 128 threads at 80 registers, 6 x 35.5 KB
// of shared memory.
constexpr int kCountBlocks = 6;

template <bool kVec>
__global__ void __launch_bounds__(kCountThreads, kCountBlocks)
match_count(const uint8_t *__restrict__ segs, const int32_t *__restrict__ offsets,
            int n, int32_t *__restrict__ counts, int64_t nseg, int seg) {
  __shared__ __align__(16) uint8_t xs[kHalo + kTile];
  __shared__ __align__(16) uint32_t planes[8 * kSpanGroups];
  __shared__ int offs[kMaxOffsets];
  __shared__ int warp_counts[kCountThreads / 32][kMaxOffsets];
  const int tid = threadIdx.x;
  const int h0 = kHalo / 32 + kGroups * tid;  // this thread's first group of the span
  const int64_t tiles = (seg + kTile - 1) / kTile;
  const int64_t total = nseg * tiles;
  if (tid < n) offs[tid] = offsets[tid];
  // tile t is row t / tiles, positions from (t % tiles) * kTile
  auto stage_tile = [&](int64_t t) {
    const int64_t r = t / tiles;
    const int p0 = (int)(t - r * tiles) * kTile;
    stage_count<kVec>(xs, segs + r * seg, p0 - kHalo, min(p0 + kTile, seg), seg);
  };
  if (blockIdx.x < total) stage_tile(blockIdx.x);
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const int64_t r = t / tiles;
    const int p0 = (int)(t - r * tiles) * kTile;
    const uint8_t *x = segs + r * seg;
    const int end = min(p0 + kTile, seg);
    const int pu = p0 + kUnit * tid;  // this thread's first position
    const bool active = pu < end;
    wait_staged<kVec>();
    // the halo's 32 groups, one a lane of the first warp (not on a row's
    // first tile: its halo is never loaded)
    if (p0 > 0 && tid < kHalo / 32) {
      uint32_t p[8];
      group_planes(xs, tid, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) planes[k * kSpanGroups + tid] = p[k];
    }
    uint32_t g[kGroups + 2][8];
    if (active) {
#pragma unroll
      for (int j = 0; j < kGroups; ++j) group_planes(xs, h0 + j, g[2 + j]);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        *(uint4 *)(planes + k * kSpanGroups + h0) = make_uint4(g[2][k], g[3][k], g[4][k], g[5][k]);
    }
    __syncthreads();
    // the bytes are in planes now: stage the block's next tile behind the
    // counts of this one
    if (t + gridDim.x < total) stage_tile(t + gridDim.x);
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint2 prev = *(const uint2 *)(planes + k * kSpanGroups + h0 - 2);
        g[0][k] = prev.x;
        g[1][k] = prev.y;
      }
    }
    for (int i = 0; i < n; ++i) {
      const int d = offs[i];
      uint32_t c = 0;
      if (active && d >= 1) {
        if (d > kHalo) {
          c = count_far_bytes(x, pu, end, d);
        } else {
          uint32_t m[kGroups];
          if (d < 64)
            mismatch_near(g, d, m);
          else if (d % 32 == 0)
            mismatch_shared<false>(planes, h0, g, d, m);
          else
            mismatch_shared<true>(planes, h0, g, d, m);
          c = count_equal(m, pu, d, end);
        }
      }
      // every lane stores the warp's sum to the same word
      warp_counts[tid / 32][i] = (int)__reduce_add_sync(0xffffffffu, c);
    }
    __syncthreads();
    if (tid < n) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kCountThreads / 32; ++w) c += warp_counts[w][tid];
      if (c != 0) atomicAdd(&counts[r * n + tid], c);
    }
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
    match_count<true><<<grid, kCountThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)segs, (const int32_t *)offsets, (int)n,
        (int32_t *)counts, nseg, (int)seg);
  else
    match_count<false><<<grid, kCountThreads, 0, (cudaStream_t)stream>>>(
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
