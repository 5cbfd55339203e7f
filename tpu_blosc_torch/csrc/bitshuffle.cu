// Per-block bit shuffle and bit unshuffle for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA device programs _bit_shuffle_batch_dev and
// _bit_unshuffle_batch_dev (tpu_blosc/filters/batched.py:65-79) and their
// SWAR word forms (_SWAR_BIT_SHUFFLE / _SWAR_BIT_UNSHUFFLE, :442-453):
// the reference's LOCAL bit shuffle (tpu_blosc/filters/reference.py:69-110).
// Within each group of 8 elements (8*ts bytes), the 8 bytes at byte
// position j go through an MSB-first 8x8 bit transpose to
//
//     shuffle:    dst[g*8ts + j*8 + o] = bit-transpose(src[g*8ts + e*ts + j], e < 8)[o]
//     unshuffle:  the inverse (the transpose is an involution); a block whose
//                 keep_raw[b] is non-zero is copied verbatim (it was stored
//                 raw in the frame).
//
// A group's output fills exactly the 8*ts bytes its input came from, so the
// filter is local to 8*ts-byte chunks: no shared memory, no cross-thread
// data.  The launchers take blocks of bs bytes with bs % (8*ts) == 0 (every
// block chunk.choose_block_size gives), so the nb blocks are one run of
// nb*bs/(8*ts) groups, and the block only matters for keep_raw.
//
// What bounds it: 2*n bytes of device memory per pass and about 24 word
// operations (the transpose8 butterfly of Hacker's Delight, as in
// tpu_blosc/filters/jaxops.py:54-99) per 8 bytes, well under what the SMs
// issue at that byte rate.  The launcher picks one of two paths:
//
// vec16: ts in {2, 4, 8, 16} and both pointers on 16-byte boundaries.  One
//   thread owns one group: it loads the group's 8*ts bytes as 16-byte
//   vectors, packs each byte position's 8 bytes into two big-endian words
//   with PRMT (__byte_perm), transposes them in registers and stores the
//   8*ts output bytes as 16-byte vectors.
//
// generic: every other type size and alignment (ts 3, 5, 32, 300; views off
//   a 16-byte boundary).  One thread owns one (group, byte position) pair,
//   with byte loads and stores: neighbouring threads take neighbouring byte
//   positions, so a warp's accesses stay within a few cache lines.
//
// Each launcher checks its geometry and returns cudaErrorInvalidValue when
// it does not hold, runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = int64_t{1} << 20;

// MSB-first 8x8 bit transpose of the bytes p0..p7 packed big-endian as
// x = p0 p1 p2 p3, y = p4 p5 p6 p7 (tpu_blosc/filters/jaxops.py:73-86).
__device__ __forceinline__ void transpose8(uint32_t &x, uint32_t &y) {
  uint32_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AAu;
  x = x ^ t ^ (t << 7);
  t = (y ^ (y >> 7)) & 0x00AA00AAu;
  y = y ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCCu;
  x = x ^ t ^ (t << 14);
  t = (y ^ (y >> 14)) & 0x0000CCCCu;
  y = y ^ t ^ (t << 14);
  t = (x & 0xF0F0F0F0u) | ((y >> 4) & 0x0F0F0F0Fu);
  y = ((x << 4) & 0xF0F0F0F0u) | (y & 0x0F0F0F0Fu);
  x = t;
}

// a << 24 | b << 16 | c << 8 | d, where a is byte ka of word wa, and so on
// (three PRMTs; the byte numbers are compile-time after unrolling)
__device__ __forceinline__ uint32_t be_word(uint32_t wa, int ka, uint32_t wb,
                                           int kb, uint32_t wc, int kc,
                                           uint32_t wd, int kd) {
  const uint32_t lo = __byte_perm(wd, wc, kd | (4 + kc) << 4);  // c << 8 | d
  const uint32_t hi = __byte_perm(wb, wa, kb | (4 + ka) << 4);  // a << 8 | b
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint32_t bswap(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// ---- vec16 path --------------------------------------------------------

// W: the group's 2*TS little-endian words; element e's byte j is byte
// (e*TS + j) % 4 of word (e*TS + j) / 4.
template <int TS>
__device__ __forceinline__ void shuffle_group(const uint32_t (&w)[2 * TS],
                                              uint32_t (&o)[2 * TS]) {
#pragma unroll
  for (int j = 0; j < TS; j++) {
    uint32_t x = be_word(w[(0 * TS + j) / 4], (0 * TS + j) % 4,
                         w[(1 * TS + j) / 4], (1 * TS + j) % 4,
                         w[(2 * TS + j) / 4], (2 * TS + j) % 4,
                         w[(3 * TS + j) / 4], (3 * TS + j) % 4);
    uint32_t y = be_word(w[(4 * TS + j) / 4], (4 * TS + j) % 4,
                         w[(5 * TS + j) / 4], (5 * TS + j) % 4,
                         w[(6 * TS + j) / 4], (6 * TS + j) % 4,
                         w[(7 * TS + j) / 4], (7 * TS + j) % 4);
    transpose8(x, y);
    // output bytes j*8 .. j*8+7 are x's then y's, most significant first
    o[2 * j] = bswap(x);
    o[2 * j + 1] = bswap(y);
  }
}

template <int TS>
__device__ __forceinline__ void unshuffle_group(const uint32_t (&w)[2 * TS],
                                                uint32_t (&o)[2 * TS]) {
  uint32_t x[TS], y[TS];
#pragma unroll
  for (int j = 0; j < TS; j++) {
    x[j] = bswap(w[2 * j]);
    y[j] = bswap(w[2 * j + 1]);
    transpose8(x[j], y[j]);
  }
  // output byte i = e*TS + j is element e's byte j: byte 3-e of x[j] for
  // e < 4, byte 7-e of y[j] for e >= 4
#pragma unroll
  for (int k = 0; k < 2 * TS; k++) {
    uint32_t src[4];
    int sel[4];
#pragma unroll
    for (int m = 0; m < 4; m++) {
      const int i = 4 * k + m, e = i / TS, j = i % TS;
      src[m] = e < 4 ? x[j] : y[j];
      sel[m] = e < 4 ? 3 - e : 7 - e;
    }
    o[k] = be_word(src[3], sel[3], src[2], sel[2], src[1], sel[1], src[0], sel[0]);
  }
}

template <int TS, bool kShuffle>
__global__ void __launch_bounds__(kThreads)
vec16_groups(const uint8_t *__restrict__ src, uint8_t *__restrict__ dst,
             const uint8_t *__restrict__ keep_raw, int64_t ngroups,
             int64_t groups_per_block) {
  constexpr int kVecs = TS / 2;  // 16-byte vectors in a group's 8*TS bytes
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < ngroups;
       g += stride) {
    const uint4 *s = reinterpret_cast<const uint4 *>(src + g * 8 * TS);
    uint4 *d = reinterpret_cast<uint4 *>(dst + g * 8 * TS);
    if (!kShuffle && keep_raw != nullptr && keep_raw[g / groups_per_block]) {
#pragma unroll
      for (int v = 0; v < kVecs; v++) d[v] = s[v];
      continue;
    }
    uint32_t w[2 * TS], o[2 * TS];
#pragma unroll
    for (int v = 0; v < kVecs; v++) {
      const uint4 q = s[v];
      w[4 * v] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
    if (kShuffle)
      shuffle_group<TS>(w, o);
    else
      unshuffle_group<TS>(w, o);
#pragma unroll
    for (int v = 0; v < kVecs; v++)
      d[v] = make_uint4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
  }
}

// ---- generic path ------------------------------------------------------

// One thread per (group g, byte position j): item = g*ts + j.
template <bool kShuffle>
__global__ void __launch_bounds__(kThreads)
generic_groups(const uint8_t *__restrict__ src, uint8_t *__restrict__ dst,
               const uint8_t *__restrict__ keep_raw, int64_t nitems, int64_t ts,
               int64_t groups_per_block) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       item < nitems; item += stride) {
    const int64_t g = item / ts, j = item - g * ts;
    const uint8_t *s = src + g * 8 * ts;
    uint8_t *d = dst + g * 8 * ts;
    uint32_t x = 0, y = 0;
    if (kShuffle) {
      // element e's byte j, e = 0..7
#pragma unroll
      for (int e = 0; e < 4; e++) {
        x = x << 8 | s[e * ts + j];
        y = y << 8 | s[(e + 4) * ts + j];
      }
      transpose8(x, y);
#pragma unroll
      for (int o = 0; o < 4; o++) {
        d[j * 8 + o] = (uint8_t)(x >> (24 - 8 * o));
        d[j * 8 + 4 + o] = (uint8_t)(y >> (24 - 8 * o));
      }
    } else if (keep_raw != nullptr && keep_raw[g / groups_per_block]) {
#pragma unroll
      for (int o = 0; o < 8; o++) d[j * 8 + o] = s[j * 8 + o];
    } else {
#pragma unroll
      for (int o = 0; o < 4; o++) {
        x = x << 8 | s[j * 8 + o];
        y = y << 8 | s[j * 8 + 4 + o];
      }
      transpose8(x, y);
#pragma unroll
      for (int e = 0; e < 4; e++) {
        d[e * ts + j] = (uint8_t)(x >> (24 - 8 * e));
        d[(e + 4) * ts + j] = (uint8_t)(y >> (24 - 8 * e));
      }
    }
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxGrid ? blocks : kMaxGrid);
}

bool vec16_fits(const void *src, const void *dst, int64_t ts) {
  return (ts == 2 || ts == 4 || ts == 8 || ts == 16) &&
         (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0;
}

template <bool kShuffle>
int launch(const void *src, void *dst, const void *keep_raw, int64_t nb,
           int64_t bs, int64_t ts, void *stream) {
  if (nb < 0 || ts < 2 || bs < 8 * ts || bs % (8 * ts) != 0)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const auto *s = (const uint8_t *)src;
  auto *d = (uint8_t *)dst;
  const auto *k = (const uint8_t *)keep_raw;
  const int64_t gpb = bs / (8 * ts), ngroups = nb * gpb;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16_fits(src, dst, ts)) {
    const unsigned grid = grid_for(ngroups);
    switch (ts) {
      case 2: vec16_groups<2, kShuffle><<<grid, kThreads, 0, st>>>(s, d, k, ngroups, gpb); break;
      case 4: vec16_groups<4, kShuffle><<<grid, kThreads, 0, st>>>(s, d, k, ngroups, gpb); break;
      case 8: vec16_groups<8, kShuffle><<<grid, kThreads, 0, st>>>(s, d, k, ngroups, gpb); break;
      default: vec16_groups<16, kShuffle><<<grid, kThreads, 0, st>>>(s, d, k, ngroups, gpb); break;
    }
  } else {
    const int64_t nitems = ngroups * ts;
    generic_groups<kShuffle><<<grid_for(nitems), kThreads, 0, st>>>(s, d, k, nitems, ts, gpb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src, dst: nb*bs bytes on the device, not overlapping; bs % (8*ts) == 0.
int tpbt_bitshuffle_blocks(const void *src, void *dst, int64_t nb, int64_t bs,
                           int64_t ts, void *stream) {
  return launch<true>(src, dst, nullptr, nb, bs, ts, stream);
}

// keep_raw: nb bytes on the device (non-zero = copy block b verbatim), or
// null when no block was stored raw.
int tpbt_bitunshuffle_blocks(const void *src, void *dst, const void *keep_raw,
                             int64_t nb, int64_t bs, int64_t ts, void *stream) {
  return launch<false>(src, dst, keep_raw, nb, bs, ts, stream);
}

}  // extern "C"
