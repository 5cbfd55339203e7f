// Per-block byte shuffle and unshuffle for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels byte_plane_split and byte_plane_merge
// (tpu_blosc/filters/pallas_kernels.py:292-333), and with them the XLA
// SWAR and u8 shuffle bodies of tpu_blosc/filters/batched.py, which carry
// type sizes 8, 16 and odd sizes on the TPU.  Every type size from 2 up to
// the block size is served.
//
// For each block b of bs bytes, element i < ne = bs/ts and byte c < ts:
//
//     shuffle:    dst[b*bs + c*ne + i] = src[b*bs + i*ts + c]
//     unshuffle:  the inverse; a block whose keep_raw[b] is non-zero is
//                 copied verbatim (it was stored raw in the frame).
//
// What bounds it: it computes nothing, so device-memory bytes bound it,
// 2*n bytes per pass (each byte read once and written once).  The element
// side of a block (its bytes in element order) is one contiguous span; the
// plane side is ts contiguous runs of ne bytes.  Each launcher takes one of
// two paths, which the caller names (filters/kernels.py shuffle_path):
//
// vec16: ts in {2, 4, 8, 16}, ne % 16 == 0, bs < 2^31, and src and dst on
//   16-byte boundaries (every default block size).  A thread owns groups of
//   16 elements: 16*ts element-side bytes and 16 bytes of each plane, so
//   every device-memory access is a 16-byte vector.  Persistent thread
//   blocks walk a contiguous range of tiles of 256 groups (or of whole
//   blocks, when a block has fewer groups), with a ring of kStages tiles in
//   shared memory filled by cp.async, so the next tiles' loads are in
//   flight while this one is transposed and stored.  The element side of a
//   tile is staged with an XOR swizzle of its 16-byte chunks, so a warp
//   reading or writing a group's ts chunks touches every bank group once.
//   The transpose runs on 32-bit words with PRMT (__byte_perm): a 4x4 byte
//   transpose is 8 PRMTs; ts 8 and 16 are 2 and 4 of them per 4 elements,
//   ts 2 a 2x2 over half-words.  Shuffle: element side cp.async -> shared
//   -> registers -> 16-byte stores, one per plane, 512 contiguous bytes per
//   plane per warp.  Unshuffle: plane runs cp.async -> shared -> registers
//   -> shared (in place, swizzled) -> 16-byte stores of the element side.
//   A raw block's groups are copied with 16-byte loads instead.  Offsets
//   within a block are 32-bit, one 64-bit base per block.
//
// generic: every other geometry (odd ts, ts >= 32, ne % 16 != 0, unaligned
//   views).  Each block is a byte matrix, transposed through a tile of up
//   to 16 KiB in shared memory with an odd row pitch: rows are loaded
//   contiguously and columns stored contiguously, one byte per thread.  A
//   grid-stride loop walks all tiles; tile coordinates advance by adding a
//   precomputed stride, and each thread walks its tile by addition, with
//   32-bit offsets from one 64-bit base per tile (64-bit offsets only where
//   a tile's reach passes 2^31).
//
// Each launcher checks the named path's preconditions and returns
// cudaErrorInvalidValue when they do not hold (it never takes the other
// path instead), runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

enum Path { kGeneric = 0, kVec16 = 1 };

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// ---- generic path ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int64_t kTileBytes = 16384;
constexpr int64_t kMaxEdge = 256;
constexpr int64_t kMaxGrid = int64_t{1} << 20;

struct GenericArgs {
  const uint8_t *src;
  uint8_t *dst;
  const uint8_t *keep_raw;
  int64_t nb, rows, cols;
  int tr, tc;
  int64_t tiles_r, tiles_c;          // tiles per matrix along each axis
  int64_t step_b, step_r, step_c;    // gridDim.x as (matrices, tile rows, tile cols)
};

// Matrix b (of nb) is rows x cols bytes at src + b*rows*cols, row-major;
// its transpose (cols x rows) goes to dst + b*rows*cols.  Tiles of
// tr x tc bytes; grid-stride over all tiles of all matrices.  Off is the
// type of offsets within a tile: int32_t unless they could pass 2^31.
template <typename Off>
__global__ void __launch_bounds__(kThreads, 8)
transpose_blocks(const GenericArgs a) {
  extern __shared__ uint8_t tile[];
  const int T = kThreads;
  const int pitch = a.tc | 1;
  const Off rows = (Off)a.rows, cols = (Off)a.cols;
  const int64_t mat = a.rows * a.cols;
  const int64_t per_mat = a.tiles_r * a.tiles_c;
  int64_t b = blockIdx.x / per_mat;
  int64_t ri = blockIdx.x % per_mat / a.tiles_c;
  int64_t ci = blockIdx.x % a.tiles_c;
  while (b < a.nb) {
    const int64_t r0 = ri * a.tr, c0 = ci * a.tc;
    const int h = (int)min64(a.rows - r0, a.tr);
    const int w = (int)min64(a.cols - c0, a.tc);
    const int n = h * w;
    // the tile's first byte in src (and, for a raw block, in dst)
    const uint8_t *s = a.src + b * mat + r0 * a.cols + c0;
    // walk the tile row by row (contiguous in src): c its column, off its
    // offset from s, si its index in shared memory
    const int dr = T / w, dc = T % w;
    const Off step = (Off)dr * cols + dc, wrap = cols - w;
    int c = threadIdx.x % w;
    Off off = (Off)(threadIdx.x / w) * cols + c;
    if (a.keep_raw != nullptr && a.keep_raw[b]) {
      // a raw block: this tile's bytes pass through in place (b is the
      // same for the whole thread block, so no thread skips a barrier)
      uint8_t *d = a.dst + (s - a.src);
      for (int k = threadIdx.x; k < n; k += T) {
        d[off] = s[off];
        off += step;
        c += dc;
        if (c >= w) {
          c -= w;
          off += wrap;
        }
      }
    } else {
      int si = threadIdx.x / w * pitch + c;
      for (int k = threadIdx.x; k < n; k += T) {
        tile[si] = s[off];
        off += step;
        si += dr * pitch + dc;
        c += dc;
        if (c >= w) {
          c -= w;
          off += wrap;
          si += pitch - w;
        }
      }
      __syncthreads();
      // walk the tile column by column (contiguous in dst)
      uint8_t *d = a.dst + b * mat + c0 * a.rows + r0;
      const int sc = T / h, sr = T % h;
      const Off ostep = (Off)sc * rows + sr, owrap = rows - h;
      int r = threadIdx.x % h;
      Off o = (Off)(threadIdx.x / h) * rows + r;
      si = r * pitch + threadIdx.x / h;
      for (int k = threadIdx.x; k < n; k += T) {
        d[o] = tile[si];
        o += ostep;
        si += sr * pitch + sc;
        r += sr;
        if (r >= h) {
          r -= h;
          o += owrap;
          si += 1 - h * pitch;
        }
      }
      __syncthreads();
    }
    // next tile: add the grid's stride with carries
    ci += a.step_c;
    if (ci >= a.tiles_c) {
      ci -= a.tiles_c;
      ++ri;
    }
    ri += a.step_r;
    if (ri >= a.tiles_r) {
      ri -= a.tiles_r;
      ++b;
    }
    b += a.step_b;
  }
}

int launch_generic(const void *src, void *dst, const void *keep_raw,
                   int64_t nb, int64_t rows, int64_t cols, int64_t tr,
                   int64_t tc, void *stream) {
  GenericArgs a;
  a.src = (const uint8_t *)src;
  a.dst = (uint8_t *)dst;
  a.keep_raw = (const uint8_t *)keep_raw;
  a.nb = nb;
  a.rows = rows;
  a.cols = cols;
  a.tr = (int)tr;
  a.tc = (int)tc;
  a.tiles_r = (rows + tr - 1) / tr;
  a.tiles_c = (cols + tc - 1) / tc;
  const int64_t per_mat = a.tiles_r * a.tiles_c;
  const int64_t grid = std::min(nb * per_mat, kMaxGrid);
  a.step_b = grid / per_mat;
  a.step_r = grid % per_mat / a.tiles_c;
  a.step_c = grid % a.tiles_c;
  const size_t smem = (size_t)tr * (size_t)(tc | 1);
  // an offset within a tile, or a thread's step through one (including
  // the step past its last byte), is below (kThreads + tile edge + 1) *
  // matrix edge
  const int64_t reach =
      std::max((kThreads + tr + 1) * cols, (kThreads + tc + 1) * rows);
  if (reach < (int64_t{1} << 31))
    transpose_blocks<int32_t>
        <<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  else
    transpose_blocks<int64_t>
        <<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- vec16 path ------------------------------------------------------

constexpr int kVecThreads = 256;  // one 16-element group per thread
constexpr int kStages = 3;        // tiles in the shared-memory ring
constexpr int kMaxDevices = 64;

struct Vec16Args {
  const uint8_t *src;
  uint8_t *dst;
  const uint8_t *keep_raw;
  int64_t nb, bs;
  int64_t ntiles, per_cta;  // tiles in all, and per thread block
  int ne, gpb;              // elements and 16-element groups per block
  // a tile is bpt whole blocks (gpb <= 256, cpb == 1) or one of cpb
  // chunks of 256 groups of one block (gpb > 256, bpt == 1)
  int bpt, cpb;
};

__device__ __forceinline__ void cp_async16(uint32_t smem, const void *gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where 16-byte chunk q of a tile's element side lies in shared memory.
// Thread t reads or writes chunks ts*t .. ts*t+ts-1; XOR-ing the low bits
// of q with the low bits of the group index spreads the 8 lanes of each
// 128-byte phase over the 8 bank groups, and 8 aligned consecutive chunks
// (a coalesced copy) stay in their own 8 slots.
template <int TS>
__device__ __forceinline__ uint32_t swizzle(uint32_t q) {
  return q ^ ((q >> (TS == 16 ? 4 : 3)) & (TS >= 8 ? 7 : TS - 1));
}

// 4x4 byte transpose: o[i*stride] holds byte i of a, b, c and d.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t *o,
                                           int stride) {
  const uint32_t x0 = __byte_perm(a, b, 0x5140), x1 = __byte_perm(a, b, 0x7362);
  const uint32_t y0 = __byte_perm(c, d, 0x5140), y1 = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[stride] = __byte_perm(x0, y0, 0x7632);
  o[2 * stride] = __byte_perm(x1, y1, 0x5410);
  o[3 * stride] = __byte_perm(x1, y1, 0x7632);
}

// One group: w holds 16 elements of TS bytes (4*TS words, element order),
// p the same bytes as TS planes of 16 bytes (word 4*c + q of plane c).
template <int TS>
__device__ __forceinline__ void to_planes(const uint32_t *w, uint32_t *p) {
  if constexpr (TS == 2) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p[q] = __byte_perm(w[2 * q], w[2 * q + 1], 0x6420);
      p[4 + q] = __byte_perm(w[2 * q], w[2 * q + 1], 0x7531);
    }
  } else {
    constexpr int W = TS / 4;  // words per element
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(w[4 * q * W + j], w[(4 * q + 1) * W + j],
                   w[(4 * q + 2) * W + j], w[(4 * q + 3) * W + j],
                   &p[16 * j + q], 4);
  }
}

template <int TS>
__device__ __forceinline__ void to_elements(const uint32_t *p, uint32_t *w) {
  if constexpr (TS == 2) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[2 * q] = __byte_perm(p[q], p[4 + q], 0x5140);
      w[2 * q + 1] = __byte_perm(p[q], p[4 + q], 0x7362);
    }
  } else {
    constexpr int W = TS / 4;
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(p[16 * j + q], p[16 * j + 4 + q], p[16 * j + 8 + q],
                   p[16 * j + 12 + q], &w[4 * q * W + j], W);
  }
}

__device__ __forceinline__ void load16(const void *ptr, uint32_t *w) {
  const uint4 v = *(const uint4 *)ptr;
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void store16(void *ptr, const uint32_t *w) {
  *(uint4 *)ptr = make_uint4(w[0], w[1], w[2], w[3]);
}

// A tile: its first block b and, when a block spans several tiles, which
// chunk k of that block.
struct Cursor {
  int64_t b;
  int k;
  __device__ void advance(const Vec16Args &a) {
    if (++k == a.cpb) {
      k = 0;
      b += a.bpt;
    }
  }
  __device__ int blocks(const Vec16Args &a) const {
    return (int)min64(a.bpt, a.nb - b);
  }
  // groups in the tile
  __device__ int groups(const Vec16Args &a) const {
    return a.cpb == 1 ? blocks(a) * a.gpb
                      : min(kVecThreads, a.gpb - k * kVecThreads);
  }
  // offset of the tile's element side (one contiguous span)
  __device__ int64_t base(const Vec16Args &a, int ts) const {
    return b * a.bs + (int64_t)k * kVecThreads * 16 * ts;
  }
};

template <int TS, bool kShuffle>
__global__ void __launch_bounds__(kVecThreads)
vec16_blocks(__grid_constant__ const Vec16Args a) {
  extern __shared__ __align__(128) uint8_t ring[];
  constexpr int T = kVecThreads;
  constexpr uint32_t kStage = T * 16 * TS;  // bytes of one tile
  const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(ring);
  const int t = threadIdx.x;
  // this thread's group in every tile: block tb of the tile, group tj of
  // that block (plus the tile's chunk offset k*T)
  const int tb = a.cpb == 1 ? t / a.gpb : 0;
  const int tj = a.cpb == 1 ? t - tb * a.gpb : t;
  const int64_t first = blockIdx.x * a.per_cta;
  const int n = (int)min64(a.per_cta, a.ntiles - first);

  auto fetch = [&](int stage, const Cursor &c) {
    const uint32_t s = ring0 + stage * kStage;
    const uint8_t *g = a.src + c.base(a, TS);
    if (kShuffle) {
      // the element side, swizzled
      const int chunks = c.groups(a) * TS;
      for (int q = t; q < chunks; q += T)
        cp_async16(s + 16 * swizzle<TS>(q), g + 16 * q);
    } else if (a.cpb == 1) {
      // whole blocks: their plane runs are one contiguous span
      const int chunks = c.blocks(a) * a.gpb * TS;
      for (int q = t; q < chunks; q += T) cp_async16(s + 16 * q, g + 16 * q);
    } else if (t < c.groups(a)) {
      // chunk k of each plane run of block b: run c at c*16*T
      const uint8_t *gp = a.src + c.b * a.bs + 16 * (c.k * T + t);
      for (int p = 0; p < TS; ++p)
        cp_async16(s + 16 * (p * T + t), gp + (int64_t)p * a.ne);
    }
  };

  auto process = [&](int stage, const Cursor &c) {
    uint8_t *s = ring + stage * kStage;
    const int64_t blk = c.b + tb;
    const int j = c.k * T + tj;
    const bool active = tb < c.blocks(a) && j < a.gpb;
    uint32_t w[4 * TS], p[4 * TS];
    if (kShuffle) {
      if (!active) return;
#pragma unroll
      for (int i = 0; i < TS; ++i)
        load16(s + 16 * swizzle<TS>(TS * t + i), &w[4 * i]);
      to_planes<TS>(w, p);
      uint8_t *d = a.dst + blk * a.bs + 16 * j;
#pragma unroll
      for (int i = 0; i < TS; ++i) store16(d + i * a.ne, &p[4 * i]);
      return;
    }
    const bool raw = active && a.keep_raw != nullptr && a.keep_raw[blk];
    if (raw) {
      const uint8_t *g = a.src + blk * a.bs + 16 * TS * j;
#pragma unroll
      for (int i = 0; i < TS; ++i) load16(g + 16 * i, &w[4 * i]);
    } else if (active) {
      const int pitch = a.cpb == 1 ? a.gpb : T;  // chunks between planes
      const uint8_t *sp = s + 16 * (tb * a.gpb * TS + tj);
#pragma unroll
      for (int i = 0; i < TS; ++i) load16(sp + 16 * i * pitch, &p[4 * i]);
      to_elements<TS>(p, w);
    }
    __syncthreads();  // every plane read before the element side lands
    if (active) {
#pragma unroll
      for (int i = 0; i < TS; ++i)
        store16(s + 16 * swizzle<TS>(TS * t + i), &w[4 * i]);
    }
    __syncthreads();
    uint8_t *d = a.dst + c.base(a, TS);
    const int chunks = c.groups(a) * TS;
    for (int q = t; q < chunks; q += T) {
      uint32_t v[4];
      load16(s + 16 * swizzle<TS>(q), v);
      store16(d + 16 * q, v);
    }
  };

  Cursor load{first / a.cpb * a.bpt, (int)(first % a.cpb)};
  Cursor cur = load;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) {
      fetch(i, load);
      load.advance(a);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's, and tile i-1's stage is free again
    if (i + kStages - 1 < n) {
      fetch((i + kStages - 1) % kStages, load);
      load.advance(a);
    }
    cp_async_commit();
    process(i % kStages, cur);
    cur.advance(a);
  }
}

bool vec16_fits(const void *src, const void *dst, int64_t bs, int64_t ts) {
  return (ts == 2 || ts == 4 || ts == 8 || ts == 16) && (bs / ts) % 16 == 0 &&
         bs < (int64_t{1} << 31) && (uintptr_t)src % 16 == 0 &&
         (uintptr_t)dst % 16 == 0;
}

// resident thread blocks per SM, and SMs, of the current device
template <int TS, bool kShuffle>
int vec16_grid_limit(int smem, int *limit) {
  static std::mutex mu;
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cached[dev] == 0) {
    auto kern = vec16_blocks<TS, kShuffle>;
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kVecThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *limit = cached[dev];
  return 0;
}

template <int TS, bool kShuffle>
int launch_vec16(const void *src, void *dst, const void *keep_raw, int64_t nb,
                 int64_t bs, void *stream) {
  const int smem = kStages * kVecThreads * 16 * TS;
  int limit = 0;
  const int rc = vec16_grid_limit<TS, kShuffle>(smem, &limit);
  if (rc != 0) return rc;
  Vec16Args a;
  a.src = (const uint8_t *)src;
  a.dst = (uint8_t *)dst;
  a.keep_raw = (const uint8_t *)keep_raw;
  a.nb = nb;
  a.bs = bs;
  a.ne = (int)(bs / TS);
  a.gpb = a.ne / 16;
  if (a.gpb <= kVecThreads) {
    a.bpt = kVecThreads / a.gpb;
    a.cpb = 1;
    a.ntiles = (nb + a.bpt - 1) / a.bpt;
  } else {
    a.bpt = 1;
    a.cpb = (a.gpb + kVecThreads - 1) / kVecThreads;
    a.ntiles = nb * a.cpb;
  }
  a.per_cta = (a.ntiles + limit - 1) / limit;
  const int64_t grid = (a.ntiles + a.per_cta - 1) / a.per_cta;
  vec16_blocks<TS, kShuffle>
      <<<(unsigned)grid, kVecThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kShuffle>
int launch_vec16_ts(const void *src, void *dst, const void *keep_raw,
                    int64_t nb, int64_t bs, int64_t ts, void *stream) {
  switch (ts) {
    case 2: return launch_vec16<2, kShuffle>(src, dst, keep_raw, nb, bs, stream);
    case 4: return launch_vec16<4, kShuffle>(src, dst, keep_raw, nb, bs, stream);
    case 8: return launch_vec16<8, kShuffle>(src, dst, keep_raw, nb, bs, stream);
    default: return launch_vec16<16, kShuffle>(src, dst, keep_raw, nb, bs, stream);
  }
}

// 0 when the geometry and the path may be launched, else the error code
int refuse(const void *src, const void *dst, int64_t nb, int64_t bs,
           int64_t ts, int path) {
  const bool geometry = nb >= 0 && ts >= 2 && bs >= ts && bs % ts == 0;
  const bool fits = path == kGeneric ||
                    (path == kVec16 && vec16_fits(src, dst, bs, ts));
  return geometry && fits ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// src, dst: nb*bs bytes on the device, not overlapping.  path: 0 generic,
// 1 vec16.
int tpbt_shuffle_blocks(const void *src, void *dst, int64_t nb, int64_t bs,
                        int64_t ts, int path, void *stream) {
  if (const int rc = refuse(src, dst, nb, bs, ts, path)) return rc;
  if (nb == 0) return 0;
  if (path == kVec16)
    return launch_vec16_ts<true>(src, dst, nullptr, nb, bs, ts, stream);
  const int64_t ne = bs / ts;
  const int64_t tc = std::min(ts, kMaxEdge);
  const int64_t tr = std::min(ne, kTileBytes / tc);
  return launch_generic(src, dst, nullptr, nb, ne, ts, tr, tc, stream);
}

// keep_raw: nb bytes on the device (non-zero = copy block b verbatim), or
// null when no block was stored raw.
int tpbt_unshuffle_blocks(const void *src, void *dst, const void *keep_raw,
                          int64_t nb, int64_t bs, int64_t ts, int path,
                          void *stream) {
  if (const int rc = refuse(src, dst, nb, bs, ts, path)) return rc;
  if (nb == 0) return 0;
  if (path == kVec16)
    return launch_vec16_ts<false>(src, dst, keep_raw, nb, bs, ts, stream);
  const int64_t ne = bs / ts;
  const int64_t tr = std::min(ts, kMaxEdge);
  const int64_t tc = std::min(ne, kTileBytes / tr);
  return launch_generic(src, dst, keep_raw, nb, ts, ne, tr, tc, stream);
}

}  // extern "C"
