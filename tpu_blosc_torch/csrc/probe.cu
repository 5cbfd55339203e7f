// Compressibility probe over 1 MiB tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _probe_runs and _probe_bytesum (_make_probe over
// _runs_kernel and _bytesum_kernel, tpu_blosc/filters/pallas_kernels.py:
// 80-126).  The input is tiles * 2^18 little-endian 32-bit words (the
// (rows, 512) int32 layout of probe_ready, 512 rows to a tile).  For each
// tile it writes two int32 sums:
//
//     out[2*i]     = the count of equal adjacent byte pairs inside each
//                    word, bytes (0,1), (1,2), (2,3): 3 of every 4 pairs
//     out[2*i + 1] = the sum of all bytes (at most 255 * 2^20, no wrap)
//
// On the TPU these are two kernels only because Mosaic hung on two
// reduction chains in one kernel; here one pass computes both.
//
// What bounds it: bytes.  Each word is read once, as part of a 16-byte
// vector load, and costs a few integer instructions (__vcmpeq4 for the
// byte compares, __vsadu4 for the byte sum).  kBlocksPerTile thread blocks
// share a tile; each reduces its slice by warp shuffles and shared memory
// and adds its two partial sums to the tile's with one atomicAdd each.
// Integer addition is exact in any order, so the result does not depend on
// the order the blocks run in.  The caller zeroes out first.
//
// The launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTileVecs = (int64_t{1} << 20) / 16;  // uint4 per tile
constexpr int kBlocksPerTile = 16;
constexpr int kVecsPerBlock = (int)(kTileVecs / kBlocksPerTile);  // 4096

__device__ __forceinline__ void add_word(uint32_t w, uint32_t &runs,
                                         uint32_t &sum) {
  const uint32_t eq = __vcmpeq4(w ^ (w >> 8), 0u) & 0x00FFFFFFu;
  runs += __popc(eq) >> 3;
  sum += __vsadu4(w, 0u);
}

__global__ void __launch_bounds__(kThreads)
probe_tiles(const uint4 *__restrict__ words, int32_t *__restrict__ out) {
  const int64_t tile = blockIdx.x / kBlocksPerTile;
  const uint4 *v = words + (int64_t)blockIdx.x * kVecsPerBlock;
  uint32_t runs = 0, sum = 0;
  for (int k = threadIdx.x; k < kVecsPerBlock; k += kThreads) {
    const uint4 q = v[k];
    add_word(q.x, runs, sum);
    add_word(q.y, runs, sum);
    add_word(q.z, runs, sum);
    add_word(q.w, runs, sum);
  }
  for (int off = 16; off > 0; off >>= 1) {
    runs += __shfl_down_sync(0xFFFFFFFFu, runs, off);
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
  }
  __shared__ uint32_t part[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = runs;
    part[1][warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t r = 0, s = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      r += part[0][i];
      s += part[1][i];
    }
    atomicAdd(&out[2 * tile], (int32_t)r);
    atomicAdd(&out[2 * tile + 1], (int32_t)s);
  }
}

}  // namespace

extern "C" {

// words: tiles * 2^20 bytes on the device, 16-byte aligned; out: 2*tiles
// int32 on the device, zeroed by the caller.
int tpbt_probe_tiles(const void *words, int64_t tiles, void *out,
                     void *stream) {
  if (tiles < 0 || tiles > (int64_t{1} << 26) ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  probe_tiles<<<(unsigned)(tiles * kBlocksPerTile), kThreads, 0,
                (cudaStream_t)stream>>>((const uint4 *)words, (int32_t *)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
