// The oversample skip of the DCVGO forward for Hopper (sm_90a): cumdist_thres.
//
// Counterpart of the reference's CUDA kernel ub360_utils_kernel.cu:12-32
// (cumdist_thres_cuda), which the JAX package writes as a lax.scan over the
// sample axis (unboundednerfpytorch_tpu/ops/sampling.py::cumdist_thres); no
// TPU kernel stands behind it. Per ray over S step distances, in order:
//   cum += dist_i;  out_i = cum > thres;  cum = out_i ? cum * 0 : cum
// which is the scan's cum * (1 - out_i) to the bit (a product with 1 leaves a
// float as it is). The plain version is ops/sampling.py::cumdist_thres_plain.
//
// What bounds it: the recurrence. A ray's S steps form one dependent chain
// (add, compare, select: about a dozen cycles a step), and the path has only
// 4096 rays, 128 warps for 132 multiprocessors, so the chain of 1063 steps is
// as long as moving the 4096 x 1063 floats in and the flags out (17.4 MB in,
// 4.4 MB out: 6.5 us at the H100 SXM's 3.35 TB/s). The design keeps memory
// off that chain:
//   - a thread a ray, a warp of 32 rays a block, so every multiprocessor runs
//     one chain and none waits on another;
//   - the distances arrive in tiles of 32 rays x 32 samples through a ring of
//     four tiles in shared memory, filled by 4-byte cp.async copies issued
//     three tiles ahead of the one being walked: a warp's copy of one row is
//     one coalesced request (rows are S floats apart and start anywhere, so no
//     wider vector is safe), and the loads never stall the chain;
//   - the walk reads its row of the tile at a pitch of 33 floats (no bank
//     conflict between lanes) and writes its flags to a byte tile, which the
//     warp stores row by row (32 consecutive bytes of one ray a request)
//     instead of 32 rays' bytes S apart.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 32;    // a block's rays: one warp, a thread a ray
constexpr int kTile = 32;    // samples a tile
constexpr int kStages = 4;   // tiles in the ring: three in flight beside the one walked
constexpr int kPitch = kTile + 1;
constexpr int kFlagPitch = kTile + 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

__global__ void __launch_bounds__(kRays)
cumdist_thres_kernel(const float* __restrict__ dist, float thres, int N, int S,
                     unsigned char* __restrict__ out) {
  __shared__ float tile[kStages][kRays][kPitch];
  __shared__ unsigned char flags[kRays][kFlagPitch];
  const int lane = threadIdx.x;
  const int ray0 = blockIdx.x * kRays;
  const int rays = min(kRays, N - ray0);
  const int tiles = (S + kTile - 1) / kTile;
  const float* base = dist + (long long)ray0 * S;

  // tile t: lane l copies sample t * kTile + l of each of the block's rays.
  // A group is committed even past the last tile, so that the count of
  // groups in flight stays what the wait below expects.
  auto load = [&](int t) {
    const int s = t * kTile + lane;
    if (t < tiles && s < S) {
      float* dst = &tile[t % kStages][0][lane];
      for (int r = 0; r < rays; ++r) cp_async4(dst + r * kPitch, base + (long long)r * S + s);
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) load(t);
  float cum = 0.f;
  for (int t = 0; t < tiles; ++t) {
    load(t + kStages - 1);          // into the slot walked in the last round
    cp_async_wait<kStages - 1>();   // this thread's copies of tile t have landed
    __syncwarp();                   // and so have the other lanes'
    const int n = min(kTile, S - t * kTile);
    if (lane < rays) {
      const float* row = &tile[t % kStages][lane][0];
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        cum += row[j];
        const bool over = cum > thres;
        cum = over ? cum * 0.f : cum;
        flags[lane][j] = over;
      }
    }
    __syncwarp();
    const int s = t * kTile + lane;
    if (s < S) {
      unsigned char* dst = out + (long long)ray0 * S + s;
      for (int r = 0; r < rays; ++r) dst[(long long)r * S] = flags[r][lane];
    }
    __syncwarp();                   // the flags and the slot are free again
  }
}

}  // namespace

extern "C" {

// dist [N, S] f32, out [N, S] bool (one byte each), both contiguous.
// Returns the cudaError_t of the launch.
int cumdist_thres(const void* dist, float thres, int N, int S, void* out, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + kRays - 1) / kRays;
  cumdist_thres_kernel<<<blocks, kRays, 0, (cudaStream_t)stream>>>(
      (const float*)dist, thres, N, S, (unsigned char*)out);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
