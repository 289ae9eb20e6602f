// Fused ray march for Hopper (sm_90a): density -> alpha -> transmittance scan,
// and its backward.
//
// Replaces the TPU kernels of unboundednerfpytorch_tpu/ops/pallas/march.py:
//   march_forward  <- _fused_forward_impl (kernel body _fwd_kernel)
//   march_backward <- _fused_backward_impl (kernel body _bwd_kernel)
//
// Forward, per ray over S samples near -> far:
//   alpha_i = mask_i ? 1 - exp(-softplus(d_i + shift) * interval) : 0
//   t_excl_i = prod_{j<i} (1 - alpha_j)            (exclusive transmittance)
//   processed_i = t_excl_i >= 1e-3                 (the reference's early exit)
//   w_i = processed_i ? t_excl_i * alpha_i : 0
//   alphainv = t_excl of the first sample that is not processed, or the product
//              over all samples where every one is
// and alpha is an output, t_excl the residual the backward needs beside it.
//
// Backward, per ray in reverse, carrying back = gl * alphainv + sum_{j>i} gw_j w_j
// over processed samples:
//   g_alpha_i = processed_i ? gw_i * t_excl_i - back / (1 - alpha_i + 1e-10) : 0
//   gd_i = g_alpha_i * interval * (1 + e)^(-interval - 1) * min(e, 1e10) * mask_i,
//   e = exp(clip(d_i + shift, -50, 50))
// exactly the formula and epsilons of _bwd_kernel. The direct cotangent of
// the alpha output is added by the autograd wrapper, as the TPU VJP does.
//
// What bounds it: latency. At the train step's [2048, 96] the forward moves
// 3.3 MB and the backward 4.1 MB, which the card's memory streams in about a
// microsecond, as long as an empty launch takes (launch_floor below); a
// render chunk's [8192, 96] forward, which keeps no t_excl, moves 10 MB in
// 3 microseconds. What a launch costs beyond that is the chain from the first
// load to the last store, and how many multiprocessors share it.
//
// Forward design: a warp a ray. With a thread a ray (the first version of both
// kernels) neighbouring threads read addresses S floats apart (32 sectors a
// request for 128 useful bytes, on each of five arrays), 2048 rays fill 16 of
// 132 multiprocessors, and the 96 exp/log1p/multiply steps of a ray form one
// dependent chain: 58 microseconds at [2048, 96] on an NVIDIA H100 80GB HBM3 at
// 700 W, where all times of this note were taken. Here the lanes of
// a warp take 32 consecutive samples of one ray (every load and store is one
// coalesced 128-byte request), three such chunks are in flight at once (the
// path's 96 samples in one pass: all loads and all exp/log1p are
// independent), the products of 1 - alpha within a chunk are a five-step
// shuffle scan, and only the carry from chunk to chunk is sequential. 2048
// rays are 256 blocks of eight warps over all multiprocessors: 2.8
// microseconds, and 5.0 at [8192, 96]. Two, four or eight warps a block and
// three or four chunks all measure within 10% of each other
// (probes/variants.py). What is left at [2048, 96] is one wave of warps going
// from load to store: without exp/log1p the same kernel takes 2.3 microseconds
// (two and a half launch floors), without the scan 2.9 of its 3.0.
//
// The scan multiplies in another order than a sequential loop, so t_excl
// differs from it in its last bits. `processed` is decided, sample by sample,
// on the very value written to t_excl, which is what march_backward decides
// it on again; alphainv is the t_excl of the first sample that is not
// processed, or the full product where every sample is (the plain version's
// rule). A transmittance within rounding of the threshold can thus fall on
// the other side than in the plain version: the checks on the card count such
// samples instead of loosening their tolerance. Without a gradient (t_excl
// null) the forward stores no t_excl: a third fewer bytes written.
//
// Backward design: the forward's layout run in reverse. A warp a ray, lanes on
// 32 consecutive samples, so each of the five loads and the store is one
// coalesced request; all chunks of a group (three: the path's 96 samples)
// loaded before any is used, so every exp, pow and divide of a ray is
// independent of the others; gw * w over the processed samples summed from the
// far end by a five-step shuffle scan (__shfl_down_sync) inside a chunk, and a
// scalar carry, which starts at gl * alphainv, from the far chunk to the near
// one and from group to group where S > 96. The sums are thus taken in another
// order than a sequential loop's and than the plain version's cumsum: a
// result may differ from theirs by a few roundings of the ray's largest
// partial sum, which the checks allow for per element
// (ops/cuda/march.py::march_backward_tolerance) and in nothing else.
// `processed` is read off the stored t_excl, so forward and backward cannot
// disagree on a sample. The first version, a thread a ray, took 70
// microseconds at [2048, 96].

#include <cuda_runtime.h>

namespace {

constexpr float kEarlyExitT = 1e-3f;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: logaddexp(x, 0)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 3;  // chunks of 32 samples a warp keeps in flight
constexpr unsigned kFullWarp = 0xffffffffu;

template <bool kResiduals>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
march_forward_kernel(const float* __restrict__ density, const unsigned char* __restrict__ mask,
                     float shift, float interval, int N, int S, float* __restrict__ weights,
                     float* __restrict__ alphainv, float* __restrict__ alpha,
                     float* __restrict__ t_excl) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const long long row = (long long)n * S;
  float carry = 1.0f;  // transmittance entering the group of chunks
  float ai = 0.0f;
  bool stopped = false;
  for (int base = 0; base < S; base += 32 * kChunks) {
    float a[kChunks], v[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int s = base + 32 * c + lane;
      float d = 0.0f;
      bool live = false;
      if (s < S) {
        d = density[row + s];
        live = mask[row + s] != 0;
      }
      a[c] = live ? 1.0f - expf(-softplus(d + shift) * interval) : 0.0f;
      v[c] = 1.0f - a[c];
    }
    // v[c] becomes the product of 1 - alpha over the chunk's lanes 0..lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float u = __shfl_up_sync(kFullWarp, v[c], o);
        if (lane >= o) v[c] *= u;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int s = base + 32 * c + lane;
      const bool valid = s < S;
      float e = __shfl_up_sync(kFullWarp, v[c], 1);
      if (lane == 0) e = 1.0f;
      const float T = carry * e;  // exclusive transmittance of this sample
      const bool processed = T >= kEarlyExitT;
      if (valid) {
        weights[row + s] = processed ? T * a[c] : 0.0f;
        alpha[row + s] = a[c];
        if (kResiduals) t_excl[row + s] = T;
      }
      const unsigned stop = __ballot_sync(kFullWarp, valid && !processed);
      if (!stopped && stop != 0u) {
        ai = __shfl_sync(kFullWarp, T, __ffs(stop) - 1);
        stopped = true;
      }
      carry *= __shfl_sync(kFullWarp, v[c], 31);
    }
  }
  if (lane == 0) alphainv[n] = stopped ? ai : carry;
}

__device__ __forceinline__ float dalpha_ddensity(float d, float shift, float interval) {
  const float e = expf(fminf(fmaxf(d + shift, -50.0f), 50.0f));
  return interval * powf(1.0f + e, -interval - 1.0f) * fminf(e, 1e10f);
}

constexpr int kBwdWarpsPerBlock = 8;
constexpr int kBwdChunks = 3;  // chunks of 32 samples a warp keeps in flight

__global__ void __launch_bounds__(kBwdWarpsPerBlock * 32)
march_backward_kernel(const float* __restrict__ alpha, const float* __restrict__ t_excl,
                      const float* __restrict__ alphainv, const float* __restrict__ gw,
                      const float* __restrict__ gl, float shift, float interval,
                      const float* __restrict__ density, const unsigned char* __restrict__ mask,
                      int N, int S, float* __restrict__ gd) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kBwdWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const long long row = (long long)n * S;
  constexpr int kGroup = 32 * kBwdChunks;
  // gl * alphainv + the sum of gw * w over the processed samples behind the
  // chunk at hand
  float carry = gl[n] * alphainv[n];
  for (int base = (S - 1) / kGroup * kGroup; base >= 0; base -= kGroup) {
    float a[kBwdChunks], gt[kBwdChunks], dd[kBwdChunks], v[kBwdChunks];
    bool processed[kBwdChunks], live[kBwdChunks];
#pragma unroll
    for (int c = 0; c < kBwdChunks; ++c) {
      const int s = base + 32 * c + lane;
      float t = 0.0f, g = 0.0f, d = 0.0f;
      a[c] = 0.0f;
      live[c] = false;
      if (s < S) {
        a[c] = alpha[row + s];
        t = t_excl[row + s];
        g = gw[row + s];
        d = density[row + s];
        live[c] = mask[row + s] != 0;
      }
      processed[c] = s < S && t >= kEarlyExitT;
      gt[c] = g * t;
      v[c] = processed[c] ? g * (t * a[c]) : 0.0f;
      dd[c] = dalpha_ddensity(d, shift, interval);
    }
    // v[c] becomes the sum of gw * w over the chunk's lanes lane..31
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < kBwdChunks; ++c) {
        const float u = __shfl_down_sync(kFullWarp, v[c], o);
        if (lane + o < 32) v[c] += u;
      }
    }
#pragma unroll
    for (int c = kBwdChunks - 1; c >= 0; --c) {
      const int s = base + 32 * c + lane;
      float behind = __shfl_down_sync(kFullWarp, v[c], 1);
      if (lane == 31) behind = 0.0f;
      const float back = carry + behind;
      if (s < S) {
        const float g_alpha = processed[c] ? gt[c] - back / (1.0f - a[c] + 1e-10f) : 0.0f;
        gd[row + s] = live[c] ? g_alpha * dd[c] : 0.0f;
      }
      carry += __shfl_sync(kFullWarp, v[c], 0);
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// t_excl may be null: the forward then keeps no residual for the backward.
// Returns the cudaError_t of the launch.
int march_forward(const void* density, const void* mask, float shift, float interval, int N,
                  int S, void* weights, void* alphainv, void* alpha, void* t_excl,
                  void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel = t_excl != nullptr ? march_forward_kernel<true> : march_forward_kernel<false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)density, (const unsigned char*)mask, shift, interval, N, S,
      (float*)weights, (float*)alphainv, (float*)alpha, (float*)t_excl);
  return (int)cudaGetLastError();
}

int march_backward(const void* alpha, const void* t_excl, const void* alphainv,
                   const void* gw, const void* gl, float shift, float interval,
                   const void* density, const void* mask, int N, int S, void* gd, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + kBwdWarpsPerBlock - 1) / kBwdWarpsPerBlock;
  march_backward_kernel<<<blocks, kBwdWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)t_excl, (const float*)alphainv, (const float*)gw,
      (const float*)gl, shift, interval, (const float*)density,
      (const unsigned char*)mask, N, S, (float*)gd);
  return (int)cudaGetLastError();
}

// An empty kernel: timed like the others, it gives the launch floor.
int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
