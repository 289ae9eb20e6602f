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
//   alphainv = t_excl after the last processed sample
// and alpha, t_excl are written as residuals for the backward.
//
// Backward, per ray in reverse, carrying back = gl * alphainv + sum_{j>i} gw_j w_j
// over processed samples:
//   g_alpha_i = processed_i ? gw_i * t_excl_i - back / (1 - alpha_i + 1e-10) : 0
//   gd_i = g_alpha_i * interval * (1 + e)^(-interval - 1) * min(e, 1e10) * mask_i,
//   e = exp(clip(d_i + shift, -50, 50))
// exactly the formula and epsilons of _bwd_kernel. The direct cotangent of
// the alpha output is added by the autograd wrapper, as the TPU VJP does.
//
// What bounds it: at the train step's [2048, 96] both kernels move about
// 3-4 MB, which the card's memory streams in about a microsecond; the run is
// bound by launch latency and by too few threads (one per ray, 2048 of them)
// rather than by bytes or operations.
//
// Design: one thread per ray, the sequential scan in registers, exactly the
// loop order of the CUDA reference. Left for later: coalescing the per-ray
// loop (neighbouring threads read addresses S floats apart), a warp per ray
// with a shuffle scan for long rays, and fusing the kernel into the
// gather/composite around it.

#include <cuda_runtime.h>

namespace {

constexpr float kEarlyExitT = 1e-3f;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: logaddexp(x, 0)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void march_forward_kernel(const float* __restrict__ density,
                                     const unsigned char* __restrict__ mask, float shift,
                                     float interval, int N, int S, float* __restrict__ weights,
                                     float* __restrict__ alphainv, float* __restrict__ alpha,
                                     float* __restrict__ t_excl) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long row = (long long)n * S;
  float T = 1.0f;
  float ai = 1.0f;
  for (int s = 0; s < S; ++s) {
    const long long i = row + s;
    const float a =
        mask[i] ? 1.0f - expf(-softplus(density[i] + shift) * interval) : 0.0f;
    const float t_next = T * (1.0f - a);
    const bool processed = T >= kEarlyExitT;
    weights[i] = processed ? T * a : 0.0f;
    if (processed) ai = t_next;
    alpha[i] = a;
    t_excl[i] = T;
    T = t_next;
  }
  alphainv[n] = ai;
}

__global__ void march_backward_kernel(const float* __restrict__ alpha,
                                      const float* __restrict__ t_excl,
                                      const float* __restrict__ alphainv,
                                      const float* __restrict__ gw,
                                      const float* __restrict__ gl, float shift,
                                      float interval, const float* __restrict__ density,
                                      const unsigned char* __restrict__ mask, int N, int S,
                                      float* __restrict__ gd) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long row = (long long)n * S;
  float back = gl[n] * alphainv[n];
  for (int s = S - 1; s >= 0; --s) {
    const long long i = row + s;
    const float a = alpha[i];
    const float t = t_excl[i];
    const bool processed = t >= kEarlyExitT;
    const float g = gw[i];
    const float g_alpha = processed ? g * t - back / (1.0f - a + 1e-10f) : 0.0f;
    if (processed) back += g * (t * a);
    const float e = expf(fminf(fmaxf(density[i] + shift, -50.0f), 50.0f));
    const float dalpha_dd = interval * powf(1.0f + e, -interval - 1.0f) * fminf(e, 1e10f);
    gd[i] = mask[i] ? g_alpha * dalpha_dd : 0.0f;
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.
int march_forward(const void* density, const void* mask, float shift, float interval, int N,
                  int S, void* weights, void* alphainv, void* alpha, void* t_excl,
                  void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  march_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)density, (const unsigned char*)mask, shift, interval, N, S,
      (float*)weights, (float*)alphainv, (float*)alpha, (float*)t_excl);
  return (int)cudaGetLastError();
}

int march_backward(const void* alpha, const void* t_excl, const void* alphainv,
                   const void* gw, const void* gl, float shift, float interval,
                   const void* density, const void* mask, int N, int S, void* gd,
                   void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  march_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)t_excl, (const float*)alphainv, (const float*)gw,
      (const float*)gl, shift, interval, (const float*)density,
      (const unsigned char*)mask, N, S, (float*)gd);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
