// Fused total-variation gradient injection for Hopper (sm_90a).
//
// Replaces the TPU kernel unboundednerfpytorch_tpu/ops/pallas/tv.py
// (tv_add_grad, kernel body _kernel) and computes, in one pass:
//
//   out = grad + gate * where(dense | grad != 0, tv_grad(param), 0)
//   tv_grad_i = sum_ax w_ax * [clip(p_i - p_{i+1}, +-1) + clip(p_i - p_{i-1}, +-1)]
//
// with missing neighbours contributing 0 and w_ax already divided by 6 by the
// wrapper. Grids are channel-last [B, X, Y, Z, C]; the math is f32 for f32
// and bf16 grids alike. `out` may alias `grad` (each element is read and
// written by one thread only and `param` is never written), which is how the
// train step calls it: the TV term lands in param.grad in place.
//
// What bounds it: memory. Each element needs param read, grad read and out
// written (3 passes; the 6 neighbour reads of param hit L1/L2), and about 25
// f32 operations, far below the card's f32 rate.
//
// Design: one thread per element with a grid-stride loop; blockIdx.y is the
// bank, so in-bank offsets stay 32-bit. Neighbours sit at +-C (z), +-Z*C (y)
// and +-Y*Z*C (x), masked at each axis end. Left for later: tiling the
// stencil through shared memory (x-planes streamed as the TPU kernel does),
// vectorised 16-byte loads of the channel run, and dropping the integer
// index decomposition.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float clip1(float d) { return fminf(fmaxf(d, -1.0f), 1.0f); }

template <typename T>
__global__ void tv_add_grad_kernel(const T* __restrict__ param, const T* grad, T* out,
                                   int X, int Y, int Z, int C, float wx, float wy,
                                   float wz, float gate, int dense) {
  const int per_bank = X * Y * Z * C;
  const long long base = (long long)blockIdx.y * per_bank;
  const T* p = param + base;
  const T* g = grad + base;
  T* o = out + base;
  const int zc = Z * C;
  const int yzc = Y * zc;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < per_bank;
       j += gridDim.x * blockDim.x) {
    int r = j / C;
    const int z = r % Z;
    r /= Z;
    const int y = r % Y;
    const int x = r / Y;
    const float pc = load_f(p, j);
    const float ax = (x < X - 1 ? clip1(pc - load_f(p, j + yzc)) : 0.0f) +
                     (x > 0 ? clip1(pc - load_f(p, j - yzc)) : 0.0f);
    const float ay = (y < Y - 1 ? clip1(pc - load_f(p, j + zc)) : 0.0f) +
                     (y > 0 ? clip1(pc - load_f(p, j - zc)) : 0.0f);
    const float az = (z < Z - 1 ? clip1(pc - load_f(p, j + C)) : 0.0f) +
                     (z > 0 ? clip1(pc - load_f(p, j - C)) : 0.0f);
    const float acc = wx * ax + wy * ay + wz * az;
    const float gv = load_f(g, j);
    const float keep = (dense != 0 || gv != 0.0f) ? 1.0f : 0.0f;
    store_f(o, j, gv + acc * keep * gate);
  }
}

template <typename T>
int launch(const void* param, const void* grad, void* out, int B, int X, int Y, int Z,
           int C, float wx, float wy, float wz, float gate, int dense, void* stream) {
  const int threads = 256;
  const long long per_bank = (long long)X * Y * Z * C;
  long long blocks = (per_bank + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)B);
  tv_add_grad_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)param, (const T*)grad, (T*)out, X, Y, Z, C, wx, wy, wz, gate, dense);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int tv_add_grad(const void* param, const void* grad, void* out, int dtype, int B, int X,
                int Y, int Z, int C, float wx, float wy, float wz, float gate, int dense,
                void* stream) {
  if (dtype == 0)
    return launch<float>(param, grad, out, B, X, Y, Z, C, wx, wy, wz, gate, dense, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(param, grad, out, B, X, Y, Z, C, wx, wy, wz, gate, dense,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
