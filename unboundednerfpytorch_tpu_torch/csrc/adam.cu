// Masked Adam for Hopper (sm_90a): one fused, in-place pass over a parameter.
//
// Counterpart of the JAX package's update (unboundednerfpytorch_tpu/optim/
// masked_adam.py::update, which XLA fuses; no TPU kernel stands behind it) and
// of the reference's adam_upd_cuda (FourierGrid/cuda/adam_upd_kernel.cu). Per
// element, with g the gradient as f32 (0 where the parameter has no grad):
//   m1 = m*b1 + g*(1-b1);  v1 = v*b2 + (g*(1-b2))*g
//   p  = round_to_p_dtype(p - (step*m1) / (sqrt(v1) + eps));  m = m1;  v = v1
// and, for a skip_zero_grad group, p, m and v stay as they are where g == 0.
// With a per-element learning rate r (pervoxel_lr: the coarse density grid's
// normalised view counts, f32, the reference's per-voxel-lr update) the step
// is scaled after the quotient and every element is updated, skip or not:
//   p  = round_to_p_dtype(p - ((step*m1) / (sqrt(v1) + eps)) * r)
// p and g are bf16 or f32 (the same), m, v and r f32. The plain version is
// ops/cuda/adam.py::masked_adam_plain, which runs each product, sum and
// quotient as its own PyTorch launch: every operation here is the intrinsic
// of one correctly rounded float operation (__fmul_rn, __fadd_rn, ...), which
// nvcc never contracts into an FMA, and the constants are the floats PyTorch
// makes of a Python scalar, so the result equals the plain version's to the bit.
//
// What bounds it: the bytes. An element is read once and written once (22
// bytes for bf16 p: p 2 + 2, g 2, m 4 + 4, v 4 + 4; 28 for f32; 4 more with
// r, which is read once: 32 for the f32 coarse density grid) for about 10
// operations, some 0.5 operations a byte, far under the H100's ridge, so the
// least time is the bytes over 3.35 TB/s. Nothing is reused, so TMA and wgmma
// have nothing to offer: the design only keeps enough bytes in flight.
//   - a grid-stride loop over as many blocks as fit on the multiprocessors at
//     once; each thread takes one 16-byte vector of p at a time (8 bf16 or 4
//     f32) with its g, m and v, neighbouring threads on neighbouring vectors,
//     so every access is a full, coalesced 16-byte load or store;
//   - streaming cache hints (ld.global.cs / st.global.cs): each byte is
//     touched once, and the parameter does not fit in the 50 MB L2 anyway;
//   - a skip group reads g first and loads and stores p, m and v only for a
//     vector that holds a non-zero g, so voxels no ray reached cost 2 bytes;
//   - r is one more streamed f32 read, loaded like m and v;
//   - the elements before the first aligned vector (a view that starts
//     inside a vector) and after the last one go one element a thread; a
//     tensor whose g, m, v and r do not line up with p's vectors goes that
//     way whole;
//   - 64-bit offsets: Truck.py's k0 grid holds 2.73 G elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Coef {
  float b1, c1, b2, c2, step, eps;
};

// one element, in the plain version's order of operations
__device__ __forceinline__ float adam1(float p, float& m, float& v, float g, const Coef& k) {
  const float m1 = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g, k.c1));
  const float v1 = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g, k.c2), g));
  const float den = __fadd_rn(__fsqrt_rn(v1), k.eps);
  m = m1;
  v = v1;
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(k.step, m1), den));
}

// the same with the per-element learning rate r
__device__ __forceinline__ float adam1_lr(float p, float& m, float& v, float g, float r,
                                          const Coef& k) {
  const float m1 = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g, k.c1));
  const float v1 = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g, k.c2), g));
  const float den = __fadd_rn(__fsqrt_rn(v1), k.eps);
  m = m1;
  v = v1;
  return __fsub_rn(p, __fmul_rn(__fdiv_rn(__fmul_rn(k.step, m1), den), r));
}

template <bool kLr>
__device__ __forceinline__ float update1(float p, float& m, float& v, float g, float r,
                                         const Coef& k) {
  return kLr ? adam1_lr(p, m, v, g, r, k) : adam1(p, m, v, g, k);
}

// an element of p or g: f32, or the bits of a bf16 (unsigned short)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void store_as(float x, float& out) { out = x; }
__device__ __forceinline__ void store_as(float x, unsigned short& out) {  // nearest, ties to even
  out = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T>
union Vec16 {  // a 16-byte vector of p or g
  uint4 raw;
  T el[16 / sizeof(T)];
};

template <int V>
union Moments {  // the V moments of one vector of p
  float4 raw[V / 4];
  float el[V];
};

template <typename T, bool kSkip, bool kGrad, bool kLr>
__device__ __forceinline__ void scalar_update(T* p, float* m, float* v, const T* g,
                                              const float* r, long long e, const Coef& k) {
  const float gf = kGrad ? to_f32(g[e]) : 0.f;
  if (kSkip && gf == 0.f) return;
  float mf = m[e], vf = v[e];
  store_as(update1<kLr>(to_f32(p[e]), mf, vf, gf, kLr ? r[e] : 0.f, k), p[e]);
  m[e] = mf;
  v[e] = vf;
}

// [0, head): one element a thread; [head, head + nvec * V): vectors;
// [head + nvec * V, n): one element a thread
template <typename T, bool kSkip, bool kGrad, bool kLr>
__global__ void __launch_bounds__(kThreads)
masked_adam_kernel(T* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                   const T* __restrict__ g, const float* __restrict__ r, long long n,
                   long long head, long long nvec, Coef k) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    const long long e = head + i * V;
    float gf[V];
    if (kGrad) {
      Vec16<T> gv;
      gv.raw = __ldcs(reinterpret_cast<const uint4*>(g + e));
#pragma unroll
      for (int j = 0; j < V; ++j) gf[j] = to_f32(gv.el[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) gf[j] = 0.f;
    }
    if (kSkip) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j) any |= gf[j] != 0.f;
      if (!any) continue;  // nothing of this vector changes
    }
    Vec16<T> pv;
    pv.raw = __ldcs(reinterpret_cast<const uint4*>(p + e));
    Moments<V> mv, vv, rv;
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      mv.raw[q] = __ldcs(reinterpret_cast<const float4*>(m + e) + q);
      vv.raw[q] = __ldcs(reinterpret_cast<const float4*>(v + e) + q);
      if (kLr) rv.raw[q] = __ldcs(reinterpret_cast<const float4*>(r + e) + q);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (kSkip && gf[j] == 0.f) continue;  // written back as read
      store_as(update1<kLr>(to_f32(pv.el[j]), mv.el[j], vv.el[j], gf[j], kLr ? rv.el[j] : 0.f,
                            k),
               pv.el[j]);
    }
    __stcs(reinterpret_cast<uint4*>(p + e), pv.raw);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      __stcs(reinterpret_cast<float4*>(m + e) + q, mv.raw[q]);
      __stcs(reinterpret_cast<float4*>(v + e) + q, vv.raw[q]);
    }
  }
  const long long tail0 = head + nvec * V;
  const long long scalars = head + (n - tail0);
  for (long long s = tid; s < scalars; s += stride) {
    scalar_update<T, kSkip, kGrad, kLr>(p, m, v, g, r, s < head ? s : tail0 + (s - head), k);
  }
}

template <typename T, bool kSkip, bool kGrad, bool kLr>
cudaError_t launch(void* p, void* m, void* v, const void* g, const float* r, long long n,
                   const Coef& k, cudaStream_t stream) {
  constexpr long long V = 16 / sizeof(T);
  const auto a = [](const void* ptr) { return (std::uintptr_t)ptr; };
  // elements before p's first 16-byte boundary; the vectors need g, m, v
  // and r on a boundary at the same element
  long long head = (long long)((16 - a(p) % 16) % 16) / (long long)sizeof(T);
  if (head > n) head = n;
  const bool aligned = (a(p) + head * sizeof(T)) % 16 == 0 &&
                       (!kGrad || (a(g) + head * sizeof(T)) % 16 == 0) &&
                       (a(m) + head * 4) % 16 == 0 && (a(v) + head * 4) % 16 == 0 &&
                       (!kLr || (a(r) + head * 4) % 16 == 0);
  if (!aligned) head = n;
  const long long nvec = (n - head) / V;
  const long long work = nvec > head + (n - head - nvec * V) ? nvec : head + (n - head - nvec * V);

  auto kernel = masked_adam_kernel<T, kSkip, kGrad, kLr>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (T*)p, (float*)m, (float*)v, (const T*)g, r, n, head, nvec, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* p, void* m, void* v, const void* g, const float* r, long long n,
                     const Coef& k, bool skip, cudaStream_t stream) {
  if (r != nullptr) {  // a per-element lr: every element, skip or not
    return g == nullptr ? launch<T, false, false, true>(p, m, v, g, r, n, k, stream)
                        : launch<T, false, true, true>(p, m, v, g, r, n, k, stream);
  }
  if (g == nullptr) {
    if (skip) return cudaSuccess;  // no grad: nothing of a skip group changes
    return launch<T, false, false, false>(p, m, v, g, r, n, k, stream);
  }
  return skip ? launch<T, true, true, false>(p, m, v, g, r, n, k, stream)
              : launch<T, false, true, false>(p, m, v, g, r, n, k, stream);
}

}  // namespace

extern "C" {

// p [n] bf16 (p_bf16 = 1) or f32, g like p or NULL (no grad), m and v [n]
// f32, r [n] f32 or NULL (no per-element lr), all contiguous and on one
// device; p, m and v are updated in place.
// The constants are given as the Python floats they are and rounded to f32
// here, as PyTorch rounds a Python scalar: b1, 1 - b1 (taken in double),
// b2, 1 - b2, step_size and eps. Returns the cudaError_t of the launch.
int masked_adam(void* p, void* m, void* v, const void* g, const void* r, long long n,
                int p_bf16, double step_size, double b1, double b2, double eps, int skip,
                void* stream) {
  if (n <= 0) return 0;
  const Coef k{(float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), (float)step_size,
               (float)eps};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* rf = (const float*)r;
  return (int)(p_bf16 ? dispatch<unsigned short>(p, m, v, g, rf, n, k, skip != 0, s)
                      : dispatch<float>(p, m, v, g, rf, n, k, skip != 0, s));
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
