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
// and bf16 grids alike, rounded once on the store. `out` may alias `grad`
// (each element of grad is read and written by one block only, which has it
// in shared memory before it stores it; `param` is never written),
// which is how the train step calls it: the TV term lands in param.grad in
// place.
//
// What bounds it: by bytes it is a memory kernel: param read, grad read and
// out written (6 bytes an element in bf16) against about 25 f32 operations.
// The first version (one thread an element, seven scalar loads of param, three
// integer divisions an element; kept below as tv_add_grad_simple_kernel) was
// bound by the count of its load/store and integer operations: 24-29% of the byte
// bound at the train step's shapes (4.5 to 5.2 ms on an NVIDIA H100 80GB HBM3
// at 700 W). This version is at 56% of it (2.3 ms on the same card).
// What remains is the multiprocessor's dispatch rate: the inner loop compiles
// to about 50 machine operations an element (seven 2-byte shared loads and
// their conversions, six subtractions, twelve min/max, six selects), which
// the staging only partly hides behind; the staging alone, without the
// arithmetic, runs at 79% of the bound.
//
// Design (tv_add_grad_kernel). The TPU kernel streams whole x-planes through
// VMEM; a block here owns a *span* of kSpanBytes of one (y, z, c)-plane,
// cut on the flat index of the plane, and walks x over a segment of planes
// with a ring of three staged spans in shared memory (x, x+1, and x+2 on
// its way):
//   * every global access is a 16-byte vector, aligned on the *address*: a
//     plane, a row and a bank start at any multiple of the element size
//     (Z*C = 2388 elements and planes of 950,424 bytes at the train step's
//     shape), so a span is staged from the aligned vector under its first
//     element (`lead` elements early) and the partial vectors at a range's
//     ends are read and written element by element;
//   * the span is staged with a halo of Z*C elements on both sides, so the
//     z-neighbours (+-C) and the y-neighbours (+-Z*C) are reads of shared
//     memory at a shifted index, the x+1 neighbour is the same index in the
//     next slot and the x-1 neighbour is the value the thread read one step
//     earlier, kept in a register: each param byte comes from global memory
//     once, plus the halo (2*Z*C / span: 58% for k0, 5% for density, served
//     by the L2);
//   * the copies are cp.async: plane x+2 and the grad of plane x+1 arrive
//     while plane x is worked on;
//   * grad goes through shared memory as well, and the result leaves as
//     16-byte vectors from the same buffer when out and grad share their
//     alignment (always, in place), element by element otherwise;
//   * a thread owns the same kPerThread in-plane positions at every x, so
//     the y and z edge masks are decomposed once per block (the only
//     divisions) and kept as bits; the x masks are uniform over the block.
//     Every neighbour is loaded unconditionally from a fixed base register
//     and dropped by a select, which halved the loop's length against
//     loads under their masks.
// Consecutive threads read consecutive elements of shared memory: no bank
// conflicts at either element size. Two blocks of 512 threads and 108 KB fit a
// multiprocessor; x is cut into segments so that about eight waves of blocks
// fill the card.
//
// Measured and left: a span of 8 KB with three blocks, 1024 threads a block
// and sixteen waves were all slower. Left for later: two elements a thread
// from one 4-byte shared load where the alignment allows it, and a halo
// shared between neighbouring spans through a cluster's shared memory.
//
// tv_add_grad_simple_kernel serves rows too long for the ring to fit in shared
// memory (Z*C above about 13,000 bf16 or 6,000 f32 elements) and can be forced
// for testing.
//
// Halo planes. A grid cut along x over several GPUs (--grid_parallel) holds an
// x-slab [B, xs, Y, Z, C] on each; the TV at plane x reads planes x - 1 and
// x + 1, so a slab's first and last planes need the neighbours' boundary
// planes. `lo` and `hi` ([B, Y, Z, C] each, or null at the whole grid's ends)
// are the plane before the slab and the plane after it: with them the slab's
// result is its part of the whole grid's, to the bit. They enter where the
// whole-grid launch reads planes -1 and X: `lo` as the first plane's x-1
// neighbour (the `prev` registers), `hi` staged into the ring as plane X.
// With both null the launch is the single-grid one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSpanBytes = 16384;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float clip1(float d) { return fminf(fmaxf(d, -1.0f), 1.0f); }

// 16 bytes from global to shared memory without passing through registers;
// complete for the issuing thread after cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Elements by which `p + index` lies past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int lead_of(const T* p, int index) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long e = (long long)(reinterpret_cast<uintptr_t>(p) / sizeof(T)) + index;
  return (int)(e & (V - 1));
}

// Stage src[begin, begin + len) into dst, where dst[i] holds
// src[begin - lead + i]: a vector of dst is a 16-byte aligned vector of
// global memory. Only indices in [lo, hi) are touched: a vector inside that
// range moves whole and asynchronously (cp.async), a vector across its ends
// element by element.
template <typename T>
__device__ __forceinline__ void load_span(T* dst, const T* src, int begin, int len, int lead,
                                          int lo, int hi) {
  constexpr int V = 16 / (int)sizeof(T);
  const int a0 = begin - lead;
  const int nvec = (lead + len + V - 1) / V;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int e = a0 + v * V;
    if (e >= lo && e + V <= hi) {
      cp_async16(dst + v * V, src + e);
    } else {
      for (int k = 0; k < V; ++k)
        if (e + k >= lo && e + k < hi) dst[v * V + k] = src[e + k];
    }
  }
}

// The reverse: dst[begin, begin + len) from src, src[i] holding
// dst[begin - lead + i]. Nothing outside [begin, begin + len) is written.
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src, int begin, int len, int lead) {
  constexpr int V = 16 / (int)sizeof(T);
  const int a0 = begin - lead;
  const int nvec = (lead + len + V - 1) / V;
  const int end = begin + len;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int e = a0 + v * V;
    if (e >= begin && e + V <= end) {
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + v * V);
    } else {
      for (int k = 0; k < V; ++k)
        if (e + k >= begin && e + k < end) dst[e + k] = src[v * V + k];
    }
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Elements of one ring slot: a span, its two halos of Z*C, and room for the lead.
template <typename T>
__host__ __device__ constexpr int slot_elems(int zc) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int L = kSpanBytes / (int)sizeof(T);
  return ((L + 2 * zc) / V + 2) * V;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tv_add_grad_kernel(const T* param, const T* grad, T* out, const T* lo_plane, const T* hi_plane,
                int B, int X, int Y, int Z, int C, float wx, float wy, float wz, float gate,
                int dense, int spans, int nseg, int seg_len) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int L = kSpanBytes / (int)sizeof(T);
  constexpr int kPerThread = L / kThreads;
  static_assert(kPerThread * 4 <= 64, "edge masks are kept in 64 bits");
  extern __shared__ uint4 smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int zc = Z * C;
  const int pyz = Y * zc;
  const int hl = slot_elems<T>(zc);
  int bid = blockIdx.x;
  const int span = bid % spans;
  bid /= spans;
  const int seg = bid % nseg;
  const int b = bid / nseg;
  const int s = span * L;
  const int own = min(L, pyz - s);  // elements of this block's span
  const int x0 = seg * seg_len;
  const int x1 = min(X, x0 + seg_len);
  const long long total = (long long)B * X * pyz;
  const int tid = threadIdx.x;

  // y and z edge masks of this thread's positions, 4 bits each: z+, z-, y+, y-
  unsigned long long edges = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = s + tid + k * kThreads;
    const int y = q / zc;
    const int z = (q - y * zc) / C;
    const unsigned long long m = (z < Z - 1 ? 1u : 0u) | (z > 0 ? 2u : 0u) |
                                 (y < Y - 1 ? 4u : 0u) | (y > 0 ? 8u : 0u);
    edges |= m << (4 * k);
  }

  T* bc = smem;  // plane x
  T* bn = smem + hl;  // plane x + 1
  T* bf = smem + 2 * hl;  // free: plane x + 2 lands here while plane x is worked on
  T* gc = smem + 3 * hl;  // grad of plane x, then the result
  T* gn = gc + L + V;  // grad of plane x + 1 on its way
  const int hbeg = s - zc;
  const int hlen = own + 2 * zc;

  // planes past the slab's ends: x = -1 from lo_plane, x = X from hi_plane
  const int x_end = X + (hi_plane != nullptr ? 1 : 0);
  // start staging the span of plane x (x = X: hi_plane) with its halo;
  // returns its lead
  auto stage = [&](T* buf, int x) {
    const bool past = x == X;
    const long long off = past ? (long long)b * pyz : ((long long)b * X + x) * pyz;
    const T* pl = (past ? hi_plane : param) + off;
    const long long all = past ? (long long)B * pyz : total;
    const int lead = lead_of(pl, hbeg);
    const int lo = (int)max(-off, -(1LL << 30));
    const int hi = (int)min(all - off, 1LL << 30);
    load_span(buf, pl, hbeg, hlen, lead, lo, hi);
    return lead;
  };
  // the same for this block's own span of grad
  auto stage_grad = [&](T* buf, int x) {
    const T* gpl = grad + ((long long)b * X + x) * pyz;
    const int lead = lead_of(gpl, s);
    load_span(buf, gpl, s, own, lead, s, s + own);
    return lead;
  };

  // param of plane x - 1 at this thread's positions: from global memory for
  // the segment's first plane, then each plane's values are kept for the next
  float prev[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = tid + k * kThreads;
    prev[k] = (x0 > 0 && p < own)
                  ? to_f(param[((long long)b * X + x0 - 1) * pyz + s + p])
                  : ((lo_plane != nullptr && p < own) ? to_f(lo_plane[(long long)b * pyz + s + p])
                                                      : 0.0f);
  }
  int lc = stage(bc, x0);
  int ln = x0 + 1 < x_end ? stage(bn, x0 + 1) : 0;
  int lf = 0;
  int lg = stage_grad(gc, x0);
  int lgn = 0;
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int x = x0; x < x1; ++x) {
    const bool has_next = x + 1 < x_end;
    const bool has_prev = x > 0 || lo_plane != nullptr;
    if (x + 1 < x1) {  // what the next step needs arrives during this one
      if (x + 2 < x_end) lf = stage(bf, x + 2);
      lgn = stage_grad(gn, x + 1);
    }
    cp_async_commit();
    T* opl = out + ((long long)b * X + x) * pyz;
    const bool direct = lead_of(opl, s) != lg;  // out is aligned otherwise than grad

    // this thread's element k of the span sits at [k * kThreads] of each base
    const T* c0 = bc + lc + zc + tid;
    const T* n0 = bn + ln + zc + tid;
    const T* czp = c0 + C;
    const T* czm = c0 - C;
    const T* cyp = c0 + zc;
    const T* cym = c0 - zc;
    T* g0 = gc + lg + tid;
    // Every neighbour is loaded, then kept or dropped by its mask: a masked
    // neighbour's slot holds other elements of the staged range or stale
    // values, never memory outside the slot.
    auto work = [&](auto full) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        constexpr int kStep = kThreads;
        if (decltype(full)::value || tid + k * kStep < own) {
          const unsigned m = (unsigned)(edges >> (4 * k));
          const float pc = to_f(c0[k * kStep]);
          const float dxn = clip1(pc - to_f(n0[k * kStep]));
          const float dxp = clip1(pc - prev[k]);
          const float dyn = clip1(pc - to_f(cyp[k * kStep]));
          const float dyp = clip1(pc - to_f(cym[k * kStep]));
          const float dzn = clip1(pc - to_f(czp[k * kStep]));
          const float dzp = clip1(pc - to_f(czm[k * kStep]));
          const float gv = to_f(g0[k * kStep]);
          const float ax = (has_next ? dxn : 0.0f) + (has_prev ? dxp : 0.0f);
          const float ay = ((m & 4u) ? dyn : 0.0f) + ((m & 8u) ? dyp : 0.0f);
          const float az = ((m & 1u) ? dzn : 0.0f) + ((m & 2u) ? dzp : 0.0f);
          const float acc = wx * ax + wy * ay + wz * az;
          const float keep = (dense != 0 || gv != 0.0f) ? 1.0f : 0.0f;
          from_f(g0 + k * kStep, gv + acc * keep * gate);
          prev[k] = pc;
        }
      }
    };
    if (own == L) work(Flag<true>()); else work(Flag<false>());
    cp_async_wait_all();
    __syncthreads();  // the results and the next step's spans are in shared memory
    if (!direct) {
      store_span(opl, gc, s, own, lg);
    } else {
      for (int p = tid; p < own; p += kThreads) opl[s + p] = gc[lg + p];
    }
    __syncthreads();  // gc and bc are read out: the next step stages into them
    T* t = bc;
    bc = bn;
    bn = bf;
    bf = t;
    lc = ln;
    ln = lf;
    t = gc;
    gc = gn;
    gn = t;
    lg = lgn;
  }
}

template <typename T>
__global__ void tv_add_grad_simple_kernel(const T* __restrict__ param, const T* grad, T* out,
                                 const T* lo_plane, const T* hi_plane, int X,
                                 int Y, int Z, int C, float wx, float wy, float wz, float gate,
                                 int dense) {
  const int per_bank = X * Y * Z * C;
  const long long base = (long long)blockIdx.y * per_bank;
  const T* p = param + base;
  const T* g = grad + base;
  T* o = out + base;
  const int zc = Z * C;
  const int yzc = Y * zc;
  const T* lo = lo_plane != nullptr ? lo_plane + (long long)blockIdx.y * yzc : nullptr;
  const T* hi = hi_plane != nullptr ? hi_plane + (long long)blockIdx.y * yzc : nullptr;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < per_bank;
       j += gridDim.x * blockDim.x) {
    int r = j / C;
    const int z = r % Z;
    r /= Z;
    const int y = r % Y;
    const int x = r / Y;
    const float pc = to_f(p[j]);
    const float ax =
        (x < X - 1 ? clip1(pc - to_f(p[j + yzc]))
                   : (hi != nullptr ? clip1(pc - to_f(hi[j - x * yzc])) : 0.0f)) +
        (x > 0 ? clip1(pc - to_f(p[j - yzc])) : (lo != nullptr ? clip1(pc - to_f(lo[j])) : 0.0f));
    const float ay = (y < Y - 1 ? clip1(pc - to_f(p[j + zc])) : 0.0f) +
                     (y > 0 ? clip1(pc - to_f(p[j - zc])) : 0.0f);
    const float az = (z < Z - 1 ? clip1(pc - to_f(p[j + C])) : 0.0f) +
                     (z > 0 ? clip1(pc - to_f(p[j - C])) : 0.0f);
    const float acc = wx * ax + wy * ay + wz * az;
    const float gv = to_f(g[j]);
    const float keep = (dense != 0 || gv != 0.0f) ? 1.0f : 0.0f;
    from_f(o + j, gv + acc * keep * gate);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

template <typename T>
int launch(const void* param, const void* grad, void* out, const void* lo, const void* hi, int B,
           int X, int Y, int Z, int C, float wx, float wy, float wz, float gate, int dense,
           int simple, void* stream) {
  constexpr int L = kSpanBytes / (int)sizeof(T);
  const long long zc = (long long)Z * C;
  const long long pyz = zc * Y;
  constexpr int V = 16 / (int)sizeof(T);
  // three ring slots and two grad buffers; rows beyond any ring get the simple kernel
  const long long smem =
      zc > (1 << 20) ? kMaxSmem + 1LL : (3LL * slot_elems<T>((int)zc) + 2 * (L + V)) * sizeof(T);
  const long long spans = (pyz + L - 1) / L;
  // x is cut into segments so that about eight waves of blocks fill the card;
  // a segment restages two planes, so it keeps at least eight
  const long long want = (8LL * 2 * sm_count() + spans * B - 1) / (spans * B);
  long long nseg = want < 1 ? 1 : want;
  if (nseg > X / 8) nseg = X / 8 > 0 ? X / 8 : 1;
  const int seg_len = (int)((X + nseg - 1) / nseg);
  nseg = (X + seg_len - 1) / seg_len;
  const long long blocks = spans * nseg * B;
  // in-plane indices with their halo stay inside 32 bits up to planes of 2^30 elements
  if (simple || smem > kMaxSmem || pyz >= (1LL << 30) || blocks >= (1LL << 31)) {
    const int threads = 256;
    const long long per_bank = pyz * X;
    long long nb = (per_bank + threads - 1) / threads;
    if (nb > 8192) nb = 8192;
    if (nb < 1) nb = 1;
    dim3 grid((unsigned)nb, (unsigned)B);
    tv_add_grad_simple_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const T*)param, (const T*)grad, (T*)out, (const T*)lo, (const T*)hi, X, Y, Z, C, wx, wy,
        wz, gate, dense);
    return (int)cudaGetLastError();
  }
  // above 48 KB, shared memory is dynamic and opted into (per device, so every time)
  const cudaError_t err = cudaFuncSetAttribute(
      tv_add_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tv_add_grad_kernel<T><<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)param, (const T*)grad, (T*)out, (const T*)lo, (const T*)hi, B, X, Y, Z, C, wx,
      wy, wz, gate, dense, (int)spans, (int)nseg, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lo and hi: the planes [B, Y, Z, C] before and
// after a slab of a grid cut along x, or null. simple != 0 forces the
// one-thread-an-element kernel. Returns the cudaError_t of the launch.
int tv_add_grad(const void* param, const void* grad, void* out, const void* lo, const void* hi,
                int dtype, int B, int X, int Y, int Z, int C, float wx, float wy, float wz,
                float gate, int dense, int simple, void* stream) {
  if ((long long)B * X * Y * Z * C == 0) return 0;
  if (dtype == 0)
    return launch<float>(param, grad, out, lo, hi, B, X, Y, Z, C, wx, wy, wz, gate, dense,
                         simple, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(param, grad, out, lo, hi, B, X, Y, Z, C, wx, wy, wz, gate,
                                 dense, simple, stream);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
