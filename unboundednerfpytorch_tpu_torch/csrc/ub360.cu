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
// What bounds it: the bytes (4096 x 1063 floats in, as many flags out: 6.5 us
// at the H100 SXM's 3.35 TB/s) and, as long, a ray's chain of S dependent
// steps (add, compare, select: about a dozen cycles each, 7 us for 1063).
// With one thread a ray and 4096 rays the card holds about one walking warp
// a multiprocessor, so nothing hides any work the walking warp does beside
// its chain: the design gives all of it to other warps.
//   - a block is 1 + kProducers warps: warp 0 walks 32 rays, a thread a ray
//     (fewer rays for a very long S); the others move their distances in;
//   - the distances come into shared memory in pieces of kPiece samples
//     through a ring of kSlots slots, one bulk copy (cp.async.bulk) a ray and
//     piece: the piece's 16-byte-aligned span, at most 12 bytes wider than
//     the piece. A slot's copies complete on its "full" mbarrier; the walkers
//     free the slot on its "empty" one. A bulk copy takes its addresses from
//     uniform registers, so the copies of one warp go out one after another,
//     some 130 cycles each on an H100 SXM: when every walker copied its own
//     ray's pieces this took most of 0.035 ms at [4096, 1063]. So one thread
//     of each producer warp issues the copies of every kProducers-th ray.
//     Floats at the very ends of the tensor that no aligned span inside it
//     reaches are read directly by the walker that needs them;
//   - the walk takes its slot kGroup distances at a time into registers, the
//     next group's loads issued before this group's chain, so no
//     shared-memory load lies on the chain;
//   - the walk writes its flags to a byte image of the block's output rows,
//     which lie one after another in the output: at the end the block stores
//     that image as whole 16-byte vectors (its ends byte by byte) instead of
//     32 rays' bytes S apart.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRays = 32;            // warp 0: a ray a thread
constexpr int kProducers = 4;        // warps that move the distances
constexpr int kThreads = 32 * (1 + kProducers);
constexpr int kPiece = 128;          // samples a piece
constexpr int kSlots = 4;            // pieces in the ring
constexpr int kPitch = kPiece + 12;  // floats a slot: a piece's aligned span (4-way banks)
constexpr int kGroup = 8;            // samples a walk holds in registers (divides kPiece)
constexpr int kRingBytes = kSlots * kRays * kPitch * 4;
constexpr int kBarBytes = 2 * kSlots * 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxFlagBytes = kMaxSmem - kRingBytes - kBarBytes - 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the bytes [src, src + bytes) (both ends 16-byte aligned) into dst, counted
// on bar as bytes it waits for
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// piece t of a ray whose distances start at row: its floats [a0, a1) and the
// aligned span [lo, hi) of them inside the tensor's aligned interior, which a
// bulk copy brings to slot + (lo - s0) / 4 (s0: a0 rounded down to 16 bytes)
struct Span {
  std::uintptr_t a0, a1, s0, lo, hi;
};

__device__ __forceinline__ Span span_of(const float* row, int t, int S, std::uintptr_t lo_all,
                                        std::uintptr_t hi_all) {
  Span sp;
  sp.a0 = (std::uintptr_t)(row + t * kPiece);
  sp.a1 = sp.a0 + 4u * min(kPiece, S - t * kPiece);
  sp.s0 = sp.a0 & ~(std::uintptr_t)15;
  sp.lo = sp.s0 > lo_all ? sp.s0 : lo_all;
  const std::uintptr_t s1 = (sp.a1 + 15) & ~(std::uintptr_t)15;
  sp.hi = s1 < hi_all ? s1 : hi_all;
  return sp;
}

__global__ void __launch_bounds__(kThreads)
cumdist_thres_kernel(const float* __restrict__ dist, float thres, int N, int S, int rays_per_block,
                     unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  auto* full = reinterpret_cast<unsigned long long*>(smem + kRingBytes);
  unsigned long long* empty = full + kSlots;
  unsigned char* flags = smem + kRingBytes + kBarBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long ray0 = (long long)blockIdx.x * rays_per_block;
  const int rays = (int)min((long long)rays_per_block, N - ray0);
  const int pieces = (S + kPiece - 1) / kPiece;
  const std::uintptr_t lo_all = ((std::uintptr_t)dist + 15) & ~(std::uintptr_t)15;
  const std::uintptr_t hi_all = (std::uintptr_t)(dist + (long long)N * S) & ~(std::uintptr_t)15;
  // the block's output rows [o0, o1) and their image in shared memory, at the
  // same offset from a 16-byte boundary
  const std::uintptr_t o0 = (std::uintptr_t)(out + ray0 * S);
  const std::uintptr_t o1 = o0 + (std::uintptr_t)rays * S;
  const std::uintptr_t f0 = o0 & ~(std::uintptr_t)15;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      bar_init(full + s, kProducers);  // the producers' arrivals, and the bytes
      bar_init(empty + s, rays);       // every walker has walked the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    if (lane == 0) {  // a producer: the rays warp - 1, warp - 1 + kProducers, ...
      for (int t = 0; t < pieces; ++t) {
        const int s = t % kSlots;
        if (t >= kSlots) bar_wait(empty + s, (unsigned)(t / kSlots - 1) & 1u);
        for (int r = warp - 1; r < rays; r += kProducers) {
          const Span sp = span_of(dist + (ray0 + r) * S, t, S, lo_all, hi_all);
          if (sp.hi > sp.lo)
            bulk_load(ring + (s * kRays + r) * kPitch + (sp.lo - sp.s0) / 4,
                      (const void*)sp.lo, (unsigned)(sp.hi - sp.lo), full + s);
        }
        bar_arrive(full + s);
      }
    }
  } else if (lane < rays) {  // a walker
    const float* row = dist + (ray0 + lane) * S;
    unsigned char* my_flags = flags + (o0 - f0) + (std::uintptr_t)lane * S;
    float cum = 0.f;
    for (int t = 0; t < pieces; ++t) {
      const int s = t % kSlots;
      const Span sp = span_of(row, t, S, lo_all, hi_all);
      float* slot = ring + (s * kRays + lane) * kPitch;
      // floats of the piece outside [lo, hi): at the tensor's ends only
      for (std::uintptr_t a = sp.a0; a < sp.a1 && a < sp.lo; a += 4)
        slot[(a - sp.s0) / 4] = *(const float*)a;
      for (std::uintptr_t a = sp.hi > sp.a0 ? sp.hi : sp.a0; a < sp.a1; a += 4)
        slot[(a - sp.s0) / 4] = *(const float*)a;
      bar_wait(full + s, (unsigned)(t / kSlots) & 1u);
      const int n = (int)(sp.a1 - sp.a0) / 4;
      const float* d = slot + (sp.a0 - sp.s0) / 4;
      unsigned char* f = my_flags + t * kPiece;
      // kGroup samples at a time: only the ray's last piece can end inside a
      // group; its padding steps add 0 and their flags are not stored
      float x[kGroup], y[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = k < n ? d[k] : 0.f;
      for (int j0 = 0; j0 < n; j0 += kGroup) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int j = j0 + kGroup + k;
          y[k] = j < n ? d[j] : 0.f;
        }
        bool fl[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const float c = __fadd_rn(cum, x[k]);
          fl[k] = c > thres;
          cum = fl[k] ? __fmul_rn(c, 0.f) : c;
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (j0 + k < n) f[j0 + k] = fl[k];
          x[k] = y[k];
        }
      }
      bar_arrive(empty + s);  // this walker is done with the slot
    }
  }
  __syncthreads();
  // the image out: its head and tail byte by byte, the rest in 16-byte
  // vectors, by every thread of the block
  const int tid = threadIdx.x;
  const std::uintptr_t v0 = (o0 + 15) & ~(std::uintptr_t)15;
  const std::uintptr_t v1 = o1 & ~(std::uintptr_t)15;
  if (v0 >= v1) {
    for (std::uintptr_t a = o0 + tid; a < o1; a += kThreads) *(unsigned char*)a = flags[a - f0];
    return;
  }
  for (std::uintptr_t a = o0 + tid; a < v0; a += kThreads) *(unsigned char*)a = flags[a - f0];
  for (std::uintptr_t a = v1 + tid; a < o1; a += kThreads) *(unsigned char*)a = flags[a - f0];
  for (std::uintptr_t a = v0 + 16u * tid; a < v1; a += 16u * kThreads)
    *(uint4*)a = *(const uint4*)(flags + (a - f0));
}

}  // namespace

extern "C" {

// dist [N, S] f32, out [N, S] bool (one byte each), both contiguous. Returns
// the cudaError_t of the launch: cudaErrorInvalidValue for an S whose flags
// of one ray do not fit in shared memory beside the ring (over 160 K).
int cumdist_thres(const void* dist, float thres, int N, int S, void* out, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  if (S > kMaxFlagBytes) return (int)cudaErrorInvalidValue;
  const int rays = min(kRays, kMaxFlagBytes / S);
  const long long flag_bytes = (long long)rays * S + 16;
  const int smem = kRingBytes + kBarBytes + (int)((flag_bytes + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(cumdist_thres_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + rays - 1) / rays;
  cumdist_thres_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)dist, thres, N, S, rays, (unsigned char*)out);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
