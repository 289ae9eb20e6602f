// Gather probes for Hopper (sm_90a): the four functions that the JAX
// package's TPU gather probes compute, as hand-written kernels, so that the
// render engine's memory paths can be chosen on the card's own numbers.
//
// Replaces the TPU kernels of
//   tools/probe_pallas_gather.py  kernel / kernel2  -> gather_rows
//   tools/probe_dynamic_gather.py run               -> gather_tile_rows
//   tools/probe_kernel_gather.py  p1_rowloop        -> gather_tile_rows
//   tools/probe_vreg_gather.py    kernel            -> box_gather8
//   tools/probe_kernel_gather.py  p2_boxdma         -> box_sum
// (two pairs of TPU kernels compute one function by two mechanisms: a vector
// dynamic_gather against a scalar loop over SMEM indices. The GPU form of
// that question is how many threads share a row: neighbouring lanes copying
// it together in vectors, against one thread walking the whole row. Both
// are launch shapes of the same kernel, chosen by `lanes`.)
//
//   gather_rows      out[i, :] = table[idx[i], :]
//   gather_tile_rows out[b*A + i, :] = table[b*A + idx[b*A + i], :], idx in [0, A)
//   box_gather8      out[r, 0:8] = box[r / R][dx*16 + dy][dz*8 : dz*8 + 8],
//                    code[r] = dx*256 + dy*16 + dz, box b a 16x16x16x8 f32 cube
//                    (128 KB), R requests per box
//   box_sum          out[b, :] = sum over the (BX, BY, BZ) box at origin org[b]
//                    of table[x, y, z, :] (bf16), accumulated in f32
//
// What bounds them: all four move bytes and compute next to nothing, so the
// bound is bytes over the memory rate. Where the source stays in the 50 MB L2
// (the 8 MB table of gather_rows, each A x C tile of gather_tile_rows after
// its first touch) the HBM traffic is the output and the indices, and the
// bound of "each input once, each output once" is generous.
//
// Design:
//   row gathers: a row is copied by `lanes` threads (a power of two, at
//   most 32). The wrapper's default is the smallest that covers the row in
//   vectors, so a 256-byte row takes half a warp and a 24-byte row one lane
//   per 8-byte vector, and neighbouring lanes read neighbouring addresses;
//   lanes = 1 is the row loop, one thread per row. The vector width is the
//   largest of 16/8/4/2 bytes that divides the row. All offsets are 64-bit.
//   box_gather8: one block per box; the 128 KB box is staged in dynamic
//   shared memory (opt-in above 48 KB), then every request is two 16-byte
//   shared-memory reads and one coalesced 32-byte store.
//   box_sum: a box (0.5-1 MB) is larger than shared memory, so it is
//   streamed: the innermost contiguous run is BZ*C elements; each thread owns
//   one 16-byte vector of that run and walks the BX*BY rows with f32
//   accumulators, then a fixed-order reduction through shared memory (no
//   atomics: the sum's order is the same in every run).
// Left for later: TMA box loads (cp.async.bulk.tensor) for box_sum and
// box_gather8, which would take the address arithmetic off the threads.
//
// Indices are clamped into range (row ids into the table or tile, box codes
// modulo 4096, box origins into the table), so a bad index reads a wrong row
// and never memory outside the tensors; the plain versions clamp alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__device__ __forceinline__ void copy_row(const char* __restrict__ src, char* __restrict__ dst,
                                         int n_vec, int lane, int lanes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (int v = lane; v < n_vec; v += lanes) d[v] = s[v];
}

__device__ __forceinline__ long long load_index(const void* idx, int idx64, long long i) {
  return idx64 ? static_cast<const long long*>(idx)[i]
               : (long long)static_cast<const int*>(idx)[i];
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tile == 0: plain row gather from a table of n_rows rows.
// tile == A: row i reads from its own tile of A rows, idx local to the tile.
template <typename V, bool kTiled>
__global__ void gather_rows_kernel(const char* __restrict__ table, const void* __restrict__ idx,
                                   int idx64, long long n_out, long long n_rows,
                                   long long tile, int row_bytes, int lanes,
                                   char* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / lanes;
  const int lane = (int)(t % lanes);
  if (row >= n_out) return;
  long long src = load_index(idx, idx64, row);
  if (kTiled) {
    src = (row / tile) * tile + clampll(src, 0, tile - 1);
  }
  src = clampll(src, 0, n_rows - 1);
  copy_row<V>(table + (size_t)src * row_bytes, out + (size_t)row * row_bytes,
              row_bytes / (int)sizeof(V), lane, lanes);
}

template <bool kTiled>
int launch_gather(const void* table, const void* idx, int idx64, long long n_out,
                  long long n_rows, long long tile, int row_bytes, int lanes, void* out,
                  cudaStream_t stream) {
  if (n_out <= 0) return 0;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) return (int)cudaErrorInvalidValue;
  int vec = 16;
  while (row_bytes % vec != 0) vec /= 2;  // 16, 8, 4 or 2 (rows are >= 2 bytes)
  const int threads = 256;
  const long long total = n_out * lanes;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
#define LAUNCH(V)                                                                          \
  gather_rows_kernel<V, kTiled><<<(unsigned)blocks, threads, 0, stream>>>(                 \
      (const char*)table, idx, idx64, n_out, n_rows, tile, row_bytes, lanes, (char*)out)
  switch (vec) {
    case 16: LAUNCH(uint4); break;
    case 8: LAUNCH(uint2); break;
    case 4: LAUNCH(uint32_t); break;
    default: LAUNCH(uint16_t); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

constexpr int kBoxFloats = 16 * 16 * 16 * 8;  // 32768 floats = 128 KB
constexpr int kBoxThreads = 512;

__global__ void box_gather8_kernel(const float* __restrict__ box, const int* __restrict__ code,
                                   long long n_req, int req_per_box, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const long long b = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(box + (size_t)b * kBoxFloats);
  for (int v = threadIdx.x; v < kBoxFloats / 4; v += blockDim.x) smem4[v] = src[v];
  __syncthreads();
  const long long first = b * (long long)req_per_box;
  float4* dst = reinterpret_cast<float4*>(out);
  // two threads per request: one 16-byte half of its 8 floats each
  for (int w = threadIdx.x; w < 2 * req_per_box; w += blockDim.x) {
    const long long r = first + (w >> 1);
    if (r >= n_req) break;
    const int c = code[r] & 4095;  // dx*256 + dy*16 + dz
    // float offset in the box: (dx*16 + dy)*128 + dz*8 = (c >> 4)*128 + (c & 15)*8
    const int f4 = ((c >> 4) * 128 + (c & 15) * 8) / 4 + (w & 1);
    dst[(size_t)r * 2 + (w & 1)] = smem4[f4];
  }
}

__device__ __forceinline__ void add_bf16x8(const uint4& v, float* acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

// blockDim.x = groups * run_vecs; thread (g, v) owns 16-byte vector v of the
// contiguous z-run and the (x, y) rows g, g + groups, ...
__global__ void box_sum_kernel(const uint16_t* __restrict__ table, const int* __restrict__ org,
                               int X, int Y, int Z, int C, int BX, int BY, int BZ,
                               float* __restrict__ out) {
  extern __shared__ float partial[];  // [blockDim.x][8]
  const int run_vecs = BZ * C / 8;
  const int groups = blockDim.x / run_vecs;
  const int v = threadIdx.x % run_vecs;
  const int g = threadIdx.x / run_vecs;
  const long long b = blockIdx.x;
  const int ox = min(max(org[b * 3 + 0], 0), X - BX);
  const int oy = min(max(org[b * 3 + 1], 0), Y - BY);
  const int oz = min(max(org[b * 3 + 2], 0), Z - BZ);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int n_rows = BX * BY;
#pragma unroll 4
  for (int r = g; r < n_rows; r += groups) {
    const int x = ox + r / BY;
    const int y = oy + r % BY;
    const size_t elem = (((size_t)x * Y + y) * Z + oz) * C;
    const uint4* src = reinterpret_cast<const uint4*>(table + elem);
    add_bf16x8(src[v], acc);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) partial[threadIdx.x * 8 + k] = acc[k];
  __syncthreads();
  // channel c is held by vectors v with (v*8) % C <= c < (v*8) % C + 8, one
  // per z, in every group
  const int vecs_per_z = C / 8;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg)
      for (int z = 0; z < BZ; ++z)
        s += partial[(gg * run_vecs + z * vecs_per_z + c / 8) * 8 + (c % 8)];
    out[(size_t)b * C + c] = s;
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 = ok).

int gather_rows(const void* table, const void* idx, int idx64, long long n_out,
                long long n_rows, int row_bytes, int lanes, void* out, void* stream) {
  return launch_gather<false>(table, idx, idx64, n_out, n_rows, 0, row_bytes, lanes, out,
                              (cudaStream_t)stream);
}

int gather_tile_rows(const void* table, const void* idx, int idx64, long long n_out,
                     long long tile, int row_bytes, int lanes, void* out, void* stream) {
  return launch_gather<true>(table, idx, idx64, n_out, n_out, tile, row_bytes, lanes, out,
                             (cudaStream_t)stream);
}

int box_gather8(const void* box, const void* code, long long n_req, int req_per_box,
                void* out, void* stream) {
  if (n_req <= 0) return 0;
  const int smem = kBoxFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(box_gather8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_req + req_per_box - 1) / req_per_box;
  box_gather8_kernel<<<(unsigned)blocks, kBoxThreads, smem, (cudaStream_t)stream>>>(
      (const float*)box, (const int*)code, n_req, req_per_box, (float*)out);
  return (int)cudaGetLastError();
}

int box_sum(const void* table, const void* org, int n_boxes, int X, int Y, int Z, int C,
            int BX, int BY, int BZ, int threads, void* out, void* stream) {
  if (n_boxes <= 0) return 0;
  const int smem = threads * 8 * (int)sizeof(float);
  box_sum_kernel<<<n_boxes, threads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)table, (const int*)org, X, Y, Z, C, BX, BY, BZ, (float*)out);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
