// Gather probes for Hopper (sm_90a): the four functions that the JAX
// package's TPU gather probes compute, as hand-written kernels, so that the
// render engine's memory paths can be chosen on the card's own numbers.
//
// Replaces the TPU kernels of
//   tools/probe_pallas_gather.py  kernel (vmem_take)      -> gather_rows
//   tools/probe_pallas_gather.py  kernel2 (vmem_rowloop)  -> gather_rows_loop
//   tools/probe_dynamic_gather.py run                     -> gather_tile_rows
//   tools/probe_kernel_gather.py  p1_rowloop              -> gather_tile_rows_loop
//   tools/probe_vreg_gather.py    kernel                  -> box_gather8
//   tools/probe_kernel_gather.py  p2_boxdma               -> box_sum
// (two pairs of TPU kernels compute one function by two mechanisms: a vector
// gather (jnp.take, dynamic_gather) against a scalar loop that copies one row
// an iteration from indices held in scalar memory. Each mechanism has its
// kernel here: lanes copying a row together in vectors, and a row loop of
// bulk copies.)
//
//   gather_rows      out[i, :] = table[idx[i], :]
//   gather_tile_rows out[b*A + i, :] = table[b*A + idx[b*A + i], :], idx in [0, A)
//   (the *_loop entry points compute the same two functions)
//   box_gather8      out[r, 0:8] = box[r / R][dx*16 + dy][dz*8 : dz*8 + 8],
//                    code[r] = dx*256 + dy*16 + dz, box b a 16x16x16x8 f32 cube
//                    (128 KB), R requests per box
//   box_sum          out[b, :] = sum over the (BX, BY, BZ) box at origin org[b]
//                    of table[x, y, z, :] (bf16), accumulated in f32
//
// What bounds them: all four move bytes and compute next to nothing, so the
// bound is bytes over the memory rate. Where the source stays in the 50 MB L2
// (the 8 MB table of gather_rows, each 512 KB-1 MB A x C tile of
// gather_tile_rows after its first touch) the HBM traffic is the output, the
// indices and the sources once, and the bound of "each input once, each
// output once" is generous.
//
// Design:
//   row gathers, vector form: a row is copied by `lanes` threads (a power of
//   two, at most 32). The wrapper's default is the smallest that covers the
//   row in vectors, so a 256-byte row takes half a warp and a 24-byte row one
//   lane per 8-byte vector, and neighbouring lanes read neighbouring
//   addresses. The vector width is the largest of 16/8/4/2 bytes that
//   divides the row. All offsets are 64-bit. (lanes = 1, one thread walking
//   a whole row, was the first row loop: a warp-wide load then touches 32
//   rows 256 bytes apart and uses 16 bytes of each, each store lands in 32
//   partial sectors, and each thread keeps little in flight: 11.7 % and
//   20.4 % of the bound on an H100, slower than torch.index_select.)
//   row gathers, row loop (gather_rows_loop_kernel): the TPU kernels' design,
//   rows brought into fast memory by a scalar loop and the block written back
//   whole, in the card's own terms. Every warp of a block issues, with its
//   own ring of kLoopStages stages of R rows (R * row_bytes about
//   kLoopStageBytes, R <= 32) in dynamic shared memory, and walks its groups
//   of R consecutive output rows with a grid stride. For a group, its 32
//   lanes load the R indices in one coalesced load (issued a group ahead, as
//   the TPU's scalar prefetch, so no index load stands between two copies),
//   clamp them and leave the source addresses in shared memory; lane 0 sets
//   the stage's mbarrier to expect R * row_bytes bytes and issues R bulk
//   copies (cp.async.bulk), one a row, into consecutive slots of the stage.
//   When a stage's barrier completes, lane 0 writes its R rows, which lie
//   one after another in the output, with one bulk store (a bulk group), and
//   waits for its store to have read the stage before it fills it again.
//   The copy engine moves whole lines in and whole lines out; the threads
//   only issue, and the bytes in flight are kLoopAhead stages x R rows x the
//   issuing warps. A bulk copy takes its addresses from uniform registers, so
//   one warp's copies go out one after another, some 130 cycles each on an
//   H100 SXM (csrc/ub360.cu): one issuing warp moves about 2 bytes a cycle
//   of 256-byte rows, where the bound needs about 14 a cycle on each SM. So
//   a block has kLoopWarps = 8 issuing warps, one block an SM. Measured on
//   an H100 (probes/variants.py --only gather_loop): 2 issuers an SM are
//   issue-bound (twice the time); 8 to 32 reach the same time within 4 % on
//   the 8 MB table. On p1_rowloop's 256 MB of tiles a second block an SM (16
//   or 32 issuers) is 6-9 % slower than one (a wider window of tiles in
//   flight at once), and 16 warps of one block with half the stage read as
//   8 do (PERF.md gives the times).
//   Designs not taken (timed by that probe): one issuing lane a block,
//   16 to 32 issuing warps an SM, other R and stage counts, and the vector
//   kernel at lanes = 1.
//   Stages are written and read only by the async proxy (bulk copy in, bulk
//   store out), so no proxy fence stands between them.
//   box_gather8: no staging. The TPU kernel brings a box into VMEM because
//   its vector unit reads nothing else; here the 50 MB L2 cache plays that
//   part. A request's 8 floats are one aligned 32-byte run of its box (float
//   offset 8 * (code & 4095)), one L2 sector, read by two lanes with one
//   16-byte load each, so HBM is read only for the runs that requests touch
//   (1 - 1/e of them at 4096 random requests a box) and a run asked for again
//   is an L2 hit. Consecutive requests go to consecutive lane pairs (a warp's
//   store is 512 contiguous bytes); each lane loads one code of a chunk of 32
//   requests (coalesced) and hands the run to its lane pair by a shuffle; a
//   warp has kBoxChunks chunks of loads in flight before its stores; the grid
//   is one warp per kBoxChunks * 32 requests, in request order, so the boxes
//   in flight are few and consecutive. No shared memory: an SM holds as many
//   blocks as their registers allow. Request indices are 32-bit where n_req
//   allows (a 64-bit division a request is 5 % slower).
//   Measured on an H100 (probes/variants.py --only box_gather8): about 66 %
//   of the bound, within 10 % of a copy_ of as many bytes; more chunks in
//   flight (2 to 8) or other block sizes are no faster, nor are loads that
//   ask the L2 for 64 to 256 bytes, a 32-byte L2 fetch hint or streaming
//   stores; its loads alone and its stores alone take about half the time
//   each (PERF.md gives the times).
//   Designs not taken (timed by that probe): the earlier one, a 512-thread
//   block a box staging all 128 KB by its threads (one block an SM, two
//   waves at the probe's 256 boxes, no overlap of a box's load and its
//   stores: 1.6x slower); the TPU's, the box brought in by bulk copies
//   (cp.async.bulk) on one mbarrier, which frees the threads but keeps one
//   block an SM and reads whole boxes (4 % slower by graph, 5 % faster after
//   an L2 flush); and a cluster of 2 or 4 blocks a box, each staging its
//   part by bulk copies and reading its peers' parts through distributed
//   shared memory (1.3x slower).
//   box_sum: a box (0.5-1 MB) is larger than shared memory, so it is
//   streamed: the innermost contiguous run is BZ*C elements; each thread owns
//   one 16-byte vector of that run and walks the BX*BY rows with f32
//   accumulators, then a fixed-order reduction through shared memory (no
//   atomics: the sum's order is the same in every run).
// Left for later: TMA box loads (cp.async.bulk.tensor) for box_sum, which
// would take the address arithmetic off the threads.
//
// Indices are clamped into range (row ids into the table or tile, box codes
// modulo 4096, box origins into the table), so a bad index reads a wrong row
// and never memory outside the tensors; the plain versions clamp alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// the row loop of bulk copies

constexpr int kLoopWarps = 8;          // issuing warps a block
constexpr int kLoopStageBytes = 4096;  // a stage holds R = this / row_bytes rows (1 to 32)
constexpr int kLoopStages = 3;         // stages in each warp's ring
constexpr int kLoopAhead = 2;          // groups whose copies are in flight before a store
constexpr int kLoopMaxBlocksPerSm = 1;  // 8 issuers an SM
constexpr int kLoopMaxRowBytes = 8192;
static_assert(kLoopAhead >= 1 && kLoopAhead < kLoopStages, "a stage to store, one to fill");
// per warp: kLoopStages mbarriers and 32 source addresses; then the rings
constexpr int kLoopBarBytes = kLoopWarps * kLoopStages * 8;
constexpr int kLoopHeadBytes = (kLoopBarBytes + kLoopWarps * 32 * 8 + 127) / 128 * 128;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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

// one arrival on bar, and bytes more that its phase waits for
__device__ __forceinline__ void bar_arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the bytes [src, src + bytes) (both ends 16-byte aligned) into dst, counted
// on bar as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the bytes [src, src + bytes) of shared memory to dst, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Warp w of block b takes the groups g = b*kLoopWarps + w + k*(warps in the
// grid) of R output rows each. Iteration k stores group k - kLoopAhead, then
// fills stage k % kLoopStages with group k; the last iterations only store.
template <bool kTiled>
__global__ void __launch_bounds__(kLoopWarps * 32)
gather_rows_loop_kernel(const char* __restrict__ table, const void* __restrict__ idx, int idx64,
                        long long n_out, long long n_rows, long long tile, int row_bytes, int R,
                        char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned stage_bytes = (unsigned)R * (unsigned)row_bytes;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem) + warp * kLoopStages;
  const char** src_of = reinterpret_cast<const char**>(smem + kLoopBarBytes) + warp * 32;
  unsigned char* ring = smem + kLoopHeadBytes + (size_t)warp * kLoopStages * stage_bytes;
  if (lane == 0) {
    for (int s = 0; s < kLoopStages; ++s) bar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  const long long groups = (n_out + R - 1) / R;
  const long long first = (long long)blockIdx.x * kLoopWarps + warp;
  const long long stride = (long long)gridDim.x * kLoopWarps;
  const long long n_iter = first < groups ? (groups - 1 - first) / stride + 1 : 0;
  // this lane's index of the group it fills next, loaded a group ahead
  long long next = 0;
  if (n_iter > 0 && lane < R && first * R + lane < n_out)
    next = load_index(idx, idx64, first * R + lane);

  for (long long k = 0; k < n_iter + kLoopAhead; ++k) {
    if (k >= kLoopAhead && lane == 0) {
      const long long j = k - kLoopAhead;
      const int s = (int)(j % kLoopStages);
      const long long row0 = (first + j * stride) * R;
      const unsigned rows = (unsigned)min((long long)R, n_out - row0);
      bar_wait(bars + s, (unsigned)(j / kLoopStages) & 1u);
      bulk_store(out + (size_t)row0 * row_bytes, ring + (size_t)s * stage_bytes,
                 rows * (unsigned)row_bytes);
    }
    if (k >= n_iter) continue;
    const long long row0 = (first + k * stride) * R;
    const int rows = (int)min((long long)R, n_out - row0);
    if (lane < rows) {
      const long long row = row0 + lane;
      long long src = next;
      if (kTiled) src = (row / tile) * tile + clampll(src, 0, tile - 1);
      src = clampll(src, 0, n_rows - 1);
      src_of[lane] = table + (size_t)src * row_bytes;
    }
    const long long row1 = row0 + stride * R + lane;
    if (k + 1 < n_iter && lane < R && row1 < n_out) next = load_index(idx, idx64, row1);
    __syncwarp();
    if (lane == 0) {
      const int s = (int)(k % kLoopStages);
      // the store that last read this stage, group k - kLoopStages, has
      // kLoopStages - kLoopAhead stores issued after it
      if (k >= kLoopStages) bulk_wait_read<kLoopStages - kLoopAhead>();
      unsigned char* dst = ring + (size_t)s * stage_bytes;
      bar_arrive_expect(bars + s, (unsigned)rows * (unsigned)row_bytes);
      for (int r = 0; r < rows; ++r)
        bulk_load(dst + (size_t)r * row_bytes, src_of[r], (unsigned)row_bytes, bars + s);
    }
    __syncwarp();
  }
  if (lane == 0) bulk_wait_all();
}

template <bool kTiled>
int launch_gather_loop(const void* table, const void* idx, int idx64, long long n_out,
                       long long n_rows, long long tile, int row_bytes, void* out,
                       cudaStream_t stream) {
  if (n_out <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > kLoopMaxRowBytes ||
      ((uintptr_t)table | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int R = std::max(1, std::min(32, kLoopStageBytes / row_bytes));
  const int smem = kLoopHeadBytes + kLoopWarps * kLoopStages * R * row_bytes;
  auto kernel = gather_rows_loop_kernel<kTiled>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLoopWarps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (n_out + R - 1) / R;
  const long long blocks = std::min((groups + kLoopWarps - 1) / kLoopWarps,
                                    (long long)std::min(per_sm, kLoopMaxBlocksPerSm) * sms);
  kernel<<<(unsigned)blocks, kLoopWarps * 32, smem, stream>>>(
      (const char*)table, idx, idx64, n_out, n_rows, tile, row_bytes, R, (char*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

constexpr int kBoxRuns = 4096;    // 32-byte runs (8 f32) in a 128 KB box
constexpr int kBoxThreads = 256;  // threads a block
constexpr int kBoxChunks = 1;     // chunks of 32 requests a warp has in flight

// Warp w serves the kBoxChunks * 32 requests from w * kBoxChunks * 32 on.
// Lane l loads the code of request 32k + l of each chunk k (one coalesced
// load a chunk) and resolves its run; then each half of the chunk's 16
// requests is served by lane pairs, lanes 2j and 2j + 1 taking one 16-byte
// half of request j's run, so that a warp's store covers 512 contiguous
// bytes. I is the request index's type (32 bits where n_req allows).
template <typename I>
__global__ void __launch_bounds__(kBoxThreads)
box_gather8_kernel(const float4* __restrict__ box, const int* __restrict__ code, I n_req,
                   I req_per_box, float4* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const I first = ((I)blockIdx.x * (kBoxThreads / 32) + threadIdx.x / 32) * (kBoxChunks * 32);
  long long run[kBoxChunks];  // box * kBoxRuns + (code & 4095), of request first + 32k + lane
#pragma unroll
  for (int k = 0; k < kBoxChunks; ++k) {
    const I r = first + k * 32 + lane;
    // code = dx*256 + dy*16 + dz; its float offset in the box,
    // (dx*16 + dy)*128 + dz*8, is 8 * (code & 4095): run code & 4095
    run[k] = r < n_req
                 ? (long long)(r / req_per_box) * kBoxRuns + (__ldg(code + r) & (kBoxRuns - 1))
                 : 0;
  }
  float4 v[2 * kBoxChunks];
#pragma unroll
  for (int k = 0; k < kBoxChunks; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long src = __shfl_sync(0xffffffffu, run[k], h * 16 + lane / 2);
      v[2 * k + h] = __ldg(box + src * 2 + (lane & 1));
    }
#pragma unroll
  for (int k = 0; k < kBoxChunks; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const I r = first + k * 32 + h * 16 + lane / 2;
      if (r < n_req) out[(size_t)r * 2 + (lane & 1)] = v[2 * k + h];
    }
}

template <typename I>
int launch_box_gather8(const void* box, const void* code, long long n_req, int req_per_box,
                       void* out, cudaStream_t stream) {
  const long long per_block = (long long)kBoxThreads / 32 * kBoxChunks * 32;
  const long long blocks = (n_req + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  box_gather8_kernel<I><<<(unsigned)blocks, kBoxThreads, 0, stream>>>(
      (const float4*)box, (const int*)code, (I)n_req, (I)req_per_box, (float4*)out);
  return (int)cudaGetLastError();
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

// The row loop of bulk copies: the same two functions. cudaErrorInvalidValue
// for rows that are no multiple of 16 bytes or over kLoopMaxRowBytes, and for
// a table or out not 16-byte aligned.
int gather_rows_loop(const void* table, const void* idx, int idx64, long long n_out,
                     long long n_rows, int row_bytes, void* out, void* stream) {
  return launch_gather_loop<false>(table, idx, idx64, n_out, n_rows, 0, row_bytes, out,
                                   (cudaStream_t)stream);
}

int gather_tile_rows_loop(const void* table, const void* idx, int idx64, long long n_out,
                          long long tile, int row_bytes, void* out, void* stream) {
  return launch_gather_loop<true>(table, idx, idx64, n_out, n_out, tile, row_bytes, out,
                                  (cudaStream_t)stream);
}

int box_gather8(const void* box, const void* code, long long n_req, int req_per_box,
                void* out, void* stream) {
  if (n_req <= 0) return 0;
  if (req_per_box <= 0 || ((uintptr_t)box | (uintptr_t)out) % 16) return (int)cudaErrorInvalidValue;
  // 32-bit request indices while a warp's last request, n_req + 32 * kBoxChunks, fits
  if (n_req < (1LL << 31))
    return launch_box_gather8<unsigned>(box, code, n_req, req_per_box, out, (cudaStream_t)stream);
  return launch_box_gather8<unsigned long long>(box, code, n_req, req_per_box, out,
                                                (cudaStream_t)stream);
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
