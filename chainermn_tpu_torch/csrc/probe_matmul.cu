// The stage-1 gradient products of ResNet-50, for Hopper (sm_90a).
//
//   wgrad:    C[256, 64] f32 = A[256, M] bf16 @ B[M, 64] bf16
//   rowblock: C[M, n] bf16   = bf16(A[M, k] bf16 @ B[k, n] bf16 in f32)
//             (k, n) = (64, 256): dgrad; (256, 64): the forward 1x1 conv
//
// M = 256 * 56 * 56 = 802,816 in the probe.  These replace the Pallas
// kernels of benchmarks/bench_pallas_conv_probe.py: make_wgrad_pallas (:51,
// its kernel body at :57: a grid over M that adds each block's product into
// a VMEM accumulator and stores it at the last step) and
// make_rowblock_pallas (:82, body at :88: a grid over row blocks of M, B
// whole in each block, the product rounded to bf16 once).
//
// What bounds them: every case moves ~514 MB (A and B read once, C written
// once) for 26.3 GFLOP, 51 FLOP a byte against the ~295 at which an H100
// SXM's bf16 tensor cores (989.4 TFLOP/s) would outrun its memory (3.35
// TB/s).  So memory sets the least time, ~0.153 ms, and the design is about
// keeping every SM streaming: a persistent grid of kSpans blocks, one an SM,
// each fed by TMA copies through an mbarrier ring of shared-memory stages
// (128-200 KB a block), multiplying with wgmma (bf16 in, float32
// accumulators in registers, both operands read from the stages as TMA
// swizzled them), and -- rowblock -- storing by TMA while its next tiles
// load and multiply.  `python3 flash_probe.py probe` times each kernel with
// a part of its work left out and each alternative named below; leaving
// the products out does not make either faster: the copies set the pace.
//
// The split.  M is cut into 64-row tiles, and the tiles into kSpans = 132
// spans balanced within one tile: span s holds base + 1 tiles if s < extra,
// else base.  wgrad's block s reduces span s as a contiguous run of tiles,
// from tile s * base + min(s, extra) (Share::span); rowblock's block s takes
// as many tiles, every kSpans-th from tile s (Share::strided), so that the
// blocks' stores fill neighbouring rows of C at any moment (the
// alternative, contiguous_rows, is slower).  The wrapper
// (ops/probe_matmul.py, probe_geometry) computes (spans, base, extra); the
// entry points refuse any other split.  The span count is a constant, not
// the card's SM count, so the bits do not depend on which card runs them.
// The probe's bm (rows of M a grid step on the TPU, and of a block in this
// file's earlier mma.sync design) takes no part here: every bm gives the
// same launch and the same bits; it only names the chunk order of the
// plain versions.
//
// wgrad.  Two warpgroups of 128 threads, each owning 128 of the 256 output
// rows and all 64 columns: two wgmma.m64n64k16 a k step.  A stage holds
// one tile: A's [256 rows, 64 k] (K-major, 32 KB) and B's [64 k, 64 n]
// (MN-major: the product reads it transposed, 8 KB), both 128-byte
// swizzled; 5 stages, 200 KB.  Warp 0 also feeds the ring: once both
// warpgroups have released a stage it loads the tile 5 ahead into it.  A
// tile reads 128 bytes of each of A's 256 rows, 1.6 MB apart: the maps
// promote L2 fetches to 256 bytes (the next tile's half;
// wgrad_no_promotion), and the loads mark their lines evict-first
// (wgrad_loads_normal).
// Accumulation: a tile's 64 products (4 k steps) are chained in the tensor
// cores from 0 (scale-d 0 on the first step), then added to 64 float
// accumulators a thread with round-to-nearest float adds.  The tensor
// cores' own accumulation is not specified to round to nearest, so its
// chain is kept to one tile (64 products) rather than a whole span (6,080
// at the probe's M).  Each block writes its float32 [256, 64] partial
// (zeros for an empty span) into a workspace of kSpans x 64 KB (8.65 MB,
// inside the 50 MB L2, whatever M and bm); span_sum_kernel adds the
// partials in a fixed order: 4 groups of 33 spans, each summed in span
// order from 0 by one thread, then ((g0 + g1) + g2) + g3.  Deterministic,
// no atomics, no counters to zero.
//
// rowblock.  B (32 KB) is loaded once per block.  The two warpgroups take
// the block's tiles in turn (warpgroup w its tiles w, w + 2, ...), each
// with one wgmma chain over the whole k (4 x m64n256k16 for dgrad, 16 x
// m64n64k16 for fwd1x1) into float accumulators, rounded once to bf16
// (round to nearest even, as the Pallas body's .astype), written into a
// staging tile laid out as the TMA store's 128-byte swizzle, and stored by
// one TMA store (cp.async.bulk.tensor) of the whole 64-row tile through a
// 3-D view of C, so that each row of C is written whole and in order
// (dgrad is slower with four 64-column boxes: box_stores).  Each warpgroup
// has two staging tiles: the store of its tile i runs while its tile i + 1
// is multiplied, and is waited for (cp.async.bulk.wait_group.read) only
// before tile i + 2 is staged.  The stores mark their lines evict-first
// (stores_normal).
// A tiles stream through one ring (8 stages of 8 KB for dgrad, 4 of 32 KB
// for fwd1x1); the warpgroup that releases a stage reloads it with the tile
// kStages ahead, which is its own again.  fwd1x1's A loads, most of its
// traffic, are evict-first too; dgrad's are not (dgrad_loads_first: slower
// so).
//
// Plain C entry points (bound from Python with ctypes, no PyTorch headers):
// the caller checks shapes, allocates the outputs and the workspace, passes
// the split, PyTorch's stream and the device, and raises if the returned
// cudaError_t is not 0.  The TMA tensor maps are built on the host at every
// launch and passed by value, so a CUDA graph captures them.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpans = 132;    // blocks of both kernels: spans of M
constexpr int kTile = 64;      // rows of M a tile
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWgradM = 256;   // wgrad's output: [256, 64]
constexpr int kWgradN = 64;
constexpr int kWgradOut = kWgradM * kWgradN;
constexpr int kSumGroups = 4;  // span_sum_kernel: groups of spans,
constexpr int kSumSpans = kSpans / kSumGroups;  // spans a group,
constexpr int kSumOuts = 32;   // outputs a block
constexpr int kMaxDevices = 64;
static_assert(kSpans % kSumGroups == 0, "spans split into equal groups");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (the helpers of flash_attention.cu, 2-D here)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* b, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(b)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the phase of barrier b with parity `parity` has completed
// (parity 1 before the first phase completes: the buffer starts empty).  A
// stage lands or frees in microseconds: a wait of 10 s is a fault, and
// traps -- the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  if (bar_try(b, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_try(b, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

// L2 cache policies of the copies (createpolicy): evict_first marks lines
// that no one reads again.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// The box at column c0, row r0 of a 2-D tensor map into shared memory at
// dst, counted on barrier `bar`, under L2 policy `pol`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0), "l"(pol)
      : "memory");
}

// The box at row r0 of a 3-D tile map (tile_map) from shared memory at
// src, in this thread's current bulk group, under L2 policy `pol`.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int r0,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(
          map)),
      "r"(smem_addr(src)), "r"(0), "r"(r0), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until every bulk group of this thread has completed (its writes
// done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's writes to shared memory visible to TMA (the async
// proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void sync_threads(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// a; lbo and sbo in bytes.  The address field is a's bits 4..17, so a byte
// offset >> 4 added to a descriptor moves it (shared memory is < 256 KB).
__device__ __forceinline__ uint64_t wg_desc(uint32_t a, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The address of a tile, hidden from the optimiser: the descriptors built
// from it are recomputed at each step (a few integer adds) instead of being
// hoisted out of the loop into registers the accumulators need.
__device__ __forceinline__ uint32_t opaque_addr(const void* p) {
  uint32_t a = smem_addr(p);
  asm volatile("" : "+r"(a));
  return a;
}

// K-major A operand at shared address a, a tile of R rows whose k columns
// lie in 64-wide regions of R x 128 bytes: rows r0..r0 + 63, k step kk
// (columns 16 kk..16 kk + 15).
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t a, int r0, int kk) {
  return wg_desc(a + r0 * 128, 16, 1024) +
         (((kk / 4) * R * 128 + (kk % 4) * 32) >> 4);
}

// MN-major B operand at shared address a, a tile of R k rows whose n
// columns lie in 64-wide regions of R x 128 bytes: k rows 16 kk..16 kk + 15,
// all n columns.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t a, int kk) {
  return wg_desc(a, R * 128, 1024) + ((kk * 16 * 128) >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or reuse of accumulators that an
// in-flight wgmma writes across the issue or the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// wgmma.mma_async m64nNk16, bf16 in, float32 accumulators, A K-major and B
// MN-major (transposed), both from shared memory; N = 64 or 256 (the
// accumulator's extent picks the overload); scale_d 0 overwrites d.
__device__ __forceinline__ void wg_mma(float (&d)[8][4], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[32][4], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Block s's share of a split (base, extra): `count` tiles, the t-th of them
// span(t) = first + t when the block takes a contiguous span (wgrad), or
// strided(t) = s + t kSpans when it takes every kSpans-th tile (rowblock);
// both cover every tile once.
struct Share {
  int s;
  int64_t first;
  int count;
  __device__ Share(int s_, int64_t base, int extra)
      : s(s_),
        first(s_ * base + min(s_, extra)),
        count(static_cast<int>(base) + (s_ < extra)) {}
  __device__ int64_t span(int t) const { return first + t; }
  __device__ int64_t strided(int t) const {
    return s + static_cast<int64_t>(t) * kSpans;
  }
};

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

struct WgradSmem {
  static constexpr int kA = kWgradM * 128;  // A [256 rows][64 k], 32 KB
  static constexpr int kB = kTile * 128;    // B [64 k][64 n], 8 KB
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = 5;
  static constexpr int kBars = kStages * kStage;
  static constexpr size_t kBytes = kBars + 2 * kStages * 8 + 1024;
};

// Block s: partial[s] = A[:, span s] @ B[span s, :] in float32.
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 float* __restrict__ partial, int64_t base, int extra) {
  using L = WgradSmem;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + S;
  const Share sp(blockIdx.x, base, extra);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kThreads);  // every thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 loads tile t into stage t % S once both warpgroups have
  // released the tile S before it
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int t) {
    if (t >= sp.count) return;
    const int s = t % S;
    bar_wait(empty + s, ((t / S) & 1) ^ 1);
    if (threadIdx.x == 0) {
      const int k0 = static_cast<int>(sp.span(t) * kTile);
      const uint64_t pol = evict_first();
      unsigned char* st = sm + s * L::kStage;
      bar_expect(full + s, L::kStage);
      tma_load(st, &tm_a, full + s, k0, 0, pol);
      tma_load(st + L::kA, &tm_b, full + s, 0, k0, pol);
    }
    __syncwarp();
  };
  if (producer)
    for (int t = 0; t < S; ++t) produce(t);

  // warpgroup cw: output rows cw * 128 + mi * 64 .. + 63, mi = 0, 1
  const int cw = threadIdx.x / 128;
  float acc[2][8][4] = {};
  float d[2][8][4];
  for (int t = 0; t < sp.count; ++t) {
    const int s = t % S;
    bar_wait(full + s, (t / S) & 1);
    const uint32_t a = opaque_addr(sm + s * L::kStage);
    const uint32_t b = a + L::kA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wg_mma(d[mi], kmajor<kWgradM>(a, cw * 128 + mi * 64, kk),
               mnmajor<kTile>(b, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(d[0]);
    reg_fence(d[1]);
    bar_arrive(empty + s);
    if (producer) produce(t + S);
    // the tile's 64-product chains, added in float (see the header)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += d[mi][j][e];
  }

  // the accumulator layout: row 16 warp + lane / 4 (+ 8 for e = 2, 3),
  // column 8 j + 2 (lane % 4) (+ 1 for odd e) of each 64-row tile
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float* out = partial + static_cast<int64_t>(blockIdx.x) * kWgradOut;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = cw * 128 + mi * 64 + warp * 16 + g, c = j * 8 + 2 * q;
      *reinterpret_cast<float2*>(out + r * kWgradN + c) =
          make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * kWgradN + c) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
}

// out[i] = ((g0 + g1) + g2) + g3, g_k the sum of partial[s][i] over the
// k-th group of kSumSpans spans, in span order from 0.  One thread per
// output and group, the group's loads all in flight.
__global__ void __launch_bounds__(kSumGroups * kSumOuts)
    span_sum_kernel(const float* __restrict__ partial,
                    float* __restrict__ out) {
  static_assert(kSumGroups == 4, "the fold below adds four groups");
  __shared__ float group[kSumGroups][kSumOuts];
  const int grp = threadIdx.x / kSumOuts, o = threadIdx.x % kSumOuts;
  const int i = blockIdx.x * kSumOuts + o;
  const float* p =
      partial + static_cast<int64_t>(grp) * kSumSpans * kWgradOut + i;
  float v[kSumSpans];
#pragma unroll
  for (int s = 0; s < kSumSpans; ++s) v[s] = p[s * kWgradOut];
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kSumSpans; ++s) acc += v[s];
  group[grp][o] = acc;
  __syncthreads();
  if (grp == 0)
    out[i] = ((group[0][o] + group[1][o]) + group[2][o]) + group[3][o];
}

// ---------------------------------------------------------------------------
// rowblock
// ---------------------------------------------------------------------------

template <int K, int N>
struct RowblockSmem {
  static constexpr int kB = K * N * 2;      // B: N / 64 regions [K][64]
  static constexpr int kA = kTile * K * 2;  // A tile: K / 64 regions [64][64]
  static constexpr int kC = kTile * N * 2;  // output tile: 64 x N / 64 lines
  // even: a stage is always taken by the same warpgroup (tiles t and t +
  // kStages alike), so no warpgroup waits on a stage's barrier while its
  // previous phase is still open -- a parity wait cannot tell that phase
  // from the one it waits for
  static constexpr int kStages = K == 64 ? 8 : 4;
  static_assert(kStages % 2 == 0, "two warpgroups take the tiles in turn");
  static constexpr int kRing = kB;
  static constexpr int kOut = kRing + kStages * kA;  // 2 a warpgroup
  static constexpr int kBars = kOut + 4 * kC;
  static constexpr size_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// Block s: C[tile rows] = bf16(A[tile rows] @ B) for each of its tiles,
// every kSpans-th from tile s.
template <int K, int N>
__global__ void __launch_bounds__(kThreads, 1)
    rowblock_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, int64_t base,
                    int extra) {
  using L = RowblockSmem<K, N>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* bbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = bbar + 1;
  uint64_t* empty = full + S;
  const Share sp(blockIdx.x, base, extra);
  if (sp.count == 0) return;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    bar_init(bbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 128);  // the warpgroup that takes the tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's tile t into stage t % S (one thread)
  auto load = [&](int t) {
    const int s = t % S;
    unsigned char* st = sm + L::kRing + s * L::kA;
    const int r0 = static_cast<int>(sp.strided(t) * kTile);
    // evicted first where A is most of the traffic (fwd1x1); dgrad, whose
    // stores are, ran slower so (see the header)
    const uint64_t pol = K == 256 ? evict_first() : evict_normal();
    bar_expect(full + s, L::kA);
#pragma unroll
    for (int j = 0; j < K / 64; ++j)
      tma_load(st + j * kTile * 128, &tm_a, full + s, 64 * j, r0, pol);
  };
  if (threadIdx.x == 0) {
    bar_expect(bbar, L::kB);
#pragma unroll
    for (int j = 0; j < N / 64; ++j)
      tma_load(sm + j * K * 128, &tm_b, bbar, 64 * j, 0, evict_normal());
    for (int t = 0; t < S && t < sp.count; ++t) load(t);
  }
  __syncwarp();
  bar_wait(bbar, 0);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  float acc[N / 8][4];
  int i = 0;  // this warpgroup's tiles so far
  for (int t = wg; t < sp.count; t += 2, ++i) {
    const int s = t % S;
    bar_wait(full + s, (t / S) & 1);
    const uint32_t a = opaque_addr(sm + L::kRing + s * L::kA);
    const uint32_t b = opaque_addr(sm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wg_mma(acc, kmajor<kTile>(a, 0, kk), mnmajor<K>(b, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    bar_arrive(empty + s);
    if (tid == 0 && t + S < sp.count) {  // reload the stage S tiles ahead
      bar_wait(empty + s, (t / S) & 1);
      load(t + S);
    }
    __syncwarp();

    // staging tile i % 2 of this warpgroup, once the store of its tile
    // i - 2 has read it: the accumulators rounded to bf16, (row r, column c)
    // in 128-byte line r N / 64 + c / 64 (the tile's rows whole, in order),
    // its 16-byte chunk (c % 64) / 8 XORed with the line % 8 (the TMA
    // store's swizzle)
    unsigned char* cs = sm + L::kOut + (2 * wg + (i & 1)) * L::kC;
    if (tid == 0) bulk_wait_read<1>();
    sync_threads(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int line = (warp * 16 + g + 8 * h) * (N / 64) + j / 8;
        *reinterpret_cast<__nv_bfloat162*>(
            cs + line * 128 + (((j % 8) ^ (line & 7)) << 4) + 4 * q) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    fence_async_smem();
    sync_threads(1 + wg, 128);
    if (tid == 0) {
      tma_store(&tm_c, cs, static_cast<int>(sp.strided(t) * kTile),
                evict_first());
      bulk_commit();
    }
    __syncwarp();
  }
  if (tid == 0) bulk_wait_all();  // the block's last stores are done
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Above 48 KB a block's dynamic shared memory must be allowed per kernel
// and per device; done once, before the first launch on that device.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes, int device, bool* done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// CUDA runtime, so it takes the driver's entry point from the runtime.
using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of a row-major [rows, cols] bf16 matrix at `base`, read or
// written in [box_rows][box_cols] boxes with the 128-byte swizzle (box_cols
// 64: one 128-byte row a box row), its L2 fetches promoted to `promotion`;
// rows past the end read as zeros and are not written.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int64_t rows,
                       int64_t cols, int box_rows, int box_cols,
                       CUtensorMapL2promotion promotion) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * 2)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major [rows, cols] bf16 matrix (cols a multiple
// of 64) written in whole tiles of 64 rows: the 3-D view (64 columns, cols /
// 64 blocks of them, rows), one box a tile, so that one store writes the
// tile's rows whole and in address order from a shared tile of 128-byte
// lines (row, block), 128-byte swizzled.
cudaError_t tile_map(CUtensorMap* map, void* base, int64_t rows,
                     int64_t cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(cols / 64),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[2] = {128, static_cast<cuuint64_t>(cols * 2)};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(cols / 64), kTile};
  cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The split both entry points take: M a positive multiple of kTile whose
// tile coordinates fit an int, cut into kSpans spans of base tiles, the
// first `extra` of them one more, covering every tile once.
bool bad_split(int64_t m_total, int spans, int64_t base, int extra) {
  if (m_total <= 0 || m_total % kTile || m_total > 0x7fffffff) return true;
  return spans != kSpans || base < 0 || extra < 0 || extra >= spans ||
         base * spans + extra != m_total / kTile;
}

template <int K, int N>
cudaError_t launch_rowblock(const void* a, const void* b, void* c,
                            int64_t m_total, int64_t base, int extra,
                            cudaStream_t s, int device) {
  static bool done[kMaxDevices] = {};
  using L = RowblockSmem<K, N>;
  // whole tiles of contiguous rows: nothing to promote
  constexpr CUtensorMapL2promotion promo = CU_TENSOR_MAP_L2_PROMOTION_NONE;
  CUtensorMap ma, mb, mc;
  cudaError_t err = tensor_map(&ma, a, m_total, K, kTile, 64, promo);
  if (err == cudaSuccess) err = tensor_map(&mb, b, K, N, K, 64, promo);
  if (err == cudaSuccess) err = tile_map(&mc, c, m_total, N);
  if (err == cudaSuccess)
    err = allow_smem(rowblock_kernel<K, N>, L::kBytes, device, done);
  if (err != cudaSuccess) return err;
  rowblock_kernel<K, N><<<kSpans, kThreads, L::kBytes, s>>>(ma, mb, mc, base,
                                                            extra);
  return cudaGetLastError();
}

}  // namespace

// C[256, 64] f32 = A[256, M] @ B[M, 64] (bf16, row-major, 16-byte aligned)
// over the split (spans, base, extra), through `work`, kSpans x 256 x 64
// floats of workspace.  Two launches on `stream` of `device`; returns the
// first cudaError_t that is not 0.
extern "C" int cmn_probe_wgrad(const void* a, const void* b, float* work,
                               float* c, int64_t m_total, int spans,
                               int64_t base, int extra, int device,
                               void* stream) {
  if (bad_split(m_total, spans, base, extra)) return cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: point it at the tensors'
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  // a tile reads 128 bytes of each A row; the 256-byte promotion fetches
  // the next tile's too
  constexpr CUtensorMapL2promotion promo = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  CUtensorMap ma, mb;
  err = tensor_map(&ma, a, kWgradM, m_total, kWgradM, 64, promo);
  if (err == cudaSuccess)
    err = tensor_map(&mb, b, m_total, kWgradN, kTile, 64, promo);
  if (err == cudaSuccess)
    err = allow_smem(wgrad_kernel, WgradSmem::kBytes, device, done);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_kernel<<<kSpans, kThreads, WgradSmem::kBytes, s>>>(ma, mb, work, base,
                                                           extra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  span_sum_kernel<<<kWgradOut / kSumOuts, kSumGroups * kSumOuts, 0, s>>>(
      work, c);
  return cudaGetLastError();
}

// C[M, n] bf16 = A[M, k] @ B[k, n] (bf16, row-major, 16-byte aligned) for
// (k, n) = (64, 256) or (256, 64) over the split (spans, base, extra), on
// `stream` of `device`.  Returns the launch's cudaError_t (0 on success).
extern "C" int cmn_probe_rowblock(const void* a, const void* b, void* c,
                                  int64_t m_total, int k, int n, int spans,
                                  int64_t base, int extra, int device,
                                  void* stream) {
  if (bad_split(m_total, spans, base, extra)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 64 && n == 256)
    return launch_rowblock<64, 256>(a, b, c, m_total, base, extra, s, device);
  if (k == 256 && n == 64)
    return launch_rowblock<256, 64>(a, b, c, m_total, base, extra, s, device);
  return cudaErrorInvalidValue;
}
