// The two reductions of the fused BatchNorm(+ReLU), for Hopper (sm_90a):
// the forward statistics (bn_stats_kernel, cmn_bn_stats) and the backward
// reduction (bn_bwd_reduce_kernel, cmn_bn_bwd_reduce).  Both read an
// activation viewed as [R, C] (channels last), of float32, bf16 or fp16,
// and do all arithmetic in float32.  Each gathers its blocks' partial sums
// in the same launch, in a fixed order, with no atomics on the sums: a
// rerun gives the same bits.
//
// ---------------------------------------------------------------------------
// bn_stats_kernel: the statistics
//
//     mean[c] = sum_r x[r, c] / R
//     var[c]  = max(sum_r x[r, c]^2 / R - mean[c]^2, 0)   (flax's fast form)
//
// Replaces the Pallas kernel chainermn_tpu/ops/fused_norm.py:78
// (`_stats_kernel`, reached from `_stats_call` at :166), which walks a
// sequential grid over row tiles and carries the two sums in VMEM scratch.
//
// What bounds it: 3 float32 operations per element against one element
// read, so device memory sets its least time: (x bytes + the two [C]
// float32 outputs) / 3.35 TB/s on an H100 SXM.  At ResNet-50's batch 32
// half the boundaries read under 7 MB (under 2 us at that rate), so fixed
// costs -- launches, a second pass over the partials on few SMs -- weigh
// as much as the bytes.  The design:
//  * One cooperative launch of at most one block an SM (132 on an H100).
//    A block takes a span of whole rows and, for C <= 2048, all C
//    channels: one contiguous run of memory.  Wider C is cut into channel
//    tiles of 2048 (blocks loop over their tiles).  The kernel's shared
//    memory lets two blocks share an SM, so a grid stays co-resident beside
//    another kernel (a concurrent launch on another stream, NCCL's).
//  * Loads: one thread copies the span through a ring of kStatsStages (6)
//    stages of kStageBytes (16 KB) in shared memory with 1-D bulk
//    asynchronous copies (the TMA engine, cp.async.bulk ...
//    mbarrier::complete_tx, no tensor map):
//    one copy a stage where the span is one run, one a row where C is
//    tiled.  One mbarrier a stage says when it has landed; a block barrier
//    after each stage is read frees it for the next copy.  Each thread
//    owns 8 neighbouring channels, reads them 16 bytes at a time from
//    shared memory and keeps sum x and sum x^2 in float32 registers.
//  * Bulk copies need 16-byte aligned addresses and sizes: with C % 8 == 0
//    and x 16-byte aligned every row, so every span and stage, is.  Else
//    the scalar path: one channel a thread (tiles of 256), plain loads of
//    four row steps at once, the same partials and finalize.
//  * Each block adds its threads' sums in shared memory (threads that share
//    channels, in row order) and writes one [2, C] float32 partial into the
//    call's workspace [spans, 2, C] (2.1 MB at C 2048, which stays in L2).
//  * Finalize in the same launch: a grid-wide barrier (cooperative groups),
//    then every block takes a slice of the channels and adds their partials
//    in span order -- groups of 4 channels read as 16-byte loads, 8 spans
//    loaded before any is added, the spans split into K slices on the
//    lanes of a warp, combined by a butterfly of warp shuffles -- and
//    writes mean and var.  No counter
//    and no memset: the barrier's state is the cooperative launch's own.
//    The order of every sum depends only on (R, C, the block count).
//
// ---------------------------------------------------------------------------
// bn_bwd_reduce_kernel: the backward reduction
//
//     dbeta[c]  = sum_r dz[r, c]
//     dgamma[c] = sum_r dz[r, c] * xhat[r, c]
//     xhat = (x - mean[c]) * invstd[c];  dz = g, or with the ReLU
//     dz = (xhat * scale[c] + bias[c] > 0) ? g : 0
//
// over x and its upstream gradient g.  Replaces the Pallas kernel
// chainermn_tpu/ops/fused_norm.py:119 (`_bwd_reduce_kernel`, reached from
// `_bwd_reduce_call` at :201), which walks a sequential grid over row
// tiles and carries the two sums in VMEM scratch.
//
// What bounds it: ~9 float32 operations per element against 2 elements of
// device memory read, so the card's memory rate (3.35 TB/s on an H100 SXM)
// and not its arithmetic sets its least time: (x bytes + g bytes + the six
// C-vectors) / 3.35 TB/s.  Two things stand between a GPU reduction and that
// bound: keeping enough bytes in flight on every SM, and gathering the
// blocks' partial sums without a second pass that runs on few SMs.  The
// design:
//  * Grid (chunks x channel tiles).  A block takes a tile of up to 128
//    channels and a chunk of whole rows; there is about one block per SM in
//    all, and each walks at least 8 row steps.  Narrow tiles give the wide
//    layers (C up to 2048) many tiles, each with few chunks, so that every
//    tile's finalize has few partials to add.
//  * Loads: each thread owns 8 neighbouring channels and streams rows of x
//    and g through its own cp.async ring of 8 stages in shared memory (16
//    bytes a copy: one of a 2-byte type, two of float32): seven stages in
//    flight, 56 KB a block at bf16 (112 KB at float32).  A thread reads back
//    only what it copied, so the ring needs no block barrier.  Partial sums
//    stay in float32 registers; the ReLU test rounds each step as the plain
//    version's separate operations do (no fused multiply-add), so the mask
//    is the plain version's bit for bit.
//  * Each block adds its threads' sums (threads that share channels, in row
//    order) in shared memory and writes one [2, tile] float32 partial to
//    the workspace [chunks, 2, C].
//  * Finalize in the same launch: each block fences its partial and takes a
//    ticket from its channel tile's counter; the block that draws the last
//    ticket adds the tile's partials over all chunks -- all 256 threads,
//    16-byte loads of 4 channels, 16 chunks loaded before any is added (a
//    load-add chain would leave one load in flight a thread), chunks split
//    into a fixed number of slices per output and the slices combined by a
//    fixed tree in shared memory -- and writes dbeta and dgamma.  The order
//    of every sum depends only on (R, C), so a rerun gives the same bits; no
//    atomics touch the sums.
//  * Counters: one int per channel tile, at the end of the launch's own
//    workspace, zeroed by a cudaMemsetAsync on the launch's stream just
//    before the kernel.  The workspace comes from PyTorch's stream-ordered
//    allocator, so launches on two streams never share a counter, a CUDA
//    graph captures the memset with the kernel and replays both, and no
//    count outlives its launch.  The memset costs one small device operation
//    a call; a per-device array reset by the last block would
//    save it but break under any of those three.
//  * The scalar path (C not a multiple of 8, or x or g not 16-byte
//    aligned): one channel a thread, plain loads of four row steps at once,
//    the same partials and finalize.
//
// Plain C entry points (bound from Python with ctypes, no PyTorch headers):
// the caller (chainermn_tpu_torch/ops/fused_norm.py) checks the tensors,
// chooses the geometry, allocates the outputs and the workspace (with the
// reduction's counters at its end), passes PyTorch's stream and the
// device, and raises if the returned cudaError_t is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with chainermn_tpu_torch/ops/fused_norm.py
enum Code { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;
constexpr int kVec = 8;       // channels a thread owns on the vector path
constexpr int kStages = 8;    // depth of each thread's cp.async ring
constexpr int kUnroll = 4;    // row steps loaded at once on the scalar path
constexpr int kBatch = 16;    // partials a finalize thread loads at once
constexpr int kMaxDevices = 64;
// the statistics: ring stages of bulk copies, their size, the spans a
// finalize thread loads at once, channels of a finalize group (vector path)
constexpr int kStatsStages = 6;
constexpr int kStageBytes = 16384;
constexpr int kStatsBatch = 8;
constexpr int kGroup = 4;

// The launch geometry, chosen by the caller: a block takes `tile_c` =
// `tpr` * (8 or 1) channels and `rows` rows (a multiple of `rpi`), its
// threads `rpi` rows x `tpr` channel groups at a step.
struct Geo {
  int64_t R, rows;
  int C, tpr, rpi, tile_c, relu;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !ok.
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a block: the threads' rings (vector path), then the
// [2][rpi][tile_c] float sums of the block's threads, which the finalize
// reuses for its slices (tile_c * rpi <= 8 * kThreads).
template <typename T, bool VEC>
struct Smem {
  static constexpr size_t ring =
      VEC ? static_cast<size_t>(kStages) * kThreads * 2 * kVec * sizeof(T)
          : 0;
  static constexpr size_t bytes = ring + 2 * kVec * kThreads * sizeof(float);
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ mean,
                         const float* __restrict__ invstd,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         float* __restrict__ dbeta,
                         float* __restrict__ dgamma, float* __restrict__ ws,
                         int* __restrict__ counters, const Geo geo) {
  constexpr int EPC = VEC ? kVec : 1;  // channels a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + Smem<T, VEC>::ring);
  __shared__ int last;

  const int tid = threadIdx.x;
  const int C = geo.C, rpi = geo.rpi, tile_c = geo.tile_c;
  const int row_in = tid / geo.tpr, grp = tid % geo.tpr;
  const bool active = row_in < rpi;
  const int tile0 = blockIdx.y * tile_c;  // the tile's first channel
  const int c0 = tile0 + grp * EPC;       // this thread's first channel
  const int64_t r_lo = static_cast<int64_t>(blockIdx.x) * geo.rows;
  const int64_t r_hi = r_lo + geo.rows < geo.R ? r_lo + geo.rows : geo.R;
  const int n_it = static_cast<int>((r_hi - r_lo + rpi - 1) / rpi);

  float m[EPC], is[EPC], sc[EPC], bi[EPC], db[EPC], dg[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    const bool ok = active && c0 + e < C;
    m[e] = ok ? mean[c0 + e] : 0.0f;
    is[e] = ok ? invstd[c0 + e] : 0.0f;
    sc[e] = ok ? scale[c0 + e] : 0.0f;
    bi[e] = ok ? bias[c0 + e] : 0.0f;
    db[e] = dg[e] = 0.0f;
  }
  // one row step of this thread's channels; a zero g adds nothing
  auto add = [&](int e, float xv, float gv) {
    const float xhat = __fmul_rn(__fsub_rn(xv, m[e]), is[e]);
    if (geo.relu && !(__fadd_rn(__fmul_rn(xhat, sc[e]), bi[e]) > 0.0f))
      gv = 0.0f;
    db[e] += gv;
    dg[e] += gv * xhat;
  };
  // row of step `it`, and whether this thread reads it
  auto row_of = [&](int it, bool& ok) {
    const int64_t r = r_lo + static_cast<int64_t>(it) * rpi + row_in;
    ok = active && c0 < C && r < r_hi;
    return r;
  };

  if constexpr (VEC) {
    // the ring: [stage][16-byte piece: x's, then g's][thread], so that a
    // warp's copies and reads fall on neighbouring 16-byte words
    constexpr int P = kVec * sizeof(T) / 16;  // pieces of one tensor
    constexpr int PIECE = 16 / sizeof(T);     // elements of one piece
    uint4* ring = reinterpret_cast<uint4*>(smem);
    auto slot = [&](int it, int piece) {
      return ring + (static_cast<size_t>(it % kStages) * 2 * P + piece) *
                        kThreads + tid;
    };
    auto issue = [&](int it) {
      if (it < n_it) {
        bool ok;
        const int64_t r = row_of(it, ok);
        const int64_t off = ok ? r * C + c0 : 0;
#pragma unroll
        for (int pc = 0; pc < P; ++pc) {
          cp_async16(slot(it, pc), x + off + pc * PIECE, ok);
          cp_async16(slot(it, P + pc), g + off + pc * PIECE, ok);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int it = 0; it < n_it; ++it) {
      issue(it + kStages - 1);
      cp_async_wait<kStages - 1>();  // step it's group has landed
      uint4 xr[P], gr[P];
#pragma unroll
      for (int pc = 0; pc < P; ++pc) {
        xr[pc] = *slot(it, pc);
        gr[pc] = *slot(it, P + pc);
      }
      const T* xv = reinterpret_cast<const T*>(xr);
      const T* gv = reinterpret_cast<const T*>(gr);
#pragma unroll
      for (int e = 0; e < kVec; ++e) add(e, to_f32(xv[e]), to_f32(gv[e]));
    }
    cp_async_wait<0>();
  } else {
    for (int it = 0; it < n_it; it += kUnroll) {
      float xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool ok;
        const int64_t r = row_of(it + u, ok);
        ok = ok && it + u < n_it;
        xv[u] = ok ? to_f32(x[r * C + c0]) : 0.0f;
        gv[u] = ok ? to_f32(g[r * C + c0]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(0, xv[u], gv[u]);
    }
  }

  // the block's partial: the threads of each channel added in row order
  if (active) {
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      red[row_in * tile_c + grp * EPC + e] = db[e];
      red[(rpi + row_in) * tile_c + grp * EPC + e] = dg[e];
    }
  }
  __syncthreads();
  const int nc = C - tile0 < tile_c ? C - tile0 : tile_c;  // tile's channels
  for (int o = tid; o < 2 * nc; o += kThreads) {
    const int w = o / nc, ci = o % nc;
    const float* col = red + w * rpi * tile_c + ci;
    float acc = 0.0f;
    for (int k = 0; k < rpi; ++k) acc += col[k * tile_c];
    ws[(static_cast<int64_t>(blockIdx.x) * 2 + w) * C + tile0 + ci] = acc;
  }

  // the last block of this channel tile to finish adds every partial
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(counters + blockIdx.y, 1) ==
           static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // outputs (dbeta then dgamma of the tile's channels) in groups of G
  // neighbouring channels, read as one 16-byte load on the vector path; K
  // slices of the chunks per group, K a power of two with K * groups a pass
  // <= threads.  A thread loads kBatch chunks of its slice before it adds
  // them, in chunk order: the loads are in flight together.
  constexpr int G = VEC ? 4 : 1;
  const int n_grp = 2 * nc / G, n_chunks = gridDim.x;
  int K = 1;
  while (2 * K * n_grp <= kThreads && K < n_chunks) K *= 2;
  const int per_pass = kThreads / K;
  const int k = tid / per_pass, j = tid % per_pass;
  for (int o0 = 0; o0 < n_grp; o0 += per_pass) {
    const int o = o0 + j;
    float acc[G] = {};
    if (o < n_grp) {
      const int w = o * G / nc, ci = o * G % nc;
      const float* src = ws + static_cast<int64_t>(w) * C + tile0 + ci;
      for (int n0 = k; n0 < n_chunks; n0 += kBatch * K) {
        float v[kBatch][G];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int n = n0 + u * K;
          const float* at = src + static_cast<int64_t>(n) * 2 * C;
          if constexpr (VEC) {
            const float4 f = n < n_chunks
                                 ? __ldcg(reinterpret_cast<const float4*>(at))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            v[u][0] = f.x;
            v[u][1] = f.y;
            v[u][2] = f.z;
            v[u][3] = f.w;
          } else {
            v[u][0] = n < n_chunks ? __ldcg(at) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int e = 0; e < G; ++e) acc[e] += v[u][e];
      }
    }
    if (K > 1) {
      __syncthreads();  // red is free: the previous pass is written out
#pragma unroll
      for (int e = 0; e < G; ++e) red[e * kThreads + tid] = acc[e];
      __syncthreads();
      for (int step = K / 2; step >= 1; step /= 2) {
        if (k < step)
#pragma unroll
          for (int e = 0; e < G; ++e) {
            float* r = red + e * kThreads + tid;
            *r += r[step * per_pass];
          }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < G; ++e) acc[e] = red[e * kThreads + j];
    }
    if (k == 0 && o < n_grp) {
      const int w = o * G / nc, ci = o * G % nc;
#pragma unroll
      for (int e = 0; e < G; ++e)
        (w == 0 ? dbeta : dgamma)[tile0 + ci + e] = acc[e];
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed per kernel
// and per device; done once, before the first launch on that device.
template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* g, const float* const* vecs,
                   float* dbeta, float* dgamma, float* ws, int* counters,
                   const Geo& geo, int n_chunks, int n_tiles, int device,
                   cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  auto kernel = bn_bwd_reduce_kernel<T, VEC>;
  constexpr size_t bytes = Smem<T, VEC>::bytes;
  if (!done[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  kernel<<<dim3(n_chunks, n_tiles), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), vecs[0], vecs[1],
      vecs[2], vecs[3], dbeta, dgamma, ws, counters, geo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_path(int vec, const void* x, const void* g,
                    const float* const* vecs, float* dbeta, float* dgamma,
                    float* ws, int* counters, const Geo& geo, int n_chunks,
                    int n_tiles, int device, cudaStream_t s) {
  return vec ? launch<T, true>(x, g, vecs, dbeta, dgamma, ws, counters, geo,
                               n_chunks, n_tiles, device, s)
             : launch<T, false>(x, g, vecs, dbeta, dgamma, ws, counters, geo,
                                n_chunks, n_tiles, device, s);
}

// ---------------------------------------------------------------------------
// the statistics
// ---------------------------------------------------------------------------

// The statistics' geometry, chosen by the caller: `gpr` threads cover a row
// of a channel tile (`tile_c` = gpr * (8 or 1) channels, `tiles` of them),
// `rpi` rows a step; a block takes `span` rows (a multiple of rpi) of each
// of its tiles, `stage_rows` rows (a multiple of rpi) a ring stage on the
// vector path.
struct StatsGeo {
  int64_t R, span;
  int C, gpr, rpi, tile_c, tiles, stage_rows;
};

// Shared memory of a statistics block: the ring and its mbarriers (vector
// path), then the [2][rpi][tile_c] float sums of the block's threads
// (tile_c * rpi <= 8 * kThreads).
template <bool VEC>
struct StatsSmem {
  static constexpr size_t ring =
      VEC ? static_cast<size_t>(kStatsStages) * kStageBytes : 0;
  static constexpr size_t bars = VEC ? kStatsStages * sizeof(uint64_t) : 0;
  static constexpr size_t bytes =
      ring + bars + 2 * kVec * kThreads * sizeof(float);
};

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

// Returns once the phase of barrier b with parity `parity` has completed.
// A stage lands in microseconds: a wait of 10 s is a fault, and traps --
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  if (bar_try(b, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_try(b, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

// `bytes` (a multiple of 16) from global memory at src to shared memory at
// dst (both 16-byte aligned) by the TMA engine, counted on barrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Adds the 8 neighbouring channels at p (16-byte aligned shared memory) to
// this thread's sums of x and x^2.
template <typename T>
__device__ __forceinline__ void add8(const unsigned char* p, float* s,
                                     float* q) {
  constexpr int P = kVec * sizeof(T) / 16;  // 16-byte pieces
  uint4 v[P];
#pragma unroll
  for (int pc = 0; pc < P; ++pc) v[pc] = reinterpret_cast<const uint4*>(p)[pc];
  const T* e = reinterpret_cast<const T*>(v);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float f = to_f32(e[i]);
    s[i] += f;
    q[i] = fmaf(f, f, q[i]);
  }
}

// Block `b` of `nblocks` adds the partials [spans, 2, C] of its slice of
// the channels, in span order, and writes their mean and variance: groups
// of G channels (one 16-byte load on the vector path), K slices of the
// spans a group on K neighbouring lanes of a warp (K a power of two, at
// most 32 and at most spans, K * groups a pass <= threads), each thread
// loading kStatsBatch spans of its slice before it adds them, the slices
// combined by a butterfly of warp shuffles (a fixed order; lane 0 writes).
template <bool VEC>
__device__ __forceinline__ void stats_finalize(const float* __restrict__ ws,
                                               float* __restrict__ mean,
                                               float* __restrict__ var,
                                               const StatsGeo& geo, int b,
                                               int nblocks) {
  constexpr int G = VEC ? kGroup : 1;
  const int tid = threadIdx.x, C = geo.C, spans = gridDim.x;
  const int ng = C / G;
  const int g_lo = static_cast<int>(static_cast<int64_t>(b) * ng / nblocks);
  const int n = static_cast<int>(static_cast<int64_t>(b + 1) * ng / nblocks) -
                g_lo;
  if (n == 0) return;
  int K = 1;
  while (2 * K * n <= kThreads && 2 * K <= spans && K < 32) K *= 2;
  const int per_pass = kThreads / K;
  const int k = tid % K, j = tid / K;
  const float rows = static_cast<float>(geo.R);
  for (int o0 = 0; o0 < n; o0 += per_pass) {
    const int o = o0 + j;
    float acc[2][G] = {};
    if (o < n) {
      const float* src = ws + (g_lo + o) * G;
      for (int n0 = k; n0 < spans; n0 += kStatsBatch * K) {
        float v[kStatsBatch][2][G];
#pragma unroll
        for (int u = 0; u < kStatsBatch; ++u) {
          const int sp = n0 + u * K;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float* at = src + (static_cast<int64_t>(sp) * 2 + w) * C;
            if constexpr (VEC) {
              const float4 f =
                  sp < spans ? __ldcg(reinterpret_cast<const float4*>(at))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              v[u][w][0] = f.x;
              v[u][w][1] = f.y;
              v[u][w][2] = f.z;
              v[u][w][3] = f.w;
            } else {
              v[u][w][0] = sp < spans ? __ldcg(at) : 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kStatsBatch; ++u)
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int e = 0; e < G; ++e) acc[w][e] += v[u][w][e];
      }
    }
    // every lane takes part (o0 is the same for the whole block)
    for (int lane = K / 2; lane >= 1; lane /= 2)
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int e = 0; e < G; ++e)
          acc[w][e] += __shfl_xor_sync(0xffffffffu, acc[w][e], lane);
    if (k == 0 && o < n) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const int c = (g_lo + o) * G + e;
        // the plain version's order: sum / R, then sumsq / R - mean^2
        const float m = __fdiv_rn(acc[0][e], rows);
        const float d = __fsub_rn(__fdiv_rn(acc[1][e], rows), __fmul_rn(m, m));
        mean[c] = m;
        var[c] = d < 0.0f ? 0.0f : d;  // a NaN stays NaN, as in clamp_min
      }
    }
  }
}

// Grid (spans, tile blocks): block (s, t) reduces rows [s * span, (s + 1)
// * span) of channel tiles t, t + gridDim.y, ...; launched cooperatively.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                    float* __restrict__ var, float* __restrict__ ws,
                    const StatsGeo geo) {
  constexpr int EPC = VEC ? kVec : 1;  // channels a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + StatsSmem<VEC>::ring);
  float* red = reinterpret_cast<float*>(smem + StatsSmem<VEC>::ring +
                                        StatsSmem<VEC>::bars);

  const int tid = threadIdx.x;
  const int C = geo.C, rpi = geo.rpi, tile_c = geo.tile_c;
  const int row_in = tid / geo.gpr, grp = tid % geo.gpr;
  const int64_t r_lo = static_cast<int64_t>(blockIdx.x) * geo.span;
  const int64_t r_hi = r_lo + geo.span < geo.R ? r_lo + geo.span : geo.R;
  if constexpr (VEC) {
    if (tid == 0) {
      for (int i = 0; i < kStatsStages; ++i) bar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  int64_t job = 0;  // ring stages this block has taken, over all its tiles
  for (int tile = blockIdx.y; tile < geo.tiles; tile += gridDim.y) {
    const int c_lo = tile * tile_c;
    const int nc = C - c_lo < tile_c ? C - c_lo : tile_c;  // tile's channels
    const bool active = row_in < rpi && grp * EPC < nc;
    float s[EPC], q[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) s[e] = q[e] = 0.0f;

    if constexpr (VEC) {
      const uint32_t row_bytes = nc * sizeof(T);
      const int n_st = static_cast<int>(
          (r_hi - r_lo + geo.stage_rows - 1) / geo.stage_rows);
      auto rows_of = [&](int st) {
        const int64_t left = r_hi - r_lo - static_cast<int64_t>(st) *
                                               geo.stage_rows;
        return left < geo.stage_rows ? static_cast<int>(left) : geo.stage_rows;
      };
      // thread 0 copies stage st of the span into its ring slot: one bulk
      // copy where the tile is whole rows (one run), else one a row
      auto issue = [&](int st) {
        if (tid != 0 || st >= n_st) return;
        const int slot = static_cast<int>((job + st) % kStatsStages);
        const int rows = rows_of(st);
        unsigned char* dst = ring + static_cast<size_t>(slot) * kStageBytes;
        const T* src = x + (r_lo + static_cast<int64_t>(st) * geo.stage_rows) *
                               C + c_lo;
        bar_expect(full + slot, rows * row_bytes);
        if (tile_c == C) {
          bulk_load(dst, src, rows * row_bytes, full + slot);
        } else {
          for (int i = 0; i < rows; ++i)
            bulk_load(dst + static_cast<size_t>(i) * tile_c * sizeof(T),
                      src + static_cast<int64_t>(i) * C, row_bytes,
                      full + slot);
        }
      };
      for (int st = 0; st < kStatsStages; ++st) issue(st);
      const size_t step = static_cast<size_t>(rpi) * tile_c * sizeof(T);
      for (int st = 0; st < n_st; ++st) {
        const int slot = static_cast<int>((job + st) % kStatsStages);
        bar_wait(full + slot,
                 static_cast<int>(((job + st) / kStatsStages) & 1));
        if (active) {
          const int rows = rows_of(st);
          const unsigned char* at =
              ring + static_cast<size_t>(slot) * kStageBytes +
              static_cast<size_t>(row_in * tile_c + grp * kVec) * sizeof(T);
#pragma unroll 4
          for (int i = row_in; i < rows; i += rpi, at += step)
            add8<T>(at, s, q);
        }
        __syncthreads();  // the slot is read: copy a later stage into it
        issue(st + kStatsStages);
      }
      job += n_st;
    } else {
      const int c = c_lo + grp;
      const int64_t stride = static_cast<int64_t>(rpi) * kUnroll;
      for (int64_t r = r_lo + row_in; active && r < r_hi; r += stride) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t rr = r + static_cast<int64_t>(u) * rpi;
          v[u] = rr < r_hi ? to_f32(x[rr * C + c]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[0] += v[u];
          q[0] = fmaf(v[u], v[u], q[0]);
        }
      }
    }

    // the block's partial of this tile: the threads of each channel added
    // in row order
    if (active) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        red[row_in * tile_c + grp * EPC + e] = s[e];
        red[(rpi + row_in) * tile_c + grp * EPC + e] = q[e];
      }
    }
    __syncthreads();
    for (int o = tid; o < 2 * nc; o += kThreads) {
      const int w = o / nc, ci = o % nc;
      const float* col = red + w * rpi * tile_c + ci;
      float acc = 0.0f;
      for (int k = 0; k < rpi; ++k) acc += col[k * tile_c];
      ws[(static_cast<int64_t>(blockIdx.x) * 2 + w) * C + c_lo + ci] = acc;
    }
    __syncthreads();  // red is free for the next tile
  }

  // every partial is written: each block finalizes its slice of channels
  cooperative_groups::this_grid().sync();
  stats_finalize<VEC>(ws, mean, var, geo, blockIdx.y * gridDim.x + blockIdx.x,
                      gridDim.x * gridDim.y);
}

// A cooperative launch (every block resident at once, which the grid
// barrier needs) of one statistics kernel; the shared memory above 48 KB is
// allowed once per kernel and device first.
template <typename T, bool VEC>
cudaError_t launch_stats(const void* x, float* mean, float* var, float* ws,
                         const StatsGeo& geo, int spans, int tile_blocks,
                         int device, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  auto kernel = bn_stats_kernel<T, VEC>;
  constexpr size_t bytes = StatsSmem<VEC>::bytes;
  if (!done[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spans, tile_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                       mean, var, ws, geo);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t stats_by_path(int vec, const void* x, float* mean, float* var,
                          float* ws, const StatsGeo& geo, int spans,
                          int tile_blocks, int device, cudaStream_t s) {
  return vec ? launch_stats<T, true>(x, mean, var, ws, geo, spans,
                                     tile_blocks, device, s)
             : launch_stats<T, false>(x, mean, var, ws, geo, spans,
                                      tile_blocks, device, s);
}

}  // namespace

// out [2, C] float32 = (dbeta, dgamma) of x, g [R, C] (contiguous, of type
// `dtype`) on `stream` of `device`.  `vecs` holds the mean, invstd, scale and bias
// pointers ([C] float32 each).  The geometry: `vec` (1: 8 channels a
// thread, C % 8 == 0 and x, g 16-byte aligned), `tpr` threads a row, `rpi`
// rows a step, blocks of `rows` rows (a multiple of rpi): n_chunks =
// ceil(R / rows) blocks for each of n_tiles = ceil(C / tile_c) channel
// tiles, tile_c = tpr * (vec ? 8 : 1).  `ws` holds [n_chunks, 2, C] floats,
// `counters` n_tiles ints, which this call zeroes on `stream` first.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cmn_bn_bwd_reduce(const void* x, const void* g,
                                 const float* const* vecs, float* out,
                                 float* ws, int* counters,
                                 int64_t R, int64_t C, int64_t rows, int tpr,
                                 int rpi, int vec, int relu, int dtype,
                                 int device, void* stream) {
  const int64_t epc = vec ? kVec : 1;
  if (R <= 0 || C <= 0 || C > (1ll << 30) || tpr <= 0 || rpi <= 0 ||
      tpr * rpi > kThreads || tpr * epc * rpi > kVec * kThreads ||
      rows <= 0 || rows % rpi || (vec && C % kVec) || device < 0 ||
      device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const int64_t tile_c = tpr * epc;
  const int64_t n_chunks = (R + rows - 1) / rows;
  const int64_t n_tiles = (C + tile_c - 1) / tile_c;
  if (n_chunks > 0x7fffffff || n_tiles > 65535) return cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: point it at the tensors'
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counters, 0, n_tiles * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const Geo geo{R, rows, static_cast<int>(C), tpr, rpi,
                static_cast<int>(tile_c), relu};
  const int nc = static_cast<int>(n_chunks), nt = static_cast<int>(n_tiles);
  float* dbeta = out;
  float* dgamma = out + C;
  switch (dtype) {
    case kF32:
      return by_path<float>(vec, x, g, vecs, dbeta, dgamma, ws, counters,
                            geo, nc, nt, device, s);
    case kBF16:
      return by_path<__nv_bfloat16>(vec, x, g, vecs, dbeta, dgamma, ws,
                                    counters, geo, nc, nt, device, s);
    case kF16:
      return by_path<__half>(vec, x, g, vecs, dbeta, dgamma, ws, counters,
                             geo, nc, nt, device, s);
  }
  return cudaErrorInvalidValue;
}

// mean, var [C] float32 of x [R, C] (contiguous, of type
// `dtype`) on `stream` of `device`.  The geometry: `vec` (1: 8 channels a
// thread and bulk copies, C % 8 == 0 and x 16-byte aligned), `gpr` threads
// a row of a channel tile (tile_c = gpr * (vec ? 8 : 1) channels), `rpi`
// rows a step, blocks of `span` rows (a multiple of rpi), ring stages of
// `stage_rows` rows (a multiple of rpi; vector path), `tile_blocks` blocks
// across the ceil(C / tile_c) tiles for each of the ceil(R / span) spans.
// `ws` holds [spans, 2, C] floats.  Every block must be resident at once:
// a grid larger than the card holds fails with
// cudaErrorCooperativeLaunchTooLarge.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cmn_bn_stats(const void* x, float* mean, float* var,
                            float* ws, int64_t R, int64_t C, int64_t span,
                            int gpr, int rpi, int stage_rows, int tile_blocks,
                            int vec, int dtype, int device, void* stream) {
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
    return cudaErrorInvalidValue;
  const int64_t epc = vec ? kVec : 1;
  const int64_t itemsize = dtype == kF32 ? 4 : 2;
  const int64_t tile_c = static_cast<int64_t>(gpr) * epc;
  if (R <= 0 || C <= 0 || C > (1ll << 30) || gpr <= 0 || rpi <= 0 ||
      gpr * rpi > kThreads || tile_c > C || tile_c * rpi > kVec * kThreads ||
      span <= 0 || span % rpi || stage_rows <= 0 || stage_rows % rpi ||
      (vec && (C % kVec || reinterpret_cast<uintptr_t>(x) % 16 ||
               stage_rows * tile_c * itemsize > kStageBytes)) ||
      tile_blocks <= 0 || device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const int64_t spans = (R + span - 1) / span;
  const int64_t tiles = (C + tile_c - 1) / tile_c;
  if (tile_blocks > tiles || tile_blocks > 65535 || spans > 0x7fffffff)
    return cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: point it at the tensor's
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StatsGeo geo{R, span, static_cast<int>(C), gpr, rpi,
                     static_cast<int>(tile_c), static_cast<int>(tiles),
                     stage_rows};
  const int ns = static_cast<int>(spans);
  switch (dtype) {
    case kF32:
      return stats_by_path<float>(vec, x, mean, var, ws, geo, ns, tile_blocks,
                                  device, s);
    case kBF16:
      return stats_by_path<__nv_bfloat16>(vec, x, mean, var, ws, geo, ns,
                                          tile_blocks, device, s);
    case kF16:
      return stats_by_path<__half>(vec, x, mean, var, ws, geo, ns,
                                   tile_blocks, device, s);
  }
  return cudaErrorInvalidValue;
}
