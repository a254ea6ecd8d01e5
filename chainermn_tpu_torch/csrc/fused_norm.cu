// The backward reduction of the fused BatchNorm(+ReLU), for Hopper (sm_90a).
//
//     dbeta[c]  = sum_r dz[r, c]
//     dgamma[c] = sum_r dz[r, c] * xhat[r, c]
//     xhat = (x - mean[c]) * invstd[c];  dz = g, or with the ReLU
//     dz = (xhat * scale[c] + bias[c] > 0) ? g : 0
//
// over an activation x and its upstream gradient g viewed as [R, C]
// (channels last), in float32 whatever their type (float32, bf16, fp16).
// Replaces the Pallas kernel chainermn_tpu/ops/fused_norm.py:119
// (`_bwd_reduce_kernel`, reached from `_bwd_reduce_call` at :201), which
// walks a sequential grid over row tiles and carries the two sums in VMEM
// scratch.
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
// Plain C entry point (bound from Python with ctypes, no PyTorch headers):
// the caller (chainermn_tpu_torch/ops/fused_norm.py) checks the tensors,
// chooses the geometry, allocates the outputs, the workspace and the
// counters, passes PyTorch's stream and the device, and raises if the
// returned cudaError_t is not 0.

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
