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
// streaming: 16-byte cp.async copies from every thread, double-buffered
// tiles, and tensor-core products (mma.sync.m16n8k16, bf16 in, f32
// accumulators in registers, operands from shared memory through ldmatrix)
// that keep up with the copies.  wgmma/TMA would add nothing a
// bytes-bound kernel needs first.
//
// wgrad.  On the TPU the grid runs in order and one accumulator collects
// the whole M reduction.  Here blocks run in parallel and in no order, and
// one block per output tile would put the 256x64 output on 1-4 of 132 SMs.
// So the M reduction is split: block c takes rows [c bm, (c + 1) bm) of M
// (bm keeps the probe's meaning, rows of M a grid step) and writes its f32
// [256, 64] partial into a workspace; a second kernel sums the partials in
// chunk order, one thread an output element: deterministic, no atomics
// (the rule of fused_norm's two-stage reductions).  The workspace is
// M / bm x 64 KB (51 MB at bm 1024, 6.4 MB at 8192) and its round trip is
// the split's cost, which the probe's bm sweep shows.  A [256, M] has the
// contraction axis contiguous (the mma's row-major A: ldmatrix); B [M, 64]
// has it along the rows (ldmatrix.trans).  Each of 8 warps owns 32 of the
// 256 output rows and all 64 columns (64 f32 accumulators a thread); a
// step takes 64 rows of M: a [256, 64] A tile and a [64, 64] B tile.  Each
// mma sums 16 products from 0 and the float adds after it round to nearest:
// the tensor cores' own accumulation is not specified to, and a chain of
// M / 16 of them in one accumulator could drift as M grows.
//
// rowblock.  Block b takes rows [b bm, (b + 1) bm) of M, 64 rows a step.
// B (32 KB) is copied into shared memory once per block; A tiles stream in
// through cp.async, one ahead.  The f32 accumulators of a 64-row tile are
// rounded to bf16 once (round to nearest even, as the Pallas body's
// .astype), staged in shared memory and written out as 16-byte rows.
//
// Tiles are padded by 16 bytes a row so that ldmatrix's eight row addresses
// fall into different banks.  Plain C entry points (bound from Python with
// ctypes, no PyTorch headers): the caller checks shapes, allocates the
// outputs and the workspace, passes PyTorch's stream and the device, and
// raises if the returned cudaError_t is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBk = 64;        // rows of M a step takes (both kernels)
constexpr int kWgradM = 256;   // wgrad's output: [256, 64]
constexpr int kWgradN = 64;
constexpr int kSumThreads = 128;
constexpr int kSumUnroll = 16;  // loads in flight per thread of the sum
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b for one 16x8x16 tile, bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (rows r0..r0+15, k columns k0..k0+15) of a row-major tile of
// pitch LD elements.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* tile,
                                       int r0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of the 8-column tiles n0 (r[0..1]) and n0 + 8 (r[2..3]) for k
// rows k0..k0+15, from a tile stored [k][n] of pitch LD (transposed).
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 +
                   (lane >> 4) * 8);
}

// ROWS x COLS bf16 from global (row pitch `ld` elements) into shared memory
// (pitch COLS + 8), 16 bytes a copy, asynchronously.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t ld) {
  constexpr int kPieces = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    cp_async16(dst + r * (COLS + 8) + c, src + r * ld + c);
  }
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

struct WgradSmem {
  static constexpr int kALd = kBk + 8;      // A tile [256][64 + 8]
  static constexpr int kBLd = kWgradN + 8;  // B tile [64][64 + 8]
  static constexpr int kA = kWgradM * kALd;
  static constexpr int kB = kBk * kBLd;
  static constexpr size_t kBytes = 2 * (kA + kB) * sizeof(bf16);  // 92,160
};

// Block c: partial[c] = A[:, c bm : (c + 1) bm] @ B[c bm : (c + 1) bm, :].
__global__ void __launch_bounds__(kThreads)
wgrad_chunk_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   float* __restrict__ partial, int64_t m_total, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + 2 * WgradSmem::kA;
  const int64_t k_first = static_cast<int64_t>(blockIdx.x) * bm;
  const int steps = bm / kBk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto load = [&](int s, int buf) {
    const int64_t k0 = k_first + static_cast<int64_t>(s) * kBk;
    copy_tile<kWgradM, kBk>(as + buf * WgradSmem::kA, a + k0, m_total);
    copy_tile<kBk, kWgradN>(bs + buf * WgradSmem::kB, b + k0 * kWgradN,
                            kWgradN);
    cp_async_commit();
  };

  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      load(s + 1, buf ^ 1);  // the other buffer was freed by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = as + buf * WgradSmem::kA;
    const bf16* bt = bs + buf * WgradSmem::kB;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t fa[2][4], fb[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        frag_a<WgradSmem::kALd>(fa[mi], at, warp * 32 + mi * 16, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        frag_b<WgradSmem::kBLd>(fb[j], bt, 16 * j, kk);
      // 16 products a mma from 0, added in float (see the header)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma(d, fa[mi], fb[ni / 2][(ni % 2) * 2],
              fb[ni / 2][(ni % 2) * 2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
        }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * kWgradM * kWgradN;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int r = warp * 32 + mi * 16 + g, c = ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + r * kWgradN + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * kWgradN + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// out[i] = partial[0][i] + partial[1][i] + ... in chunk order (a left fold
// from 0, as the plain version sums), kSumUnroll loads in flight a thread.
__global__ void __launch_bounds__(kSumThreads)
chunk_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int64_t chunks, int n) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = partial + i;
  float acc = 0.f;
  int64_t c = 0;
  for (; c + kSumUnroll <= chunks; c += kSumUnroll) {
    float v[kSumUnroll];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) v[u] = __ldg(p + (c + u) * n);
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) acc += v[u];
  }
  for (; c < chunks; ++c) acc += __ldg(p + c * n);
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// rowblock
// ---------------------------------------------------------------------------

template <int K, int N>
struct Rowblock {
  // 8 warps over a [64, N] output tile: WM x WN warps of RM x RN
  static constexpr int kWN = N >= 256 ? 4 : 2;
  static constexpr int kWM = 8 / kWN;
  static constexpr int kRM = kBk / kWM;
  static constexpr int kRN = N / kWN;
  static constexpr int kMI = kRM / 16;
  static constexpr int kNI = kRN / 8;
  static constexpr int kALd = K + 8, kBLd = N + 8, kCLd = N + 8;
  static constexpr int kA = kBk * kALd;  // one A stage [64][K + 8]
  static constexpr int kB = K * kBLd;    // B [K][N + 8]
  static constexpr int kC = kBk * kCLd;  // output tile [64][N + 8]
  static constexpr size_t kBytes = (2 * kA + kB + kC) * sizeof(bf16);
};

template <int K, int N>
__global__ void __launch_bounds__(kThreads)
rowblock_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                bf16* __restrict__ c, int bm) {
  using L = Rowblock<K, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + 2 * L::kA;
  bf16* cs = bs + L::kB;
  const int64_t row_first = static_cast<int64_t>(blockIdx.x) * bm;
  const int tiles = bm / kBk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / L::kWN, wn = warp % L::kWN;

  copy_tile<K, N>(bs, b, N);
  copy_tile<kBk, K>(as, a + row_first * K, K);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    const int64_t row0 = row_first + static_cast<int64_t>(tile) * kBk;
    if (tile + 1 < tiles) {
      copy_tile<kBk, K>(as + (buf ^ 1) * L::kA, a + (row0 + kBk) * K, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = as + buf * L::kA;
    float acc[L::kMI][L::kNI][4];
#pragma unroll
    for (int mi = 0; mi < L::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t fa[L::kMI][4], fb[L::kNI / 2][4];
#pragma unroll
      for (int mi = 0; mi < L::kMI; ++mi)
        frag_a<L::kALd>(fa[mi], at, wm * L::kRM + mi * 16, kk);
#pragma unroll
      for (int j = 0; j < L::kNI / 2; ++j)
        frag_b<L::kBLd>(fb[j], bs, wn * L::kRN + 16 * j, kk);
#pragma unroll
      for (int mi = 0; mi < L::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < L::kNI; ++ni)
          mma(acc[mi][ni], fa[mi], fb[ni / 2][(ni % 2) * 2],
              fb[ni / 2][(ni % 2) * 2 + 1]);
    }
    // round once to bf16 into the staging tile (the previous tile's stores
    // from it finished before this iteration's first barrier)
#pragma unroll
    for (int mi = 0; mi < L::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::kNI; ++ni) {
        const int r = wm * L::kRM + mi * 16 + g;
        const int col = wn * L::kRN + ni * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(cs + r * L::kCLd + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<__nv_bfloat162*>(cs + (r + 8) * L::kCLd + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
      }
    __syncthreads();  // the tile is staged; every warp is done with `buf`
    constexpr int kPieces = N / 8;
    for (int i = threadIdx.x; i < kBk * kPieces; i += kThreads) {
      const int r = i / kPieces, col = (i % kPieces) * 8;
      *reinterpret_cast<uint4*>(c + (row0 + r) * N + col) =
          *reinterpret_cast<const uint4*>(cs + r * L::kCLd + col);
    }
  }
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

// the split both entry points take: bm a multiple of kBk dividing M
bool bad_split(int64_t m_total, int64_t bm) {
  return bm <= 0 || bm % kBk || m_total <= 0 || m_total % bm ||
         m_total / bm > 0x7fffffff;
}

template <int K, int N>
cudaError_t launch_rowblock(const void* a, const void* b, void* c,
                            int64_t m_total, int64_t bm, cudaStream_t s,
                            int device) {
  static bool done[kMaxDevices] = {};
  constexpr size_t bytes = Rowblock<K, N>::kBytes;
  cudaError_t err = allow_smem(rowblock_kernel<K, N>, bytes, device, done);
  if (err != cudaSuccess) return err;
  rowblock_kernel<K, N><<<static_cast<unsigned>(m_total / bm), kThreads,
                          bytes, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), static_cast<int>(bm));
  return cudaGetLastError();
}

}  // namespace

// C[256, 64] f32 = A[256, M] @ B[M, 64] (bf16, row-major, 16-byte aligned)
// through `work`, M / bm x 256 x 64 floats of workspace.  Two launches on
// `stream` of `device`; returns the first cudaError_t that is not 0.
extern "C" int cmn_probe_wgrad(const void* a, const void* b, float* work,
                               float* c, int64_t m_total, int64_t bm,
                               int device, void* stream) {
  if (bad_split(m_total, bm)) return cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: point it at the tensors'
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  err = allow_smem(wgrad_chunk_kernel, WgradSmem::kBytes, device, done);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = m_total / bm;
  wgrad_chunk_kernel<<<static_cast<unsigned>(chunks), kThreads,
                       WgradSmem::kBytes, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), work,
      m_total, static_cast<int>(bm));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kOut = kWgradM * kWgradN;
  chunk_sum_kernel<<<kOut / kSumThreads, kSumThreads, 0, s>>>(work, c, chunks,
                                                             kOut);
  return cudaGetLastError();
}

// C[M, n] bf16 = A[M, k] @ B[k, n] (bf16, row-major, 16-byte aligned) for
// (k, n) = (64, 256) or (256, 64), one block per bm rows, on `stream` of
// `device`.  Returns the launch's cudaError_t (0 on success).
extern "C" int cmn_probe_rowblock(const void* a, const void* b, void* c,
                                  int64_t m_total, int64_t bm, int k, int n,
                                  int device, void* stream) {
  if (bad_split(m_total, bm)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 64 && n == 256)
    return launch_rowblock<64, 256>(a, b, c, m_total, bm, s, device);
  if (k == 256 && n == 64)
    return launch_rowblock<256, 64>(a, b, c, m_total, bm, s, device);
  return cudaErrorInvalidValue;
}
