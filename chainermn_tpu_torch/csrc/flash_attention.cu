// Flash attention -- forward, dK/dV and dQ -- for Hopper (sm_90a).
//
// Three entry points replace the three Pallas kernels of
// chainermn_tpu/ops/flash_attention.py:
//
//   cmn_flash_fwd      <- _fwd_kernel (:136), called by _forward (:231)
//   cmn_flash_bwd_dkv  <- _dkv_kernel (:307), called by _pallas_backward (:465)
//   cmn_flash_bwd_dq   <- _dq_kernel  (:393), called by _pallas_backward (:465)
//
// They compute what the TPU kernels compute, with the same conventions:
// q [B, Tq, H, D] and k/v [B, Tk, Hk, D] (any strides with a unit stride
// along D, a 16-byte aligned base and strides of 16-byte multiples: the
// views a fused qkv projection's split gives); GQA (q head h reads kv head
// h / (H / Hk)); the score scaled after the QK^T product; masked scores set
// to -1e30 and masked probabilities zeroed explicitly; causal and
// segment-id masks on GLOBAL positions
// (per-sequence offsets [B, 2]); dropout on the normalised weights from the
// counter hash of (seed, b * H + h, q position, k position), with inverted
// scaling and the denominator built from the undropped weights; P cast to
// v's dtype before the PV product; an empty row gives output 0 and lse 1e30;
// the lse cotangent (glse) enters ds as a * glse * scale.
//
// What bounds them: at the shapes attention runs (head dim 16..128, long
// sequences) each kernel does ~D multiply-adds per byte it must move, far
// above the H100's 295 (bf16) or 20 (float32) operations per byte, so the
// least time is the matrix-product FLOPs (2 products forward, 4 for dK/dV,
// 3 for dQ, over the (q, k) pairs the mask allows) over the peak of the
// units that run them: 989 TFLOP/s for bf16/fp16 (tensor cores), 66.9
// TFLOP/s for float32 (CUDA cores, never TF32).  What keeps a kernel from
// it is feeding those units: operand traffic through shared memory, copies
// that stall the products, and the softmax (or gradient) arithmetic
// between two products.
//
// Which kernel runs is a dispatch by dtype and head dim, one kernel each:
//
//   bf16/fp16, D 64 and 128: fwd_wgmma_kernel, dkv_wgmma_kernel,
//                            dq_wgmma_kernel (wgmma + TMA)
//   bf16/fp16, D 16 and 32:  fwd_tc_kernel, dkv_tc_kernel, dq_tc_kernel
//                            (mma.sync)
//   float32, any D:          *_f32_kernel (CUDA cores)
//
// Common to all:
//  * TPU grids run in order and carry accumulators in VMEM scratch across
//    the innermost grid axis; here one block owns an output tile and walks
//    the other axis in a loop: forward, one block per (b*h, q tile) looping
//    over K/V tiles with an online softmax in float32; dK/dV, one block per
//    (b*hk, key tile) looping over the group's q heads and the q tiles at or
//    after the diagonal, so the GQA group sum of dK/dV is taken in float32
//    inside the kernel; dQ, one block per (b*h, q tile) looping over K/V
//    tiles.  No atomics: one block writes each output tile, so a rerun
//    gives the same bits.
//  * Tiles past the causal diagonal are never visited, as the TPU kernels
//    skip their grid steps; causal q tiles run heaviest first.
//  * ragged sequence ends are masked in the kernels (rows and keys past T),
//    so any Tq and Tk work, Tq != Tk included.
//
// The wgmma kernels (the LM's path: bf16, D 128).  A block of 128 output
// rows (q rows forward and for dQ, keys for dK/dV) is two warpgroups of 64
// rows each, whose first warp is also the producer.  It issues TMA copies
// (cp.async.bulk.tensor) of the tiles the block walks -- K/V tiles of 128
// keys forward and of 64 for dQ, Q/dO tiles of 64 rows for dK/dV -- into a
// ring of shared-memory stages with `full`/`empty` mbarriers, and writes
// each stage's per-row vectors (kv segment ids; lse, delta, glse, q segment
// ids) with plain loads, since a ragged T leaves them too short for bulk
// copies.  The tensor maps are 4-D (D, H, T, B) over the caller's strides,
// so the strided q/k/v views of one qkv projection are read in place, and
// rows past T arrive as zeros, never from the next sequence.  The warpgroups
// run wgmma.mma_async m64nNk16 with float32 accumulators in registers: S = Q
// K^T (dK/dV: S^T = K Q^T and dP^T = V dO^T; dQ: S = Q K^T and dP = dO V^T)
// with both operands read from the 128-byte-swizzled tiles, then O += P V
// (dV += P_drop^T dO, dK += dS^T Q; dQ += dS K) with P (dS) packed to 16
// bits in registers as the A operand and V (dO, Q; K) read MN-major.  The
// forward and dQ are software-pipelined: the scores (and dP) of tile kt are
// issued before, and their softmax (element step) runs while, P V (dS K) of
// tile kt - 1 is on the tensor cores.  That answers the mma.sync kernels'
// four limits: 64-row warpgroup products read each B tile once per 64 rows
// instead of once per 16; the tiles are 128 wide; one thread issues each
// tile's copy; copies, products and softmax overlap.  There is no separate
// producer warpgroup: with 12 warps a block's threads are held to 168
// registers (3 warps share each quarter of the register file), which ptxas
// did not lift for the consumers through setmaxnreg, while the dK/dV
// consumers need ~230 (128 for the dK/dV accumulators alone at D 128).
// With 8 warps each thread may have 255.
//
// The mma.sync kernels (bf16/fp16 at D 16 and 32): four warps, each owning
// 16 output rows; mma.sync m16n8k16 with float32 accumulators in registers
// -- scores, dP, the output and the dQ/dK/dV accumulators never go through
// shared memory, and P (dS) is repacked from the accumulator layout into the
// next product's A operand in registers; operands come from shared memory by
// ldmatrix; the next K/V (Q/dO) tile is copied in with cp.async while the
// current one is used.
//
// The float32 kernels (*_f32_kernel): the products run on the CUDA cores in
// float32 (never TF32, no split into TF32 parts), so the float32 gates hold.
// They are the path of float32 models (the long-context example), not of
// the bf16 LM.  On the CUDA cores the limit is shared memory: an SM returns
// 128 bytes (32 floats) of it a clock and runs 128 FMAs a clock, so a
// kernel whose threads read F floats of shared memory per FMA runs at most
// 1 / (4 F) of the float32 peak (measured, the model is pessimistic: a
// 128-bit read that a quarter warp shares costs less).  All three are
// register-blocked:
//  * fwd_f32_kernel: a block of 256 threads owns 128 q rows and walks K/V
//    tiles of 64 keys, double-buffered by cp.async (the next tile's copy
//    runs under this tile's products); causal q tiles heaviest first.  Row
//    groups of 16 lanes in one warp: a thread holds an 8 x 4 micro-tile of S
//    (rows ty + 16 i, keys tx + 16 j) and the same 8 rows' 8 output dims
//    (at D 128) in registers, with its rows' running max (reduced by
//    __shfl_xor_sync over the 16 lanes, every row at once) and its own
//    share of the denominator (summed over the lanes once, at the end).  O
//    is rescaled in registers; P goes through shared memory once, over the
//    tile's K stage, as P V contracts over keys.  Operands are 128-bit
//    reads (ld.shared.v4): Q and K along D, P along the keys, V along D.
//    Per 4 dims of S a thread reads 8 + 4 float4 for 128 FMAs, per 4 keys
//    of P V 8 + 8 for 256: F = 0.31 a tile (cap 0.80).  In a quarter warp
//    the Q and P reads are one broadcast address, the K and V reads eight
//    rows (pitch D + 4: distinct banks) or eight consecutive float4.
//  * dkv_f32_kernel: a block of 256 threads owns 64 keys, with K and V
//    staged once and Q/dO tiles of 64 rows double-buffered by cp.async.  A
//    thread holds 4 keys x 4 q rows of S^T and of dP^T (both products in
//    one loop over D), runs the element step on them in registers, and
//    keeps 4 keys x 8 dims (D 128) of dK and of dV.  P_drop^T, then dS^T,
//    go through one shared [key][q] buffer as the A operands of dV +=
//    P_drop^T dO and dK += dS^T Q.  F = 0.44 (cap 0.57).  The causal skip of
//    q tiles before the diagonal and the GQA group loop (heads outer) stay:
//    the group's float32 sum is taken inside the block.
//  * dq_f32_kernel, dK/dV's mirror: a block of 256 threads owns 64 q rows of
//    one (b, h), with Q, dO and their lse, delta, glse and segment ids
//    staged once, and walks K/V tiles of 64 keys (of kv head h / (H / Hk))
//    double-buffered by cp.async up to the causal end, causal q tiles
//    heaviest first.  A thread holds 4 q rows x 4 keys of S and of dP (both
//    products in one loop over D), runs the element step on them in
//    registers (a branch-free path for unmasked tiles without dropout or
//    glse), and keeps its 4 rows' 8 dims (D 128) of dQ in registers for the
//    whole walk, written once.  dS goes through its own shared [q][key]
//    buffer (pitch 64 + 8: a warp's 4 rows x 8 keys on 32 banks) as the A
//    operand of dQ += dS K; with 222,720 bytes at D 128 it fits beside the
//    K/V stages, so no barrier waits for the V stage to free.  Two barriers
//    a tile.  F = 0.5 in the S/dP loop, 0.375 in dS K (cap 0.55).
// The tiles were chosen by `flash_probe.py f32` (CUDA-graph ms at the LM's
// shape, B 1, T 8192, H 16, D 128, causal, on an H100 80GB HBM3 at 700 W;
// PERF.md section 6): forward 7.74 ms against 8.11 with 8-lane row groups
// (4 x 8 of S, 4 x 16 of O) and 8.41 with 4-row threads (64-row blocks);
// dK/dV 15.29 ms against 18.13 with 32-row Q/dO tiles and 23.32 with
// 32-key blocks; dQ 11.65 ms against 12.50 with 128-row blocks over 32-key
// tiles (8 x 2 of S and dP a thread), 12.71 with 8 key groups (128-row
// blocks over 32-key tiles, 4 x 4) and 14.11 with 32-key tiles (4 x 2); two
// blocks of 128 threads an SM (one stage, the largest carveout) gained
// nothing (7.79, 15.32; dQ 12.09).  The product loops are unrolled eight
// times: in turns (`flash_probe.py f32-turns`) dQ 11.65 against 11.76 ms
// unrolled four times, dK/dV 15.15 against 15.29, the forward the same
// (7.74).  ptxas: 254 (forward), 252 (dK/dV) and 168 (dQ) registers at
// D 128, no spills.
//
// Plain C entry points (bound from Python with ctypes, no PyTorch headers):
// the caller fills `Args`, allocates the outputs, passes its stream and
// device, and raises if the returned cudaError_t is not 0.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Mirrors chainermn_tpu_torch/ops/flash_attention.py `_Args`: every field
// 8 bytes.  Strides are in elements; pointers not used by a kernel are null.
// Outside the unnamed namespace: the extern "C" entry points take it, and
// a type with internal linkage would hide them from the library's symbols.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO, [B, Tq, H, D]
  const float* lse_in;  // [B, H, Tq]
  const float* delta;   // rowsum(dO * O), [B, H, Tq]
  const float* glse;    // lse cotangent [B, H, Tq] or null
  const int* qseg;      // [B, Tq] or null
  const int* kseg;      // [B, Tk]
  const int* offs;      // [B, 2] (q, kv) global offsets or null
  void* out;            // [B, Tq, H, D], contiguous
  float* lse;           // [B, H, Tq]
  void* dq;             // [B, Tq, H, D], contiguous
  void* dk;             // [B, Tk, Hk, D], contiguous
  void* dv;
  int64_t B, Tq, Tk, H, Hk;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  int64_t causal, seed, thresh, dropout;
  double scale, inv_keep;
};

namespace {

// dtype codes shared with ops/flash_attention.py
enum Code { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLseSentinel = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// JAX's _keep_mask: murmur3-finalizer rounds over uint32.
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, uint32_t qp,
                                     uint32_t kp, uint32_t thresh) {
  uint32_t x = qp * 0x9E3779B1u ^ kp * 0x85EBCA77u ^ bh * 0xC2B2AE35u ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// Shared-memory carving: every buffer starts on a 128-byte boundary.
__host__ __device__ constexpr size_t al(size_t x) {
  return (x + 127) / 128 * 128;
}

struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += al(n * sizeof(U));
    return r;
  }
};

// v summed over the tpr lanes (a power of two) of its row group in a warp
__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int o = tpr / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core kernels
// ---------------------------------------------------------------------------
//
// Four warps a block; each warp owns 16 rows of the block's 64-row output
// tile (q rows forward and for dQ, keys for dK/dV) and keeps its scores, its
// probabilities and its output accumulators in registers, in the layout of
// mma.sync.m16n8k16's C fragment: lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8, columns 8 n + 2 t and 8 n + 2 t + 1 of each 8-column
// tile n.  That is also the A fragment of the next product once pairs are
// packed to bf16/fp16, so P (dS) never leaves the registers.  Operands come
// from shared memory through ldmatrix (.trans for the K-major ones); the
// next K/V (Q/dO) tile is copied in with cp.async while this one is used.
// Tile rows are padded by 16 bytes so that ldmatrix's eight row addresses
// fall into different banks.

constexpr int kTcThreads = 128;
constexpr int kTcRows = 64;    // output rows of a block (16 a warp)
constexpr int kTcCols = 64;    // the other axis' tile: keys fwd/dQ
constexpr int kTcQRows = 32;   // q rows a dK/dV step takes

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

// 16 bytes (or `bytes` < 16 and the rest zero) from global to shared memory,
// asynchronously; 0 bytes read means a zero-filled destination.
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* s, const void* g, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a * b for one 16x8x16 tile; `pack` rounds two floats (the lower
// column first) into one register of the 16-bit type.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// ROWS rows of D elements (row r at src + r * stride) into dst (pitch
// D + 8), asynchronously; rows at or past `valid` (>= 1) are zero-filled.
template <typename T, int D, int ROWS>
__device__ void async_rows(T* dst, const T* src, int64_t stride, int valid) {
  constexpr int V = 8, CPR = D / V, LD = D + 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * V;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r * stride + c : 0), ok);
  }
}

// n entries of a row vector (4 bytes each), 0 past `valid` (>= 1).
template <typename U>
__device__ void async_vec(U* dst, const U* src, int valid, int n) {
  for (int i = threadIdx.x; i < n; i += kTcThreads)
    cp_async4(dst + i, src + (i < valid ? i : 0), i < valid);
}

// A fragment (16 rows x 16 k) of a row-major [rows][D + 8] tile: rows
// r0..r0+15, k columns k0..k0+15.
template <int LD, typename T>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const T* tile,
                                       int r0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles n0, n0+8 for k columns k0..k0+15, from
// a tile stored [n][k] (B = tile^T: keys x d for S = Q K^T): r[0..1] for
// n0, r[2..3] for n0 + 8.
template <int LD, typename T>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const T* tile,
                                       int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (B = tile: V for P V), transposed.
template <int LD, typename T>
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4], const T* tile,
                                         int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 +
                   (lane >> 4) * 8);
}

// The A fragment of k columns 16 kc..16 kc+15 from a C-layout accumulator
// (two 8-column tiles), rounded to T.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kc) {
  a[0] = Mma<T>::pack(c[2 * kc][0], c[2 * kc][1]);
  a[1] = Mma<T>::pack(c[2 * kc][2], c[2 * kc][3]);
  a[2] = Mma<T>::pack(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = Mma<T>::pack(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// 2**x, one MUFU instruction (what __expf(x) computes for 2**(x log2 e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Number of leading tiles of `tile` rows along T that are not fully masked
// by causality for a q tile whose last global position is q_last: tile j
// is needed while its first position goff + j * tile <= q_last.
__device__ __forceinline__ int causal_tiles(int q_last, int goff, int tile,
                                            int n) {
  int j = 0;
  while (j < n && q_last >= goff + j * tile) ++j;
  return j;
}

template <typename T, int D>
struct TcSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t tile(int rows) { return al(rows * LD * sizeof(T)); }
  static constexpr size_t vec(int n) { return al(n * 4); }
  static constexpr size_t fwd = tile(kTcRows) + 4 * tile(kTcCols) +
                                vec(kTcRows) + 2 * vec(kTcCols);
  static constexpr size_t dq = 2 * tile(kTcRows) + 4 * tile(kTcCols) +
                               4 * vec(kTcRows) + 2 * vec(kTcCols);
  static constexpr size_t dkv = 2 * tile(kTcRows) + 4 * tile(kTcQRows) +
                                8 * vec(kTcQRows) + vec(kTcRows);
};

// The positions, sizes and offsets of one block, in int (sequence lengths
// and global positions stay below 2**31).
struct TcPos {
  int Tq, Tk, goff_q, goff_k;
  __device__ TcPos(const Args& p, int64_t b)
      : Tq(static_cast<int>(p.Tq)), Tk(static_cast<int>(p.Tk)),
        goff_q(p.offs ? p.offs[2 * b] : 0),
        goff_k(p.offs ? p.offs[2 * b + 1] : 0) {}
};

// Causal q tiles are visited last-first: the tiles with the most keys to
// walk start first, so the short ones fill the tail of the grid.
__device__ __forceinline__ int64_t heavy_first(const Args& p, int tiles) {
  return p.causal ? tiles - 1 - blockIdx.x : blockIdx.x;
}

// ---------------------------------------------------------------------------
// float32 forward, dK/dV and dQ: register-blocked CUDA-core kernels
// ---------------------------------------------------------------------------

// Their tiles (the header says why).  fwd_f32_kernel: kF32FwdThreads
// threads as row groups of kF32FwdLanes lanes; a thread owns kF32FwdRows q
// rows, kF32FwdKeys keys of each K/V tile of S, and its rows' D /
// kF32FwdLanes output dims; kF32FwdStages K/V stages.  dkv_f32_kernel:
// kF32DkvThreads / 16 key groups x 16 q groups; a thread owns kF32DkvKeys
// of the block's keys, kF32DkvRows rows of each Q/dO tile of S^T and dP^T,
// and its keys' D / 16 dims of dK and of dV; kF32DkvStages Q/dO stages.
// dq_f32_kernel: kF32DqThreads / kF32DqKeyGroups q groups x kF32DqKeyGroups
// key groups; a thread owns kF32DqRows of the block's q rows, kF32DqKeys
// keys of each K/V tile of S and dP, and its rows' D / kF32DqKeyGroups dims
// of dQ; kF32DqStages K/V stages.
constexpr int kF32FwdThreads = 256;
constexpr int kF32FwdLanes = 16;
constexpr int kF32FwdRows = 8;
constexpr int kF32FwdKeys = 4;
constexpr int kF32FwdStages = 2;
constexpr int kF32DkvThreads = 256;
constexpr int kF32DkvKeys = 4;
constexpr int kF32DkvRows = 4;
constexpr int kF32DkvStages = 2;
constexpr int kF32DqThreads = 256;
constexpr int kF32DqKeyGroups = 16;
constexpr int kF32DqRows = 4;
constexpr int kF32DqKeys = 4;
constexpr int kF32DqStages = 2;
constexpr int kF32Pad = 4;  // floats past D in a staged Q, K, V or dO row

template <int D>
struct F32Fwd {
  static constexpr int NT = kF32FwdThreads, NS = kF32FwdStages;
  static constexpr int TX = kF32FwdLanes, TY = NT / TX;
  static constexpr int RM = kF32FwdRows, CN = kF32FwdKeys;
  static constexpr int BQ = TY * RM;   // q rows of a block
  static constexpr int BK = TX * CN;   // keys of a K/V tile
  static constexpr int LDT = D + kF32Pad;
  static constexpr int LDP = BK + TX;  // a warp's P rows on distinct banks
  static constexpr int DN = D / TX;    // output dims of a thread, read and
  static constexpr int VW = DN < 4 ? DN : 4;  // written VW at a time
  // floats of one K stage (the K tile, then P [BQ][LDP] over it) and of one
  // V stage; NS stages of each
  static constexpr int KST = static_cast<int>(
      al(4 * (BK * LDT > BQ * LDP ? BK * LDT : BQ * LDP)) / 4);
  static constexpr int VST = static_cast<int>(al(4 * BK * LDT) / 4);
  static constexpr size_t bytes = al(4 * BQ * LDT) + 4 * NS * size_t(KST) +
                                  4 * NS * size_t(VST) + al(4 * BQ) +
                                  al(4 * NS * BK);
  static_assert(D % TX == 0 && 32 % TX == 0 && RM * CN <= 32 && BK % 4 == 0,
                "tiles");
};

template <int D>
struct F32Dkv {
  static constexpr int NT = kF32DkvThreads, NS = kF32DkvStages;
  static constexpr int TQ = 16;          // q groups
  static constexpr int TK = NT / TQ;     // key groups
  static constexpr int RK = kF32DkvKeys, CQ = kF32DkvRows;
  static constexpr int BK = TK * RK;     // keys of a block
  static constexpr int BQ = TQ * CQ;     // q rows of a Q/dO tile
  static constexpr int LDT = D + kF32Pad;
  static constexpr int LDP = BQ + 8;     // P_drop^T, then dS^T: [key][q]
  static constexpr int DN = D / TQ;      // dK, dV dims of a thread
  static constexpr int VW = DN < 4 ? DN : 4;
  static constexpr int QST = static_cast<int>(al(4 * BQ * LDT) / 4);
  // K, V; NS stages of Q and of dO; P^T; NS stages of lse, delta, glse and
  // the q segment ids; the key segment ids
  static constexpr size_t bytes = 2 * al(4 * BK * LDT) +
                                  8 * NS * size_t(QST) + al(4 * BK * LDP) +
                                  4 * al(4 * NS * BQ) + al(4 * BK);
  static_assert(D % TQ == 0 && BQ % 4 == 0 && TK % 4 == 0, "tiles");
};

template <int D>
struct F32Dq {
  static constexpr int NT = kF32DqThreads, NS = kF32DqStages;
  static constexpr int TK = kF32DqKeyGroups;  // key groups
  static constexpr int TQ = NT / TK;     // q groups
  static constexpr int RQ = kF32DqRows, CK = kF32DqKeys;
  static constexpr int BQ = TQ * RQ;     // q rows of a block
  static constexpr int BK = TK * CK;     // keys of a K/V tile
  static constexpr int LDT = D + kF32Pad;
  static constexpr int LDP = BK + 8;     // dS: [q][key]
  static constexpr int DN = D / TK;      // dQ dims of a thread
  static constexpr int VW = DN < 4 ? DN : 4;
  static constexpr int KST = static_cast<int>(al(4 * BK * LDT) / 4);
  // Q, dO; NS stages of K and of V; dS; lse, delta, glse and the q segment
  // ids; NS stages of the key segment ids
  static constexpr size_t bytes = 2 * al(4 * BQ * LDT) +
                                  8 * NS * size_t(KST) + al(4 * BQ * LDP) +
                                  4 * al(4 * BQ) + al(4 * NS * BK);
  static_assert(D % TK == 0 && BK % 4 == 0 && TK % 8 == 0 &&
                    (NT / 32) % (TK / 8) == 0,
                "tiles");
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c + a . b, in the order x, y, z, w
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

__device__ __forceinline__ float part(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// W (1, 2 or 4) consecutive floats from or to p, aligned to W floats
template <int W>
__device__ __forceinline__ void ld_vec(float (&r)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 v = lds4(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* p, const float (&r)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else if constexpr (W == 2)
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  else
    *p = r[0];
}

// ROWS rows of D floats (row r at src + r * stride) into dst (pitch LD),
// asynchronously in 16-byte pieces; rows at or past `valid` (>= 1) are
// zero-filled.
template <int NT, int D, int ROWS, int LD>
__device__ void f32_rows(float* dst, const float* src, int64_t stride,
                         int valid) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r * stride + c : 0), ok);
  }
}

// n entries of a row vector (4 bytes each), asynchronously; 0 past `valid`
template <int NT, typename U>
__device__ void f32_vec(U* dst, const U* src, int valid, int n) {
  for (int i = threadIdx.x; i < n; i += NT)
    cp_async4(dst + i, src + (i < valid ? i : 0), i < valid);
}

// acc[R][C] += A B^T over D, 128-bit reads along D: A's row i at a + i * AS,
// B's row j at b + j * BS, in shared memory.
template <int R, int C, int D, int AS, int BS>
__device__ __forceinline__ void f32_abt(float (&acc)[R][C], const float* a,
                                        const float* b) {
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = lds4(a + i * AS + d);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float4 bv = lds4(b + j * BS + d);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][j] = dot4(av[i], bv, acc[i][j]);
    }
  }
}

// x[R][C] += A B^T and y[R][C] += E F^T in one loop over D (twice the
// independent sums in flight): A's, E's row i at a, e + i * AS; B's, F's
// row j at b, f + j * BS.
template <int R, int C, int D, int AS, int BS>
__device__ __forceinline__ void f32_abt2(float (&x)[R][C], float (&y)[R][C],
                                         const float* a, const float* e,
                                         const float* b, const float* f) {
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[R], ev[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = lds4(a + i * AS + d), ev[i] = lds4(e + i * AS + d);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float4 bv = lds4(b + j * BS + d), fv = lds4(f + j * BS + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
        x[i][j] = dot4(av[i], bv, x[i][j]), y[i][j] = dot4(ev[i], fv, y[i][j]);
    }
  }
}

// acc[R][N] += A B over K: A(i, k) at a[i * AS + k], read 128 bits at a time
// along K; the thread's N columns of B's row k, W at a time, at b + k * LDB
// + n * NS (n < N / W).
template <int R, int N, int W, int K, int AS, int LDB, int NS>
__device__ __forceinline__ void f32_ab(float (&acc)[R][N], const float* a,
                                       const float* b) {
#pragma unroll 8
  for (int k = 0; k < K; k += 4) {
    float4 av[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = lds4(a + i * AS + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < N / W; ++n) {
        float bv[W];
        ld_vec<W>(bv, b + (k + kk) * LDB + n * NS);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[i][n * W + e] =
                fmaf(part(av[i], kk), bv[e], acc[i][n * W + e]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::NT, kThreads / F32Fwd<D>::NT)
    fwd_f32_kernel(const Args p) {
  using L = F32Fwd<D>;
  constexpr int NT = L::NT, NS = L::NS;
  constexpr int TX = L::TX, TY = L::TY, RM = L::RM, CN = L::CN;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDP = L::LDP;
  constexpr int DN = L::DN, VW = L::VW;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(BQ * LDT);
  float* Ks = cv.take<float>(NS * L::KST);
  float* Vs = cv.take<float>(NS * L::VST);
  int* qseg_s = cv.take<int>(BQ);
  int* kseg_s = cv.take<int>(NS * BK);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, P.Tk - k0);
    f32_rows<NT, D, BK, LDT>(Ks + buf * L::KST, kb + k0 * p.k_st, p.k_st,
                             k_valid);
    f32_rows<NT, D, BK, LDT>(Vs + buf * L::VST, vb + k0 * p.v_st, p.v_st,
                             k_valid);
    if (has_seg)
      f32_vec<NT>(kseg_s + buf * BK, p.kseg + b * P.Tk + k0, k_valid, BK);
  };
  f32_rows<NT, D, BQ, LDT>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                                   h * p.q_sh + q0 * p.q_st,
                           p.q_st, q_valid);
  if (has_seg) f32_vec<NT>(qseg_s, p.qseg + b * P.Tq + q0, q_valid, BQ);
  if (kt_end > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // row group ty (TX lanes of one warp), lane tx in it: rows ty + TY i,
  // keys tx + TX j of a tile, output dims VW tx + TX VW n + e
  const int lane = threadIdx.x % 32;
  const int tx = lane % TX, ty = threadIdx.x / 32 * (32 / TX) + lane / TX;
  const int qpos0 = P.goff_q + q0 + ty;  // row i at global qpos0 + TY i
  float o[RM][DN] = {};
  float m[RM], l[RM], alpha[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) m[i] = kNegInf, l[i] = 0.0f;

  // online softmax of S's tile at k0 in registers: scale, mask, the running
  // max over the row group's lanes (every row's shuffles at once), the
  // lane's share of the denominator (summed over the lanes at the end), then
  // dropout; S becomes P.  A tile no mask touches takes the branch-free path.
  auto softmax = [&](float (&s)[RM][CN], int k0, const int* ks) {
    const bool full = !has_seg && k0 + BK <= P.Tk &&
                      (!p.causal || P.goff_k + k0 + BK - 1 <= P.goff_q + q0);
    uint32_t allow = ~0u;  // bit i CN + j: element (i, j) is not masked
    float mx[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) mx[i] = kNegInf;
    if (full) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] *= scale;
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int c = tx + TX * j;
          bool ok = k0 + c < P.Tk;
          if (p.causal) ok = ok && qpos0 + TY * i >= P.goff_k + k0 + c;
          if (has_seg) ok = ok && qseg_s[ty + TY * i] == ks[c];
          if (!ok) allow &= ~(1u << (i * CN + j));
          s[i][j] = ok ? s[i][j] * scale : kNegInf;
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
    }
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RM; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float pj = expf(s[i][j] - mn);
        if (!full && !((allow >> (i * CN + j)) & 1u)) pj = 0.0f;
        sum += pj;
        s[i][j] = pj;
      }
      l[i] = l[i] * alpha[i] + sum;
    }
    if (p.dropout)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          s[i][j] = keep(static_cast<uint32_t>(p.seed),
                         static_cast<uint32_t>(bh),
                         static_cast<uint32_t>(qpos0 + TY * i),
                         static_cast<uint32_t>(P.goff_k + k0 + tx + TX * j),
                         static_cast<uint32_t>(p.thresh))
                        ? s[i][j] * inv_keep
                        : 0.0f;
  };

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = NS == 2 ? kt & 1 : 0;
    if (NS == 2 && kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    float* K = Ks + buf * L::KST;
    const float* V = Vs + buf * L::VST;
    float s[RM][CN] = {};
    f32_abt<RM, CN, D, TY * LDT, TX * LDT>(s, Qs + ty * LDT, K + tx * LDT);
    softmax(s, kt * BK, kseg_s + buf * BK);
    __syncthreads();  // every warp is done with this K tile: P goes there
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        K[(ty + TY * i) * LDP + tx + TX * j] = s[i][j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int n = 0; n < DN; ++n) o[i][n] *= alpha[i];
    __syncthreads();
    f32_ab<RM, DN, VW, BK, TY * LDP, LDT, TX * VW>(o, K + ty * LDP,
                                                   V + VW * tx);
    if (NS == 1 && kt + 1 < kt_end) {  // one stage: the next tile now
      __syncthreads();
      load_kv(kt + 1, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) l[i] = row_sum(l[i], TX);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= P.Tq) continue;
    const bool empty = l[i] == 0.0f;
    const float denom = empty ? 1.0f : l[i];
    float* orow = static_cast<float*>(p.out) + ((b * P.Tq + qi) * H + h) * D +
                  VW * tx;
#pragma unroll
    for (int n = 0; n < DN / VW; ++n) {
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = o[i][n * VW + e] / denom;
      st_vec<VW>(orow + TX * VW * n, v);
    }
    if (tx == 0)
      p.lse[bh * P.Tq + qi] = empty ? kLseSentinel : m[i] + logf(denom);
  }
}

template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::NT, kThreads / F32Dkv<D>::NT)
    dkv_f32_kernel(const Args p) {
  using L = F32Dkv<D>;
  constexpr int NT = L::NT, NS = L::NS, TK = L::TK, TQ = L::TQ;
  constexpr int RK = L::RK, CQ = L::CQ, BK = L::BK, BQ = L::BQ;
  constexpr int LDT = L::LDT, LDP = L::LDP, DN = L::DN, VW = L::VW;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Ks = cv.take<float>(BK * LDT);
  float* Vs = cv.take<float>(BK * LDT);
  float* Qs = cv.take<float>(NS * L::QST);
  float* Gs = cv.take<float>(NS * L::QST);
  float* Pt = cv.take<float>(BK * LDP);
  float* lse_s = cv.take<float>(NS * BQ);
  float* delta_s = cv.take<float>(NS * BQ);
  float* glse_s = cv.take<float>(NS * BQ);
  int* qseg_s = cv.take<int>(NS * BQ);
  int* kseg_s = cv.take<int>(BK);

  const int64_t H = p.H, Hk = p.Hk;
  const int64_t grp = H / Hk;
  const int64_t bhk = blockIdx.y, b = bhk / Hk, hk = bhk % Hk;
  const TcPos P(p, b);
  const int k0 = blockIdx.x * BK;
  const bool has_seg = p.qseg != nullptr;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const int k_valid = min(BK, P.Tk - k0);
  const int n_qt = (P.Tq + BQ - 1) / BQ;
  // causal: q tiles whose last row does not see key k0 are skipped
  int qt0 = 0;
  if (p.causal)
    while (qt0 < n_qt &&
           P.goff_q + min((qt0 + 1) * BQ, P.Tq) - 1 < P.goff_k + k0)
      ++qt0;
  const int nq = n_qt - qt0;
  const int total = static_cast<int>(grp) * nq;  // the group's heads outer

  auto load_q = [&](int it, int buf) {
    const int64_t h = hk * grp + it / nq, bhq = b * H + h;
    const int q0 = (qt0 + it % nq) * BQ;
    const int q_valid = min(BQ, P.Tq - q0);
    f32_rows<NT, D, BQ, LDT>(Qs + buf * L::QST,
                             static_cast<const float*>(p.q) + b * p.q_sb +
                                 h * p.q_sh + q0 * p.q_st,
                             p.q_st, q_valid);
    f32_rows<NT, D, BQ, LDT>(Gs + buf * L::QST,
                             static_cast<const float*>(p.g) + b * p.g_sb +
                                 h * p.g_sh + q0 * p.g_st,
                             p.g_st, q_valid);
    f32_vec<NT>(lse_s + buf * BQ, p.lse_in + bhq * P.Tq + q0, q_valid, BQ);
    f32_vec<NT>(delta_s + buf * BQ, p.delta + bhq * P.Tq + q0, q_valid, BQ);
    if (p.glse)
      f32_vec<NT>(glse_s + buf * BQ, p.glse + bhq * P.Tq + q0, q_valid, BQ);
    if (has_seg)
      f32_vec<NT>(qseg_s + buf * BQ, p.qseg + b * P.Tq + q0, q_valid, BQ);
  };
  f32_rows<NT, D, BK, LDT>(Ks, static_cast<const float*>(p.k) + b * p.k_sb +
                                   hk * p.k_sh + k0 * p.k_st,
                           p.k_st, k_valid);
  f32_rows<NT, D, BK, LDT>(Vs, static_cast<const float*>(p.v) + b * p.v_sb +
                                   hk * p.v_sh + k0 * p.v_st,
                           p.v_st, k_valid);
  if (has_seg) f32_vec<NT>(kseg_s, p.kseg + b * P.Tk + k0, k_valid, BK);
  if (total > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // key group ky, q group qx (a warp: 4 key groups x 8 q groups): keys
  // ky + TK i, q rows qx + TQ j of a tile, dK/dV dims VW qx + TQ VW n + e
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ky = warp / 2 * 4 + lane / 8, qx = warp % 2 * 8 + lane % 8;
  const int kpos0 = P.goff_k + k0 + ky;  // key i at global kpos0 + TK i
  float dk[RK][DN] = {}, dv[RK][DN] = {};

  // the element step of S^T and dP^T of the q tile at q0, in registers:
  // a = exp(s scale - lse) (0 where masked), dropout, ds = a (da - delta)
  // scale (+ a glse scale); S^T becomes P_drop^T and dP^T becomes dS^T.
  auto element = [&](float (&st)[RK][CQ], float (&dpt)[RK][CQ], int q0,
                     int64_t bhq, int buf) {
    const bool full = !has_seg && k0 + BK <= P.Tk && q0 + BQ <= P.Tq &&
                      (!p.causal || P.goff_q + q0 >= P.goff_k + k0 + BK - 1);
    if (full && !p.dropout && !p.glse) {  // the branch-free common case
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const float lse = lse_s[buf * BQ + qx + TQ * j];
        const float delta = delta_s[buf * BQ + qx + TQ * j];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float a = expf(st[i][j] * scale - lse);
          st[i][j] = a;
          dpt[i][j] = a * (dpt[i][j] - delta) * scale;
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < CQ; ++j) {
      const int r = qx + TQ * j;
      const int qpos = P.goff_q + q0 + r;
      const bool row_ok = q0 + r < P.Tq;
      const float lse = lse_s[buf * BQ + r], delta = delta_s[buf * BQ + r];
      const float gl = p.glse ? glse_s[buf * BQ + r] : 0.0f;
      const int qsg = has_seg ? qseg_s[buf * BQ + r] : 0;
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        bool ok = true;
        if (!full) {
          ok = row_ok && k0 + ky + TK * i < P.Tk;
          if (p.causal) ok = ok && qpos >= kpos0 + TK * i;
          if (has_seg) ok = ok && qsg == kseg_s[ky + TK * i];
        }
        const float a = ok ? expf(st[i][j] * scale - lse) : 0.0f;
        float a_drop = a, da = dpt[i][j];
        if (p.dropout) {
          const bool kp = keep(static_cast<uint32_t>(p.seed),
                               static_cast<uint32_t>(bhq),
                               static_cast<uint32_t>(qpos),
                               static_cast<uint32_t>(kpos0 + TK * i),
                               static_cast<uint32_t>(p.thresh));
          a_drop = kp ? a * inv_keep : 0.0f;
          da = kp ? da * inv_keep : 0.0f;
        }
        float ds = a * (da - delta) * scale;
        if (p.glse) ds = ds + a * gl * scale;
        st[i][j] = a_drop;
        dpt[i][j] = ds;
      }
    }
  };

  for (int it = 0; it < total; ++it) {
    const int buf = NS == 2 ? it & 1 : 0;
    if (NS == 2 && it + 1 < total) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    const float* Q = Qs + buf * L::QST;
    const float* G = Gs + buf * L::QST;
    // S^T = K Q^T and dP^T = V dO^T, then the element step
    float st[RK][CQ] = {}, dpt[RK][CQ] = {};
    f32_abt2<RK, CQ, D, TK * LDT, TQ * LDT>(st, dpt, Ks + ky * LDT,
                                            Vs + ky * LDT, Q + qx * LDT,
                                            G + qx * LDT);
    element(st, dpt, (qt0 + it % nq) * BQ, b * H + hk * grp + it / nq, buf);
    // dV += P_drop^T dO, then dK += dS^T Q, each P^T through shared memory
    // (the previous step's dK product ended at the barrier that ends it)
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j)
        Pt[(ky + TK * i) * LDP + qx + TQ * j] = st[i][j];
    __syncthreads();
    f32_ab<RK, DN, VW, BQ, TK * LDP, LDT, TQ * VW>(dv, Pt + ky * LDP,
                                                   G + VW * qx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j)
        Pt[(ky + TK * i) * LDP + qx + TQ * j] = dpt[i][j];
    __syncthreads();
    f32_ab<RK, DN, VW, BQ, TK * LDP, LDT, TQ * VW>(dk, Pt + ky * LDP,
                                                   Q + VW * qx);
    if (NS == 1 && it + 1 < total) {  // one stage: the next tile now
      __syncthreads();
      load_q(it + 1, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    if (k0 + ky + TK * i >= P.Tk) continue;
    const int64_t o = ((b * P.Tk + k0 + ky + TK * i) * Hk + hk) * D + VW * qx;
#pragma unroll
    for (int n = 0; n < DN / VW; ++n) {
      float x[VW], y[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e)
        x[e] = dk[i][n * VW + e], y[e] = dv[i][n * VW + e];
      st_vec<VW>(static_cast<float*>(p.dk) + o + TQ * VW * n, x);
      st_vec<VW>(static_cast<float*>(p.dv) + o + TQ * VW * n, y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32Dq<D>::NT, kThreads / F32Dq<D>::NT)
    dq_f32_kernel(const Args p) {
  using L = F32Dq<D>;
  constexpr int NT = L::NT, NS = L::NS, TK = L::TK, TQ = L::TQ;
  constexpr int RQ = L::RQ, CK = L::CK, BQ = L::BQ, BK = L::BK;
  constexpr int LDT = L::LDT, LDP = L::LDP, DN = L::DN, VW = L::VW;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(BQ * LDT);
  float* Gs = cv.take<float>(BQ * LDT);
  float* Ks = cv.take<float>(NS * L::KST);
  float* Vs = cv.take<float>(NS * L::KST);
  float* dS = cv.take<float>(BQ * LDP);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);
  float* glse_s = cv.take<float>(BQ);
  int* qseg_s = cv.take<int>(BQ);
  int* kseg_s = cv.take<int>(NS * BK);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, P.Tk - k0);
    f32_rows<NT, D, BK, LDT>(Ks + buf * L::KST, kb + k0 * p.k_st, p.k_st,
                             k_valid);
    f32_rows<NT, D, BK, LDT>(Vs + buf * L::KST, vb + k0 * p.v_st, p.v_st,
                             k_valid);
    if (has_seg)
      f32_vec<NT>(kseg_s + buf * BK, p.kseg + b * P.Tk + k0, k_valid, BK);
  };
  f32_rows<NT, D, BQ, LDT>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                                   h * p.q_sh + q0 * p.q_st,
                           p.q_st, q_valid);
  f32_rows<NT, D, BQ, LDT>(Gs, static_cast<const float*>(p.g) + b * p.g_sb +
                                   h * p.g_sh + q0 * p.g_st,
                           p.g_st, q_valid);
  f32_vec<NT>(lse_s, p.lse_in + bh * P.Tq + q0, q_valid, BQ);
  f32_vec<NT>(delta_s, p.delta + bh * P.Tq + q0, q_valid, BQ);
  if (p.glse) f32_vec<NT>(glse_s, p.glse + bh * P.Tq + q0, q_valid, BQ);
  if (has_seg) f32_vec<NT>(qseg_s, p.qseg + b * P.Tq + q0, q_valid, BQ);
  if (kt_end > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // q group qy, key group kx (a warp: 4 q groups x 8 key groups): rows
  // qy + TQ i, keys kx + TK j of a tile, dQ dims VW kx + TK VW n + e
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qy = warp / (TK / 8) * 4 + lane / 8;
  const int kx = warp % (TK / 8) * 8 + lane % 8;
  const int qpos0 = P.goff_q + q0 + qy;  // row i at global qpos0 + TQ i
  float dq[RQ][DN] = {};

  // the element step of S and dP of the K/V tile at k0, in registers:
  // a = exp(s scale - lse) (0 where masked), dropout, ds = a (da - delta)
  // scale (+ a glse scale); dP becomes dS.
  auto element = [&](const float (&s)[RQ][CK], float (&dp)[RQ][CK], int k0,
                     int buf) {
    const bool full = !has_seg && k0 + BK <= P.Tk && q0 + BQ <= P.Tq &&
                      (!p.causal || P.goff_q + q0 >= P.goff_k + k0 + BK - 1);
    if (full && !p.dropout && !p.glse) {  // the branch-free common case
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float lse = lse_s[qy + TQ * i], delta = delta_s[qy + TQ * i];
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const float a = expf(s[i][j] * scale - lse);
          dp[i][j] = a * (dp[i][j] - delta) * scale;
        }
      }
      return;
    }
    const int kpos0 = P.goff_k + k0 + kx;  // key j at global kpos0 + TK j
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = qy + TQ * i;
      const int qpos = qpos0 + TQ * i;
      const bool row_ok = q0 + r < P.Tq;
      const float lse = lse_s[r], delta = delta_s[r];
      const float gl = p.glse ? glse_s[r] : 0.0f;
      const int qsg = has_seg ? qseg_s[r] : 0;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        bool ok = true;
        if (!full) {
          ok = row_ok && k0 + kx + TK * j < P.Tk;
          if (p.causal) ok = ok && qpos >= kpos0 + TK * j;
          if (has_seg) ok = ok && qsg == kseg_s[buf * BK + kx + TK * j];
        }
        const float a = ok ? expf(s[i][j] * scale - lse) : 0.0f;
        float da = dp[i][j];
        if (p.dropout)
          da = keep(static_cast<uint32_t>(p.seed), static_cast<uint32_t>(bh),
                    static_cast<uint32_t>(qpos),
                    static_cast<uint32_t>(kpos0 + TK * j),
                    static_cast<uint32_t>(p.thresh))
                   ? da * inv_keep
                   : 0.0f;
        float ds = a * (da - delta) * scale;
        if (p.glse) ds = ds + a * gl * scale;
        dp[i][j] = ds;
      }
    }
  };

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = NS == 2 ? kt & 1 : 0;
    if (NS == 2 && kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    const float* K = Ks + buf * L::KST;
    const float* V = Vs + buf * L::KST;
    // S = Q K^T and dP = dO V^T, then the element step
    float s[RQ][CK] = {}, dp[RQ][CK] = {};
    f32_abt2<RQ, CK, D, TQ * LDT, TK * LDT>(s, dp, Qs + qy * LDT,
                                            Gs + qy * LDT, K + kx * LDT,
                                            V + kx * LDT);
    element(s, dp, kt * BK, buf);
    // dQ += dS K, dS through shared memory (the previous tile's product
    // ended at the barrier that ends it)
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j)
        dS[(qy + TQ * i) * LDP + kx + TK * j] = dp[i][j];
    __syncthreads();
    f32_ab<RQ, DN, VW, BK, TQ * LDP, LDT, TK * VW>(dq, dS + qy * LDP,
                                                   K + VW * kx);
    if (NS == 1 && kt + 1 < kt_end) {  // one stage: the next tile now
      __syncthreads();
      load_kv(kt + 1, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + qy + TQ * i;
    if (qi >= P.Tq) continue;
    float* row = static_cast<float*>(p.dq) + ((b * P.Tq + qi) * H + h) * D +
                 VW * kx;
#pragma unroll
    for (int n = 0; n < DN / VW; ++n) {
      float x[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) x[e] = dq[i][n * VW + e];
      st_vec<VW>(row + TK * VW * n, x);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) fwd_tc_kernel(const Args p) {
  constexpr int BQ = kTcRows, BK = kTcCols, LD = D + 8;
  static_assert(D <= 32, "head dims 64 and 128 take fwd_wgmma_kernel");
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BQ * LD);
  T* Ks = cv.take<T>(2 * BK * LD);
  T* Vs = cv.take<T>(2 * BK * LD);
  int* qseg_s = cv.take<int>(BQ);
  int* kseg_s = cv.take<int>(2 * BK);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, P.Tk - k0);
    async_rows<T, D, BK>(Ks + buf * BK * LD, kb + k0 * p.k_st, p.k_st,
                         k_valid);
    async_rows<T, D, BK>(Vs + buf * BK * LD, vb + k0 * p.v_st, p.v_st,
                         k_valid);
    if (has_seg) async_vec(kseg_s + buf * BK, p.kseg + b * P.Tk + k0,
                           k_valid, BK);
  };
  async_rows<T, D, BQ>(Qs, static_cast<const T*>(p.q) + b * p.q_sb +
                               h * p.q_sh + q0 * p.q_st,
                       p.q_st, q_valid);
  if (has_seg) async_vec(qseg_s, p.qseg + b * P.Tq + q0, q_valid, BQ);
  if (kt_end > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[D / 16][4];  // this warp's Q rows stay in registers
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) frag_a<LD>(qf[kc], Qs, warp * 16, kc * 16);
  const int qpos0 = P.goff_q + q0 + warp * 16;  // the warp's first row
  int qpos[2], qs[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    qpos[ri] = qpos0 + g + 8 * ri;
    qs[ri] = has_seg ? qseg_s[warp * 16 + g + 8 * ri] : 0;
  }
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    const T* K = Ks + buf * BK * LD;
    const T* V = Vs + buf * BK * LD;
    const int* ks = kseg_s + buf * BK;
    const int k0 = kt * BK;

    float s[BK / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t r[4];
        frag_b<LD>(r, K, nt * 8, kc * 16);
        Mma<T>::run(s[nt], qf[kc], r[0], r[1]);
        Mma<T>::run(s[nt + 1], qf[kc], r[2], r[3]);
      }
    // online softmax: scale, mask, running max and denominator.  A tile
    // that no mask touches for any of the warp's rows skips the masks.
    const bool full = !has_seg && k0 + BK <= P.Tk &&
                      (!p.causal || P.goff_k + k0 + BK - 1 <= qpos0);
    uint32_t allow = ~0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
        bool ok = true;
        if (!full) {
          ok = k0 + c < P.Tk;
          if (p.causal) ok = ok && qpos[ri] >= P.goff_k + k0 + c;
          if (has_seg) ok = ok && qs[ri] == ks[c];
          if (!ok) allow &= ~(1u << (nt * 4 + j));
        }
        const float v = ok ? s[nt][j] * scale : kNegInf;
        s[nt][j] = v;
        mx[ri] = fmaxf(mx[ri], v);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float mn = fmaxf(m[ri], quad_max(mx[ri]));
      alpha[ri] = __expf(m[ri] - mn);
      m[ri] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = j >> 1;
        float pj = __expf(s[nt][j] - m[ri]);
        if (!full && !((allow >> (nt * 4 + j)) & 1u)) pj = 0.0f;
        sum[ri] += pj;
        if (p.dropout)
          pj = keep(static_cast<uint32_t>(p.seed), static_cast<uint32_t>(bh),
                    static_cast<uint32_t>(qpos[ri]),
                    static_cast<uint32_t>(P.goff_k + k0 + nt * 8 + 2 * t +
                                          (j & 1)),
                    static_cast<uint32_t>(p.thresh))
                   ? pj * inv_keep
                   : 0.0f;
        s[nt][j] = pj;
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) l[ri] = l[ri] * alpha[ri] + quad_sum(sum[ri]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    // O += P V, P from the registers, rounded to v's type
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a<T>(a, s, kc);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t r[4];
        frag_b_t<LD>(r, V, nd * 8, kc * 16);
        Mma<T>::run(o[nd], a, r[0], r[1]);
        Mma<T>::run(o[nd + 1], a, r[2], r[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int64_t qi = q0 + warp * 16 + g + 8 * ri;
    if (qi >= P.Tq) continue;
    const bool empty = l[ri] == 0.0f;
    const float denom = empty ? 1.0f : l[ri];
    T* orow = static_cast<T*>(p.out) + ((b * P.Tq + qi) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) = Mma<T>::pack(
          o[nd][2 * ri] / denom, o[nd][2 * ri + 1] / denom);
    if (t == 0)
      p.lse[bh * P.Tq + qi] = empty ? kLseSentinel : m[ri] + logf(denom);
  }
}

// From the scores s and dP of one (row, column) element: a = exp(s scale -
// lse) (0 where masked), dropout, ds = a (da - delta) scale (+ a glse
// scale).  Returns ds; `a_drop` gets the dropped a.
__device__ __forceinline__ float grad_elem(const Args& p, bool ok, float s,
                                           float dp, float lse, float delta,
                                           float gl, uint32_t bh, int qpos,
                                           int kpos, float& a_drop) {
  const float scale = static_cast<float>(p.scale);
  const float a = ok ? __expf(s * scale - lse) : 0.0f;
  float da = dp;
  a_drop = a;
  if (p.dropout) {
    const float inv = static_cast<float>(p.inv_keep);
    const bool kp = keep(static_cast<uint32_t>(p.seed), bh,
                         static_cast<uint32_t>(qpos),
                         static_cast<uint32_t>(kpos),
                         static_cast<uint32_t>(p.thresh));
    a_drop = kp ? a * inv : 0.0f;
    da = kp ? dp * inv : 0.0f;
  }
  float ds = a * (da - delta) * scale;
  if (p.glse) ds = ds + a * gl * scale;
  return ds;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) dq_tc_kernel(const Args p) {
  constexpr int BQ = kTcRows, BK = kTcCols, LD = D + 8;
  static_assert(D <= 32, "head dims 64 and 128 take dq_wgmma_kernel");
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BQ * LD);
  T* Gs = cv.take<T>(BQ * LD);
  T* Ks = cv.take<T>(2 * BK * LD);
  T* Vs = cv.take<T>(2 * BK * LD);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);
  float* glse_s = cv.take<float>(BQ);
  int* qseg_s = cv.take<int>(BQ);
  int* kseg_s = cv.take<int>(2 * BK);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, P.Tk - k0);
    async_rows<T, D, BK>(Ks + buf * BK * LD, kb + k0 * p.k_st, p.k_st,
                         k_valid);
    async_rows<T, D, BK>(Vs + buf * BK * LD, vb + k0 * p.v_st, p.v_st,
                         k_valid);
    if (has_seg) async_vec(kseg_s + buf * BK, p.kseg + b * P.Tk + k0,
                           k_valid, BK);
  };
  async_rows<T, D, BQ>(Qs, static_cast<const T*>(p.q) + b * p.q_sb +
                               h * p.q_sh + q0 * p.q_st,
                       p.q_st, q_valid);
  async_rows<T, D, BQ>(Gs, static_cast<const T*>(p.g) + b * p.g_sb +
                               h * p.g_sh + q0 * p.g_st,
                       p.g_st, q_valid);
  async_vec(lse_s, p.lse_in + bh * P.Tq + q0, q_valid, BQ);
  async_vec(delta_s, p.delta + bh * P.Tq + q0, q_valid, BQ);
  if (p.glse) async_vec(glse_s, p.glse + bh * P.Tq + q0, q_valid, BQ);
  if (has_seg) async_vec(qseg_s, p.qseg + b * P.Tq + q0, q_valid, BQ);
  if (kt_end > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qpos0 = P.goff_q + q0 + warp * 16;  // the warp's first row
  const bool rows_ok = q0 + warp * 16 + 16 <= P.Tq;
  int qpos[2], qs[2];
  bool row_ok[2];
  float lse[2], delta[2], gl[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = warp * 16 + g + 8 * ri;
    qpos[ri] = qpos0 + g + 8 * ri;
    row_ok[ri] = q0 + row < P.Tq;
    qs[ri] = has_seg ? qseg_s[row] : 0;
    lse[ri] = lse_s[row];
    delta[ri] = delta_s[row];
    gl[ri] = p.glse ? glse_s[row] : 0.0f;
  }
  float dq[D / 8][4] = {};

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    const T* K = Ks + buf * BK * LD;
    const T* V = Vs + buf * BK * LD;
    const int* ks = kseg_s + buf * BK;
    const int k0 = kt * BK;

    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], ga[4];
      frag_a<LD>(qa, Qs, warp * 16, kc * 16);
      frag_a<LD>(ga, Gs, warp * 16, kc * 16);
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t r[4];
        frag_b<LD>(r, K, nt * 8, kc * 16);
        Mma<T>::run(s[nt], qa, r[0], r[1]);
        Mma<T>::run(s[nt + 1], qa, r[2], r[3]);
        frag_b<LD>(r, V, nt * 8, kc * 16);
        Mma<T>::run(dp[nt], ga, r[0], r[1]);
        Mma<T>::run(dp[nt + 1], ga, r[2], r[3]);
      }
    }
    const bool full = !has_seg && rows_ok && k0 + BK <= P.Tk &&
                      (!p.causal || P.goff_k + k0 + BK - 1 <= qpos0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
        bool ok = true;
        if (!full) {
          ok = row_ok[ri] && k0 + c < P.Tk;
          if (p.causal) ok = ok && qpos[ri] >= P.goff_k + k0 + c;
          if (has_seg) ok = ok && qs[ri] == ks[c];
        }
        float unused;
        s[nt][j] = grad_elem(p, ok, s[nt][j], dp[nt][j], lse[ri], delta[ri],
                             gl[ri], static_cast<uint32_t>(bh), qpos[ri],
                             P.goff_k + k0 + c, unused);
      }
    // dQ += dS K, dS from the registers, rounded to k's type
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a<T>(a, s, kc);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t r[4];
        frag_b_t<LD>(r, K, nd * 8, kc * 16);
        Mma<T>::run(dq[nd], a, r[0], r[1]);
        Mma<T>::run(dq[nd + 1], a, r[2], r[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (!row_ok[ri]) continue;
    const int64_t qi = q0 + warp * 16 + g + 8 * ri;
    T* row = static_cast<T*>(p.dq) + ((b * P.Tq + qi) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(row + nd * 8 + 2 * t) =
          Mma<T>::pack(dq[nd][2 * ri], dq[nd][2 * ri + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) dkv_tc_kernel(const Args p) {
  constexpr int BK = kTcRows, BQ = kTcQRows, LD = D + 8;
  static_assert(D <= 32, "head dims 64 and 128 take dkv_wgmma_kernel");
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(BK * LD);
  T* Vs = cv.take<T>(BK * LD);
  T* Qs = cv.take<T>(2 * BQ * LD);
  T* Gs = cv.take<T>(2 * BQ * LD);
  float* lse_s = cv.take<float>(2 * BQ);
  float* delta_s = cv.take<float>(2 * BQ);
  float* glse_s = cv.take<float>(2 * BQ);
  int* qseg_s = cv.take<int>(2 * BQ);
  int* kseg_s = cv.take<int>(BK);

  const int64_t H = p.H, Hk = p.Hk;
  const int64_t grp = H / Hk;
  const int64_t bhk = blockIdx.y, b = bhk / Hk, hk = bhk % Hk;
  const TcPos P(p, b);
  const int k0 = blockIdx.x * BK;
  const bool has_seg = p.qseg != nullptr;
  const int k_valid = min(BK, P.Tk - k0);
  const int n_qt = (P.Tq + BQ - 1) / BQ;
  // causal: q tiles whose last row does not see key k0 are skipped
  int qt0 = 0;
  if (p.causal)
    while (qt0 < n_qt &&
           P.goff_q + min((qt0 + 1) * BQ, P.Tq) - 1 < P.goff_k + k0)
      ++qt0;
  const int nq = n_qt - qt0;
  const int total = static_cast<int>(grp) * nq;

  auto load_q = [&](int i, int buf) {
    const int64_t h = hk * grp + i / nq, bhq = b * H + h;
    const int q0 = (qt0 + i % nq) * BQ;
    const int q_valid = min(BQ, P.Tq - q0);
    async_rows<T, D, BQ>(Qs + buf * BQ * LD,
                         static_cast<const T*>(p.q) + b * p.q_sb +
                             h * p.q_sh + q0 * p.q_st,
                         p.q_st, q_valid);
    async_rows<T, D, BQ>(Gs + buf * BQ * LD,
                         static_cast<const T*>(p.g) + b * p.g_sb +
                             h * p.g_sh + q0 * p.g_st,
                         p.g_st, q_valid);
    async_vec(lse_s + buf * BQ, p.lse_in + bhq * P.Tq + q0, q_valid, BQ);
    async_vec(delta_s + buf * BQ, p.delta + bhq * P.Tq + q0, q_valid, BQ);
    if (p.glse)
      async_vec(glse_s + buf * BQ, p.glse + bhq * P.Tq + q0, q_valid, BQ);
    if (has_seg)
      async_vec(qseg_s + buf * BQ, p.qseg + b * P.Tq + q0, q_valid, BQ);
  };
  async_rows<T, D, BK>(Ks, static_cast<const T*>(p.k) + b * p.k_sb +
                               hk * p.k_sh + k0 * p.k_st,
                       p.k_st, k_valid);
  async_rows<T, D, BK>(Vs, static_cast<const T*>(p.v) + b * p.v_sb +
                               hk * p.v_sh + k0 * p.v_st,
                       p.v_st, k_valid);
  if (has_seg) async_vec(kseg_s, p.kseg + b * P.Tk + k0, k_valid, BK);
  if (total > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kpos_last = P.goff_k + k0 + warp * 16 + 15;  // the warp's last key
  const bool keys_ok = k0 + warp * 16 + 16 <= P.Tk;
  int kpos[2], ks[2];
  bool key_ok[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = warp * 16 + g + 8 * ri;
    kpos[ri] = P.goff_k + k0 + row;
    key_ok[ri] = k0 + row < P.Tk;
    ks[ri] = has_seg ? kseg_s[row] : 0;
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    if (i + 1 < total) load_q(i + 1, buf ^ 1);
    cp_async_commit();
    const int64_t bhq = b * H + hk * grp + i / nq;
    const int q0 = (qt0 + i % nq) * BQ;
    const T* Q = Qs + buf * BQ * LD;
    const T* G = Gs + buf * BQ * LD;
    const float* lse_b = lse_s + buf * BQ;
    const float* delta_b = delta_s + buf * BQ;
    const float* glse_b = glse_s + buf * BQ;
    const int* qseg_b = qseg_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, Ks, warp * 16, kc * 16);
      frag_a<LD>(va, Vs, warp * 16, kc * 16);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) {
        uint32_t r[4];
        frag_b<LD>(r, Q, nt * 8, kc * 16);
        Mma<T>::run(st[nt], ka, r[0], r[1]);
        Mma<T>::run(st[nt + 1], ka, r[2], r[3]);
        frag_b<LD>(r, G, nt * 8, kc * 16);
        Mma<T>::run(dpt[nt], va, r[0], r[1]);
        Mma<T>::run(dpt[nt + 1], va, r[2], r[3]);
      }
    }
    const bool full = !has_seg && keys_ok && q0 + BQ <= P.Tq &&
                      (!p.causal || P.goff_q + q0 >= kpos_last);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
        const int qpos = P.goff_q + q0 + c;
        bool ok = true;
        if (!full) {
          ok = key_ok[ri] && q0 + c < P.Tq;
          if (p.causal) ok = ok && qpos >= kpos[ri];
          if (has_seg) ok = ok && qseg_b[c] == ks[ri];
        }
        float a_drop;
        dpt[nt][j] = grad_elem(p, ok, st[nt][j], dpt[nt][j], lse_b[c],
                               delta_b[c], p.glse ? glse_b[c] : 0.0f,
                               static_cast<uint32_t>(bhq), qpos, kpos[ri],
                               a_drop);
        st[nt][j] = a_drop;
      }
    // dV += P_drop^T dO and dK += dS^T Q, both A operands from registers
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], sa[4];
      acc_to_a<T>(pa, st, kc);
      acc_to_a<T>(sa, dpt, kc);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t r[4];
        frag_b_t<LD>(r, G, nd * 8, kc * 16);
        Mma<T>::run(dv[nd], pa, r[0], r[1]);
        Mma<T>::run(dv[nd + 1], pa, r[2], r[3]);
        frag_b_t<LD>(r, Q, nd * 8, kc * 16);
        Mma<T>::run(dk[nd], sa, r[0], r[1]);
        Mma<T>::run(dk[nd + 1], sa, r[2], r[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (!key_ok[ri]) continue;
    const int64_t o =
        ((b * P.Tk + k0 + warp * 16 + g + 8 * ri) * Hk + hk) * D;
    T* dkr = static_cast<T*>(p.dk) + o;
    T* dvr = static_cast<T*>(p.dv) + o;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dkr + nd * 8 + 2 * t) =
          Mma<T>::pack(dk[nd][2 * ri], dk[nd][2 * ri + 1]);
      *reinterpret_cast<uint32_t*>(dvr + nd * 8 + 2 * t) =
          Mma<T>::pack(dv[nd][2 * ri], dv[nd][2 * ri + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 at head dims 64 and 128: wgmma kernels fed by TMA
// ---------------------------------------------------------------------------
//
// A block is two warpgroups of 128 threads; each owns 64 rows of the
// block's 128-row output tile (q rows forward, keys for dK/dV) and keeps
// its accumulators in registers.  Warp 0 is also the producer: it issues
// the TMA loads of the tiles the block walks into a ring of stages (and
// writes the stage's small per-row vectors), guarded by mbarriers -- `full`
// when a stage has landed, `empty` when both warpgroups are done with it --
// refilling a stage as soon as it is released.
//
// A tile arrives as TMA lays it out with the 128-byte swizzle: each
// 64-column half of a [rows][D] tile is its own [rows][64] region (128-byte
// rows whose 16-byte chunks are permuted by row % 8, in 1024-byte atoms of
// 8 rows).  wgmma reads its B operand (and A, for the first product) from
// there through a matrix descriptor: K-major for Q K^T (K Q^T, V dO^T),
// stepping 32 bytes along a row per 16-wide k step and to the next region
// every 4 steps; MN-major (the transpose bit) for the V of P V (the dO, Q
// of dV, dK), stepping 16 rows per k step with LBO the distance between
// the 64-column regions along N and SBO that between 8-row groups along K.
// The second product takes A from registers: wgmma's accumulator layout is
// mma.sync's C layout tiled along N, so P (dS) is packed to 16 bits in
// registers by acc_to_a as in the mma.sync kernels.

// Two consumer warpgroups, warp 0 also the producer.  Not a third
// (producer) warpgroup: with 12 warps ptxas holds every thread to 168
// registers whatever setmaxnreg asks, and the dK/dV consumers need ~230.
constexpr int kHopThreads = 256;

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

// The [rows][64] box at (d0, h, t0, b) of a (D, H, T, B) tensor map into
// shared memory at dst, counted on barrier `bar`; rows past T are zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0),
      "r"(h), "r"(t0), "r"(b)
      : "memory");
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

// K-major operand of a tile of R rows at shared address a: its rows from
// r0 (A: 64 rows; B: all R), k step kk (columns 16 kk..16 kk + 15).
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t a, int r0, int kk) {
  return wg_desc(a + r0 * 128, 16, 1024) +
         (((kk / 4) * R * 128 + (kk % 4) * 32) >> 4);
}

// MN-major B operand of a tile of R rows at shared address a: rows 16 kc..
// 16 kc + 15 (K), all D columns (N) across its 64-column regions.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t a, int kc) {
  return wg_desc(a, R * 128, 1024) + ((kc * 16 * 128) >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight (they
// complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait<0>();
}

// Keeps the compiler from moving reads or reuse of registers that an
// in-flight wgmma writes (accumulators) or reads (A fragments) across the
// issue or the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// wgmma.mma_async m64nNk16 with float32 accumulators, N = 64 or 128 (the
// accumulator's extent picks the overload): `ss` reads A and B K-major from
// shared memory (scale_d 0 overwrites D), `rs` reads A from registers and B
// MN-major.
template <typename T>
struct Wg;

template <>
struct Wg<__nv_bfloat16> {
  __device__ static void ss(float (&d)[8][4], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
  __device__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],
                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
  __device__ static void ss(float (&d)[16][4], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[16][4], const uint32_t (&a)[4],
                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wg<__half> {
  __device__ static void ss(float (&d)[8][4], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
  __device__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],
                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
  __device__ static void ss(float (&d)[16][4], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[16][4], const uint32_t (&a)[4],
                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

// Shared memory of the forward kernel: Q [D/64][BQ][64], then S stages of
// K and V [D/64][BK][64], the stages' kv segment ids, and the barriers (q,
// full[S], empty[S]); 1024 bytes of slack align the base for the swizzle
// atoms.  Three stages: a consumer holds two (the V of the tile whose P V
// is in flight, the K of the next), the third is the producer's.  At D 128
// that is 227 KB, all a block may have.
template <int D>
struct FwdTiles {
  static constexpr int BQ = 128, BK = 128, S = 3;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + S * KV_BYTES;
  static constexpr int KSEG = V + S * KV_BYTES;
  static constexpr int BARS = KSEG + S * BK * 4;
  static constexpr size_t bytes = BARS + (1 + 2 * S) * 8 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args p) {
  using L = FwdTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::S, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  int* kseg_s = reinterpret_cast<int*>(sm + L::KSEG);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = static_cast<int>(h / (H / p.Hk));
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);        // the producer warp's lanes
      bar_init(empty + s, 2 * 128);  // every thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0 also feeds the ring: Q once, then tile kt into stage kt % S
  // once both warpgroups have released the tile S before it.
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int kt) {
    if (kt >= kt_end) return;
    const int s = kt % S, lane = threadIdx.x;
    bar_wait(empty + s, ((kt / S) & 1) ^ 1);
    const int k0 = kt * BK;
    if (has_seg)
      for (int i = lane; i < BK; i += 32)
        kseg_s[s * BK + i] = k0 + i < P.Tk ? p.kseg[b * P.Tk + k0 + i] : 0;
    if (lane == 0) {
      bar_expect(full + s, 2 * L::KV_BYTES);
      unsigned char* kd = sm + L::K + s * L::KV_BYTES;
      unsigned char* vd = sm + L::V + s * L::KV_BYTES;
      for (int j = 0; j < NH; ++j) {
        tma_load(kd + j * BK * 128, &tm_k, full + s, 64 * j, hk, k0,
                 static_cast<int>(b));
        tma_load(vd + j * BK * 128, &tm_v, full + s, 64 * j, hk, k0,
                 static_cast<int>(b));
      }
    } else {
      bar_arrive(full + s);
    }
  };
  if (producer && kt_end > 0) {
    if (threadIdx.x == 0) {
      bar_expect(qbar, L::Q_BYTES);
      for (int j = 0; j < NH; ++j)
        tma_load(sm + L::Q + j * BQ * 128, &tm_q, qbar, 64 * j,
                 static_cast<int>(h), q0, static_cast<int>(b));
    }
    for (int kt = 0; kt < S; ++kt) produce(kt);
  }
  // a stage is done with: release it and, in warp 0, refill it
  auto release = [&](int kt) {
    bar_arrive(empty + kt % S);
    if (producer) produce(kt + S);
  };

  {
    // two consumer warpgroups of 64 q rows: S = Q K^T and O += P V
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + cw * 64;     // the warpgroup's first row
    const int wrow = row0 + warp * 16;  // the warp's first row
    const int qpos0 = P.goff_q + wrow;
    const bool wg_rows = row0 < P.Tq;
    const int wg_last = P.goff_q + min(row0 + 63, P.Tq - 1);
    const float scale2 = static_cast<float>(p.scale) * kLog2e;
    const float inv_keep = static_cast<float>(p.inv_keep);
    int qpos[2], qs[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = wrow + g + 8 * ri;
      qpos[ri] = qpos0 + g + 8 * ri;
      qs[ri] = has_seg && qi < P.Tq ? p.qseg[b * P.Tq + qi] : 0;
    }
    float o[D / 8][4] = {};
    float sc[BK / 8][4];     // scores, then probabilities, of one tile
    uint32_t pa[BK / 16][4];  // P packed to T: the A operand of P V
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    // the tiles this warpgroup takes: none if its rows are all past T,
    // else those up to its last row's causal limit -- a prefix of the
    // block's; the rest it only passes on
    const int kt_wg = !wg_rows ? 0
                      : p.causal ? causal_tiles(wg_last, P.goff_k, BK, n_kt)
                                 : n_kt;

    // S = Q K^T of tile kt, issued and committed (not waited for)
    auto scores = [&](int kt) {
      const uint32_t qa = opaque_addr(sm + L::Q) + cw * 64 * 128;
      const uint32_t ka = opaque_addr(sm + L::K + (kt % S) * L::KV_BYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<T>::ss(sc, kmajor<BQ>(qa, 0, kk), kmajor<BK>(ka, 0, kk), kk > 0);
      wg_commit();
    };
    // O += P V of tile kt, P from pa, issued and committed
    auto pv = [&](int kt) {
      const uint32_t va = opaque_addr(sm + L::V + (kt % S) * L::KV_BYTES);
      reg_fence(o);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        Wg<T>::rs(o, pa[kc], mnmajor<BK>(va, kc), 1);
      wg_commit();
    };
    // online softmax of tile kt on sc: scale, mask, running max and
    // denominator, in log2 units (m is the running max of s * scale *
    // log2 e, so one ex2 per element); sc becomes the (dropped)
    // probabilities, alpha the factor the output must be rescaled by.  A
    // tile that no mask touches takes a branch-free loop.
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int k0 = kt * BK;
      const bool full_tile = !has_seg && k0 + BK <= P.Tk &&
                             (!p.causal || P.goff_k + k0 + BK - 1 <= qpos0);
      uint32_t allow[BK / 32];
      float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
      if (full_tile) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = sc[nt][j] * scale2;
            sc[nt][j] = v;
            mx[j >> 1][j & 1] = fmaxf(mx[j >> 1][j & 1], v);
          }
      } else {
        const int* ks = kseg_s + (kt % S) * BK;
#pragma unroll
        for (int w = 0; w < BK / 32; ++w) allow[w] = ~0u;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
            bool ok = k0 + c < P.Tk;
            if (p.causal) ok = ok && qpos[ri] >= P.goff_k + k0 + c;
            if (has_seg) ok = ok && qs[ri] == ks[c];
            if (!ok) allow[nt / 8] &= ~(1u << ((nt % 8) * 4 + j));
            const float v = ok ? sc[nt][j] * scale2 : kNegInf;
            sc[nt][j] = v;
            mx[ri][j & 1] = fmaxf(mx[ri][j & 1], v);
          }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const float mn =
            fmaxf(m[ri], quad_max(fmaxf(mx[ri][0], mx[ri][1])));
        alpha[ri] = ex2(m[ri] - mn);
        m[ri] = mn;
      }
      float sum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      if (full_tile) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pj = ex2(sc[nt][j] - m[j >> 1]);
            sum[j >> 1][j & 1] += pj;
            sc[nt][j] = pj;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = j >> 1;
            const bool ok = (allow[nt / 8] >> ((nt % 8) * 4 + j)) & 1u;
            const float pj = ok ? ex2(sc[nt][j] - m[ri]) : 0.0f;
            sum[ri][j & 1] += pj;
            sc[nt][j] = pj;
          }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
        l[ri] = l[ri] * alpha[ri] + quad_sum(sum[ri][0] + sum[ri][1]);
      if (p.dropout) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sc[nt][j] =
                keep(static_cast<uint32_t>(p.seed), static_cast<uint32_t>(bh),
                     static_cast<uint32_t>(qpos[j >> 1]),
                     static_cast<uint32_t>(P.goff_k + k0 + nt * 8 + 2 * t +
                                           (j & 1)),
                     static_cast<uint32_t>(p.thresh))
                    ? sc[nt][j] * inv_keep
                    : 0.0f;
      }
    };
    // P rounded to v's type, packed from the accumulator layout
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a<T>(pa[kc], sc, kc);
    };

    if (kt_end > 0) bar_wait(qbar, 0);
    // Software pipeline: while P V of tile kt - 1 runs on the tensor cores,
    // S of tile kt is issued before it and its softmax runs after it has
    // landed.  A stage is released once P V has read its V.
    if (kt_wg > 0) {
      float alpha[2];
      bar_wait(full, 0);
      scores(0);
      wg_wait<0>();
      reg_fence(sc);
      softmax(0, alpha);  // O is still 0: nothing to rescale
      pack_p();
      for (int kt = 1; kt < kt_wg; ++kt) {
        bar_wait(full + kt % S, (kt / S) & 1);
        scores(kt);
        pv(kt - 1);
        wg_wait<1>();  // S of tile kt has landed; P V may still run
        reg_fence(sc);
        softmax(kt, alpha);
        wg_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        release(kt - 1);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[nd][0] *= alpha[0];
          o[nd][1] *= alpha[0];
          o[nd][2] *= alpha[1];
          o[nd][3] *= alpha[1];
        }
        pack_p();
      }
      pv(kt_wg - 1);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      release(kt_wg - 1);
    }
    for (int kt = kt_wg; kt < kt_end; ++kt) {
      bar_wait(full + kt % S, (kt / S) & 1);
      release(kt);
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int64_t qi = wrow + g + 8 * ri;
      if (qi >= P.Tq) continue;
      const bool empty_row = l[ri] == 0.0f;
      const float denom = empty_row ? 1.0f : l[ri];
      T* orow = static_cast<T*>(p.out) + ((b * P.Tq + qi) * H + h) * D;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) = Mma<T>::pack(
            o[nd][2 * ri] / denom, o[nd][2 * ri + 1] / denom);
      if (t == 0)
        p.lse[bh * P.Tq + qi] =
            empty_row ? kLseSentinel : m[ri] * kLn2 + logf(denom);
    }
  }
}

// Shared memory of the dK/dV kernel: K and V [D/64][BK][64], S stages of Q
// and dO [D/64][BQ][64] and of the per-row vectors (lse, delta, glse, q
// segment ids, BQ each), and the barriers (kv, full[S], empty[S]).
template <int D>
struct DkvTiles {
  static constexpr int BK = 128, BQ = 64, S = 2;
  static constexpr int KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;
  static constexpr int G = Q + S * Q_BYTES;
  static constexpr int VEC = G + S * Q_BYTES;
  static constexpr int BARS = VEC + S * 4 * BQ * 4;
  static constexpr size_t bytes = BARS + (1 + 2 * S) * 8 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g, const Args p) {
  using L = DkvTiles<D>;
  constexpr int BK = L::BK, BQ = L::BQ, S = L::S, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;
  float* vec = reinterpret_cast<float*>(sm + L::VEC);

  const int64_t H = p.H, Hk = p.Hk;
  const int grp = static_cast<int>(H / Hk);
  const int64_t bhk = blockIdx.y, b = bhk / Hk;
  const int hk = static_cast<int>(bhk % Hk);
  const TcPos P(p, b);
  const int k0 = blockIdx.x * BK;
  const bool has_seg = p.qseg != nullptr;
  const int n_qt = (P.Tq + BQ - 1) / BQ;
  // causal: q tiles whose last row does not see key k0 are skipped
  int qt0 = 0;
  if (p.causal)
    while (qt0 < n_qt &&
           P.goff_q + min((qt0 + 1) * BQ, P.Tq) - 1 < P.goff_k + k0)
      ++qt0;
  const int nq = n_qt - qt0;
  const int total = grp * nq;

  if (threadIdx.x == 0) {
    bar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);
      bar_init(empty + s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0 also feeds the ring: K/V once, then (q head, q tile) step i's
  // Q, dO and per-row vectors into stage i % S once both warpgroups have
  // released step i - S.
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int i) {
    if (i >= total) return;
    const int s = i % S, lane = threadIdx.x;
    bar_wait(empty + s, ((i / S) & 1) ^ 1);
    const int h = hk * grp + i / nq;
    const int q0 = (qt0 + i % nq) * BQ;
    const int64_t row = (b * H + h) * P.Tq + q0;
    float* vs = vec + s * 4 * BQ;
    for (int j = lane; j < BQ; j += 32) {
      const bool ok = q0 + j < P.Tq;
      vs[j] = ok ? p.lse_in[row + j] : 0.0f;
      vs[BQ + j] = ok ? p.delta[row + j] : 0.0f;
      vs[2 * BQ + j] = ok && p.glse ? p.glse[row + j] : 0.0f;
      reinterpret_cast<int*>(vs)[3 * BQ + j] =
          ok && has_seg ? p.qseg[b * P.Tq + q0 + j] : 0;
    }
    if (lane == 0) {
      bar_expect(full + s, 2 * L::Q_BYTES);
      unsigned char* qd = sm + L::Q + s * L::Q_BYTES;
      unsigned char* gd = sm + L::G + s * L::Q_BYTES;
      for (int j = 0; j < NH; ++j) {
        tma_load(qd + j * BQ * 128, &tm_q, full + s, 64 * j, h, q0,
                 static_cast<int>(b));
        tma_load(gd + j * BQ * 128, &tm_g, full + s, 64 * j, h, q0,
                 static_cast<int>(b));
      }
    } else {
      bar_arrive(full + s);
    }
  };
  if (producer && total > 0) {
    if (threadIdx.x == 0) {
      bar_expect(kvbar, 2 * L::KV_BYTES);
      for (int j = 0; j < NH; ++j) {
        tma_load(sm + L::K + j * BK * 128, &tm_k, kvbar, 64 * j, hk, k0,
                 static_cast<int>(b));
        tma_load(sm + L::V + j * BK * 128, &tm_v, kvbar, 64 * j, hk, k0,
                 static_cast<int>(b));
      }
    }
    for (int i = 0; i < S; ++i) produce(i);
  }

  {
    // two consumer warpgroups of 64 keys: S^T = K Q^T, dP^T = V dO^T, then
    // dV += P_drop^T dO and dK += dS^T Q, all on wgmma
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = k0 + cw * 64;     // the warpgroup's first key
    const int wkey = key0 + warp * 16;  // the warp's first key
    const int kpos_last = P.goff_k + wkey + 15;
    const bool keys_ok = wkey + 16 <= P.Tk;
    const float scale = static_cast<float>(p.scale);
    const float scale2 = scale * kLog2e;
    int kpos[2], ks[2];
    bool key_ok[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int ki = wkey + g + 8 * ri;
      kpos[ri] = P.goff_k + ki;
      key_ok[ri] = ki < P.Tk;
      ks[ri] = has_seg && key_ok[ri] ? p.kseg[b * P.Tk + ki] : 0;
    }
    float dk[D / 8][4] = {}, dv[D / 8][4] = {};
    if (total > 0) bar_wait(kvbar, 0);

    for (int i = 0; i < total; ++i) {
      const int s = i % S;
      bar_wait(full + s, (i / S) & 1);
      const int64_t bhq = b * H + hk * grp + i / nq;
      const int q0 = (qt0 + i % nq) * BQ;
      // a warpgroup whose keys are all past T, or that no row of this q
      // tile sees, only passes the stage on
      if (key0 < P.Tk &&
          (!p.causal || P.goff_q + min(q0 + BQ, P.Tq) - 1 >= P.goff_k + key0)) {
        const uint32_t ka = opaque_addr(sm + L::K);
        const uint32_t va = opaque_addr(sm + L::V);
        const uint32_t qa = opaque_addr(sm + L::Q + s * L::Q_BYTES);
        const uint32_t ga = opaque_addr(sm + L::G + s * L::Q_BYTES);
        const float* lse_b = vec + s * 4 * BQ;
        const float* delta_b = lse_b + BQ;
        const float* glse_b = lse_b + 2 * BQ;
        const int* qseg_b = reinterpret_cast<const int*>(lse_b + 3 * BQ);
        float st[BQ / 8][4], dpt[BQ / 8][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wg<T>::ss(st, kmajor<BK>(ka, cw * 64, kk), kmajor<BQ>(qa, 0, kk),
                    kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wg<T>::ss(dpt, kmajor<BK>(va, cw * 64, kk), kmajor<BQ>(ga, 0, kk),
                    kk > 0);
        wg_commit_wait();
        reg_fence(st);
        reg_fence(dpt);
        const bool full_tile = !has_seg && keys_ok && q0 + BQ <= P.Tq &&
                               (!p.causal || P.goff_q + q0 >= kpos_last);
        if (full_tile && !p.dropout) {
          // no mask, no dropout: a = 2**(s scale log2 e - lse log2 e) and
          // ds = a (dp - (delta - glse)) scale, branch-free
#pragma unroll
          for (int nt = 0; nt < BQ / 8; ++nt) {
            const int c = nt * 8 + 2 * t;
            const float l2[2] = {lse_b[c] * kLog2e, lse_b[c + 1] * kLog2e};
            const float dl[2] = {delta_b[c] - glse_b[c],
                                 delta_b[c + 1] - glse_b[c + 1]};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = ex2(st[nt][j] * scale2 - l2[j & 1]);
              dpt[nt][j] = a * (dpt[nt][j] - dl[j & 1]) * scale;
              st[nt][j] = a;
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
              const int qpos = P.goff_q + q0 + c;
              bool ok = true;
              if (!full_tile) {
                ok = key_ok[ri] && q0 + c < P.Tq;
                if (p.causal) ok = ok && qpos >= kpos[ri];
                if (has_seg) ok = ok && qseg_b[c] == ks[ri];
              }
              float a_drop;
              dpt[nt][j] = grad_elem(p, ok, st[nt][j], dpt[nt][j], lse_b[c],
                                     delta_b[c], glse_b[c],
                                     static_cast<uint32_t>(bhq), qpos, kpos[ri],
                                     a_drop);
              st[nt][j] = a_drop;
            }
        }
        // dV += P_drop^T dO and dK += dS^T Q, both A operands from registers
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          acc_to_a<T>(pa[kc], st, kc);
          acc_to_a<T>(sa[kc], dpt, kc);
        }
        reg_fence(dk);
        reg_fence(dv);
        reg_fence(pa);
        reg_fence(sa);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          Wg<T>::rs(dv, pa[kc], mnmajor<BQ>(ga, kc), 1);
          Wg<T>::rs(dk, sa[kc], mnmajor<BQ>(qa, kc), 1);
        }
        wg_commit_wait();
        reg_fence(dk);
        reg_fence(dv);
        reg_fence(pa);
        reg_fence(sa);
      }
      bar_arrive(empty + s);
      if (producer) produce(i + S);
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (!key_ok[ri]) continue;
      const int64_t o = ((b * P.Tk + wkey + g + 8 * ri) * Hk + hk) * D;
      T* dkr = static_cast<T*>(p.dk) + o;
      T* dvr = static_cast<T*>(p.dv) + o;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(dkr + nd * 8 + 2 * t) =
            Mma<T>::pack(dk[nd][2 * ri], dk[nd][2 * ri + 1]);
        *reinterpret_cast<uint32_t*>(dvr + nd * 8 + 2 * t) =
            Mma<T>::pack(dv[nd][2 * ri], dv[nd][2 * ri + 1]);
      }
    }
  }
}

// Shared memory of the dQ kernel: Q and dO [D/64][BQ][64], then S stages
// of K and V [D/64][BK][64], the stages' kv segment ids, and the barriers
// (q, full[S], empty[S]).  64-key tiles keep S and dP at 32 floats a thread
// each beside the 64 of the dQ accumulator at D 128 (at 128 keys the three
// would not fit in 255 registers); four stages: a consumer holds two (the K
// of the tile whose dS K is in flight, the K and V of the next), the
// producer fills the other two.  At D 128 that is 194 KB.
template <int D>
struct DqTiles {
  static constexpr int BQ = 128, BK = 64, S = 4;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int G = Q + Q_BYTES;
  static constexpr int K = G + Q_BYTES;
  static constexpr int V = K + S * KV_BYTES;
  static constexpr int KSEG = V + S * KV_BYTES;
  static constexpr int BARS = KSEG + S * BK * 4;
  static constexpr size_t bytes = BARS + (1 + 2 * S) * 8 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g, const Args p) {
  using L = DqTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::S, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  int* kseg_s = reinterpret_cast<int*>(sm + L::KSEG);

  const int64_t H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = static_cast<int>(h / (H / p.Hk));
  const TcPos P(p, b);
  const int q0 = static_cast<int>(heavy_first(p, gridDim.x)) * BQ;
  const bool has_seg = p.qseg != nullptr;
  const int q_valid = min(BQ, P.Tq - q0);
  const int n_kt = (P.Tk + BK - 1) / BK;
  const int kt_end = p.causal ? causal_tiles(P.goff_q + q0 + q_valid - 1,
                                             P.goff_k, BK, n_kt)
                              : n_kt;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);        // the producer warp's lanes
      bar_init(empty + s, 2 * 128);  // every thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0 also feeds the ring: Q and dO once, then K/V tile kt into stage
  // kt % S once both warpgroups have released the tile S before it.
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int kt) {
    if (kt >= kt_end) return;
    const int s = kt % S, lane = threadIdx.x;
    bar_wait(empty + s, ((kt / S) & 1) ^ 1);
    const int k0 = kt * BK;
    if (has_seg)
      for (int i = lane; i < BK; i += 32)
        kseg_s[s * BK + i] = k0 + i < P.Tk ? p.kseg[b * P.Tk + k0 + i] : 0;
    if (lane == 0) {
      bar_expect(full + s, 2 * L::KV_BYTES);
      unsigned char* kd = sm + L::K + s * L::KV_BYTES;
      unsigned char* vd = sm + L::V + s * L::KV_BYTES;
      for (int j = 0; j < NH; ++j) {
        tma_load(kd + j * BK * 128, &tm_k, full + s, 64 * j, hk, k0,
                 static_cast<int>(b));
        tma_load(vd + j * BK * 128, &tm_v, full + s, 64 * j, hk, k0,
                 static_cast<int>(b));
      }
    } else {
      bar_arrive(full + s);
    }
  };
  if (producer && kt_end > 0) {
    if (threadIdx.x == 0) {
      bar_expect(qbar, 2 * L::Q_BYTES);
      for (int j = 0; j < NH; ++j) {
        tma_load(sm + L::Q + j * BQ * 128, &tm_q, qbar, 64 * j,
                 static_cast<int>(h), q0, static_cast<int>(b));
        tma_load(sm + L::G + j * BQ * 128, &tm_g, qbar, 64 * j,
                 static_cast<int>(h), q0, static_cast<int>(b));
      }
    }
    for (int kt = 0; kt < S; ++kt) produce(kt);
  }
  // a stage is done with: release it and, in warp 0, refill it
  auto release = [&](int kt) {
    bar_arrive(empty + kt % S);
    if (producer) produce(kt + S);
  };

  {
    // two consumer warpgroups of 64 q rows: S = Q K^T, dP = dO V^T, the
    // element step, then dQ += dS K
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + cw * 64;     // the warpgroup's first row
    const int wrow = row0 + warp * 16;  // the warp's first row
    const int qpos0 = P.goff_q + wrow;
    const bool rows_ok = wrow + 16 <= P.Tq;
    const int wg_last = P.goff_q + min(row0 + 63, P.Tq - 1);
    const float scale = static_cast<float>(p.scale);
    const float scale2 = scale * kLog2e;
    // the per-row vectors of this thread's two rows, read once
    int qpos[2], qs[2];
    bool row_ok[2];
    float lse[2], delta[2], gl[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = wrow + g + 8 * ri;
      const int64_t at = bh * P.Tq + qi;
      qpos[ri] = qpos0 + g + 8 * ri;
      row_ok[ri] = qi < P.Tq;
      qs[ri] = has_seg && row_ok[ri] ? p.qseg[b * P.Tq + qi] : 0;
      lse[ri] = row_ok[ri] ? p.lse_in[at] : 0.0f;
      delta[ri] = row_ok[ri] ? p.delta[at] : 0.0f;
      gl[ri] = row_ok[ri] && p.glse ? p.glse[at] : 0.0f;
    }
    float dq[D / 8][4] = {};
    float sc[BK / 8][4], dp[BK / 8][4];  // S and dP, then dS in sc
    uint32_t sa[BK / 16][4];              // dS packed to T: the A of dS K
    // the tiles this warpgroup takes: none if its rows are all past T,
    // else those up to its last row's causal limit -- a prefix of the
    // block's; the rest it only passes on
    const int kt_wg = row0 >= P.Tq ? 0
                      : p.causal ? causal_tiles(wg_last, P.goff_k, BK, n_kt)
                                 : n_kt;

    // S = Q K^T and dP = dO V^T of tile kt, issued and committed as one
    // group (not waited for)
    auto products = [&](int kt) {
      const uint32_t qa = opaque_addr(sm + L::Q) + cw * 64 * 128;
      const uint32_t ga = opaque_addr(sm + L::G) + cw * 64 * 128;
      const uint32_t ka = opaque_addr(sm + L::K + (kt % S) * L::KV_BYTES);
      const uint32_t va = opaque_addr(sm + L::V + (kt % S) * L::KV_BYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<T>::ss(sc, kmajor<BQ>(qa, 0, kk), kmajor<BK>(ka, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<T>::ss(dp, kmajor<BQ>(ga, 0, kk), kmajor<BK>(va, 0, kk), kk > 0);
      wg_commit();
    };
    // dQ += dS K of tile kt, dS from sa and K read MN-major, issued and
    // committed
    auto dsk = [&](int kt) {
      const uint32_t ka = opaque_addr(sm + L::K + (kt % S) * L::KV_BYTES);
      reg_fence(dq);
      reg_fence(sa);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        Wg<T>::rs(dq, sa[kc], mnmajor<BK>(ka, kc), 1);
      wg_commit();
    };
    // the element step of tile kt on the accumulator layout: sc becomes
    // dS.  A tile that no mask touches, without dropout, takes a
    // branch-free loop: a = 2**(s scale log2 e - lse log2 e) and ds = a
    // (dp - (delta - glse)) scale; the rest goes through grad_elem.
    auto element = [&](int kt) {
      const int k0 = kt * BK;
      const bool full_tile = !has_seg && rows_ok && k0 + BK <= P.Tk &&
                             (!p.causal || P.goff_k + k0 + BK - 1 <= qpos0);
      if (full_tile && !p.dropout) {
        const float l2[2] = {lse[0] * kLog2e, lse[1] * kLog2e};
        const float dl[2] = {delta[0] - gl[0], delta[1] - gl[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = j >> 1;
            const float a = ex2(sc[nt][j] * scale2 - l2[ri]);
            sc[nt][j] = a * (dp[nt][j] - dl[ri]) * scale;
          }
      } else {
        const int* ks = kseg_s + (kt % S) * BK;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = j >> 1, c = nt * 8 + 2 * t + (j & 1);
            bool ok = true;
            if (!full_tile) {
              ok = row_ok[ri] && k0 + c < P.Tk;
              if (p.causal) ok = ok && qpos[ri] >= P.goff_k + k0 + c;
              if (has_seg) ok = ok && qs[ri] == ks[c];
            }
            float unused;
            sc[nt][j] = grad_elem(p, ok, sc[nt][j], dp[nt][j], lse[ri],
                                  delta[ri], gl[ri],
                                  static_cast<uint32_t>(bh), qpos[ri],
                                  P.goff_k + k0 + c, unused);
          }
      }
    };
    // dS rounded to k's type, packed from the accumulator layout
    auto pack_ds = [&]() {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a<T>(sa[kc], sc, kc);
    };

    if (kt_end > 0) bar_wait(qbar, 0);
    // Software pipeline: while dS K of tile kt - 1 runs on the tensor
    // cores, S and dP of tile kt are issued before it and the element step
    // of tile kt runs after they have landed.  A stage is released once dS
    // K has read its K.
    if (kt_wg > 0) {
      bar_wait(full, 0);
      products(0);
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      element(0);
      pack_ds();
      for (int kt = 1; kt < kt_wg; ++kt) {
        bar_wait(full + kt % S, (kt / S) & 1);
        products(kt);
        dsk(kt - 1);
        wg_wait<1>();  // S and dP of tile kt have landed; dS K may still run
        reg_fence(sc);
        reg_fence(dp);
        element(kt);
        wg_wait<0>();
        reg_fence(dq);
        reg_fence(sa);
        release(kt - 1);
        pack_ds();
      }
      dsk(kt_wg - 1);
      wg_wait<0>();
      reg_fence(dq);
      reg_fence(sa);
      release(kt_wg - 1);
    }
    for (int kt = kt_wg; kt < kt_end; ++kt) {
      bar_wait(full + kt % S, (kt / S) & 1);
      release(kt);
    }

    // dQ [B, Tq, H, D], contiguous; rows past Tq are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (!row_ok[ri]) continue;
      const int64_t qi = wrow + g + 8 * ri;
      T* row = static_cast<T*>(p.dq) + ((b * P.Tq + qi) * H + h) * D;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(row + nd * 8 + 2 * t) =
            Mma<T>::pack(dq[nd][2 * ri], dq[nd][2 * ri + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Above 48 KB a block's dynamic shared memory must be allowed per kernel
// and per device; done once, before the first launch on that device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int device, bool* done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <typename Kern, typename... KArgs>
cudaError_t launch_kernel(Kern kernel, dim3 grid, int threads, size_t bytes,
                          cudaStream_t s, int device, bool* done,
                          const KArgs&... args) {
  cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(args...);
  return cudaGetLastError();
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

// The (D, H, T, B) tensor map of a [B, T, H, D] 16-bit tensor at `base`
// with element strides sb, st, sh (unit stride along D), read in [rows][64]
// boxes with the 128-byte swizzle; rows past T read as zeros.  Built on the
// host at every launch and passed by value, so a CUDA graph captures it.
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int64_t B,
                       int64_t Tn, int64_t Hn, int D, int64_t sb, int64_t st,
                       int64_t sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int64_t e = sizeof(T);
  // a dimension of extent 1 is never stepped: any legal stride will do
  auto bytes = [&](int64_t stride, int64_t extent) {
    return static_cast<cuuint64_t>(extent > 1 ? stride * e : D * e);
  };
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(Hn),
                        static_cast<cuuint64_t>(Tn),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {bytes(sh, Hn), bytes(st, Tn), bytes(sb, B)};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// float32 takes the CUDA-core kernels; bf16/fp16 the mma.sync kernels at
// head dims 16 and 32 and the wgmma kernels at 64 and 128 -- a dispatch by
// shape: each head dim has exactly one kernel, for dQ as for the others.
struct Fwd {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bh = static_cast<unsigned>(a.B * a.H);
    if constexpr (std::is_same<T, float>::value) {
      using L = F32Fwd<D>;
      return launch_kernel(fwd_f32_kernel<D>,
                           dim3((a.Tq + L::BQ - 1) / L::BQ, bh), L::NT,
                           L::bytes, s, device, done, a);
    } else if constexpr (D <= 32) {
      return launch_kernel(fwd_tc_kernel<T, D>,
                           dim3((a.Tq + kTcRows - 1) / kTcRows, bh),
                           kTcThreads, TcSmem<T, D>::fwd, s, device, done, a);
    } else {
      using L = FwdTiles<D>;
      CUtensorMap mq, mk, mv;
      cudaError_t err = tensor_map<T>(&mq, a.q, a.B, a.Tq, a.H, D, a.q_sb,
                                      a.q_st, a.q_sh, L::BQ);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mk, a.k, a.B, a.Tk, a.Hk, D, a.k_sb, a.k_st,
                            a.k_sh, L::BK);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mv, a.v, a.B, a.Tk, a.Hk, D, a.v_sb, a.v_st,
                            a.v_sh, L::BK);
      if (err != cudaSuccess) return err;
      return launch_kernel(fwd_wgmma_kernel<T, D>,
                           dim3((a.Tq + L::BQ - 1) / L::BQ, bh), kHopThreads,
                           L::bytes, s, device, done, mq, mk, mv, a);
    }
  }
};

struct Dkv {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bhk = static_cast<unsigned>(a.B * a.Hk);
    if constexpr (std::is_same<T, float>::value) {
      using L = F32Dkv<D>;
      return launch_kernel(dkv_f32_kernel<D>,
                           dim3((a.Tk + L::BK - 1) / L::BK, bhk), L::NT,
                           L::bytes, s, device, done, a);
    } else if constexpr (D <= 32) {
      return launch_kernel(dkv_tc_kernel<T, D>,
                           dim3((a.Tk + kTcRows - 1) / kTcRows, bhk),
                           kTcThreads, TcSmem<T, D>::dkv, s, device, done, a);
    } else {
      using L = DkvTiles<D>;
      CUtensorMap mq, mk, mv, mg;
      cudaError_t err = tensor_map<T>(&mq, a.q, a.B, a.Tq, a.H, D, a.q_sb,
                                      a.q_st, a.q_sh, L::BQ);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mg, a.g, a.B, a.Tq, a.H, D, a.g_sb, a.g_st,
                            a.g_sh, L::BQ);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mk, a.k, a.B, a.Tk, a.Hk, D, a.k_sb, a.k_st,
                            a.k_sh, L::BK);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mv, a.v, a.B, a.Tk, a.Hk, D, a.v_sb, a.v_st,
                            a.v_sh, L::BK);
      if (err != cudaSuccess) return err;
      return launch_kernel(dkv_wgmma_kernel<T, D>,
                           dim3((a.Tk + L::BK - 1) / L::BK, bhk), kHopThreads,
                           L::bytes, s, device, done, mq, mk, mv, mg, a);
    }
  }
};

struct Dq {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bh = static_cast<unsigned>(a.B * a.H);
    if constexpr (std::is_same<T, float>::value) {
      using L = F32Dq<D>;
      return launch_kernel(dq_f32_kernel<D>,
                           dim3((a.Tq + L::BQ - 1) / L::BQ, bh), L::NT,
                           L::bytes, s, device, done, a);
    } else if constexpr (D <= 32) {
      return launch_kernel(dq_tc_kernel<T, D>,
                           dim3((a.Tq + kTcRows - 1) / kTcRows, bh),
                           kTcThreads, TcSmem<T, D>::dq, s, device, done, a);
    } else {
      using L = DqTiles<D>;
      CUtensorMap mq, mk, mv, mg;
      cudaError_t err = tensor_map<T>(&mq, a.q, a.B, a.Tq, a.H, D, a.q_sb,
                                      a.q_st, a.q_sh, L::BQ);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mg, a.g, a.B, a.Tq, a.H, D, a.g_sb, a.g_st,
                            a.g_sh, L::BQ);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mk, a.k, a.B, a.Tk, a.Hk, D, a.k_sb, a.k_st,
                            a.k_sh, L::BK);
      if (err == cudaSuccess)
        err = tensor_map<T>(&mv, a.v, a.B, a.Tk, a.Hk, D, a.v_sb, a.v_st,
                            a.v_sh, L::BK);
      if (err != cudaSuccess) return err;
      return launch_kernel(dq_wgmma_kernel<T, D>,
                           dim3((a.Tq + L::BQ - 1) / L::BQ, bh), kHopThreads,
                           L::bytes, s, device, done, mq, mk, mv, mg, a);
    }
  }
};

template <class K, typename T>
cudaError_t by_dim(int64_t d, const Args& a, cudaStream_t s, int device) {
  switch (d) {
    case 16: return K::template run<T, 16>(a, s, device);
    case 32: return K::template run<T, 32>(a, s, device);
    case 64: return K::template run<T, 64>(a, s, device);
    case 128: return K::template run<T, 128>(a, s, device);
  }
  return cudaErrorInvalidValue;
}

template <class K>
cudaError_t launch(const Args* a, int dtype, int64_t d, int device,
                   void* stream) {
  if (a == nullptr || a->Hk <= 0 || a->H % a->Hk) return cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: point it at the tensors'
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return by_dim<K, float>(d, *a, s, device);
    case kBF16: return by_dim<K, __nv_bfloat16>(d, *a, s, device);
    case kF16: return by_dim<K, __half>(d, *a, s, device);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).
extern "C" int cmn_flash_fwd(const Args* a, int dtype, int64_t d, int device,
                             void* stream) {
  return launch<Fwd>(a, dtype, d, device, stream);
}

extern "C" int cmn_flash_bwd_dkv(const Args* a, int dtype, int64_t d,
                                 int device, void* stream) {
  return launch<Dkv>(a, dtype, d, device, stream);
}

extern "C" int cmn_flash_bwd_dq(const Args* a, int dtype, int64_t d,
                                int device, void* stream) {
  return launch<Dq>(a, dtype, d, device, stream);
}
