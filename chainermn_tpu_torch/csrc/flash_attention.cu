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
// along D and 16-byte aligned rows: the views a fused qkv projection's split
// gives); GQA (q head h reads kv head h / (H / Hk)); the score scaled after
// the QK^T product; masked scores set to -1e30 and masked probabilities
// zeroed explicitly; causal and segment-id masks on GLOBAL positions
// (per-sequence offsets [B, 2]); dropout on the normalised weights from the
// counter hash of (seed, b * H + h, q position, k position), with inverted
// scaling and the denominator built from the undropped weights; P cast to
// v's dtype before the PV product; an empty row gives output 0 and lse 1e30;
// the lse cotangent (glse) enters ds as a * glse * scale.
//
// What bounds them: at the shapes attention runs (head dim 16..128, long
// sequences) each kernel does ~D multiply-adds per byte it must move, far
// above the H100's 295 operations per byte, so the least time is the
// matrix-product FLOPs (2 products forward, 4 for dK/dV, 3 for dQ, over the
// (q, k) pairs the mask allows) over 989 TFLOP/s (bf16/fp16 tensor cores).
//
// The design, kept simple (no wgmma, TMA or warp specialisation yet):
//  * TPU grids run in order and carry accumulators in VMEM scratch across
//    the innermost grid axis; here one block owns an output tile and walks
//    the other axis in a loop: forward, one block per (b*h, 64-row q tile)
//    looping over K/V tiles with an online softmax in float32; dK/dV, one
//    block per (b*hk, 64-key tile) looping over the group's q heads and the
//    q tiles at or after the diagonal, so the GQA group sum of dK/dV is
//    taken in float32 inside the kernel; dQ, one block per (b*h, 64-row q
//    tile) looping over K/V tiles.  No atomics: one block writes each
//    output tile, so a rerun gives the same bits.
//  * Tiles past the causal diagonal are never visited, as the TPU kernels
//    skip their grid steps.
//  * bf16/fp16 (the tensor-core kernels, *_tc_kernel): four warps, each
//    owning 16 output rows; mma.sync m16n8k16 with float32 accumulators in
//    registers -- scores, dP, the output and the dQ/dK/dV accumulators
//    never go through shared memory, and P (dS) is repacked from the
//    accumulator layout into the next product's A operand in registers;
//    operands come from shared memory by ldmatrix; the next K/V (Q/dO)
//    tile is copied in with cp.async while the current one is used.
//  * float32 (*_f32_kernel): the products run on the CUDA cores in float32
//    (never TF32), 256 threads over 32-row tiles staged in shared memory.
//    It is the path of float32 models (the long-context example), not of
//    the bf16 LM.
//  * ragged sequence ends are masked in the kernels (rows and keys past T),
//    so any Tq and Tk work, Tq != Tk included.
//
// Plain C entry points (bound from Python with ctypes, no PyTorch headers):
// the caller fills `Args`, allocates the outputs, passes its stream and
// device, and raises if the returned cudaError_t is not 0.

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

// Tiles of the float32 (CUDA-core) kernels.
template <typename T, int D>
struct Cfg {
  static constexpr int BQ = 32;               // q rows of a tile
  static constexpr int BK = BQ;               // keys of a tile
  static constexpr int PAD = 4;               // elements; keeps 16 B rows
  static constexpr int LDT = D + PAD;         // T tiles [rows][D]
  static constexpr int LDS = BK + 4;          // float [BQ][BK]
  static constexpr int LDP = BK + PAD;        // T [BQ][BK]
  static constexpr int LDA = D + 4;           // float accumulators [rows][D]
  static constexpr int TPR = kThreads / BQ;   // threads on one score row
  static constexpr int NC = BK / TPR;         // score columns per thread
  static_assert(D % 16 == 0 && NC <= 32, "tile shape");
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

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

// ---------------------------------------------------------------------------
// float32: CUDA-core kernels over tiles staged in shared memory
// ---------------------------------------------------------------------------

// C[M][N] (float, row-major, ldc) = (accumulate ? C : 0) + A * B over K,
// with A(m, k) = A_ROW ? a[m * lda + k] : a[k * lda + m] and
//      B(k, n) = B_ROW ? b[k * ldb + n] : b[n * ldb + k], all in shared
// memory, in float32 on the CUDA cores.  The 256 threads form a 16 x 16
// grid; thread (tr, tc) owns rows tr + 16 i and columns tc + 16 j.
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW>
struct TileMma;

template <int M, int N, int K, bool A_ROW, bool B_ROW>
struct TileMma<float, M, N, K, A_ROW, B_ROW> {
  __device__ static void run(const float* a, int lda, const float* b, int ldb,
                             float* c, int ldc, bool accumulate) {
    constexpr int RM = M / 16, RN = N / 16;
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        acc[i][j] = accumulate ? c[(tr + 16 * i) * ldc + tc + 16 * j] : 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        av[i] = A_ROW ? a[(tr + 16 * i) * lda + kk] : a[kk * lda + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j)
        bv[j] = B_ROW ? b[kk * ldb + tc + 16 * j] : b[(tc + 16 * j) * ldb + kk];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        c[(tr + 16 * i) * ldc + tc + 16 * j] = acc[i][j];
  }
};

// ROWS rows of D elements from src (row r at src + r * stride) into dst
// (pitch ld); rows at or past `valid` are zero.  16-byte vectors.
template <typename T, int D, int ROWS>
__device__ void load_rows(T* dst, int ld, const T* src, int64_t stride,
                          int valid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = D / V;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// n entries of a row vector, 0 past `valid` (src may be null: all 0)
template <typename U>
__device__ void load_vec(U* dst, const U* src, int valid, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = (src != nullptr && i < valid) ? src[i] : U(0);
}

template <typename U>
__device__ void zero(U* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = U(0);
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

template <typename T, int D>
struct Smem {
  using C = Cfg<T, D>;
  static constexpr size_t tile = al(C::BQ * C::LDT * sizeof(T));
  static constexpr size_t score = al(C::BQ * C::LDS * sizeof(float));
  static constexpr size_t prob = al(C::BQ * C::LDP * sizeof(T));
  static constexpr size_t acc = al(C::BQ * C::LDA * sizeof(float));
  static constexpr size_t vec = al(C::BQ * sizeof(float));
  static constexpr size_t fwd = 3 * tile + score + prob + acc + 2 * vec;
  static constexpr size_t dkv = 4 * tile + 2 * score + 2 * prob + 2 * acc +
                                5 * vec;
  static constexpr size_t dq = 4 * tile + 2 * score + prob + acc + 5 * vec;
};

__device__ __forceinline__ float row_max(float v, int tpr) {
  for (int o = tpr / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int o = tpr / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// float32 forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(const Args p) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(C::BQ * C::LDT);
  T* Ks = cv.take<T>(C::BK * C::LDT);
  T* Vs = cv.take<T>(C::BK * C::LDT);
  float* S = cv.take<float>(C::BQ * C::LDS);
  T* P = cv.take<T>(C::BQ * C::LDP);
  float* O = cv.take<float>(C::BQ * C::LDA);
  int* qseg_s = cv.take<int>(C::BQ);
  int* kseg_s = cv.take<int>(C::BK);

  const int64_t Tq = p.Tq, Tk = p.Tk, H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const int q0 = blockIdx.x * C::BQ;
  const int64_t goff_q = p.offs ? p.offs[2 * b] : 0;
  const int64_t goff_k = p.offs ? p.offs[2 * b + 1] : 0;
  const bool has_seg = p.qseg != nullptr;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = static_cast<int>(imin(C::BQ, Tq - q0));
  load_rows<T, D, C::BQ>(Qs, C::LDT, qb + q0 * p.q_st, p.q_st, q_valid);
  if (has_seg) load_vec(qseg_s, p.qseg + b * Tq + q0, q_valid, C::BQ);
  zero(O, C::BQ * C::LDA);

  const int r = threadIdx.x / C::TPR, sub = threadIdx.x % C::TPR;
  const int64_t qi = q0 + r;
  const int64_t qpos = goff_q + qi;
  float m = kNegInf, l = 0.0f;
  const int64_t q_last = goff_q + q0 + q_valid - 1;
  const int n_kt = static_cast<int>((Tk + C::BK - 1) / C::BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::BK;
    // causal: this and every later tile is masked for all rows
    if (p.causal && q_last < goff_k + k0) break;
    __syncthreads();  // the last tile's products are done with Ks, Vs, P
    const int k_valid = static_cast<int>(imin(C::BK, Tk - k0));
    load_rows<T, D, C::BK>(Ks, C::LDT, kb + k0 * p.k_st, p.k_st, k_valid);
    load_rows<T, D, C::BK>(Vs, C::LDT, vb + k0 * p.v_st, p.v_st, k_valid);
    if (has_seg) load_vec(kseg_s, p.kseg + b * Tk + k0, k_valid, C::BK);
    __syncthreads();
    TileMma<T, C::BQ, C::BK, D, true, false>::run(Qs, C::LDT, Ks, C::LDT, S,
                                                  C::LDS, false);
    __syncthreads();
    // online softmax over this tile's columns of row r
    const int qs = has_seg ? qseg_s[r] : 0;
    float sv[C::NC];
    uint32_t allow = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      const int c = sub + C::TPR * j;
      const int64_t ki = k0 + c;
      bool ok = ki < Tk;
      if (p.causal) ok = ok && qpos >= goff_k + ki;
      if (has_seg) ok = ok && qs == kseg_s[c];
      const float s = ok ? S[r * C::LDS + c] * scale : kNegInf;
      allow |= static_cast<uint32_t>(ok) << j;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = row_max(mx, C::TPR);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      const int c = sub + C::TPR * j;
      float pj = ((allow >> j) & 1u) ? expf(sv[j] - m_new) : 0.0f;
      sum += pj;
      if (p.dropout)
        pj = keep(static_cast<uint32_t>(p.seed), static_cast<uint32_t>(bh),
                  static_cast<uint32_t>(qpos),
                  static_cast<uint32_t>(goff_k + k0 + c),
                  static_cast<uint32_t>(p.thresh))
                 ? pj * inv_keep
                 : 0.0f;
      P[r * C::LDP + c] = static_cast<T>(pj);
    }
    sum = row_sum(sum, C::TPR);
    l = l * alpha + sum;
    m = m_new;
    for (int c = sub; c < D; c += C::TPR) O[r * C::LDA + c] *= alpha;
    __syncthreads();
    TileMma<T, C::BQ, D, C::BK, true, true>::run(P, C::LDP, Vs, C::LDT, O,
                                                 C::LDA, true);
  }
  __syncthreads();
  if (qi < Tq) {
    const bool empty = l == 0.0f;
    const float denom = empty ? 1.0f : l;
    T* orow = static_cast<T*>(p.out) + ((b * Tq + qi) * H + h) * D;
    for (int c = sub; c < D; c += C::TPR)
      orow[c] = static_cast<T>(O[r * C::LDA + c] / denom);
    if (sub == 0)
      p.lse[bh * Tq + qi] = empty ? kLseSentinel : m + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// float32 backward: the per-element step shared by dK/dV and dQ
// ---------------------------------------------------------------------------

// From S = Q K^T and dP = dO V^T of one (q tile, k tile): a = exp(s - lse)
// (0 where masked), dropout, ds = a (da - delta) scale (+ a glse scale).
// Writes ds (in T) to dS and, when Pd is not null, the dropped a to Pd.
template <typename T, int D>
__device__ void grad_step(const Args& p, const float* S, const float* dP,
                          T* dS, T* Pd, const float* lse_s,
                          const float* delta_s, const float* glse_s,
                          const int* qseg_s, const int* kseg_s, int64_t q0,
                          int64_t k0, int64_t goff_q, int64_t goff_k,
                          int64_t bh) {
  using C = Cfg<T, D>;
  const int r = threadIdx.x / C::TPR, sub = threadIdx.x % C::TPR;
  const int64_t qi = q0 + r, qpos = goff_q + qi;
  const bool row_ok = qi < p.Tq;
  const bool has_seg = p.qseg != nullptr;
  const int qs = has_seg ? qseg_s[r] : 0;
  const float scale = static_cast<float>(p.scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const float lse = lse_s[r], delta = delta_s[r];
  const float gl = p.glse ? glse_s[r] : 0.0f;
#pragma unroll
  for (int j = 0; j < C::NC; ++j) {
    const int c = sub + C::TPR * j;
    const int64_t ki = k0 + c;
    bool ok = row_ok && ki < p.Tk;
    if (p.causal) ok = ok && qpos >= goff_k + ki;
    if (has_seg) ok = ok && qs == kseg_s[c];
    const float a = ok ? expf(S[r * C::LDS + c] * scale - lse) : 0.0f;
    const float dp = dP[r * C::LDS + c];
    float a_drop = a, da = dp;
    if (p.dropout) {
      const bool kp = keep(static_cast<uint32_t>(p.seed),
                           static_cast<uint32_t>(bh),
                           static_cast<uint32_t>(qpos),
                           static_cast<uint32_t>(goff_k + ki),
                           static_cast<uint32_t>(p.thresh));
      a_drop = kp ? a * inv_keep : 0.0f;
      da = kp ? dp * inv_keep : 0.0f;
    }
    float ds = a * (da - delta) * scale;
    if (p.glse) ds = ds + a * gl * scale;
    dS[r * C::LDP + c] = static_cast<T>(ds);
    if (Pd != nullptr) Pd[r * C::LDP + c] = static_cast<T>(a_drop);
  }
}

// ---------------------------------------------------------------------------
// float32 dK / dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(const Args p) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(C::BK * C::LDT);
  T* Vs = cv.take<T>(C::BK * C::LDT);
  T* Qs = cv.take<T>(C::BQ * C::LDT);
  T* Gs = cv.take<T>(C::BQ * C::LDT);
  float* S = cv.take<float>(C::BQ * C::LDS);
  float* dP = cv.take<float>(C::BQ * C::LDS);
  T* Pd = cv.take<T>(C::BQ * C::LDP);
  T* dS = cv.take<T>(C::BQ * C::LDP);
  float* dK = cv.take<float>(C::BK * C::LDA);
  float* dV = cv.take<float>(C::BK * C::LDA);
  float* lse_s = cv.take<float>(C::BQ);
  float* delta_s = cv.take<float>(C::BQ);
  float* glse_s = cv.take<float>(C::BQ);
  int* qseg_s = cv.take<int>(C::BQ);
  int* kseg_s = cv.take<int>(C::BK);

  const int64_t Tq = p.Tq, Tk = p.Tk, H = p.H, Hk = p.Hk;
  const int64_t grp = H / Hk;
  const int64_t bhk = blockIdx.y, b = bhk / Hk, hk = bhk % Hk;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * C::BK;
  const int64_t goff_q = p.offs ? p.offs[2 * b] : 0;
  const int64_t goff_k = p.offs ? p.offs[2 * b + 1] : 0;
  const bool has_seg = p.qseg != nullptr;

  const int k_valid = static_cast<int>(imin(C::BK, Tk - k0));
  load_rows<T, D, C::BK>(
      Ks, C::LDT,
      static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + k0 * p.k_st,
      p.k_st, k_valid);
  load_rows<T, D, C::BK>(
      Vs, C::LDT,
      static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + k0 * p.v_st,
      p.v_st, k_valid);
  if (has_seg) load_vec(kseg_s, p.kseg + b * Tk + k0, k_valid, C::BK);
  zero(dK, C::BK * C::LDA);
  zero(dV, C::BK * C::LDA);

  const int n_qt = static_cast<int>((Tq + C::BQ - 1) / C::BQ);
  for (int64_t gi = 0; gi < grp; ++gi) {
    const int64_t h = hk * grp + gi, bh = b * H + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gb = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int64_t q0 = static_cast<int64_t>(qt) * C::BQ;
      const int q_valid = static_cast<int>(imin(C::BQ, Tq - q0));
      // causal: no row of this q tile sees the k tile's first key
      if (p.causal && goff_q + q0 + q_valid - 1 < goff_k + k0) continue;
      __syncthreads();  // the last q tile's products are done
      load_rows<T, D, C::BQ>(Qs, C::LDT, qb + q0 * p.q_st, p.q_st, q_valid);
      load_rows<T, D, C::BQ>(Gs, C::LDT, gb + q0 * p.g_st, p.g_st, q_valid);
      load_vec(lse_s, p.lse_in + bh * Tq + q0, q_valid, C::BQ);
      load_vec(delta_s, p.delta + bh * Tq + q0, q_valid, C::BQ);
      if (p.glse) load_vec(glse_s, p.glse + bh * Tq + q0, q_valid, C::BQ);
      if (has_seg) load_vec(qseg_s, p.qseg + b * Tq + q0, q_valid, C::BQ);
      __syncthreads();
      TileMma<T, C::BQ, C::BK, D, true, false>::run(Qs, C::LDT, Ks, C::LDT,
                                                    S, C::LDS, false);
      TileMma<T, C::BQ, C::BK, D, true, false>::run(Gs, C::LDT, Vs, C::LDT,
                                                    dP, C::LDS, false);
      __syncthreads();
      grad_step<T, D>(p, S, dP, dS, Pd, lse_s, delta_s, glse_s, qseg_s,
                      kseg_s, q0, k0, goff_q, goff_k, bh);
      __syncthreads();
      // dV += Pd^T dO, dK += dS^T Q (A read column-major from [BQ][BK])
      TileMma<T, C::BK, D, C::BQ, false, true>::run(Pd, C::LDP, Gs, C::LDT,
                                                    dV, C::LDA, true);
      TileMma<T, C::BK, D, C::BQ, false, true>::run(dS, C::LDP, Qs, C::LDT,
                                                    dK, C::LDA, true);
    }
  }
  __syncthreads();
  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
  for (int i = threadIdx.x; i < k_valid * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    const int64_t o = ((b * Tk + k0 + rr) * Hk + hk) * D + c;
    dkb[o] = static_cast<T>(dK[rr * C::LDA + c]);
    dvb[o] = static_cast<T>(dV[rr * C::LDA + c]);
  }
}

// ---------------------------------------------------------------------------
// float32 dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Args p) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(C::BQ * C::LDT);
  T* Gs = cv.take<T>(C::BQ * C::LDT);
  T* Ks = cv.take<T>(C::BK * C::LDT);
  T* Vs = cv.take<T>(C::BK * C::LDT);
  float* S = cv.take<float>(C::BQ * C::LDS);
  float* dP = cv.take<float>(C::BQ * C::LDS);
  T* dS = cv.take<T>(C::BQ * C::LDP);
  float* dQ = cv.take<float>(C::BQ * C::LDA);
  float* lse_s = cv.take<float>(C::BQ);
  float* delta_s = cv.take<float>(C::BQ);
  float* glse_s = cv.take<float>(C::BQ);
  int* qseg_s = cv.take<int>(C::BQ);
  int* kseg_s = cv.take<int>(C::BK);

  const int64_t Tq = p.Tq, Tk = p.Tk, H = p.H;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t hk = h / (H / p.Hk);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * C::BQ;
  const int64_t goff_q = p.offs ? p.offs[2 * b] : 0;
  const int64_t goff_k = p.offs ? p.offs[2 * b + 1] : 0;
  const bool has_seg = p.qseg != nullptr;

  const int q_valid = static_cast<int>(imin(C::BQ, Tq - q0));
  load_rows<T, D, C::BQ>(
      Qs, C::LDT,
      static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st,
      p.q_st, q_valid);
  load_rows<T, D, C::BQ>(
      Gs, C::LDT,
      static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh + q0 * p.g_st,
      p.g_st, q_valid);
  load_vec(lse_s, p.lse_in + bh * Tq + q0, q_valid, C::BQ);
  load_vec(delta_s, p.delta + bh * Tq + q0, q_valid, C::BQ);
  if (p.glse) load_vec(glse_s, p.glse + bh * Tq + q0, q_valid, C::BQ);
  if (has_seg) load_vec(qseg_s, p.qseg + b * Tq + q0, q_valid, C::BQ);
  zero(dQ, C::BQ * C::LDA);

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t q_last = goff_q + q0 + q_valid - 1;
  const int n_kt = static_cast<int>((Tk + C::BK - 1) / C::BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * C::BK;
    if (p.causal && q_last < goff_k + k0) break;
    __syncthreads();  // the last tile's products are done with Ks, dS
    const int k_valid = static_cast<int>(imin(C::BK, Tk - k0));
    load_rows<T, D, C::BK>(Ks, C::LDT, kb + k0 * p.k_st, p.k_st, k_valid);
    load_rows<T, D, C::BK>(Vs, C::LDT, vb + k0 * p.v_st, p.v_st, k_valid);
    if (has_seg) load_vec(kseg_s, p.kseg + b * Tk + k0, k_valid, C::BK);
    __syncthreads();
    TileMma<T, C::BQ, C::BK, D, true, false>::run(Qs, C::LDT, Ks, C::LDT, S,
                                                  C::LDS, false);
    TileMma<T, C::BQ, C::BK, D, true, false>::run(Gs, C::LDT, Vs, C::LDT, dP,
                                                  C::LDS, false);
    __syncthreads();
    grad_step<T, D>(p, S, dP, dS, static_cast<T*>(nullptr), lse_s, delta_s,
                    glse_s, qseg_s, kseg_s, q0, k0, goff_q, goff_k, bh);
    __syncthreads();
    TileMma<T, C::BQ, D, C::BK, true, true>::run(dS, C::LDP, Ks, C::LDT, dQ,
                                                 C::LDA, true);
  }
  __syncthreads();
  T* dqb = static_cast<T*>(p.dq);
  for (int i = threadIdx.x; i < q_valid * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    dqb[((b * Tq + q0 + rr) * H + h) * D + c] =
        static_cast<T>(dQ[rr * C::LDA + c]);
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) fwd_tc_kernel(const Args p) {
  constexpr int BQ = kTcRows, BK = kTcCols, LD = D + 8;
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

template <typename Kern>
cudaError_t launch_kernel(Kern kernel, dim3 grid, int threads, size_t bytes,
                          const Args& a, cudaStream_t s, int device,
                          bool* done) {
  cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// float32 takes the CUDA-core kernels, bf16/fp16 the tensor-core ones
struct Fwd {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bh = static_cast<unsigned>(a.B * a.H);
    if constexpr (std::is_same<T, float>::value) {
      using C = Cfg<T, D>;
      return launch_kernel(fwd_f32_kernel<T, D>,
                           dim3((a.Tq + C::BQ - 1) / C::BQ, bh), kThreads,
                           Smem<T, D>::fwd, a, s, device, done);
    } else {
      return launch_kernel(fwd_tc_kernel<T, D>,
                           dim3((a.Tq + kTcRows - 1) / kTcRows, bh),
                           kTcThreads, TcSmem<T, D>::fwd, a, s, device, done);
    }
  }
};

struct Dkv {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bhk = static_cast<unsigned>(a.B * a.Hk);
    if constexpr (std::is_same<T, float>::value) {
      using C = Cfg<T, D>;
      return launch_kernel(dkv_f32_kernel<T, D>,
                           dim3((a.Tk + C::BK - 1) / C::BK, bhk), kThreads,
                           Smem<T, D>::dkv, a, s, device, done);
    } else {
      return launch_kernel(dkv_tc_kernel<T, D>,
                           dim3((a.Tk + kTcRows - 1) / kTcRows, bhk),
                           kTcThreads, TcSmem<T, D>::dkv, a, s, device, done);
    }
  }
};

struct Dq {
  template <typename T, int D>
  static cudaError_t run(const Args& a, cudaStream_t s, int device) {
    static bool done[kMaxDevices] = {};
    const unsigned bh = static_cast<unsigned>(a.B * a.H);
    if constexpr (std::is_same<T, float>::value) {
      using C = Cfg<T, D>;
      return launch_kernel(dq_f32_kernel<T, D>,
                           dim3((a.Tq + C::BQ - 1) / C::BQ, bh), kThreads,
                           Smem<T, D>::dq, a, s, device, done);
    } else {
      return launch_kernel(dq_tc_kernel<T, D>,
                           dim3((a.Tq + kTcRows - 1) / kTcRows, bh),
                           kTcThreads, TcSmem<T, D>::dq, a, s, device, done);
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
