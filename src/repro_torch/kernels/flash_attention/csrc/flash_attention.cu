// Flash attention for Hopper (sm_90a), float32 on the CUDA cores: the causal
// / windowed GQA forward with an online softmax, and its gradient.
//
// Replaces, for float32 inputs, the Pallas TPU kernel src/repro/kernels/
// flash_attention/flash_attention.py:24-121 (`_fa_kernel`,
// `flash_attention_fwd`); bfloat16 runs on flash_attention_tc.cu.  The JAX
// package has no gradient kernel: JAX differentiates the blockwise jnp loop
// of src/repro/models/layers.py:109 (`flash_attention`), rematerialising the
// scores per block.  The gradient here computes that derivative.
//
// Layout (the TPU kernel's): q, o [BH, G, Tq, Dh]; k, v [BH, Tk, Dh] (one
// KV head per BH row, G query heads sharing it); lse, D [BH, G, Tq] float32.
// q, k, v, o and the gradients are float32.  Tq and Tk are independent
// (cross-attention, a ragged cache); the causal mask is the reference's
// top-left one, q >= k with both counted from 0.
//
// Forward, one CTA of 256 threads per (bh, g, block of 64 query rows).  The
// TPU walked a sequential (BH, G, nq, nk) grid and carried m, l and the
// accumulator in VMEM scratch across the kv axis; here a loop over 64-key
// blocks inside the CTA carries them: warp w owns query rows 8w..8w+7, and
// every lane of the warp holds their running max m and sum l (reduced with
// shuffles) and an 8 x ceil(Dh/32) slice of the float32 accumulator.  Each
// K/V block is staged in shared memory as float32, once per CTA.
//   * scores q.k are float32, times Dh^-0.5,
//     masked to the finite -1e30 (causal: q >= k; window w > 0: q - k < w)
//     and to -inf past Tk; p = exp(s - m_new) is rounded to v's dtype before the
//     p.v product (the TPU kernel's `p.astype(v.dtype)`), l sums p unrounded;
//     o = acc / max(l, 1e-30) in q's dtype; lse = m + log(l) in float32.
//   * the loop visits only the kv blocks that the mask leaves non-empty for
//     some row of the q block.  That cannot change the result: a block that
//     is empty for a row adds exp(-1e30 - m) = 0 once the row has seen a
//     valid key, and before that (p = 1 on every masked key, as in the
//     reference) the first valid block's correction exp(-1e30 - m_new) = 0
//     clears it.
//   * a row that sees no key at all (only with a window and Tq > Tk: rows
//     at and past Tk - 1 + window) gets what the reference gives it, the
//     mean of V over all Tk keys: every key is masked to the same -1e30, so
//     p = 1 on each of them, and -inf past Tk keeps the padding out.  A q
//     block holding such rows visits every kv block.  In the gradient these
//     rows have dS = 0 (no dQ, dK) and P = 1 / Tk on every key, so they add
//     one vector, (1 / Tk) sum of their dO, to every dV row: the pre-pass
//     sums it and the dK/dV epilogue adds it.
//   * Tq and Tk need not be multiples of 64: rows past Tq and keys past Tk
//     are masked and never written.
//
// Gradient (FlashAttention-2's), three launches, no float atomics, so it is
// deterministic:
//   1. D = rowsum(dO * O) per query row (one warp per row), and where rows
//      see no key, the sum of their dO per bh (one more CTA per bh);
//   2. dK, dV: one CTA per (bh, block of 32 keys).  It loops over the G
//      query heads and the 64-row q blocks that see its keys (none for the
//      keys at and past Tq when causal with Tk > Tq: their dK and dV are
//      written as zeros), recomputes
//      P = exp(s - lse), dP = dO.v, dS = P (dP - D), and sums
//      dV += P^T dO and dK += scale dS^T Q in registers;
//   3. dQ: one CTA per (bh, g, block of 32 query rows), looping over the kv
//      blocks the forward visits: dQ += scale dS K.
//
// Head dims past MAX_DH (256) run as column chunks: ceil(Dh / 256) chunks
// of at most 256 output columns, on a grid axis of their own (the forward
// and dQ kernels' y = G * chunks, the dK/dV kernel's z), the `WIDE`
// instantiation of each kernel.  Every CTA of a row block computes the
// scores (and dP = dO.V) over the whole Dh, reducing Q.K in pieces of 256
// columns staged one after another through the same shared tiles, in the
// same order in every chunk, so every chunk sees the same scores, softmax
// statistics and P bit for bit; it then accumulates only its own columns of
// O (forward), dQ, or dK and dV, reloading its chunk of K (dQ) or of Q and
// dO (dK/dV) after the pieces where the last piece is not its own.  Nothing
// crosses CTAs, so there are no float atomics and two calls give the same
// bits.  Shared memory and registers stay those of Dh 256 (a piece is a
// Dh-256 tile); the Dh <= 256 instantiations (one piece, one chunk, Q or
// K/V resident across the loop) are the kernels as they were.  The cost is
// reading Q.K's pieces (and Q or K/V) once per chunk and per kv block:
// right, not fast.
//
// Bound: operations.  At the training path's shape (B 2, Hkv 8, G 4, T 4096,
// Dh 128, causal) the forward does 2.7e11 multiply-add FLOPs on 335 MB of
// float32 inputs and outputs: 4.0 ms at the CUDA cores' 67 TFLOP/s float32
// peak.  The products run in exact float32 on the CUDA cores (which the
// float32 tolerances need; TF32 tensor cores would not hold them) from
// shared-memory tiles, 8 x 2 scores or 8 x 8 accumulator cells per thread.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (repro_torch/kernels/
// flash_attention/ops.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 256;           // columns of a staged piece and of an output chunk
constexpr int NC = MAX_DH / 32;       // accumulator columns per lane
constexpr float NEG_INF = -1e30f;

constexpr int F_Q = 64;               // forward: query rows per CTA
constexpr int F_K = 64;               //          keys per block
constexpr int Q_Q = 32;               // dQ: query rows per CTA
constexpr int Q_K = 64;               //     keys per block
constexpr int K_K = 32;               // dK/dV: keys per CTA
constexpr int K_Q = 64;               //        query rows per block
constexpr int LDP = 64 + 4;           // row stride of the P / dS tiles

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Four consecutive elements (the row start is a multiple of 4 elements and
// the wrapper checks 16-byte aligned bases) as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Built on the host and passed by value, so its fields sit in the kernel
// parameters' constant bank, not in registers.
struct Mask {
  int Tq, Tk, causal, window;
  int blind;        // the first query row that sees no key (Tq where none does)
  float inv_tk;     // 1 / Tk: such a row's P on every key (dV)
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    return kp < Tk && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
  }
  // the keys [lo, hi] that query rows [q_lo, q_hi] visit: all of them where
  // a row sees none
  __device__ __forceinline__ int key_lo(int q_lo, int q_hi) const {
    return window > 0 && q_hi < blind ? max(0, q_lo - window + 1) : 0;
  }
  __device__ __forceinline__ int key_hi(int q_hi) const {
    return causal ? min(q_hi, Tk - 1) : Tk - 1;
  }
  // the query rows [lo, hi] that see keys [k_lo, k_hi]
  __device__ __forceinline__ int query_lo(int k_lo) const { return causal ? k_lo : 0; }
  __device__ __forceinline__ int query_hi(int k_hi) const {
    return window > 0 ? min(Tq - 1, k_hi + window - 1) : Tq - 1;
  }
};

Mask make_mask(int Tq, int Tk, int causal, int window) {
  const int blind = window > 0 && window <= Tq - Tk ? Tk - 1 + window : Tq;
  return Mask{Tq, Tk, causal, window, blind, 1.f / Tk};
}

// columns [c0, c0 + w) of rows [row0, row0 + rows) of a [T, Dh] matrix
// into shared memory [rows][ld] as float32, zeros past T (w and c0 are
// multiples of 4)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int row0,
                                          int rows, int Tn, int Dh, int c0, int w) {
  const int q4 = w >> 2;
  for (int i = threadIdx.x; i < rows * q4; i += THREADS) {
    const int r = i / q4, c = (i - r * q4) << 2;
    const int gr = row0 + r;
    const float4 x = gr < Tn ? load4(src + (size_t)gr * Dh + c0 + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// A CTA's share of the head dim: `np` pieces of at most MAX_DH columns that
// the scores reduce over, and its own output chunk [c0, c0 + wc).  WIDE is
// false for Dh <= MAX_DH: one piece, the whole of Dh.
template <bool WIDE>
struct Cols {
  int ld, np, c0, wc;
  __device__ __forceinline__ Cols(int Dh, int chunk)
      : ld((WIDE ? MAX_DH : Dh) + 4), np(WIDE ? (Dh + MAX_DH - 1) / MAX_DH : 1),
        c0(WIDE ? chunk * MAX_DH : 0), wc(WIDE ? min(MAX_DH, Dh - chunk * MAX_DH) : Dh) {}
  __device__ __forceinline__ int width(int Dh, int p) const {
    return WIDE ? min(MAX_DH, Dh - p * MAX_DH) : Dh;
  }
  // whether the last piece staged is this CTA's own chunk
  __device__ __forceinline__ bool own_last() const { return c0 == (np - 1) * MAX_DH; }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
fa_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                  int G, int Dh, Mask mask, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Tq = mask.Tq, Tk = mask.Tk;
  const int nch = WIDE ? (Dh + MAX_DH - 1) / MAX_DH : 1;
  const int g = WIDE ? blockIdx.y / nch : blockIdx.y;
  const Cols<WIDE> cols(Dh, blockIdx.y - g * nch);
  const int ld = cols.ld;
  float* Qs = smem;                   // [F_Q][ld]
  float* Ks = Qs + F_Q * ld;          // [F_K][ld]
  float* Vs = Ks + F_K * ld;          // [F_K][ld]  this CTA's chunk of V
  float* Ps = Vs + F_K * ld;          // [F_Q][LDP]  p, rounded to T

  constexpr int R = F_Q / WARPS;      // query rows per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * F_Q, bh = blockIdx.z;
  const int r0 = warp * R;
  const size_t qrow0 = ((size_t)bh * G + g) * Tq;
  const T* qh = q + qrow0 * Dh;
  const T* kh = k + (size_t)bh * Tk * Dh;
  const T* vh = v + (size_t)bh * Tk * Dh;

  if (!WIDE) load_tile(Qs, ld, qh, q0, F_Q, Tq, Dh, 0, Dh);

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int q_hi = min(q0 + F_Q, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / F_K, kb1 = mask.key_hi(q_hi) / F_K;
  for (int kb = kb0; kb <= kb1; ++kb) {
    const int k0 = kb * F_K;
    float s[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = 0.f;
    for (int p = 0; p < cols.np; ++p) {   // the scores, a piece of Dh at a time
      const int p0 = p * MAX_DH, w = cols.width(Dh, p);
      __syncthreads();                // the previous piece's (block's) tiles are consumed
      if (WIDE) load_tile(Qs, ld, qh, q0, F_Q, Tq, Dh, p0, w);
      load_tile(Ks, ld, kh, k0, F_K, Tk, Dh, p0, w);
      if (p == cols.np - 1) load_tile(Vs, ld, vh, k0, F_K, Tk, Dh, cols.c0, cols.wc);
      __syncthreads();
      for (int d = 0; d < w; d += 4) {
        const float4 ka = load4(Ks + lane * ld + d);
        const float4 kc = load4(Ks + (lane + 32) * ld + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = load4(Qs + (r0 + r) * ld + d);
          s[r][0] = dot4(qv, ka, s[r][0]);
          s[r][1] = dot4(qv, kc, s[r][1]);
        }
      }
    }

    float corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        s[r][j] = mask.ok(qp, kp) ? s[r][j] * scale : kp < Tk ? NEG_INF : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      Ps[(r0 + r) * LDP + lane] = to_f32(from_f32<T>(p0));
      Ps[(r0 + r) * LDP + lane + 32] = to_f32(from_f32<T>(p1));
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr[r];
    for (int j = 0; j < F_K; j += 4) {
      float4 pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pr[r] = load4(Ps + (r0 + r) * LDP + j);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < cols.wc) {
          const float v0 = Vs[j * ld + d], v1 = Vs[(j + 1) * ld + d];
          const float v2 = Vs[(j + 2) * ld + d], v3 = Vs[(j + 3) * ld + d];
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r][c] = dot4(pr[r], make_float4(v0, v1, v2, v3), acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + (qrow0 + qp) * Dh + cols.c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < cols.wc) orow[d] = from_f32<T>(acc[r][c] / den);
    }
    if (lane == 0 && cols.c0 == 0) lse[qrow0 + qp] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// gradient
// ---------------------------------------------------------------------------

// D[row] = sum_d dO[row, d] * O[row, d], one warp per row; the CTAs past the
// rows' (one per bh, launched only where some query row sees no key) sum dO
// over those rows of all G heads, in order, into colsum [BH, Dh]
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_rowdot_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                 float* __restrict__ D, long long rows, int Dh, float* __restrict__ colsum,
                 int G, Mask mask) {
  const long long row_blocks = (rows + WARPS - 1) / WARPS;
  if (blockIdx.x >= row_blocks) {
    const int bh = (int)(blockIdx.x - row_blocks);
    for (int d = threadIdx.x; d < Dh; d += THREADS) {
      float acc = 0.f;
      for (int g = 0; g < G; ++g) {
        const T* col = dout + (size_t)(bh * G + g) * mask.Tq * Dh + d;
        for (int i = mask.blind; i < mask.Tq; ++i) acc += to_f32(col[(size_t)i * Dh]);
      }
      colsum[(size_t)bh * Dh + d] = acc;
    }
    return;
  }
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = dout + row * Dh;
  const T* b = out + row * Dh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc = fmaf(to_f32(a[d]), to_f32(b[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) D[row] = acc;
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ D, T* __restrict__ dq, int G, int Dh,
             Mask mask, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Tq = mask.Tq, Tk = mask.Tk;
  const int nch = WIDE ? (Dh + MAX_DH - 1) / MAX_DH : 1;
  const int g = WIDE ? blockIdx.y / nch : blockIdx.y;
  const Cols<WIDE> cols(Dh, blockIdx.y - g * nch);
  const int ld = cols.ld;
  float* Qs = smem;                   // [Q_Q][ld]
  float* dOs = Qs + Q_Q * ld;         // [Q_Q][ld]
  float* Ks = dOs + Q_Q * ld;         // [Q_K][ld]
  float* Vs = Ks + Q_K * ld;          // [Q_K][ld]
  float* dSs = Vs + Q_K * ld;         // [Q_Q][LDP]

  constexpr int R = Q_Q / WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * Q_Q, bh = blockIdx.z;
  const int r0 = warp * R;
  const size_t qrow0 = ((size_t)bh * G + g) * Tq;
  const T* qh = q + qrow0 * Dh;
  const T* gh = dout + qrow0 * Dh;
  const T* kh = k + (size_t)bh * Tk * Dh;
  const T* vh = v + (size_t)bh * Tk * Dh;

  if (!WIDE) {
    load_tile(Qs, ld, qh, q0, Q_Q, Tq, Dh, 0, Dh);
    load_tile(dOs, ld, gh, q0, Q_Q, Tq, Dh, 0, Dh);
  }
  float lse_r[R], d_r[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = min(q0 + r0 + r, Tq - 1);
    lse_r[r] = lse[qrow0 + qp];
    d_r[r] = D[qrow0 + qp];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int q_hi = min(q0 + Q_Q, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / Q_K, kb1 = mask.key_hi(q_hi) / Q_K;
  for (int kb = kb0; kb <= kb1; ++kb) {
    const int k0 = kb * Q_K;
    float s[R][2], dp[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int p = 0; p < cols.np; ++p) {   // s = Q.K and dP = dO.V, a piece of Dh at a time
      const int p0 = p * MAX_DH, w = cols.width(Dh, p);
      __syncthreads();
      if (WIDE) {
        load_tile(Qs, ld, qh, q0, Q_Q, Tq, Dh, p0, w);
        load_tile(dOs, ld, gh, q0, Q_Q, Tq, Dh, p0, w);
      }
      load_tile(Ks, ld, kh, k0, Q_K, Tk, Dh, p0, w);
      load_tile(Vs, ld, vh, k0, Q_K, Tk, Dh, p0, w);
      __syncthreads();
      for (int d = 0; d < w; d += 4) {
        const float4 ka = load4(Ks + lane * ld + d), kc = load4(Ks + (lane + 32) * ld + d);
        const float4 va = load4(Vs + lane * ld + d), vc = load4(Vs + (lane + 32) * ld + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = load4(Qs + (r0 + r) * ld + d);
          const float4 gv = load4(dOs + (r0 + r) * ld + d);
          s[r][0] = dot4(qv, ka, s[r][0]);
          s[r][1] = dot4(qv, kc, s[r][1]);
          dp[r][0] = dot4(gv, va, dp[r][0]);
          dp[r][1] = dot4(gv, vc, dp[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        const float p = mask.ok(qp, kp) ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        dSs[(r0 + r) * LDP + lane + 32 * j] = p * (dp[r][j] - d_r[r]);
      }
    }
    __syncwarp();
    if (WIDE && !cols.own_last()) {   // this CTA's chunk of K for dS.K
      __syncthreads();
      load_tile(Ks, ld, kh, k0, Q_K, Tk, Dh, cols.c0, cols.wc);
      __syncthreads();
    }
    for (int j = 0; j < Q_K; j += 4) {
      float4 ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = load4(dSs + (r0 + r) * LDP + j);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < cols.wc) {
          const float4 kv = make_float4(Ks[j * ld + d], Ks[(j + 1) * ld + d],
                                        Ks[(j + 2) * ld + d], Ks[(j + 3) * ld + d]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][c] = dot4(ds[r], kv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Tq) continue;
    T* row = dq + (qrow0 + qp) * Dh + cols.c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < cols.wc) row[d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
fa_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, const float* __restrict__ colsum,
               T* __restrict__ dk, T* __restrict__ dv, int G, int Dh, Mask mask,
               float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Tq = mask.Tq, Tk = mask.Tk;
  const Cols<WIDE> cols(Dh, blockIdx.z);
  const int ld = cols.ld;
  float* Ks = smem;                   // [K_K][ld]
  float* Vs = Ks + K_K * ld;          // [K_K][ld]
  float* Qs = Vs + K_K * ld;          // [K_Q][ld]
  float* dOs = Qs + K_Q * ld;         // [K_Q][ld]
  float* Ps = dOs + K_Q * ld;         // [K_K][LDP]  P^T
  float* dSs = Ps + K_K * LDP;        // [K_K][LDP]  dS^T
  float* lse_s = dSs + K_K * LDP;     // [K_Q]
  float* D_s = lse_s + K_Q;           // [K_Q]

  constexpr int R = K_K / WARPS;      // key rows per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * K_K, bh = blockIdx.y;
  const int r0 = warp * R;
  const size_t krow0 = (size_t)bh * Tk;
  const T* kh = k + krow0 * Dh;
  const T* vh = v + krow0 * Dh;

  if (!WIDE) {
    load_tile(Ks, ld, kh, k0, K_K, Tk, Dh, 0, Dh);
    load_tile(Vs, ld, vh, k0, K_K, Tk, Dh, 0, Dh);
  }
  float dkacc[R][NC], dvacc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dkacc[r][c] = dvacc[r][c] = 0.f;

  const int k_hi = min(k0 + K_K, Tk) - 1;
  const int qb0 = mask.query_lo(k0) / K_Q, qb1 = mask.query_hi(k_hi) / K_Q;
  for (int g = 0; g < G; ++g) {
    const size_t qrow0 = ((size_t)bh * G + g) * Tq;
    const T* qh = q + qrow0 * Dh;
    const T* gh = dout + qrow0 * Dh;
    for (int qb = qb0; qb <= qb1; ++qb) {
      const int q0 = qb * K_Q;
      // s^T[key r][query i] = k_r . q_i; dp^T[r][i] = v_r . dO_i, for the
      // queries i = lane and lane + 32, a piece of Dh at a time
      float s[R][2], dp[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
      for (int p = 0; p < cols.np; ++p) {
        const int p0 = p * MAX_DH, w = cols.width(Dh, p);
        __syncthreads();
        if (WIDE) {
          load_tile(Ks, ld, kh, k0, K_K, Tk, Dh, p0, w);
          load_tile(Vs, ld, vh, k0, K_K, Tk, Dh, p0, w);
        }
        load_tile(Qs, ld, qh, q0, K_Q, Tq, Dh, p0, w);
        load_tile(dOs, ld, gh, q0, K_Q, Tq, Dh, p0, w);
        if (p == 0 && threadIdx.x < K_Q) {
          const int qp = min(q0 + (int)threadIdx.x, Tq - 1);
          lse_s[threadIdx.x] = lse[qrow0 + qp];
          D_s[threadIdx.x] = D[qrow0 + qp];
        }
        __syncthreads();
        for (int d = 0; d < w; d += 4) {
          const float4 qa = load4(Qs + lane * ld + d), qc = load4(Qs + (lane + 32) * ld + d);
          const float4 ga = load4(dOs + lane * ld + d), gc = load4(dOs + (lane + 32) * ld + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 kv = load4(Ks + (r0 + r) * ld + d);
            const float4 vv = load4(Vs + (r0 + r) * ld + d);
            s[r][0] = dot4(kv, qa, s[r][0]);
            s[r][1] = dot4(kv, qc, s[r][1]);
            dp[r][0] = dot4(vv, ga, dp[r][0]);
            dp[r][1] = dot4(vv, gc, dp[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kp = k0 + r0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = lane + 32 * j;
          const int qp = q0 + i;
          const float p = (qp < Tq && mask.ok(qp, kp))
                              ? expf(s[r][j] * scale - lse_s[i]) : 0.f;
          Ps[(r0 + r) * LDP + i] = p;
          dSs[(r0 + r) * LDP + i] = p * (dp[r][j] - D_s[i]);
        }
      }
      __syncwarp();
      if (WIDE && !cols.own_last()) {   // this CTA's chunk of Q and dO
        __syncthreads();
        load_tile(Qs, ld, qh, q0, K_Q, Tq, Dh, cols.c0, cols.wc);
        load_tile(dOs, ld, gh, q0, K_Q, Tq, Dh, cols.c0, cols.wc);
        __syncthreads();
      }
      for (int i = 0; i < K_Q; i += 4) {
        float4 pr[R], ds[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pr[r] = load4(Ps + (r0 + r) * LDP + i);
          ds[r] = load4(dSs + (r0 + r) * LDP + i);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < cols.wc) {
            const float4 gv = make_float4(dOs[i * ld + d], dOs[(i + 1) * ld + d],
                                          dOs[(i + 2) * ld + d], dOs[(i + 3) * ld + d]);
            const float4 qv = make_float4(Qs[i * ld + d], Qs[(i + 1) * ld + d],
                                          Qs[(i + 2) * ld + d], Qs[(i + 3) * ld + d]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              dvacc[r][c] = dot4(pr[r], gv, dvacc[r][c]);
              dkacc[r][c] = dot4(ds[r], qv, dkacc[r][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Tk) continue;
    T* krow = dk + (krow0 + kp) * Dh + cols.c0;
    T* vrow = dv + (krow0 + kp) * Dh + cols.c0;
    const float* csum = colsum + (size_t)bh * Dh + cols.c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < cols.wc) {
        // rows that see no key: P = 1 / Tk on every key
        const float blind = mask.blind < Tq ? mask.inv_tk * csum[d] : 0.f;
        krow[d] = from_f32<T>(dkacc[r][c] * scale);
        vrow[d] = from_f32<T>(dvacc[r][c] + blind);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// shared memory of a CTA at head dim Dh (a piece of MAX_DH columns past it)
int tile_dh(int Dh) { return Dh > MAX_DH ? MAX_DH : Dh; }
int chunks(int Dh) { return (Dh + MAX_DH - 1) / MAX_DH; }
size_t fwd_smem(int Dh) {
  return sizeof(float) * ((size_t)(F_Q + 2 * F_K) * (tile_dh(Dh) + 4) + F_Q * LDP);
}
size_t dq_smem(int Dh) {
  return sizeof(float) * ((size_t)(2 * Q_Q + 2 * Q_K) * (tile_dh(Dh) + 4) + Q_Q * LDP);
}
size_t dkdv_smem(int Dh) {
  return sizeof(float) * ((size_t)(2 * K_K + 2 * K_Q) * (tile_dh(Dh) + 4) + 2 * K_K * LDP +
                          2 * K_Q);
}

template <typename T, bool WIDE>
cudaError_t forward(const void* q, const void* k, const void* v, void* o, float* lse,
                    int BH, int G, int Dh, Mask mask, float scale, cudaStream_t st) {
  auto kern = fa_forward_kernel<T, WIDE>;
  const size_t smem = fwd_smem(Dh);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((mask.Tq + F_Q - 1) / F_Q, G * chunks(Dh), BH);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), lse, G,
                                    Dh, mask, scale);
  return cudaGetLastError();
}

template <typename T, bool WIDE>
cudaError_t backward(const void* q, const void* k, const void* v, const void* o,
                     const float* lse, const void* dout, void* dq, void* dk, void* dv,
                     float* D, int BH, int G, int Dh, Mask mask, float scale,
                     cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = (long long)BH * G * mask.Tq;
  float* colsum = D + rows;
  const long long blocks = (rows + WARPS - 1) / WARPS + (mask.blind < mask.Tq ? BH : 0);
  fa_rowdot_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      gt, static_cast<const T*>(o), D, rows, Dh, colsum, G, mask);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kkv = fa_dkdv_kernel<T, WIDE>;
  size_t smem = dkdv_smem(Dh);
  if ((e = set_smem(kkv, smem)) != cudaSuccess) return e;
  kkv<<<dim3((mask.Tk + K_K - 1) / K_K, BH, chunks(Dh)), THREADS, smem, st>>>(
      qt, kt, vt, gt, lse, D, colsum, static_cast<T*>(dk), static_cast<T*>(dv), G, Dh,
      mask, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto kq = fa_dq_kernel<T, WIDE>;
  smem = dq_smem(Dh);
  if ((e = set_smem(kq, smem)) != cudaSuccess) return e;
  kq<<<dim3((mask.Tq + Q_Q - 1) / Q_Q, G * chunks(Dh), BH), THREADS, smem, st>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dq), G, Dh, mask, scale);
  return cudaGetLastError();
}

// the grid's y axis holds G x chunks(Dh)
bool bad_shape(int BH, int G, int Tq, int Tk, int Dh, int dtype) {
  return BH < 1 || BH > 65535 || G < 1 || Tq < 1 || Tk < 1 || Dh < 4 || (Dh & 3) != 0 ||
         (long long)G * chunks(Dh) > 65535 || dtype != 0;
}

template <typename T>
cudaError_t forward_any(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int G, int Dh, Mask mask, float scale, cudaStream_t st) {
  return Dh > MAX_DH ? forward<T, true>(q, k, v, o, lse, BH, G, Dh, mask, scale, st)
                     : forward<T, false>(q, k, v, o, lse, BH, G, Dh, mask, scale, st);
}

template <typename T>
cudaError_t backward_any(const void* q, const void* k, const void* v, const void* o,
                         const float* lse, const void* dout, void* dq, void* dk, void* dv,
                         float* D, int BH, int G, int Dh, Mask mask, float scale,
                         cudaStream_t st) {
  return Dh > MAX_DH
             ? backward<T, true>(q, k, v, o, lse, dout, dq, dk, dv, D, BH, G, Dh, mask,
                                 scale, st)
             : backward<T, false>(q, k, v, o, lse, dout, dq, dk, dv, D, BH, G, Dh, mask,
                                  scale, st);
}

}  // namespace

// dtype: 0, float32 (q, k, v, o and the gradients; bfloat16 runs on
// flash_attention_tc.cu's fa_tc_forward / fa_tc_backward, which share this
// interface); causal 0/1; window <= 0 means none; scale is Dh^-0.5 rounded
// to float32.  Returns 0 or a cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                          int BH, int G, int Tq, int Tk, int Dh, int dtype, int causal,
                          int window, float scale, void* stream) {
  if (bad_shape(BH, G, Tq, Tk, Dh, dtype)) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(Tq, Tk, causal, window);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)forward_any<float>(q, k, v, o, l, BH, G, Dh, mask, scale, s);
}

// D is float32 scratch of BH * G * Tq + BH * Dh elements.
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, void* dq, void* dk, void* dv,
                           void* D, int BH, int G, int Tq, int Tk, int Dh, int dtype,
                           int causal, int window, float scale, void* stream) {
  if (bad_shape(BH, G, Tq, Tk, Dh, dtype)) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(Tq, Tk, causal, window);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)backward_any<float>(q, k, v, o, l, dout, dq, dk, dv, d, BH, G, Dh, mask,
                                  scale, s);
}
