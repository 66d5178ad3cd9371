// Flash attention on Hopper's tensor cores (sm_90a, bfloat16): the causal /
// windowed GQA forward with an online softmax, and its gradient.
//
// Replaces, for bfloat16 inputs at every head dim, the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:24-121 (`_fa_kernel`,
// `flash_attention_fwd`) and JAX's autodiff of the blockwise loop
// src/repro/models/layers.py:109 (`flash_attention`).  The bodies are
// instantiated at Dh 16, 32, 64, 80, 96, 112, 128 and 256, and past 256 at
// any multiple of 128 (the wide bodies below); the wrapper zero-pads any
// other head dim to the least of these at or above it, with the true head
// dim's scale (exact: zero columns add nothing to Q K^T, and the padded
// columns of O and of the gradients are dropped).  float32 stays on the
// CUDA-core kernels of flash_attention.cu, whose float32 arithmetic holds the
// float32 tolerances; this file has the same layout, the same mask and the
// same results up to bfloat16 rounding of P and dS.
//
// Layout: q, o [BH, G, Tq, Dh]; k, v [BH, Tk, Dh] (one KV head per BH row, G
// query heads sharing it); lse, D [BH, G, Tq] float32.  Tq and Tk are
// independent; the causal mask is the reference's top-left one (q >= k).
//
// Bound: operations.  At the training path's shape (B 2, Hkv 8, G 4, T 4096,
// Dh 128, causal) the forward does 2.7e11 FLOPs (0.28 ms at the 989 TFLOP/s
// bf16 tensor-core peak), the gradient 6.9e11 (0.70 ms); at Dh 512 (B 1, Hkv
// 8, G 4, T 1024) 3.4e10 and 8.6e10 FLOPs on 84 and 168 MB of inputs and
// outputs.  So every product runs on the tensor cores with bf16 operands and
// f32 accumulators in registers.  The forward at Dh 128 (the training
// path's) uses Hopper's `wgmma` with K/V brought by TMA into an mbarrier ring (see
// fa_tc_forward_kernel_wgmma below).  The forward at the other head dims and
// the gradient use `mma.sync.m16n8k16`, operands brought from shared memory
// with `ldmatrix` (`.trans` for the operands that are used transposed).  Their
// tiles are staged as bf16 in shared memory with an XOR swizzle of 16-byte
// chunks (chunk c of row r sits at c ^ (r & 7) within its 128-byte group), so
// the eight rows that one `ldmatrix` reads fall in distinct banks, and are
// copied with `cp.async` into two stages: the next tile's copy overlaps the
// products on the current one.
//
// Registers and shared memory set the widths.  At Dh 256 a warp's 16 rows of
// the O accumulator take 128 of its 255 registers, and one stage of Q, K and
// V at Dh 512 would take 192 KB of the 227 KB of shared memory.  So past
// 256 (the wide bodies, `fa_tc_*_kernel_wide`) no tile holds a whole row:
// the reductions over Dh (Q K^T, dO V^T) run in 128-column pieces through
// the two-stage ring, and the outputs split into chunks of 256 columns, a
// grid axis of their own, each CTA accumulating its chunk after the last
// piece; every chunk reduces the pieces in the same order, so P and lse are
// the same bits in each.  The price is S (and dP) recomputed per chunk.
//
// Forward (mma.sync), one CTA of 8 warps per (bh, g, block of 128 query
// rows), heaviest causal blocks first.  Warp w owns rows 16w..16w+15; their Q
// fragments stay in registers for the whole key loop (Dh <= 128; re-read from
// shared memory at Dh 256).  Per block of BN keys (128, or 64 at Dh 256): S = Q K^T on the
// tensor cores; scale, mask and the online softmax on the accumulator
// fragments (the four lanes that share a row reduce with two shuffles); P is
// rounded to bf16 in registers and fed back as the A operand of O += P V,
// with no trip through shared memory.  The mask is as flash_attention.cu's:
// masked scores take the finite -1e30, so a row that sees no valid key in a
// visited block takes p = 1 there and the first valid block's correction
// exp(-1e30 - m) = 0 clears it; only the blocks that cross the diagonal, the
// window edge, Tq or Tk are masked element by element, keys past Tk to -inf.
// A row that sees no key at all (a window with Tq > Tk: rows at and past
// Tk - 1 + window) takes p = 1 on every key and so the mean of V over the Tk
// keys, as the reference does; a q block holding one visits every key
// block.  In the gradient such rows have dS = 0 and P = 1 / Tk on every
// key, so they add one vector, (1 / Tk) sum of their dO, to every dV row:
// the pre-pass sums it and the dK/dV epilogue adds it.
// Scores are kept in the log2 domain (scale * log2 e folded into one
// multiply, exp2); lse is returned in natural log.
//
// Gradient (FlashAttention-2's), three launches and no float atomics, so it is
// deterministic:
//   1. D = rowsum(dO * O) per query row (one warp per row), and where rows
//      see no key, the sum of their dO per bh (one more CTA per bh);
//   2. dK, dV: one CTA per (bh, block of 128 keys, 64 at Dh 256).  Warp w owns
//      16 keys (at Dh 256 two warps share them, each accumulating half of the
//      columns).  It loops over the G query heads and the 64-row q blocks
//      that see its keys (none, and dK = dV = 0, for keys at and past Tq
//      when causal with Tk > Tq), Q, dO, lse and D double-buffered by cp.async:
//      S^T = K Q^T, P^T = exp(scale S^T - lse); dP^T = V dO^T;
//      dS^T = P^T (dP^T - D); dV += P^T dO and dK += dS^T Q with P^T and dS^T
//      rounded to bf16 in registers as the A operands;
//   3. dQ: one CTA per (bh, g, block of 128 query rows, 64 at Dh 256), looping
//      over the key blocks of 64 that the forward visits: S and dP again,
//      dQ += dS K.  Recomputing S and dP here (7 products where the bound
//      counts 5) is the price of no atomics.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes (repro_torch/kernels/flash_attention/
// ops.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  // whether some pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is
  // masked (or out of range), so the block needs the element-wise mask
  __device__ __forceinline__ bool edge(int q0, int nq, int k0, int nk) const {
    return k0 + nk > Tk || q0 + nq > Tq || (causal && k0 + nk - 1 > q0) ||
           (window > 0 && q0 + nq - 1 - k0 >= window);
  }
};

Mask make_mask(int Tq, int Tk, int causal, int window) {
  const int blind = window > 0 && window <= Tq - Tk ? Tk - 1 + window : Tq;
  return Mask{Tq, Tk, causal, window, blind, 1.f / Tk};
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// whose rows hold DP elements (DP a multiple of 64)
template <int DP>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * DP + (((chunk & ~7) | ((chunk ^ row) & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A operand of the next product from two 16x8 accumulator tiles (the
// columns 0-7 and 8-15 of a 16x16 block), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + ROWS) of a [T, DH] bf16 matrix into a swizzled tile,
// zeros past T (cp.async, not committed)
template <int ROWS, int DH, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int Tn) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int gr = row0 + r;
    const bool ok = gr < Tn;
    cp_async16(smem_u32(dst + swz<DP>(r, c)), src + (size_t)(ok ? gr : 0) * DH + c * 8, ok);
  }
}

// rows [row0, row0 + N) of a float vector of length T, zeros past T
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int Tn) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const int gr = row0 + i;
    const bool ok = gr < Tn;
    cp_async4(smem_u32(dst + i), src + (ok ? gr : 0), ok);
  }
}

constexpr int round64(int x) { return (x + 63) / 64 * 64; }

// One key block of the online softmax on accumulator fragments: S is scaled
// to the log2 domain and masked (element-wise only on an edge block), the
// running max m and this lane's share of the row sum l of rows row_a and
// row_b = row_a + 8 advance, S becomes P and the output accumulator is
// rescaled.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&acc)[NO][4],
                                             float& m_a, float& m_b, float& l_a, float& l_b,
                                             const Mask& mask, bool edge, int row_a,
                                             int row_b, int k0, int tq, float scale_log2) {
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
        if (!mask.ok(e < 2 ? row_a : row_b, kp)) x = kp < mask.Tk ? NEG_INF : -INFINITY;
      }
      s[j][e] = x;
    }
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
  const float c_a = exp2f(m_a - mn_a), c_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = exp2f(s[j][0] - mn_a);
    s[j][1] = exp2f(s[j][1] - mn_a);
    s[j][2] = exp2f(s[j][2] - mn_b);
    s[j][3] = exp2f(s[j][3] - mn_b);
    ps_a += s[j][0] + s[j][1];
    ps_b += s[j][2] + s[j][3];
  }
  l_a = l_a * c_a + ps_a;
  l_b = l_b * c_b + ps_b;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= c_a; acc[n][1] *= c_a;
    acc[n][2] *= c_b; acc[n][3] *= c_b;
  }
}

// O = acc / l in bf16 and lse = m + log l (natural log) for rows row_a and
// row_b of the rows that start at qrow0, those below Tq
template <int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], float m_a, float m_b,
                                           float l_a, float l_b, bf16* o, float* lse,
                                           size_t qrow0, int row_a, int row_b, int Tn, int tq) {
  constexpr int DH = NO * 8;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (row_a < Tn) {
    bf16* orow = o + (qrow0 + row_a) * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (tq == 0) lse[qrow0 + row_a] = (m_a + log2f(l_a)) * LN2;
  }
  if (row_b < Tn) {
    bf16* orow = o + (qrow0 + row_b) * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
    if (tq == 0) lse[qrow0 + row_b] = (m_b + log2f(l_b)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DH> struct Fwd {
  static constexpr int BM = 128;                 // query rows per CTA
  static constexpr int BN = DH <= 128 ? 128 : 64;  // keys per block
  static constexpr int DP = round64(DH);
  static constexpr bool Q_REGS = DH <= 128;
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(BM + 4 * BN) * DP;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
fa_tc_forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int G, Mask mask, float scale_log2) {
  using C = Fwd<DH>;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int BM = C::BM, BN = C::BN, DP = C::DP;
  constexpr int KS = DH / 16;       // k-steps of Q K^T
  constexpr int NO = DH / 8;        // n-tiles of O
  constexpr int NS = BN / 8;        // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BM][DP]
  bf16* Ks = Qs + BM * DP;                        // [2][BN][DP]
  bf16* Vs = Ks + 2 * BN * DP;                    // [2][BN][DP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal blocks first
  const size_t qrow0 = (size_t)blockIdx.x * Tq;        // (bh * G + g) * Tq
  const bf16* kh = k + (size_t)bh * Tk * DH;
  const bf16* vh = v + (size_t)bh * Tk * DH;
  // per-lane parts of the ldmatrix addresses: the A / transposed-B pattern and
  // the B pattern
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  const int q_hi = min(q0 + BM, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / BN, kb1 = mask.key_hi(q_hi) / BN;

  load_tile<BM, DH, DP>(Qs, q + qrow0 * DH, q0, Tq);
  cp_async_commit();
  load_tile<BN, DH, DP>(Ks, kh, kb0 * BN, Tk);
  load_tile<BN, DH, DP>(Vs, vh, kb0 * BN, Tk);
  cp_async_commit();

  uint32_t qf[C::Q_REGS ? KS : 1][4];
  if constexpr (C::Q_REGS) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qf[kk], smem_u32(Qs + swz<DP>(warp * 16 + a_row, 2 * kk + a_chk)));
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;

  for (int kb = kb0; kb <= kb1; ++kb) {
    const int st = (kb - kb0) & 1;
    if (kb < kb1) {
      load_tile<BN, DH, DP>(Ks + (st ^ 1) * BN * DP, kh, (kb + 1) * BN, Tk);
      load_tile<BN, DH, DP>(Vs + (st ^ 1) * BN * DP, vh, (kb + 1) * BN, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kst = Ks + st * BN * DP;
    const bf16* Vst = Vs + st * BN * DP;
    const int k0 = kb * BN;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (C::Q_REGS) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, smem_u32(Qs + swz<DP>(warp * 16 + a_row, 2 * kk + a_chk)));
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Kst + swz<DP>(16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    softmax_step(s, acc, m_a, m_b, l_a, l_b, mask, mask.edge(q0, BM, k0, BN), row_a, row_b,
                 k0, tq, scale_log2);

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(Vst + swz<DP>(16 * kk + a_row, 2 * dp + a_chk)));
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                  // this stage is consumed
  }

  store_rows(acc, m_a, m_b, l_a, l_b, o, lse, qrow0, row_a, row_b, Tq, tq);
}


// ---------------------------------------------------------------------------
// forward at Dh 128 on wgmma, K/V brought by TMA into an mbarrier ring
// ---------------------------------------------------------------------------
//
// Two warpgroups of 64 query rows each (BM 128); per block of 128 keys
// S = Q K^T is eight wgmma.m64n128k16 with Q and K read from shared memory,
// and O += P V eight more with P from registers (the mma.sync A layout, so
// the softmax of the mma.sync kernel carries over) and V read transposed.
// Q, K and V arrive by TMA as boxes of [128 rows][64 columns] (one 128-byte
// row each, 128-byte swizzle: wgmma's canonical layout), zero past Tq / Tk.  Thread
// 0 starts the copies: Q and the first two K/V blocks up front, block i + 2
// into the stage of block i once all eight warps have released it.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a [heads, T, Dh] tensor: columns c0.., rows c1.., head c2
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  __syncwarp();                        // .aligned: the warp converged (after the spin waits)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers that wgmma reads or writes asynchronously stay put until here
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+r"(a[j][0]), "+r"(a[j][1]), "+r"(a[j][2]), "+r"(a[j][3])::"memory");
}

// d (+)= A B for a 64x128 tile: A from shared memory (K-major), B from
// shared memory (K-major), f32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for a 64x128 tile: A from registers (the mma.sync A layout per
// warp), B from shared memory transposed (MN-major), f32 accumulators
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int WG_ROWS = 128;                  // query rows per CTA, keys per block
constexpr int WG_BOX = WG_ROWS * 64 * 2;      // bytes of one [128][64] bf16 box
// alignment slack, Q, two stages of K and V (two boxes each), 7 mbarriers
constexpr size_t WG_SMEM = 1024 + 10 * (size_t)WG_BOX + 64;

__global__ void __launch_bounds__(THREADS, 1)
fa_tc_forward_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, int G, Mask mask, float scale_log2) {
  constexpr int DH = 128, NS = WG_ROWS / 8, NO = DH / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t sQ = base;                                        // boxes 0, 1
  auto sK = [&](int st) { return base + (2 + 4 * st) * WG_BOX; };  // boxes 2-3, 6-7
  auto sV = [&](int st) { return base + (4 + 4 * st) * WG_BOX; };  // boxes 4-5, 8-9
  const uint32_t bars = base + 10 * WG_BOX;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 + 8 * st; };
  auto v_full = [&](int st) { return bars + 24 + 8 * st; };
  auto empty = [&](int st) { return bars + 40 + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                      // warpgroup: query rows 64 wg..
  const int gq = lane >> 2, tq4 = lane & 3;
  const int head = blockIdx.x, bh = head / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_ROWS;   // the longest causal blocks first
  const int q_hi = min(q0 + WG_ROWS, mask.Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / WG_ROWS;
  const int nkb = mask.key_hi(q_hi) / WG_ROWS - kb0 + 1;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int i) {            // key block kb0 + i into stage i & 1
    const int st = i & 1, k0 = (kb0 + i) * WG_ROWS;
    mbar_expect_tx(k_full(st), 2 * WG_BOX);
    tma_load(sK(st), &tk, 0, k0, bh, k_full(st));
    tma_load(sK(st) + WG_BOX, &tk, 64, k0, bh, k_full(st));
    mbar_expect_tx(v_full(st), 2 * WG_BOX);
    tma_load(sV(st), &tv, 0, k0, bh, v_full(st));
    tma_load(sV(st) + WG_BOX, &tv, 64, k0, bh, v_full(st));
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, 2 * WG_BOX);
    tma_load(sQ, &tq, 0, q0, head, q_full);
    tma_load(sQ + WG_BOX, &tq, 64, q0, head, q_full);
    fetch(0);
    if (nkb > 1) fetch(1);
  }

  float acc[NO][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const int row_a = q0 + 64 * wg + 16 * (warp & 3) + gq, row_b = row_a + 8;
  const uint32_t qa = sQ + wg * 64 * 128;        // this warpgroup's 64 rows
  mbar_wait(q_full, 0);

  for (int i = 0; i < nkb; ++i) {
    const int st = i & 1, par = (i >> 1) & 1, k0 = (kb0 + i) * WG_ROWS;
    mbar_wait(k_full(st), par);
    // S = Q K^T: K-major A and B, 16 columns (32 bytes) of a 128-byte row a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * WG_BOX + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(qa + off, 16, 1024), gmma_desc(sK(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit_wait();
    pin(s);
    softmax_step(s, acc, m_a, m_b, l_a, l_b, mask, mask.edge(q0, WG_ROWS, k0, WG_ROWS),
                 row_a, row_b, k0, tq4, scale_log2);
    uint32_t pa[WG_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk) acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);

    // O += P V: V is MN-major (columns contiguous); 16 keys = two 8-row groups
    // of 1 KB a step, the second 64 columns one box (LBO) further
    mbar_wait(v_full(st), par);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk)
      wgmma_rs(acc, pa[kk], gmma_desc(sV(st) + kk * 2048, WG_BOX, 1024));
    wgmma_commit_wait();
    pin(acc);
    pin(pa);
    if (lane == 0) mbar_arrive(empty(st));
    if (tid == 0 && i + 2 < nkb) {
      mbar_wait(empty(st), par);
      fetch(i + 2);
    }
  }
  store_rows(acc, m_a, m_b, l_a, l_b, o, lse, (size_t)head * mask.Tq, row_a, row_b, mask.Tq,
             tq4);
}

// ---------------------------------------------------------------------------
// gradient
// ---------------------------------------------------------------------------

// D[row] = sum_d dO[row, d] * O[row, d], one warp per row; the CTAs past the
// rows' (one per bh, launched only where some query row sees no key) sum dO
// over those rows of all G heads, in order, into colsum [BH, DH].  DH 0 reads
// the head dim from `dh` (the wide bodies').
template <int DH_>
__global__ void __launch_bounds__(THREADS)
fa_tc_rowdot_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                    float* __restrict__ D, long long rows, float* __restrict__ colsum, int G,
                    Mask mask, int dh) {
  const int DH = DH_ ? DH_ : dh;
  const long long row_blocks = (rows + WARPS - 1) / WARPS;
  if (blockIdx.x >= row_blocks) {
    const int bh = (int)(blockIdx.x - row_blocks);
    for (int d = threadIdx.x; d < DH; d += THREADS) {
      float acc = 0.f;
      for (int g = 0; g < G; ++g) {
        const bf16* col = dout + (size_t)(bh * G + g) * mask.Tq * DH + d;
        for (int i = mask.blind; i < mask.Tq; ++i) acc += __bfloat162float(col[(size_t)i * DH]);
      }
      colsum[(size_t)bh * DH + d] = acc;
    }
    return;
  }
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* a = dout + row * DH;
  const bf16* b = out + row * DH;
  float acc = 0.f;
  for (int c = lane; c < DH / 8; c += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + 8 * c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + 8 * c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fx = __bfloat1622float2(xp[i]), fy = __bfloat1622float2(yp[i]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// WD warps share each 16-row slice of the output, each owning DH / WD of its
// columns (2 at Dh 256, where one warp cannot hold 16 x 256 twice in f32)
template <int DH> struct Bwd {
  static constexpr int WD = DH > 128 ? 2 : 1;
  static constexpr int BR = 16 * WARPS / WD;     // output rows per CTA (keys / queries)
  static constexpr int BS = 64;                  // rows per step of the loop
  static constexpr int DP = round64(DH);
  static constexpr size_t DKDV_SMEM =
      sizeof(bf16) * (size_t)(2 * BR + 4 * BS) * DP + sizeof(float) * 4 * BS;
  static constexpr size_t DQ_SMEM = sizeof(bf16) * (size_t)(2 * BR + 4 * BS) * DP;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
fa_tc_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  const float* __restrict__ colsum, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int G, Mask mask, float scale_log2, float scale) {
  using C = Bwd<DH>;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int WD = C::WD, BK = C::BR, BQ = C::BS, DP = C::DP;
  constexpr int KS = DH / 16;          // k-steps over the head dim
  constexpr int DW = DH / WD;          // output columns per warp
  constexpr int NO = DW / 8;           // n-tiles of dK, dV per warp
  constexpr int NS = BQ / 8;           // n-tiles of S^T (queries)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][DP]
  bf16* Vs = Ks + BK * DP;                        // [BK][DP]
  bf16* Qs = Vs + BK * DP;                        // [2][BQ][DP]
  bf16* Os = Qs + 2 * BQ * DP;                    // [2][BQ][DP]  dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * DP);   // [2][BQ]  lse
  float* Dsm = Ls + 2 * BQ;                                  // [2][BQ]  D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int kw = warp / WD, col0 = (warp % WD) * DW;
  const int bh = blockIdx.x, k0 = blockIdx.y * BK;   // the longest causal blocks first
  const size_t krow0 = (size_t)bh * Tk;
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  load_tile<BK, DH, DP>(Ks, k + krow0 * DH, k0, Tk);
  load_tile<BK, DH, DP>(Vs, v + krow0 * DH, k0, Tk);

  const int k_hi = min(k0 + BK, Tk) - 1;
  const int qb0 = mask.query_lo(k0) / BQ;
  const int nq = max(0, mask.query_hi(k_hi) / BQ - qb0 + 1);   // 0: no query sees these keys
  const int steps = G * nq;
  auto fetch = [&](int it, int st) {
    const int g = it / nq, qs = (qb0 + it - g * nq) * BQ;
    const size_t qrow0 = ((size_t)bh * G + g) * Tq;
    load_tile<BQ, DH, DP>(Qs + st * BQ * DP, q + qrow0 * DH, qs, Tq);
    load_tile<BQ, DH, DP>(Os + st * BQ * DP, dout + qrow0 * DH, qs, Tq);
    load_vec<BQ>(Ls + st * BQ, lse + qrow0, qs, Tq);
    load_vec<BQ>(Dsm + st * BQ, D + qrow0, qs, Tq);
  };
  if (steps > 0) fetch(0, 0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key_a = k0 + kw * 16 + gq, key_b = key_a + 8;

  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    if (it + 1 < steps) {
      fetch(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qst = Qs + st * BQ * DP;
    const bf16* Ost = Os + st * BQ * DP;
    const float* Lst = Ls + st * BQ;
    const float* Dst = Dsm + st * BQ;
    const int q0 = (qb0 + it % nq) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, smem_u32(Ks + swz<DP>(kw * 16 + a_row, 2 * kk + a_chk)));
      ldsm_x4(av, smem_u32(Vs + swz<DP>(kw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Qst + swz<DP>(16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], ak, b[0], b[1]);
        mma(s[2 * j + 1], ak, b[2], b[3]);
        ldsm_x4(b, smem_u32(Ost + swz<DP>(16 * j + b_row, 2 * kk + b_chk)));
        mma(dp[2 * j], av, b[0], b[1]);
        mma(dp[2 * j + 1], av, b[2], b[3]);
      }
    }

    // P^T = exp(scale S^T - lse), masked to 0; dS^T = P^T (dP^T - D)
    const bool edge = mask.edge(q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int qi = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(Lst + qi);
      const float2 d2 = *reinterpret_cast<const float2*>(Dst + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = exp2f(s[j][e] * scale_log2 - (c ? l2.y : l2.x) * LOG2E);
        if (edge) {
          const int qp = q0 + qi + c;
          if (qp >= Tq || !mask.ok(qp, e < 2 ? key_a : key_b)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (c ? d2.y : d2.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q over the BQ queries, A operands from registers
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ad[4];
      acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t b[4];
        const int chk = col0 / 8 + 2 * n + a_chk;
        ldsm_x4_t(b, smem_u32(Ost + swz<DP>(16 * kk + a_row, chk)));
        mma(dva[2 * n], ap, b[0], b[1]);
        mma(dva[2 * n + 1], ap, b[2], b[3]);
        ldsm_x4_t(b, smem_u32(Qst + swz<DP>(16 * kk + a_row, chk)));
        mma(dka[2 * n], ad, b[0], b[1]);
        mma(dka[2 * n + 1], ad, b[2], b[3]);
      }
    }
    __syncthreads();                  // this stage is consumed
  }
  cp_async_wait<0>();                 // K and V, where no step waited for them

  const int c0 = col0 + 2 * tq;
  if (mask.blind < Tq) {              // rows that see no key: P = 1 / Tk on every key
    const float pb = __bfloat162float(__float2bfloat16_rn(mask.inv_tk));
    const float* cs = colsum + (size_t)bh * DH + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = pb * cs[8 * n], x1 = pb * cs[8 * n + 1];
      dva[n][0] += x0; dva[n][1] += x1;
      dva[n][2] += x0; dva[n][3] += x1;
    }
  }
  if (key_a < Tk) {
    bf16* kr = dk + (krow0 + key_a) * DH + c0;
    bf16* vr = dv + (krow0 + key_a) * DH + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(kr + 8 * n) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vr + 8 * n) = pack_bf16(dva[n][0], dva[n][1]);
    }
  }
  if (key_b < Tk) {
    bf16* kr = dk + (krow0 + key_b) * DH + c0;
    bf16* vr = dv + (krow0 + key_b) * DH + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(kr + 8 * n) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vr + 8 * n) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
fa_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                bf16* __restrict__ dq, int G, Mask mask, float scale_log2,
                float scale) {
  using C = Bwd<DH>;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int WD = C::WD, BM = C::BR, BN = C::BS, DP = C::DP;
  constexpr int KS = DH / 16;
  constexpr int DW = DH / WD;
  constexpr int NO = DW / 8;
  constexpr int NS = BN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BM][DP]
  bf16* Os = Qs + BM * DP;                        // [BM][DP]  dO
  bf16* Ks = Os + BM * DP;                        // [2][BN][DP]
  bf16* Vs = Ks + 2 * BN * DP;                    // [2][BN][DP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp / WD, col0 = (warp % WD) * DW;
  const int bh = blockIdx.x / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal blocks first
  const size_t qrow0 = (size_t)blockIdx.x * Tq;
  const bf16* kh = k + (size_t)bh * Tk * DH;
  const bf16* vh = v + (size_t)bh * Tk * DH;
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  const int q_hi = min(q0 + BM, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / BN, kb1 = mask.key_hi(q_hi) / BN;
  load_tile<BM, DH, DP>(Qs, q + qrow0 * DH, q0, Tq);
  load_tile<BM, DH, DP>(Os, dout + qrow0 * DH, q0, Tq);
  load_tile<BN, DH, DP>(Ks, kh, kb0 * BN, Tk);
  load_tile<BN, DH, DP>(Vs, vh, kb0 * BN, Tk);
  cp_async_commit();

  const int row_a = q0 + rw * 16 + gq, row_b = row_a + 8;
  const float ll_a = lse[qrow0 + min(row_a, Tq - 1)] * LOG2E;
  const float ll_b = lse[qrow0 + min(row_b, Tq - 1)] * LOG2E;
  const float d_a = D[qrow0 + min(row_a, Tq - 1)], d_b = D[qrow0 + min(row_b, Tq - 1)];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb = kb0; kb <= kb1; ++kb) {
    const int st = (kb - kb0) & 1;
    if (kb < kb1) {
      load_tile<BN, DH, DP>(Ks + (st ^ 1) * BN * DP, kh, (kb + 1) * BN, Tk);
      load_tile<BN, DH, DP>(Vs + (st ^ 1) * BN * DP, vh, (kb + 1) * BN, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kst = Ks + st * BN * DP;
    const bf16* Vst = Vs + st * BN * DP;
    const int k0 = kb * BN;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, smem_u32(Qs + swz<DP>(rw * 16 + a_row, 2 * kk + a_chk)));
      ldsm_x4(ao, smem_u32(Os + swz<DP>(rw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Kst + swz<DP>(16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], aq, b[0], b[1]);
        mma(s[2 * j + 1], aq, b[2], b[3]);
        ldsm_x4(b, smem_u32(Vst + swz<DP>(16 * j + b_row, 2 * kk + b_chk)));
        mma(dp[2 * j], ao, b[0], b[1]);
        mma(dp[2 * j + 1], ao, b[2], b[3]);
      }
    }

    const bool edge = mask.edge(q0, BM, k0, BN);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f(s[j][e] * scale_log2 - (lo ? ll_a : ll_b));
        if (edge && !mask.ok(lo ? row_a : row_b, k0 + 8 * j + 2 * tq + (e & 1))) p = 0.f;
        dp[j][e] = p * (dp[j][e] - (lo ? d_a : d_b));
      }
    }

    // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(Kst + swz<DP>(16 * kk + a_row, col0 / 8 + 2 * n + a_chk)));
        mma(acc[2 * n], a, b[0], b[1]);
        mma(acc[2 * n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const int c0 = col0 + 2 * tq;
  if (row_a < Tq) {
    bf16* r = dq + (qrow0 + row_a) * DH + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + 8 * n) = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
  }
  if (row_b < Tq) {
    bf16* r = dq + (qrow0 + row_b) * DH + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + 8 * n) = pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// head dims past 256: the wide bodies
// ---------------------------------------------------------------------------
//
// Dh (a multiple of PW = 128, the wrapper pads to it) splits two ways.  The
// reductions over Dh (S = Q K^T, dP = dO V^T) run in pieces of PW columns,
// staged by cp.async through a two-stage swizzled ring, every piece in the
// same order in every CTA, so S, P, lse and dS are the same bits in every
// chunk.  The outputs (O, dQ, dK, dV) split into chunks of CW = 256 columns
// (the last one 128 where Dh is an odd multiple of 128), a grid axis (z) of
// their own; each CTA accumulates its chunk's columns of the product that
// ends there, P V, dS K, P^T dO and dS^T Q, from a tile of the chunk's
// columns that arrives with the last piece.  In the gradient two warps
// share each 16 keys (dK/dV) or 16 query rows (dQ): each computes S and dP
// for half of the other side's 64, rounds P^T and dS^T (dS) to bf16 into
// shared memory, and after a barrier each reads the whole 16 x 64 block as
// the A operand of its 128 columns.  So no product is computed twice inside
// a CTA; across chunks S and dP are recomputed (the forward does 1.5x the
// bound's products at Dh 512, the gradient 2.2x), and there are no float
// atomics.

constexpr int PW = 128;   // columns of a piece of the reductions over Dh
constexpr int CW = 256;   // output columns a CTA holds (a chunk)

int wide_chunks(int Dh) { return (Dh + CW - 1) / CW; }

// rows [row0, row0 + ROWS) x columns [col0, col0 + W) of a [Tn, ld] bf16
// matrix into a swizzled [ROWS][DP] tile, zeros past Tn (cp.async, not
// committed); W a multiple of 8, at most DP
template <int ROWS, int DP>
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* src, int ld, int row0, int Tn,
                                          int col0, int W) {
  const int CH = W / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int gr = row0 + r;
    const bool ok = gr < Tn;
    cp_async16(smem_u32(dst + swz<DP>(r, c)), src + (size_t)(ok ? gr : 0) * ld + col0 + c * 8,
               ok);
  }
}

// a 16 x 8 accumulator tile's two rows, rounded to bf16, into a swizzled
// [rows][64] tile at (row, col): the A operand of a later ldmatrix
__device__ __forceinline__ void put_a(bf16* t, int row, int col, const float (&c)[4]) {
  *reinterpret_cast<uint32_t*>(t + swz<64>(row, col >> 3) + (col & 7)) = pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(t + swz<64>(row + 8, col >> 3) + (col & 7)) =
      pack_bf16(c[2], c[3]);
}

// Forward: one CTA of 8 warps per (bh, g, block of 128 query rows, chunk);
// warp w owns rows 16w..16w+15 and the chunk's columns of O.  Per key block
// of 64: S over the pieces (Q from shared memory: whole where it fits, at
// Dh <= 640, else a piece a step through the ring with K), the online
// softmax, then O += P V over the chunk, V's chunk arriving with the last
// piece.
struct WideFwd {
  static constexpr int BM = 128, BN = 64;
  static size_t smem(int Dh, bool q_whole) {
    return sizeof(bf16) * ((q_whole ? (size_t)BM * Dh : 2 * (size_t)BM * PW) +
                           2 * (size_t)BN * PW + (size_t)BN * CW);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
fa_tc_forward_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int G, int Dh, int q_whole, Mask mask,
                          float scale_log2) {
  using C = WideFwd;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int BM = C::BM, BN = C::BN;
  constexpr int NS = BN / 8, NO = CW / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);            // [np][BM][PW] or [2][BM][PW]
  bf16* Ks = Qs + (q_whole ? BM * Dh : 2 * BM * PW);       // [2][BN][PW]
  bf16* Vs = Ks + 2 * BN * PW;                              // [BN][CW]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal blocks first
  const int c0 = blockIdx.z * CW, wc = min(CW, Dh - c0);
  const int np = Dh / PW;
  const size_t qrow0 = (size_t)blockIdx.x * Tq;
  const bf16* qh = q + qrow0 * Dh;
  const bf16* kh = k + (size_t)bh * Tk * Dh;
  const bf16* vh = v + (size_t)bh * Tk * Dh;
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  const int q_hi = min(q0 + BM, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / BN, kb1 = mask.key_hi(q_hi) / BN;
  const int steps = (kb1 - kb0 + 1) * np;
  auto fetch = [&](int i) {          // key block kb0 + i / np, piece i % np
    const int kb = kb0 + i / np, p = i % np, st = i & 1;
    if (!q_whole) load_cols<BM, PW>(Qs + st * BM * PW, qh, Dh, q0, Tq, p * PW, PW);
    load_cols<BN, PW>(Ks + st * BN * PW, kh, Dh, kb * BN, Tk, p * PW, PW);
    if (p == np - 1) load_cols<BN, CW>(Vs, vh, Dh, kb * BN, Tk, c0, wc);
  };
  if (q_whole)
    for (int p = 0; p < np; ++p) load_cols<BM, PW>(Qs + p * BM * PW, qh, Dh, q0, Tq, p * PW, PW);
  fetch(0);
  cp_async_commit();

  float acc[NO][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, p = i % np, k0 = (kb0 + i / np) * BN;
    if (i + 1 < steps) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qst = Qs + (q_whole ? p : st) * BM * PW;
    const bf16* Kst = Ks + st * BN * PW;
    if (p == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < PW / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(Qst + swz<PW>(warp * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Kst + swz<PW>(16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }
    if (p == np - 1) {
      softmax_step(s, acc, m_a, m_b, l_a, l_b, mask, mask.edge(q0, BM, k0, BN), row_a, row_b,
                   k0, tq, scale_log2);
      // O += P V over the chunk, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          if (16 * dp < wc) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_u32(Vs + swz<CW>(16 * kk + a_row, 2 * dp + a_chk)));
            mma(acc[2 * dp], a, b[0], b[1]);
            mma(acc[2 * dp + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                  // this stage is consumed
  }

  // O = acc / l over the chunk's columns; lse from the first chunk
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (row_a < Tq) {
    bf16* orow = o + (qrow0 + row_a) * Dh + c0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < wc)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (tq == 0 && blockIdx.z == 0) lse[qrow0 + row_a] = (m_a + log2f(l_a)) * LN2;
  }
  if (row_b < Tq) {
    bf16* orow = o + (qrow0 + row_b) * Dh + c0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < wc)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
    if (tq == 0 && blockIdx.z == 0) lse[qrow0 + row_b] = (m_b + log2f(l_b)) * LN2;
  }
}

// the gradient's wide tiles: 64 output rows a CTA (keys for dK/dV, query
// rows for dQ), 64 rows of the other side a step, 8 warps: warp w owns the
// 16 rows 16 (w / 2).. and, of the chunk, columns 128 (w % 2)..; for S and
// dP it takes the other side's rows 32 (w % 2)..
struct WideBwd {
  static constexpr int BR = 64, BS = 64, DW = CW / 2;
  // ring of [2] x (four [BS][PW] pieces), two [BS][CW] chunk tiles, two
  // [BR][BS] bf16 blocks, lse and D [BS]
  static constexpr size_t DKDV_SMEM = sizeof(bf16) * (2 * 4 * (size_t)BS * PW + 2 * BS * CW +
                                                      2 * BR * BS) + sizeof(float) * 2 * BS;
  // ring of [2] x (four [64][PW] pieces), one [BS][CW] chunk of K, the dS block
  static constexpr size_t DQ_SMEM =
      sizeof(bf16) * (2 * 4 * (size_t)BS * PW + (size_t)BS * CW + (size_t)BR * BS);
};

__global__ void __launch_bounds__(THREADS, 1)
fa_tc_dkdv_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ D,
                       const float* __restrict__ colsum, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int G, int Dh, Mask mask, float scale_log2,
                       float scale) {
  using C = WideBwd;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int BK = C::BR, BQ = C::BS, DW = C::DW;
  constexpr int NS = BQ / 2 / 8;       // n-tiles of this warp's half of S^T
  constexpr int NO = DW / 8;           // n-tiles of dK, dV per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [2][K, V, Q, dO][64][PW]
  bf16* Qc = ring + 2 * 4 * BQ * PW;                // [BQ][CW]  Q's chunk
  bf16* Oc = Qc + BQ * CW;                          // [BQ][CW]  dO's chunk
  bf16* Ps = Oc + BQ * CW;                          // [BK][BQ]  P^T
  bf16* Ss = Ps + BK * BQ;                          // [BK][BQ]  dS^T
  float* Ls = reinterpret_cast<float*>(Ss + BK * BQ);   // [BQ]  lse
  float* Dsm = Ls + BQ;                                  // [BQ]  D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int kw = warp >> 1, half = warp & 1, col0 = half * DW;
  const int bh = blockIdx.x, k0 = blockIdx.y * BK;   // the longest causal blocks first
  const int c0 = blockIdx.z * CW, wc = min(CW, Dh - c0);
  const int np = Dh / PW;
  const size_t krow0 = (size_t)bh * Tk;
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  const int k_hi = min(k0 + BK, Tk) - 1;
  const int qb0 = mask.query_lo(k0) / BQ;
  const int nq = max(0, mask.query_hi(k_hi) / BQ - qb0 + 1);   // 0: no query sees these keys
  const int steps = G * nq * np;
  auto fetch = [&](int i) {          // q step i / np (head g, block qs), piece i % np
    const int it = i / np, p = i % np;
    const int g = it / nq, qs = (qb0 + it - g * nq) * BQ;
    const size_t qrow0 = ((size_t)bh * G + g) * Tq;
    bf16* st = ring + (i & 1) * 4 * BQ * PW;
    load_cols<BK, PW>(st, k + krow0 * Dh, Dh, k0, Tk, p * PW, PW);
    load_cols<BK, PW>(st + BQ * PW, v + krow0 * Dh, Dh, k0, Tk, p * PW, PW);
    load_cols<BQ, PW>(st + 2 * BQ * PW, q + qrow0 * Dh, Dh, qs, Tq, p * PW, PW);
    load_cols<BQ, PW>(st + 3 * BQ * PW, dout + qrow0 * Dh, Dh, qs, Tq, p * PW, PW);
    if (p == np - 1) {
      load_cols<BQ, CW>(Qc, q + qrow0 * Dh, Dh, qs, Tq, c0, wc);
      load_cols<BQ, CW>(Oc, dout + qrow0 * Dh, Dh, qs, Tq, c0, wc);
      load_vec<BQ>(Ls, lse + qrow0, qs, Tq);
      load_vec<BQ>(Dsm, D + qrow0, qs, Tq);
    }
  };
  if (steps > 0) fetch(0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4], s[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key_a = k0 + kw * 16 + gq, key_b = key_a + 8;

  for (int i = 0; i < steps; ++i) {
    const int p = i % np;
    if (i + 1 < steps) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kst = ring + (i & 1) * 4 * BQ * PW;
    const bf16* Vst = Kst + BQ * PW;
    const bf16* Qst = Kst + 2 * BQ * PW;
    const bf16* Ost = Kst + 3 * BQ * PW;
    if (p == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
#pragma unroll
    for (int kk = 0; kk < PW / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, smem_u32(Kst + swz<PW>(kw * 16 + a_row, 2 * kk + a_chk)));
      ldsm_x4(av, smem_u32(Vst + swz<PW>(kw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Qst + swz<PW>(half * 32 + 16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], ak, b[0], b[1]);
        mma(s[2 * j + 1], ak, b[2], b[3]);
        ldsm_x4(b, smem_u32(Ost + swz<PW>(half * 32 + 16 * j + b_row, 2 * kk + b_chk)));
        mma(dp[2 * j], av, b[0], b[1]);
        mma(dp[2 * j + 1], av, b[2], b[3]);
      }
    }
    if (p != np - 1) {
      __syncthreads();                // this stage is consumed
      continue;
    }
    const int it = i / np;
    const int q0 = (qb0 + it % nq) * BQ;
    // P^T = exp(scale S^T - lse), masked to 0; dS^T = P^T (dP^T - D); both
    // to shared memory in bf16
    const bool edge = mask.edge(q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int qi = half * 32 + 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + qi);
      const float2 d2 = *reinterpret_cast<const float2*>(Dsm + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float pv = exp2f(s[j][e] * scale_log2 - (c ? l2.y : l2.x) * LOG2E);
        if (edge) {
          const int qp = q0 + qi + c;
          if (qp >= Tq || !mask.ok(qp, e < 2 ? key_a : key_b)) pv = 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - (c ? d2.y : d2.x));
      }
      put_a(Ps, kw * 16 + gq, qi, s[j]);
      put_a(Ss, kw * 16 + gq, qi, dp[j]);
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the BQ queries and this warp's columns
    if (col0 < wc) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ldsm_x4(ap, smem_u32(Ps + swz<64>(kw * 16 + a_row, 2 * kk + a_chk)));
        ldsm_x4(ad, smem_u32(Ss + swz<64>(kw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
        for (int n = 0; n < NO / 2; ++n) {
          uint32_t b[4];
          const int chk = col0 / 8 + 2 * n + a_chk;
          ldsm_x4_t(b, smem_u32(Oc + swz<CW>(16 * kk + a_row, chk)));
          mma(dva[2 * n], ap, b[0], b[1]);
          mma(dva[2 * n + 1], ap, b[2], b[3]);
          ldsm_x4_t(b, smem_u32(Qc + swz<CW>(16 * kk + a_row, chk)));
          mma(dka[2 * n], ad, b[0], b[1]);
          mma(dka[2 * n + 1], ad, b[2], b[3]);
        }
      }
    }
    __syncthreads();                  // the stage, the chunk tiles and P^T, dS^T are consumed
  }

  if (col0 >= wc) return;
  const int cc = c0 + col0 + 2 * tq;  // this lane's first column of the head dim
  if (mask.blind < Tq) {              // rows that see no key: P = 1 / Tk on every key
    const float pb = __bfloat162float(__float2bfloat16_rn(mask.inv_tk));
    const float* cs = colsum + (size_t)bh * Dh + cc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = pb * cs[8 * n], x1 = pb * cs[8 * n + 1];
      dva[n][0] += x0; dva[n][1] += x1;
      dva[n][2] += x0; dva[n][3] += x1;
    }
  }
  if (key_a < Tk) {
    bf16* kr = dk + (krow0 + key_a) * Dh + cc;
    bf16* vr = dv + (krow0 + key_a) * Dh + cc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(kr + 8 * n) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vr + 8 * n) = pack_bf16(dva[n][0], dva[n][1]);
    }
  }
  if (key_b < Tk) {
    bf16* kr = dk + (krow0 + key_b) * Dh + cc;
    bf16* vr = dv + (krow0 + key_b) * Dh + cc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(kr + 8 * n) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vr + 8 * n) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fa_tc_dq_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ D,
                     bf16* __restrict__ dq, int G, int Dh, Mask mask, float scale_log2,
                     float scale) {
  using C = WideBwd;
  const int Tq = mask.Tq, Tk = mask.Tk;
  constexpr int BM = C::BR, BN = C::BS, DW = C::DW;
  constexpr int NS = BN / 2 / 8;       // n-tiles of this warp's half of S
  constexpr int NO = DW / 8;           // n-tiles of dQ per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [2][Q, dO, K, V][64][PW]
  bf16* Kc = ring + 2 * 4 * BN * PW;                // [BN][CW]  K's chunk
  bf16* Ss = Kc + BN * CW;                          // [BM][BN]  dS

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp >> 1, half = warp & 1, col0 = half * DW;
  const int bh = blockIdx.x / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal blocks first
  const int c0 = blockIdx.z * CW, wc = min(CW, Dh - c0);
  const int np = Dh / PW;
  const size_t qrow0 = (size_t)blockIdx.x * Tq;
  const bf16* qh = q + qrow0 * Dh;
  const bf16* oh = dout + qrow0 * Dh;
  const bf16* kh = k + (size_t)bh * Tk * Dh;
  const bf16* vh = v + (size_t)bh * Tk * Dh;
  const int a_row = lane & 15, a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chk = (lane >> 3) & 1;

  const int q_hi = min(q0 + BM, Tq) - 1;
  const int kb0 = mask.key_lo(q0, q_hi) / BN, kb1 = mask.key_hi(q_hi) / BN;
  const int steps = (kb1 - kb0 + 1) * np;
  auto fetch = [&](int i) {          // key block kb0 + i / np, piece i % np
    const int kb = kb0 + i / np, p = i % np;
    bf16* st = ring + (i & 1) * 4 * BN * PW;
    load_cols<BM, PW>(st, qh, Dh, q0, Tq, p * PW, PW);
    load_cols<BM, PW>(st + BN * PW, oh, Dh, q0, Tq, p * PW, PW);
    load_cols<BN, PW>(st + 2 * BN * PW, kh, Dh, kb * BN, Tk, p * PW, PW);
    load_cols<BN, PW>(st + 3 * BN * PW, vh, Dh, kb * BN, Tk, p * PW, PW);
    if (p == np - 1) load_cols<BN, CW>(Kc, kh, Dh, kb * BN, Tk, c0, wc);
  };
  fetch(0);
  cp_async_commit();

  const int row_a = q0 + rw * 16 + gq, row_b = row_a + 8;
  const float ll_a = lse[qrow0 + min(row_a, Tq - 1)] * LOG2E;
  const float ll_b = lse[qrow0 + min(row_b, Tq - 1)] * LOG2E;
  const float d_a = D[qrow0 + min(row_a, Tq - 1)], d_b = D[qrow0 + min(row_b, Tq - 1)];
  float acc[NO][4], s[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int p = i % np;
    if (i + 1 < steps) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qst = ring + (i & 1) * 4 * BN * PW;
    const bf16* Ost = Qst + BN * PW;
    const bf16* Kst = Qst + 2 * BN * PW;
    const bf16* Vst = Qst + 3 * BN * PW;
    if (p == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 32 keys
#pragma unroll
    for (int kk = 0; kk < PW / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, smem_u32(Qst + swz<PW>(rw * 16 + a_row, 2 * kk + a_chk)));
      ldsm_x4(ao, smem_u32(Ost + swz<PW>(rw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Kst + swz<PW>(half * 32 + 16 * j + b_row, 2 * kk + b_chk)));
        mma(s[2 * j], aq, b[0], b[1]);
        mma(s[2 * j + 1], aq, b[2], b[3]);
        ldsm_x4(b, smem_u32(Vst + swz<PW>(half * 32 + 16 * j + b_row, 2 * kk + b_chk)));
        mma(dp[2 * j], ao, b[0], b[1]);
        mma(dp[2 * j + 1], ao, b[2], b[3]);
      }
    }
    if (p != np - 1) {
      __syncthreads();                // this stage is consumed
      continue;
    }
    const int k0 = (kb0 + i / np) * BN;
    const bool edge = mask.edge(q0, BM, k0, BN);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int kj = half * 32 + 8 * j + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float pv = exp2f(s[j][e] * scale_log2 - (lo ? ll_a : ll_b));
        if (edge && !mask.ok(lo ? row_a : row_b, k0 + kj + (e & 1))) pv = 0.f;
        dp[j][e] = pv * (dp[j][e] - (lo ? d_a : d_b));
      }
      put_a(Ss, rw * 16 + gq, kj, dp[j]);
    }
    __syncthreads();
    // dQ += dS K over the BN keys and this warp's columns
    if (col0 < wc) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(Ss + swz<64>(rw * 16 + a_row, 2 * kk + a_chk)));
#pragma unroll
        for (int n = 0; n < NO / 2; ++n) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(Kc + swz<CW>(16 * kk + a_row, col0 / 8 + 2 * n + a_chk)));
          mma(acc[2 * n], a, b[0], b[1]);
          mma(acc[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                  // the stage, K's chunk and dS are consumed
  }

  if (col0 >= wc) return;
  const int cc = c0 + col0 + 2 * tq;
  if (row_a < Tq) {
    bf16* r = dq + (qrow0 + row_a) * Dh + cc;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + 8 * n) = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
  }
  if (row_b < Tq) {
    bf16* r = dq + (qrow0 + row_b) * Dh + cc;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + 8 * n) = pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
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

template <int DH>
cudaError_t forward(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH,
                    int G, Mask mask, float scale, cudaStream_t st) {
  using C = Fwd<DH>;
  auto kern = fa_tc_forward_kernel<DH>;
  cudaError_t e = set_smem(kern, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH * G, (mask.Tq + C::BM - 1) / C::BM);
  kern<<<grid, THREADS, C::SMEM, st>>>(q, k, v, o, lse, G, mask, scale * LOG2E);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time with cudaGetDriverEntryPoint
// (the library is not linked against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [heads, Tn, 128] bf16 tensor in boxes of [128 rows][64 columns], 128-byte
// swizzle, zeros past Tn
bool tensor_map(CUtensorMap* map, const void* base, int heads, int Tn) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {128, (cuuint64_t)Tn, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {128 * sizeof(bf16), (cuuint64_t)Tn * 128 * sizeof(bf16)};
  const cuuint32_t box[3] = {64, WG_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

cudaError_t forward_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                          int BH, int G, Mask mask, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, BH * G, mask.Tq) || !tensor_map(&tk, k, BH, mask.Tk) ||
      !tensor_map(&tv, v, BH, mask.Tk))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem(fa_tc_forward_kernel_wgmma, WG_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH * G, (mask.Tq + WG_ROWS - 1) / WG_ROWS);
  fa_tc_forward_kernel_wgmma<<<grid, THREADS, WG_SMEM, st>>>(tq, tk, tv, o, lse, G, mask,
                                                             scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t forward_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                         int BH, int G, int Dh, Mask mask, float scale, cudaStream_t st) {
  const bool q_whole = WideFwd::smem(Dh, true) <= 232448;   // Q of a CTA stays resident
  const size_t smem = WideFwd::smem(Dh, q_whole);
  cudaError_t e = set_smem(fa_tc_forward_kernel_wide, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH * G, (mask.Tq + WideFwd::BM - 1) / WideFwd::BM, wide_chunks(Dh));
  fa_tc_forward_kernel_wide<<<grid, THREADS, smem, st>>>(q, k, v, o, lse, G, Dh, (int)q_whole,
                                                         mask, scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t backward_wide(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                          const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                          float* D, int BH, int G, int Dh, Mask mask, float scale,
                          cudaStream_t st) {
  using C = WideBwd;
  const long long rows = (long long)BH * G * mask.Tq;
  float* colsum = D + rows;
  const long long blocks = (rows + WARPS - 1) / WARPS + (mask.blind < mask.Tq ? BH : 0);
  fa_tc_rowdot_kernel<0><<<(unsigned)blocks, THREADS, 0, st>>>(dout, o, D, rows, colsum, G,
                                                                 mask, Dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nc = wide_chunks(Dh);
  if ((e = set_smem(fa_tc_dkdv_kernel_wide, C::DKDV_SMEM)) != cudaSuccess) return e;
  fa_tc_dkdv_kernel_wide<<<dim3(BH, (mask.Tk + C::BR - 1) / C::BR, nc), THREADS, C::DKDV_SMEM,
                           st>>>(q, k, v, dout, lse, D, colsum, dk, dv, G, Dh, mask,
                                 scale * LOG2E, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(fa_tc_dq_kernel_wide, C::DQ_SMEM)) != cudaSuccess) return e;
  fa_tc_dq_kernel_wide<<<dim3(BH * G, (mask.Tq + C::BR - 1) / C::BR, nc), THREADS, C::DQ_SMEM,
                         st>>>(q, k, v, dout, lse, D, dq, G, Dh, mask, scale * LOG2E, scale);
  return cudaGetLastError();
}

// past 256, the wide bodies: a multiple of PW
bool wide_dh(int Dh) { return Dh > 256 && Dh % PW == 0; }

template <int DH>
cudaError_t backward(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                     const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                     float* D, int BH, int G, Mask mask, float scale, cudaStream_t st) {
  using C = Bwd<DH>;
  const long long rows = (long long)BH * G * mask.Tq;
  float* colsum = D + rows;
  const long long blocks = (rows + WARPS - 1) / WARPS + (mask.blind < mask.Tq ? BH : 0);
  fa_tc_rowdot_kernel<DH><<<(unsigned)blocks, THREADS, 0, st>>>(dout, o, D, rows, colsum, G,
                                                                  mask, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kkv = fa_tc_dkdv_kernel<DH>;
  if ((e = set_smem(kkv, C::DKDV_SMEM)) != cudaSuccess) return e;
  kkv<<<dim3(BH, (mask.Tk + C::BR - 1) / C::BR), THREADS, C::DKDV_SMEM, st>>>(
      q, k, v, dout, lse, D, colsum, dk, dv, G, mask, scale * LOG2E, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto kq = fa_tc_dq_kernel<DH>;
  if ((e = set_smem(kq, C::DQ_SMEM)) != cudaSuccess) return e;
  kq<<<dim3(BH * G, (mask.Tq + C::BR - 1) / C::BR), THREADS, C::DQ_SMEM, st>>>(
      q, k, v, dout, lse, D, dq, G, mask, scale * LOG2E, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int G, int Tq, int Tk) {
  return BH < 1 || BH > 65535 || G < 1 || G > 65535 || Tq < 1 || Tk < 1 ||
         (long long)BH * G > 0x7fffffffLL;
}

}  // namespace

// flash_attention.cu's interface, for dtype 1 (bfloat16 q, k, v, o and
// gradients) and Dh in {16, 32, 64, 80, 96, 112, 128, 256} or a multiple of
// 128 past 256 (the wrapper zero-pads other head dims to one of these);
// causal 0/1; window <= 0 means none; scale is the true head dim's
// Dh^-0.5 rounded to float32.  Returns 0 or a cudaError_t.
extern "C" int fa_tc_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                             int BH, int G, int Tq, int Tk, int Dh, int dtype, int causal,
                             int window, float scale, void* stream) {
  if (bad_shape(BH, G, Tq, Tk) || dtype != 1) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(Tq, Tk, causal, window);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return (int)forward<16>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 32: return (int)forward<32>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 64: return (int)forward<64>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 80: return (int)forward<80>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 96: return (int)forward<96>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 112: return (int)forward<112>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 128: return (int)forward_wgmma(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    case 256: return (int)forward<256>(qb, kb, vb, ob, l, BH, G, mask, scale, s);
    default:
      if (!wide_dh(Dh)) return (int)cudaErrorInvalidValue;
      return (int)forward_wide(qb, kb, vb, ob, l, BH, G, Dh, mask, scale, s);
  }
}

// D is float32 scratch of BH * G * Tq + BH * Dh elements.
extern "C" int fa_tc_backward(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* D, int BH, int G, int Tq, int Tk, int Dh, int dtype,
                              int causal, int window, float scale, void* stream) {
  if (bad_shape(BH, G, Tq, Tk) || dtype != 1) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(Tq, Tk, causal, window);
  const bf16* a[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<const bf16*>(o)};
  const bf16* g = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  bf16* r[3] = {static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv)};
  float* d = static_cast<float*>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_TC_BWD(N) \
  (int)backward<N>(a[0], a[1], a[2], a[3], l, g, r[0], r[1], r[2], d, BH, G, mask, scale, s)
  switch (Dh) {
    case 16: return FA_TC_BWD(16);
    case 32: return FA_TC_BWD(32);
    case 64: return FA_TC_BWD(64);
    case 80: return FA_TC_BWD(80);
    case 96: return FA_TC_BWD(96);
    case 112: return FA_TC_BWD(112);
    case 128: return FA_TC_BWD(128);
    case 256: return FA_TC_BWD(256);
    default:
      if (!wide_dh(Dh)) return (int)cudaErrorInvalidValue;
      return (int)backward_wide(a[0], a[1], a[2], a[3], l, g, r[0], r[1], r[2], d, BH, G, Dh,
                                mask, scale, s);
  }
#undef FA_TC_BWD
}
