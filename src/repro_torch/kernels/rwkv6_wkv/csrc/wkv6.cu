// The RWKV-6 WKV recurrence for Hopper (sm_90a): forward and gradient.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:
// 23-77 (`_wkv_kernel`, `wkv_forward`), and computes what
// src/repro/models/rwkv6.py:77 (`wkv_scan`) computes: per (batch, head),
// with the state S [Dk, Dv] float32,
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// from an optional initial state (zero without one), with an optional final
// state.  The JAX package has no gradient kernel: JAX differentiates the
// lax.scan of wkv_scan.  The gradient kernels here compute that derivative
// by the reverse recurrence (G_t = dL/dS_t):
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//     dk_t = G_t v_t + u * r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + (sum_i u_i r_ti k_ti) dy_t
//     dw_t = rowsum(G_t * S_{t-1})
//     du_bh = sum_t r_t * k_t (v_t . dy_t)      (summed over the batch outside)
// and G_{-1}, the gradient of the initial state.
//
// Layout: r, k, v, w, y, dy and the input gradients [BH, T, D] float32,
// contiguous; u [H, D] (row bh uses head bh % H); states [BH, D, D] with
// S[i][j] at i * D + j.  D is 16, 32, 64, 128 or 256.
//
// Forward: the state is separable over its columns.  Column j evolves alone
// (S_t[:, j] = w_t * S_{t-1}[:, j] + k_t v_tj), and y_tj needs only it:
// y_tj = sum_i r_ti S_{t-1,ij} + v_tj (r_t . (u * k_t)).  So
// wkv_fwd_split_kernel splits the columns over CTAs: W = 16 columns a CTA,
// D / 16 CTAs a (b, h), adjacent so they share r, k and w in L2 (BH * 4 =
// 512 CTAs of 64 threads at the training path's shape, all resident at
// once), with no sum across CTAs and no atomics.  A thread holds a tile of
// S, FR rows of CQ contiguous columns (4 x 4 for walks of 16 steps or more,
// 8 x 2 for shorter ones such as the decode step, 4 x 2 at D 16), so each
// row value it loads from shared memory serves CQ columns; the P = D / FR
// threads of a column group are neighbouring lanes.  Per step a thread
// keeps its partial sums of r_i S_ij; every LC steps (16; 4 or 8 for short
// walks) one reduce-scatter of shuffles finishes all of them (in a fixed
// order, so the forward is deterministic), and each lane then writes whole
// vectors of y, adding v_tj times the step's r . (u * k), which a few
// threads a step sum before the walk.  Inputs come LC steps at a time
// through cp.async into two shared-memory buffers, the next chunk in flight
// while the current one is computed.  The initial, saved (every CK = 64th
// step) and final states are read and written as vectors of a thread's
// tile.  At the
// training path's shape (BH 128, T 4096, D 64) it does 4*BH*T*D^2 = 8.6e9
// float32 operations (0.128 ms at 67 TFLOP/s) on 0.68 GB of inputs and
// outputs (0.20 ms at 3.35 TB/s): bound by bytes on paper, and by the
// FMA and shuffle issue rate of the serial walk over T in practice.
//
// Gradient: the state is separable.  Row i of S and of G evolves alone
// (S_t[i,:] = w_ti S_{t-1}[i,:] + k_ti v_t, G likewise), and dr, dk, dw and
// du of row i need only row i of S and G plus all of v and dy; column j of
// G evolves alone too, and dv of column j needs only that column and the
// per-step scalar sum_i u_i r_ti k_ti.  So the two kernels split the state
// over rows and over columns, with no sum across CTAs, no atomics and no
// state in device memory, on CTAs of up to 128 threads, the CTAs of one
// (b, h) adjacent so they share their inputs in L2.  The P = D / 8 threads
// of a row (column) are neighbouring lanes, each holding GR = 8 entries.
//   1. wkv_dv_kernel, column split (BH * D / 32 CTAs at D 64): G runs
//      backwards from dL/dS_T (its recurrence needs only w, r and dy).  Each
//      thread holds 8 rows of two columns, since every row value it loads
//      from shared memory then serves two columns: that load rate, not the
//      FMAs, bounds this kernel.  sum_i u_i r_i k_i is one warp's dot
//      product per step.
//   2. wkv_drkw_kernel, row split (BH * D / 16 CTAs at D 64, at most 128
//      registers a thread so four CTAs fit on an SM and the grid runs in
//      one wave), also dL/dS_{-1}: dr and dw need S_{t-1}
//      while G runs backwards, and S is not rebuilt by dividing by w_t
//      (w = exp(-exp(lw)) reaches 0 in float32).  For each CK-step segment,
//      from the last, a forward pass from the forward's saved state writes
//      the state entering every LB = 8th step into shared memory; then each
//      LB-step sub-segment, from the last, is recomputed from its state into
//      registers and walked backwards.  The recomputation costs one more
//      forward pass; the states never leave the SM.
// Per step a thread's sums over its 8 entries are partial; each LB (dv: LV)
// steps the P threads of a row (column) finish all of them at once with a
// reduce-scatter by shuffles (each lane ends holding whole sums of a few
// steps and writes those outputs), log2(P) rounds for 4 * LB sums instead
// of log2(P) rounds per sum.  Inputs come in chunks of steps through
// cp.async into two shared-memory buffers, the next chunk in flight while
// the current one is computed.
//
// Bound: at the training path's shape the gradient does 12*BH*T*D^2 =
// 2.6e10 float32 operations (0.385 ms at 67 TFLOP/s) on 1.21 GB of inputs
// and outputs (0.36 ms), so it is bound by operations on paper.  The
// sub-segment pass recomputes the states a second time (two more
// operations per entry and step), and the shared-memory loads of each
// step's inputs and the serial walk over T stand between it and the FMA
// peak.  A chunked (matrix) form on the tensor cores is later work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (repro_torch/kernels/rwkv6_wkv/
// ops.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 64;  // steps between saved states (a multiple of LC and LB)

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// columns [col0, col0 + W) of steps [t0, t0 + n) of a [T, D] block into
// dst [n][W], by cp.async in 16-byte pieces
template <int D, int NT>
__device__ __forceinline__ void stage_async(float* dst, const float* src, int t0, int n,
                                            int col0, int W) {
  const int per = W / 4;
  for (int x = threadIdx.x; x < n * per; x += NT) {
    const int s = x / per, q = x % per;
    cp16(dst + s * W + 4 * q, src + (size_t)(t0 + s) * D + col0 + 4 * q);
  }
}

// Reduce-scatter over the groups of (initial) 2*S neighbouring lanes: on
// entry each lane holds partial sums x[0, N); on exit lane g of its group
// holds the group's whole sums of entries [g * N / (2S), (g + 1) * N / (2S))
// in x[0, N / (2S)).  Each round a lane keeps one half, sends the other,
// and adds what its partner sent: a fixed order, so the result is
// deterministic.
template <int N, int n, int s>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int g) {
  if constexpr (s > 0) {
    const bool up = (g & s) != 0;
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const float send = up ? x[q] : x[q + n / 2];
      const float keep = up ? x[q + n / 2] : x[q];
      x[q] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
    reduce_scatter<N, n / 2, s / 2>(x, g);
  }
}

// N contiguous floats (N = 1, 2 or 4, aligned to 4N bytes) to and from
// registers
template <int N>
__device__ __forceinline__ void ldv(float (&d)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    d[0] = a.x; d[1] = a.y;
  } else {
    d[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void stv(float* p, const float (&d)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

// ---------------------------------------------------------------------------
// forward: the state split over its columns
// ---------------------------------------------------------------------------

// Each thread holds FR rows of CQ contiguous columns: rows (e / 4) * 4P +
// 4g + e % 4, so its row values are FR / 4 float4s of a step's row; the P
// threads of a column group are neighbouring lanes; a CTA owns W columns and
// takes LC steps a chunk (16; fewer for short T, where the reduce-scatter's
// registers would cost occupancy for nothing).  A tile of four rows of four
// columns (from D 32) loads the fewest row values per FMA, which is what
// long walks need; short ones (the decode step) take eight rows of two,
// whose fewer partial sums and registers finish a step sooner (each
// faster than the other where it is used, timed on an H100).  D 16 takes
// four rows of two.
template <int D, int LC_>
struct FwdSplit {
  static constexpr bool LONG = LC_ >= 16 && D >= 32;
  // rows per thread (8 at D 256, where the D / FR threads of a column group
  // would pass a warp with 4)
  static constexpr int FR = (D >= 32 && !LONG) || D > 128 ? 8 : 4;
  static constexpr int CQ = LONG ? 4 : 2;        // columns per thread
  static constexpr int P = D / FR;               // threads per column group
  static constexpr int W = 16;                   // columns per CTA
  static constexpr int NC = W / CQ;              // column groups per CTA
  static constexpr int NT = NC * P;              // threads per CTA
  static constexpr int CTAS = D / W;             // CTAs per (b, h)
  static constexpr int LC = LC_;                 // steps per chunk
  static constexpr int PER = LC * CQ / P;        // whole sums per lane after the reduce-scatter
  static constexpr int NV = PER < CQ ? PER : CQ; // floats per y store
  static constexpr int TPS = NT / LC;            // threads per step of r . (u * k)
  static constexpr int EV = D / TPS < 4 ? D / TPS : 4;  // its floats per load
  static constexpr int NJ = D / TPS / EV;        // its loads per thread
  // two chunk buffers of r, k, w [LC][D], v [LC][W] and r . (u * k) [LC]
  static constexpr int OFF_K = LC * D, OFF_W = 2 * LC * D, OFF_V = 3 * LC * D;
  static constexpr int OFF_RUK = OFF_V + LC * W;
  static constexpr int STAGE = OFF_RUK + LC;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
  static_assert(FR % 4 == 0 && NT % 32 == 0 && P <= 32 && PER >= 1 && PER % NV == 0 &&
                    NT % LC == 0 && TPS <= 32 && NJ >= 1 && STAGE % 4 == 0 && CK % LC == 0,
                "forward split");
};

// steps [t0, t0 + n) of a [T, D] block into dst [n][D], by cp.async (the
// rows are contiguous, so the pieces need no row/column split)
template <int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int t0, int n) {
  const float* s = src + (size_t)t0 * D;
  for (int x = threadIdx.x; x < n * (D / 4); x += NT) cp16(dst + 4 * x, s + 4 * x);
}

template <int D, int LC_>
__global__ void __launch_bounds__(FwdSplit<D, LC_>::NT)
    wkv_fwd_split_kernel(const float* __restrict__ r, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ w,
                         const float* __restrict__ u, const float* s0, float* __restrict__ y,
                         float* s_out, float* __restrict__ ckpt, int H, int T) {
  using FS = FwdSplit<D, LC_>;
  constexpr int FR = FS::FR, CQ = FS::CQ, PP = FS::P, NT = FS::NT, W = FS::W, LC = FS::LC;
  constexpr int PER = FS::PER, NV = FS::NV, TPS = FS::TPS, EV = FS::EV, NJ = FS::NJ;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x / FS::CTAS, col0 = (blockIdx.x % FS::CTAS) * W;
  const int h = bh % H;
  const int g = threadIdx.x % PP, cg = threadIdx.x / PP;
  const size_t base = (size_t)bh * T * D;
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (T + CK - 1) / CK;
  // this thread's tile in a [D, D] state: row e at tile + row_off(e)
  const int tile = 4 * g * D + col0 + cg * CQ;
  auto row_off = [](int e) { return ((e / 4) * 4 * PP + e % 4) * D; };
  // r . (u * k): the TPS neighbouring threads of step ks each sum NJ pieces
  // of EV entries, piece j at (((j + ks) % NJ) * TPS + q) * EV (rotated by
  // the step, so the steps of a warp fall in different banks)
  const int ks = threadIdx.x / TPS, kq = threadIdx.x % TPS;
  int koff[NJ];
  float uq[NJ][EV];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    koff[j] = (((j + ks) % NJ) * TPS + kq) * EV;
#pragma unroll
    for (int e = 0; e < EV; ++e) uq[j][e] = u[h * D + koff[j] + e];
  }
  float S[FR][CQ];
#pragma unroll
  for (int e = 0; e < FR; ++e) {
    if (s0 != nullptr) {
      ldv<CQ>(S[e], s0 + sbase + tile + row_off(e));
    } else {
#pragma unroll
      for (int c = 0; c < CQ; ++c) S[e][c] = 0.f;
    }
  }

  const int nq = (T + LC - 1) / LC;
  auto prefetch = [&](int q) {
    if (q < nq) {
      float* st = sm + (q & 1) * FS::STAGE;
      const int t0 = q * LC, n = min(LC, T - t0);
      stage_rows<D, NT>(st, r + base, t0, n);
      stage_rows<D, NT>(st + FS::OFF_K, k + base, t0, n);
      stage_rows<D, NT>(st + FS::OFF_W, w + base, t0, n);
      stage_async<D, NT>(st + FS::OFF_V, v + base, t0, n, col0, W);
    }
    cp_commit();
  };
  prefetch(0);
  for (int q = 0; q < nq; ++q) {
    prefetch(q + 1);
    cp_wait_prev();
    __syncthreads();
    const float* st = sm + (q & 1) * FS::STAGE;
    const int t0 = q * LC, n = min(LC, T - t0);
    if (ckpt != nullptr && t0 % CK == 0) {
      float* dst = ckpt + ((size_t)bh * nck + t0 / CK) * D * D + tile;
#pragma unroll
      for (int e = 0; e < FR; ++e) stv<CQ>(dst + row_off(e), S[e]);
    }
    {
      float a = 0.f;
      if (ks < n) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float rr[EV], kk[EV];
          ldv<EV>(rr, st + ks * D + koff[j]);
          ldv<EV>(kk, st + FS::OFF_K + ks * D + koff[j]);
#pragma unroll
          for (int e = 0; e < EV; ++e) a = fmaf(uq[j][e] * rr[e], kk[e], a);
        }
      }
#pragma unroll
      for (int o = TPS / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (kq == 0) sm[(q & 1) * FS::STAGE + FS::OFF_RUK + ks] = a;
    }
    // per step, partial sums over this thread's rows of r_i S_ij, per column
    float x[LC * CQ];
#pragma unroll
    for (int s = 0; s < LC; ++s) {
      float acc[CQ];
#pragma unroll
      for (int c = 0; c < CQ; ++c) acc[c] = 0.f;
      if (s < n) {
        float rr[FR], kk[FR], ww[FR], vv[CQ];
#pragma unroll
        for (int b = 0; b < FR / 4; ++b) {
          const int o = s * D + b * 4 * PP + 4 * g;
          float t4[4];
          ldv<4>(t4, st + o);
#pragma unroll
          for (int e = 0; e < 4; ++e) rr[4 * b + e] = t4[e];
          ldv<4>(t4, st + FS::OFF_K + o);
#pragma unroll
          for (int e = 0; e < 4; ++e) kk[4 * b + e] = t4[e];
          ldv<4>(t4, st + FS::OFF_W + o);
#pragma unroll
          for (int e = 0; e < 4; ++e) ww[4 * b + e] = t4[e];
        }
        ldv<CQ>(vv, st + FS::OFF_V + s * W + cg * CQ);
#pragma unroll
        for (int e = 0; e < FR; ++e)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            acc[c] = fmaf(rr[e], S[e][c], acc[c]);
            S[e][c] = fmaf(ww[e], S[e][c], kk[e] * vv[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) x[s * CQ + c] = acc[c];
    }
    reduce_scatter<LC * CQ, LC * CQ, PP / 2>(x, g);
    __syncthreads();   // the chunk's r . (u * k)
    // this lane's whole sums: entries g*PER .. g*PER + PER - 1 of (step, column)
#pragma unroll
    for (int m = 0; m < PER / NV; ++m) {
      const int idx = g * PER + m * NV, s = idx / CQ, c0 = idx % CQ;
      if (s < n) {
        const float ruk = st[FS::OFF_RUK + s];
        const float* vs = st + FS::OFF_V + s * W + cg * CQ + c0;
        float o[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) o[e] = fmaf(ruk, vs[e], x[m * NV + e]);
        stv<NV>(y + base + (size_t)(t0 + s) * D + col0 + cg * CQ + c0, o);
      }
    }
    __syncthreads();   // before the next prefetch refills this buffer
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int e = 0; e < FR; ++e) stv<CQ>(s_out + sbase + tile + row_off(e), S[e]);
  }
}

// ---------------------------------------------------------------------------
// gradient: the state split over rows (drkw) and over columns (dv)
// ---------------------------------------------------------------------------

constexpr int GT = 128;  // threads per gradient CTA (fewer at D 16)
constexpr int GR = 8;    // state entries per thread: one row's, or one column's
constexpr int LB = 8;    // drkw: steps per sub-segment, whose states sit in registers
constexpr int LV = 16;   // dv: steps per chunk
constexpr int NSUB = CK / LB;

// drkw's split: each thread holds GR = 8 columns of one row
template <int D>
struct Split {
  static constexpr int P = D / GR;                        // threads per row
  static constexpr int NB = GT / P < D ? GT / P : D;      // rows per CTA
  static constexpr int NT = NB * P;                       // threads per CTA
  static constexpr int CTAS = D / NB;                     // CTAs per (b, h)
  // drkw: sub-segment states [NSUB][2][NT][4], then two chunk buffers of
  // r, k, w [LB][NB], v, dy [LB][D] and v.dy [LB]
  static constexpr int OFF_R = 0, OFF_K = LB * NB, OFF_W = 2 * LB * NB;
  static constexpr int OFF_V = 3 * LB * NB, OFF_DY = OFF_V + LB * D;
  static constexpr int OFF_VDY = OFF_DY + LB * D;
  static constexpr int STAGE = OFF_VDY + LB;
  static constexpr int SUBCK = NSUB * GR * NT;
  static constexpr size_t DRKW_SMEM = (SUBCK + 2 * STAGE) * sizeof(float);
  static_assert(P >= 2 && P <= 32 && (4 * LB) % P == 0 && STAGE % 4 == 0, "split");
};

// a thread's 8 entries: e in [0, 8) -> index (e / 4) * 4P + 4g + e % 4
template <int PP>
__device__ __forceinline__ int entry(int e, int g) {
  return (e / 4) * 4 * PP + 4 * g + e % 4;
}

template <int PP>
__device__ __forceinline__ void load8(float (&dst)[GR], const float* row, int g) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * g);
  const float4 b = *reinterpret_cast<const float4*>(row + 4 * PP + 4 * g);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

template <int PP>
__device__ __forceinline__ void store8(float* row, const float (&src)[GR], int g) {
  *reinterpret_cast<float4*>(row + 4 * g) = make_float4(src[0], src[1], src[2], src[3]);
  *reinterpret_cast<float4*>(row + 4 * PP + 4 * g) = make_float4(src[4], src[5], src[6], src[7]);
}

// ---------------------------------------------------------------------------
// gradient 1: dv, column split
// ---------------------------------------------------------------------------

// dv's split: each thread holds GR = 8 rows of CQ columns (two where the
// block still fills a warp), so each row value loaded from shared memory
// serves CQ columns: shared-memory bandwidth bounds this kernel.
template <int D>
struct DvSplit {
  static constexpr int P = D / GR;                       // threads per column group
  static constexpr int CQ = D >= 32 ? 2 : 1;             // columns per thread
  static constexpr int NC = GT / P < D / CQ ? GT / P : D / CQ;  // column groups per CTA
  static constexpr int NT = NC * P;                      // threads per CTA
  static constexpr int W = NC * CQ;                      // columns per CTA
  static constexpr int CTAS = D / W;                     // CTAs per (b, h)
  // two chunk buffers of r, k, w [LV][D], dy [LV][W], sum_i u_i r_i k_i [LV]
  static constexpr int OFF_K = LV * D, OFF_W = 2 * LV * D, OFF_DY = 3 * LV * D;
  static constexpr int OFF_RUK = OFF_DY + LV * W;
  static constexpr int STAGE = OFF_RUK + LV;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
  static_assert(NT >= 32 && (LV * CQ) % P == 0 && STAGE % 4 == 0, "dv split");
};

template <int D>
__global__ void __launch_bounds__(DvSplit<D>::NT)
    wkv_dv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ dy, const float* __restrict__ ds_out,
                  float* __restrict__ dv, int H, int T) {
  using SP = DvSplit<D>;
  constexpr int PP = SP::P, CQ = SP::CQ, NC = SP::NC, NT = SP::NT, W = SP::W;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x / SP::CTAS, col0 = (blockIdx.x % SP::CTAS) * W;
  const int h = bh % H;
  const int g = threadIdx.x % PP, cg = threadIdx.x / PP;   // columns cg + c * NC
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * T * D;
  constexpr int UL = (D + 31) / 32;    // this lane's entries of u, for sum_i u_i r_i k_i
  float ul[UL];
#pragma unroll
  for (int a = 0; a < UL; ++a) ul[a] = lane + 32 * a < D ? u[h * D + lane + 32 * a] : 0.f;
  float G[CQ][GR];
#pragma unroll
  for (int c = 0; c < CQ; ++c)
#pragma unroll
    for (int e = 0; e < GR; ++e)
      G[c][e] = ds_out ? ds_out[(size_t)bh * D * D + (size_t)entry<PP>(e, g) * D + col0 +
                                cg + c * NC]
                       : 0.f;

  const int nq = (T + LV - 1) / LV;   // chunks, walked from the last
  auto prefetch = [&](int q) {
    if (q < nq) {
      float* st = sm + (q & 1) * SP::STAGE;
      const int t0 = (nq - 1 - q) * LV, n = min(LV, T - t0);
      stage_async<D, NT>(st, r + base, t0, n, 0, D);
      stage_async<D, NT>(st + SP::OFF_K, k + base, t0, n, 0, D);
      stage_async<D, NT>(st + SP::OFF_W, w + base, t0, n, 0, D);
      stage_async<D, NT>(st + SP::OFF_DY, dy + base, t0, n, col0, W);
    }
    cp_commit();
  };
  prefetch(0);
  for (int q = 0; q < nq; ++q) {
    prefetch(q + 1);
    cp_wait_prev();
    __syncthreads();
    float* st = sm + (q & 1) * SP::STAGE;
    const int t0 = (nq - 1 - q) * LV, n = min(LV, T - t0);
    // sum_i u_i r_i k_i of each step, one warp per step
    for (int s = warp; s < n; s += NT / 32) {
      float a = 0.f;
#pragma unroll
      for (int b = 0; b < UL; ++b)
        if (lane + 32 * b < D)
          a = fmaf(ul[b] * st[s * D + lane + 32 * b], st[SP::OFF_K + s * D + lane + 32 * b], a);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) st[SP::OFF_RUK + s] = a;
    }
    __syncthreads();
    // per step, partial sums over this thread's 8 rows of G^T k, per column
    float x[LV * CQ];
#pragma unroll
    for (int s = LV - 1; s >= 0; --s) {
      float gk[CQ];
#pragma unroll
      for (int c = 0; c < CQ; ++c) gk[c] = 0.f;
      if (s < n) {
        float rr[GR], kk[GR], ww[GR];
        load8<PP>(rr, st + s * D, g);
        load8<PP>(kk, st + SP::OFF_K + s * D, g);
        load8<PP>(ww, st + SP::OFF_W + s * D, g);
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const float dyj = st[SP::OFF_DY + s * W + cg + c * NC];
#pragma unroll
          for (int e = 0; e < GR; ++e) {
            gk[c] = fmaf(G[c][e], kk[e], gk[c]);
            G[c][e] = fmaf(ww[e], G[c][e], rr[e] * dyj);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) x[s * CQ + c] = gk[c];
    }
    reduce_scatter<LV * CQ, LV * CQ, PP / 2>(x, g);
    constexpr int PER = LV * CQ / PP;  // whole sums per lane
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = g * PER + e, s = idx / CQ, c = idx % CQ;
      if (s < n)
        dv[base + (size_t)(t0 + s) * D + col0 + cg + c * NC] =
            fmaf(st[SP::OFF_RUK + s], st[SP::OFF_DY + s * W + cg + c * NC], x[e]);
    }
    __syncthreads();   // before the next prefetch refills this buffer
  }
}

// ---------------------------------------------------------------------------
// gradient 2: dr, dk, dw, du, dS_{-1}, row split
// ---------------------------------------------------------------------------

struct Chunk {
  int c, b, nsub, t0, n;
  bool back;
};

// The q-th chunk of a CTA's walk: segments from the last; in each, its
// sub-segments forward (the states pass), then backward.
__device__ __forceinline__ Chunk chunk_of(int q, int T, int nck, int last_nsub) {
  int c, rr, nsub;
  if (q < 2 * last_nsub) {
    c = nck - 1;
    rr = q;
    nsub = last_nsub;
  } else {
    const int q2 = q - 2 * last_nsub;
    c = nck - 2 - q2 / (2 * NSUB);
    rr = q2 % (2 * NSUB);
    nsub = NSUB;
  }
  Chunk x;
  x.c = c;
  x.nsub = nsub;
  x.back = rr >= nsub;
  x.b = x.back ? 2 * nsub - 1 - rr : rr;
  x.t0 = c * CK + x.b * LB;
  x.n = min(LB, T - x.t0);
  return x;
}

template <int D>
__global__ void __launch_bounds__(Split<D>::NT, 4)
    wkv_drkw_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ ckpt, const float* __restrict__ ds_out,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ ds0, int H, int T) {
  using SP = Split<D>;
  constexpr int PP = SP::P, NB = SP::NB, NT = SP::NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* subck = sm;                  // [NSUB][2][NT][4]
  const int bh = blockIdx.x / SP::CTAS, row0 = (blockIdx.x % SP::CTAS) * NB;
  const int h = bh % H;
  const int g = threadIdx.x % PP, il = threadIdx.x / PP, i = row0 + il;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * T * D;
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (T + CK - 1) / CK;
  const int last_nsub = (T - (nck - 1) * CK + LB - 1) / LB;
  const int nq = 2 * last_nsub + 2 * NSUB * (nck - 1);
  const float ui = u[h * D + i];
  float G[GR];
  if (ds_out) {
    load8<PP>(G, ds_out + sbase + (size_t)i * D, g);
  } else {
#pragma unroll
    for (int e = 0; e < GR; ++e) G[e] = 0.f;
  }
  float du_acc = 0.f;

  auto prefetch = [&](int q) {
    if (q < nq) {
      const Chunk x = chunk_of(q, T, nck, last_nsub);
      float* st = sm + SP::SUBCK + (q & 1) * SP::STAGE;
      stage_async<D, NT>(st + SP::OFF_K, k + base, x.t0, x.n, row0, NB);
      stage_async<D, NT>(st + SP::OFF_W, w + base, x.t0, x.n, row0, NB);
      stage_async<D, NT>(st + SP::OFF_V, v + base, x.t0, x.n, 0, D);
      if (x.back) {
        stage_async<D, NT>(st + SP::OFF_R, r + base, x.t0, x.n, row0, NB);
        stage_async<D, NT>(st + SP::OFF_DY, dy + base, x.t0, x.n, 0, D);
      }
    }
    cp_commit();
  };
  // this thread's slot of sub-segment state b: two float4 NT apart
  auto sub_slot = [&](int b) { return subck + ((size_t)b * 2 * NT + threadIdx.x) * 4; };
  auto put_slot = [&](float* slot, const float (&a)[GR]) {
    *reinterpret_cast<float4*>(slot) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(slot + 4 * NT) = make_float4(a[4], a[5], a[6], a[7]);
  };
  auto get_slot = [&](float (&a)[GR], const float* slot) {
    const float4 p = *reinterpret_cast<const float4*>(slot);
    const float4 q = *reinterpret_cast<const float4*>(slot + 4 * NT);
    a[0] = p.x; a[1] = p.y; a[2] = p.z; a[3] = p.w;
    a[4] = q.x; a[5] = q.y; a[6] = q.z; a[7] = q.w;
  };

  prefetch(0);
  for (int q = 0; q < nq; ++q) {
    prefetch(q + 1);
    cp_wait_prev();
    __syncthreads();
    const Chunk x = chunk_of(q, T, nck, last_nsub);
    float* st = sm + SP::SUBCK + (q & 1) * SP::STAGE;
    const float* sk = st + SP::OFF_K + il;
    const float* sw = st + SP::OFF_W + il;
    if (!x.back) {
      // the states pass: the state entering each sub-segment, into shared
      // memory (each thread reads back only what it wrote)
      float S[GR];
      if (x.b == 0) {
        load8<PP>(S, ckpt + ((size_t)bh * nck + x.c) * D * D + (size_t)i * D, g);
        put_slot(sub_slot(0), S);
      } else {
        get_slot(S, sub_slot(x.b));
      }
#pragma unroll
      for (int s = 0; s < LB; ++s) {
        if (s < x.n) {
          float vv[GR];
          load8<PP>(vv, st + SP::OFF_V + s * D, g);
          const float ki = sk[s * NB], wi = sw[s * NB];
#pragma unroll
          for (int e = 0; e < GR; ++e) S[e] = fmaf(wi, S[e], ki * vv[e]);
        }
      }
      if (x.b + 1 < x.nsub) put_slot(sub_slot(x.b + 1), S);
    } else {
      // v . dy of each step of the chunk, one warp per step
      for (int s = warp; s < x.n; s += NT / 32) {
        float a = 0.f;
        for (int jj = lane; jj < D; jj += 32)
          a = fmaf(st[SP::OFF_V + s * D + jj], st[SP::OFF_DY + s * D + jj], a);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) st[SP::OFF_VDY + s] = a;
      }
      __syncthreads();
      // the sub-segment's states S_{t-1}, recomputed into registers
      float Ss[LB][GR];
      get_slot(Ss[0], sub_slot(x.b));
#pragma unroll
      for (int s = 0; s + 1 < LB; ++s) {
        if (s + 1 < x.n) {
          float vv[GR];
          load8<PP>(vv, st + SP::OFF_V + s * D, g);
          const float ki = sk[s * NB], wi = sw[s * NB];
#pragma unroll
          for (int e = 0; e < GR; ++e) Ss[s + 1][e] = fmaf(wi, Ss[s][e], ki * vv[e]);
        }
      }
      // backwards through the sub-segment; per step partial sums over this
      // thread's 8 columns of dy.S, G.v and G.S
      float xs[4 * LB];
#pragma unroll
      for (int s = LB - 1; s >= 0; --s) {
        float dyS = 0.f, Gv = 0.f, GS = 0.f;
        if (s < x.n) {
          float vv[GR], dd[GR];
          load8<PP>(vv, st + SP::OFF_V + s * D, g);
          load8<PP>(dd, st + SP::OFF_DY + s * D, g);
          const float ri = st[SP::OFF_R + s * NB + il], wi = sw[s * NB];
#pragma unroll
          for (int e = 0; e < GR; ++e) {
            dyS = fmaf(dd[e], Ss[s][e], dyS);
            Gv = fmaf(G[e], vv[e], Gv);
            GS = fmaf(G[e], Ss[s][e], GS);
            G[e] = fmaf(wi, G[e], ri * dd[e]);
          }
        }
        xs[4 * s] = dyS;
        xs[4 * s + 1] = Gv;
        xs[4 * s + 2] = GS;
        xs[4 * s + 3] = 0.f;
      }
      reduce_scatter<4 * LB, 4 * LB, PP / 2>(xs, g);
      constexpr int PER = 4 * LB / PP;   // whole sums per lane
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = g * PER + e, s = idx / 4, kind = idx % 4;
        if (s < x.n && kind < 3) {
          const size_t o = base + (size_t)(x.t0 + s) * D + i;
          const float ri = st[SP::OFF_R + s * NB + il], ki = sk[s * NB];
          const float vdy = st[SP::OFF_VDY + s];
          if (kind == 0) {
            dr[o] = fmaf(ui * ki, vdy, xs[e]);
            du_acc = fmaf(ri * ki, vdy, du_acc);
          } else if (kind == 1) {
            dk[o] = fmaf(ui * ri, vdy, xs[e]);
          } else {
            dw[o] = xs[e];
          }
        }
      }
    }
    __syncthreads();   // before the next prefetch refills this buffer
  }
#pragma unroll
  for (int o = PP / 2; o > 0; o >>= 1) du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (g == 0) du_part[(size_t)bh * D + i] = du_acc;
  if (ds0 != nullptr) store8<PP>(ds0 + sbase + (size_t)i * D, G, g);
}

template <int D, int LC>
cudaError_t forward_lc(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* s0, float* y, float* s_out, float* ckpt,
                       int BH, int H, int T, cudaStream_t st) {
  using FS = FwdSplit<D, LC>;
  // only a block above the default 48 KB of dynamic shared memory needs the
  // attribute; the short chunks of the decode step stay under it
  if constexpr (FS::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(wkv_fwd_split_kernel<D, LC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)FS::SMEM);
    if (e != cudaSuccess) return e;
  }
  wkv_fwd_split_kernel<D, LC><<<BH * FS::CTAS, FS::NT, FS::SMEM, st>>>(r, k, v, w, u, s0, y,
                                                                       s_out, ckpt, H, T);
  return cudaGetLastError();
}

// chunks of 16 steps; of the fewest that still give each lane a whole sum
// where T is shorter (the decode step: T = 1; at D 256 that is 16 too)
template <int D>
cudaError_t forward(const float* r, const float* k, const float* v, const float* w,
                    const float* u, const float* s0, float* y, float* s_out, float* ckpt,
                    int BH, int H, int T, cudaStream_t st) {
  constexpr int SHORT = D == 256 ? 16 : D == 128 ? 8 : 4;
  if (T < 16) return forward_lc<D, SHORT>(r, k, v, w, u, s0, y, s_out, ckpt, BH, H, T, st);
  return forward_lc<D, 16>(r, k, v, w, u, s0, y, s_out, ckpt, BH, H, T, st);
}

template <int D>
cudaError_t backward(const float* r, const float* k, const float* v, const float* w,
                     const float* u, const float* dy, const float* ckpt,
                     const float* ds_out, float* dr, float* dk, float* dv, float* dw,
                     float* du_part, float* ds0, int BH, int H, int T, cudaStream_t st) {
  using SP = Split<D>;
  using DP = DvSplit<D>;
  cudaError_t e = cudaFuncSetAttribute(wkv_dv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DP::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wkv_drkw_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SP::DRKW_SMEM);
  if (e != cudaSuccess) return e;
  wkv_dv_kernel<D><<<BH * DP::CTAS, DP::NT, DP::SMEM, st>>>(r, k, w, u, dy, ds_out, dv, H, T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv_drkw_kernel<D><<<BH * SP::CTAS, SP::NT, SP::DRKW_SMEM, st>>>(
      r, k, v, w, u, dy, ckpt, ds_out, dr, dk, dw, du_part, ds0, H, T);
  return cudaGetLastError();
}

bool bad_shape(int BH, int H, int T) { return BH < 1 || H < 1 || BH % H != 0 || T < 1; }

}  // namespace

#define F(x) static_cast<const float*>(x)
#define M(x) static_cast<float*>(x)

// s0, s_out and ckpt may be null (zero start; no final state; no
// checkpoints).  s0 and s_out may be the same buffer.  ckpt holds
// BH * ceil(T / 64) * D * D floats.  Returns 0 or a cudaError_t.
extern "C" int wkv_forward(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s0, void* y, void* s_out, void* ckpt,
                           int BH, int H, int T, int D, void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)forward<16>(F(r), F(k), F(v), F(w), F(u), F(s0), M(y), M(s_out), M(ckpt), BH, H, T, s);
    case 32: return (int)forward<32>(F(r), F(k), F(v), F(w), F(u), F(s0), M(y), M(s_out), M(ckpt), BH, H, T, s);
    case 64: return (int)forward<64>(F(r), F(k), F(v), F(w), F(u), F(s0), M(y), M(s_out), M(ckpt), BH, H, T, s);
    case 128: return (int)forward<128>(F(r), F(k), F(v), F(w), F(u), F(s0), M(y), M(s_out), M(ckpt), BH, H, T, s);
    case 256: return (int)forward<256>(F(r), F(k), F(v), F(w), F(u), F(s0), M(y), M(s_out), M(ckpt), BH, H, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ckpt is the forward's; ds_out (the final state's gradient) and ds0 (the
// initial state's) may be null.  du_part holds BH * D floats.  Every
// pointer is 16-byte aligned.
extern "C" int wkv_backward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* dy, const void* ckpt,
                            const void* ds_out, void* dr, void* dk, void* dv, void* dw,
                            void* du_part, void* ds0, int BH, int H, int T, int D,
                            void* stream) {
  if (bad_shape(BH, H, T) || ckpt == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B_ARGS F(r), F(k), F(v), F(w), F(u), F(dy), F(ckpt), F(ds_out), M(dr), M(dk), \
               M(dv), M(dw), M(du_part), M(ds0), BH, H, T, s
  switch (D) {
    case 16: return (int)backward<16>(B_ARGS);
    case 32: return (int)backward<32>(B_ARGS);
    case 64: return (int)backward<64>(B_ARGS);
    case 128: return (int)backward<128>(B_ARGS);
    case 256: return (int)backward<256>(B_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B_ARGS
}
