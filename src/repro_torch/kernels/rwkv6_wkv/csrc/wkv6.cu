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
// S[i][j] at i * D + j.  D is 16, 32, 64 or 128.
//
// The TPU kernel walked a sequential (BH, chunks) grid and carried S in a
// VMEM scratch.  Here one CTA owns one (b, h) and carries S in registers
// through a loop over T; the CTAs run in parallel.
//   * forward, "column" layout: P = 4 threads per value column j, thread
//     (j, p) holding S[i][j] for the D/P rows i = ii*P + p.  Each step the
//     P threads of a column sum r_i (S_ij + u_i k_i v_j) over their rows and
//     finish with two shuffles; then S_ij <- w_i S_ij + k_i v_j.  Inputs are
//     staged in shared memory C = 16 steps at a time with float4 loads.
//     With a checkpoint buffer, the state entering every CK = 64th step is
//     written out for the gradient.
//   * gradient, two kernels, no float atomics (deterministic):
//     1. dv, column layout: G runs backwards from dL/dS_T without S, since
//        its recurrence needs only w, r and dy; dv_j sums over rows like y.
//     2. dr, dk, dw, du and G_{-1}, "row" layout: thread (i, p) holds G[i][j]
//        and S[i][j] for the D/P columns j = jj*P + p, so the sums over j
//        finish with two shuffles.  dw_t needs S_{t-1} while G runs
//        backwards.  S is not rebuilt by dividing by w_t (w = exp(-exp(lw))
//        reaches 0 in float32): the CTA walks the CK-step segments from the
//        last, recomputes each segment's CK states forward from the saved
//        checkpoint into a scratch of CK * D * D floats per CTA (each thread
//        writes and reads back only its own slice), then walks the segment
//        backwards, prefetching the next state slice one step ahead.
//
// Bound: the recurrence is serial in T, and each CTA does D*D*O(1) work per
// step.  At the training path's shape (BH 128, T 4096, D 64) the forward
// does 4*BH*T*D^2 = 8.6e9 float32 operations (0.128 ms at 67 TFLOP/s) on
// 0.68 GB of inputs and outputs (0.20 ms at 3.35 TB/s), so it is bound by
// bytes on paper; in practice one CTA per (b, h) walks T steps one
// after another, and the step's latency (shared-memory loads, two shuffles,
// a barrier every C steps) bounds it.  Splitting a column over P threads
// puts 4x more warps on each SM than one thread per column; a chunked
// (matrix) form of the recurrence on the tensor cores is later work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (repro_torch/kernels/rwkv6_wkv/
// ops.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 4;    // threads per state column (forward, dv) or row
constexpr int C = 16;   // time steps staged in shared memory at once
constexpr int CK = 64;  // steps between saved states (a multiple of C)

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// a thread's slice of one recomputed state in the gradient's scratch
template <int R>
__device__ __forceinline__ void load_slice(float (&dst)[R], const float* scr, int step,
                                           int nthreads) {
  const float4* src =
      reinterpret_cast<const float4*>(scr + ((size_t)step * nthreads + threadIdx.x) * R);
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 x = src[q];
    dst[4 * q] = x.x;
    dst[4 * q + 1] = x.y;
    dst[4 * q + 2] = x.z;
    dst[4 * q + 3] = x.w;
  }
}

// steps [t0, t0 + n) of one (b, h) row block [T, D] into dst [C][D]
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int t0, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)t0 * D);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int x = threadIdx.x; x < n * (D / 4); x += D * P) d4[x] = s4[x];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(D * P)
    wkv_forward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, const float* s0, float* __restrict__ y,
                       float* s_out, float* __restrict__ ckpt, int H, int T) {
  constexpr int R = D / P;
  __shared__ __align__(16) float sr[C * D];
  __shared__ __align__(16) float sk[C * D];
  __shared__ __align__(16) float sv[C * D];
  __shared__ __align__(16) float sw[C * D];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x / P, p = threadIdx.x % P;
  const size_t base = (size_t)bh * T * D;
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (T + CK - 1) / CK;
  float S[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = ii * P + p;
    uu[ii] = u[h * D + i];
    S[ii] = s0 ? s0[sbase + i * D + j] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    __syncthreads();
    stage<D>(sr, r + base, t0, n);
    stage<D>(sk, k + base, t0, n);
    stage<D>(sv, v + base, t0, n);
    stage<D>(sw, w + base, t0, n);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      if (ckpt != nullptr && t % CK == 0) {
        float* dst = ckpt + ((size_t)bh * nck + t / CK) * D * D;
#pragma unroll
        for (int ii = 0; ii < R; ++ii) dst[(ii * P + p) * D + j] = S[ii];
      }
      const float* rs = sr + s * D;
      const float* ks = sk + s * D;
      const float* ws = sw + s * D;
      const float vj = sv[s * D + j];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = ii * P + p;
        const float kv = ks[i] * vj;
        acc = fmaf(rs[i], S[ii] + uu[ii] * kv, acc);
        S[ii] = fmaf(ws[i], S[ii], kv);
      }
      acc = group_sum(acc);
      if (p == 0) y[base + (size_t)t * D + j] = acc;
    }
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int ii = 0; ii < R; ++ii) s_out[sbase + (ii * P + p) * D + j] = S[ii];
  }
}

// ---------------------------------------------------------------------------
// gradient 1: dv (column layout)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(D * P)
    wkv_dv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ dy, const float* __restrict__ ds_out,
                  float* __restrict__ dv, int H, int T) {
  constexpr int R = D / P;
  __shared__ __align__(16) float sr[C * D];
  __shared__ __align__(16) float sk[C * D];
  __shared__ __align__(16) float sw[C * D];
  __shared__ __align__(16) float sd[C * D];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x / P, p = threadIdx.x % P;
  const size_t base = (size_t)bh * T * D;
  float G[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = ii * P + p;
    uu[ii] = u[h * D + i];
    G[ii] = ds_out ? ds_out[(size_t)bh * D * D + i * D + j] : 0.f;
  }
  for (int t0 = ((T - 1) / C) * C; t0 >= 0; t0 -= C) {
    const int n = min(C, T - t0);
    __syncthreads();
    stage<D>(sr, r + base, t0, n);
    stage<D>(sk, k + base, t0, n);
    stage<D>(sw, w + base, t0, n);
    stage<D>(sd, dy + base, t0, n);
    __syncthreads();
    for (int s = n - 1; s >= 0; --s) {
      const float* rs = sr + s * D;
      const float* ks = sk + s * D;
      const float* ws = sw + s * D;
      const float dyj = sd[s * D + j];
      float gk = 0.f, ruk = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = ii * P + p;
        gk = fmaf(G[ii], ks[i], gk);
        ruk = fmaf(uu[ii] * rs[i], ks[i], ruk);
        G[ii] = fmaf(ws[i], G[ii], rs[i] * dyj);
      }
      gk = group_sum(gk);
      ruk = group_sum(ruk);
      if (p == 0) dv[base + (size_t)(t0 + s) * D + j] = fmaf(ruk, dyj, gk);
    }
  }
}

// ---------------------------------------------------------------------------
// gradient 2: dr, dk, dw, du, dS_{-1} (row layout)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(D * P)
    wkv_drkw_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ ckpt, const float* __restrict__ ds_out,
                    float* scratch, float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ ds0, int H, int T) {
  constexpr int R = D / P;
  __shared__ __align__(16) float sr[C * D];
  __shared__ __align__(16) float sk[C * D];
  __shared__ __align__(16) float sv[C * D];
  __shared__ __align__(16) float sw[C * D];
  __shared__ __align__(16) float sd[C * D];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int i = threadIdx.x / P, p = threadIdx.x % P;
  const size_t base = (size_t)bh * T * D;
  const size_t sbase = (size_t)bh * D * D;
  const int nck = (T + CK - 1) / CK;
  // this thread's slice of each of the CK recomputed states: R floats at
  // (step * D * P + threadIdx.x) * R
  float* scr = scratch + (size_t)bh * CK * D * D;
  const float ui = u[h * D + i];
  float G[R], S[R], Sp[R], Sn[R];
#pragma unroll
  for (int jj = 0; jj < R; ++jj) G[jj] = ds_out ? ds_out[sbase + i * D + jj * P + p] : 0.f;
  float du_acc = 0.f;

  for (int c = nck - 1; c >= 0; --c) {
    const int c0 = c * CK;
    const int cn = min(CK, T - c0);
    // (a) the segment's states S_{t-1}, forward from its checkpoint
    const float* ck = ckpt + ((size_t)bh * nck + c) * D * D;
#pragma unroll
    for (int jj = 0; jj < R; ++jj) S[jj] = ck[i * D + jj * P + p];
    for (int t0 = c0; t0 < c0 + cn; t0 += C) {
      const int n = min(C, c0 + cn - t0);
      __syncthreads();
      stage<D>(sk, k + base, t0, n);
      stage<D>(sv, v + base, t0, n);
      stage<D>(sw, w + base, t0, n);
      __syncthreads();
      for (int s = 0; s < n; ++s) {
        float4* dst = reinterpret_cast<float4*>(
            scr + ((size_t)(t0 - c0 + s) * D * P + threadIdx.x) * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
          dst[q] = make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2], S[4 * q + 3]);
        const float ki = sk[s * D + i], wi = sw[s * D + i];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) S[jj] = fmaf(wi, S[jj], ki * sv[s * D + jj * P + p]);
      }
    }
    // (b) the segment backwards
    load_slice<R>(Sn, scr, cn - 1, D * P);
    for (int t0 = c0 + ((cn - 1) / C) * C; t0 >= c0; t0 -= C) {
      const int n = min(C, c0 + cn - t0);
      __syncthreads();
      stage<D>(sr, r + base, t0, n);
      stage<D>(sk, k + base, t0, n);
      stage<D>(sv, v + base, t0, n);
      stage<D>(sw, w + base, t0, n);
      stage<D>(sd, dy + base, t0, n);
      __syncthreads();
      for (int s = n - 1; s >= 0; --s) {
        const int step = t0 - c0 + s;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) Sp[jj] = Sn[jj];
        if (step > 0) load_slice<R>(Sn, scr, step - 1, D * P);
        const float ri = sr[s * D + i], ki = sk[s * D + i], wi = sw[s * D + i];
        const float* vs = sv + s * D;
        const float* ds = sd + s * D;
        float dyS = 0.f, Gv = 0.f, GS = 0.f, vdy = 0.f;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int j = jj * P + p;
          const float vj = vs[j], dyj = ds[j];
          dyS = fmaf(dyj, Sp[jj], dyS);
          Gv = fmaf(G[jj], vj, Gv);
          GS = fmaf(G[jj], Sp[jj], GS);
          vdy = fmaf(vj, dyj, vdy);
          G[jj] = fmaf(wi, G[jj], ri * dyj);
        }
        dyS = group_sum(dyS);
        Gv = group_sum(Gv);
        GS = group_sum(GS);
        vdy = group_sum(vdy);
        du_acc = fmaf(ri * ki, vdy, du_acc);
        if (p == 0) {
          const size_t o = base + (size_t)(t0 + s) * D + i;
          dr[o] = fmaf(ui * ki, vdy, dyS);
          dk[o] = fmaf(ui * ri, vdy, Gv);
          dw[o] = GS;
        }
      }
    }
  }
  if (p == 0) du_part[(size_t)bh * D + i] = du_acc;
  if (ds0 != nullptr) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj) ds0[sbase + i * D + jj * P + p] = G[jj];
  }
}

template <int D>
cudaError_t forward(const float* r, const float* k, const float* v, const float* w,
                    const float* u, const float* s0, float* y, float* s_out, float* ckpt,
                    int BH, int H, int T, cudaStream_t st) {
  wkv_forward_kernel<D><<<BH, D * P, 0, st>>>(r, k, v, w, u, s0, y, s_out, ckpt, H, T);
  return cudaGetLastError();
}

template <int D>
cudaError_t backward(const float* r, const float* k, const float* v, const float* w,
                     const float* u, const float* dy, const float* ckpt,
                     const float* ds_out, float* scratch, float* dr, float* dk, float* dv,
                     float* dw, float* du_part, float* ds0, int BH, int H, int T,
                     cudaStream_t st) {
  wkv_dv_kernel<D><<<BH, D * P, 0, st>>>(r, k, w, u, dy, ds_out, dv, H, T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv_drkw_kernel<D><<<BH, D * P, 0, st>>>(r, k, v, w, u, dy, ckpt, ds_out, scratch, dr,
                                           dk, dw, du_part, ds0, H, T);
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// ckpt is the forward's; ds_out (the final state's gradient) and ds0 (the
// initial state's) may be null.  scratch holds BH * 64 * D * D floats,
// du_part BH * D.
extern "C" int wkv_backward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* dy, const void* ckpt,
                            const void* ds_out, void* scratch, void* dr, void* dk, void* dv,
                            void* dw, void* du_part, void* ds0, int BH, int H, int T, int D,
                            void* stream) {
  if (bad_shape(BH, H, T) || ckpt == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B_ARGS F(r), F(k), F(v), F(w), F(u), F(dy), F(ckpt), F(ds_out), M(scratch), M(dr), \
               M(dk), M(dv), M(dw), M(du_part), M(ds0), BH, H, T, s
  switch (D) {
    case 16: return (int)backward<16>(B_ARGS);
    case 32: return (int)backward<32>(B_ARGS);
    case 64: return (int)backward<64>(B_ARGS);
    case 128: return (int)backward<128>(B_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B_ARGS
}
