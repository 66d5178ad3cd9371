// Paged-attention decode for Hopper (sm_90a): one new query token per
// sequence, G query heads per KV head, attending to a K/V cache kept as
// fixed-size pages scattered in a pool and found through a page table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:26-102 (`_pa_kernel` and `paged_attention`).  It
// computes the same function; it is not carried over block by block:
//
//   * one block per (sequence, KV head), 128 threads.  The TPU walked a
//     sequential (B, Hkv, max_pages) grid and carried the softmax state in
//     VMEM scratch across grid steps; here a loop over the sequence's pages
//     inside the block carries it (running max m, running sum l per query
//     row in shared memory, the G x Dh accumulator in registers);
//   * the block reads its own page ids from the table, which takes the
//     place of the TPU's scalar prefetch, and stages each page's K and V
//     tile in shared memory with all its threads (the page is contiguous
//     in the pool), so a page costs one round trip to memory, not one per
//     key row;
//   * the loop stops after ceil(len / page_size) pages.  The TPU walked all
//     max_pages pages and masked those past the length: a fully masked page
//     adds exp(-1e30 - m) = 0 to the sum and scales by exp(0) = 1, so the
//     result is the same.  A length <= 0 masks every position; the
//     reference then averages V over every page of the table, so the loop
//     walks all max_pages pages for it;
//   * scores are float32 (q promoted, as the TPU's preferred_element_type),
//     multiplied by Dh^-0.5 after the dot product, masked to the finite
//     -1e30 at and past the length; p is rounded to the pools' dtype before
//     the PV product, the output is acc / max(l, 1e-30) cast to q's dtype.
//
// Bound: bytes.  Each valid page's K and V tile is read once (16 KB per
// page and head in float32 at page 16, Dh 128), against 2*G multiply-adds
// per element read.  At the serving path's shapes (B 8, Hkv 8) it runs only
// B*Hkv = 64 blocks on 132 SMs; splitting a sequence's pages across blocks
// (a second reduction pass) is later performance work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (repro_torch/kernels/
// paged_attention/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;              // query heads per KV head
constexpr int MAX_DH = 256;            // head dim
constexpr int COLS = MAX_DH / THREADS; // V columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ lens, TQ* __restrict__ out,
                       int Hkv, int G, int Dh, int n_pool, int page_size,
                       int max_pages, float scale) {
  extern __shared__ float smem[];
  const int tile = page_size * Dh;
  float* q_s = smem;                    // [G][Dh] query rows, float32
  float* k_s = q_s + G * Dh;            // [page_size][Dh] this page's K
  float* v_s = k_s + tile;              // [page_size][Dh] this page's V
  float* s_s = v_s + tile;              // [G][page_size] scores, then p
  float* m_s = s_s + G * page_size;     // [G] running max
  float* l_s = m_s + G;                 // [G] running sum
  float* c_s = l_s + G;                 // [G] this page's correction

  const int bh = blockIdx.x;            // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const TQ* qp = q + (size_t)bh * G * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) q_s[i] = to_f32(qp[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int len = lens[b];
  const int n_iter = len > 0 ? min((len + page_size - 1) / page_size, max_pages)
                             : max_pages;
  const TKV* kh = k_pool + (size_t)h * n_pool * tile;
  const TKV* vh = v_pool + (size_t)h * n_pool * tile;

  float acc[MAX_G][COLS];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[g][c] = 0.f;

  for (int pi = 0; pi < n_iter; ++pi) {
    // attend() clamps the table to >= 0; this only keeps reads in the pool
    const int phys = min(max(table[(size_t)b * max_pages + pi], 0), n_pool - 1);
    const TKV* kp = kh + (size_t)phys * tile;
    const TKV* vp = vh + (size_t)phys * tile;

    // the page's K and V tiles (contiguous in the pool) into shared
    // memory, all threads, many loads in flight
#pragma unroll 4
    for (int i = tid; i < tile; i += THREADS) {
      k_s[i] = to_f32(kp[i]);
      v_s[i] = to_f32(vp[i]);
    }
    __syncthreads();

    // scores: warp w takes key rows w, w + WARPS, ...; lanes split Dh
    for (int j = warp; j < page_size; j += WARPS) {
      const bool valid = pi * page_size + j < len;
      const float* kr = k_s + j * Dh;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < Dh; d += 32) part += q_s[g * Dh + d] * kr[d];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) s_s[g * page_size + j] = valid ? part * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this page, one thread per query row
    if (tid < G) {
      float* srow = s_s + tid * page_size;
      float mx = NEG_INF;
      for (int j = 0; j < page_size; ++j) mx = fmaxf(mx, srow[j]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < page_size; ++j) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        srow[j] = to_f32(from_f32<TKV>(p));   // p in the pools' dtype
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ V, thread t owning columns t, t + THREADS
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tid + c * THREADS;
      if (d >= Dh) continue;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      for (int j = 0; j < page_size; ++j) {
        const float vj = v_s[j * Dh + d];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += s_s[g * page_size + j] * vj;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g][c] = acc[g][c] * c_s[g] + part[g];
    }
    __syncthreads();   // the tiles, s_s and c_s are rewritten by the next page
  }

  TQ* op = out + (size_t)bh * G * Dh;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = tid + c * THREADS;
    if (d >= Dh) continue;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) op[g * Dh + d] = from_f32<TQ>(acc[g][c] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lens, void* out, int B, int Hkv,
                   int G, int Dh, int n_pool, int page_size, int max_pages,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * Dh + 2 * (size_t)page_size * Dh +
                                       (size_t)G * page_size + 3 * G);
  auto kern = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), table, lens, static_cast<TQ*>(out), Hkv, G,
      Dh, n_pool, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; scale is Dh^-0.5 rounded to float32
// by the caller.  Returns 0 or a cudaError_t.
extern "C" int pa_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* lens, void* out,
                                  int B, int Hkv, int G, int Dh, int n_pool,
                                  int page_size, int max_pages, int q_dtype,
                                  int kv_dtype, float scale, void* stream) {
  if (G < 1 || G > MAX_G || Dh < 1 || Dh > MAX_DH || page_size < 1 || max_pages < 1 ||
      n_pool < 1 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0)
    e = launch<float, float>(q, k_pool, v_pool, t, l, out, B, Hkv, G, Dh, n_pool, page_size, max_pages, scale, s);
  else if (q_dtype == 0)
    e = launch<float, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, B, Hkv, G, Dh, n_pool, page_size, max_pages, scale, s);
  else if (kv_dtype == 0)
    e = launch<__nv_bfloat16, float>(q, k_pool, v_pool, t, l, out, B, Hkv, G, Dh, n_pool, page_size, max_pages, scale, s);
  else
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, B, Hkv, G, Dh, n_pool, page_size, max_pages, scale, s);
  return (int)e;
}
