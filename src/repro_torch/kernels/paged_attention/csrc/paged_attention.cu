// Paged-attention decode for Hopper (sm_90a): one new query token per
// sequence, G query heads per KV head, attending to a K/V cache kept as
// fixed-size pages scattered in a pool and found through a page table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:26-102 (`_pa_kernel` and `paged_attention`).  It
// computes the same function; it is not carried over block by block.
//
// What it computes: scores q.k in float32 (q promoted, as the TPU's
// preferred_element_type), multiplied by Dh^-0.5 after the dot product,
// positions at or past a sequence's length masked to the finite -1e30; p is
// rounded to the pools' dtype before the PV product; the output is
// acc / max(l, 1e-30) cast to q's dtype.  Table entries are clamped to
// [0, n_pool).  The TPU walked all max_pages pages and masked those past the
// length; a key past the length adds exp(-1e30 - m) = 0 once a valid key has
// set m, so only the keys below the length are visited.  A length <= 0
// masks every position, and the reference then averages V over every key
// of every page of the table: such a sequence visits all max_pages pages,
// each key with p = 1.
//
// Bound: bytes.  Each valid key's K and V rows are read once (1 KB per key
// and KV head in float32 at Dh 128), against 2 G multiply-adds per element
// read.  So the design is about keeping enough bytes in flight:
//
//   * split-K over pages (flash-decoding): grid (B * Hkv, n_split); CTA s of
//     a (sequence, KV head) takes pages [s * pps, (s + 1) * pps) and writes
//     a partial (m, l, acc[G][Dh]) in float32 to a scratch the wrapper
//     allocates.  The TPU walked a sequential (B, Hkv, max_pages) grid and
//     carried the softmax state in VMEM scratch; one CTA per (sequence,
//     head) gives only 64 CTAs on 132 SMs at the serving shape.  pps comes
//     from max_pages and B * Hkv on the host (ops.splits), never from the
//     lengths: the launch needs no host sync.  A CTA whose pages lie past
//     the length writes an empty partial (m = -1e30, l = 0) and exits;
//   * a second kernel merges the partials of each (sequence, head) in split
//     order, M = max m_s, L = sum l_s e^(m_s - M), O = sum acc_s e^(m_s - M)
//     / max(L, 1e-30), skipping the empty ones.  No float atomics, so two
//     calls give the same bits;
//   * asynchronous, vectorised loads: the CTA's keys are walked in chunks of
//     32 (a page's rows are contiguous in the pool, so a chunk may span
//     pages); each chunk's K and V rows come in with 16-byte cp.async into a
//     ring of up to 3 stages in shared memory, in the pools' dtype, so the
//     next chunks are in flight while this one's scores and PV run.  Rows of
//     a head dim whose bytes are not a multiple of 16 (or pools not 16-byte
//     aligned) are copied element by element instead;
//   * two barriers per chunk: thread (warp w, lane j) computes the scores of
//     key j for the query rows g = w, w + 4, ... over all of Dh (K row read
//     as 16-byte vectors from a padded, conflict-free layout; q broadcast);
//     the warp then runs the online-softmax update of its rows across its
//     32 lanes (shuffle max and sum) and writes p and the correction to
//     shared memory; after the barrier thread t accumulates acc[g][d] for
//     its columns d = t, t + 128 over the chunk's 32 keys.
//
// Head dims past MAX_DH (256) run as column chunks on a third grid axis,
// (B * Hkv, n_split, ceil(Dh / 256)), in `paged_attention_wide_kernel`: each
// CTA computes the scores over the whole Dh and accumulates only its own
// chunk of at most 256 output columns, so `acc` keeps COLS = 2 columns a
// thread.  Its ring holds units of [KC][256] pool elements: for each chunk
// of 32 keys, the ceil(Dh / 256) pieces of K in order (the scores reduce
// over them in the order the Dh <= 256 kernel reduces over one row, so every
// chunk's CTA gets the same scores and softmax statistics bit for bit), then
// the CTA's own columns of V.  A unit is 32 KB at float32 (three fit
// STAGE_BUDGET, where a chunk of full K rows at Dh 512 would take 64 KB and
// K with V 128 KB); q stays whole in shared memory as float32.  The split
// kernel of chunk 0 writes m and l; the merge kernel takes the chunk axis
// too and merges each chunk's columns.  The Dh <= 256 kernel is unchanged.
//
// Tensor cores are not needed: G <= 16 query rows fill at most one m16
// tile, the serving path's pools are float32, and the kernel is bound by
// bytes, not operations.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (repro_torch/kernels/
// paged_attention/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;                 // keys per chunk: one per lane
constexpr int MAX_G = 16;              // query heads per KV head
constexpr int MAX_DH = 256;            // head dim of one CTA's output columns
constexpr int COLS = MAX_DH / THREADS; // PV columns per thread
constexpr int G_PER_WARP = MAX_G / WARPS;
constexpr float NEG_INF = -1e30f;
constexpr int STAGE_BUDGET = 112 * 1024;   // bytes of the K/V ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// row stride in shared memory (elements): Dh rounded up to a 16-byte vector
// and one vector more, so that the 8 lanes of a phase reading 8 rows at one
// column hit 8 distinct 16-byte bank groups
template <typename T> __host__ __device__ __forceinline__ int row_ld(int Dh) {
  constexpr int V = 16 / (int)sizeof(T);
  return (Dh + V - 1) / V * V + V;
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n groups are pending (n small, runtime)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// dot of a 16-byte vector of K with q's float32 row at the same columns
__device__ __forceinline__ float dot_vec(const float* k, const float* q, float acc) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(q);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_vec(const __nv_bfloat16* k, const float* q, float acc) {
  const uint4 u = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    const float2 b = *reinterpret_cast<const float2*>(q + 2 * i);
    acc = fmaf(f.x, b.x, acc);
    acc = fmaf(f.y, b.y, acc);
  }
  return acc;
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

struct Shape {
  int Hkv, G, Dh, n_pool, page, max_pages, pps, n_split, stages, vec;
};

// Keys [c0, c0 + KC) of one sequence's head (those below `end`; zeros past
// it) into one stage of the ring: K and V rows [KC][ld] in the pools' dtype.
// Warp w takes rows w, w + WARPS, ...; its lanes split the row.
template <typename TKV>
__device__ __forceinline__ void load_chunk(TKV* ks, TKV* vs, const TKV* kh, const TKV* vh,
                                           const int* trow, int c0, int end, const Shape& sh) {
  constexpr int V = 16 / (int)sizeof(TKV);
  const int ld = row_ld<TKV>(sh.Dh);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < KC; r += WARPS) {
    const int pos = c0 + r;
    const bool ok = pos < end;
    size_t off = 0;
    if (ok) {
      const int pg = pos / sh.page;
      const int phys = min(max(__ldg(trow + pg), 0), sh.n_pool - 1);
      off = ((size_t)phys * sh.page + (pos - pg * sh.page)) * sh.Dh;
    }
    if (sh.vec) {
      for (int c = lane * V; c < sh.Dh; c += 32 * V) {
        cp_async16(smem_u32(ks + r * ld + c), kh + off + c, ok);
        cp_async16(smem_u32(vs + r * ld + c), vh + off + c, ok);
      }
    } else {                          // element by element; the padding stays 0
      for (int c = lane; c < sh.Dh; c += 32) {
        ks[r * ld + c] = ok ? kh[off + c] : from_f32<TKV>(0.f);
        vs[r * ld + c] = ok ? vh[off + c] : from_f32<TKV>(0.f);
      }
    }
  }
}

// Grid (B * Hkv, n_split), THREADS threads.  Writes this split's partial
// m, l [G] and acc [G][Dh] (unnormalised) of one (sequence, KV head).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_attention_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                             const TKV* __restrict__ v_pool, const int* __restrict__ table,
                             const int* __restrict__ lens, float* __restrict__ part_acc,
                             float* __restrict__ part_ml, Shape sh, float scale) {
  constexpr int V = 16 / (int)sizeof(TKV);   // pool elements in a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = sh.G, Dh = sh.Dh;
  const int ld = row_ld<TKV>(Dh);
  const int dv = (Dh + V - 1) / V * V;       // the K columns the scores read
  const int ldq = (Dh + 7) / 8 * 8;   // q rows in float32, zeros past Dh (ldq >= dv)
  TKV* kv_s = reinterpret_cast<TKV*>(smem_raw);               // [stages][2][KC][ld]
  float* q_s = reinterpret_cast<float*>(kv_s + (size_t)sh.stages * 2 * KC * ld);  // [G][ldq]
  float* p_s = q_s + G * ldq;                                 // [G][KC] p, rounded
  float* c_s = p_s + G * KC;                                  // [G] correction

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / sh.Hkv, h = bh - b * sh.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int total = sh.max_pages * sh.page;
  const bool masked = len <= 0;        // every position masked: walk the whole table
  const int end = masked ? total : min(len, total);
  const int k_begin = split * sh.pps * sh.page;
  const int k_end = min(end, k_begin + sh.pps * sh.page);
  const size_t part = (size_t)bh * sh.n_split + split;
  float* ml = part_ml + part * G * 2;
  if (k_begin >= k_end) {              // past the length: an empty partial
    if (tid < G) {
      ml[2 * tid] = NEG_INF;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  const size_t head = (size_t)h * sh.n_pool * sh.page * Dh;
  const TKV* kh = k_pool + head;
  const TKV* vh = v_pool + head;
  const int* trow = table + (size_t)b * sh.max_pages;
  const int n_chunks = (k_end - k_begin + KC - 1) / KC;
  const int stage_elems = 2 * KC * ld;

  if (!sh.vec) {                       // the padding columns must read as zeros
    for (int i = tid; i < sh.stages * stage_elems; i += THREADS) kv_s[i] = from_f32<TKV>(0.f);
    __syncthreads();
  }
  // the first stages - 1 chunks in flight, then q (the loop's first barrier
  // publishes it)
  for (int c = 0; c < sh.stages - 1; ++c) {
    if (c < n_chunks) {
      TKV* st = kv_s + (size_t)c * stage_elems;
      load_chunk(st, st + KC * ld, kh, vh, trow, k_begin + c * KC, k_end, sh);
    }
    cp_async_commit();
  }
  const TQ* qp = q + (size_t)bh * G * Dh;
  for (int i = tid; i < G * ldq; i += THREADS) {
    const int g = i / ldq, d = i - g * ldq;
    q_s[i] = d < Dh ? to_f32(qp[g * Dh + d]) : 0.f;
  }

  float m[G_PER_WARP], l[G_PER_WARP];  // the running max and sum of rows warp + 4 i
#pragma unroll
  for (int i = 0; i < G_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[MAX_G][COLS];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[g][c] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(sh.stages - 2);
    __syncthreads();                   // chunk c landed; chunk c - 1 consumed
    {                                  // chunk c + stages - 1 into chunk c - 1's stage
      const int n = c + sh.stages - 1;
      if (n < n_chunks) {
        TKV* st = kv_s + (size_t)(n % sh.stages) * stage_elems;
        load_chunk(st, st + KC * ld, kh, vh, trow, k_begin + n * KC, k_end, sh);
      }
      cp_async_commit();
    }
    const TKV* ks = kv_s + (size_t)(c % sh.stages) * stage_elems;
    const TKV* vs = ks + KC * ld;
    const int pos = k_begin + c * KC + lane;

    // scores of key `lane` for rows warp, warp + 4, ...; then their online
    // softmax across the warp
#pragma unroll
    for (int i = 0; i < G_PER_WARP; ++i) {
      const int g = warp + WARPS * i;
      if (g >= G) break;
      float s = 0.f;
      const TKV* kr = ks + lane * ld;
      const float* qr = q_s + g * ldq;
      for (int d = 0; d < dv; d += V) s = dot_vec(kr + d, qr + d, s);
      s = pos >= k_end ? -INFINITY : masked ? NEG_INF : s * scale;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      p_s[g * KC + lane] = to_f32(from_f32<TKV>(p));   // p in the pools' dtype
      if (lane == 0) c_s[g] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ V over the chunk, thread t owning columns
    // t, t + THREADS
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) {
      const int d = tid + cc * THREADS;
      if (d >= Dh) continue;
      float part_g[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part_g[g] = 0.f;
      for (int j = 0; j < KC; j += 4) {
        const float v0 = to_f32(vs[j * ld + d]), v1 = to_f32(vs[(j + 1) * ld + d]);
        const float v2 = to_f32(vs[(j + 2) * ld + d]), v3 = to_f32(vs[(j + 3) * ld + d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float4 p = *reinterpret_cast<const float4*>(p_s + g * KC + j);
            part_g[g] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, part_g[g]))));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g][cc] = acc[g][cc] * c_s[g] + part_g[g];
    }
  }
  cp_async_wait(0);

  float* pa = part_acc + part * G * Dh;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int d = tid + cc * THREADS;
    if (d >= Dh) continue;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) pa[g * Dh + d] = acc[g][cc];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < G_PER_WARP; ++i) {
      const int g = warp + WARPS * i;
      if (g < G) {
        ml[2 * g] = m[i];
        ml[2 * g + 1] = l[i];
      }
    }
  }
}

// Columns [col0, col0 + w) of keys [k0, k0 + KC) of one sequence's head
// (those below `end`; zeros past it) into one unit of the wide kernel's
// ring, [KC][ld] in the pools' dtype, zeros past w up to the next 16-byte
// vector.  col0 is a multiple of MAX_DH, so a 16-byte row stays aligned.
template <typename TKV>
__device__ __forceinline__ void load_cols(TKV* dst, int ld, const TKV* src, const int* trow,
                                          int k0, int end, int col0, int w,
                                          const Shape& sh) {
  constexpr int V = 16 / (int)sizeof(TKV);
  const int lane = threadIdx.x & 31;
  const int wv = (w + V - 1) / V * V;
  for (int r = threadIdx.x >> 5; r < KC; r += WARPS) {
    const int pos = k0 + r;
    const bool ok = pos < end;
    size_t off = 0;
    if (ok) {
      const int pg = pos / sh.page;
      const int phys = min(max(__ldg(trow + pg), 0), sh.n_pool - 1);
      off = ((size_t)phys * sh.page + (pos - pg * sh.page)) * sh.Dh + col0;
    }
    if (sh.vec) {                     // w is a multiple of V here
      for (int c = lane * V; c < w; c += 32 * V)
        cp_async16(smem_u32(dst + r * ld + c), src + off + c, ok);
    } else {
      for (int c = lane; c < wv; c += 32)
        dst[r * ld + c] = ok && c < w ? src[off + c] : from_f32<TKV>(0.f);
    }
  }
}

// The ring's unit n of the wide kernel: key chunk n / (np + 1); its K piece
// n % (np + 1) below np, else this CTA's columns of V.
template <typename TKV>
__device__ __forceinline__ void load_unit(TKV* ring, int n, int ld, const TKV* kh,
                                          const TKV* vh, const int* trow, int k_begin,
                                          int k_end, int np, int c0, int wc,
                                          const Shape& sh) {
  TKV* st = ring + (size_t)(n % sh.stages) * KC * ld;
  const int c = n / (np + 1), j = n - c * (np + 1);
  if (j < np)
    load_cols(st, ld, kh, trow, k_begin + c * KC, k_end, j * MAX_DH,
              min(MAX_DH, sh.Dh - j * MAX_DH), sh);
  else
    load_cols(st, ld, vh, trow, k_begin + c * KC, k_end, c0, wc, sh);
}

// Grid (B * Hkv, n_split, ceil(Dh / MAX_DH)), THREADS threads, Dh > MAX_DH:
// as the split kernel, for output columns [c0, c0 + wc), c0 = MAX_DH *
// blockIdx.z; m and l [G] are written by chunk 0.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_attention_wide_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                            const TKV* __restrict__ v_pool, const int* __restrict__ table,
                            const int* __restrict__ lens, float* __restrict__ part_acc,
                            float* __restrict__ part_ml, Shape sh, float scale) {
  constexpr int V = 16 / (int)sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = sh.G, Dh = sh.Dh;
  const int ld = row_ld<TKV>(MAX_DH);
  const int ldq = (Dh + 7) / 8 * 8;   // q rows in float32, zeros past Dh
  const int np = (Dh + MAX_DH - 1) / MAX_DH;
  const int c0 = blockIdx.z * MAX_DH, wc = min(MAX_DH, Dh - c0);
  TKV* ring = reinterpret_cast<TKV*>(smem_raw);                     // [stages][KC][ld]
  float* q_s = reinterpret_cast<float*>(ring + (size_t)sh.stages * KC * ld);  // [G][ldq]
  float* p_s = q_s + G * ldq;                                       // [G][KC]
  float* c_s = p_s + G * KC;                                        // [G]

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / sh.Hkv, h = bh - b * sh.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int total = sh.max_pages * sh.page;
  const bool masked = len <= 0;
  const int end = masked ? total : min(len, total);
  const int k_begin = split * sh.pps * sh.page;
  const int k_end = min(end, k_begin + sh.pps * sh.page);
  const size_t part = (size_t)bh * sh.n_split + split;
  float* ml = part_ml + part * G * 2;
  if (k_begin >= k_end) {
    if (blockIdx.z == 0 && tid < G) {
      ml[2 * tid] = NEG_INF;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  const size_t head = (size_t)h * sh.n_pool * sh.page * Dh;
  const TKV* kh = k_pool + head;
  const TKV* vh = v_pool + head;
  const int* trow = table + (size_t)b * sh.max_pages;
  const int n_units = (k_end - k_begin + KC - 1) / KC * (np + 1);

  if (!sh.vec) {                       // the padding columns must read as zeros
    for (int i = tid; i < sh.stages * KC * ld; i += THREADS) ring[i] = from_f32<TKV>(0.f);
    __syncthreads();
  }
  for (int n = 0; n < sh.stages - 1; ++n) {
    if (n < n_units) load_unit(ring, n, ld, kh, vh, trow, k_begin, k_end, np, c0, wc, sh);
    cp_async_commit();
  }
  const TQ* qp = q + (size_t)bh * G * Dh;
  for (int i = tid; i < G * ldq; i += THREADS) {
    const int g = i / ldq, d = i - g * ldq;
    q_s[i] = d < Dh ? to_f32(qp[g * Dh + d]) : 0.f;
  }

  float m[G_PER_WARP], l[G_PER_WARP], s_run[G_PER_WARP];
#pragma unroll
  for (int i = 0; i < G_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    s_run[i] = 0.f;
  }
  float acc[MAX_G][COLS];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[g][c] = 0.f;

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait(sh.stages - 2);
    __syncthreads();                   // unit u landed; unit u - 1 consumed
    {
      const int n = u + sh.stages - 1;
      if (n < n_units) load_unit(ring, n, ld, kh, vh, trow, k_begin, k_end, np, c0, wc, sh);
      cp_async_commit();
    }
    const TKV* t = ring + (size_t)(u % sh.stages) * KC * ld;
    const int c = u / (np + 1), j = u - c * (np + 1);
    if (j < np) {
      // piece j of the scores of key `lane` for rows warp, warp + 4, ...;
      // after the last piece their online softmax across the warp
      const int p0 = j * MAX_DH;
      const int dv = (min(MAX_DH, Dh - p0) + V - 1) / V * V;
      const int pos = k_begin + c * KC + lane;
#pragma unroll
      for (int i = 0; i < G_PER_WARP; ++i) {
        const int g = warp + WARPS * i;
        if (g >= G) break;
        float s = j == 0 ? 0.f : s_run[i];
        const TKV* kr = t + lane * ld;
        const float* qr = q_s + g * ldq + p0;
        for (int d = 0; d < dv; d += V) s = dot_vec(kr + d, qr + d, s);
        s_run[i] = s;
        if (j == np - 1) {
          s = pos >= k_end ? -INFINITY : masked ? NEG_INF : s * scale;
          const float m_new = fmaxf(m[i], warp_max(s));
          const float p = expf(s - m_new);
          const float corr = expf(m[i] - m_new);
          l[i] = l[i] * corr + warp_sum(p);
          m[i] = m_new;
          p_s[g * KC + lane] = to_f32(from_f32<TKV>(p));   // p in the pools' dtype
          if (lane == 0) c_s[g] = corr;
        }
      }
    } else {
      // acc = acc * corr + p @ V over the chunk, thread t owning columns
      // c0 + t, c0 + t + THREADS (p and corr published by the barrier above)
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int d = tid + cc * THREADS;
        if (d >= wc) continue;
        float part_g[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) part_g[g] = 0.f;
        for (int jj = 0; jj < KC; jj += 4) {
          const float v0 = to_f32(t[jj * ld + d]), v1 = to_f32(t[(jj + 1) * ld + d]);
          const float v2 = to_f32(t[(jj + 2) * ld + d]), v3 = to_f32(t[(jj + 3) * ld + d]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
              const float4 p = *reinterpret_cast<const float4*>(p_s + g * KC + jj);
              part_g[g] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, part_g[g]))));
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g][cc] = acc[g][cc] * c_s[g] + part_g[g];
      }
    }
  }
  cp_async_wait(0);

  float* pa = part_acc + part * G * Dh + c0;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int d = tid + cc * THREADS;
    if (d >= wc) continue;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) pa[g * Dh + d] = acc[g][cc];
  }
  if (lane == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int i = 0; i < G_PER_WARP; ++i) {
      const int g = warp + WARPS * i;
      if (g < G) {
        ml[2 * g] = m[i];
        ml[2 * g + 1] = l[i];
      }
    }
  }
}

// Grid (B * Hkv, ceil(Dh / MAX_DH)), THREADS threads: the partials of one
// (sequence, KV head) in split order into out [G][Dh], output columns
// [c0, c0 + wc) of chunk c0 / MAX_DH (all of Dh where Dh <= MAX_DH).  The live splits are a prefix (a sequence's
// keys start at 0), the empty ones (l = 0) follow.  Shared memory: the
// partials' m, l [n_split][G][2], then w [n_split][G], inv_l [G].
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_attention_merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml, TQ* __restrict__ out, int G,
                             int Dh, int n_split) {
  extern __shared__ float msmem[];
  float* ml = msmem;                   // [n_split][G][2]
  float* w = ml + n_split * G * 2;     // [n_split][G]
  float* inv_l = w + n_split * G;      // [G]
  __shared__ int n_live;
  const int bh = blockIdx.x;
  const float* src = part_ml + (size_t)bh * n_split * G * 2;
  for (int i = threadIdx.x; i < n_split * G * 2; i += THREADS) ml[i] = src[i];
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    int live = 0;
    float M = -INFINITY;
    while (live < n_split && ml[(live * G + g) * 2 + 1] > 0.f)
      M = fmaxf(M, ml[(live++ * G + g) * 2]);
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const float e = expf(ml[(s * G + g) * 2] - M);
      w[s * G + g] = e;
      L += ml[(s * G + g) * 2 + 1] * e;
    }
    inv_l[g] = 1.f / fmaxf(L, 1e-30f);
    if (g == 0) n_live = live;
  }
  __syncthreads();
  const float* pa = part_acc + (size_t)bh * n_split * G * Dh;
  TQ* o = out + (size_t)bh * G * Dh;
  const int live = n_live;
  const int c0 = blockIdx.y * MAX_DH, wc = min(MAX_DH, Dh - c0);
  for (int i = threadIdx.x; i < G * wc; i += THREADS) {
    const int g = i / wc;
    const int at = g * Dh + c0 + (i - g * wc);
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) acc = fmaf(pa[(size_t)s * G * Dh + at], w[s * G + g], acc);
    o[at] = from_f32<TQ>(acc * inv_l[g]);
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
                   const int* lens, void* out, float* part, int B, Shape sh, float scale,
                   cudaStream_t stream) {
  // a stage: K and V rows of a chunk of keys, or (Dh > MAX_DH) one
  // [KC][MAX_DH] unit of the wide kernel's ring
  const bool wide = sh.Dh > MAX_DH;
  const int ld = row_ld<TKV>(wide ? MAX_DH : sh.Dh);
  const size_t stage = sizeof(TKV) * (wide ? 1 : 2) * KC * (size_t)ld;
  sh.stages = STAGE_BUDGET >= 3 * stage ? 3 : 2;
  const int ldq = (sh.Dh + 7) / 8 * 8;
  const size_t smem = stage * sh.stages + sizeof(float) * ((size_t)sh.G * (ldq + KC + 1));
  auto split = wide ? &paged_attention_wide_kernel<TQ, TKV>
                    : &paged_attention_split_kernel<TQ, TKV>;
  cudaError_t e = set_smem(split, smem);
  if (e != cudaSuccess) return e;
  const int BH = B * sh.Hkv;
  const int n_chunk = (sh.Dh + MAX_DH - 1) / MAX_DH;
  float* part_acc = part;
  float* part_ml = part + (size_t)BH * sh.n_split * sh.G * sh.Dh;
  split<<<dim3(BH, sh.n_split, n_chunk), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), table, lens, part_acc, part_ml, sh, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t msmem = sizeof(float) * ((size_t)sh.n_split * sh.G * 3 + sh.G);
  auto merge = paged_attention_merge_kernel<TQ>;
  if ((e = set_smem(merge, msmem)) != cudaSuccess) return e;
  merge<<<dim3(BH, n_chunk), THREADS, msmem, stream>>>(part_acc, part_ml,
                                                       static_cast<TQ*>(out), sh.G, sh.Dh,
                                                       sh.n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; scale is Dh^-0.5 rounded to float32
// by the caller.  pages_per_split and n_split = ceil(max_pages /
// pages_per_split) come from the caller, which allocates `part`: float32
// scratch of B * Hkv * n_split * G * (Dh + 2) elements.  vec16 is 1 where
// Dh * sizeof(pool dtype) is a multiple of 16 and both pools are 16-byte
// aligned.  Returns 0 or a cudaError_t.
extern "C" int pa_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* lens, void* out, void* part,
                                  int B, int Hkv, int G, int Dh, int n_pool, int page_size,
                                  int max_pages, int pages_per_split, int q_dtype,
                                  int kv_dtype, int vec16, float scale, void* stream) {
  if (G < 1 || G > MAX_G || Dh < 1 || (Dh + MAX_DH - 1) / MAX_DH > 65535 || page_size < 1 ||
      max_pages < 1 ||
      n_pool < 1 || pages_per_split < 1 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 1 || (long long)max_pages * page_size > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  const int n_split = (max_pages + pages_per_split - 1) / pages_per_split;
  if (n_split > 65535) return (int)cudaErrorInvalidValue;
  const Shape sh{Hkv, G, Dh, n_pool, page_size, max_pages, pages_per_split, n_split, 0,
                 vec16 != 0};
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lens);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0)
    e = launch<float, float>(q, k_pool, v_pool, t, l, out, p, B, sh, scale, s);
  else if (q_dtype == 0)
    e = launch<float, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, p, B, sh, scale, s);
  else if (kv_dtype == 0)
    e = launch<__nv_bfloat16, float>(q, k_pool, v_pool, t, l, out, p, B, sh, scale, s);
  else
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, p, B, sh, scale, s);
  return (int)e;
}
