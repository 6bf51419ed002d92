// Paged multi-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_mq` (body
// `_paged_mq_kernel`) of src/repro/kernels/paged_attention.py.
//
// What it computes.  q (B, S, KVH, G, HD), k_pages / v_pages
// (P, page_size, KVH, HD), block_tables (B, MP) int32, lengths (B,) int32
// -> out shaped like q.  Query s of slot b attends to the first
// lengths[b] + s positions of the slot's sequence (the staircase mask of a
// speculative block whose own K/V rows are already written); position t
// lives at row t % page_size of page block_tables[b][t / page_size].
// Softmax is online, in f32; the output is cast to q's dtype.  Masked
// scores take the finite -1e30 and the denominator is clamped at 1e-30, so
// a row with no visible position returns finite garbage (the engine masks
// such inactive slots at sampling).
//
// What bounds it.  Decode attention does ~2 flops per K/V byte it reads:
// far below the card's ratio of flops to memory bandwidth, so the bound is
// the bytes of K/V of the pages each slot occupies.
//
// What the design does about that.  One thread block per (slot, kv-head)
// walks only the ceil((len + S - 1) / page_size) pages the slot occupies
// (capped at MP), never the whole block table; each K/V tile of block_k
// rows is read from device memory once and staged through shared memory,
// where all S * G query rows of the block share it (the point of the
// multi-query kernel: speculation and GQA add queries, which are tiny, not
// K/V traffic).  The running max, denominator and accumulator of every
// query row stay in shared memory for the whole walk.  On the TPU the page
// walk was the sequential grid dimension carrying m/l/acc in VMEM scratch;
// here blocks run unordered, so the walk is a loop inside the block.
// Split-KV across blocks, cp.async/TMA pipelining and tensor cores are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory floats one block needs: q and acc rows (R x HD each), the
// K and V tiles (bk x HD each), the score tile (R x bk) and m / l / alpha.
__host__ __device__ inline size_t smem_floats(int R, int HD, int bk) {
  return 2 * (size_t)R * HD + 2 * (size_t)bk * HD + (size_t)R * bk + 3 * (size_t)R;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mq_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                const T* __restrict__ v_pages,
                const int* __restrict__ block_tables,
                const int* __restrict__ lengths, T* __restrict__ out, int S,
                int KVH, int G, int HD, int page_size, int max_pages, int bk,
                float scale) {
  extern __shared__ float smem[];
  const int R = S * G;                 // query rows sharing each K/V tile
  float* qs = smem;                    // [R][HD]
  float* acc = qs + (size_t)R * HD;    // [R][HD]
  float* ks = acc + (size_t)R * HD;    // [bk][HD]
  float* vs = ks + (size_t)bk * HD;    // [bk][HD]
  float* pt = vs + (size_t)bk * HD;    // [R][bk] scores, then probabilities
  float* m = pt + (size_t)R * bk;      // [R] running max
  float* l = m + R;                    // [R] running denominator
  float* alpha = l + R;                // [R] rescale of this tile

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const int* bt = block_tables + (size_t)b * max_pages;

  // q (B, S, KVH, G, HD): row r = s * G + g of this (slot, kv-head)
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = r / G, g = r % G;
    const size_t off = ((((size_t)b * S + s) * KVH + h) * G + g) * HD + d;
    qs[i] = to_f32(q[off]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();

  // positions the last query sees; pages beyond them are never read
  const int visible = len + S - 1;
  int n_pages = visible > 0 ? (visible + page_size - 1) / page_size : 0;
  if (n_pages > max_pages) n_pages = max_pages;
  const size_t row_stride = (size_t)KVH * HD;   // token row to token row

  for (int p = 0; p < n_pages; ++p) {
    const size_t page = (size_t)bt[p];
    for (int t0 = 0; t0 < page_size; t0 += bk) {
      const int base = p * page_size + t0;
      if (base >= visible) break;      // uniform across the block

      // stage the K/V tile in f32: rows t0 .. t0 + bk - 1 of the page
      for (int i = tid; i < bk * HD; i += kThreads) {
        const int j = i / HD, d = i % HD;
        const size_t off =
            (page * page_size + t0 + j) * row_stride + (size_t)h * HD + d;
        ks[i] = to_f32(k_pages[off]);
        vs[i] = to_f32(v_pages[off]);
      }
      __syncthreads();

      // scores: one warp per (row, key) pair, lanes split the head dim
      for (int pr = warp; pr < R * bk; pr += kWarps) {
        const int r = pr / bk, j = pr % bk;
        float dot = 0.f;
        for (int d = lane; d < HD; d += 32) dot += qs[r * HD + d] * ks[j * HD + d];
        dot = warp_sum(dot);
        if (lane == 0) pt[pr] = (base + j < len + r / G) ? dot * scale : kNegInf;
      }
      __syncthreads();

      // online softmax: one warp per row
      for (int r = warp; r < R; r += kWarps) {
        float mx = kNegInf;
        for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, pt[r * bk + j]);
        mx = warp_max(mx);
        const float m_prev = m[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < bk; j += 32) {
          const float e = expf(pt[r * bk + j] - m_new);
          pt[r * bk + j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          alpha[r] = a;
          l[r] = a * l[r] + sum;
          m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P @ V
      for (int i = tid; i < R * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        const float* prow = pt + (size_t)r * bk;
        float a = acc[i] * alpha[r];
        for (int j = 0; j < bk; ++j) a += prow[j] * vs[j * HD + d];
        acc[i] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = r / G, g = r % G;
    const size_t off = ((((size_t)b * S + s) * KVH + h) * G + g) * HD + d;
    store(acc[i] / fmaxf(l[r], 1e-30f), out + off);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int B,
           int S, int KVH, int G, int HD, int page_size, int max_pages, int bk,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(S * G, HD, bk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_mq_kernel<T><<<B * KVH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, KVH, G, HD,
      page_size, max_pages, bk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel takes.
size_t paged_attention_mq_smem_bytes(int S, int G, int HD, int block_k) {
  return smem_floats(S * G, HD, block_k) * sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
int paged_attention_mq_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* block_tables,
                              const void* lengths, void* out, int B, int S,
                              int KVH, int G, int HD, int page_size,
                              int max_pages, int block_k, int dtype,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, S, KVH, G, HD, page_size, max_pages,
                                 block_k, scale, st);
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B, S,
                       KVH, G, HD, page_size, max_pages, block_k, scale, st);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
