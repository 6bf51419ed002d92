// Online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (body `_flash_kernel`)
// of src/repro/kernels/flash_attention.py.
//
// What it computes.  q (BH, S, D), k / v (BH, Sk, D) -> out (BH, S, D) in
// q's dtype (float32 or bfloat16).  Query row qi sees key ki where
// `qi >= ki` (causal) and `qi - ki < window` (window > 0), on absolute
// positions with no offset, also when S != Sk.  Scores q.k * D^-1/2 are
// masked to -1e30, the softmax is online over (bq, bk) tiles in f32 and the
// denominator is clamped at 1e-30, exactly as the TPU kernel does: a row
// with no visible key at all gets a uniform softmax over every key (the
// mean of v), like the plain version.
//
// What bounds it.  Attention does ~4 * D flops per (query, visible key)
// pair against ~4 * D bytes per query or key row it must read: at S = 512
// and D = 64 that is operations on the CUDA cores (this kernel uses scalar
// f32 FMAs, not the tensor cores, so in bf16 it stays far from the tensor
// cores' bound).
//
// What the design does about that.  One block of 256 threads per (bh,
// q-tile of bq rows) loops over the k-tiles of bk keys; the TPU's grid
// carried m, l and the accumulator in VMEM across the k axis, here they
// stay in the block for its whole loop.  Shared memory cannot hold the
// TPU's four f32 tiles at bq = bk = 128, D = 128 (Q, K, V and the scores:
// 256 KB, above the 227 KB a block may have), so the design keeps Q and
// the full (bq, bk) score tile in shared memory (one online-softmax update
// per caller's k-tile, as on the TPU) and streams K, then V, through one
// 32-row sub-tile buffer; the (bq, D) accumulator lives in registers,
// 4 columns x D/8 rows per thread.  At most 150 KB of shared memory.  Rows
// are padded by one float so a warp's reads hit distinct banks.  k-tiles
// that every row of the block masks out are skipped: they only add exact
// zeros once a row has seen a visible key.  Blocks holding a row that sees
// no key at all walk every tile, so such rows get the TPU kernel's uniform
// result.  Tensor cores, cp.async/TMA and a pipelined ring are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxTile = 128;       // bq and bk at most this
constexpr int kSub = 32;            // K/V rows staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

size_t smem_floats(int D, int bq, int bk) {
  const int kt = bk < kSub ? bk : kSub;
  return (size_t)bq * (D + 1) + (size_t)bq * (bk + 1) + (size_t)kt * (D + 1) +
         3 * (size_t)bq;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Sk,
             int bq, int bk, int causal, int window, float scale) {
  constexpr int DP = D + 1;                 // padded row of Q / K / V
  constexpr int CG = D / 4;                 // column groups of the acc
  constexpr int NGR = kThreads / CG;        // row groups of the acc
  constexpr int R = kMaxTile / NGR;         // acc rows per thread (max)
  extern __shared__ float smem[];
  const int SP = bk + 1;                    // padded row of the score tile
  const int kt = bk < kSub ? bk : kSub;
  float* qs = smem;                         // [bq][DP]
  float* ss = qs + bq * DP;                 // [bq][SP]
  float* kv = ss + bq * SP;                 // [kt][DP]
  float* m_s = kv + kt * DP;                // [bq]
  float* l_s = m_s + bq;                    // [bq]
  float* a_s = l_s + bq;                    // [bq]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const T* qb = q + ((size_t)bh * S + q0) * D;
  const T* kb_ = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  for (int e = tid; e < bq * D; e += kThreads)
    qs[(e / D) * DP + e % D] = to_f32(qb[e]);
  for (int r = tid; r < bq; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // the k-tiles this block must walk
  const int nk = Sk / bk;
  const int last = q0 + bq - 1;
  int kb0 = 0, kb1 = nk - 1;
  if (!(window > 0 && last >= Sk - 1 + window)) {
    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(last, Sk - 1) : Sk - 1;
    kb0 = lo / bk;
    kb1 = hi / bk;
  }

  const int dg = tid % CG, rg = tid / CG;
  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kb = kb0; kb <= kb1; ++kb) {
    const int k0 = kb * bk;
    // scores of the (bq, bk) tile, K staged kt rows at a time
    for (int sub = 0; sub < bk; sub += kt) {
      for (int e = tid; e < kt * D; e += kThreads)
        kv[(e / D) * DP + e % D] = to_f32(kb_[(size_t)(k0 + sub) * D + e]);
      __syncthreads();
      const int items = ((bq + 3) / 4) * kt;
      for (int e = tid; e < items; e += kThreads) {
        const int c = e % kt, r0 = (e / kt) * 4;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        const float* kr = kv + c * DP;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r0 + i < bq) dot[i] = fmaf(qs[(r0 + i) * DP + d], kd, dot[i]);
        }
        const int ki = k0 + sub + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= bq) break;
          const int qi = q0 + r;
          bool ok = true;
          if (causal) ok = ok && qi >= ki;
          if (window > 0) ok = ok && qi - ki < window;
          ss[r * SP + sub + c] = ok ? dot[i] * scale : kNegInf;
        }
      }
      __syncthreads();
    }
    // online-softmax update, one thread per row, over the whole k-tile
    for (int r = tid; r < bq; r += kThreads) {
      float* sr = ss + r * SP;
      float mx = kNegInf;
      for (int c = 0; c < bk; ++c) mx = fmaxf(mx, sr[c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < bk; ++c) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      a_s[r] = alpha;
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg + NGR * i;
      if (r < bq) {
        const float alpha = a_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      }
    }
    // acc += P @ V, V staged kt rows at a time
    for (int sub = 0; sub < bk; sub += kt) {
      for (int e = tid; e < kt * D; e += kThreads)
        kv[(e / D) * DP + e % D] = to_f32(vb[(size_t)(k0 + sub) * D + e]);
      __syncthreads();
      for (int c = 0; c < kt; ++c) {
        float vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = kv[c * DP + dg + CG * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = rg + NGR * i;
          if (r < bq) {
            const float p = ss[r * SP + sub + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  T* ob = out + ((size_t)bh * S + q0) * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rg + NGR * i;
    if (r < bq) {
      const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(acc[i][j] * inv_l, ob + (size_t)r * D + dg + CG * j);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int Sk, int bq, int bk, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(D, bq, bk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(S / bq, BH);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Sk, bq, bk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int Sk, int D, int bq, int bk, int causal, int window,
             float scale, cudaStream_t st) {
  if (D == 32)
    return launch<T, 32>(q, k, v, out, BH, S, Sk, bq, bk, causal, window,
                         scale, st);
  if (D == 64)
    return launch<T, 64>(q, k, v, out, BH, S, Sk, bq, bk, causal, window,
                         scale, st);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, BH, S, Sk, bq, bk, causal, window,
                          scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel takes.
size_t flash_attention_smem_bytes(int D, int bq, int bk) {
  return smem_floats(D, bq, bk) * sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dim outside (32, 64, 128).  dtype:
// 0 = float32, 1 = bfloat16 (q, k, v and out share it).  bq divides S, bk
// divides Sk, both at most 128, and bk is below 32 or a multiple of it.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int BH, int S, int Sk, int D, int bq,
                           int bk, int causal, int window, int dtype,
                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, Sk, D, bq, bk, causal,
                                   window, scale, st);
  return dispatch<float>(q, k, v, out, BH, S, Sk, D, bq, bk, causal, window,
                         scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
