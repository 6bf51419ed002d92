// Linear-attention scans for Hopper (sm_90a): RWKV6's WKV and Mamba2's SSD,
// each as a sequential recurrence ("fused") and as a chunked parallel scan
// ("chunk").
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/linear_scan.py:
// `wkv_kernel`, `wkv_chunk_kernel`, `ssd_kernel` and `ssd_chunk_kernel`.
// The plain PyTorch versions are `wkv_linear_scan`, `wkv_chunk`,
// `ssd_linear_scan` and `ssd_chunk` of src/repro_torch/kernels/ref.py.
//
// Layouts (all float32, contiguous; the wrapper moves T and H and casts):
//   WKV: r, k, v, w (B, H, T, N); u (H, N); s0 (B, H, N, N) with S[j][i]
//        over (key j, value i) -> out (B, H, T, N), s_out (B, H, N, N).
//   SSD: x (B, H, T, P); b, c (B, T, N) shared across heads; dt (B, H, T);
//        a (H,); s0 (B, H, P, N) -> y (B, H, T, P), s_out (B, H, P, N).
//
// On the TPU the time axis was the sequential grid dimension, with the
// state carried in VMEM scratch from one grid step to the next and T cut
// into `bt`-step tiles that had to divide T.  Hopper runs blocks in no
// order, so here one block owns one (batch row, head) and walks the whole
// sequence in a loop with the state on chip; any T is taken, and a chunk
// length that does not divide T leaves a shorter last chunk (as in the
// plain `wkv_chunk` / `ssd_chunk`).
//
// Exponentials and logarithms are expf / logf (no fast-math intrinsics),
// and masked exponents are skipped, never evaluated: an overflow times a
// zero mask would give NaN.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kChunkThreads = 256;   // threads of a chunk-form block
constexpr int kTile = 16;            // time steps per staged tile

// ---------------------------------------------------------------------------
// wkv_fused — replaces `wkv_kernel` (linear_scan.py:62).
//
// What bounds it.  Per step and (b, h) it does ~7 N^2 flops on N^2 state
// floats that stay on chip, so at decode (T = 1) the work is the state read
// and written once plus the r/k/v/w/out rows: bytes, far below the card's
// flop rate (rwkv6-3b, 8 slots x 40 heads x 64 x 64: 10.5 MB of state per
// layer call, about 3.1 us at 3.35 TB/s).
//
// What the design does about it.  One block of N threads per (b, h);
// thread i keeps column i of S (N floats) in registers for the whole
// sequence, so the state crosses device memory exactly twice per call.
// Each step stages r_t, k_t, w_t in shared memory (double-buffered, one
// barrier a step); out_i = sum_j r_j (S[j][i] + u_j k_j v_i) and
// S[j][i] <- w_j S[j][i] + k_j v_i are then sums inside one thread.  At
// prefill only H blocks run per sequence (40 on 132 SMs), each serial in T.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(N)
wkv_fused_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s_out, int H,
                 int T) {
  __shared__ float rs[2][N], ks[2][N], ws[2][N], us[N];
  const int bh = blockIdx.x;
  const int i = threadIdx.x;
  const float* s0p = s0 + (size_t)bh * N * N;
  float s[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = s0p[j * N + i];
  us[i] = u[(bh % H) * N + i];
  const size_t base = (size_t)bh * T * N;
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    const size_t off = base + (size_t)t * N + i;
    rs[buf][i] = r[off];
    ks[buf][i] = k[off];
    ws[buf][i] = w[off];
    const float vi = v[off];
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float kv = ks[buf][j] * vi;
      acc += rs[buf][j] * (s[j] + us[j] * kv);
      s[j] = ws[buf][j] * s[j] + kv;
    }
    out[off] = acc;
  }
  float* sop = s_out + (size_t)bh * N * N;
#pragma unroll
  for (int j = 0; j < N; ++j) sop[j * N + i] = s[j];
}

// ---------------------------------------------------------------------------
// ssd_fused — replaces `ssd_kernel` (linear_scan.py:200).
//
// What bounds it.  As wkv_fused: ~5 P N flops per step on P N state floats,
// so bytes (zamba2-2.7b decode, 8 slots x 80 heads x 64 x 64: 21.0 MB of
// state per layer call, about 6.3 us at 3.35 TB/s).
//
// What the design does about it.  One block of P threads per (b, h);
// thread p keeps row p of S (N floats) in registers for the whole sequence.
// b_t and c_t, shared by every head, are staged in shared memory once per
// block and step (double-buffered); dt_t is a broadcast load.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(64)
ssd_fused_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, int H,
                 int T, int P) {
  __shared__ float bs[2][N], cs[2][N];
  const int bh = blockIdx.x;
  const int bidx = bh / H;
  const int p = threadIdx.x;
  const float* s0p = s0 + ((size_t)bh * P + p) * N;
  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = s0p[n];
  const float ah = a[bh % H];
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    const size_t bc_off = ((size_t)bidx * T + t) * N;
    for (int n = p; n < N; n += P) {
      bs[buf][n] = b[bc_off + n];
      cs[buf][n] = c[bc_off + n];
    }
    const float dtt = dt[(size_t)bh * T + t];
    const size_t off = ((size_t)bh * T + t) * P + p;
    const float dx = dtt * x[off];
    const float decay = expf(dtt * ah);
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      s[n] = decay * s[n] + dx * bs[buf][n];
      acc += s[n] * cs[buf][n];
    }
    y[off] = acc;
  }
  float* sop = s_out + ((size_t)bh * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) sop[n] = s[n];
}

// ---------------------------------------------------------------------------
// wkv_chunk — replaces `wkv_chunk_kernel` (linear_scan.py:138).
//
// What bounds it.  The function is wkv_fused's, ~7 N^2 flops per step and
// (b, h) whatever C is.  At prefill (rwkv6-3b, one sequence, T = 512, 40
// heads of 64) that is 0.59 GFLOP of f32 work (~8.8 us at 67 TFLOP/s)
// against 27.5 MB of streams (~8.2 us at 3.35 TB/s): operations, narrowly.
// The chunked arrangement does more work to make a chunk's steps parallel:
// per chunk of C steps the cross term and the carry are 2 C N^2 flops each,
// the intra-chunk term C^2 N / 2 exponentials and about 3 C^2 N flops more.
//
// What the design does about it.  One block of 256 threads per (b, h) walks
// the chunks in order with S (N x N) in shared memory.  Per chunk:
//   A. the per-channel inclusive log-decay cumsum L of the chunk, written to
//      a scratch tensor in device memory (it spans the whole chunk, so it
//      would not fit in shared memory for C up to 512);
//   B. 16-step query tiles: the cross term (r exp(Lexc)) S, then 16-step key
//      tiles up to the diagonal, att[t][s] = sum_j r[t][j] k[s][j]
//      exp(Lexc[t][j] - L[s][j]) for s < t only (the (C, C, N) tensor of the
//      TPU kernel is never formed), att @ v, and the u bonus on the diagonal;
//   C. the carry S <- exp(L_last) S + sum_t (k_t exp(L_last - L_t)) v_t^T, in
//      16-step tiles.
// Shared memory is bounded (about 41 KB at N = 64) whatever C is.  No tensor
// cores yet: the tiles are f32 and the (C, N) products small.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kChunkThreads)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s_out,
                 float* lsc, int H, int T, int chunk) {
  static_assert(kTile * N % kChunkThreads == 0, "N too small");
  static_assert(N * N % kChunkThreads == 0, "N too small");
  constexpr int kOut = kTile * N / kChunkThreads;   // outputs per thread
  constexpr int kSt = N * N / kChunkThreads;        // state entries per thread
  __shared__ float S[N * N];
  __shared__ float qr[kTile * N], qe[kTile * N], qre[kTile * N];
  __shared__ float kk[kTile * N], kl[kTile * N], vv[kTile * N];
  __shared__ float att[kTile * kTile];
  __shared__ float dco[kTile], wl[N], us[N];
  static_assert(kTile * kTile == kChunkThreads, "one att entry a thread");
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)bh * T * N;
  for (int e = tid; e < N * N; e += kChunkThreads)
    S[e] = s0[(size_t)bh * N * N + e];
  if (tid < N) us[tid] = u[(bh % H) * N + tid];
  __syncthreads();

  for (int lo = 0; lo < T; lo += chunk) {
    const int C = min(chunk, T - lo);
    const size_t cbase = base + (size_t)lo * N;
    // A. inclusive log-decay cumsum over the chunk, one channel a thread
    if (tid < N) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += logf(w[cbase + (size_t)t * N + tid]);
        lsc[cbase + (size_t)t * N + tid] = acc;
      }
    }
    __syncthreads();

    // B. outputs, one query tile at a time
    for (int q0 = 0; q0 < C; q0 += kTile) {
      const int nq = min(kTile, C - q0);
      for (int e = tid; e < kTile * N; e += kChunkThreads) {
        const int t = e / N;
        if (t < nq) {
          const size_t g = cbase + (size_t)(q0 + t) * N + (e % N);
          const float lexc = lsc[g] - logf(w[g]);
          qr[e] = r[g];
          qe[e] = lexc;
          qre[e] = r[g] * expf(lexc);
        } else {
          qr[e] = 0.f;
          qe[e] = 0.f;
          qre[e] = 0.f;
        }
      }
      __syncthreads();
      float acc[kOut];
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kChunkThreads;
        const int t = e / N, i = e % N;
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) a += qre[t * N + j] * S[j * N + i];
        acc[m] = a;
      }
      for (int s0k = 0; s0k <= q0; s0k += kTile) {
        const int nk = min(kTile, C - s0k);
        for (int e = tid; e < kTile * N; e += kChunkThreads) {
          const int t = e / N;
          if (t < nk) {
            const size_t g = cbase + (size_t)(s0k + t) * N + (e % N);
            kk[e] = k[g];
            kl[e] = lsc[g];
            vv[e] = v[g];
          } else {
            kk[e] = 0.f;
            kl[e] = 0.f;
            vv[e] = 0.f;
          }
        }
        __syncthreads();
        {
          const int tq = tid / kTile, sk = tid % kTile;
          float a = 0.f;
          if (tq < nq && sk < nk && s0k + sk < q0 + tq) {
            for (int j = 0; j < N; ++j)
              a += qr[tq * N + j] * kk[sk * N + j] *
                   expf(qe[tq * N + j] - kl[sk * N + j]);
          }
          att[tq * kTile + sk] = a;
          if (s0k == q0 && tid < nq) {   // diagonal tile: the u bonus
            float d = 0.f;
            for (int j = 0; j < N; ++j)
              d += qr[tid * N + j] * kk[tid * N + j] * us[j];
            dco[tid] = d;
          }
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kOut; ++m) {
          const int e = tid + m * kChunkThreads;
          const int t = e / N, i = e % N;
          float a = 0.f;
          for (int sk = 0; sk < kTile; ++sk)
            a += att[t * kTile + sk] * vv[sk * N + i];
          if (s0k == q0 && t < nq) a += dco[t] * vv[t * N + i];
          acc[m] += a;
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kChunkThreads;
        const int t = e / N;
        if (t < nq) out[cbase + (size_t)(q0 + t) * N + (e % N)] = acc[m];
      }
    }

    // C. carry the state to the chunk's end
    if (tid < N) wl[tid] = lsc[cbase + (size_t)(C - 1) * N + tid];
    __syncthreads();
    float sacc[kSt];
#pragma unroll
    for (int m = 0; m < kSt; ++m) {
      const int e = tid + m * kChunkThreads;
      sacc[m] = expf(wl[e / N]) * S[e];
    }
    for (int t0 = 0; t0 < C; t0 += kTile) {
      const int nt = min(kTile, C - t0);
      for (int e = tid; e < kTile * N; e += kChunkThreads) {
        const int t = e / N, j = e % N;
        if (t < nt) {
          const size_t g = cbase + (size_t)(t0 + t) * N + j;
          kk[e] = k[g] * expf(wl[j] - lsc[g]);
          vv[e] = v[g];
        } else {
          kk[e] = 0.f;
          vv[e] = 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kSt; ++m) {
        const int e = tid + m * kChunkThreads;
        const int j = e / N, i = e % N;
        float a = 0.f;
        for (int t = 0; t < kTile; ++t) a += kk[t * N + j] * vv[t * N + i];
        sacc[m] += a;
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kSt; ++m) S[tid + m * kChunkThreads] = sacc[m];
    __syncthreads();
  }
  for (int e = tid; e < N * N; e += kChunkThreads)
    s_out[(size_t)bh * N * N + e] = S[e];
}

// ---------------------------------------------------------------------------
// ssd_chunk — replaces `ssd_chunk_kernel` (linear_scan.py:276).
//
// What bounds it.  The function is ssd_fused's, ~5 P N flops per step and
// (b, h) whatever C is: at prefill (zamba2, one sequence, T = 512, 80
// heads, P = N = 64) 0.84 GFLOP (~12.5 us at 67 TFLOP/s) against 24 MB of
// streams (~7.2 us): operations.  The chunked arrangement does more: per
// chunk the cross term and the carry are 2 C P N flops each, the
// intra-chunk term C^2 (N + P) flops and C^2 / 2 exponentials, ~1 GFLOP at
// C = 64 and ~2 GFLOP at C = 256.
//
// What the design does about it.  One block of 256 threads per (b, h) with
// S (P x N) in shared memory.  Per chunk: A. the scalar cumsum
// L = cumsum(dt a) into a scratch tensor; B. 16-step query tiles: the cross
// term exp(L_t) (c_t . S^T), then key tiles up to the diagonal with
// M[t][s] = (c_t . b_s) exp(L_t - L_s) dt_s for s <= t only (the inclusive
// diagonal: the output reads the state after its own update), and M @ x;
// C. the carry S <- exp(L_last) S + sum_t (x_t exp(L_last - L_t) dt_t) b_t^T.
// All streams are f32 (the `precise=True` contract that keeps greedy decode
// token-identical across scan modes).  Shared memory ~30 KB at P = N = 64.
// ---------------------------------------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(kChunkThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, float* lsc,
                 int H, int T, int chunk) {
  static_assert(kTile * P % kChunkThreads == 0, "P too small");
  static_assert(P * N % kChunkThreads == 0, "P * N too small");
  constexpr int kOut = kTile * P / kChunkThreads;
  constexpr int kSt = P * N / kChunkThreads;
  __shared__ float S[P * N];
  __shared__ float cq[kTile * N], kb[kTile * N], kx[kTile * P];
  __shared__ float lq[kTile], kL[kTile], kdt[kTile];
  __shared__ float M[kTile * kTile];
  const int bh = blockIdx.x;
  const int bidx = bh / H;
  const int tid = threadIdx.x;
  const float ah = a[bh % H];
  for (int e = tid; e < P * N; e += kChunkThreads)
    S[e] = s0[(size_t)bh * P * N + e];
  __syncthreads();

  for (int lo = 0; lo < T; lo += chunk) {
    const int C = min(chunk, T - lo);
    const size_t dbase = (size_t)bh * T + lo;           // dt and L rows
    const size_t xbase = dbase * P;                      // x and y rows
    const size_t bbase = ((size_t)bidx * T + lo) * N;    // b and c rows
    // A. the scalar log-decay cumsum
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += dt[dbase + t] * ah;
        lsc[dbase + t] = acc;
      }
    }
    __syncthreads();

    // B. outputs, one query tile at a time
    for (int q0 = 0; q0 < C; q0 += kTile) {
      const int nq = min(kTile, C - q0);
      for (int e = tid; e < kTile * N; e += kChunkThreads) {
        const int t = e / N;
        cq[e] = t < nq ? c[bbase + (size_t)(q0 + t) * N + (e % N)] : 0.f;
      }
      if (tid < kTile) lq[tid] = tid < nq ? lsc[dbase + q0 + tid] : 0.f;
      __syncthreads();
      float acc[kOut];
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kChunkThreads;
        const int t = e / P, p = e % P;
        float d = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) d += cq[t * N + n] * S[p * N + n];
        acc[m] = t < nq ? expf(lq[t]) * d : 0.f;
      }
      for (int s0k = 0; s0k <= q0; s0k += kTile) {
        const int nk = min(kTile, C - s0k);
        for (int e = tid; e < kTile * N; e += kChunkThreads) {
          const int t = e / N;
          kb[e] = t < nk ? b[bbase + (size_t)(s0k + t) * N + (e % N)] : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kChunkThreads) {
          const int t = e / P;
          kx[e] = t < nk ? x[xbase + (size_t)(s0k + t) * P + (e % P)] : 0.f;
        }
        if (tid < kTile) {
          kL[tid] = tid < nk ? lsc[dbase + s0k + tid] : 0.f;
          kdt[tid] = tid < nk ? dt[dbase + s0k + tid] : 0.f;
        }
        __syncthreads();
        {
          const int tq = tid / kTile, sk = tid % kTile;
          float m = 0.f;
          if (tq < nq && sk < nk && s0k + sk <= q0 + tq) {
            float cb = 0.f;
            for (int n = 0; n < N; ++n) cb += cq[tq * N + n] * kb[sk * N + n];
            m = cb * expf(lq[tq] - kL[sk]) * kdt[sk];
          }
          M[tq * kTile + sk] = m;
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kOut; ++m) {
          const int e = tid + m * kChunkThreads;
          const int t = e / P, p = e % P;
          float d = 0.f;
          for (int sk = 0; sk < kTile; ++sk)
            d += M[t * kTile + sk] * kx[sk * P + p];
          acc[m] += d;
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kChunkThreads;
        const int t = e / P;
        if (t < nq) y[xbase + (size_t)(q0 + t) * P + (e % P)] = acc[m];
      }
    }

    // C. carry the state to the chunk's end
    const float wlast = lsc[dbase + C - 1];
    float sacc[kSt];
#pragma unroll
    for (int m = 0; m < kSt; ++m)
      sacc[m] = expf(wlast) * S[tid + m * kChunkThreads];
    for (int t0 = 0; t0 < C; t0 += kTile) {
      const int nt = min(kTile, C - t0);
      for (int e = tid; e < kTile * P; e += kChunkThreads) {
        const int t = e / P;
        float v = 0.f;
        if (t < nt) {
          const size_t d = dbase + t0 + t;
          v = x[xbase + (size_t)(t0 + t) * P + (e % P)] *
              (expf(wlast - lsc[d]) * dt[d]);
        }
        kx[e] = v;
      }
      for (int e = tid; e < kTile * N; e += kChunkThreads) {
        const int t = e / N;
        kb[e] = t < nt ? b[bbase + (size_t)(t0 + t) * N + (e % N)] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kSt; ++m) {
        const int e = tid + m * kChunkThreads;
        const int p = e / N, n = e % N;
        float d = 0.f;
        for (int t = 0; t < kTile; ++t) d += kx[t * P + p] * kb[t * N + n];
        sacc[m] += d;
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kSt; ++m) S[tid + m * kChunkThreads] = sacc[m];
    __syncthreads();
  }
  for (int e = tid; e < P * N; e += kChunkThreads)
    s_out[(size_t)bh * P * N + e] = S[e];
}

template <typename F>
int dispatch_dim(int n, F&& f) {
  switch (n) {
    case 16: f(std::integral_constant<int, 16>{}); return 0;
    case 64: f(std::integral_constant<int, 64>{}); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); the wrapper raises on anything else.

int wkv_fused_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* s_out, int B, int H, int T, int N, void* stream) {
  if (B * H == 0) return 0;
  const int rc = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    wkv_fused_kernel<kN><<<B * H, kN, 0, (cudaStream_t)stream>>>(
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)out, (float*)s_out, H, T);
  });
  return rc ? rc : (int)cudaGetLastError();
}

int wkv_chunk_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* s_out, void* scratch, int B, int H, int T, int N,
                     int chunk, void* stream) {
  if (B * H == 0) return 0;
  const int rc = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    wkv_chunk_kernel<kN><<<B * H, kChunkThreads, 0, (cudaStream_t)stream>>>(
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)out, (float*)s_out,
        (float*)scratch, H, T, chunk);
  });
  return rc ? rc : (int)cudaGetLastError();
}

int ssd_fused_launch(const void* x, const void* b, const void* c,
                     const void* dt, const void* a, const void* s0, void* y,
                     void* s_out, int B, int H, int T, int P, int N,
                     void* stream) {
  if (B * H == 0) return 0;
  if (P != 16 && P != 64) return (int)cudaErrorInvalidValue;
  const int rc = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    ssd_fused_kernel<kN><<<B * H, P, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)b, (const float*)c, (const float*)dt,
        (const float*)a, (const float*)s0, (float*)y, (float*)s_out, H, T, P);
  });
  return rc ? rc : (int)cudaGetLastError();
}

int ssd_chunk_launch(const void* x, const void* b, const void* c,
                     const void* dt, const void* a, const void* s0, void* y,
                     void* s_out, void* scratch, int B, int H, int T, int P,
                     int N, int chunk, void* stream) {
  if (B * H == 0) return 0;
  int rc = 0;
  const int rp = dispatch_dim(P, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    rc = dispatch_dim(N, [&](auto n) {
      constexpr int kN = decltype(n)::value;
      ssd_chunk_kernel<kP, kN>
          <<<B * H, kChunkThreads, 0, (cudaStream_t)stream>>>(
              (const float*)x, (const float*)b, (const float*)c,
              (const float*)dt, (const float*)a, (const float*)s0, (float*)y,
              (float*)s_out, (float*)scratch, H, T, chunk);
    });
  });
  if (rp) return rp;
  return rc ? rc : (int)cudaGetLastError();
}

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
