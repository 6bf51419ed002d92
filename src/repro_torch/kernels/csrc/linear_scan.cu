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
// order.  The fused kernels split each (batch row, head) state over blocks
// along its independent axis (SSD's rows, WKV's value columns), each block
// walking the sequence with its slice of the state in registers; the chunk
// kernels split the scan into chunk states, a state pass over chunks and
// outputs by (chunk, 64-step query tile), each its own grid.  Any T is
// taken, and a chunk length that does not divide T leaves a shorter last
// chunk (as in the plain `wkv_chunk` / `ssd_chunk`).
//
// Exponentials are expf (no fast-math intrinsics), and masked exponents
// are skipped, never evaluated: an overflow times a zero mask would give
// NaN.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// wkv_fused and ssd_fused — the sequential recurrences, replacing
// `wkv_kernel` (linear_scan.py:62) and `ssd_kernel` (linear_scan.py:200).
//
// What bounds them.  Per step and (b, h) WKV does ~7 N^2 flops and SSD
// ~5 P N on a state of N^2 or P N floats that stays on chip, so at decode
// (T = 1: the pool step, and the batch-1 re-advance after a rejected draft)
// the work is the state read once and written once plus a few input rows:
// bytes.  At 8 slots that is 10.9 MB a call for rwkv6-3b (40 heads of 64),
// 3.26 us at 3.35 TB/s, and 21.3 MB for zamba2-2.7b (80 heads, P = N = 64),
// 6.36 us; at one slot 1.37 and 2.66 MB, under a microsecond, so that one
// launch and one round trip to device memory are most of a call.
//
// What the design does about it.
// * Each (b, h) state is split across blocks along its independent axis:
//   SSD's rows p (y_p = sum_n S[p][n] c_n needs only x_p, dt, b and c),
//   grid (row tile, H, B); WKV's value columns i (out_i = sum_j r_j S[j][i]
//   + (sum_j r_j u_j k_j) v_i, the bracket the same for every i), grid
//   (column tile, H, B).  A block is 4 warps at width 64, and a thread
//   holds R float4s of the state: the launcher takes the largest R that
//   leaves at least kMinBlocks blocks (two an SM), so that a batch-1 call
//   fills the card (R = 1 for WKV, 8-column tiles; R = 2 for SSD, 16-row
//   tiles: 320 blocks for either family) and a batch-8 call has the whole
//   state in flight in one wave of blocks (R = 4, 32 columns; R = 8, 64
//   rows: 640 blocks) instead of 2-3 waves of short blocks, each waiting
//   on device memory in turn.
// * The state moves as 16-byte streaming loads and stores (__ldcs / __stcs:
//   read once, written once), neighbouring lanes on neighbouring addresses
//   (SSD: N / 4 lanes a row, 512 contiguous bytes a warp; WKV: 2R lanes a
//   row's slice of the tile, 32R contiguous bytes), all issued before the
//   first step.  It stays in registers for the whole sequence, and is
//   stored right after the last step (SSD: after the last update, before
//   that step's reductions).
// * Reductions are shuffle trees, not serial chains.  SSD: a row's N terms
//   are 4 a lane, then xor-shuffles over its N / 4 lanes.  WKV: a thread
//   sums its R rows, then the sum over j is a reduce-scatter over the lanes
//   of a warp that share a column group (2 shuffles trade halves of its 4
//   columns, 1 quarters, the rest add), then a sum over the warps through
//   shared memory, once a stage of steps, when the outputs are written.
//   The decay expf(dt a) (SSD; by the thread that staged dt_t, before the
//   stage's barrier) and the bonus sum_j r_j u_j k_j (WKV; a warp a step,
//   after the steps, for the outputs) are computed once per (b, h, t) in a
//   block and read from shared memory.
// * Step inputs arrive ahead of use.  Stages of up to kStage steps (x, dt,
//   b, c or r, k, v, w) reach shared memory as cp.async copies, the next
//   stage's issued when the current one starts, so no step waits on a
//   global load; b and c (shared by every head and row tile) and r, k, w
//   (by every column tile) come from L2 after the first block.  Outputs
//   collect in shared memory and are written once a stage, coalesced.
//   Shared memory is sized to the call: one stage of min(T, kStage) steps,
//   two when T is longer (at most 37 KB).
// ---------------------------------------------------------------------------

constexpr int kStage = 16;        // time steps a fused block stages at a time
constexpr int kMinBlocks = 264;   // blocks a fused call keeps: two an SM

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// steps of a stage, and shared buffers of stages, of a fused call of T steps
__host__ __device__ inline int fused_steps(int T) {
  return T < 1 ? 1 : (T < kStage ? T : kStage);
}
__host__ __device__ inline int fused_bufs(int T) { return T > kStage ? 2 : 1; }

// The state a fused thread holds, in float4s: the largest power of two
// from `least` to `most` that leaves a grid of `blocks_least` blocks (at
// `least`) at least kMinBlocks.
inline int fused_per_thread(long blocks_least, int least, int most) {
  int r = least;
  while (2 * r <= most && blocks_least * least / (2 * r) >= kMinBlocks)
    r *= 2;
  return r;
}

__device__ __forceinline__ float4 ld_state(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st_state(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// n floats (a multiple of 4, both ends 16-byte aligned) from global `src`
// to shared `dst` as asynchronous 16-byte copies by the block's threads
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n) {
  for (int e = 4 * (int)threadIdx.x; e < n; e += 4 * (int)blockDim.x)
    __pipeline_memcpy_async(dst + e, src + e, 16);
}

template <int N, int R>
struct WkvFused {   // R rows j of S a thread, one float4 of each
  static constexpr int kGroups = 2 * R;            // float4s of a row's slice
  static constexpr int kCols = 4 * kGroups;        // value columns a block
  static constexpr int kThreads = 2 * N;           // N / R rows x kGroups
  static constexpr int kWarps = kThreads / 32;
  // a stage buffer: r, k, w rows (K, N) and the tile's v columns (K, kCols)
  __host__ __device__ static int buf_floats(int K) {
    return 3 * K * N + kCols * K;
  }
  // + u (N), the bonus (K), the warps' partial sums (K, kWarps, kCols)
  __host__ __device__ static int smem_floats(int T) {
    const int K = fused_steps(T);
    return fused_bufs(T) * buf_floats(K) + N + pad4(K) + K * kWarps * kCols;
  }
};

template <int N, int R>
__global__ void __launch_bounds__(WkvFused<N, R>::kThreads)
wkv_fused_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s_out, int H,
                 int T) {
  using F = WkvFused<N, R>;
  constexpr int kC = F::kCols, kG = F::kGroups, kW = F::kWarps;
  constexpr int kStride = N / R;                   // between a thread's rows
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = fused_steps(T), nst = (T + K - 1) / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // thread: rows jr + m N / R of S, columns c0 + 4g .. c0 + 4g + 3; lane
  // bits log2(2R)..4 are jr's low bits, so the 16 / R lanes of a warp that
  // share g hold 16 rows
  const int g = tid % kG, jr = tid / kG;
  const int c0 = blockIdx.x * kC, h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const size_t sidx = (bh * N + jr) * N + c0 + 4 * g;
  float4 s[R];
#pragma unroll
  for (int m = 0; m < R; ++m) s[m] = ld_state(s0 + sidx + m * kStride * N);
  auto store_state = [&] {
#pragma unroll
    for (int m = 0; m < R; ++m) st_state(s_out + sidx + m * kStride * N, s[m]);
  };
  float* us = smem + fused_bufs(T) * F::buf_floats(K);
  float* bonus = us + N;
  float* part = bonus + pad4(K);
  auto buffer = [&](int st) { return smem + (st & 1) * F::buf_floats(K); };
  auto stage = [&](int st) {
    float* rs = buffer(st);
    const int t0 = st * K, n = min(K, T - t0);
    const size_t row = (bh * T + t0) * N;
    stage_rows(rs, r + row, n * N);
    stage_rows(rs + K * N, k + row, n * N);
    stage_rows(rs + 2 * K * N, w + row, n * N);
    float* vs = rs + 3 * K * N;
    for (int e = tid; e < n * kG; e += F::kThreads) {
      const int t = e / kG, q = e % kG;
      __pipeline_memcpy_async(vs + t * kC + 4 * q,
                              v + row + (size_t)t * N + c0 + 4 * q, 16);
    }
    __pipeline_commit();
  };
  if (nst > 0) {
    stage_rows(us, u + (size_t)h * N, N);
    stage(0);
  }
  for (int st = 0; st < nst; ++st) {
    const float* rs = buffer(st);
    const float* ks = rs + K * N;
    const float* ws = ks + K * N;
    const float* vs = ws + K * N;
    const int t0 = st * K, n = min(K, T - t0);
    __pipeline_wait_prior(0);
    __syncthreads();                 // stage st landed; st - 1 all read
    if (st + 1 < nst) stage(st + 1);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + t * kC + 4 * g);
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int j = jr + m * kStride;
        const float rj = rs[t * N + j], kj = ks[t * N + j];
        const float wj = ws[t * N + j];
        p0 = fmaf(rj, s[m].x, p0);
        p1 = fmaf(rj, s[m].y, p1);
        p2 = fmaf(rj, s[m].z, p2);
        p3 = fmaf(rj, s[m].w, p3);
        s[m].x = wj * s[m].x + kj * vv.x;
        s[m].y = wj * s[m].y + kj * vv.y;
        s[m].z = wj * s[m].z + kj * vv.z;
        s[m].w = wj * s[m].w + kj * vv.w;
      }
      // reduce-scatter over the lanes sharing g: lanes 16 apart trade the
      // halves of the 4 columns, lanes 8 apart the quarters, the rest add;
      // column 2 * b4 + b3 ends on the lanes with bits (b4, b3)
      const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
      float a0 = b4 ? p2 : p0, a1 = b4 ? p3 : p1;
      a0 += __shfl_xor_sync(kAll, b4 ? p0 : p2, 16);
      a1 += __shfl_xor_sync(kAll, b4 ? p1 : p3, 16);
      float e = b3 ? a1 : a0;
      e += __shfl_xor_sync(kAll, b3 ? a0 : a1, 8);
#pragma unroll
      for (int o = 4; o >= kG; o >>= 1) e += __shfl_xor_sync(kAll, e, o);
      if ((lane & (8 - kG)) == 0)
        part[(t * kW + warp) * kC + 4 * g + 2 * b4 + b3] = e;
    }
    if (st + 1 == nst) store_state();
    for (int t = warp; t < n; t += kW) {   // the bonus: a warp a step
      float p = 0.f;
      for (int i = lane; i < N; i += 32)
        p += rs[t * N + i] * us[i] * ks[t * N + i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(kAll, p, o);
      if (lane == 0) bonus[t] = p;
    }
    __syncthreads();
    for (int e = tid; e < n * kC; e += F::kThreads) {
      const int t = e / kC, col = e % kC;
      float o = part[t * kW * kC + col];
#pragma unroll
      for (int q = 1; q < kW; ++q) o += part[(t * kW + q) * kC + col];
      out[(bh * T + t0 + t) * N + c0 + col] = fmaf(bonus[t], vs[e], o);
    }
  }
  if (nst == 0) store_state();
}

template <int N, int R>
struct SsdFused {   // R rows p of S a thread, 8 rows a pass of the block
  static constexpr int kLanes = N / 4;             // lanes of a state row
  static constexpr int kThreads = 8 * kLanes;
  static constexpr int kRows = 8 * R;              // rows p a block
  // a stage buffer: b, c rows (K, N), the tile's x (K, kRows), dt (K)
  __host__ __device__ static int buf_floats(int K) {
    return 2 * K * N + kRows * K + pad4(K);
  }
  // + the decays (K) and the outputs (K, kRows)
  __host__ __device__ static int smem_floats(int T) {
    const int K = fused_steps(T);
    return fused_bufs(T) * buf_floats(K) + pad4(K) + kRows * K;
  }
};

template <int N, int R>
__global__ void __launch_bounds__(SsdFused<N, R>::kThreads)
ssd_fused_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, int H,
                 int T, int P) {
  using F = SsdFused<N, R>;
  constexpr int kL = F::kLanes, kR = F::kRows;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = fused_steps(T), nst = (T + K - 1) / K;
  // thread: rows p0 + rr + 8i of S (i < R), columns 4q .. 4q + 3
  const int tid = threadIdx.x, q = tid % kL, rr = tid / kL;
  const int p0 = blockIdx.x * kR, h = blockIdx.y, bi = blockIdx.z;
  const size_t bh = (size_t)bi * H + h;
  const size_t sidx = (bh * P + p0 + rr) * N + 4 * q;
  float4 s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = ld_state(s0 + sidx + 8 * i * N);
  auto store_state = [&] {
#pragma unroll
    for (int i = 0; i < R; ++i) st_state(s_out + sidx + 8 * i * N, s[i]);
  };
  const float ah = a[h];
  float* decay = smem + fused_bufs(T) * F::buf_floats(K);
  float* ys = decay + pad4(K);
  auto buffer = [&](int st) { return smem + (st & 1) * F::buf_floats(K); };
  // thread t < n stages dt_t and, once its copies have landed, the decay
  auto stage = [&](int st) {
    float* bs = buffer(st);
    float* xs = bs + 2 * K * N;
    float* dts = xs + kR * K;
    const int t0 = st * K, n = min(K, T - t0);
    const size_t row = ((size_t)bi * T + t0) * N;
    stage_rows(bs, b + row, n * N);
    stage_rows(bs + K * N, c + row, n * N);
    for (int e = tid; e < n * (kR / 4); e += F::kThreads) {
      const int t = e / (kR / 4), i = e % (kR / 4);
      __pipeline_memcpy_async(xs + t * kR + 4 * i,
                              x + (bh * T + t0 + t) * P + p0 + 4 * i, 16);
    }
    if (tid < n) __pipeline_memcpy_async(dts + tid, dt + bh * T + t0 + tid, 4);
    __pipeline_commit();
  };
  if (nst > 0) stage(0);
  for (int st = 0; st < nst; ++st) {
    const float* bs = buffer(st);
    const float* cs = bs + K * N;
    const float* xs = cs + K * N;
    const float* dts = xs + kR * K;
    const int t0 = st * K, n = min(K, T - t0);
    __pipeline_wait_prior(0);
    if (tid < n) decay[tid] = expf(dts[tid] * ah);
    __syncthreads();                 // stage st landed; st - 1 all read
    if (st + 1 < nst) stage(st + 1);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float4 bv = *reinterpret_cast<const float4*>(bs + t * N + 4 * q);
      const float4 cv = *reinterpret_cast<const float4*>(cs + t * N + 4 * q);
      const float gt = decay[t], d = dts[t];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dx = d * xs[t * kR + rr + 8 * i];
        s[i].x = gt * s[i].x + dx * bv.x;
        s[i].y = gt * s[i].y + dx * bv.y;
        s[i].z = gt * s[i].z + dx * bv.z;
        s[i].w = gt * s[i].w + dx * bv.w;
      }
      if (st + 1 == nst && t + 1 == n) store_state();
      float part[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float acc = s[i].x * cv.x;
        acc = fmaf(s[i].y, cv.y, acc);
        acc = fmaf(s[i].z, cv.z, acc);
        part[i] = fmaf(s[i].w, cv.w, acc);
      }
#pragma unroll
      for (int o = kL / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          part[i] += __shfl_xor_sync(kAll, part[i], o);
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) ys[t * kR + rr + 8 * i] = part[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < n * kR; e += F::kThreads)
      y[(bh * T + t0 + e / kR) * P + p0 + e % kR] = ys[e];
  }
  if (nst == 0) store_state();
}

// ---------------------------------------------------------------------------
// wkv_chunk and ssd_chunk — chunk-parallel scans, replacing
// `wkv_chunk_kernel` (linear_scan.py:148) and `ssd_chunk_kernel`
// (linear_scan.py:286).
//
// What bounds them.  The function is the fused kernels': ~7 N^2 flops per
// step and (b, h) for WKV, ~5 P N for SSD.  At prefill (one sequence,
// T = 512: rwkv6-3b 40 heads of 64, zamba2-2.7b 80 heads, P = N = 64)
// that is 0.59 / 0.84 GFLOP of f32 work against 27.5 / 24 MB of streams:
// operations, narrowly, at 67 TFLOP/s.  The chunked arrangement does more
// work to make a chunk's steps parallel: at C = 64 about 0.7 GFLOP (WKV)
// and 1 GFLOP (SSD), all of it on the CUDA cores.
//
// What the design does about it.  The chunked scan's own decomposition,
// parallel over (sequence, head, chunk, 64-step query tile) instead of
// serial over chunks, in three kernels (two when the call is one chunk, one
// when it is one 64-step tile: the output kernel then also writes the final
// state, and the entry state is read once):
//   A. chunk states, grid (chunk, head, sequence): walking the chunk's
//      64-step tiles from the last, its state contribution dS and decay
//      (WKV: dS = sum_t (k_t prod_{m>t} w_m) v_t^T, per channel;
//      SSD: dS = sum_t exp(L_C - L_t) dt_t x_t b_t^T, per head);
//   B. state pass, grid (state slice, head, sequence): S <- decay S + dS
//      serially over chunks only, each chunk's entry state written over
//      its dS in the workspace, then the final state (bytes);
//   C. outputs, grid (chunk x query tile, head or head group, sequence):
//      a query tile needs only its chunk's entry state and the keys up to
//      its own rows, so the tiles of one chunk are independent.
// B and C are launched with programmatic dependent launch: C loads its
// query tile and walks the earlier key tiles of its chunk while A and B
// still run, and waits for them only before it reads the entry state.
// Tiles and states reach shared memory as asynchronous 16-byte copies
// (cp.async), so a block's loads overlap one another.
// Every tile product is a 64-step register-blocked f32 product on the
// CUDA cores, 256 threads in a 16 x 16 grid, each a 4 x 4 (or 4 x 1 at
// width 16) micro-tile: the outer form reads a row of each operand as
// float4s (contiguous micro-tiles), the inner form reads rows along the
// reduction as float4s (micro-tile rows 16 apart); shared rows are padded
// to width + 4 floats, so that no quarter-warp reads a bank twice.
//
// WKV in the linear domain.  Every decay factor is a product of decays
// (prefix products from a tile's or 16-step sub-tile's start, suffix
// products to its end), never exp of a difference of log-decay cumsums:
// nothing cancels (a cumsum difference in f32 loses |L| ulp, which at
// extreme decays or long chunks exceeds the f32 tolerance), every factor
// is <= 1 so nothing overflows, and no log or exp is evaluated.  In tile
// C, keys of an earlier tile of the chunk enter through one product of
// (r_t prod_{q0<=m<t} w_m) and (k_s prod_{s<m<q0} w_m); keys of the
// query tile's own 16-step sub-tiles through three factors (r_t's prefix
// product in its sub-tile, the totals of the sub-tiles between, k_s's
// suffix product in its sub-tile); keys of its own sub-tile through
// running products over t for each key s (masked pairs never computed);
// then the u bonus and the cross term (r_t prod_{m<t} w_m) S.
//
// SSD's decay is one scalar per step and head: its log-decays dt a are
// summed in f64 (parallel scans of 64 steps with warp shuffles, suffix
// sums with a carry across tiles) and one expf is taken of each exponent
// rounded to f32.  b and c are shared by every head, so tile C computes
// G = c b^T once per (sequence, chunk, tile pair) and reuses it from
// registers for the kHeads heads of its block, each M = G exp(L_t - L_s)
// dt_s (s <= t on its own tile) and y += M x.  kHeads is 2: the heads'
// output accumulators stay in registers at two blocks an SM (4 heads took
// 183 registers a thread, which fits one block an SM).
//
// Route: the CUDA cores, in f32.  Tensor cores were not taken: one TF32
// pass keeps three decimal digits, and a 3xTF32 split triples the
// products of tiles whose operands are re-scaled for every tile pair;
// every case must stay within the f32 tolerance of 1e-5 + 1e-5 |plain|.
// Shared memory is bounded whatever C is (tiles of 64 steps): about 110 KB
// (WKV C) and 107 KB (SSD C) at width 64, two blocks an SM, set through
// cudaFuncSetAttribute.  The kernels allocate nothing: the workspace
// (dS, then entry states, and the decays) is the wrapper's.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // threads of a chunk-form block, 16 x 16
constexpr int kT = 64;          // time steps of a tile
constexpr int kSub = 16;        // time steps of a WKV sub-tile
constexpr int kHeads = 2;       // SSD heads of an output block
constexpr int kLdT = kT + 4;    // row stride of a (., 64) shared array

__host__ __device__ constexpr int ld_of(int n) { return n + 4; }

template <int K>
__device__ __forceinline__ void load_vec(float (&x)[K], const float* p) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = p[i];
  }
}

// acc[a][b] += sum_{k<K} X[k][m0 + a] Y[k][n0 + b]  (the outer form)
template <int MT, int NT>
__device__ __forceinline__ void mm_outer(float (&acc)[MT][NT],
                                         const float* X, int ldx,
                                         const float* Y, int ldy, int K,
                                         int m0, int n0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[MT], y[NT];
    load_vec<MT>(x, X + k * ldx + m0);
    load_vec<NT>(y, Y + k * ldy + n0);
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < NT; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// acc[a][b] += sum_{k<K} X[ty + 16a][k] Y[tx + 16b][k]  (the inner form;
// K a multiple of 4), for the row groups a < `na` only (a tile's rows past
// 16 na are padding: a call of 3 steps computes one row group, not four)
template <int MA, int NB>
__device__ __forceinline__ void mm_inner(float (&acc)[MA][NB],
                                         const float* X, int ldx,
                                         const float* Y, int ldy, int K,
                                         int ty, int tx, int na = MA) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 x[MA], y[NB];
#pragma unroll
    for (int a = 0; a < MA; ++a)
      if (a < na)
        x[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * ldx + k);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      y[b] = *reinterpret_cast<const float4*>(Y + (tx + 16 * b) * ldy + k);
#pragma unroll
    for (int a = 0; a < MA; ++a)
      if (a < na)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          acc[a][b] = fmaf(x[a].x, y[b].x, fmaf(x[a].y, y[b].y,
                      fmaf(x[a].z, y[b].z, fmaf(x[a].w, y[b].w, acc[a][b]))));
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT]) {
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b) acc[a][b] = 0.f;
}

// rows [0, n) of a (rows, W) row-major global array into `rows` rows of a
// shared one of row stride ld_of(W), as asynchronous 16-byte copies (the
// loads of a block overlap one another); rows [n, rows) take `fill`.  The
// copies land after load_wait().
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int n, float fill, int rows = kT) {
  constexpr int kQ = W / 4;
  for (int e = threadIdx.x; e < rows * kQ; e += kThreads) {
    const int t = e / kQ, q = e % kQ;
    float* d = dst + t * ld_of(W) + 4 * q;
    if (t < n)
      __pipeline_memcpy_async(d, src + t * W + 4 * q, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(fill, fill, fill, fill);
  }
}

// wait for this thread's copies, then for the block's
__device__ __forceinline__ void load_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Programmatic dependent launch (sm_90): a kernel launched with
// programmatic stream serialization may start while the previous kernel of
// the stream still runs, and waits for that kernel's results (complete and
// visible) in wait_prior_grid(), a no-op in a kernel launched without it.
// A kernel lets the next one start once all its own blocks are running.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Inclusive prefix sums, in f64, of the values v that the 64 threads
// [64 g, 64 g + 64) pass (row t = threadIdx.x % 64 of group g): each
// group's two warps scan with shuffles and the second adds the first's
// total.  `tmp` holds 8 doubles; the whole block calls it.
__device__ __forceinline__ double scan64(double v, double* tmp) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) tmp[tid >> 5] = v;
  __syncthreads();
  if ((tid >> 5) & 1) v += tmp[(tid >> 5) - 1];
  __syncthreads();
  return v;
}

// ---- WKV -------------------------------------------------------------------

template <int N>
struct WkvSmemA {   // phase A: k, v, w of a tile, sub-tile totals, factors
  static constexpr int kTile = kT * ld_of(N);
  static constexpr int kFloats = 3 * kTile + 9 * N;
};

template <int N>
struct WkvSmemC {   // phase C: r, k, v, w of a tile, A^T, the entry state,
                    // per-channel rows
  static constexpr int kTile = kT * ld_of(N);
  static constexpr int kFloats = 4 * kTile + kT * kLdT + N * ld_of(N) + 21 * N;
};

// Suffix products within each 16-step sub-tile of a (64, N) tile: k[s] *=
// prod of w over (s, end of its sub-tile), and tot[c][j] = the product of
// sub-tile c's decays.  One thread a (sub-tile, channel).
template <int N>
__device__ __forceinline__ void wkv_sub_suffix(float* k, const float* w,
                                               float* tot) {
  const int tid = threadIdx.x;
  if (tid < 4 * N) {
    const int c = tid / N, j = tid % N;
    float s = 1.f;
#pragma unroll 4
    for (int m = kSub - 1; m >= 0; --m) {
      const int row = (c * kSub + m) * ld_of(N) + j;
      k[row] *= s;
      s *= w[row];
    }
    tot[c * N + j] = s;
  }
}

// Per channel (thread j < N): fac[c][j] = carry[j] times the totals of
// the sub-tiles after c; carry[j] then takes the whole tile's product.
template <int N>
__device__ __forceinline__ void wkv_carry(const float* tot, float* fac,
                                          float* carry) {
  const int j = threadIdx.x;
  if (j < N) {
    float f = carry[j];
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      fac[c * N + j] = f;
      f *= tot[c * N + j];
    }
    carry[j] = f;
  }
}

// k[s][j] *= fac[s / 16][j] over a (64, N) tile
template <int N>
__device__ __forceinline__ void wkv_scale_rows(float* k, const float* fac) {
  for (int e = threadIdx.x; e < kT * N; e += kThreads) {
    const int t = e / N, j = e % N;
    k[t * ld_of(N) + j] *= fac[(t / kSub) * N + j];
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_state_kernel(const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ w,
                       const float* __restrict__ s0, float* __restrict__ s_out,
                       float* __restrict__ ws, float* __restrict__ dec,
                       int H, int T, int chunk, int nc) {
  extern __shared__ float4 smem4[];
  using L = WkvSmemA<N>;
  float* kb = reinterpret_cast<float*>(smem4);
  float* vb = kb + L::kTile;
  float* wb = vb + L::kTile;
  float* tot = wb + L::kTile;        // [4][N]
  float* fac = tot + 4 * N;          // [4][N]
  float* carry = fac + 4 * N;        // [N]
  constexpr int MT = N / 16;
  const int c = blockIdx.x, bh = blockIdx.z * H + blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lo = c * chunk, C = min(chunk, T - lo);
  const size_t base = ((size_t)bh * T + lo) * N;
  allow_next_grid();
  if (tid < N) carry[tid] = 1.f;
  float acc[MT][MT];
  zero(acc);
  for (int t0 = (C - 1) / kT * kT; t0 >= 0; t0 -= kT) {
    const int n = min(kT, C - t0);
    load_tile<N>(kb, k + base + (size_t)t0 * N, n, 0.f);
    load_tile<N>(vb, v + base + (size_t)t0 * N, n, 0.f);
    load_tile<N>(wb, w + base + (size_t)t0 * N, n, 1.f);
    load_wait();
    wkv_sub_suffix<N>(kb, wb, tot);
    __syncthreads();
    wkv_carry<N>(tot, fac, carry);
    __syncthreads();
    wkv_scale_rows<N>(kb, fac);
    __syncthreads();
    // dS[j][i] += sum_t kd[t][j] v[t][i]
    mm_outer<MT, MT>(acc, kb, ld_of(N), vb, ld_of(N), n, ty * MT, tx * MT);
    __syncthreads();
  }
  const size_t st = (size_t)bh * N * N;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int j = ty * MT + a;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int e = j * N + tx * MT + b;
      if (nc == 1)
        s_out[st + e] = fmaf(carry[j], s0[st + e], acc[a][b]);
      else
        ws[((size_t)bh * nc + c) * N * N + e] = acc[a][b];
    }
  }
  if (nc > 1 && tid < N) dec[((size_t)bh * nc + c) * N + tid] = carry[tid];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     const float* __restrict__ ws, float* __restrict__ out,
                     float* __restrict__ s_out, int H, int T, int chunk,
                     int nc, int tpc) {
  extern __shared__ float4 smem4[];
  using L = WkvSmemC<N>;
  constexpr int ld = ld_of(N);
  constexpr int NT = N / 16;          // output columns a thread
  constexpr int NQ = N / 4;           // float4 quads of a row
  float* rb = reinterpret_cast<float*>(smem4);   // r -> rd -> rq
  float* kb = rb + L::kTile;          // k -> kd; key tiles
  float* vb = kb + L::kTile;          // v; key tiles' v
  float* wb = vb + L::kTile;          // w; key tiles' w
  float* at = wb + L::kTile;          // A^T (64, 64); (r prod w)^T (N, 64)
  float* sb = at + kT * kLdT;         // the chunk's entry state (N, N)
  float* tot = sb + N * ld;           // [4][N] sub-tile products
  float* df = tot + 4 * N;            // [6][N] products between sub-tiles
  float* bef = df + 6 * N;            // [4][N] products before a sub-tile
  float* fac = bef + 4 * N;           // [4][N]
  float* carry = fac + 4 * N;         // [N]
  float* us = carry + N;              // [N]
  float* tall = us + N;               // [N] the tile's product (one tile)
  const int c = blockIdx.x / tpc, qi = blockIdx.x % tpc;
  const int h = blockIdx.y, bh = blockIdx.z * H + h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lo = c * chunk, C = min(chunk, T - lo);
  const int q0 = qi * kT;
  if (q0 >= C) return;
  const int nq = min(kT, C - q0);
  const size_t base = ((size_t)bh * T + lo) * N;   // the chunk's rows
  const size_t qbase = base + (size_t)q0 * N;
  // the entry state: s0 for one chunk, else the state pass's, which a
  // call of one tile lacks (it has no earlier kernel, and loads s0 now)
  const bool one_tile = nc == 1 && tpc == 1;
  const float* st = nc == 1 ? s0 + (size_t)bh * N * N
                            : ws + ((size_t)bh * nc + c) * N * N;
  load_tile<N>(rb, r + qbase, nq, 0.f);
  load_tile<N>(kb, k + qbase, nq, 0.f);
  load_tile<N>(vb, v + qbase, nq, 0.f);
  load_tile<N>(wb, w + qbase, nq, 1.f);
  if (one_tile) load_tile<N>(sb, st, N, 0.f, N);
  if (tid < N) {
    us[tid] = u[h * N + tid];
    carry[tid] = 1.f;
  }
  load_wait();

  // 1. each own sub-tile, strictly causal: for a key s and a quad of
  //    channels, P = prod_{s<m<t} w_m runs over t, giving the quad's part of
  //    A[t][s] for the 16 rows t of the sub-tile; the 16 sums over the row's
  //    quads are then taken at once (independent shuffles within a group of
  //    NQ lanes) and written to A^T, zeros where s > t and the u bonus
  //    r_t (u k_t) where s = t.
  {
    constexpr int kGroups = kThreads / NQ;
    const int jq = tid % NQ, grp = tid / NQ;
    const int nsub = (nq + kSub - 1) / kSub;
    const float4 uq = *reinterpret_cast<const float4*>(us + 4 * jq);
    for (int task = grp; task < 4 * kSub; task += kGroups) {
      const int a = task / kSub, sl = task % kSub;
      if (a >= nsub) break;            // uniform: tasks grow with a
      const int s = a * kSub + sl;
      const float4 kq = *reinterpret_cast<const float4*>(kb + s * ld + 4 * jq);
      float4 P = make_float4(1.f, 1.f, 1.f, 1.f);
      float cs[kSub];
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        const int t = a * kSub + tl;
        if (tl > sl + 1) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wb + (t - 1) * ld + 4 * jq);
          P.x *= wv.x; P.y *= wv.y; P.z *= wv.z; P.w *= wv.w;
        }
        const float4 rv = *reinterpret_cast<const float4*>(rb + t * ld + 4 * jq);
        const float4 f = tl == sl ? uq : P;
        cs[tl] = tl < sl ? 0.f
                         : rv.x * (kq.x * f.x) + rv.y * (kq.y * f.y) +
                           rv.z * (kq.z * f.z) + rv.w * (kq.w * f.w);
      }
#pragma unroll
      for (int o = NQ / 2; o > 0; o >>= 1)
#pragma unroll
        for (int tl = 0; tl < kSub; ++tl)
          cs[tl] += __shfl_xor_sync(0xffffffffu, cs[tl], o);
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl)
        if (tl % NQ == jq) at[s * kLdT + a * kSub + tl] = cs[tl];
    }
  }
  __syncthreads();

  // 2. prefix products (r) and suffix products (k) within each sub-tile,
  //    in place, and each sub-tile's total
  if (tid < 4 * N) {
    const int sc = tid / N, j = tid % N;
    float p = 1.f, s = 1.f;
#pragma unroll 4
    for (int m = 0; m < kSub; ++m) {
      const int row = (sc * kSub + m) * ld + j;
      rb[row] *= p;
      p *= wb[row];
    }
#pragma unroll 4
    for (int m = kSub - 1; m >= 0; --m) {
      const int row = (sc * kSub + m) * ld + j;
      kb[row] *= s;
      s *= wb[row];
    }
    tot[sc * N + j] = p;
  }
  __syncthreads();
  if (tid < N) {
    const float t0 = tot[tid], t1 = tot[N + tid], t2 = tot[2 * N + tid];
    bef[tid] = 1.f;
    bef[N + tid] = t0;
    bef[2 * N + tid] = t0 * t1;
    bef[3 * N + tid] = t0 * t1 * t2;
    // pairs (a, b), b < a, at a (a - 1) / 2 + b: the sub-tiles between
    df[0 * N + tid] = 1.f;       // (1, 0)
    df[1 * N + tid] = t1;        // (2, 0)
    df[2 * N + tid] = 1.f;       // (2, 1)
    df[3 * N + tid] = t1 * t2;   // (3, 0)
    df[4 * N + tid] = t2;        // (3, 1)
    df[5 * N + tid] = 1.f;       // (3, 2)
  }
  __syncthreads();

  // 3. earlier sub-tiles of the own tile: A[t][s] = sum_j rd[t][j]
  //    df[a, b][j] kd[s][j] for t in sub-tile a, s in b < a (a thread's
  //    micro-tile rows ty + 16a and columns tx + 16b hit one entry of each
  //    sub-tile pair); later sub-tiles are zero
  {
    float acc[4][3] = {};
    if (nq > kSub) {
      for (int j = 0; j < N; j += 4) {
        float4 q[3], kk[3], d[6];
#pragma unroll
        for (int a = 1; a < 4; ++a)
          q[a - 1] = *reinterpret_cast<const float4*>(
              rb + (ty + 16 * a) * ld + j);
#pragma unroll
        for (int b = 0; b < 3; ++b)
          kk[b] = *reinterpret_cast<const float4*>(
              kb + (tx + 16 * b) * ld + j);
#pragma unroll
        for (int p = 0; p < 6; ++p)
          d[p] = *reinterpret_cast<const float4*>(df + p * N + j);
#pragma unroll
        for (int a = 1; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < a; ++b) {
            const float4 dq = d[a * (a - 1) / 2 + b], qa = q[a - 1];
            acc[a][b] = fmaf(qa.x * dq.x, kk[b].x,
                        fmaf(qa.y * dq.y, kk[b].y,
                        fmaf(qa.z * dq.z, kk[b].z,
                        fmaf(qa.w * dq.w, kk[b].w, acc[a][b]))));
          }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b != a)
          at[(tx + 16 * b) * kLdT + ty + 16 * a] = b < a ? acc[a][b] : 0.f;
  }
  __syncthreads();

  // 4. out = A @ v (the u bonus included); then rq = rd * (products of the sub-tiles
  //    before), the query factor of earlier tiles and of the cross term
  float o[4][NT];
  zero(o);
  const bool rows = ty * 4 < nq;      // this thread's rows hold outputs
  if (rows) mm_outer<4, NT>(o, at, kLdT, vb, ld, nq, ty * 4, tx * NT);
  for (int e = tid; e < kT * N; e += kThreads) {
    const int t = e / N, j = e % N;
    rb[t * ld + j] *= bef[(t / kSub) * N + j];
  }
  __syncthreads();

  // 4b. a call of one tile has no chunk-state kernel: its final state,
  //    (prod_t w_t) S + sum_t (k_t prod_{m>t} w_m) v_t^T, is written here
  //    (kd's suffix products extended over the later sub-tiles)
  if (one_tile) {
    if (tid < N) {
      float f = 1.f;
#pragma unroll
      for (int sc = 3; sc >= 0; --sc) {
        fac[sc * N + tid] = f;
        f *= tot[sc * N + tid];
      }
      tall[tid] = f;
    }
    __syncthreads();
    wkv_scale_rows<N>(kb, fac);
    __syncthreads();
    constexpr int MT = N / 16;
    float ds[MT][MT];
    zero(ds);
    mm_outer<MT, MT>(ds, kb, ld, vb, ld, nq, ty * MT, tx * MT);
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      const int j = ty * MT + a;
#pragma unroll
      for (int b = 0; b < MT; ++b) {
        const int i = tx * MT + b;
        s_out[(size_t)bh * N * N + j * N + i] =
            fmaf(tall[j], sb[j * ld + i], ds[a][b]);
      }
    }
    __syncthreads();
  }

  // 5. earlier tiles of the chunk, from the nearest: kf[s] = k[s] prod_{s<m
  //    <q0} w_m; A = rq kf^T; out += A @ v
  for (int kt = qi - 1; kt >= 0; --kt) {
    const size_t kbase = base + (size_t)kt * kT * N;
    load_tile<N>(kb, k + kbase, kT, 0.f);
    load_tile<N>(vb, v + kbase, kT, 0.f);
    load_tile<N>(wb, w + kbase, kT, 1.f);
    load_wait();
    wkv_sub_suffix<N>(kb, wb, tot);
    __syncthreads();
    wkv_carry<N>(tot, fac, carry);
    __syncthreads();
    wkv_scale_rows<N>(kb, fac);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    mm_inner<4, 4>(acc, rb, ld, kb, ld, N, ty, tx, (nq + 15) / 16);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        at[(tx + 16 * b) * kLdT + ty + 16 * a] = acc[a][b];
    __syncthreads();
    if (rows) mm_outer<4, NT>(o, at, kLdT, vb, ld, kT, ty * 4, tx * NT);
    __syncthreads();
  }

  // 6. cross term: (rq * prod_{lo<=m<q0} w_m)^T, transposed into `at`,
  //    against the chunk's entry state (the earlier kernels' results)
  if (!one_tile) {
    wait_prior_grid();
    load_tile<N>(sb, st, N, 0.f, N);
  }
  for (int e = tid; e < kT * N; e += kThreads) {
    const int t = e % kT, j = e / kT;
    at[j * kLdT + t] = rb[t * ld + j] * carry[j];
  }
  load_wait();
  if (rows) {
    mm_outer<4, NT>(o, at, kLdT, sb, ld, N, ty * 4, tx * NT);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty * 4 + a;
      if (t < nq) {
        float* dst = out + qbase + (size_t)t * N + tx * NT;
#pragma unroll
        for (int b = 0; b < NT; ++b) dst[b] = o[a][b];
      }
    }
  }
}

// ---- state pass (both families) -------------------------------------------

// S <- decay * S + dS over the chunks, a float4 of the state a thread; each
// chunk's entry state overwrites its dS.  `row` is the state floats that
// share one decay value (N for WKV's per-key-channel decay, P N for SSD's).
// The dS and decays of kAhead chunks are loaded before the first is used,
// so a thread waits for device memory once per kAhead chunks, not per
// chunk.
__global__ void __launch_bounds__(kThreads)
chunk_state_pass_kernel(const float* __restrict__ s0, float* __restrict__ s_out,
                        float* __restrict__ ws, const float* __restrict__ dec,
                        int H, int nc, int state, int row) {
  constexpr int kAhead = 8;
  allow_next_grid();
  wait_prior_grid();
  const int e4 = blockIdx.x * kThreads + threadIdx.x;
  if (4 * e4 >= state) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int ndec = state / row;
  const int di = 4 * e4 / row;
  float4* d = reinterpret_cast<float4*>(ws + bh * nc * state) + e4;
  const float* g = dec + bh * nc * ndec + di;
  const int step = state / 4;         // float4s between two chunks' dS
  float4 S = reinterpret_cast<const float4*>(s0 + bh * state)[e4];
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    const int n = min(kAhead, nc - c0);
    float4 x[kAhead];
    float gc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (u < n) {
        x[u] = d[(size_t)(c0 + u) * step];
        gc[u] = g[(size_t)(c0 + u) * ndec];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (u < n) {
        d[(size_t)(c0 + u) * step] = S;
        S.x = fmaf(gc[u], S.x, x[u].x);
        S.y = fmaf(gc[u], S.y, x[u].y);
        S.z = fmaf(gc[u], S.z, x[u].z);
        S.w = fmaf(gc[u], S.w, x[u].w);
      }
  }
  reinterpret_cast<float4*>(s_out + bh * state)[e4] = S;
}

// ---- SSD -------------------------------------------------------------------

template <int P, int N>
struct SsdSmemA {   // phase A: x, b of a tile, weights, scan scratch
  static constexpr int kFloats = kT * ld_of(P) + kT * ld_of(N) + kT + 32;
};

template <int P, int N>
struct SsdSmemC {   // phase C: c, b, x tiles, M^T, the heads' entry states;
                    // per-head scalars
  static constexpr int kFloats = 2 * kT * ld_of(N) + kT * ld_of(P) +
                                 kT * kLdT + kHeads * P * ld_of(N) +
                                 2 * kHeads * kT  /* lq, f64 */ +
                                 3 * kHeads * kT + 2 * kHeads + 16;
  static_assert(kHeads * kT <= kThreads, "a group of 64 threads a head");
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ b,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ s0, float* __restrict__ s_out,
                       float* __restrict__ ws, float* __restrict__ dec,
                       int H, int T, int chunk, int nc) {
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);
  float* bb = xb + kT * ld_of(P);
  float* wt = bb + kT * ld_of(N);                 // [64] row weights
  double* tmp = reinterpret_cast<double*>(wt + kT);   // [16]
  constexpr int MT = P / 16, NT = N / 16;
  const int c = blockIdx.x, h = blockIdx.y, bidx = blockIdx.z;
  const int bh = bidx * H + h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lo = c * chunk, C = min(chunk, T - lo);
  const double ah = a[h];
  allow_next_grid();
  double carry = 0.0;                 // sum of dt a over the later tiles
  float acc[MT][NT];
  zero(acc);
  for (int t0 = (C - 1) / kT * kT; t0 >= 0; t0 -= kT) {
    const int n = min(kT, C - t0);
    load_tile<P>(xb, x + ((size_t)bh * T + lo + t0) * P, n, 0.f);
    load_tile<N>(bb, b + ((size_t)bidx * T + lo + t0) * N, n, 0.f);
    __pipeline_commit();
    // suffix sums of dt a: thread i scans row 63 - i
    const int row = kT - 1 - (tid & (kT - 1));
    const float dtv = row < n ? dt[(size_t)bh * T + lo + t0 + row] : 0.f;
    const double la = dtv * ah;
    const double inc = scan64(la, tmp);           // sum over rows >= row
    if (tid < kT) wt[row] = dtv * expf((float)(inc - la + carry));
    if (tid == kT - 1) tmp[8] = inc;              // the tile's total
    load_wait();
    carry += tmp[8];
    for (int e = tid; e < kT * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xb[t * ld_of(P) + p] *= wt[t];
    }
    __syncthreads();
    // dS[p][n] += sum_t (w_t x_t)[p] b_t[n]
    mm_outer<MT, NT>(acc, xb, ld_of(P), bb, ld_of(N), n, ty * MT, tx * NT);
    __syncthreads();
  }
  const float g = expf((float)carry);
  const size_t st = (size_t)bh * P * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int e = (ty * MT + i) * N + tx * NT + j;
      if (nc == 1)
        s_out[st + e] = fmaf(g, s0[st + e], acc[i][j]);
      else
        ws[((size_t)bh * nc + c) * P * N + e] = acc[i][j];
    }
  if (nc > 1 && tid == 0) dec[(size_t)bh * nc + c] = g;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out_kernel(const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ cm,
                     const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ s0,
                     const float* __restrict__ ws, float* __restrict__ y,
                     float* __restrict__ s_out, int H, int T, int chunk,
                     int nc, int tpc) {
  extern __shared__ float4 smem4[];
  constexpr int ldn = ld_of(N), ldp = ld_of(P);
  constexpr int PT = P / 16;          // output columns a thread
  float* cq = reinterpret_cast<float*>(smem4);    // c of the query rows
  float* bk = cq + kT * ldn;          // b of a key tile
  float* xk = bk + kT * ldn;          // x of a key tile, one head
  float* mt = xk + kT * ldp;          // M^T; the cross term
  float* sb = mt + kT * kLdT;         // [kHeads] entry states (P, N)
  double* lq = reinterpret_cast<double*>(sb + kHeads * P * ldn);
  float* dtq = reinterpret_cast<float*>(lq + kHeads * kT); // [kHeads][64]
  float* rowf = dtq + kHeads * kT;    // [kHeads][64] exp(L_t)
  float* colf = rowf + kHeads * kT;   // [kHeads][64] a key tile's factors
  double* carry = reinterpret_cast<double*>(colf + kHeads * kT);  // [kHeads]
  double* tmp = carry + kHeads;       // [8]
  const int c = blockIdx.x / tpc, qi = blockIdx.x % tpc;
  const int h0 = blockIdx.y * kHeads, bidx = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lo = c * chunk, C = min(chunk, T - lo);
  const int q0 = qi * kT;
  if (q0 >= C) return;
  const int nq = min(kT, C - q0);
  const int nh = min(kHeads, H - h0);       // the block's heads
  const int g = tid / kT, row = tid % kT;   // one head a group of 64 threads
  const bool mine = g < nh;
  const int hg = h0 + g;
  const size_t bc0 = (size_t)bidx * T + lo;      // the chunk's b, c rows
  const bool one_tile = nc == 1 && tpc == 1;     // writes the final state
  const int na = (nq + 15) / 16;                 // row groups with rows
  // the heads' entry states: s0 for one chunk, else the state pass's; a
  // call of one tile has no earlier kernel and loads them now
  auto load_states = [&] {
    for (int i = 0; i < nh; ++i) {
      const size_t sbh = (size_t)bidx * H + h0 + i;
      load_tile<N>(sb + i * P * ldn,
                   nc == 1 ? s0 + sbh * P * N : ws + (sbh * nc + c) * P * N,
                   P, 0.f, P);
    }
  };
  load_tile<N>(cq, cm + (bc0 + q0) * N, nq, 0.f);
  if (one_tile) load_states();
  {
    const float dtv =
        mine && row < nq ? dt[((size_t)bidx * H + hg) * T + lo + q0 + row]
                         : 0.f;
    const double la = mine ? dtv * (double)a[hg] : 0.0;
    const double inc = scan64(la, tmp);
    if (mine) {
      lq[g * kT + row] = inc;
      dtq[g * kT + row] = dtv;
      rowf[g * kT + row] = expf((float)inc);
      if (row == 0) carry[g] = 0.0;
    }
  }
  float yacc[kHeads][4][PT];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) zero(yacc[i]);
  const bool rows = ty * 4 < nq;
  for (int kt = qi; kt >= 0; --kt) {
    const int nk = kt == qi ? nq : kT;
    load_tile<N>(bk, b + (bc0 + (size_t)kt * kT) * N, nk, 0.f);
    if (kt < qi) {
      // key factors exp(L_{q0-1} - L_s) dt_s: suffix sums of dt a within
      // the tile (thread i scans row 63 - i) plus the later tiles' sum
      const int sr = kT - 1 - row;
      const float dtv =
          mine ? dt[((size_t)bidx * H + hg) * T + lo + kt * kT + sr] : 0.f;
      const double la = mine ? dtv * (double)a[hg] : 0.0;
      const double inc = scan64(la, tmp);
      if (mine) colf[g * kT + sr] = dtv * expf((float)(inc - la + carry[g]));
      __syncthreads();
      if (mine && row == kT - 1) carry[g] += inc;   // the tile's total
    }
    load_wait();
    float G[4][4];                    // c b^T, shared by the block's heads
    zero(G);
    mm_inner<4, 4>(G, cq, ldn, bk, ldn, N, ty, tx, na);
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      if (i >= nh) break;
      load_tile<P>(xk,
                   x + (((size_t)bidx * H + h0 + i) * T + lo + kt * kT) * P,
                   nk, 0.f);
#pragma unroll
      for (int ra = 0; ra < 4; ++ra)
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          const int t = ty + 16 * ra, s = tx + 16 * cb;
          float m = 0.f;
          if (kt < qi) {
            m = G[ra][cb] * rowf[i * kT + t] * colf[i * kT + s];
          } else if (s <= t && t < nq) {
            m = G[ra][cb] * dtq[i * kT + s] *
                expf((float)(lq[i * kT + t] - lq[i * kT + s]));
          }
          mt[s * kLdT + t] = m;
        }
      load_wait();
      if (rows) mm_outer<4, PT>(yacc[i], mt, kLdT, xk, ldp, nk, ty * 4,
                                tx * PT);
      __syncthreads();
    }
  }
  if (!one_tile) {
    wait_prior_grid();
    load_states();
    load_wait();
  }
  // per head: the cross term exp(L_t) (c_t . S[p]), L_t from the chunk's
  // start, computed in the inner form and added through `mt`; for a call of
  // one tile also the final state exp(L_C) S + sum_t exp(L_C - L_t) dt_t
  // x_t b_t^T (there is no chunk-state kernel; `bk` holds the tile's b)
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    if (i >= nh) break;
    const size_t sbh = (size_t)bidx * H + h0 + i;
    const float* S = sb + i * P * ldn;
    float X[4][PT];
    zero(X);
    mm_inner<4, PT>(X, cq, ldn, S, ldn, N, ty, tx, na);
#pragma unroll
    for (int ra = 0; ra < 4; ++ra) {
      const int t = ty + 16 * ra;
      const float f = expf((float)(carry[i] + lq[i * kT + t]));
#pragma unroll
      for (int cb = 0; cb < PT; ++cb)
        mt[t * kLdT + tx + 16 * cb] = f * X[ra][cb];
    }
    if (one_tile) {
      const double lc = lq[i * kT + nq - 1];
      for (int e = tid; e < kT * P; e += kThreads) {
        const int t = e / P, p = e % P;
        xk[t * ldp + p] =
            t < nq ? x[(sbh * T + t) * P + p] * dtq[i * kT + t] *
                         expf((float)(lc - lq[i * kT + t]))
                   : 0.f;
      }
    }
    __syncthreads();
    if (rows) {
#pragma unroll
      for (int ra = 0; ra < 4; ++ra) {
        const int t = ty * 4 + ra;
        float yv[PT];
        load_vec<PT>(yv, mt + t * kLdT + tx * PT);
        if (t < nq) {
          float* dst = y + (sbh * T + lo + q0 + t) * P + tx * PT;
#pragma unroll
          for (int cb = 0; cb < PT; ++cb) dst[cb] = yacc[i][ra][cb] + yv[cb];
        }
      }
    }
    if (one_tile) {
      constexpr int MT = P / 16, NT = N / 16;
      float ds[MT][NT];
      zero(ds);
      mm_outer<MT, NT>(ds, xk, ldp, bk, ldn, nq, ty * MT, tx * NT);
      const float gc = expf((float)lq[i * kT + nq - 1]);
#pragma unroll
      for (int pi = 0; pi < MT; ++pi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const int p = ty * MT + pi, n = tx * NT + nj;
          s_out[sbh * P * N + p * N + n] =
              fmaf(gc, S[p * ldn + n], ds[pi][nj]);
        }
    }
    __syncthreads();
  }
}

template <typename F>
int dispatch_dim(int n, F&& f) {
  switch (n) {
    case 16: f(std::integral_constant<int, 16>{}); return 0;
    case 64: f(std::integral_constant<int, 64>{}); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

// the state a fused thread holds, in float4s (fused_per_thread)
template <typename F>
void dispatch_per(int r, F&& f) {
  switch (r) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

// The chunked scans enqueue their chunk-state kernel, the state pass when
// there is more than one chunk, and the output kernel; a call of one
// 64-step tile only the output kernel, which then writes the final state
// too.  `ws` (B, H, chunks, state) and `dec` (B, H, chunks, N or 1) are the
// wrapper's workspace, NULL for a single chunk.

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch `kernel` on `st` with programmatic stream serialization when
// `after` (the call's previous kernel is on the stream), else plainly.
template <typename... Exp, typename... Act>
int launch(bool after, void (*kernel)(Exp...), dim3 grid, size_t smem,
           cudaStream_t st, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

int state_pass(const void* s0, void* s_out, void* ws, const void* dec, int B,
               int H, int nc, int state, int row, cudaStream_t st) {
  const dim3 grid((state / 4 + kThreads - 1) / kThreads, H, B);
  return launch(true, chunk_state_pass_kernel, grid, 0, st,
                (const float*)s0, (float*)s_out, (float*)ws,
                (const float*)dec, H, nc, state, row);
}

}  // namespace

extern "C" {

// Each launcher enqueues its kernels on `stream` (the fused ones one, the
// chunked ones two or three) and returns the first cudaGetLastError() that
// is not 0 (0 = launched); the wrapper raises on anything else.

int wkv_fused_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* s_out, int B, int H, int T, int N, void* stream) {
  if (B * H == 0) return 0;
  int rc = 0;
  const int rd = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    const int per =
        fused_per_thread((long)B * H * (kN / 8), 1, min(4, kN / 8));
    dispatch_per(per, [&](auto rr) {
      constexpr int kR = decltype(rr)::value;
      if constexpr (kR <= 4 && 8 * kR <= kN) {
        using F = WkvFused<kN, kR>;
        wkv_fused_kernel<kN, kR><<<dim3(kN / F::kCols, H, B), F::kThreads,
                                   F::smem_floats(T) * sizeof(float),
                                   (cudaStream_t)stream>>>(
            (const float*)r, (const float*)k, (const float*)v,
            (const float*)w, (const float*)u, (const float*)s0,
            (float*)out, (float*)s_out, H, T);
      } else {
        rc = (int)cudaErrorInvalidValue;
      }
    });
  });
  if (rd || rc) return rd ? rd : rc;
  return (int)cudaGetLastError();
}

int wkv_chunk_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* s_out, void* ws, void* dec, int B, int H, int T,
                     int N, int chunk, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  const int nc = (T + chunk - 1) / chunk;
  const int tpc = (min(chunk, T) + kT - 1) / kT;
  if (nc > 1 && (ws == nullptr || dec == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  const int rd = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    const size_t sa = WkvSmemA<kN>::kFloats * sizeof(float);
    const size_t sc = WkvSmemC<kN>::kFloats * sizeof(float);
    rc = set_smem(wkv_chunk_state_kernel<kN>, sa);
    if (!rc) rc = set_smem(wkv_chunk_out_kernel<kN>, sc);
    if (rc) return;
    const bool one_tile = nc == 1 && tpc == 1;
    if (!one_tile) {
      rc = launch(false, wkv_chunk_state_kernel<kN>, dim3(nc, H, B), sa, st,
                  (const float*)k, (const float*)v, (const float*)w,
                  (const float*)s0, (float*)s_out, (float*)ws, (float*)dec,
                  H, T, chunk, nc);
      if (!rc && nc > 1)
        rc = state_pass(s0, s_out, ws, dec, B, H, nc, kN * kN, kN, st);
      if (rc) return;
    }
    rc = launch(!one_tile, wkv_chunk_out_kernel<kN>, dim3(nc * tpc, H, B),
                sc, st, (const float*)r, (const float*)k, (const float*)v,
                (const float*)w, (const float*)u, (const float*)s0,
                (const float*)ws, (float*)out, (float*)s_out, H, T, chunk,
                nc, tpc);
  });
  return rd ? rd : rc;
}

int ssd_fused_launch(const void* x, const void* b, const void* c,
                     const void* dt, const void* a, const void* s0, void* y,
                     void* s_out, int B, int H, int T, int P, int N,
                     void* stream) {
  if (B * H == 0) return 0;
  if (P != 16 && P != 64) return (int)cudaErrorInvalidValue;
  int rc = 0;
  const int rd = dispatch_dim(N, [&](auto n) {
    constexpr int kN = decltype(n)::value;
    const int per =
        fused_per_thread((long)B * H * (P / 16), 2, min(8, P / 8));
    dispatch_per(per, [&](auto rr) {
      constexpr int kR = decltype(rr)::value;
      if constexpr (kR >= 2) {
        using F = SsdFused<kN, kR>;
        ssd_fused_kernel<kN, kR><<<dim3(P / F::kRows, H, B), F::kThreads,
                                   F::smem_floats(T) * sizeof(float),
                                   (cudaStream_t)stream>>>(
            (const float*)x, (const float*)b, (const float*)c,
            (const float*)dt, (const float*)a, (const float*)s0, (float*)y,
            (float*)s_out, H, T, P);
      } else {
        rc = (int)cudaErrorInvalidValue;
      }
    });
  });
  if (rd || rc) return rd ? rd : rc;
  return (int)cudaGetLastError();
}

int ssd_chunk_launch(const void* x, const void* b, const void* c,
                     const void* dt, const void* a, const void* s0, void* y,
                     void* s_out, void* ws, void* dec, int B, int H, int T,
                     int P, int N, int chunk, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  const int nc = (T + chunk - 1) / chunk;
  const int tpc = (min(chunk, T) + kT - 1) / kT;
  if (nc > 1 && (ws == nullptr || dec == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  const int rp = dispatch_dim(P, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    const int rn = dispatch_dim(N, [&](auto n) {
      constexpr int kN = decltype(n)::value;
      const size_t sa = SsdSmemA<kP, kN>::kFloats * sizeof(float);
      const size_t sc = SsdSmemC<kP, kN>::kFloats * sizeof(float);
      rc = set_smem(ssd_chunk_state_kernel<kP, kN>, sa);
      if (!rc) rc = set_smem(ssd_chunk_out_kernel<kP, kN>, sc);
      if (rc) return;
      const bool one_tile = nc == 1 && tpc == 1;
      if (!one_tile) {
        rc = launch(false, ssd_chunk_state_kernel<kP, kN>, dim3(nc, H, B),
                    sa, st, (const float*)x, (const float*)b,
                    (const float*)dt, (const float*)a, (const float*)s0,
                    (float*)s_out, (float*)ws, (float*)dec, H, T, chunk, nc);
        if (!rc && nc > 1)
          rc = state_pass(s0, s_out, ws, dec, B, H, nc, kP * kN, kP * kN,
                          st);
        if (rc) return;
      }
      rc = launch(!one_tile, ssd_chunk_out_kernel<kP, kN>,
                  dim3(nc * tpc, (H + kHeads - 1) / kHeads, B), sc, st,
                  (const float*)x, (const float*)b, (const float*)c,
                  (const float*)dt, (const float*)a, (const float*)s0,
                  (const float*)ws, (float*)y, (float*)s_out, H, T, chunk,
                  nc, tpc);
    });
    if (rn) rc = rn;
  });
  return rp ? rp : rc;
}

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
