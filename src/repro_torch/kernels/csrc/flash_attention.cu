// Online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (body `_flash_kernel`)
// of src/repro/kernels/flash_attention.py.
//
// What it computes.  q (B, S, H, D) or (BH, S, D) and k / v (B, Sk, H, D)
// or (BH, Sk, D), read and written through (batch, head, row) strides in
// elements, so the model layout is read in place -> out in q's dtype
// (float32 or bfloat16).  Query row qi sees key ki where `qi >= ki`
// (causal) and `qi - ki < window` (window > 0), on absolute positions with
// no offset, also when S != Sk.  Scores q.k * D^-1/2 are masked to -1e30,
// the softmax is online over the caller's (bq, bk) tiles in f32 (one update
// per k-tile, as on the TPU) and the denominator is clamped at 1e-30,
// exactly as the TPU kernel does: a row with no visible key at all gets a
// uniform softmax over every key (the mean of v), like the plain version.
// k-tiles that every row of the block masks out are skipped: they only add
// exact zeros once a row has seen a visible key.  Blocks holding a row that
// sees no key at all walk every tile, so such rows get the TPU kernel's
// uniform result.
//
// What bounds it.  Attention does ~4 * D flops per (query, visible key)
// pair against ~4 * D bytes per query or key row it must read: at the main
// path's shape (S = 512, D = 64, causal) the bf16 call is bound by the bytes
// it must move, and the f32 call (three TF32 products a product, below) by
// the tensor cores' TF32 operations.
//
// bf16: what the design does about that.  `flash_bf16_mma` runs both
// products on the tensor cores with `mma.sync.m16n8k16` (bf16 in, f32
// accumulators).  One block per (b, h, q-tile of bq rows), one warp per 16
// query rows (bq in {32, 64, 128}: 2, 4 or 8 warps); each warp keeps its Q
// fragments in registers for the whole walk.  K and V tiles of bk rows
// (bk in {32, 64, 128}) come through a double-buffered `cp.async` ring,
// rows padded by 16 bytes so `ldmatrix` reads hit distinct banks.  S = Q.K^T
// stays in registers; mask, row max and row sum are reduced there with quad
// shuffles, and no score tile goes to shared memory.  P.V reuses P from the
// score accumulator's register layout as the A operand.  P is split into
// hi = bf16(P) and lo = bf16(P - hi), two MMAs into one f32 accumulator:
// P rounded once to bf16 misses the bf16 bound the kernel is held to
// (1e-5 + 2^-8 x |plain|), the split meets it with f32 P's error.  Q.K^T
// needs no such care: a product of two bf16 values is exact in f32.  The
// softmax's elementwise work, not the MMAs, bounds the loop, so exp runs
// as one SFU `ex2.approx` (2^-22 relative error) and each pair of P is
// split with two packing conversions.
//
// f32: what the design does about that.  `flash_f32_mma` runs both
// products on the tensor cores as a 3xTF32 split with
// `mma.sync.m16n8k8.f32.tf32.tf32.f32`: each f32 operand a becomes a_hi =
// tf32(a) (`cvt.rna`) and a_lo = tf32(a - a_hi), and a product is lo.hi +
// hi.lo + hi.hi into one f32 tile, the small terms first (lo.lo, at most
// 2^-22 of it, is dropped).  The block layout is the bf16 kernel's: a block
// per (b, h, q-tile of bq rows), a warp per 16 query rows.  Q is split once
// per block into registers (D <= 64; at D = 128 its halves would take 128
// registers a thread, so Q stays f32 there and each use splits it), each K
// tile as its fragments are read for S = Q.K^T, P and each V tile as their
// fragments are read for O = P.V.  A product's columns may stand for any k
// of its step: in S two steps cover 16 dims, a lane's columns being dims
// 4t, 4t+1 and 4t+2, 4t+3, so one 16-byte load of a K row feeds both; in
// O = P.V a lane's columns are keys 2t and 2t+1, where the score
// accumulator holds them, so P needs no shuffle.  The tensor cores' f32
// adds do not round to nearest, so no sum runs long on them: S sums the D
// dims of one k-tile into a fresh tile; each group of (up to 4) output
// tiles sums the k-tile's keys of P.V into a fresh tile, added to O as O =
// alpha O + part with round-to-nearest FMAs.  At the main path's shape it
// is within 4.3e-6 of the plain version (the gate 1e-5 + 1e-5 x
// |plain|).  K and V each have one buffer and alternate: the next K tile
// loads by `cp.async` while this tile's softmax and P.V run, the next V
// tile while the next S runs (K rows padded by 16 floats, V rows by 4, so
// the fragment loads hit distinct banks); at most 138 KB of shared memory
// (D = 128, bk = 128).  At the main path's shape it takes ~6x its 3xTF32
// bound: every warp re-splits the whole K and V tile (8 warps at bq =
// 128), and the softmax's elementwise work issues beside the MMAs;
// splitting K and V once per block into shared memory is the next step
// (at D = 128, bk = 128 the split halves would not fit beside each other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxTile = 128;       // bq and bk at most this

// (batch, head, row) strides of a tensor in elements; its last dim is
// contiguous
struct Strides {
  long long b, h, r;
};

// the k-tiles [kb0, kb1] a block of rows q0 .. q0+bq-1 must walk
__device__ __forceinline__ void tile_range(int q0, int bq, int Sk, int bk,
                                           int causal, int window, int& kb0,
                                           int& kb1) {
  const int last = q0 + bq - 1;
  kb0 = 0;
  kb1 = Sk / bk - 1;
  if (!(window > 0 && last >= Sk - 1 + window)) {
    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(last, Sk - 1) : Sk - 1;
    kb0 = lo / bk;
    kb1 = hi / bk;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (max relative error ~2^-22); exp(x) is ex2(x * log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// P's two bf16 halves: hi = bf16(p), lo = bf16(p - hi), packed in pairs
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  // a bf16 is the top half of an f32
  lo = pack_bf16(p0 - __uint_as_float(hi << 16),
                 p1 - __uint_as_float(hi & 0xFFFF0000u));
}

template <int D>
__host__ __device__ constexpr int kv_pitch() {
  return D + 8;   // a K / V row in shared memory, padded by 16 bytes
}

template <int D, int BK>
constexpr size_t bf16_smem_bytes() {
  return (size_t)2 * 2 * BK * kv_pitch<D>() * sizeof(bf16);  // 2 bufs, K, V
}

// Fragment layouts (m16n8k16): lane l holds, of a 16-row A tile, rows
// g = l/4 and g+8 at columns 2c, 2c+1 (+8), c = l%4; of the 16 x 8
// accumulator, rows g and g+8 at columns 2c, 2c+1.
template <int D, int BK>
__global__ void __launch_bounds__(kMaxTile * 2)
flash_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int H,
               int S, int Sk, int bq, int causal, int window, float scale,
               Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int DP = kv_pitch<D>();
  constexpr int NS = BK / 8;        // score accumulators (8 keys each)
  constexpr int NO = D / 8;         // output accumulators (8 columns each)
  extern __shared__ __align__(16) bf16 kvs[];   // [2][K, V][BK][DP]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * bq;
  const bf16* kb_ = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  int kb0, kb1;
  tile_range(q0, bq, Sk, BK, causal, window, kb0, kb1);

  auto load_tile = [&](int kb, int buf) {
    constexpr int CH = D / 8;      // 16-byte chunks of a row
    bf16* ks = kvs + buf * 2 * BK * DP;
    bf16* vs = ks + BK * DP;
    const long long k0 = (long long)kb * BK;
    for (int e = tid; e < BK * CH; e += nthreads) {
      const int r = e / CH, ch = e % CH;
      cp_async16(ks + r * DP + ch * 8, kb_ + (k0 + r) * sk.r + ch * 8);
      cp_async16(vs + r * DP + ch * 8, vb + (k0 + r) * sv.r + ch * 8);
    }
    cp_async_commit();
  };
  load_tile(kb0, 0);

  // this warp's 16 query rows: g and g + 8 of them
  const int qr = q0 + warp * 16 + g;
  uint32_t qf[D / 16][4];
  {
    const bf16* qp = q + b * sq.b + h * sq.h + (long long)qr * sq.r + 2 * c;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      qf[t][0] = *reinterpret_cast<const uint32_t*>(qp + 16 * t);
      qf[t][1] = *reinterpret_cast<const uint32_t*>(qp + 8 * sq.r + 16 * t);
      qf[t][2] = *reinterpret_cast<const uint32_t*>(qp + 16 * t + 8);
      qf[t][3] =
          *reinterpret_cast<const uint32_t*>(qp + 8 * sq.r + 16 * t + 8);
    }
  }
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb0, it = 0; kb <= kb1; ++kb, ++it) {
    const int buf = it & 1;
    if (kb < kb1) {
      load_tile(kb + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + buf * 2 * BK * DP;
    const bf16* vs = ks + BK * DP;
    const int k0 = kb * BK;

    // S = Q . K^T: K rows are the B operand's columns (ldmatrix, no trans)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int t = 0; t < D / 16; t += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (8 * j + lane % 8) * DP + 16 * t + 8 * (lane / 8));
        mma_bf16(s[j], qf[t], kf[0], kf[1]);
        mma_bf16(s[j], qf[t + 1], kf[2], kf[3]);
      }
    }
    // scale, mask, row max over the tile (rows g: e = 0, 1; g + 8: e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qr + 8 * (e / 2), ki = k0 + 8 * j + 2 * c + (e % 2);
        bool ok = true;
        if (causal) ok = ok && qi >= ki;
        if (window > 0) ok = ok && qi - ki < window;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // the difference first: two masked -1e30s must give exactly 0
      alpha[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2((s[j][e] - m[e / 2]) * kLog2e);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];

    // O += P . V, P = hi + lo from the score registers; V rows are the B
    // operand's rows (ldmatrix with trans)
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * t][0], s[2 * t][1], ph[0], pl[0]);
      split_pair(s[2 * t][2], s[2 * t][3], ph[1], pl[1]);
      split_pair(s[2 * t + 1][0], s[2 * t + 1][1], ph[2], pl[2]);
      split_pair(s[2 * t + 1][2], s[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (16 * t + 8 * ((lane / 8) % 2) + lane % 8) *
                                       DP + 8 * j + 8 * (lane / 16));
        mma_bf16(o[j], ph, vf[0], vf[1]);
        mma_bf16(o[j], pl, vf[0], vf[1]);
        mma_bf16(o[j + 1], ph, vf[2], vf[3]);
        mma_bf16(o[j + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();   // the buffer is refilled by the next iteration
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  bf16* op = out + b * so.b + h * so.h + (long long)qr * so.r + 2 * c;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(op + 8 * so.r + 8 * j) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync.m16n8k8)
// ---------------------------------------------------------------------------

// a = tf32(x) (to nearest, ties away) and b = tf32(x - a): x = a + b up to
// 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// three products into one f32 tile, the small terms first: lo . hi,
// hi . lo, hi . hi (lo . lo, at most 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D>
__host__ __device__ constexpr int k_pitch() {
  return D + 16;   // 16-byte loads of (key g, 4 dims at 4t) hit 32 banks
}                  // per quarter warp
template <int D>
__host__ __device__ constexpr int v_pitch() {
  return D + 4;    // (key 2t (+1), dim g) loads hit 32 banks
}
template <int D, int BK>
constexpr size_t f32_smem_bytes() {
  return (size_t)BK * (k_pitch<D>() + v_pitch<D>()) * sizeof(float);
}

// Fragment layouts (m16n8k8, lane l: g = l/4, t = l%4): A holds rows g and
// g+8 at columns t and t+4; B rows t and t+4 at column g; the accumulator
// rows g and g+8 at columns 2t and 2t+1.  A product sums over its 8
// columns in any order, so each step picks which k each column stands for:
// in S = Q.K^T two steps cover 16 dims, and a lane's columns t and t+4 are
// dims 4t, 4t+1 in the first and 4t+2, 4t+3 in the second (one 16-byte
// load of a K row feeds both); in O = P.V columns t and t+4 are keys 2t and
// 2t+1 of the 8, exactly the score accumulator's columns, so P is the A
// operand as it lies in registers, with no shuffle.
template <int D, int BK>
__global__ void __launch_bounds__(kMaxTile * 2)
flash_f32_mma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int H,
              int S, int Sk, int bq, int causal, int window, float scale,
              Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int KP = k_pitch<D>(), VP = v_pitch<D>();
  constexpr int NS = BK / 8;        // score tiles (8 keys each)
  constexpr int NO = D / 8;         // output tiles (8 dims each)
  constexpr int JG = NO < 4 ? NO : 4;   // output tiles a P.V pass sums
  constexpr bool kQOnce = D <= 64;  // Q split once (registers allow it)
  extern __shared__ __align__(16) float kvf[];   // K [BK][KP], V [BK][VP]
  float* ks = kvf;
  float* vs = kvf + BK * KP;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * bq;
  const float* kb_ = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  int kb0, kb1;
  tile_range(q0, bq, Sk, BK, causal, window, kb0, kb1);

  auto load = [&](float* dst, int pitch, const float* src, long long rs,
                  int kb) {
    const long long k0 = (long long)kb * BK;
    for (int e = tid; e < BK * D / 4; e += nthreads) {
      const int r = e / (D / 4), ch = e % (D / 4);
      cp_async16(dst + r * pitch + 4 * ch, src + (k0 + r) * rs + 4 * ch);
    }
    cp_async_commit();
  };
  load(ks, KP, kb_, sk.r, kb0);
  load(vs, VP, vb, sv.r, kb0);

  // this warp's 16 query rows: g and g + 8 of them; lane (g, c) keeps dims
  // 16u + 4c .. 16u + 4c + 3 of both (tf32 hi and lo when kQOnce)
  const int qr = q0 + warp * 16 + g;
  float qf[D / 16][2][4];
  float ql[kQOnce ? D / 16 : 1][2][4];
  {
    const float* qp = q + b * sq.b + h * sq.h + (long long)qr * sq.r + 4 * c;
#pragma unroll
    for (int u = 0; u < D / 16; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = qp[r * 8 * sq.r + 16 * u + i];
          if constexpr (kQOnce) {
            uint32_t hi, lo;
            split_tf32(x, hi, lo);
            qf[u][r][i] = __uint_as_float(hi);
            ql[u][r][i] = __uint_as_float(lo);
          } else {
            qf[u][r][i] = x;
          }
        }
  }
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb0; kb <= kb1; ++kb) {
    const int k0 = kb * BK;
    cp_async_wait<1>();   // K of this tile (its V may be in flight)
    __syncthreads();

    // S = Q . K^T, one fresh f32 tile over the D dims
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      uint32_t qh[2][4], qlo[2][4];   // [step][a0..a3]
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a0 (g, dim 2st), a1 (g+8, 2st), a2 (g, 2st+1), a3 (g+8, 2st+1)
          const int r = i % 2, d = 2 * st + i / 2;
          if constexpr (kQOnce) {
            qh[st][i] = __float_as_uint(qf[u][r][d]);
            qlo[st][i] = __float_as_uint(ql[u][r][d]);
          } else {
            split_tf32(qf[u][r][d], qh[st][i], qlo[st][i]);
          }
        }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (8 * j + g) * KP + 16 * u + 4 * c);
        uint32_t kh[4], kl[4];
        split_tf32(kv.x, kh[0], kl[0]);
        split_tf32(kv.y, kh[1], kl[1]);
        split_tf32(kv.z, kh[2], kl[2]);
        split_tf32(kv.w, kh[3], kl[3]);
        mma_3xtf32(s[j], qh[0], qlo[0], kh[0], kh[1], kl[0], kl[1]);
        mma_3xtf32(s[j], qh[1], qlo[1], kh[2], kh[3], kl[2], kl[3]);
      }
    }
    __syncthreads();   // every warp is done with K: refill it
    if (kb < kb1) load(ks, KP, kb_, sk.r, kb + 1);
    else cp_async_commit();

    // scale, mask, row max over the tile (rows g: e = 0, 1; g + 8: e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qr + 8 * (e / 2), ki = k0 + 8 * j + 2 * c + (e % 2);
        bool ok = true;
        if (causal) ok = ok && qi >= ki;
        if (window > 0) ok = ok && qi - ki < window;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // the difference first: two masked -1e30s must give exactly 0
      alpha[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2((s[j][e] - m[e / 2]) * kLog2e);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }

    cp_async_wait<1>();   // V of this tile (the next K may be in flight)
    __syncthreads();
    // O = alpha O + P . V: each group of JG output tiles sums the tile's
    // keys into a fresh f32 tile, added to O with round-to-nearest FMAs
#pragma unroll
    for (int jg = 0; jg < NO; jg += JG) {
      float part[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll
      for (int tt = 0; tt < NS; ++tt) {
        // a0 (g, key 2c), a1 (g+8, 2c), a2 (g, 2c+1), a3 (g+8, 2c+1)
        uint32_t ph[4], pl[4];
        split_tf32(s[tt][0], ph[0], pl[0]);
        split_tf32(s[tt][2], ph[1], pl[1]);
        split_tf32(s[tt][1], ph[2], pl[2]);
        split_tf32(s[tt][3], ph[3], pl[3]);
        const float* vp = vs + (8 * tt + 2 * c) * VP + 8 * jg + g;
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(vp[8 * jj], vh0, vl0);
          split_tf32(vp[VP + 8 * jj], vh1, vl1);
          mma_3xtf32(part[jj], ph, pl, vh0, vh1, vl0, vl1);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[jg + jj][e] = fmaf(alpha[e / 2], o[jg + jj][e], part[jj][e]);
    }
    __syncthreads();   // every warp is done with V: refill it
    if (kb < kb1) load(vs, VP, vb, sv.r, kb + 1);
    else cp_async_commit();
  }
  cp_async_wait<0>();

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  float* op = out + b * so.b + h * so.h + (long long)qr * so.r + 2 * c;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    op[8 * j] = o[j][0] * inv[0];
    op[8 * j + 1] = o[j][1] * inv[0];
    op[8 * so.r + 8 * j] = o[j][2] * inv[1];
    op[8 * so.r + 8 * j + 1] = o[j][3] * inv[1];
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  int H, S, Sk, bq, bk, causal, window;
  float scale;
  Strides sq, sk, sv, so;
};

template <int D, int BK>
int launch_f32(const Args& a, int BH, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<D, BK>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_mma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.S / a.bq, BH);
  flash_f32_mma<D, BK><<<grid, a.bq * 2, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.H, a.S,
      a.Sk, a.bq, a.causal, a.window, a.scale, a.sq, a.sk, a.sv, a.so);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_bf16(const Args& a, int BH, cudaStream_t st) {
  constexpr size_t smem = bf16_smem_bytes<D, BK>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_mma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.S / a.bq, BH);
  flash_bf16_mma<D, BK><<<grid, a.bq * 2, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.H, a.S,
      a.Sk, a.bq, a.causal, a.window, a.scale, a.sq, a.sk, a.sv, a.so);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_d(const Args& a, int BH, int dtype, cudaStream_t st) {
#define BK_CASE(BK_)                                          \
  if (a.bk == BK_)                                            \
    return dtype == 0 ? launch_f32<D, BK_>(a, BH, st)         \
                      : launch_bf16<D, BK_>(a, BH, st);
  BK_CASE(32) BK_CASE(64) BK_CASE(128)
#undef BK_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dim outside (32, 64, 128) or a tile
// outside (32, 64, 128).  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out
// share it).  Batch b, head h, row r of q lives at q + b*s[0] + h*s[1] +
// r*s[2] (elements), of k at s[3..5], of v at s[6..8], of out at s[9..11];
// blocks cover B*H (b, h) pairs.  bq divides S and bk divides Sk.  k and v
// (and in bf16 q) are 16-byte aligned with strides of a multiple of 16
// bytes.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int S, int Sk, int D,
                           int bq, int bk, int causal, int window, int dtype,
                           float scale, const long long* s, void* stream) {
  const Args a{q, k, v, out, H, S, Sk, bq, bk, causal, window, scale,
               {s[0], s[1], s[2]}, {s[3], s[4], s[5]},
               {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
  if (bq != 32 && bq != 64 && bq != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32) return dispatch_d<32>(a, B * H, dtype, st);
  if (D == 64) return dispatch_d<64>(a, B * H, dtype, st);
  if (D == 128) return dispatch_d<128>(a, B * H, dtype, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
