// Paged multi-query decode attention for Hopper (sm_90a), split over pages.
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
// Softmax is online, in f32; the output is rounded to nearest in q's
// dtype.  Masked positions weigh 0 and the denominator is clamped at
// 1e-30, so a row with no visible position returns finite output (0; the
// engine masks such inactive slots at sampling).
//
// What bounds it.  Decode attention does ~2 operations per K/V byte read
// for each query row sharing a kv-head (R = S * G <= 18 at the repo's
// configs: internvl2-26b's G 6 at S 3), far under the card's ~295
// operations per byte, so the bound is the bytes of K/V of the positions
// each slot's last query sees.  Those
// bytes are spread very unevenly (one slot may hold 64 pages, the next
// none), and a decode call is short, so what holds a kernel back from the
// bound is latency: the walk of the longest slot, and the chain of
// dependent reads each block makes (length, page ids, K/V, merge).
//
// What the design does about that.
// - Split-KV.  The grid is (slot, kv-head, row chunk) x split, a unit's
//   splits neighbours in the grid.  A split is a run of `pps` pages of the
//   slot's block table; the split count and pps come from shapes alone
//   (kernels/paged_attention.py `plan`: about four rounds of loads a
//   block), so the wrapper never reads lengths or block tables on the host.
//   A block reads its slot's length and exits at once when its pages all
//   lie past what the slot's last query sees, so the longest serial walk is
//   pps pages, not the slot's whole table.
// - Bytes in flight.  A lane group of `lg` lanes holds one K/V row (16-byte
//   loads, `uint4`: 8 bf16 or 4 f32, neighbouring lanes on neighbouring
//   addresses, streaming: `__ldcs`, evicted first, as each row is read
//   once); each group starts the K and V loads of kUnroll positions
//   before it uses any of them, so a 128-thread block keeps 64 rows of K
//   and V (16 KB at HD 64 in bf16) outstanding.  Any HD that is a multiple
//   of 8 up to 256 fits: a row of HD / 8 (bf16) or HD / 4 (f32) vectors
//   takes the next power of two of lanes (at most 32) and NV vectors a
//   lane, the rest predicated off (HD 80 in bf16: 10 vectors on 16 lanes).
//   Block-table entries past the slot's visible pages are never read.
// - Arithmetic in registers.  Each lane holds its slice of the block's RC
//   query rows (pre-scaled by log2(e) / sqrt(HD)), their running max, sum
//   and accumulator.  The R dot products of a row are xor-shuffles inside
//   the group; no barrier runs inside the walk, a power-of-two page splits
//   a position by shift and mask, and exp2 is one MUFU instruction.  Groups
//   merge by shuffles across the warp, warps once through shared memory.
// - Combine in the same launch.  When a slot's visible pages span one
//   split, that block writes the output.  Otherwise each live split
//   writes (m, l, acc[HD]) in f32 to a workspace sized from shapes, fences,
//   and takes a ticket on its (slot, head, row chunk) counter; the block
//   drawing the last ticket reads every split's (m, l) in one round and
//   their accumulators as float4s spread over its threads, all through L2
//   (`__ldcg`), merges them and resets the counter to 0 for the next call.
//   A split whose l is 0 weighs nothing, so empty and fully masked splits
//   cannot pull a row toward -1e30.  One launch per call.
// - block_k (the TPU kernel's tile) is validated by the wrapper and does
//   not change the walk: the tile here is a round of kUnroll positions per
//   lane group, fixed by the load width.
//
// Measured (chip_smoke.py and paged_attention_study.py, NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md has the numbers): at the smoke's timed call the
// kernel runs at about a third of the bound's rate.  A variant with no K/V
// loads takes about two thirds of the kernel's time and one with no
// arithmetic nearly all of it, an empty call (every slot at length 0)
// about a fifth: the per-block chain and the grid, not the arithmetic, are
// what is left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // positions a lane group has in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);     // round to nearest even
}

// 2^x in one MUFU instruction (relative error ~2^-22); 2^-1e30 is 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of a K/V row -> f32
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Dynamic shared memory of one block: the warps' partials (RC rows of
// HD + 2 floats each), the merge's per-split m and l of each row and a
// float4 a thread, and the split's page ids.
inline size_t smem_bytes(int RC, int HD, int n_split, int pps) {
  return ((size_t)kWarps * RC * (HD + 2) + 2 * (size_t)n_split * RC +
          4 * (size_t)kThreads) * sizeof(float) + (size_t)pps * sizeof(int);
}

template <typename T, int NV, int RC>
__global__ void __launch_bounds__(kThreads)
paged_mq_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                const T* __restrict__ v_pages,
                const int* __restrict__ block_tables,
                const int* __restrict__ lengths, T* __restrict__ out,
                float* __restrict__ part, int* __restrict__ tickets, int S,
                int KVH, int G, int HD, int page_size, int max_pages,
                int n_split, int pps, int n_rchunk, int lg, float qscale) {
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int F = NV * VEC;          // elements of a row a lane holds
  extern __shared__ float4 smem4[];
  float4* stage = smem4;                              // [kThreads]
  // [kWarps][RC][HD]
  float* red_acc = reinterpret_cast<float*>(stage + kThreads);
  float* red_ml = red_acc + (size_t)kWarps * RC * HD; // [kWarps][RC][2]
  float* wm = red_ml + kWarps * RC * 2;               // [n_split][RC]
  float* wl = wm + (size_t)n_split * RC;              // [n_split][RC]
  int* pages = reinterpret_cast<int*>(wl + (size_t)n_split * RC);  // [pps]
  __shared__ int is_last;

  // a unit's splits are neighbours in the grid, so they run together and
  // its merge follows them closely
  const int n_units = gridDim.x / n_split;
  const int unit = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int rc = unit % n_rchunk;
  const int b = unit / n_rchunk / KVH;
  const int h = unit / n_rchunk % KVH;
  const int len = lengths[b];
  // positions the last query sees; pages beyond them are never read
  const int visible = len + S - 1;
  const int n_pages =
      visible > 0 ? min((visible + page_size - 1) / page_size, max_pages) : 0;
  const int n_live = max(1, (n_pages + pps - 1) / pps);
  if (split >= n_live) return;         // uniform across the block

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gi = tid / lg, j = tid % lg, ngroups = kThreads / lg;
  const int nvec = HD / VEC;
  const int R = S * G;
  const int pg0 = split * pps;
  const int pg1 = min(n_pages, pg0 + pps);
  const int t0 = pg0 * page_size;
  const int t1 = min(visible, pg1 * page_size);   // positions [t0, t1)

  for (int i = tid; i < pg1 - pg0; i += kThreads)
    pages[i] = block_tables[(size_t)b * max_pages + pg0 + i];

  // this lane's slice of the block's query rows r = rc * RC + i, and the
  // positions each row sees (t < lim)
  float qr[RC][F];
  int lim[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int r = rc * RC + i;
    lim[i] = r < R ? len + r / G : 0;
    const size_t row =
        ((((size_t)b * S + r / G) * KVH + h) * G + r % G) * HD;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = j + v * lg;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[i][v * VEC + e] =
            (r < R && vi < nvec) ? to_f32(q[row + vi * VEC + e]) * qscale
                                 : 0.f;
    }
  }
  float m[RC], l[RC], acc[RC][F];
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < F; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KVH * HD;   // token row to token row
  const size_t page_stride = (size_t)page_size * row_stride;
  const T* k_head = k_pages + (size_t)h * HD;
  const T* v_head = v_pages + (size_t)h * HD;
  // a power-of-two page (the engine's) splits a position by shift and mask
  const int ps_shift =
      (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  // the K and V rows of a round's kUnroll positions of this lane's group;
  // positions past the split load nothing
  auto load_round = [&](int base, uint4 (&kr)[kUnroll][NV],
                   uint4 (&vr)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * ngroups + gi;
      size_t off = 0;
      if (t < t1) {
        int pi, po;
        if (ps_shift >= 0) {
          pi = t >> ps_shift;
          po = t & (page_size - 1);
        } else {
          pi = t / page_size;
          po = t - pi * page_size;
        }
        off = (size_t)pages[pi - pg0] * page_stride + (size_t)po * row_stride;
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = j + v * lg;
        if (t < t1 && vi < nvec) {
          kr[u][v] = __ldcs(reinterpret_cast<const uint4*>(
              k_head + off + vi * VEC));
          vr[u][v] = __ldcs(reinterpret_cast<const uint4*>(
              v_head + off + vi * VEC));
        } else {
          kr[u][v] = make_uint4(0, 0, 0, 0);
          vr[u][v] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  // fold one round into the running softmax state
  auto consume = [&](int base, const uint4 (&kr)[kUnroll][NV],
                     const uint4 (&vr)[kUnroll][NV]) {
    int tp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) tp[u] = base + u * ngroups + gi;
    // scores: each lane's partial dot product, summed across its group
    float sc[kUnroll][RC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[F];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        unpack(kr[u][v], kf + v * VEC, static_cast<const T*>(nullptr));
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < F; ++e) d = fmaf(qr[i][e], kf[e], d);
        for (int o = lg >> 1; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[u][i] = (tp[u] < t1 && tp[u] < lim[i]) ? d : kNegInf;
      }
    }
    // online softmax over the round (log2 domain); masked positions weigh 0
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][i]);
      const float alpha = fast_exp2(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = (tp[u] < t1 && tp[u] < lim[i])
                            ? fast_exp2(sc[u][i] - mx) : 0.f;
        sc[u][i] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < F; ++e) acc[i][e] *= alpha;
    }
    // acc += P V
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[F];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        unpack(vr[u][v], vf + v * VEC, static_cast<const T*>(nullptr));
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int e = 0; e < F; ++e)
          acc[i][e] = fmaf(sc[u][i], vf[e], acc[i][e]);
    }
  };
  // a round: every load of kUnroll positions goes out before any is used
  const int step = ngroups * kUnroll;
  for (int base = t0; base < t1; base += step) {
    uint4 kr[kUnroll][NV], vr[kUnroll][NV];
    load_round(base, kr, vr);
    consume(base, kr, vr);
  }

  // merge the groups of a warp: lanes at xor offsets >= lg hold the same
  // slice of another group's positions
  for (int o = lg; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mx = fmaxf(m[i], mo);
      const float a = fast_exp2(m[i] - mx), c = fast_exp2(mo - mx);
      m[i] = mx;
      l[i] = a * l[i] + c * lo;
#pragma unroll
      for (int e = 0; e < F; ++e)
        acc[i][e] = a * acc[i][e] +
                    c * __shfl_xor_sync(0xffffffffu, acc[i][e], o);
    }
  }
  // then the warps, once, through shared memory
  if (lane < lg) {
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      float* dst = red_acc + ((size_t)warp * RC + i) * HD;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = j + v * lg;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[vi * VEC + e] = acc[i][v * VEC + e];
        }
      }
      if (lane == 0) {
        red_ml[(warp * RC + i) * 2] = m[i];
        red_ml[(warp * RC + i) * 2 + 1] = l[i];
      }
    }
  }
  __syncthreads();

  // the workspace: every unit's per-split accumulators [split][RC][HD],
  // then their (m, l) [split][RC][2]
  float* part_acc = part + (size_t)unit * n_split * RC * HD;
  float* part_ml = part + (size_t)n_units * n_split * RC * HD +
                   (size_t)unit * n_split * RC * 2;
  for (int idx = tid; idx < RC * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    const int r = rc * RC + i;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_ml[(w * RC + i) * 2]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = fast_exp2(red_ml[(w * RC + i) * 2] - M);
      L += a * red_ml[(w * RC + i) * 2 + 1];
      A += a * red_acc[((size_t)w * RC + i) * HD + d];
    }
    if (n_live == 1) {
      if (r < R)
        store(A / fmaxf(L, 1e-30f),
              out + ((((size_t)b * S + r / G) * KVH + h) * G + r % G) * HD +
                  d);
    } else {
      part_acc[((size_t)split * RC + i) * HD + d] = A;
      if (d == 0) {
        part_ml[(split * RC + i) * 2] = M;
        part_ml[(split * RC + i) * 2 + 1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last live split of this unit to finish merges every live split
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(tickets + unit, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) tickets[unit] = 0;     // ready for the next call
  // every split's (m, l) in one round of loads, through L2
  for (int k = tid; k < n_live * RC; k += kThreads) {
    wm[k] = __ldcg(part_ml + 2 * k);
    wl[k] = __ldcg(part_ml + 2 * k + 1);
  }
  __syncthreads();
  // each split's weight per row; a split that saw nothing weighs 0
  if (tid < RC) {
    float M = kNegInf;
    for (int sp = 0; sp < n_live; ++sp)
      if (wl[sp * RC + tid] > 0.f) M = fmaxf(M, wm[sp * RC + tid]);
    float L = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float ls = wl[sp * RC + tid];
      const float w = ls > 0.f ? fast_exp2(wm[sp * RC + tid] - M) : 0.f;
      wm[sp * RC + tid] = w;
      L += w * ls;
    }
    red_ml[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // the accumulators as float4 chunks of the RC x HD rows: a chunk's
  // threads take every tpc-th split, then add up through shared memory
  const int nchunk = RC * HD / 4;
  const int tpc = max(1, kThreads / nchunk);
  for (int c0 = 0; c0 < nchunk; c0 += kThreads) {
    const int c = c0 + (nchunk <= kThreads ? tid % nchunk : tid);
    const int so = nchunk <= kThreads ? tid / nchunk : 0;
    const int i = c * 4 / HD;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nchunk && so < tpc) {
      const float4* src = reinterpret_cast<const float4*>(part_acc) + c;
#pragma unroll 4
      for (int sp = so; sp < n_live; sp += tpc) {
        const float w = wm[sp * RC + i];
        const float4 v = __ldcg(src + (size_t)sp * nchunk);
        a.x += w * v.x;
        a.y += w * v.y;
        a.z += w * v.z;
        a.w += w * v.w;
      }
    }
    stage[tid] = a;
    __syncthreads();
    const int r = rc * RC + i;
    if (c < nchunk && so == 0 && r < R) {
      for (int k = 1; k < tpc; ++k) {
        const float4 o = stage[tid + k * nchunk];
        a.x += o.x;
        a.y += o.y;
        a.z += o.z;
        a.w += o.w;
      }
      const float L = red_ml[i];
      T* dst = out + ((((size_t)b * S + r / G) * KVH + h) * G + r % G) * HD +
               c * 4 % HD;
      store(a.x / L, dst);
      store(a.y / L, dst + 1);
      store(a.z / L, dst + 2);
      store(a.w / L, dst + 3);
    }
    __syncthreads();
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *block_tables, *lengths;
  void *out, *part, *tickets;
  int B, S, KVH, G, HD, page_size, max_pages, n_split, pps, n_rchunk, lg;
  float qscale;
  cudaStream_t stream;
};

template <typename T, int NV, int RC>
int launch(const Args& a) {
  const size_t smem = smem_bytes(RC, a.HD, a.n_split, a.pps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mq_kernel<T, NV, RC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.B * a.KVH * a.n_rchunk * a.n_split);
  paged_mq_kernel<T, NV, RC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out),
      static_cast<float*>(a.part), static_cast<int*>(a.tickets), a.S, a.KVH,
      a.G, a.HD, a.page_size, a.max_pages, a.n_split, a.pps, a.n_rchunk,
      a.lg, a.qscale);
  return (int)cudaGetLastError();
}

// the instantiated (vectors a lane, rows a block): at most 32 floats of
// accumulator a lane (F * RC <= 32), so q and acc stay in registers
template <typename T>
int dispatch(const Args& a, int nv, int rows) {
  if (nv == 1 && rows == 1) return launch<T, 1, 1>(a);
  if (nv == 1 && rows == 2) return launch<T, 1, 2>(a);
  if (nv == 1 && rows == 3) return launch<T, 1, 3>(a);
  if (nv == 1 && rows == 4) return launch<T, 1, 4>(a);
  if constexpr (sizeof(T) == 4) {
    if (nv == 1 && rows == 8) return launch<T, 1, 8>(a);
    if (nv == 2 && rows == 1) return launch<T, 2, 1>(a);
    if (nv == 2 && rows == 2) return launch<T, 2, 2>(a);
    if (nv == 2 && rows == 3) return launch<T, 2, 3>(a);
    if (nv == 2 && rows == 4) return launch<T, 2, 4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).  The plan
// (n_split, pages_per_split, row_chunks, lanes, vecs, rows) comes from the
// wrapper; `part` holds B * KVH * row_chunks * n_split * rows * (HD + 2)
// floats (unused when n_split == 1; 16-byte aligned) and `tickets`
// B * KVH * row_chunks ints, zero before the first call and left zero by
// every call.
int paged_attention_mq_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* block_tables,
                              const void* lengths, void* out, void* part,
                              void* tickets, int B, int S, int KVH, int G,
                              int HD, int page_size, int max_pages,
                              int n_split, int pages_per_split, int row_chunks,
                              int lanes, int vecs, int rows, int dtype,
                              float qscale, void* stream) {
  const Args a{q, k_pages, v_pages, block_tables, lengths, out, part,
               tickets, B, S, KVH, G, HD, page_size, max_pages, n_split,
               pages_per_split, row_chunks, lanes, qscale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, vecs, rows);
  return dispatch<float>(a, vecs, rows);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
