// Tiled matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `tuned_matmul` (body `_matmul_kernel`) of
// src/repro/kernels/tuned_matmul.py.
//
// What it computes.  x (M, K) @ y (K, N) -> out (M, N) in x's dtype
// (float32 or bfloat16), summed in an f32 accumulator and written once, as
// the TPU kernel's `_flush` does.  The caller's tiles (bm, bn, bk) must
// divide (M, N, K); the wrapper clamps them to the dims first and refuses a
// tile outside the instantiated menu (kMenu below): bm in {32, 64, 128},
// bn in {64, 128}, bk in {64, 128}, the same twelve tiles for both dtypes.
// One block computes exactly one (bm, bn) output tile, so the caller's tile
// keeps the meaning it has in the reference; the bf16 kernel walks K in bk
// steps, the f32 kernel in 16-deep stages (its sum runs along K in order,
// so bk changes nothing it computes).
//
// What bounds it.  At the main path's shape (2048 x 2048 @ 2048 x 5632) the
// product does ~2 * 2048 flops per element it reads, far above the card's
// ratio of flops to bytes: it is bound by operations, in bf16 by the tensor
// cores' rate.
//
// bf16: what the design does about that.  `matmul_bf16_wgmma` runs on the
// tensor cores with `wgmma.mma_async` (m64 x bn x k16, bf16 in, f32
// accumulators in registers).  A warp-specialised block: one producer
// warpgroup, whose one thread keeps TMA loads of the x and y tiles in flight
// into a ring of up to 4 stages (3 at 128 x 128 x 128: 64 KB a stage) with
// `mbarrier` completion, and one consumer warpgroup per 64 rows of the tile
// (two at bm = 128).  The producer gives registers back with `setmaxnreg`;
// the consumers keep the launch's allocation (64 accumulators and 64
// partial sums each at most).  Both tiles land with the 128-byte swizzle,
// in boxes 64 elements (128 bytes) wide: a bk of 128 is two boxes of x, a
// bn of 128 two boxes of y.  y (K, N) is row-major, i.e. N-major for
// wgmma's B operand: the descriptor says so through the transpose bit, so y
// is never transposed in a pass of its own.  The tensor cores' f32 sum of a
// long K walk drifts: their adds inside and between chained wgmmas do not
// round to nearest, and one accumulator chained over K = 2048 (128 k16
// steps) missed the bf16 bound against the exact product on some outputs,
// as the library's own bf16 product does (chip_smoke.py logs its count).
// So each k-tile's wgmmas start a fresh register tile, which is added to
// the running f32 sum with ordinary round-to-nearest adds once the group
// has completed; the stage is freed then too.  With two consumer
// warpgroups, one adds while the other's wgmmas run.  wgmma takes at least
// 64 rows: a bm = 32 tile runs the 64-row wgmma on a 64-row stage whose rows
// 32 to 63 are zeroed once and never loaded, and stores its own 32 rows only
// (the 64-row variant was chosen over an `mma.sync` path for bm = 32).  The
// epilogue rounds f32 to bf16 to nearest (`__float2bfloat16`) and stores
// once.  The TMA descriptors are encoded on the host per launch through the
// CUDA driver's `cuTensorMapEncodeTiled`, reached with
// `cudaGetDriverEntryPoint`, so the library links no libcuda of its own.
//
// f32: what the design does about that.  `matmul_f32_simt` runs on the
// CUDA cores (bound 2MNK at 67 TFLOP/s: 0.705 ms at the main path's shape).
// The tensor cores were tried first, as a 3xTF32 split (x = hi + lo, hi =
// tf32(x), lo = tf32(x - hi); lo.hi + hi.lo + hi.hi in `mma.sync.m16n8k8`,
// each fresh register tile added to the f32 sum every 8-128 of K): at
// 2048 x 2048 @ 2048 x 5632 it is within ref.KERNEL_TOL of the exact
// product on all but 0-7 of 11.5e6 outputs at spans of 16-32 (58-67 at 8,
// 92-99 at 64, ~1.3e4 at 128; one TF32 pass misses 98%), but the gate is
// the plain f32 product, torch.matmul, whose one f32 FMA chain along K is
// itself outside that tolerance of the exact product on ~1.85e4 outputs:
// against it the split misses on 2.2e4-5.9e4 outputs on every draw and span
// (`tf32_span.py` and `tf32_span.cu` measure it).  At K = 2048 two f32
// summation orders differ by more than 1e-5, so the kernel keeps the plain
// product's order: each output is one f32 FMA chain along K in order (it
// equals torch.matmul f32 to the bit at that shape).  What is left is the
// FMA rate.  A block of BN threads sums a 16 x 8 register tile a thread at
// bm = 128 (128 FMAs a k for 6 16-byte shared loads, fetched a k ahead).
// The x and y tiles of the next 16-deep K stage are loaded into registers
// by 16-byte loads while this one is summed, then stored into the other of
// two shared buffers, x's transposed so that a thread's rows of one k are
// contiguous (33 KB at 128 x 128: two blocks fit an SM, and 255 registers
// a thread allow two).  A 3-stage `cp.async` ring of x's tile as it lies
// in memory, 8 x 8 tiles of 256 threads, x transposed through 4-byte
// copies, deeper stages and a swizzled block order were slower on the card.

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores, a register-blocked tile
// ---------------------------------------------------------------------------

namespace simt {

constexpr int KS = 16;          // K depth of one stage

template <int BM>
__host__ __device__ constexpr int a_pitch() {
  return BM + 4;                // x^T row: 16-byte aligned
}
template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)2 * KS * (a_pitch<BM>() + BN) * sizeof(float);
}

// A block of BN threads, 8 rows of BN / 8: thread (ty, tx) sums rows 4 ty +
// r + 32 q (r < 4, q < BM / 32) at columns 4 tx + c and BN / 2 + 4 tx + c
// (c < 4) in registers; a warp covers WX threads of a row and 32 / WX rows.
// Each output is one f32 FMA chain along K in order, the plain product's
// (torch.matmul in f32 with TF32 off), so the two agree to the bit where
// the library takes that order.  Two shared buffers of a KS-deep stage:
// x's (BM, KS) tile transposed to (KS, BM) and y's (KS, BN) tile.  The next
// stage's tiles are loaded into registers by 16-byte loads while this one
// is summed, then stored (x's transposed, each lane its own row) into the
// other buffer: one barrier a stage.  A k's fragments (BM / 8 x values, 8
// y values) are 16-byte shared loads, fetched one k ahead.
template <int BM, int BN>
__global__ void __launch_bounds__(BN, 2)
matmul_f32_simt(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int N, int K) {
  constexpr int NT = BN, TM = BM / 8, TX = BN / 8, AP = a_pitch<BM>();
  constexpr int WX = TX < 16 ? TX : 16, WY = 32 / WX;
  constexpr int BUF = KS * (AP + BN);
  constexpr int NA = BM * KS / 4 / NT, NB = KS * BN / 4 / NT;  // float4s
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int ty = (w / (TX / WX)) * WY + l / WX;
  const int tx = (w % (TX / WX)) * WX + l % WX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = K / KS;

  // float4 e of x's tile: row e % BM, k 4 (e / BM); of y's: row e / (BN/4)
  float4 ra[NA], rb[NB];
  auto load = [&](int kt) {
    const int k0 = kt * KS;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int e = tid + NT * j;
      ra[j] = __ldg(reinterpret_cast<const float4*>(
          x + (size_t)(row0 + e % BM) * K + k0 + 4 * (e / BM)));
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int e = tid + NT * j;
      rb[j] = __ldg(reinterpret_cast<const float4*>(
          y + (size_t)(k0 + e / (BN / 4)) * N + col0 + 4 * (e % (BN / 4))));
    }
  };
  auto store = [&](int buf) {
    float* as = smem + buf * BUF;
    float* bs = as + KS * AP;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int e = tid + NT * j, r = e % BM, k = 4 * (e / BM);
      as[(k + 0) * AP + r] = ra[j].x;
      as[(k + 1) * AP + r] = ra[j].y;
      as[(k + 2) * AP + r] = ra[j].z;
      as[(k + 3) * AP + r] = ra[j].w;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int e = tid + NT * j;
      *reinterpret_cast<float4*>(bs + (e / (BN / 4)) * BN +
                                 4 * (e % (BN / 4))) = rb[j];
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1);
    const float* as = smem + (kt & 1) * BUF;
    const float* bs = as + KS * AP;
    float4 af[2][TM / 4], bf[2][2];
    auto fetch = [&](int k, int slot) {
#pragma unroll
      for (int q = 0; q < TM / 4; ++q)
        af[slot][q] =
            *reinterpret_cast<const float4*>(as + k * AP + 4 * ty + 32 * q);
#pragma unroll
      for (int g = 0; g < 2; ++g)
        bf[slot][g] = *reinterpret_cast<const float4*>(
            bs + k * BN + (BN / 2) * g + 4 * tx);
    };
    fetch(0, 0);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int cur = k & 1;
      if (k + 1 < KS) fetch(k + 1, cur ^ 1);
      float a[TM], b[8];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        a[4 * q] = af[cur][q].x;
        a[4 * q + 1] = af[cur][q].y;
        a[4 * q + 2] = af[cur][q].z;
        a[4 * q + 3] = af[cur][q].w;
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        b[4 * g] = bf[cur][g].x;
        b[4 * g + 1] = bf[cur][g].y;
        b[4 * g + 2] = bf[cur][g].z;
        b[4 * g + 3] = bf[cur][g].w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store((kt + 1) & 1);   // last read a stage ago
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(
          out + (size_t)(row0 + 4 * ty + i % 4 + 32 * (i / 4)) * N + col0 +
          (BN / 2) * g + 4 * tx) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
}

template <int BM, int BN>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  static_assert(smem <= 48 * 1024, "static shared-memory budget");
  const dim3 grid(N / BN, M / BM);
  matmul_f32_simt<BM, BN><<<grid, BN, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), N, K);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kStageBudget = 192 * 1024;   // bytes of the ring at most

template <int BM, int BN, int BK>
struct Cfg {
  static constexpr int NC = BM == 128 ? 2 : 1;   // consumer warpgroups
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int AR = BM < 64 ? 64 : BM;   // x rows a stage holds
  static constexpr int A_BOX = AR * 128;         // one 64-wide K box of x
  static constexpr int B_BOX = BK * 128;         // one 64-wide N box of y
  static constexpr int A_BYTES = (BK / 64) * A_BOX;
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_BOX;
  static constexpr int STAGES =
      kStageBudget / STAGE < 4 ? kStageBudget / STAGE : 4;
  static constexpr uint32_t TX = (BM * BK + BK * BN) * 2;  // bytes a stage
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + align
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that lasts ~10 s of clocks traps, so a fault in the ring ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// K-major (x): the stride offset steps 8 rows of 128 bytes, the leading one
// is unused.  N-major (y): the leading offset steps from one 64-wide N box
// to the next, the stride offset steps 8 K rows of 128 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = A (64 x 16, bf16, K-major) . B (16 x N, bf16, N-major)
// + (scale_d ? d : 0); the immediates: scale-a 1, scale-b 1, transpose-a 0,
// transpose-b 1.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Cfg<BM, BN, BK>::kThreads, 1)
matmul_bf16_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_y,
                  __nv_bfloat16* __restrict__ out, int N, int K) {
  using C = Cfg<BM, BN, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  const int tid = threadIdx.x, wg = tid / 128;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = K / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), C::NC * 4);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (BM < 64) {
    // rows BM..63 of each x box: read by the 64-row wgmma, never loaded
    uint8_t* p = smem_raw + (base - raw);
    for (int s = 0; s < C::STAGES; ++s)
      for (int a = 0; a < BK / 64; ++a) {
        uint4* z = reinterpret_cast<uint4*>(p + s * C::STAGE + a * C::A_BOX +
                                            BM * 128);
        for (int e = tid; e < (64 - BM) * 128 / 16; e += C::kThreads)
          z[e] = make_uint4(0, 0, 0, 0);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::NC) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == C::NC * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES)
          mbar_wait(smem_u32(&empty[s]), ((kt / C::STAGES) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, C::TX);
        const uint32_t st = base + s * C::STAGE;
#pragma unroll
        for (int a = 0; a < BK / 64; ++a)
          tma_load_2d(st + a * C::A_BOX, &tmap_x, bar, kt * BK + 64 * a, row0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(st + C::A_BYTES + b * C::B_BOX, &tmap_y, bar,
                      col0 + 64 * b, kt * BK);
      }
    }
  } else {
    // consumer warpgroup wg: rows wg*64 .. wg*64+63 of the tile.  Each
    // k-tile's wgmmas sum into `part` afresh, which is then added to `acc`
    // with round-to-nearest f32 adds.
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int lane = tid % 32;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(smem_u32(&full[s]), (kt / C::STAGES) & 1);
      const uint32_t st = base + s * C::STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(
            st + (kk / 4) * C::A_BOX + wg * 64 * 128 + (kk % 4) * 32, 16,
            1024);
        const uint64_t db =
            smem_desc(st + C::A_BYTES + kk * 16 * 128, C::B_BOX, 1024);
        if constexpr (BN == 128)
          wgmma_m64n128k16(part, da, db, kk > 0);
        else
          wgmma_m64n64k16(part, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(part);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    // accumulator layout of m64nN: register i of lane l in warp w holds row
    // w*16 + l/4 + 8*((i/2)%2), column 8*(i/4) + 2*(l%4) + i%2
    const int w = (tid % 128) / 32;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = wg * 64 + w * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      if (r < BM)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(row0 + r) * N + col0 + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// Errors of the bf16 path's host side, beside cudaError_t's codes.
constexpr int kErrNoEncoder = -1;   // the CUDA driver lacks the encoder
constexpr int kErrEncode = -2;      // cuTensorMapEncodeTiled refused the map

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) bf16 matrix as TMA boxes of (box_outer rows,
// 64 columns), 128-byte swizzle; reads past the matrix are zero-filled.
int encode(CUtensorMap* map, const void* ptr, int inner, int outer,
           int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int BM, int BN, int BK>
int launch_bf16(const void* x, const void* y, void* out, int M, int N, int K,
                cudaStream_t stream) {
  using C = Cfg<BM, BN, BK>;
  CUtensorMap tx, ty;
  int rc = encode(&tx, x, K, M, BM);
  if (rc != 0) return rc;
  rc = encode(&ty, y, N, K, BK);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_bf16_wgmma<BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, M / BM);
  matmul_bf16_wgmma<BM, BN, BK><<<grid, C::kThreads, C::SMEM, stream>>>(
      tx, ty, static_cast<__nv_bfloat16*>(out), N, K);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK>
int launch_tile(const void* x, const void* y, void* out, int M, int N, int K,
                int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_bf16<BM, BN, BK>(x, y, out, M, N, K, st);
  return simt::launch<BM, BN>(x, y, out, M, N, K, st);
}

int dispatch(const void* x, const void* y, void* out, int M, int N, int K,
             int bm, int bn, int bk, int dtype, cudaStream_t st) {
  // kMenu: bm in {32, 64, 128} x bn in {64, 128} x bk in {64, 128}; keep in
  // step with MENU in kernels/tuned_matmul.py
#define TILE(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_)                               \
    return launch_tile<BM_, BN_, BK_>(x, y, out, M, N, K, dtype, st);
#define TILES_BM(BM_) \
  TILE(BM_, 64, 64) TILE(BM_, 64, 128) TILE(BM_, 128, 64) TILE(BM_, 128, 128)
  TILES_BM(32) TILES_BM(64) TILES_BM(128)
#undef TILES_BM
#undef TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 when launched, a cudaError_t code,
// cudaErrorInvalidValue for a tile outside the menu, or a negative code of
// the bf16 path's TMA descriptors (tuned_matmul_error_string names it).
// dtype: 0 = float32, 1 = bfloat16 (x, y and out share it).  The tiles must
// divide the dims; x, y and out must be 16-byte aligned and K and N
// multiples of 16 bytes (both dtypes load by 16-byte copies).
int tuned_matmul_launch(const void* x, const void* y, void* out, int M, int N,
                        int K, int bm, int bn, int bk, int dtype,
                        void* stream) {
  return dispatch(x, y, out, M, N, K, bm, bn, bk, dtype,
                  static_cast<cudaStream_t>(stream));
}

const char* tuned_matmul_error_string(int code) {
  if (code == kErrNoEncoder)
    return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
