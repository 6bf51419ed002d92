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
// One block computes exactly one (bm, bn) output tile and walks K in bk
// steps, so the caller's tile keeps the meaning it has in the reference.
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
// f32: a single TF32 pass keeps about three decimal digits and cannot meet
// f32's 1e-5, so f32 keeps the CUDA-core kernel `tuned_matmul_kernel`: one
// block of 256 threads per (bm, bn) tile stages the x tile (transposed, rows
// padded by one float) and the y tile in shared memory as f32, and every
// thread accumulates a (bm/16) x (bn/16) register tile with scalar FMAs.

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // f32: a 16 x 16 grid of threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }

template <int BM, int BN, int BK>
constexpr size_t smem_bytes() {
  return (size_t)(BK * (BM + 1) + BK * BN) * sizeof(float);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
tuned_matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    T* __restrict__ out, int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tiles are multiples of 16");
  extern __shared__ float smem[];
  float* xs = smem;                       // [BK][BM + 1], x tile transposed
  float* ys = smem + BK * (BM + 1);       // [BK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      xs[c * (BM + 1) + r] = to_f32(x[(size_t)(row0 + r) * K + k0 + c]);
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      ys[r * BN + c] = to_f32(y[(size_t)(k0 + r) * N + col0 + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k * (BM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store(acc[i][j],
            out + (size_t)(row0 + ty + 16 * i) * N + col0 + tx + 16 * j);
}

template <typename T, int BM, int BN, int BK>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN, BK>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tuned_matmul_kernel<T, BM, BN, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(N / BN, M / BM);
  tuned_matmul_kernel<T, BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      M, N, K);
  return (int)cudaGetLastError();
}

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
  return launch<float, BM, BN, BK>(x, y, out, M, N, K, st);
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
// divide the dims; in bf16, x, y and out must be 16-byte aligned and K and N
// multiples of 8.
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
