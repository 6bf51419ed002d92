// Tiled matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `tuned_matmul` (body `_matmul_kernel`) of
// src/repro/kernels/tuned_matmul.py.
//
// What it computes.  x (M, K) @ y (K, N) -> out (M, N) in x's dtype
// (float32 or bfloat16), summed in an f32 accumulator and written once, as
// the TPU kernel's `_flush` does.  The caller's tiles (bm, bn, bk) must
// divide (M, N, K); the wrapper clamps them to the dims first and refuses a
// tile outside the instantiated menu (see kMenu below).
//
// What bounds it.  At the main path's shape (2048 x 2048 @ 2048 x 5632) the
// product does ~2 * 2048 flops per element it reads, far above the card's
// ratio of flops to bytes: it is bound by operations.  In bf16 the bound is
// the tensor cores' rate; this kernel multiplies with scalar f32 FMAs on
// the CUDA cores, so it stays far from that bound (f32 runs at most at the
// CUDA cores' 67 TFLOP/s).
//
// What the design does about that.  One block of 256 threads per (bm, bn)
// output tile walks K in bk steps.  Each step stages the x tile (bm x bk,
// stored transposed, rows padded by one float so the transposing stores hit
// distinct banks) and the y tile (bk x bn) in shared memory as f32, then
// every thread accumulates a (bm/16) x (bn/16) register tile whose rows and
// columns are strided by 16, so a warp's shared-memory reads are broadcasts
// or distinct banks.  Each input element is read from device memory once
// per tile that needs it; the output is written once.  The TPU's grid
// carried the accumulator in VMEM across the K axis; here the K walk is a
// loop inside the block and the accumulator lives in registers.  wgmma,
// TMA and a pipelined ring of tiles are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;       // a 16 x 16 grid of threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

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

template <typename T>
int dispatch(const void* x, const void* y, void* out, int M, int N, int K,
             int bm, int bn, int bk, cudaStream_t st) {
  // kMenu: the (bm, bn, bk) tiles instantiated here; keep in step with
  // MENU in kernels/tuned_matmul.py
  if (bm == 32 && bn == 128 && bk == 128)
    return launch<T, 32, 128, 128>(x, y, out, M, N, K, st);
  if (bm == 64 && bn == 64 && bk == 64)
    return launch<T, 64, 64, 64>(x, y, out, M, N, K, st);
  if (bm == 128 && bn == 128 && bk == 64)
    return launch<T, 128, 128, 64>(x, y, out, M, N, K, st);
  if (bm == 128 && bn == 128 && bk == 128)
    return launch<T, 128, 128, 128>(x, y, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a tile outside the menu.  dtype: 0 = float32,
// 1 = bfloat16 (x, y and out share it).  The tiles must divide the dims.
int tuned_matmul_launch(const void* x, const void* y, void* out, int M, int N,
                        int K, int bm, int bn, int bk, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, out, M, N, K, bm, bn, bk, st);
  return dispatch<float>(x, y, out, M, N, K, bm, bn, bk, st);
}

const char* tuned_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
