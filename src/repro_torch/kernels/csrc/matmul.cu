// Blocked GEMM for Hopper (sm_90a): C = (A - zp_a)·(B - zp_b), A (M, K) and
// B (K, N) row-major, summed in float32. Two C entry points share one
// templated kernel:
//   * matmul_launch: zp = 0, f32 or bf16 inputs, C in the inputs' type.
//     Replaces the Pallas kernel src/repro/kernels/matmul.py::matmul
//     (body _matmul_kernel).
//   * configured_matmul_launch: the zero points are the kernel's by-value
//     parameters, f32, bf16 or int8 inputs, C in f32. Replaces
//     src/repro/kernels/matmul.py::configured_matmul (body
//     _configured_matmul_kernel). On the TPU the zero points reach the
//     kernel by scalar prefetch into SMEM before the grid runs; OpenGeMM
//     writes them to CSRs. On Hopper the launch's parameter space plays that
//     part: the host writes the two words with the launch itself, every
//     block reads them from constant memory, and no device-memory read or
//     host synchronisation is needed to reconfigure one launch to the next.
//
// Bound: operations at the qwen2-0.5b MLP width. (512, 896)·(896, 4864) is
// 4.46 GFLOP: about 66.6 us at the 67 TFLOP/s the H100 SXM has in f32
// outside the tensor cores (this kernel's arithmetic), against 29.2 MB of
// f32 traffic, about 8.7 us at 3.35 TB/s. The calibration ladder's shapes
// (up to 384 x 256 x 384, 75 MFLOP) are a few blocks each and are bound by
// the launch, not by either.
//
// Design: the classic shared-memory SGEMM, kept simple and exact in f32.
//   * A 128 x 128 output tile per block of 256 threads; each thread keeps
//     an 8 x 8 block of float32 sums in registers, at rows ty + 16 i and
//     columns tx + 16 j, so the shared-memory reads of one warp are either
//     consecutive words or a broadcast, and the stores to C are coalesced.
//   * K advances 8 at a time: the block stages a 128 x 8 slice of A
//     (transposed, padded by 4 floats against bank conflicts) and an 8 x 128
//     slice of B in shared memory, converted to f32 and with the zero points
//     already subtracted, so the inner loop is 64 FFMAs per 16 shared loads.
//   * Ragged edges are masked: elements outside A or B are staged as 0,
//     which contributes nothing whatever the zero points, and only
//     in-range elements of C are written. Any M, N, K work.
//   * f32 inputs take f32 FMA, not TF32, so the kernel can be held to the
//     plain version tightly; integer-valued inputs (OpenGeMM's int8 case)
//     give exact sums while they stay below 2^24.
// Not yet used: tensor cores (wgmma) for bf16 and int8, TMA, and a
// pipelined ring of tiles. Those are the redesign, not the port.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // rows of C per block
constexpr int kBN = 128;  // columns of C per block
constexpr int kBK = 8;    // depth staged per step
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kTM = kBM / kTY;  // 8 rows per thread
constexpr int kTN = kBN / kTX;  // 8 columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, typename O, bool kZeroPoints>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ c, int m, int n,
            int k, float zp_a, float zp_b) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int row = idx / kBK, col = idx % kBK;
      const int gm = m0 + row, gk = k0 + col;
      float x = 0.f;
      if (gm < m && gk < k) {
        x = to_f32(a[static_cast<size_t>(gm) * k + gk]);
        if (kZeroPoints) x -= zp_a;
      }
      as[col][row] = x;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int row = idx / kBN, col = idx % kBN;
      const int gk = k0 + row, gn = n0 + col;
      float x = 0.f;
      if (gk < k && gn < n) {
        x = to_f32(b[static_cast<size_t>(gk) * n + gn]);
        if (kZeroPoints) x -= zp_b;
      }
      bs[row][col] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * kTY;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kTX;
      if (gn < n) put(c + static_cast<size_t>(gm) * n + gn, acc[i][j]);
    }
  }
}

template <typename T, typename O, bool kZeroPoints>
int launch(const void* a, const void* b, void* c, int m, int n, int k, float zp_a, float zp_b,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<T, O, kZeroPoints><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c), m, n, k, zp_a, zp_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; C has the inputs' type. Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success). The caller guarantees m, n > 0 and (m + 127) / 128 <= 65535.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                             int dtype, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float, float, false>(a, b, c, m, n, k, 0.f, 0.f, stream);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(a, b, c, m, n, k, 0.f, 0.f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8; C is float32. The zero points
// arrive by value, as the launch's parameters.
extern "C" int configured_matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                                        int zp_a, int zp_b, int dtype, void* stream) {
  const float za = static_cast<float>(zp_a), zb = static_cast<float>(zp_b);
  switch (dtype) {
    case 0:
      return launch<float, float, true>(a, b, c, m, n, k, za, zb, stream);
    case 1:
      return launch<__nv_bfloat16, float, true>(a, b, c, m, n, k, za, zb, stream);
    case 2:
      return launch<int8_t, float, true>(a, b, c, m, n, k, za, zb, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
