// Greedy sampling for Hopper (sm_90a): argmax over the vocabulary of (B, V)
// logits -> (B,) int32 ids. This is the serving decode step's fused epilogue.
//
// Replaces the Pallas kernel src/repro/kernels/sampling.py::greedy_sample
// (body _greedy_kernel). On the TPU the grid walks vocab tiles in order and
// carries a running (max, index) in VMEM scratch. Hopper runs blocks in
// parallel and in no order, so this kernel is written for what that kernel
// computes, not tile by tile. It reduces (value, index) pairs with a combine
// that is associative and commutative, so any visiting order gives the
// same answer:
//   * NaN ranks above every number; among NaNs the lowest index wins;
//   * otherwise the larger value wins, and on equal values the lower index.
// That is jnp.argmax's and torch.argmax's contract (the serving engine's
// default reference), including the first NaN. The Pallas kernel returns a
// number's index on a row with a NaN; this kernel follows jnp.argmax.
//
// Bound: bytes. Each logit is read once and compared once, so the work is
// B*V*sizeof(T) bytes against a few operations per byte; at the decode
// shape (B = 4, V = 151,936, bf16) that is 1.22 MB, about 0.36 us at
// 3.35 TB/s. What the design does about it:
//   * it reads the logits in their own type, in place: no f32 copy and no
//     -inf padding as the JAX wrapper makes; the ragged ends are masked by
//     bounds, and values are compared in f32 (exact for bf16 and fp16);
//   * 16-byte vector loads, neighbouring threads on neighbouring addresses,
//     with four vectors in flight per thread;
//   * one block of 1024 threads per row, a warp-shuffle reduction and then
//     one across the block's warps in shared memory.
// One block per row uses only B of the 132 SMs, so at B = 4 a single SM
// streams each 300 KB row: splitting each row across blocks is the next
// step for speed.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

// Does (av, ai) win over (bv, bi)?
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (beats(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// The values packed in one 32-bit word of a 16-byte vector (little endian:
// the lower address sits in the low half).
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int kPer = 1;
  __device__ static float at(uint32_t w, int) { return __uint_as_float(w); }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  __device__ static float at(uint32_t w, int k) {
    return __uint_as_float(k == 0 ? (w << 16) : (w & 0xffff0000u));
  }
};
template <> struct Word<__half> {
  static constexpr int kPer = 2;
  __device__ static float at(uint32_t w, int k) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(k == 0 ? w : w >> 16)));
  }
};

template <typename T>
__device__ __forceinline__ void take_vec(const uint4& r, int base, float& bv, int& bi) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < Word<T>::kPer; ++k) {
      take(Word<T>::at(w[q], k), base + q * Word<T>::kPer + k, bv, bi);
    }
  }
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
greedy_sample_kernel(const T* __restrict__ logits, int32_t* __restrict__ out, int vocab) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  float bv = -INFINITY;
  int bi = INT_MAX;  // loses to every element, -inf included

  // Rows start 16-byte aligned only when V * sizeof(T) is a multiple of 16:
  // take the elements before the first boundary and after the last whole
  // vector one by one.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > vocab) head = vocab;
  const int nvec = (vocab - head) / kVec;
  const int tail = head + nvec * kVec;
  for (int j = threadIdx.x; j < head; j += kThreads) take(to_f32(x[j]), j, bv, bi);
  for (int j = tail + threadIdx.x; j < vocab; j += kThreads) take(to_f32(x[j]), j, bv, bi);

  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  int j = threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < nvec; j += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(xv + j + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) take_vec<T>(r[u], head + (j + u * kThreads) * kVec, bv, bi);
  }
  for (; j < nvec; j += kThreads) take_vec<T>(__ldg(xv + j), head + j * kVec, bv, bi);

  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(bv, bi);
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = wv[lane];  // kThreads / 32 == 32: one partial per lane
    bi = wi[lane];
    warp_reduce(bv, bi);
    if (lane == 0) out[blockIdx.x] = bi;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int greedy_sample_launch(const void* logits, void* out, int batch, int vocab,
                                    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0:
      greedy_sample_kernel<float><<<batch, kThreads, 0, s>>>(static_cast<const float*>(logits), o, vocab);
      break;
    case 1:
      greedy_sample_kernel<__nv_bfloat16>
          <<<batch, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(logits), o, vocab);
      break;
    case 2:
      greedy_sample_kernel<__half><<<batch, kThreads, 0, s>>>(static_cast<const __half*>(logits), o, vocab);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
