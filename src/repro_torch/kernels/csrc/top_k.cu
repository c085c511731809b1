// Top-k for Hopper (sm_90a): the k best of each row of (B, V) logits →
// (B, k) f32 values and (B, k) int32 ids, in lax.top_k's order: larger
// values first, NaN above every number, and on equal values the lower index
// first.
//
// Replaces the Pallas kernel src/repro/kernels/sampling.py::top_k, which
// runs k greedy passes (k launches of the greedy_sample kernel) and masks
// each winner to -inf between them. Masking with -inf repeats an index
// once a row's numbers run out and cannot rank a NaN; this kernel follows
// lax.top_k instead (the plain version is a stable descending sort).
//
// Bound: bytes. Each logit is read once; at (4, 151,936) bf16 that is
// 1.22 MB, about 0.36 us at 3.35 TB/s; the output is a few hundred bytes.
//
// Design: a single pass, one block of 256 threads per row.
//   * Each thread walks its strided share of the row (neighbouring threads
//     on neighbouring elements, four loads in flight) and keeps its own k
//     best (value, index) pairs in registers, sorted. The list length K is
//     a template parameter, the smallest power of two >= k up to
//     kKMax = 64, so every index into it is known at compile time and the
//     list stays in registers. A new element is first compared with the
//     list's last entry; only if it wins is it carried down the list by
//     compare-and-swap.
//   * The block then takes k rounds: an argmax over the threads' heads
//     (warp shuffles, then the 8 warp winners through shared memory), the
//     winner written out, and the winning thread shifting its list by one.
//   * Pairs compare with greedy_sample.cu's combine, which is associative
//     and commutative: NaN ranks above every number (the lower index among
//     NaNs), otherwise the larger value wins and the lower index on equal
//     values. Slots not yet filled hold (-inf, INT_MAX), which loses to
//     every element, -inf included; k <= V keeps them from ever winning.
// One block per row uses B of the 132 SMs; splitting rows across blocks is
// the redesign, not the port.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kKMax = 64;  // keep equal to sampling.K_MAX

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

// Insert (v, i) into the sorted list (bv, bi) of length K, dropping its last.
template <int K>
__device__ __forceinline__ void insert(float v, int i, float (&bv)[K], int (&bi)[K]) {
  if (!beats(v, i, bv[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (beats(v, i, bv[s], bi[s])) {
      const float tv = bv[s];
      const int ti = bi[s];
      bv[s] = v;
      bi[s] = i;
      v = tv;
      i = ti;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
top_k_kernel(const T* __restrict__ logits, float* __restrict__ vals, int32_t* __restrict__ ids,
             int vocab, int k) {
  const T* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  float bv[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bv[s] = -INFINITY;
    bi[s] = INT_MAX;
  }

  int j = threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < vocab; j += kUnroll * kThreads) {
    float r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = to_f32(x[j + u * kThreads]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) insert<K>(r[u], j + u * kThreads, bv, bi);
  }
  for (; j < vocab; j += kThreads) insert<K>(to_f32(x[j]), j, bv, bi);

  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int round = 0; round < k; ++round) {
    float hv = bv[0];
    int hi = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, hv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, hi, off);
      take(ov, oi, hv, hi);
    }
    if (lane == 0) {
      wv[warp] = hv;
      wi[warp] = hi;
    }
    __syncthreads();
    hv = wv[0];
    hi = wi[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) take(wv[w], wi[w], hv, hi);
    __syncthreads();  // every thread has read this round's winners
    if (threadIdx.x == 0) {
      vals[static_cast<size_t>(blockIdx.x) * k + round] = hv;
      ids[static_cast<size_t>(blockIdx.x) * k + round] = hi;
    }
    if (bi[0] == hi) {  // indices are unique: exactly one thread won
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) {
        bv[s] = bv[s + 1];
        bi[s] = bi[s + 1];
      }
      bv[K - 1] = -INFINITY;
      bi[K - 1] = INT_MAX;
    }
  }
}

template <typename T>
int launch_t(const void* logits, void* vals, void* ids, int batch, int vocab, int k,
             cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  float* v = static_cast<float*>(vals);
  int32_t* i = static_cast<int32_t*>(ids);
  if (k <= 1) top_k_kernel<T, 1><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else if (k <= 2) top_k_kernel<T, 2><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else if (k <= 4) top_k_kernel<T, 4><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else if (k <= 8) top_k_kernel<T, 8><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else if (k <= 16) top_k_kernel<T, 16><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else if (k <= 32) top_k_kernel<T, 32><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  else top_k_kernel<T, kKMax><<<batch, kThreads, 0, s>>>(x, v, i, vocab, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller guarantees
// 0 < k <= min(vocab, 64) and batch > 0. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int top_k_launch(const void* logits, void* vals, void* ids, int batch, int vocab, int k,
                            int dtype, void* stream) {
  if (k < 1 || k > kKMax || k > vocab) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_t<float>(logits, vals, ids, batch, vocab, k, s);
    case 1:
      return launch_t<__nv_bfloat16>(logits, vals, ids, batch, vocab, k, s);
    case 2:
      return launch_t<__half>(logits, vals, ids, batch, vocab, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int top_k_max_k() { return kKMax; }
