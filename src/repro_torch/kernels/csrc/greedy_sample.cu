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
// 3.35 TB/s. At so few bytes the time is the launch, one load latency and
// how many SMs stream at once. What the design does about it:
//   * each row is split across a thread-block cluster of `cluster` blocks
//     (kernels/sampling.py::plan_greedy_sample: 1, 2, 4, 8 or 16, about one
//     block per SM over the grid, chunks of at least 8,192 elements and a
//     multiple of 8), so at B = 4 64 SMs stream the logits, not 4. A
//     cluster of 16 is past the portable 8: the launch opts in with
//     cudaFuncAttributeNonPortableClusterSizeAllowed, and the plan takes
//     16 only for as many rows as the card holds such clusters at once
//     (greedy_sample_max_active_clusters);
//   * it reads the logits in their own type, in place: no f32 copy and no
//     -inf padding as the JAX wrapper makes; the ragged ends of each chunk
//     are taken one by one, so any row address works, and values are
//     compared in f32 (exact for bf16 and fp16);
//   * 16-byte vector loads, neighbouring threads on neighbouring addresses,
//     four vectors in flight per thread, all issued before any is compared;
//   * each 16-byte vector is reduced to its own winner without branches
//     (its first NaN, else its maximum at the lowest index), and only that
//     is combined with the thread's running pair;
//   * each block reduces its chunk to one (value, index) pair (warp
//     shuffles, then across the block's warps in shared memory) and stores
//     it into rank 0's shared memory through distributed shared memory;
//     one cluster.sync() later rank 0 combines the pairs in its own shared
//     memory and writes the id, so no block waits for another to finish
//     reading. The barrier's first phase (every block has started, which a
//     remote store needs) is arrived at on entry and waited for only
//     before the store, so it overlaps the loads. No global scratch, no
//     counter, no fill kernel: one launch, which a CUDA graph captures as
//     it is.
// A cluster the card cannot place makes the launch fail and the wrapper
// raise; there is no one-block-per-row fallback.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kPortableCluster = 8;  // larger clusters need the non-portable opt-in
constexpr int kMaxCluster = 16;

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

// A vector of kN values, in index order, becomes one candidate: its first
// NaN if it holds one, else its maximum at the lowest index that holds it.
// That is the vector's own winner under beats(), found without branches,
// and then combined once with (bv, bi).
template <typename T>
__device__ __forceinline__ void take_vec(const uint4& r, int base, float& bv, int& bi) {
  constexpr int kN = 4 * Word<T>::kPer;
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  float x[kN];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < Word<T>::kPer; ++k) x[q * Word<T>::kPer + k] = Word<T>::at(w[q], k);
  }
  float top = x[0];
  bool nan = isnan(x[0]);
#pragma unroll
  for (int k = 1; k < kN; ++k) {
    top = fmaxf(top, x[k]);  // fmaxf skips NaN
    nan |= isnan(x[k]);
  }
  int at = kN - 1;
#pragma unroll
  for (int k = kN - 1; k >= 0; --k) {
    if (nan ? isnan(x[k]) : x[k] == top) at = k;
  }
  take(nan ? __int_as_float(0x7fffffff) : top, base + at, bv, bi);
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
}

// grid.x = B * cluster, cluster dims (cluster, 1, 1): cluster b is row b,
// and its block of rank r reduces elements [r * chunk, min(V, (r + 1) * chunk)).
// kCluster = false is the instance for one block a row, with no cluster
// instruction in it, launched plainly.
template <typename T, bool kCluster>
__global__ void __launch_bounds__(kThreads)
greedy_sample_kernel(const T* __restrict__ logits, int32_t* __restrict__ out, int vocab,
                     int chunk) {
  constexpr int kVec = 16 / sizeof(T);
  int ranks = 1, rank = 0;
  if constexpr (kCluster) {
    ranks = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
    // Phase 1 of the cluster barrier, waited for only before the first
    // remote store: every block of the cluster has started by then.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int row = blockIdx.x / ranks;
  const int start = min(vocab, rank * chunk);
  const int n = min(vocab, start + chunk) - start;
  const T* x = logits + static_cast<size_t>(row) * vocab + start;
  float bv = -INFINITY;
  int bi = INT_MAX;  // loses to every element, -inf included

  // A chunk starts 16-byte aligned only when the row does: take the
  // elements before the first boundary and after the last whole vector one
  // by one.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const int nvec = (n - head) / kVec;
  const int tail = head + nvec * kVec;
  for (int j = threadIdx.x; j < head; j += kThreads) take(to_f32(x[j]), start + j, bv, bi);
  for (int j = tail + threadIdx.x; j < n; j += kThreads) take(to_f32(x[j]), start + j, bv, bi);

  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int j = threadIdx.x; j < nvec; j += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < nvec) r[u] = __ldg(xv + j + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < nvec) take_vec<T>(r[u], start + head + (j + u * kThreads) * kVec, bv, bi);
    }
  }

  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ float peer_v[kMaxCluster];  // rank 0's: each block's pair, stored by that block
  __shared__ int peer_i[kMaxCluster];
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
  }
  if constexpr (!kCluster) {
    if (threadIdx.x == 0) out[row] = bi;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all blocks have started
    if (threadIdx.x == 0) {  // this block's pair into rank 0's shared memory
      *cluster.map_shared_rank(&peer_v[rank], 0) = bv;
      *cluster.map_shared_rank(&peer_i[rank], 0) = bi;
    }
    cluster.sync();  // release the stores, acquire them in rank 0
    if (rank == 0 && warp == 0) {  // rank 0 reads only its own shared memory: peers may leave
      bv = lane < ranks ? peer_v[lane] : -INFINITY;
      bi = lane < ranks ? peer_i[lane] : INT_MAX;
      warp_reduce(bv, bi);
      if (lane == 0) out[row] = bi;
    }
  }
}

template <typename T>
int launch(const void* logits, void* out, int batch, int vocab, int cluster, int chunk,
           cudaStream_t stream) {
  if (cluster > kPortableCluster) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_sample_kernel<T, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block a row: a plain launch, no cluster to place
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster > 1 ? greedy_sample_kernel<T, true>
                                                              : greedy_sample_kernel<T, false>,
                                             static_cast<const T*>(logits),
                                             static_cast<int32_t*>(out), vocab, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_active(int cluster, int* count) {
  if (cluster > kPortableCluster) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_sample_kernel<T, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, greedy_sample_kernel<T, true>, &cfg));
}

bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == kMaxCluster;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. cluster: blocks per row,
// 1, 2, 4, 8 or 16; chunk: elements per block, a multiple of 8 with
// (cluster - 1) * chunk < vocab <= cluster * chunk. Launches on `stream`
// without synchronising and returns the launch's CUDA error (0 on success).
extern "C" int greedy_sample_launch(const void* logits, void* out, int batch, int vocab,
                                    int dtype, int cluster, int chunk, void* stream) {
  if (!valid_cluster(cluster) || chunk <= 0 || chunk % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(logits, out, batch, vocab, cluster, chunk, s);
    case 1: return launch<__nv_bfloat16>(logits, out, batch, vocab, cluster, chunk, s);
    case 2: return launch<__half>(logits, out, batch, vocab, cluster, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of `cluster` blocks of the kernel for `dtype` the
// current device can hold at once (cudaOccupancyMaxActiveClusters), in
// *count; 0 means such a cluster cannot be placed. Returns a CUDA error.
extern "C" int greedy_sample_max_active_clusters(int cluster, int dtype, int* count) {
  if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return max_active<float>(cluster, count);
    case 1: return max_active<__nv_bfloat16>(cluster, count);
    case 2: return max_active<__half>(cluster, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
