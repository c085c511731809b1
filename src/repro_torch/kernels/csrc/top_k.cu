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
// One block per row would put 4 SMs of 132 to that read, so each row is
// split across many blocks and the blocks' candidates merged.
//
// Design: one launch, a grid of B x S blocks of 256 threads.
//   * Every element becomes one 64-bit key: above, its value mapped to an
//     unsigned integer of the same order (NaN highest, -0 and +0 as one
//     value); below, 0xFFFFFFFF - index. Keys are distinct, and key order is
//     lax.top_k's order, so one unsigned compare ranks two elements. Key 0
//     is below every element and marks an empty slot.
//   * Block (r, s) takes elements [s·chunk, min(V, (s+1)·chunk)) of row r.
//     S and chunk come from kernels/sampling.py::plan_top_k: about two
//     blocks per SM over the whole grid, S <= 256, chunks of at least
//     max(1024, 32·k) elements and a multiple of 8, so a row that starts
//     16-byte aligned has every chunk start aligned. For k > 8 chunks are
//     also cut to one piece of the radix select below (4,096 elements)
//     where S <= 256 allows. A short row, or a large B with k <= 8, gets
//     S = 1.
//   * Each thread reads its share of the chunk with 16-byte loads, four in
//     flight; the elements before the chunk's first 16-byte boundary and
//     after its last take scalar loads, so any V and any row address work.
//   * For k <= 8, each thread keeps its K best keys in registers, sorted, K
//     the smallest power of two >= k (a template parameter, so every index
//     into the list is known at compile time). A new key is
//     compared with the list's last entry, and with the warp's floor (the
//     largest of its lanes' last entries, refreshed by shuffles every 32
//     elements: a key below it has K better keys in one lane and cannot be
//     an answer), before it is carried down the list.
//   * The block merges its threads' lists in log2(256) = 8 levels, not k
//     rounds: two sorted lists of K give their top K as the elementwise
//     larger of one and the other reversed, a bitonic sequence that log2 K
//     compare-exchange stages sort. Five levels pair lanes by shuffles; the
//     8 warp lists then meet in shared memory and warp 0 takes three more.
//   * With S = 1 warp 0 writes the row's answer. Otherwise it writes the
//     block's k keys to the (B, S, k) candidate scratch the wrapper
//     allocates, fences them and counts the block on the row's arrival
//     counter (zeroed by the wrapper each call); the block that arrives last
//     loads the row's S lists, one sorted list per thread, and merges them
//     the same way. Each answer's value is read back from the logits at its
//     index, so it keeps its bits (a NaN's payload, the sign of a zero).
//   * For 8 < k <= kKMax = 64 the lists above cost too much (insertions of
//     K steps and merges of log2 K stages, for every element and level), so
//     a second kernel selects instead: a block turns 4,096
//     elements at a time into keys in shared memory, appends its running
//     top k, and keeps the k largest by an MSB-first radix select over
//     8-bit digits (a shared-memory histogram per pass, warp 0 finding the
//     digit of the k-th key). Its blocks' candidates, unordered, are merged
//     by the block that arrives last with the same select, and the answer
//     is sorted by rank.
//   * Split and merge keep global indices in the keys, so they give the
//     order of one pass over the row, ties and NaNs on both sides of a
//     chunk boundary included; k <= V keeps empty slots out of the answer.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using Key = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr int kKMax = 64;   // keep equal to sampling.K_MAX
constexpr int kRegisterKMax = 8;  // larger k take the radix-select kernel
constexpr int kPiece = 4096;      // keys the radix-select kernel selects from at a time
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "the radix select gives each thread one of 256 bins");

__device__ __forceinline__ Key key_of(float v, int i) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t order = isnan(v) ? 0xffffffffu
                         : v == 0.0f ? 0x80000000u
                         : (b & 0x80000000u) ? ~b
                                             : (b | 0x80000000u);
  return (static_cast<Key>(order) << 32) | (0xffffffffu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ int index_of(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }
__device__ __forceinline__ Key kmin(Key a, Key b) { return a > b ? b : a; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 16 bytes of logits, read as one load, taken apart into floats.
template <typename T>
constexpr int kPack = 16 / sizeof(T);

__device__ __forceinline__ void unpack(uint4 q, float (&f)[4], float) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(uint4 q, float (&f)[8], __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of the float it widens to
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(uint4 q, float (&f)[8], __half) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
  }
}

// Insert y into the descending list a, dropping its last entry.
template <int K>
__device__ __forceinline__ void insert(Key (&a)[K], Key y) {
  if (y <= a[K - 1]) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const Key hi = kmax(a[s], y);
    y = kmin(a[s], y);
    a[s] = hi;
  }
}

__device__ __forceinline__ Key warp_max(Key x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = kmax(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Every element of x[c0, c1) into this thread's list: scalar loads up to
// the first 16-byte boundary and after the last, 16-byte loads between.
template <typename T, int K>
__device__ __forceinline__ void scan(const T* __restrict__ x, int c0, int c1, Key (&a)[K]) {
  constexpr int kLen = kPack<T>;
  const int lane = threadIdx.x & 31;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x + c0);
  const int head = min(static_cast<int>((16 - addr % 16) % 16 / sizeof(T)), c1 - c0);
  if (static_cast<int>(threadIdx.x) < head)
    insert<K>(a, key_of(to_f32(x[c0 + threadIdx.x]), c0 + threadIdx.x));
  const int v0 = c0 + head;
  const int packs = (c1 - v0) / kLen;
  const uint4* xv = reinterpret_cast<const uint4*>(x + v0);
  Key floor = 0;  // the warp's floor: keys at or below it are in no answer
  int j = threadIdx.x;
  // whole iterations for the whole warp, so every lane takes the shuffles
  for (; j - lane + 31 + (kUnroll - 1) * kThreads < packs; j += kUnroll * kThreads) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = xv[j + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[kLen];
      unpack(q[u], f, T());
#pragma unroll
      for (int e = 0; e < kLen; ++e) {
        const Key y = key_of(f[e], v0 + (j + u * kThreads) * kLen + e);
        if (y > floor) insert<K>(a, y);
      }
    }
    floor = warp_max(a[K - 1]);
  }
  for (; j < packs; j += kThreads) {
    float f[kLen];
    unpack(xv[j], f, T());
#pragma unroll
    for (int e = 0; e < kLen; ++e) {
      const Key y = key_of(f[e], v0 + j * kLen + e);
      if (y > floor) insert<K>(a, y);
    }
  }
  const int t = v0 + packs * kLen + threadIdx.x;  // fewer than kLen elements after the last pack
  if (t < c1) insert<K>(a, key_of(to_f32(x[t]), t));
}

// a becomes the top K of a and lane (lane ^ off)'s list, sorted: the
// larger of a[i] and the partner's a[K-1-i] is a bitonic sequence holding
// the top K of both, and log2 K half-cleaner stages sort it.
template <int K>
__device__ __forceinline__ void merge_lanes(Key (&a)[K], int off) {
#pragma unroll
  for (int i = 0; i < (K + 1) / 2; ++i) {
    const int j = K - 1 - i;
    const Key pj = __shfl_xor_sync(kFull, a[j], off);
    const Key pi = __shfl_xor_sync(kFull, a[i], off);
    a[i] = kmax(a[i], pj);
    if (j != i) a[j] = kmax(a[j], pi);
  }
#pragma unroll
  for (int s = K / 2; s > 0; s /= 2)
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((i & s) == 0) {
        const Key hi = kmax(a[i], a[i + s]);
        a[i + s] = kmin(a[i], a[i + s]);
        a[i] = hi;
      }
}

// The block's top K of its threads' lists, sorted, into a in every lane
// of warp 0 (the other warps' a is left undefined).
template <int K>
__device__ __forceinline__ void block_top_k(Key (&a)[K]) {
  __shared__ Key lists[kWarps][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) merge_lanes<K>(a, off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < K; ++i) lists[warp][i] = a[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = lists[lane % kWarps][i];  // each 8 lanes merge all 8
#pragma unroll
    for (int off = 1; off < kWarps; off *= 2) merge_lanes<K>(a, off);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
top_k_kernel(const T* __restrict__ logits, float* __restrict__ vals, int32_t* __restrict__ ids,
             Key* __restrict__ parts, unsigned* __restrict__ arrived, int vocab, int k, int chunk) {
  const int row = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* x = logits + static_cast<size_t>(row) * vocab;
  Key a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = 0;
  scan<T, K>(x, split * chunk, min(vocab, (split + 1) * chunk), a);
  block_top_k<K>(a);

  const size_t row_parts = static_cast<size_t>(row) * splits * k;
  if (splits > 1) {
    __shared__ bool last;
    if (warp == 0) {
      Key* out = parts + row_parts + static_cast<size_t>(split) * k;
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (i < k && (i & 31) == lane) out[i] = a[i];
      __threadfence();  // this block's candidates reach the device before it counts itself
      __syncwarp();
      if (lane == 0) last = atomicAdd(&arrived[row], 1u) == static_cast<unsigned>(splits - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();  // every other block's candidates are visible from here on
#pragma unroll
    for (int i = 0; i < K; ++i)  // thread t takes block t's sorted list
      a[i] = static_cast<int>(threadIdx.x) < splits && i < k
                 ? __ldcg(parts + row_parts + static_cast<size_t>(threadIdx.x) * k + i)
                 : 0;
    block_top_k<K>(a);
  }
  if (warp == 0)
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < k && (i & 31) == lane) {
        const int index = index_of(a[i]);
        vals[static_cast<size_t>(row) * k + i] = to_f32(x[index]);
        ids[static_cast<size_t>(row) * k + i] = index;
      }
}

// ---------------------------------------------------- k > 8: radix select

struct RadixShared {
  Key keys[kPiece + kKMax];  // a piece of keys, then the running top k appended
  Key top[kKMax];            // the running top k, unordered
  unsigned hist[256];        // one pass's digit counts
  Key prefix, mask;          // the digits fixed so far, and their bits
  int left;                  // how many keys the prefix's candidates still owe
  int count;
  bool done;
};

// The largest min(k, n) of sh.keys[0, n) into sh.top, unordered; returns
// how many. All threads call it. An MSB-first radix select over 8-bit
// digits: each pass counts the candidates' digits, and warp 0 finds the
// digit whose bin holds the k-th largest; it stops once that bin holds
// exactly as many keys as are still owed. Keys are distinct, so at most 8
// passes fix the k-th key.
__device__ int select_top(RadixShared& sh, int n, int k) {
  if (n <= k) {
    for (int i = threadIdx.x; i < n; i += kThreads) sh.top[i] = sh.keys[i];
    __syncthreads();
    return n;
  }
  if (threadIdx.x == 0) {
    sh.prefix = sh.mask = 0;
    sh.left = k;
    sh.count = 0;
    sh.done = false;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    sh.hist[threadIdx.x] = 0;  // kThreads bins
    __syncthreads();
    const Key prefix = sh.prefix, mask = sh.mask;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const Key key = sh.keys[i];
      if ((key & mask) == prefix) atomicAdd(&sh.hist[(key >> shift) & 0xff], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l takes bins 8l .. 8l + 7
      const int lane = threadIdx.x;
      unsigned mine = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) mine += sh.hist[8 * lane + b];
      unsigned from_me = mine;  // keys in the bins of this lane and the lanes above
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const unsigned up = __shfl_down_sync(kFull, from_me, off);
        if (lane + off < 32) from_me += up;
      }
      const unsigned left = sh.left;
      // lane 0 counts every candidate, at least `left`; the top lane that reaches it holds the digit
      const int holder = 31 - __clz(__ballot_sync(kFull, from_me >= left));
      if (lane == holder) {
        unsigned above = from_me - mine;
        int digit = 8 * lane + 7;
        while (above + sh.hist[digit] < left) above += sh.hist[digit--];
        sh.prefix = prefix | static_cast<Key>(digit) << shift;
        sh.mask = mask | static_cast<Key>(0xff) << shift;
        sh.left = left - above;
        sh.done = sh.hist[digit] == left - above;
      }
    }
    __syncthreads();
    if (sh.done) break;
  }
  // exactly k keys have masked bits at or above the prefix
  const Key prefix = sh.prefix, mask = sh.mask;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Key key = sh.keys[i];
    if ((key & mask) >= prefix) sh.top[atomicAdd(&sh.count, 1)] = key;
  }
  __syncthreads();
  return k;
}

// sh.top[0, count) sorted descending into sh.keys[0, count), each key
// written at its rank.
__device__ void sort_top(RadixShared& sh, int count) {
  if (static_cast<int>(threadIdx.x) < count) {
    const Key key = sh.top[threadIdx.x];
    int rank = 0;
    for (int j = 0; j < count; ++j) rank += sh.top[j] > key;
    sh.keys[rank] = key;
  }
  __syncthreads();
}

// Every element of x[p0, p1) as a key into keys[0, p1 - p0): scalar loads up
// to the first 16-byte boundary and after the last, 16-byte loads between.
template <typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ x, int p0, int p1, Key* keys) {
  constexpr int kLen = kPack<T>;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x + p0);
  const int head = min(static_cast<int>((16 - addr % 16) % 16 / sizeof(T)), p1 - p0);
  const int tid = threadIdx.x;
  if (tid < head) keys[tid] = key_of(to_f32(x[p0 + tid]), p0 + tid);
  const int v0 = p0 + head;
  const int packs = (p1 - v0) / kLen;
  const uint4* xv = reinterpret_cast<const uint4*>(x + v0);
#pragma unroll 4
  for (int j = tid; j < packs; j += kThreads) {
    float f[kLen];
    unpack(xv[j], f, T());
#pragma unroll
    for (int e = 0; e < kLen; ++e) keys[head + j * kLen + e] = key_of(f[e], v0 + j * kLen + e);
  }
  const int t = v0 + packs * kLen + tid;  // fewer than kLen elements after the last pack
  if (t < p1) keys[t - p0] = key_of(to_f32(x[t]), t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
top_k_radix_kernel(const T* __restrict__ logits, float* __restrict__ vals,
                   int32_t* __restrict__ ids, Key* __restrict__ parts,
                   unsigned* __restrict__ arrived, int vocab, int k, int chunk) {
  __shared__ RadixShared sh;
  __shared__ bool last;
  const int row = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const T* x = logits + static_cast<size_t>(row) * vocab;
  const int c0 = split * chunk, c1 = min(vocab, c0 + chunk);
  int count = 0;  // keys in sh.top
  for (int p0 = c0; p0 < c1; p0 += kPiece) {
    const int n = min(kPiece, c1 - p0);
    load_keys<T>(x, p0, p0 + n, sh.keys);
    for (int i = threadIdx.x; i < count; i += kThreads) sh.keys[n + i] = sh.top[i];
    __syncthreads();
    count = select_top(sh, n + count, k);
  }
  if (splits > 1) {
    const size_t row_parts = static_cast<size_t>(row) * splits * k;
    if (static_cast<int>(threadIdx.x) < k)  // unordered; a chunk shorter than k pads with 0
      parts[row_parts + static_cast<size_t>(split) * k + threadIdx.x] =
          static_cast<int>(threadIdx.x) < count ? sh.top[threadIdx.x] : 0;
    __threadfence();  // this block's candidates reach the device before it counts itself
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&arrived[row], 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();  // every other block's candidates are visible from here on
    count = 0;
    for (int p0 = 0; p0 < splits * k; p0 += kPiece) {
      const int n = min(kPiece, splits * k - p0);
      for (int i = threadIdx.x; i < n; i += kThreads) sh.keys[i] = __ldcg(parts + row_parts + p0 + i);
      for (int i = threadIdx.x; i < count; i += kThreads) sh.keys[n + i] = sh.top[i];
      __syncthreads();
      count = select_top(sh, n + count, k);
    }
  }
  sort_top(sh, count);
  if (static_cast<int>(threadIdx.x) < k) {
    const int index = index_of(sh.keys[threadIdx.x]);
    vals[static_cast<size_t>(row) * k + threadIdx.x] = to_f32(x[index]);
    ids[static_cast<size_t>(row) * k + threadIdx.x] = index;
  }
}

template <typename T, int K>
int launch_k(const void* logits, void* vals, void* ids, void* parts, void* arrived, int batch,
             int vocab, int k, int splits, int chunk, cudaStream_t s) {
  top_k_kernel<T, K><<<dim3(batch, splits), kThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<float*>(vals), static_cast<int32_t*>(ids),
      static_cast<Key*>(parts), static_cast<unsigned*>(arrived), vocab, k, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* logits, void* vals, void* ids, void* parts, void* arrived, int batch,
             int vocab, int k, int splits, int chunk, cudaStream_t s) {
#define TOP_K_LAUNCH(K) \
  launch_k<T, K>(logits, vals, ids, parts, arrived, batch, vocab, k, splits, chunk, s)
  if (k <= 1) return TOP_K_LAUNCH(1);
  if (k <= 2) return TOP_K_LAUNCH(2);
  if (k <= 4) return TOP_K_LAUNCH(4);
  if (k <= kRegisterKMax) return TOP_K_LAUNCH(kRegisterKMax);
#undef TOP_K_LAUNCH
  top_k_radix_kernel<T><<<dim3(batch, splits), kThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<float*>(vals), static_cast<int32_t*>(ids),
      static_cast<Key*>(parts), static_cast<unsigned*>(arrived), vocab, k, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each row is split into
// `splits` <= 256 chunks of `chunk` elements, the last taking the rest;
// with splits > 1, `parts` holds batch·splits·k 64-bit candidates and
// `arrived` batch zeroed counters. The caller guarantees batch > 0 and
// 0 < k <= min(vocab, 64). Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int top_k_launch(const void* logits, void* vals, void* ids, void* parts, void* arrived,
                            int batch, int vocab, int k, int splits, int chunk, int dtype,
                            void* stream) {
  if (k < 1 || k > kKMax || k > vocab || splits < 1 || splits > kThreads || chunk < 1 ||
      static_cast<long long>(splits - 1) * chunk >= vocab ||
      static_cast<long long>(splits) * chunk < vocab ||
      (splits > 1 && (parts == nullptr || arrived == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_t<float>(logits, vals, ids, parts, arrived, batch, vocab, k, splits, chunk, s);
    case 1:
      return launch_t<__nv_bfloat16>(logits, vals, ids, parts, arrived, batch, vocab, k, splits,
                                     chunk, s);
    case 2:
      return launch_t<__half>(logits, vals, ids, parts, arrived, batch, vocab, k, splits, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int top_k_max_k() { return kKMax; }
