// Flash attention for Hopper (sm_90a): softmax(q·kᵀ / sqrt(D))·v over
// (B, H, Sq, D) queries and (B, H, Sk, D) keys and values, full or causal,
// in f32 arithmetic, output in the inputs' type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel). That kernel walks a
// (B·H, Sq/bq, Sk/bk) grid in order and carries the running max,
// normaliser and accumulator of each query row across the key steps in
// VMEM scratch. Hopper runs blocks in parallel and in no order, so the key
// walk becomes a loop inside the block, the running state lives in
// registers, and where the grid would leave SMs idle the key walk of one
// query tile is split across the blocks of a thread-block cluster, whose
// partial states are merged through distributed shared memory. One
// difference of meaning, on purpose: the causal mask is bottom-right
// aligned (query row i sees keys j <= i + Sk - Sq), as the plain reference
// (src/repro/kernels/ref.py) masks; the Pallas kernel masks top-left. The
// two agree when Sq == Sk. The wrapper refuses causal Sq > Sk, where the
// first rows would see no key.
//
// Bound: operations. A causal (1, 14, 512, 64) call keeps 1,838,592
// (query, key) pairs, 4·64 FLOP each: 0.47 GFLOP, about 7 us at the H100
// SXM's 67 TFLOP/s in f32 outside the tensor cores (this kernel's
// arithmetic: no TF32, which keeps about three decimal digits), against
// 1.1 us for the bytes. So the design keeps the FMA pipe fed:
//   * Both products are register micro-tiles. A block of 256 threads takes
//     64 query rows; thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i
//     (i < 4) and, of each 64-key tile, the scores of keys tx + 16 j
//     (j < 4) and the output columns 4 tx .. 4 tx + 3 (+ 64 for D > 64).
//     Q·Kᵀ reads 4 float4 of Q (a broadcast: a quarter-warp shares its row)
//     and 4 float4 of K for 64 FMAs; P·V reads 4 float4 of P and 4 (8)
//     float4 of V for 64 (128). K rows are padded by 4 floats and P rows by
//     16, so the float4 reads and the stores of P hit distinct banks.
//   * Probabilities go through shared memory into P·V, with no per-key
//     shuffles; the row max is reduced by shuffles among the 16 lanes that
//     share a row, and the row sum once at the end.
//   * Accuracy as the plain version's, on the card's f32: a score is summed
//     4 products at a time (one FMA chain of 4, then one add), a chain of
//     D / 4 where one FMA a product gives D; the running max is kept in
//     unscaled scores and p = expf((s - m) / sqrt(D)), which for D = 64 is
//     the plain version's own arithmetic. Folding log2(e)/sqrt(D) into Q for
//     exp2f, the cheaper form, rounds every score once more and measured up
//     to 3x the plain version's error against float64 (PERF.md).
//   * K and V stream through a 2-stage ring: for f32 with D % 4 == 0 and
//     16-byte aligned q, k, v (kAsync, the "cp_async" staging of
//     kernels/flash_attention.py) tile t + 1 is copied by cp.async while
//     tile t is computed; everything else (bf16, odd D, unaligned rows) is
//     staged by plain loads converted to f32 (the "plain" staging).
//   * Only tiles that need it are masked: the diagonal tiles of a causal
//     call and the ragged last tile of a block's key range. Causal query
//     tiles are issued heaviest first.
//   * kernels/flash_attention.py::plan_attention splits the keys a query
//     tile needs (k_end) across a cluster of `splits` blocks (1, 2, 4, 8),
//     in ranges of whole 16-key units. Each block keeps its partial (m, l,
//     acc); after cluster.sync() each block merges 64 / splits of the rows
//     from all peers through distributed shared memory and writes them; a
//     second cluster.sync() keeps every block resident until its peers
//     have read it.
// Ragged edges: keys past a block's range are zero-filled and score -inf,
// query rows past Sq are computed on zeros and not written, so any Sq and
// Sk work, Sq = 1 (decode) included. A row whose keys so far are all
// masked keeps its sums at zero instead of taking exp(-inf - -inf).
// D <= 128, as two instances: D <= 64 (104 KB of shared memory, two blocks
// an SM) and D <= 128 (184 KB). This is the "simt" route: every f32 call,
// and bf16 calls that TMA cannot describe (D % 8 != 0 or a pointer off 16
// bytes). Other bf16 calls run on the tensor cores, flash_attention_wgmma.cu.

#include <climits>
#include <cmath>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kRM = 4;         // rows per thread: ty + 16 i
constexpr int kKN = 4;         // scores per row per thread: keys tx + 16 j
constexpr int kKeyUnit = 16;   // a split's key range is whole units of 16 keys
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int kPS = kBK + 16;  // P row stride: rows ty and ty + 1 16 banks apart
constexpr unsigned kFull = 0xffffffffu;

// Shared memory in floats. Q's region holds the partial accumulator after
// the key loop, for the merge across the cluster.
template <int DMAX>
struct Layout {
  static constexpr int kQS = DMAX + 4;  // row strides: 4 words mod 32, so 8
  static constexpr int kKS = DMAX + 4;  // float4 reads of 8 rows hit 32 banks
  static constexpr int kVS = DMAX;
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * kQS;         // two stages
  static constexpr int v = k + 2 * kBK * kKS;     // two stages
  static constexpr int p = v + 2 * kBK * kVS;
  static constexpr int m = p + kBQ * kPS;         // merge: each row's max,
  static constexpr int l = m + kBQ;               // its sum,
  static constexpr int w = l + kBQ;               // each peer's weight (splits x rows = 64),
  static constexpr int lt = w + kBQ;              // and the merged sum
  static constexpr int floats = lt + kBQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <typename T, int DMAX, bool kAsync>
__global__ void __launch_bounds__(kThreads, DMAX <= 64 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int sk, int d, float scale, int causal, int splits) {
  using L = Layout<DMAX>;
  constexpr int kNC = DMAX / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ps = smem + L::p;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rank = blockIdx.x % splits;
  const size_t bh = blockIdx.x / splits;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = qt * kBQ;
  const int offset = sk - sq;  // causal row i sees keys j <= i + offset
  const int k_end = causal ? min(sk, min(sq, q0 + kBQ) + offset) : sk;
  const int units = (k_end + kKeyUnit - 1) / kKeyUnit;
  const int kb = kKeyUnit * static_cast<int>(static_cast<long long>(rank) * units / splits);
  const int ke = min(k_end, kKeyUnit * static_cast<int>(static_cast<long long>(rank + 1) * units / splits));
  const int n_tiles = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const int dd = (d + 3) & ~3;  // columns staged: past d they are zero

  const T* qb = q + (bh * sq + q0) * d;
  const T* kbase = k + bh * sk * d;
  const T* vbase = v + bh * sk * d;
  if constexpr (kAsync) {
    for (int idx = tid; idx < kBQ * (d / 4); idx += kThreads) {
      const int r = idx / (d / 4), c = 4 * (idx % (d / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(r) * d + c);
      *reinterpret_cast<float4*>(qs + r * L::kQS + c) = x;
    }
  } else {
    for (int idx = tid; idx < kBQ * dd; idx += kThreads) {
      const int r = idx / dd, c = idx % dd;
      qs[r * L::kQS + c] =
          q0 + r < sq && c < d ? to_f32(qb[static_cast<size_t>(r) * d + c]) : 0.f;
    }
  }

  auto stage = [&](int buf, int k0) {
    float* kd = ks + buf * kBK * L::kKS;
    float* vd = vs + buf * kBK * L::kVS;
    if constexpr (kAsync) {
      for (int idx = tid; idx < kBK * (d / 4); idx += kThreads) {
        const int j = idx / (d / 4), c = 4 * (idx % (d / 4));
        const bool in = k0 + j < ke;
        const size_t off = in ? static_cast<size_t>(k0 + j) * d + c : 0;
        hopper::cp_async16(kd + j * L::kKS + c, kbase + off, in);
        hopper::cp_async16(vd + j * L::kVS + c, vbase + off, in);
      }
      hopper::cp_async_commit();
    } else {
      for (int idx = tid; idx < kBK * dd; idx += kThreads) {
        const int j = idx / dd, c = idx % dd;
        const bool in = k0 + j < ke && c < d;
        const size_t off = static_cast<size_t>(k0 + j) * d + c;
        kd[j * L::kKS + c] = in ? to_f32(kbase[off]) : 0.f;
        vd[j * L::kVS + c] = in ? to_f32(vbase[off]) : 0.f;
      }
    }
  };

  float m_run[kRM], l_run[kRM], acc[kRM][kNC];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;  // this thread's keys only, summed across the row at the end
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) stage(0, kb);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kb + t * kBK, buf = t & 1;
    if (t + 1 < n_tiles) {
      stage(buf ^ 1, k0 + kBK);  // its buffer was released at the end of tile t - 1
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory (and, first, Q)
    const float* kt = ks + buf * kBK * L::kKS;
    const float* vt = vs + buf * kBK * L::kVS;

    // s = q·kᵀ, unscaled
    float s[kRM][kKN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kKN; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < dd; c += 4) {
      float4 qv[kRM], kv[kKN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::kQS + c);
#pragma unroll
      for (int j = 0; j < kKN; ++j) kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * L::kKS + c);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
#pragma unroll
        for (int j = 0; j < kKN; ++j) {
          float t = qv[i].x * kv[j].x;  // 4 terms, then one add: a chain of D / 4
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] += t;
        }
      }
    }

    // mask only the ragged last tile of the range and the causal diagonal
    if (k0 + kBK > ke || (causal && k0 + kBK - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int last = causal ? q0 + ty + 16 * i + offset : INT_MAX;
#pragma unroll
        for (int j = 0; j < kKN; ++j) {
          const int gj = k0 + tx + 16 * j;
          if (gj >= ke || gj > last) s[i][j] = -INFINITY;
        }
      }
    }

    // online softmax: s becomes p
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      const float alpha = expf((m_run[i] - m_use) * scale);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        s[i][j] = expf((s[i][j] - m_use) * scale);
        rs += s[i][j];
      }
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKN; ++j) ps[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // P is in shared memory

    // acc += p · v
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vt + (j + e) * L::kVS + 4 * tx;
#pragma unroll
        for (int c4 = 0; c4 < kNC / 4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * c4);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float p = at(pv[i], e);
            acc[i][4 * c4 + 0] = fmaf(p, vv.x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(p, vv.y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(p, vv.z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(p, vv.w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // tile t's K, V and P are consumed
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l_run[i] += __shfl_xor_sync(kFull, l_run[i], off);
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi >= sq) continue;
      T* orow = o + (bh * sq + qi) * d;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = 4 * tx + 64 * (c / 4) + c % 4;
        if (col < d) put(orow + col, acc[i][c] / l_run[i]);
      }
    }
    return;
  }

  // The merge across the cluster: partial state to shared memory, then
  // each block combines its share of the rows from every peer.
  cg::cluster_group cluster = cg::this_cluster();
  float* part = qs;  // [kBQ][kQS]: the unnormalised accumulator
  float* ms = smem + L::m;
  float* ls = smem + L::l;
  float* ws = smem + L::w;
  float* lt = smem + L::lt;
  __syncthreads();  // nothing reads Q any more (a block with no tile never waited for it)
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int c = 0; c < kNC; ++c) part[r * L::kQS + 4 * tx + 64 * (c / 4) + c % 4] = acc[i][c];
    if (tx == 0) {
      ms[r] = m_run[i];
      ls[r] = l_run[i];
    }
  }
  cluster.sync();  // every block's partial state is visible to its peers

  const int rows = kBQ / splits, r0 = rank * rows;
  if (tid < rows) {
    const int row = r0 + tid;
    float mp[kMaxSplits], big = -INFINITY;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      mp[p] = p < splits ? *cluster.map_shared_rank(ms + row, p) : -INFINITY;
      big = fmaxf(big, mp[p]);
    }
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p >= splits) continue;
      const float w = mp[p] == -INFINITY ? 0.f : expf((mp[p] - big) * scale);  // a peer that saw no key
      ws[p * rows + tid] = w;
      sum = fmaf(w, *cluster.map_shared_rank(ls + row, p), sum);
    }
    lt[tid] = sum;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int rr = idx / d, col = idx % d;
    const int qi = q0 + r0 + rr;
    if (qi >= sq) continue;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < splits) {
        sum = fmaf(ws[p * rows + rr], *cluster.map_shared_rank(part + (r0 + rr) * L::kQS + col, p), sum);
      }
    }
    put(o + (bh * sq + qi) * d + col, sum / lt[rr]);
  }
  cluster.sync();  // no block leaves while a peer may still read its state
}

template <typename T, int DMAX, bool kAsync>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
           int causal, int splits, cudaStream_t stream) {
  constexpr size_t kSmem = Layout<DMAX>::bytes;
  static std::atomic<uint64_t> raised{0};
  const int err = hopper_host::allow_smem(flash_kernel<T, DMAX, kAsync>, static_cast<int>(kSmem),
                                          raised);
  if (err) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bh) * splits, (sq + kBQ - 1) / kBQ);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // no split: a plain launch, no cluster to place
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_kernel<T, DMAX, kAsync>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale, causal, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAsync>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
             int causal, int splits, cudaStream_t stream) {
  return d <= 64 ? launch<T, 64, kAsync>(q, k, v, o, bh, sq, sk, d, causal, splits, stream)
                 : launch<T, 128, kAsync>(q, k, v, o, bh, sq, sk, d, causal, splits, stream);
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all contiguous.
// dtype: 0 = float32, 1 = bfloat16. splits: blocks of a cluster sharing one
// query tile's keys, 1, 2, 4 or 8. async: stage K and V by cp.async, for
// float32 with d % 4 == 0 and q, k, v 16-byte aligned only. The caller
// guarantees 0 < d <= 128, sq, sk, bh > 0, ceil(sq / 64) <= 65535 and,
// when causal, sq <= sk. Launches on `stream` without synchronising and
// returns the launch's CUDA error (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                      int sq, int sk, int d, int causal, int dtype, int splits,
                                      int async, void* stream) {
  if (d <= 0 || d > 128 || !(splits == 1 || splits == 2 || splits == 4 || splits == 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && async) {
    if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_d<float, true>(q, k, v, o, bh, sq, sk, d, causal, splits, s);
  }
  if (async) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_d<float, false>(q, k, v, o, bh, sq, sk, d, causal, splits, s);
    case 1: return launch_d<__nv_bfloat16, false>(q, k, v, o, bh, sq, sk, d, causal, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
