// Flash attention for Hopper (sm_90a): softmax(q·kᵀ / sqrt(D))·v over
// (B, H, Sq, D) queries and (B, H, Sk, D) keys and values, full or causal,
// output in the inputs' type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel). That kernel walks a
// (B·H, Sq/bq, Sk/bk) grid in order and carries the running max,
// normaliser and accumulator of each query row across the key steps in
// VMEM scratch. Hopper runs blocks in parallel and in no order, so the key
// walk becomes a loop inside the block and the running state lives in
// registers. One difference of meaning, on purpose: the causal mask is
// bottom-right aligned (query row i sees keys j <= i + Sk - Sq), as the
// plain reference (src/repro/kernels/ref.py) masks; the Pallas kernel masks
// top-left. The two agree when Sq == Sk. The wrapper refuses causal
// Sq > Sk, where the first rows would see no key.
//
// Bound: operations. A full (1, 14, 512, 64) call is 4·14·512²·64 = 0.94
// GFLOP (about half that causal) on 3.7 MB of f32 inputs and output; at the
// H100 SXM's 67 TFLOP/s in f32 outside the tensor cores (this kernel's
// arithmetic) that is about 14 us, against 1.1 us for the bytes.
//
// Design, simple first:
//   * One block of 8 warps per (b·h, tile of 32 query rows); each warp owns
//     4 rows and keeps, per row, the f32 running max, the normaliser and the
//     accumulator (D / 32 values per lane) in registers. The queries of the
//     tile sit in shared memory, scaled by 1/sqrt(D) as they are staged.
//   * Keys and values stream through shared memory 64 at a time, converted
//     to f32 (keys padded by one float a row, so 32 lanes reading 32 key
//     rows hit 32 banks). Each lane scores two keys against the warp's 4
//     rows; the warp's max and sum come from shuffles; the probabilities are
//     shuffled to all lanes, and each lane adds p·v into its D / 32 columns.
//   * Ragged edges are masked: keys past Sk score -inf, query rows past Sq
//     are computed on zeros and not written, so any Sq and Sk work,
//     Sq = 1 (decode) included. A row whose keys so far are all masked
//     keeps its sums at zero instead of taking exp(-inf - -inf).
//   * Causal blocks stop at the last key their last row can see.
//   * D <= 128. For D > 64 the tile needs 82 KB of shared memory, which is
//     above the 48 KB default, so the kernel asks for it once with
//     cudaFuncSetAttribute.
// Not yet used: tensor cores (wgmma), TMA, and sharing the K/V tile across
// more query rows. Those are the redesign, not the port.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 64;                  // keys per tile: two per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * DMAX + kBK * (DMAX + 1) + kBK * DMAX);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int sk, int d, float scale, int causal) {
  constexpr int kC = DMAX / 32;  // accumulator columns per lane
  constexpr int kKStride = DMAX + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][DMAX]
  float* ks = qs + kBQ * DMAX;        // [kBK][DMAX + 1]
  float* vs = ks + kBK * kKStride;    // [kBK][DMAX]

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = warp * kRows;

  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    qs[r * DMAX + c] = q0 + r < sq ? to_f32(qb[static_cast<size_t>(q0 + r) * d + c]) * scale : 0.f;
  }

  float m_run[kRows], l_run[kRows], acc[kRows][kC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }

  // the keys this block needs: causal rows see j <= i + sk - sq
  int k_end = sk;
  if (causal) {
    const int last = min(sq, q0 + kBQ) - 1;
    k_end = min(sk, last + sk - sq + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
      const int j = idx / d, c = idx % d;
      const int gj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (gj < sk) {
        kx = to_f32(kb[static_cast<size_t>(gj) * d + c]);
        vx = to_f32(vb[static_cast<size_t>(gj) * d + c]);
      }
      ks[j * kKStride + c] = kx;
      vs[j * DMAX + c] = vx;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k_lo = ks + lane * kKStride;
    const float* k_hi = ks + (lane + 32) * kKStride;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float a = k_lo[c], b = k_hi[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qs[(row0 + r) * DMAX + c];
        s[r][0] = fmaf(qv, a, s[r][0]);
        s[r][1] = fmaf(qv, b, s[r][1]);
      }
    }

    // online softmax: s becomes p
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + row0 + r;
      const int last_key = causal ? qi + sk - sq : sk - 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = k0 + lane + 32 * h;
        if (gj >= sk || gj > last_key) s[r][h] = -INFINITY;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      const float p0 = expf(s[r][0] - m_use), p1 = expf(s[r][1] - m_use);
      const float alpha = expf(m_run[r] - m_use);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l_run[r] = l_run[r] * alpha + ps;
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha;
      s[r][0] = p0;
      s[r][1] = p1;
    }

    // acc += p · v
    const int n_keys = min(kBK, k_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      const int src = j & 31;
      const bool hi = j >= 32;
      float vv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = vs[j * DMAX + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __shfl_sync(kFull, hi ? s[r][1] : s[r][0], src);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= sq) continue;
    T* orow = o + (bh * sq + qi) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) put(orow + col, acc[r][c] / l_run[r]);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
           int causal, void* stream) {
  constexpr size_t kSmem = smem_bytes<DMAX>();
  if (kSmem > 48 * 1024) {
    static bool raised = false;  // once per instantiation
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised = true;
    }
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  flash_kernel<T, DMAX><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all contiguous.
// dtype: 0 = float32, 1 = bfloat16. The caller guarantees 0 < d <= 128,
// sq, sk, bh > 0, bh <= 65535 and, when causal, sq <= sk. Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                      int sq, int sk, int d, int causal, int dtype, void* stream) {
  if (d <= 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = d <= 64;
  switch (dtype) {
    case 0:
      return small ? launch<float, 64>(q, k, v, o, bh, sq, sk, d, causal, stream)
                   : launch<float, 128>(q, k, v, o, bh, sq, sk, d, causal, stream);
    case 1:
      return small ? launch<__nv_bfloat16, 64>(q, k, v, o, bh, sq, sk, d, causal, stream)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, bh, sq, sk, d, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
