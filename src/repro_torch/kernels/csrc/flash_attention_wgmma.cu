// bf16 flash attention on Hopper's tensor cores (sm_90a):
// softmax(q·kᵀ / sqrt(D))·v over (B, H, Sq, D) queries and (B, H, Sk, D)
// keys and values, full or causal, f32 running state, bf16 output. The
// "wgmma" route of src/repro_torch/kernels/flash_attention.py, which
// replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel) for bf16 with D % 8 == 0 and
// 16-byte-aligned q, k, v; f32 and other bf16 inputs take the SIMT kernel
// of flash_attention.cu, whose function this one keeps exactly: scale
// 1/sqrt(D), the bottom-right causal mask (row i sees keys
// j <= i + Sk - Sq), causal blocks stopping at their last visible key, any
// Sq (1 for decode) and Sk, D <= 128.
//
// Bound: bytes at qwen2-0.5b's (1, 14, 512, 64): 3.7 MB of bf16 q, k, v, o
// is 1.1 us at 3.35 TB/s, against 0.47 GFLOP causal, 0.5 us at 989 TFLOP/s.
// At this size each block's chain of dependent steps (load, q·kᵀ, softmax,
// p·v) sets the time, so the design keeps every product on the tensor
// cores and the next key tile in flight.
//
// Design:
//   * One warpgroup (128 threads) per 64 query rows of one (b, h): at
//     (1, 14, 512, 64) that is 8 x 14 = 112 blocks. Causal blocks are
//     launched heaviest first.
//   * q (64 x D) is one TMA load; keys and values stream 64 at a time
//     through a 2-stage ring of TMA loads on mbarriers, the load of tile
//     t + 2 issued as soon as tile t is consumed. The maps are 3-d
//     (D, S, B·H), so rows past S and columns past D arrive as zeros: D is
//     padded to 64 or 128 in shared memory for free.
//   * S = q·kᵀ: wgmma m64n64k16 with both operands K-major in shared memory,
//     ceil(D / 16) steps. The online softmax runs on the f32 accumulator in
//     registers: each thread holds 2 rows x 16 keys, the row max and sum
//     take two shuffles among the 4 threads of a row; scores are scaled by
//     log2(e)/sqrt(D) and exponentiated with exp2. A row whose keys so far
//     are all masked keeps its sums at zero, as in the SIMT kernel.
//   * O += P·V: P is rounded to bf16 and packed straight from the
//     accumulator into the register-A fragment of wgmma (the m64nN
//     accumulator and the m64k16 A fragment share their layout), and V is
//     read from shared memory MN-major, through the transpose-B immediate.
//     The normaliser sums the f32 probabilities.
//   * The epilogue divides by the normaliser and writes rows < Sq, columns
//     < D, as bf16 pairs.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block: one wgmma M
constexpr int kBKV = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr int kBox = kBKV * hopper::kSlab * 2;  // one 64 x 64 bf16 box: 8 KB

template <int DPAD>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * 2) * (DPAD / hopper::kSlab) * kBox + hopper::kAtomBytes + 3 * 8;
}

template <int DPAD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                   int sq, int sk, int d, float scale_log2, int causal) {
  using namespace hopper;
  constexpr int kSlabs = DPAD / kSlab;
  constexpr int kTile = kSlabs * kBox;  // bytes of q, or of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint8_t* qs = smem;
  uint8_t* ks = qs + kTile;        // [2 stages]
  uint8_t* vs = ks + 2 * kTile;    // [2 stages]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vs + 2 * kTile);
  uint64_t* full = q_bar + 1;      // [2 stages]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal blocks first
  int k_end = sk;
  if (causal) k_end = min(sk, min(sq, q0 + kBQ) - 1 + sk - sq + 1);
  const int tiles = (k_end + kBKV - 1) / kBKV;

  auto load_kv = [&](int t) {
    const int s = t % 2;
    mbar_expect_tx(&full[s], 2 * kTile);
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) {
      tma_load(ks + s * kTile + j * kBox, &map_k, &full[s], j * kSlab, t * kBKV, bh);
      tma_load(vs + s * kTile + j * kBox, &map_v, &full[s], j * kSlab, t * kBKV, bh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    mbar_expect_tx(q_bar, kTile);
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) tma_load(qs + j * kBox, &map_q, q_bar, j * kSlab, q0, bh);
    for (int t = 0; t < min(tiles, 2); ++t) load_kv(t);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane % 4);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;
  const int d_steps = (d + 15) / 16;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % 2;
    mbar_wait(&full[s], (t / 2) & 1);
    const uint8_t* kt = ks + s * kTile;
    const uint8_t* vt = vs + s * kTile;

    float sc[kBKV / 2];
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    fence_operands(sc);
    wgmma_fence();
    for (int kk = 0; kk < d_steps; ++kk) {
      const int off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss<0>(sc, smem_desc(qs + off, 16, kAtomBytes), smem_desc(kt + off, 16, kAtomBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // online softmax over this tile, rows row0 (h = 0) and row0 + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int last = causal ? min(row + sk - sq, sk - 1) : sk - 1;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * kBKV + 8 * j + col0 + e;
          float& x = sc[4 * j + 2 * h + e];
          x = key <= last ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      const float alpha = exp2f(m_run[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = exp2f(x - m_use);
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
    }

    // P (64 x 64) as four k16 A fragments: keys 16c..16c+15 are the
    // accumulator's column groups 2c and 2c + 1
    uint32_t p[kBKV / 16][4];
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 two = __floats2bfloat162_rn(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]);
        p[c][r] = *reinterpret_cast<const uint32_t*>(&two);
      }
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c)
      wgmma_rs<1>(acc, p[c], smem_desc(vt + c * 16 * kRowBytes, kBox, kAtomBytes), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);

    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && t + 2 < tiles) load_kv(t + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* out = o + (static_cast<size_t>(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < d)  // d % 8 == 0, so col + 1 < d too
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int DPAD>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
           int causal, void* stream) {
  static std::atomic<uint64_t> raised{0};
  int err = hopper_host::allow_smem(flash_wgmma_kernel<DPAD>, smem_bytes<DPAD>(), raised);
  if (err) return err;
  CUtensorMap maps[3];
  const cuuint32_t box[3] = {hopper::kSlab, kBKV, 1};
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t s = i == 0 ? sq : sk;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), s, static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, s * d * 2};
    if ((err = hopper_host::bf16_map(&maps[i], bases[i], 3, dims, strides, box))) return err;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
  flash_wgmma_kernel<DPAD><<<grid, kThreads, smem_bytes<DPAD>(), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), sq, sk, d, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), bf16, contiguous.
// The caller guarantees 0 < d <= 128, d % 8 == 0, 16-byte-aligned q, k, v
// and o, sq, sk, bh > 0, bh <= 65535 and, when causal, sq <= sk. Launches
// on `stream` without synchronising and returns a cudaError_t code (0 on
// success).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int bh, int sq, int sk, int d, int causal,
                                            void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return d <= 64 ? launch<64>(q, k, v, o, bh, sq, sk, d, causal, stream)
                 : launch<128>(q, k, v, o, bh, sq, sk, d, causal, stream);
}
