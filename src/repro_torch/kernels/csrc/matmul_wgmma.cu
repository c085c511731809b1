// bf16 GEMM on Hopper's tensor cores (sm_90a): C = A·B, A (M, K) and
// B (K, N) row-major bf16, summed in float32, C bf16. The "wgmma" route of
// src/repro_torch/kernels/matmul.py::matmul, which replaces the Pallas
// kernel src/repro/kernels/matmul.py::matmul (body _matmul_kernel) for
// bf16 operands that TMA can describe (K % 8 == 0, N % 8 == 0, 16-byte
// aligned A and B); other shapes take the SIMT kernel of matmul.cu.
//
// Bound: operations. (512, 896)·(896, 4864) is 4.46 GFLOP, 4.5 us at the
// H100 SXM's 989 TFLOP/s dense bf16, against 14.6 MB of bf16 traffic, 4.4
// us at 3.35 TB/s: the two bounds are nearly equal, so the kernel has to
// keep the tensor cores fed from a ring of tiles, not wait on each load.
//
// Design (warp-specialised, one output tile of 128 x BN per block):
//   * A producer warp keeps TMA loads in flight: each k-step of 64 brings a
//     128 x 64 tile of A and a 64 x BN tile of B (BN / 64 boxes of 64 x 64)
//     into a ring of kStages stages, signalled on a "full" mbarrier with the
//     stage's byte count. It reuses a stage once both consumers have
//     arrived on its "empty" mbarrier.
//   * Two consumer warpgroups each own 64 rows and issue 4 wgmma
//     m64nBNk16 per k-step, both operands read from shared memory. A is
//     K-major; B is row-major (K, N), so N-contiguous: it is read
//     MN-major through wgmma's transpose-B immediate, which exists for
//     16-bit types only. Sums stay in f32 registers; the epilogue rounds
//     to bf16 and writes only rows < M and columns < N. TMA fills
//     everything past M, N or K with zeros, so any M and any K % 8 == 0
//     work.
//   * BN is chosen by the wrapper for wave quantisation on 132 SMs
//     (matmul.py::plan_matmul): the least ceil(tiles / SMs)·BN among 128
//     and 192. It must be a multiple of 64, the width of one 128-byte
//     swizzle atom of an MN-major bf16 operand. At (512, 896)·(896, 4864),
//     BN = 128 gives 4 x 38 = 152 tiles, two rounds on 132 SMs of which the
//     second is nearly empty; BN = 192 gives 4 x 26 = 104 tiles in one
//     round (79 % of the SMs), 25 % less time per SM than two rounds of
//     128. (A width of 160, 124 tiles, would need a 64-byte swizzle.)
//   * The TMA maps are encoded on the host at every call, because the
//     pointers change from call to call: host time per launch, which
//     chip_smoke.py reports as the per-call issue time.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;  // rows of C per block: two warpgroups of 64
constexpr int kBK = 64;   // depth of one k-step: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kTileA = kBM * kBK * 2;            // bytes of A per stage
constexpr int kBox = kBK * hopper::kSlab * 2;    // one 64 x 64 box of B: 8 KB

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kTileA + BN * kBK * 2;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<BN>() + hopper::kAtomBytes + 2 * kStages * 8;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, __nv_bfloat16* __restrict__ c,
                    int m, int n, int k) {
  using namespace hopper;
  constexpr int kStage = stage_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int tiles_n = (n + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kBM, n0 = (blockIdx.x % tiles_n) * BN;
  const int steps = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp: one thread issues every load
    if (threadIdx.x == kConsumers * 128) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % kStages;
        if (step >= kStages) mbar_wait(&empty[s], (step / kStages - 1) & 1);
        uint8_t* tile = smem + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        tma_load(tile, &map_a, &full[s], step * kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / kSlab; ++j)
          tma_load(tile + kTileA + j * kBox, &map_b, &full[s], n0 + j * kSlab, step * kBK);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int s = step % kStages;
    mbar_wait(&full[s], (step / kStages) & 1);
    const uint8_t* a = smem + s * kStage + wg * 64 * kRowBytes;  // this warpgroup's rows
    const uint8_t* b = smem + s * kStage + kTileA;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<1>(acc, smem_desc(a + 32 * kk, 16, kAtomBytes),
                  smem_desc(b + 16 * kRowBytes * kk, kBox, kAtomBytes), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= m) continue;
    __nv_bfloat16* out = c + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < n)  // n % 8 == 0, so col + 1 < n too
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
int launch(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
  static std::atomic<uint64_t> raised{0};
  int err = hopper_host::allow_smem(matmul_wgmma_kernel<BN>, smem_bytes<BN>(), raised);
  if (err) return err;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides_a[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box_a[2] = {kBK, kBM};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides_b[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box_b[2] = {hopper::kSlab, kBK};
  if ((err = hopper_host::bf16_map(&map_a, a, 2, dims_a, strides_a, box_a))) return err;
  if ((err = hopper_host::bf16_map(&map_b, b, 2, dims_b, strides_b, box_b))) return err;
  const unsigned tiles = static_cast<unsigned>((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  matmul_wgmma_kernel<BN><<<tiles, kThreads, smem_bytes<BN>(), static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 C = A·B on the tensor cores, BN = block_n columns of C per block
// (128 or 192). The caller guarantees m, n, k > 0, k % 8 == 0, n % 8 == 0
// and 16-byte-aligned a and b (TMA's rule for addresses and row strides).
// Launches on `stream` without synchronising and returns a cudaError_t
// code (0 on success).
extern "C" int matmul_wgmma_launch(const void* a, const void* b, void* c, int m, int n, int k,
                                   int block_n, void* stream) {
  switch (block_n) {
    case 128:
      return launch<128>(a, b, c, m, n, k, stream);
    case 192:
      return launch<192>(a, b, c, m, n, k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
