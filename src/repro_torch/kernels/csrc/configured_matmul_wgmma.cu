// int8 GEMM with zero points on Hopper's tensor cores (sm_90a):
// C = (A - zp_a)·(B - zp_b), A (M, K) and B (K, N) row-major int8, C (M, N)
// float32. The "wgmma" route of kernels/matmul.py::configured_matmul, which
// replaces the Pallas kernel src/repro/kernels/matmul.py::configured_matmul
// (body _configured_matmul_kernel) for int8 operands with K % 16 == 0,
// N % 16 == 0, 16-byte aligned A and B, K <= 65,536 and |zp| <= 128 (the
// rule is matmul.py::plan_configured_matmul); other calls take matmul.cu's
// gemm_kernel. The zero points stay by-value launch parameters, as there.
//
// Bound: bytes, nearly. At (512, 896)·(896, 4864) the operands are 4.8 MB
// of int8 and C 10.0 MB of f32, 4.4 us at 3.35 TB/s, against 4.46 G int8
// operations, 2.3 us at 1,979 TOP/s: the f32 C is two thirds of the
// traffic, so the epilogue's stores weigh as much as the products.
//
// Design (warp-specialised, one output tile of 128 x BN per block):
//   * The zero points go to the epilogue. In integers
//       C = sum(a·b) - zp_b·rowsum(A) - zp_a·colsum(B) + K·zp_a·zp_b,
//     so the tensor cores take A and B as they lie. sum(a·b) is exact in
//     the s32 accumulators (|sum| <= 65,536 · 128² = 2^30); the four terms
//     are combined in int64 and rounded to f32 once, so C is the exact
//     answer rounded once. The plain version sums in f32; the two agree
//     wherever its partial sums are integers below 2^24.
//   * A ring of kStages stages, each one k-step of 128 (one 128-byte
//     swizzled row of int8, four wgmma k32 steps), filled by TMA: A's
//     128 x 128 tile, 128-byte swizzled, and B's 128 x BN tile as it lies
//     (row-major, N-contiguous). One consumer thread issues the loads of
//     step t + kStages as soon as step t is consumed, so kStages steps of
//     loads are in flight. TMA fills everything past M, N or K with zeros.
//   * B is transposed in shared memory: int8 wgmma reads B K-major only
//     (the transpose immediate exists for 16-bit types alone). The
//     producer warpgroup takes units of 16 k-rows x 4 columns of the
//     staged tile (4-byte reads, a warp's 32 on consecutive words),
//     gathers each column's 16 k-values with __byte_perm, stores them as
//     one 16-byte chunk of a 128-byte-swizzled K-major tile, and sums them
//     into the column's colsum(B) with __dp4a. Shared memory's bandwidth
//     bounds each step (TMA's writes, the transpose's reads and writes,
//     wgmma's reads of A and of B by both warpgroups), so each thread takes
//     its 4 columns in an order rotated by (quad / 2) % 4: 8 lanes of a
//     store phase then hit 8 different 16-byte chunks, not 2. The K-major
//     tiles take a ring of two; the producer fences its stores for the
//     async proxy and arrives on the tile's barrier.
//   * Two consumer warpgroups each own 64 rows and issue 4 wgmma m64nBNk32
//     per step, both operands K-major in shared memory; while those run
//     they sum their rows of A's tile with __dp4a into rowsum(A).
//   * Rows past M and columns past N are not written. Any M works.
//   * The epilogue writes pairs of f32 with 8-byte stores: four lanes fill
//     one 32-byte sector of a row.
//   * BN, 128 or 192, is chosen by the wrapper for wave quantisation on
//     132 SMs (the least ceil(tiles / SMs)·BN, as for bf16): at the qwen
//     width 192, 104 tiles in one wave. K-major B has no swizzle-atom rule
//     along N.
//   * The TMA maps are encoded on the host at every call, because the
//     pointers change from call to call.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;   // rows of C per block: two warpgroups of 64
constexpr int kBK = 128;   // depth of one k-step: one 128-byte swizzled row of int8
constexpr int kStages = 4;
constexpr int kTiles = 2;  // K-major B tiles
constexpr int kConsumers = 2;
constexpr int kProducers = 128;  // one warpgroup transposes B
constexpr int kThreads = kConsumers * 128 + kProducers;
constexpr int kTileA = kBM * kBK;  // bytes of A per stage
constexpr uint32_t kOnes = 0x01010101u;  // __dp4a against it sums four signed bytes

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kTileA + BN * kBK;
}

// The ring of A and row-major B, the K-major B tiles, the barriers (loaded
// and empty per stage, full per tile), colsum(B) of the tile's columns and
// rowsum(A) of its rows.
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<BN>() + kTiles * BN * kBK + hopper::kAtomBytes +
         (2 * kStages + kTiles) * 8 + (BN + kBM) * 4;
}

__device__ __forceinline__ int sum4(uint32_t w, int acc) {
  return __dp4a(static_cast<int>(w), static_cast<int>(kOnes), acc);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
configured_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                               const __grid_constant__ CUtensorMap map_b, float* __restrict__ c,
                               int m, int n, int k, int zp_a, int zp_b) {
  using namespace hopper;
  constexpr int kStage = stage_bytes<BN>();
  constexpr int kTileB = BN * kBK;
  constexpr int kQuads = BN / 4;                            // 4-column groups of the tile
  constexpr int kUnits = kQuads * (kBK / 16) / kProducers;  // 16 x 4 units per producer thread
  static_assert(kQuads * (kBK / 16) % kProducers == 0, "BN must share out evenly");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint8_t* tiles = smem + kStages * kStage;
  uint64_t* loaded = reinterpret_cast<uint64_t*>(tiles + kTiles * kTileB);
  uint64_t* empty = loaded + kStages;
  uint64_t* full = empty + kStages;
  int* colsum = reinterpret_cast<int*>(full + kTiles);
  int* rowsum = colsum + BN;

  const int tiles_n = (n + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kBM, n0 = (blockIdx.x % tiles_n) * BN;
  const int steps = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  auto issue = [&](int step) {  // one thread: A's and B's tiles of `step` into its stage
    const int s = step % kStages;
    mbar_expect_tx(&loaded[s], kStage);
    tma_load(smem + s * kStage, &map_a, &loaded[s], step * kBK, m0);
    tma_load(smem + s * kStage + kTileA, &map_b, &loaded[s], n0, step * kBK);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < kTiles; ++i) mbar_init(&full[i], kProducers);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BN; i += kThreads) colsum[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int step = 0; step < min(steps, kStages); ++step) issue(step);

  if (wg == kConsumers) {  // the producer warpgroup: B's K-major tiles and colsum(B)
    const int p = threadIdx.x - kConsumers * 128;
    int sums[kUnits][4];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) sums[u][j] = 0;
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStages;
      mbar_wait(&loaded[s], (step / kStages) & 1);
      if (step >= kTiles)  // the tile's last reader, step - kTiles, is done
        mbar_wait(&empty[(step - kTiles) % kStages], ((step - kTiles) / kStages) & 1);
      const uint8_t* rows = smem + s * kStage + kTileA;  // B's row-major 128 x BN tile
      uint8_t* tile = tiles + (step % kTiles) * kTileB;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int unit = p + u * kProducers;
        const int quad = unit % kQuads, chunk = unit / kQuads;
        uint32_t w[16];  // w[r] = B[16 chunk + r][4 quad .. 4 quad + 3] of the tile
#pragma unroll
        for (int r = 0; r < 16; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(rows + (16 * chunk + r) * BN + 4 * quad);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (j + quad / 2) % 4;     // the rotated order of the thread's columns
          const int pick = col | (col + 4) << 4;  // byte col of each of two rows
          uint32_t t[4];  // t[g] = B[16 chunk + 4g .. 16 chunk + 4g + 3][4 quad + col]
#pragma unroll
          for (int g = 0; g < 4; ++g)
            t[g] = __byte_perm(__byte_perm(w[4 * g], w[4 * g + 1], pick),
                               __byte_perm(w[4 * g + 2], w[4 * g + 3], pick), 0x5410);
          const int nn = 4 * quad + col;  // the column's row of the K-major tile
          *reinterpret_cast<uint4*>(tile + nn * kRowBytes + ((chunk ^ (nn % 8)) << 4)) =
              make_uint4(t[0], t[1], t[2], t[3]);
#pragma unroll
          for (int g = 0; g < 4; ++g) sums[u][j] = sum4(t[g], sums[u][j]);
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[step % kTiles]);
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int quad = (p + u * kProducers) % kQuads;
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&colsum[4 * quad + (j + quad / 2) % 4], sums[u][j]);
    }
    named_barrier_sync(1, kThreads);
    return;
  }

  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int t = threadIdx.x % 128;
  const int arow = t / 2, half = t % 2;  // this thread sums half of row arow of its A rows
  int rsum = 0;
  for (int step = 0; step < steps; ++step) {
    const int s = step % kStages;
    mbar_wait(&loaded[s], (step / kStages) & 1);
    mbar_wait(&full[step % kTiles], (step / kTiles) & 1);
    const uint8_t* a = smem + s * kStage + wg * 64 * kRowBytes;  // this warpgroup's rows
    const uint8_t* bt = tiles + (step % kTiles) * kTileB;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8(acc, smem_desc(a + 32 * kk, 16, kAtomBytes), smem_desc(bt + 32 * kk, 16, kAtomBytes),
               1);
    wgmma_commit();
    // The sum of a row does not depend on the swizzle's chunk order; the
    // chunks are taken rotated by row so 8 lanes of a phase hit 8 banks.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(a + arow * kRowBytes +
                                                      ((4 * half + ((i + arow) & 3)) << 4));
      rsum = sum4(v.w, sum4(v.z, sum4(v.y, sum4(v.x, rsum))));
    }
    wgmma_wait<0>();
    fence_operands(acc);
    fence_proxy_async();  // the reads of A above come before TMA refills the stage
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && step + kStages < steps) {
      mbar_wait(&empty[s], (step / kStages) & 1);
      issue(step + kStages);
    }
  }
  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
  if (half == 0) rowsum[wg * 64 + arow] = rsum;
  named_barrier_sync(1, kThreads);  // colsum(B) and rowsum(A) are complete

  const int lane = threadIdx.x % 32, warp = t / 32;
  const long long corner = static_cast<long long>(k) * zp_a * zp_b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (m0 + r >= m) continue;
    const long long row_term = corner - static_cast<long long>(zp_b) * rowsum[r];
    float* out = c + static_cast<size_t>(m0 + r) * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4);
      if (n0 + cl < n)  // n % 16 == 0, so n0 + cl + 1 < n too
        *reinterpret_cast<float2*>(out + n0 + cl) = make_float2(
            __ll2float_rn(acc[4 * j + 2 * h] + row_term - static_cast<long long>(zp_a) * colsum[cl]),
            __ll2float_rn(acc[4 * j + 2 * h + 1] + row_term -
                          static_cast<long long>(zp_a) * colsum[cl + 1]));
    }
  }
}

template <int BN>
int launch(const void* a, const void* b, void* c, int m, int n, int k, int zp_a, int zp_b,
           void* stream) {
  static std::atomic<uint64_t> raised{0};
  int err = hopper_host::allow_smem(configured_matmul_wgmma_kernel<BN>, smem_bytes<BN>(), raised);
  if (err) return err;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides_a[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box_a[2] = {kBK, kBM};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides_b[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t box_b[2] = {BN, kBK};
  if ((err = hopper_host::tensor_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                     CU_TENSOR_MAP_SWIZZLE_128B, a, 2, dims_a, strides_a, box_a)))
    return err;
  if ((err = hopper_host::tensor_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                     CU_TENSOR_MAP_SWIZZLE_NONE, b, 2, dims_b, strides_b, box_b)))
    return err;
  const unsigned tiles = static_cast<unsigned>((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  configured_matmul_wgmma_kernel<BN>
      <<<tiles, kThreads, smem_bytes<BN>(), static_cast<cudaStream_t>(stream)>>>(
          map_a, map_b, static_cast<float*>(c), m, n, k, zp_a, zp_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 C = (A - zp_a)·(B - zp_b) for int8 A and B on the tensor cores, BN =
// block_n columns of C per block (128 or 192). The caller guarantees
// m, n > 0 and 16-byte-aligned a and b (TMA's rule for addresses); the
// shape and zero-point limits that keep the sums exact, and TMA's rule for
// row strides, are checked here. Launches on `stream` without
// synchronising and returns a cudaError_t code (0 on success).
extern "C" int configured_matmul_wgmma_launch(const void* a, const void* b, void* c, int m, int n,
                                              int k, int zp_a, int zp_b, int block_n,
                                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > 65536 || k % 16 != 0 || n % 16 != 0 || zp_a < -128 ||
      zp_a > 128 || zp_b < -128 || zp_b > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (block_n) {
    case 128:
      return launch<128>(a, b, c, m, n, k, zp_a, zp_b, stream);
    case 192:
      return launch<192>(a, b, c, m, n, k, zp_a, zp_b, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
