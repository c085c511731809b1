// Decode attention over a K/V cache for Hopper (sm_90a): one new query row
// per batch row, its Hq = Hkv * G heads attending to the cache rows up to
// the row's position, with the row's own new K/V at that position.
//
// Replaces no Pallas kernel: the JAX package leaves decode attention to
// XLA (two einsums, the mask and the softmax in models/layers.py). The
// port's einsums read a (B, T, Hkv, D) cache as no single batch, so each
// copied the whole cache head-major, K for the scores and V for the sum,
// in every layer of every step, and scored all T rows to mask those past
// the position. This kernel reads the cache where it lies, with its
// strides, and only the rows each batch row attends to.
//
// Semantics (kernels/ref.py::decode_attention_ref, the plain version):
// batch row b at position p attends to cache rows 0 .. min(p, T - 1); where
// p < T its own new K/V (k_new, v_new) stands in for the cache's row p;
// where p >= T it attends to the whole cache as it is. Scores are the bf16
// products summed in f32 times an f32 1/sqrt(D); the softmax is f32; the
// probabilities are rounded to bf16 before P.V, which sums in f32; the
// output is rounded to bf16 once.
//
// Bound: bytes. G <= 8 query heads share each K/V row, so a row of 2 D
// bytes of K and as many of V carries 4 G flops per K/V element pair: far
// below the card's 295 flops a byte. At a 128-row phi4-mini step (Hkv 8,
// D 128) a position costs 2 KB of K and 2 KB of V a row and layer. What the
// design does about it:
//   * flash-decoding: a block per (slice of the cache, K/V head, batch
//     row); the slices (decode_attention.py::plan_decode_attention) are
//     planned on the host from B, Hkv, T and the SM count, never from the
//     positions, which the card advances under a CUDA graph. A slice that
//     starts past its row's position writes an empty partial and exits; a
//     slice stops at the position, so rows past it are never read from
//     device memory (a tile's rows past the slice repeat its last row,
//     which the cache has just given);
//   * the rows stream through a ring of kStages tiles of kTile rows of K
//     and V in shared memory, each row one bulk copy (cp.async.bulk, 2 D
//     bytes, completion counted on the stage's mbarrier) issued by one lane
//     of warp 0, so loading costs a few instructions a row; each row is
//     padded by 16 bytes, so ldmatrix's eight rows meet no bank conflict;
//   * the products run on the tensor cores (mma.sync, bf16 in, f32 sums):
//     the G query heads are the rows of an m16 tile (rows G..15 zero),
//     each warp takes 8 of a tile's rows as the n8 of S = Q K^T (m16n8k16
//     over D) and the k8 of O += P V (m16n8k8 over D / 8 column tiles), P
//     going from the score registers to the A operand without shared
//     memory. So a 16-byte chunk of K or V costs a fraction of an
//     instruction, and the kernel is left to stream;
//   * each warp keeps its own online softmax (m, l, O) over its rows, in
//     f32; the four warps merge at the end in shared memory, and more than
//     one slice writes f32 partials (m, l, O) that a second small launch
//     merges per (row, head); one slice writes the output directly.
// D is one of the head widths the port's configurations decode with, 16
// (the reduced ones), 64, 96, 112 and 128, a template instance each; G is
// any of 1 .. 8, read at run time: one algorithm at the shapes it is given.

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 32;      // cache rows a stage: 8 a warp
constexpr int kStages = 3;     // tiles in the ring: two in flight while one is used
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;
constexpr int kBarBytes = 128;  // the stages' mbarriers, before the ring

struct Params {
  const __nv_bfloat16* q;   // (B, 1, Hq, D)
  const __nv_bfloat16* kc;  // (B, T, Hkv, D), strided
  const __nv_bfloat16* vc;
  const __nv_bfloat16* kn;  // (B, 1, Hkv, D), strided
  const __nv_bfloat16* vn;
  const void* pos;          // (B,) int32 or int64, strided
  __nv_bfloat16* out;       // (B, 1, Hq, D), contiguous
  float* part_acc;          // (B, Hkv, splits, G, D) when splits > 1
  float* part_ml;           // (B, Hkv, splits, G, 2): the running max and sum
  int64_t q_sb, q_sh, kc_sb, kc_st, kc_sh, vc_sb, vc_st, vc_sh, kn_sb, kn_sh, vn_sb, vn_sh,
      pos_s;
  int t, hkv, g, d, pos64, splits, chunk;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(hopper::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// Four (two) 8x8 bf16 matrices from shared memory, lane l giving row l % 8
// of matrix l / 8; thread t gets row t / 4, columns 2 (t % 4) and + 1 of
// each (with .trans, of each transposed).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, rows 8..15 zero: a0 rows 0..7 at
// columns 0..7, a1 at columns 8..15) . b (16 x 8, bf16).
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a1), "r"(0u), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) += a (16 x 8, bf16, rows 8..15 zero) . b (8 x 8, bf16).
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a), "r"(0u), "r"(b));
}

// The rows batch row b attends to: 0 .. min(pos, T - 1), at least row 0.
__device__ __forceinline__ int attended(const Params& p, int b, int64_t& pos) {
  pos = p.pos64 ? static_cast<const int64_t*>(p.pos)[b * p.pos_s]
                : static_cast<const int32_t*>(p.pos)[b * p.pos_s];
  return pos < p.t ? static_cast<int>(pos < 0 ? 1 : pos + 1) : p.t;
}

// The kernel's dynamic shared memory at head width d: the barriers and the
// K/V ring, whose bytes the warps' final merge reuses.
size_t smem_bytes(int d) {
  return kBarBytes + static_cast<size_t>(kStages) * 2 * kTile * (d / 8 + 1) * 16;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 4) decode_attention_kernel(const Params p) {
  constexpr int RS = kD / 8 + 1;  // a padded row, in 16-byte chunks
  constexpr int KS = kD / 16;     // k16 steps of the scores
  constexpr int NT = kD / 8;      // n8 column tiles of the output
  constexpr int kStageChunks = 2 * kTile * RS;  // K then V
  constexpr int kRow = kD * 2;                  // bytes of a cache row of one head
  extern __shared__ __align__(128) uint8_t smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.g;
  int64_t pos;
  const int n = attended(p, b, pos);
  const int start = split * p.chunk;
  const int stop = min(start + p.chunk, n);
  const int64_t slot = (static_cast<int64_t>(b) * p.hkv + h) * p.splits + split;
  if (start >= stop) {  // the slice starts past the row's position: an empty partial
    if (tid < G) p.part_ml[(slot * G + tid) * 2] = -INFINITY;
    return;
  }

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's tile has landed
  uint4* ring = reinterpret_cast<uint4*>(smem + kBarBytes);
  const int tiles = (stop - start + kTile - 1) / kTile;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const __nv_bfloat16* kc = p.kc + b * p.kc_sb + h * p.kc_sh;
  const __nv_bfloat16* vc = p.vc + b * p.vc_sb + h * p.vc_sh;
  const __nv_bfloat16* kn = p.kn + b * p.kn_sb + h * p.kn_sh;  // the row's own K at pos
  const __nv_bfloat16* vn = p.vn + b * p.vn_sb + h * p.vn_sh;

  // warp 0 fills a stage: lane r copies the tile's row r of K and of V;
  // rows past the slice repeat its last row, which the scores then mask
  auto fill = [&](int tile) {
    const int s = tile % kStages;
    uint4* ks = ring + s * kStageChunks;
    if (lane == 0) hopper::mbar_expect_tx(&full[s], 2 * kTile * kRow);
    __syncwarp();
    const int row = min(start + tile * kTile + lane, stop - 1);
    const bool own = row == pos;
    bulk_copy(ks + lane * RS, own ? kn : kc + row * p.kc_st, kRow, &full[s]);
    bulk_copy(ks + (kTile + lane) * RS, own ? vn : vc + row * p.vc_st, kRow, &full[s]);
  };
  if (warp == 0) {
    for (int t = 0; t < kStages - 1 && t < tiles; ++t) fill(t);
  }

  // Q as the A operand: row g = lane / 4 (zero past G), columns 2 (lane % 4), + 1
  const int g = lane / 4, c2 = (lane % 4) * 2;
  uint32_t qa[KS][2];
  {
    const __nv_bfloat16* qrow = p.q + b * p.q_sb + static_cast<int64_t>(h * G + g) * p.q_sh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + c2) : 0u;
      qa[ks][1] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 8 + c2) : 0u;
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m = -INFINITY, l = 0.f;  // row g's running max and sum over this warp's rows

  for (int tile = 0; tile < tiles; ++tile) {
    __syncthreads();  // every warp is done with the stage the next fill overwrites
    if (warp == 0 && tile + kStages - 1 < tiles) {
      hopper::fence_proxy_async();
      fill(tile + kStages - 1);
    }
    const int s = tile % kStages;
    hopper::mbar_wait(&full[s], (tile / kStages) & 1);
    const uint4* ksm = ring + s * kStageChunks + warp * 8 * RS;  // this warp's 8 rows
    const uint4* vsm = ksm + kTile * RS;

    float sc[4] = {0.f, 0.f, 0.f, 0.f};  // S: row g, this warp's rows c2 and c2 + 1
#pragma unroll
    for (int ks = 0; ks < KS; ks += 2) {
      if (ks + 1 < KS) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ksm + (lane % 8) * RS + 2 * ks + lane / 8);
        mma_k16(sc, qa[ks][0], qa[ks][1], kb[0], kb[1]);
        mma_k16(sc, qa[ks + 1][0], qa[ks + 1][1], kb[2], kb[3]);
      } else {
        uint32_t kb[2];
        ldmatrix_x2(kb, ksm + (lane % 8) * RS + 2 * ks + (lane / 8) % 2);
        mma_k16(sc, qa[ks][0], qa[ks][1], kb[0], kb[1]);
      }
    }

    // the online softmax of row g over this warp's 8 rows, in f32: a quad of
    // lanes holds a row
    const int row = start + tile * kTile + warp * 8 + c2;
    const float s0 = row < stop ? sc[0] * p.scale : -INFINITY;
    const float s1 = row + 1 < stop ? sc[1] * p.scale : -INFINITY;
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;  // a warp with no row yet
    const float p0 = __expf(s0 - base), p1 = __expf(s1 - base);
    const float alpha = __expf(m - base);  // 0 before this warp's first row
    float sum = p0 + p1;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    const uint32_t pa = pack_bf16(p0, p1);  // P in bf16, as the A operand of P.V

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha;
      acc[nt][1] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 4) {
      if (nt + 3 < NT) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vsm + (lane % 8) * RS + nt + lane / 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_k8(acc[nt + j], pa, vb[j]);
      } else {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vsm + (lane % 8) * RS + nt + (lane / 8) % 2);
        mma_k8(acc[nt], pa, vb[0]);
        mma_k8(acc[nt + 1], pa, vb[1]);
      }
    }
  }

  // merge the four warps: each writes its rows' O, m and l to shared memory
  // (the ring, every copy consumed), then a thread a (head, 8 columns) sums
  __syncthreads();
  constexpr int kRed = kD + 4;  // a padded row of O, in floats
  float* red = reinterpret_cast<float*>(ring);       // (4 warps, 8 rows, kRed)
  float* ml = red + 4 * 8 * kRed;                    // (4 warps, 8 rows, 2)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(red + (warp * 8 + g) * kRed + nt * 8 + c2) =
        make_float2(acc[nt][0], acc[nt][1]);
  }
  if (lane % 4 == 0) {
    ml[(warp * 8 + g) * 2] = m;
    ml[(warp * 8 + g) * 2 + 1] = l;
  }
  __syncthreads();
  constexpr int CH = kD / 8;
  if (tid >= G * CH) return;
  const int og = tid / CH, oc = tid % CH;
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < 4; ++w) mb = fmaxf(mb, ml[(w * 8 + og) * 2]);
  float lb = 0.f, o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // in order: the same sums every run
    const float mw = ml[(w * 8 + og) * 2];
    if (mw == -INFINITY) continue;  // a warp that saw no row of the slice
    const float wt = __expf(mw - mb);
    lb = fmaf(wt, ml[(w * 8 + og) * 2 + 1], lb);
    const float* src = red + (w * 8 + og) * kRed + oc * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaf(wt, src[i], o[i]);
  }
  if (p.splits == 1) {
    uint4 packed;
    packed.x = pack_bf16(o[0] / lb, o[1] / lb);
    packed.y = pack_bf16(o[2] / lb, o[3] / lb);
    packed.z = pack_bf16(o[4] / lb, o[5] / lb);
    packed.w = pack_bf16(o[6] / lb, o[7] / lb);
    const int64_t head = static_cast<int64_t>(b) * p.hkv * G + h * G + og;
    reinterpret_cast<uint4*>(p.out + head * kD)[oc] = packed;
    return;
  }
  float4* dst = reinterpret_cast<float4*>(p.part_acc + (slot * G + og) * kD + oc * 8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  if (oc == 0) {
    p.part_ml[(slot * G + og) * 2] = mb;
    p.part_ml[(slot * G + og) * 2 + 1] = lb;
  }
}

// The slices' partials of one (batch row, K/V head) merged: a thread a
// (head, 8 columns), the slices in order.
__global__ void __launch_bounds__(kThreads) decode_attention_merge(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = p.g, D = p.d, CH = D / 8;
  if (tid >= G * CH) return;
  const int g = tid / CH, c = tid % CH;
  const int64_t base = (static_cast<int64_t>(b) * p.hkv + h) * p.splits;
  float m = -INFINITY;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, p.part_ml[((base + s) * G + g) * 2]);
  float l = 0.f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const int64_t at = (base + s) * G + g;
    const float ms = p.part_ml[at * 2];
    if (ms == -INFINITY) continue;  // an empty slice wrote nothing else
    const float w = __expf(ms - m);
    l = fmaf(w, p.part_ml[at * 2 + 1], l);
    const float4* src = reinterpret_cast<const float4*>(p.part_acc + at * D + c * 8);
    const float4 x = src[0], y = src[1];
    acc[0] = fmaf(w, x.x, acc[0]);
    acc[1] = fmaf(w, x.y, acc[1]);
    acc[2] = fmaf(w, x.z, acc[2]);
    acc[3] = fmaf(w, x.w, acc[3]);
    acc[4] = fmaf(w, y.x, acc[4]);
    acc[5] = fmaf(w, y.y, acc[5]);
    acc[6] = fmaf(w, y.z, acc[6]);
    acc[7] = fmaf(w, y.w, acc[7]);
  }
  uint4 packed;
  packed.x = pack_bf16(acc[0] / l, acc[1] / l);
  packed.y = pack_bf16(acc[2] / l, acc[3] / l);
  packed.z = pack_bf16(acc[4] / l, acc[5] / l);
  packed.w = pack_bf16(acc[6] / l, acc[7] / l);
  const int64_t head = static_cast<int64_t>(b) * p.hkv * G + h * G + g;
  reinterpret_cast<uint4*>(p.out + head * D)[c] = packed;
}

template <int kD>
int launch(const Params& p, int batch, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  const int bytes = static_cast<int>(smem_bytes(kD));
  const int err = hopper_host::allow_smem(decode_attention_kernel<kD>, bytes, raised);
  if (err) return err;
  decode_attention_kernel<kD><<<dim3(p.splits, p.hkv, batch), kThreads, bytes, s>>>(p);
  if (p.splits > 1) decode_attention_merge<<<dim3(p.hkv, batch), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One decode attention. Pointers are device pointers; `strides` is a host
// array of 13 element strides: q's (batch, head), the K cache's (batch,
// position, head), the V cache's (batch, position, head), the new K's
// (batch, head), the new V's (batch, head) and the positions'. Every row
// of D elements is contiguous and 16-byte aligned (the wrapper checks).
// pos64: the positions are int64 (else int32). part_acc and part_ml are
// the slices' scratch, unused (may be null) with one slice. Launches on
// `stream` without synchronising and returns the launch's CUDA error.
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const void* k_new, const void* v_new, const void* pos,
                                       void* out, void* part_acc, void* part_ml,
                                       const long long* strides, int batch, int t, int hkv, int g,
                                       int d, int pos64, int splits, int chunk, void* stream) {
  if ((d != 16 && d != 64 && d != 96 && d != 112 && d != kMaxD) || g < 1 || g > kMaxG ||
      splits < 1 || chunk < 1 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      static_cast<int64_t>(splits - 1) * chunk >= t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = static_cast<const __nv_bfloat16*>(k_cache);
  p.vc = static_cast<const __nv_bfloat16*>(v_cache);
  p.kn = static_cast<const __nv_bfloat16*>(k_new);
  p.vn = static_cast<const __nv_bfloat16*>(v_new);
  p.pos = pos;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.kc_sb = strides[2];
  p.kc_st = strides[3];
  p.kc_sh = strides[4];
  p.vc_sb = strides[5];
  p.vc_st = strides[6];
  p.vc_sh = strides[7];
  p.kn_sb = strides[8];
  p.kn_sh = strides[9];
  p.vn_sb = strides[10];
  p.vn_sh = strides[11];
  p.pos_s = strides[12];
  p.t = t;
  p.hkv = hkv;
  p.g = g;
  p.d = d;
  p.pos64 = pos64;
  p.splits = splits;
  p.chunk = chunk;
  p.scale = 1.0f / std::sqrt(static_cast<float>(d));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(p, batch, s);
    case 64: return launch<64>(p, batch, s);
    case 96: return launch<96>(p, batch, s);
    case 112: return launch<112>(p, batch, s);
    default: return launch<128>(p, batch, s);
  }
}
