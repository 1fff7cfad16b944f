// Kernel #2 with narrow slices: the fused Ozaki-slice GEMM at KLIMBS limbs
// (2 = dd, 3 = td, 4 = qd) whose slices are bf16, f16 or f32, the Rgemm
// epilogue fused into its drain, with an optional batch grid axis.
//
// Replaces the narrow branch of the Pallas kernel repro/kernels/ozgemm.py
// (_slab_update with slice_dtype != limb dtype: the pair dots in the
// accumulator dtype and the per-diagonal rescale; its slicing,
// _extract_slices and _normalize_slices of repro/core/ozaki.py, is the
// pre-pass csrc/ozslice.cu), which is the configuration the TPU kernel was
// written for: bf16 slices with f32 accumulation on the MXU.  The build
// compiles this file once per limb count and variant (-DKLIMBS=2|3|4
// -DOZ_VARIANT=0..3, kernels/_build.py), each library holding one variant.
//
// What it computes, per 64x64 output tile and per K slab of depth bk, from
// the pre-pass's workspace (slices normalized per row of A and column of
// B, each slice i stored as s * 2^(i*beta) / sc in the slice type, and
// the scales sc): for each diagonal d, the pair dots of slices s + t = d
// summed in the accumulator type, then dsum (as f64) * ((sc_a * sc_b) *
// 2^(-d*beta)) in that order, folded into the k-limb accumulator as in
// ozgemm.cu.  The drain is ozgemm.cu's.  The plain version is ozgemm_plain
// in repro_torch/kernels/ozgemm.py with the same slice and accumulator
// types.
//
// The pair dots, by variant (slice type / accumulator type), all on the
// tensor cores:
//   * bf16 / f32, and f32 / f32 (whose <= 11-bit slices the workspace
//     holds as f16, exactly; the wrapper's f16 / f32 pair is the same
//     code): mma.sync.m16n8k16 bf16 x bf16 -> f32, or f16 x f16 -> f32, on
//     fragments loaded with ldmatrix, two pairs at a time, each MMA issued
//     with a zero C fragment and its result added into the diagonal's
//     running f32 sum with an IEEE add.  One MMA sums at most 16 products
//     of at most 2*beta bits on one grid, and its sum, like every partial
//     sum of a diagonal, fits the f32 significand by the slice_params
//     headroom 2*beta + ceil(log2 bk) + ceil(log2 n_slices) <= 24: every
//     order gives the plain version's bits.  Nothing leans on how the
//     tensor core rounds inside an accumulation it was never asked to
//     make.  bf16 plans stop at beta 8; f16 ones reach 11, and
//     chip_smoke.py phase 2 holds a beta = 9 case on the f16 MMA exact on
//     the card.
//   * bf16 / f64: the same bf16 MMAs and IEEE f32 adds, in f32 groups of
//     at most `group` MMA results (kernels/ozgemm.py f32_group:
//     group * 16 * 2^(2*beta) <= 2^24, so each group's sum is exact in
//     f32), each closed group added into the diagonal's f64 sum with one
//     IEEE f64 add (exact by the f64 headroom, the same sum <= 53).  A
//     diagonal whose MMA results fit one group (every diagonal at dd: bk
//     16, 15 slices, group 16) runs bf16/f32's loop and one widening.
//   * f32 / f64: the f64 tensor cores, mma.sync.m16n8k4 (oz_device.cuh
//     f64_pairs, csrc/ozgemm.cu's loop) on the f32 slices widened exactly
//     to f64 as they load, the diagonal summed through the C fragments
//     (exact by the f64 headroom, as for f64 slices).
//
// Bound on the H100: the 16-bit dots are n_pairs * 2 * m * n * bk flops
// per slab at 989e12 flop/s, the f32 / f64 dots n_pairs * m * n * bk
// multiply-adds at DMMA's 33.5e12 per second; the f64 work of the rescale
// and folds (three times the f64-slice kernel's diagonals for 16-bit
// slices; bf16 / f64 adds a DADD per f32 group) is the larger part at
// every tier for 16-bit slices, against 17e12 f64 instructions per second
// (chip_smoke.py counts both, the pre-pass's extraction in the f64 part).
//
// Design: one CTA of 8 warps per 64x64 output tile (oz_device.cuh
// nt_of), every thread in every phase.  The
// slices stream from the workspace into shared memory with cp.async, one
// stage per slab (a stage being the slab's slices of the tile's 64 rows
// and 64 columns, K contiguous and padded by 8 elements so that the
// fragment loads hit 32 distinct banks, and their scales): two stages
// where two fit, so slab j + 1 lands while slab j is dotted and folded,
// else one.  Warp w owns rows 16*(w % 4) .. +16 and NT m16n8
// tiles from column 8*NT*(w / 4) on; each thread holds its 4*NT outputs in
// the mma C-fragment layout (oz_device.cuh frag_row/frag_col), the same
// for every variant and for ozgemm.cu, so the rescale, fold and drain are
// shared.  sc_a * sc_b is formed once per output per slab.
// A K panel (kernels/ozgemm.py walks K in panels when the workspace
// outgrows its budget) starts from the accumulator the previous panel
// stored, and only the last one drains with the epilogue.
#include <cuda_runtime.h>

#include <stdint.h>

#include "oz_device.cuh"

#ifndef OZ_VARIANT
#error "build with -DOZ_VARIANT=0, 1, 2 or 3"
#endif

namespace {

using namespace oz;

// D = A * B + 0 for one m16n8k16 tile of 16-bit slices (bf16 or f16 in,
// f32 out).
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8: r[m] receives row g, elements 2q, 2q + 1 of
// matrix m (lane = 4g + q), the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void *row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A diagonal summed in one f32 group (an f32 accumulator, or a bf16 / f64
// diagonal whose MMA results fit one): nothing to close.
template <int NT>
struct OneGroup {
  template <int U>
  __device__ __forceinline__ void step(float (&)[2][2 * NT]) {}
};

// A diagonal's sums with an f64 accumulator (bf16 / f64): f32 groups of at
// most `cap` MMA results (n so far), each closed into the f64 sums with
// an IEEE f64 add.  cap >= PAIRS (kernels/ozgemm.py f32_group), so a step
// of U <= PAIRS results never overfills a group.
template <int NT>
struct F64Groups {
  double sum[2][2 * NT];
  int cap, n;
  __device__ __forceinline__ void close(float (&gs)[2][2 * NT]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) {
        sum[i][jj] = __dadd_rn(sum[i][jj], (double)gs[i][jj]);
        gs[i][jj] = 0.0f;
      }
    n = 0;
  }
  template <int U>
  __device__ __forceinline__ void step(float (&gs)[2][2 * NT]) {
    n += U;
    if (n + PAIRS > cap) close(gs);
  }
};

// The 16-bit dots of U pairs (s, d - s), (s + 1, d - s - 1), ... added
// into the diagonal's f32 sums gs: per 16-deep step, every fragment loaded
// first, then every MMA, then every add, so that a warp keeps U * NT MMAs
// in flight (the sums are exact in any order); then the group's step.
template <typename T, int NT, int U, typename G>
__device__ __forceinline__ void pairs16(float (&gs)[2][2 * NT], G &grp, const T *sa,
                                        const T *sb, int s, int d, int ks, int kp) {
  // ldmatrix rows: A's m16 x k16 block as (rows 0-7, 8-15) x (k 0-7,
  // 8-15); B's n8 tiles two at a time as (tile j, j + 1) x (k 0-7, 8-15)
  const int l = threadIdx.x % 32;
  const int wr = 16 * (threadIdx.x / 32 % 4), wc = 8 * NT * (threadIdx.x / 128);
  const int ra = wr + l % 16, ka = 8 * (l / 16);
  const int rb = wc + l % 8 + 8 * (l / 16), kb8 = 8 * (l / 8 % 2);
  for (int kb = 0; kb < kp; kb += 16) {
    uint32_t a[U][4], b[U][NT][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ldmatrix_x4(a[u], sa + ((size_t)(s + u) * BM + ra) * ks + kb + ka);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + ((size_t)(d - s - u) * BN + rb + 8 * j) * ks + kb + kb8);
        b[u][j][0] = r[0];
        b[u][j][1] = r[1];
        b[u][j + 1][0] = r[2];
        b[u][j + 1][1] = r[3];
      }
    }
    float p[U][NT][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma16(p[u][j], a[u], b[u][j][0], b[u][j][1], T());
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        gs[0][2 * j] = __fadd_rn(gs[0][2 * j], p[u][j][0]);
        gs[0][2 * j + 1] = __fadd_rn(gs[0][2 * j + 1], p[u][j][1]);
        gs[1][2 * j] = __fadd_rn(gs[1][2 * j], p[u][j][2]);
        gs[1][2 * j + 1] = __fadd_rn(gs[1][2 * j + 1], p[u][j][3]);
      }
    grp.template step<U>(gs);
  }
}

// The 16-bit dots of a diagonal's pairs s_lo .. s_hi, PAIRS at a time,
// into gs (and the groups of grp).
template <typename T, int NT, typename G>
__device__ __forceinline__ void mma16_pairs(float (&gs)[2][2 * NT], G &grp, const T *sa,
                                            const T *sb, int s_lo, int s_hi, int d, int ks,
                                            int kp) {
  int s = s_lo;
  for (; s + PAIRS <= s_hi + 1; s += PAIRS) pairs16<T, NT, PAIRS>(gs, grp, sa, sb, s, d, ks, kp);
  for (; s <= s_hi; ++s) pairs16<T, NT, 1>(gs, grp, sa, sb, s, d, ks, kp);
}

// One diagonal's exact sums of 16-bit slice dots, as f64: in one f32 sum
// (an f32 accumulator, or a bf16 / f64 diagonal whose MMA results fit one
// f32 group: every diagonal at dd), else in f32 groups closed into f64.
template <int V, int NT>
__device__ __forceinline__ void mma16_diagonal(double (&dsum)[2][2 * NT],
                                               const typename Store<V>::T *sa,
                                               const typename Store<V>::T *sb, int s_lo,
                                               int s_hi, int d, int ks, int kp, int group) {
  float gs[2][2 * NT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) gs[i][jj] = 0.0f;
  if (V != kBf16F64 || (s_hi - s_lo + 1) * (kp / 16) <= group) {
    OneGroup<NT> one;
    mma16_pairs<typename Store<V>::T, NT>(gs, one, sa, sb, s_lo, s_hi, d, ks, kp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) dsum[i][jj] = (double)gs[i][jj];
  } else if constexpr (V == kBf16F64) {
    F64Groups<NT> grp;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) grp.sum[i][jj] = 0.0;
    grp.cap = group;
    grp.n = 0;
    mma16_pairs<typename Store<V>::T, NT>(gs, grp, sa, sb, s_lo, s_hi, d, ks, kp);
    if (grp.n > 0) grp.close(gs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) dsum[i][jj] = grp.sum[i][jj];
  }
}

// One slab from one stage: each diagonal's exact sum, rescaled and folded
// once, most significant first.
template <int V, int NT>
__device__ __forceinline__ void slab_update(double (&acc)[2][2 * NT][K], const unsigned char *stage,
                                            int ks, int kp, int beta, int n_slices, int n_diag,
                                            int group) {
  using T = typename Store<V>::T;
  const T *sa = reinterpret_cast<const T *>(stage);  // [n_slices][BM][ks]
  const T *sb = sa + (size_t)n_slices * BM * ks;     // [n_slices][BN][ks]
  const double *sc = reinterpret_cast<const double *>(sb + (size_t)n_slices * BN * ks);
  double scab[2][2 * NT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj)
      scab[i][jj] = dd::mul(sc[frag_row(i)], sc[BM + frag_col<NT>(jj)]);
  for (int d = 0; d < n_diag; ++d) {
    const int s_lo = max(0, d - n_slices + 1), s_hi = min(d, n_slices - 1);
    double dsum[2][2 * NT];
    if constexpr (V == kF32F64)
      dmma_diagonal<T, NT>(dsum, sa, sb, s_lo, s_hi, d, ks, kp);
    else
      mma16_diagonal<V, NT>(dsum, sa, sb, s_lo, s_hi, d, ks, kp, group);
    const double p2 = dd::pow2(-d * beta);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj)
        fold(acc[i][jj], dd::mul(dsum[i][jj], dd::mul(scab[i][jj], p2)));
  }
}

template <int V, bool BATCHED, int STAGES>
__global__ void __launch_bounds__(threads_of(V))
ozgemm_narrow_kernel(const typename Store<V>::T *__restrict__ wa,
                     const double *__restrict__ sca,
                     const typename Store<V>::T *__restrict__ wb,
                     const double *__restrict__ scb, const double *__restrict__ alpha,
                     const double *__restrict__ beta_s, In c, Out o, int m, int n,
                     int nslab, int bk, int beta, int n_slices, int n_diag, int group,
                     int epilogue, int flags, long long swa, long long swb,
                     long long stride_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = kstride(bk, V), kp = kdepth(bk, V);
  const int rpa = rows_padded(m), rpb = rows_padded(n);
  const int sbytes = stage_bytes(bk, n_slices, V);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long zo = BATCHED ? blockIdx.z * (long long)m * n : 0;
  // this entry's workspace: slab j's slices start j * n_slices * rows * kp
  // on, its scales j * rows on
  const auto *ea = wa + (BATCHED ? blockIdx.z * swa : 0);
  const auto *eb = wb + (BATCHED ? blockIdx.z * swb : 0);
  const double *eca = sca + (BATCHED && swa ? blockIdx.z * (long long)nslab * rpa : 0);
  const double *ecb = scb + (BATCHED && swb ? blockIdx.z * (long long)nslab * rpb : 0);
  const long long slab_a = (long long)n_slices * rpa * kp, slab_b = (long long)n_slices * rpb * kp;

  constexpr int NT = nt_of(V);
  double acc[2][2 * NT][K];
  start_acc<NT>(acc, flags, o, zo, row0, col0, m, n);
  auto load = [&](int j) {
    load_stage(smem_raw + (STAGES == 2 ? (j & 1) * sbytes : 0), ea + j * slab_a,
               eca + (long long)j * rpa, eb + j * slab_b, ecb + (long long)j * rpb, kp, ks,
               n_slices, rpa, rpb, row0, col0);
    cp_async_commit();
  };
  if (STAGES == 2 && nslab > 0) load(0);
  for (int j = 0; j < nslab; ++j) {
    if (STAGES == 2) {
      if (j + 1 < nslab) load(j + 1);
      else cp_async_commit();  // an empty group keeps the count
      cp_async_wait<1>();
    } else {
      load(j);
      cp_async_wait<0>();
    }
    __syncthreads();
    slab_update<V, NT>(acc, smem_raw + (STAGES == 2 ? (j & 1) * sbytes : 0), ks, kp, beta,
                       n_slices, n_diag, group);
    __syncthreads();
  }
  drain_tile<NT>(acc, alpha, beta_s, epilogue, flags, c,
             BATCHED ? blockIdx.z * stride_c : 0, o, zo, row0, col0, m, n);
}

}  // namespace

// Shared memory one CTA needs for a slab depth, slice count and variant
// (0 bf16/f32, 1 f32/f32, 2 bf16/f64, 3 f32/f64).
extern "C" int ozgemm_narrow_smem_bytes(int bk, int n_slices, int variant) {
  return smem_bytes(bk, n_slices, variant);
}

// out = epilogue(A @ B) at KLIMBS limbs over `batch` entries, from the
// pre-pass's workspaces of A and B (csrc/ozslice.cu) with the slices of
// `variant`, which must be this library's OZ_VARIANT: wa, sca and wb, scb
// hold the slices and scales of `nslab` K slabs of depth bk, entry z of
// A's at z * swa elements (0: one workspace shared by every entry; its
// scales likewise), of B's at z * swb.  c and o point at KLIMBS limb pointers (host arrays; c may hold
// nulls unless the epilogue is 2 on the last panel); C and out (m, n) per
// entry, row-major contiguous f64 on the device, entry z of C at
// z * stride_c, of out at z * m * n.  alpha and beta_s point at KLIMBS
// limbs each.  epilogue: 0 none, 1 alpha, 2 full.  flags (oz_device.cuh
// PanelFlags): 1 start from the accumulator in out, 2 the last panel
// (drain with the epilogue; otherwise store the raw accumulator).  group:
// bf16 / f64 only, the MMA results one f32 group sums (kernels/ozgemm.py
// f32_group, at least PAIRS).  Launches on `stream`; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ozgemm_narrow(const void *wa, const double *sca, const void *wb,
                             const double *scb, const double *alpha,
                             const double *beta_s, const double *const *c,
                             double *const *o, int m, int n, int nslab, int batch,
                             long long swa, long long swb, long long stride_c, int bk,
                             int beta, int n_slices, int n_diag, int epilogue, int flags,
                             int variant, int group, cudaStream_t stream) {
  if (n_slices < 1 || bk < 1 || nslab < 0 || variant != OZ_VARIANT ||
      (variant == kBf16F64 && group < PAIRS))
    return (int)cudaErrorInvalidValue;
  using T = typename Store<OZ_VARIANT>::T;
  In ci;
  Out oo;
  for (int l = 0; l < K; ++l) {
    ci.p[l] = c[l];
    oo.p[l] = o[l];
  }
  const int smem = ozgemm_narrow_smem_bytes(bk, n_slices, variant);
  const bool two = stages(bk, n_slices, variant) == 2;
  auto kernel = batch > 1 ? (two ? ozgemm_narrow_kernel<OZ_VARIANT, true, 2>
                                 : ozgemm_narrow_kernel<OZ_VARIANT, true, 1>)
                          : (two ? ozgemm_narrow_kernel<OZ_VARIANT, false, 2>
                                 : ozgemm_narrow_kernel<OZ_VARIANT, false, 1>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kernel<<<grid, threads_of(OZ_VARIANT), smem, stream>>>(
      static_cast<const T *>(wa), sca, static_cast<const T *>(wb), scb, alpha, beta_s, ci,
      oo, m, n, nslab, bk, beta, n_slices, n_diag, group, epilogue, flags, swa, swb,
      stride_c);
  return (int)cudaGetLastError();
}
