// Kernel #2 with narrow slices: the fused Ozaki-slice GEMM at KLIMBS limbs
// (2 = dd, 3 = td, 4 = qd) whose slices are bf16 or f32, the Rgemm
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
// The pair dots, by variant (slice type / accumulator type):
//   * bf16 / f32: the tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32
//     on fragments loaded with ldmatrix, two pairs at a time, each MMA
//     issued with a zero C fragment and its result added into the
//     diagonal's running f32 sum with an IEEE add.  One MMA sums 16
//     products of at most 2*beta = 16 bits on one grid (at most 20 bits, so
//     exact however the unit aligns them), and every partial sum of a
//     diagonal fits the f32 significand by the slice_params headroom
//     2*beta + ceil(log2 bk) + ceil(log2 n_slices) <= 24: every order gives
//     the plain version's bits.  Nothing leans on how the tensor core
//     rounds inside an accumulation it was never asked to make.
//   * f32 / f32: FFMA on the CUDA cores (exact products, exact sums by the
//     same headroom).  beta <= 11 with an f32 accumulator, so the slices are
//     kept as f16, which holds every one of them exactly.
//   * bf16 / f64 and f32 / f64: DFMA on the slices widened exactly to f64.
//
// Bound on the H100: the tensor-core dots are n_pairs * 2 * m * n * bk
// flops per slab at 989e12 bf16 flop/s; the f64 work of the rescale and
// folds (three times the f64-slice kernel's diagonals) is the larger part
// at every tier, against 17e12 f64 instructions per second (chip_smoke.py
// counts both, the pre-pass's extraction in the f64 part).
//
// Design: one CTA of 8 warps per 64x64 output tile (oz_device.cuh
// nt_of), every thread in every phase.  The
// slices stream from the workspace into shared memory with cp.async, one
// stage per slab (a stage being the slab's slices of the tile's 64 rows
// and 64 columns, K contiguous and padded by 8 elements so that the
// fragment loads hit 32 distinct banks, and their scales): two stages
// where two fit (dd), so slab j + 1 lands while slab j is dotted and
// folded, else one.  Warp w owns rows 16*(w % 4) .. +16 and NT m16n8
// tiles from column 8*NT*(w / 4) on; each thread holds its 4*NT outputs in
// the mma C-fragment layout (oz_device.cuh frag_row/frag_col), the same
// for every variant and for ozgemm.cu, so the rescale, fold and drain are
// shared.  sc_a * sc_b is formed once per output per slab.
// A K panel (kernels/ozgemm.py walks K in panels when the workspace
// outgrows its budget) starts from the accumulator the previous panel
// stored, and only the last one drains with the epilogue.
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "oz_device.cuh"

#ifndef OZ_VARIANT
#error "build with -DOZ_VARIANT=0, 1, 2 or 3"
#endif

namespace {

using namespace oz;

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(float x) { return x; }

// D = A * B + 0 for one m16n8k16 tile (bf16 in, f32 out).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
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

// Pair dots taken U pairs at a time in the bf16 variant's pair loop.
constexpr int PAIRS = 2;

// The bf16 dots of U pairs (s, d - s), (s + 1, d - s - 1), ... added into
// the diagonal's f32 sums: every fragment loaded first, then every MMA,
// then every add, so that a warp keeps U * NT MMAs in flight (the sums
// are exact in any order).
template <int NT, int U>
__device__ __forceinline__ void bf16_pairs(float (&ds)[2][2 * NT], const __nv_bfloat16 *sa,
                                           const __nv_bfloat16 *sb, int s, int d, int ks,
                                           int kp) {
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
      for (int j = 0; j < NT; ++j)
        mma_bf16(p[u][j], a[u][0], a[u][1], a[u][2], a[u][3], b[u][j][0], b[u][j][1]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ds[0][2 * j] = __fadd_rn(ds[0][2 * j], p[u][j][0]);
        ds[0][2 * j + 1] = __fadd_rn(ds[0][2 * j + 1], p[u][j][1]);
        ds[1][2 * j] = __fadd_rn(ds[1][2 * j], p[u][j][2]);
        ds[1][2 * j + 1] = __fadd_rn(ds[1][2 * j + 1], p[u][j][3]);
      }
  }
}

// One slab from one stage: each diagonal's exact sum in the accumulator
// type, rescaled and folded once, most significant first.
template <int V, int NT>
__device__ __forceinline__ void slab_update(double (&acc)[2][2 * NT][K], const unsigned char *stage,
                                            int ks, int kp, int kd, int beta, int n_slices,
                                            int n_diag) {
  using T = typename Store<V>::T;
  using Acc = typename std::conditional<V == kBf16F32 || V == kF32F32, float,
                                        double>::type;
  const T *sa = reinterpret_cast<const T *>(stage);  // [n_slices][BM][ks]
  const T *sb = sa + (size_t)n_slices * BM * ks;     // [n_slices][BN][ks]
  const double *sc = reinterpret_cast<const double *>(sb + (size_t)n_slices * BN * ks);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = 16 * (warp % 4), wc = 8 * NT * (warp / 4);
  double scab[2][2 * NT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj)
      scab[i][jj] = dd::mul(sc[frag_row(i)], sc[BM + frag_col<NT>(jj)]);
  for (int d = 0; d < n_diag; ++d) {
    Acc ds[2][2 * NT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) ds[i][jj] = 0;
    const int s_lo = max(0, d - n_slices + 1), s_hi = min(d, n_slices - 1);
    if constexpr (V == kBf16F32) {
      int s = s_lo;
      for (; s + PAIRS <= s_hi + 1; s += PAIRS) bf16_pairs<NT, PAIRS>(ds, sa, sb, s, d, ks, kp);
      for (; s <= s_hi; ++s) bf16_pairs<NT, 1>(ds, sa, sb, s, d, ks, kp);
    } else {
      for (int s = s_lo; s <= s_hi; ++s) {
        const T *pa = sa + ((size_t)s * BM + wr + g) * ks;
        const T *pb = sb + ((size_t)(d - s) * BN + wc + g) * ks;
        // rows g, g + 8 of the warp's block; columns 8(jj/2) + 2q + jj%2
        for (int kk = 0; kk < kd; ++kk) {
          Acc av[2], bv[2 * NT];
          av[0] = (Acc)widen(pa[kk]);
          av[1] = (Acc)widen(pa[8 * ks + kk]);
#pragma unroll
          for (int jj = 0; jj < 2 * NT; ++jj)
            bv[jj] = (Acc)widen(pb[(size_t)(8 * (jj / 2) + 2 * q + jj % 2 - g) * ks + kk]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2 * NT; ++jj) ds[i][jj] = fma(av[i], bv[jj], ds[i][jj]);
        }
      }
    }
    const double p2 = dd::pow2(-d * beta);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj)
        fold(acc[i][jj], dd::mul((double)ds[i][jj], dd::mul(scab[i][jj], p2)));
  }
}

template <int V, bool BATCHED, int STAGES>
__global__ void __launch_bounds__(threads_of(V))
ozgemm_narrow_kernel(const typename Store<V>::T *__restrict__ wa,
                     const double *__restrict__ sca,
                     const typename Store<V>::T *__restrict__ wb,
                     const double *__restrict__ scb, const double *__restrict__ alpha,
                     const double *__restrict__ beta_s, In c, Out o, int m, int n,
                     int k, int nslab, int bk, int beta, int n_slices, int n_diag,
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
    const int kd = min(bk, k - j * bk);
    slab_update<V, NT>(acc, smem_raw + (STAGES == 2 ? (j & 1) * sbytes : 0), ks, kp, kd, beta,
                   n_slices, n_diag);
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
// hold the slices and scales of `nslab` K slabs of depth bk (the panel
// [k0, k0 + k), k its depth), entry z of A's at z * swa elements (0: one
// workspace shared by every entry; its scales likewise), of B's at
// z * swb.  c and o point at KLIMBS limb pointers (host arrays; c may hold
// nulls unless the epilogue is 2 on the last panel); C and out (m, n) per
// entry, row-major contiguous f64 on the device, entry z of C at
// z * stride_c, of out at z * m * n.  alpha and beta_s point at KLIMBS
// limbs each.  epilogue: 0 none, 1 alpha, 2 full.  flags (oz_device.cuh
// PanelFlags): 1 start from the accumulator in out, 2 the last panel
// (drain with the epilogue; otherwise store the raw accumulator).
// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success).
extern "C" int ozgemm_narrow(const void *wa, const double *sca, const void *wb,
                             const double *scb, const double *alpha,
                             const double *beta_s, const double *const *c,
                             double *const *o, int m, int n, int k, int nslab,
                             int batch, long long swa, long long swb,
                             long long stride_c, int bk, int beta, int n_slices,
                             int n_diag, int epilogue, int flags, int variant,
                             cudaStream_t stream) {
  if (n_slices < 1 || bk < 1 || nslab < 0 || variant != OZ_VARIANT)
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
      oo, m, n, k, nslab, bk, beta, n_slices, n_diag, epilogue, flags, swa, swb, stride_c);
  return (int)cudaGetLastError();
}
