// Kernel #2 with narrow slices: the fused Ozaki-slice GEMM at KLIMBS limbs
// (2 = dd, 3 = td, 4 = qd) whose slices are bf16 or f32, the Rgemm
// epilogue fused into its drain, with an optional batch grid axis.
//
// Replaces the narrow branch of the Pallas kernel repro/kernels/ozgemm.py
// (_slab_update with slice_dtype != limb dtype: _normalize_slices of
// repro/core/ozaki.py, the pair dots in the accumulator dtype, the
// per-diagonal rescale), which is the configuration the TPU kernel was
// written for: bf16 slices with f32 accumulation on the MXU.  The build
// compiles this file once per limb count and variant (-DKLIMBS=2|3|4
// -DOZ_VARIANT=0..3, kernels/_build.py), each library holding one variant.
//
// What it computes, per 64x64 output tile and per K slab of depth bk:
//   1. per row of the A slab (column of B): the anchor sigma from the max
//      |limb 0| as in csrc/ozgemm.cu, then sc = pow2_near(max |slice 0|),
//      the scale of _normalize_slices;
//   2. n_slices error-free slices per element on the anchor ladder, each
//      stored in shared memory as slice(s * 2^(i*beta) / sc): the power of
//      two scalings are exact (x / sc and x * (1 / sc) are the same
//      correctly rounded number, 1 / sc being exact), and the conversion to
//      the slice type rounds as torch's .to() does (f64 -> f32 -> bf16);
//   3. per diagonal d, the pair dots of slices s + t = d summed in the
//      accumulator type, then dsum (as f64) * ((sc_a * sc_b) * 2^(-d*beta))
//      in that order, folded into the k-limb accumulator as in ozgemm.cu.
// The drain is csrc/ozgemm.cu's.  The plain version is ozgemm_plain in
// repro_torch/kernels/ozgemm.py with the same slice and accumulator types.
//
// The pair dots, by variant (slice type / accumulator type):
//   * bf16 / f32: the tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32,
//     each MMA issued with a zero C fragment and its result added into the
//     diagonal's running f32 sum with an IEEE add.  One MMA sums 16
//     products of at most 2*beta = 16 bits on one grid (at most 20 bits, so
//     exact however the unit aligns them), and every partial sum of a
//     diagonal fits the f32 significand by the slice_params headroom
//     2*beta + ceil(log2 bk) + ceil(log2 n_slices) <= 24: every order gives
//     the plain version's bits.  Nothing leans on how the tensor core
//     rounds inside an accumulation it was never asked to make.
//   * f32 / f32: FFMA on the CUDA cores (exact products, exact sums by the
//     same headroom).  beta <= 11 with an f32 accumulator, so the slices are
//     kept as f16, which holds every one of them exactly: 32 qd slices then
//     fit shared memory.
//   * bf16 / f64 and f32 / f64: DFMA on the slices widened exactly to f64.
//
// Bound on the H100: the tensor-core dots are n_pairs * 2 * m * n * bk
// flops per slab at 989e12 bf16 flop/s; the f64 work (extraction, rescale
// and folds, three times the f64-slice kernel's diagonals) is the larger
// part at every tier, against 17e12 f64 instructions per second
// (chip_smoke.py counts both).
//
// Design: one CTA of 256 threads (8 warps) per 64x64 output tile.  Warp w
// owns rows 16*(w % 4) .. +16 and columns 32*(w / 4) .. +32, four m16n8
// tiles; each thread holds its 16 outputs in the mma C-fragment layout
// (rows g and g + 8, columns 8j + 2q and 8j + 2q + 1 for lane = 4g + q),
// the same for every variant, so the rescale, fold and drain are shared.
// Slices sit in shared memory row-major with K contiguous
// ([slice][row][k] for A, [slice][column][k] for B), the slab depth
// rounded up to 16 (zero-filled) and padded by 8 elements so that the
// fragment loads hit 32 distinct banks.  Ragged edges are masked; a masked
// entry slices to zero, which equals the reference's zero padding.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "oz_device.cuh"

#ifndef OZ_VARIANT
#error "build with -DOZ_VARIANT=0, 1, 2 or 3"
#endif

namespace {

using namespace oz;

constexpr int THREADS = 256;

// How a variant keeps its slices in shared memory.
template <int V>
struct Store;
template <>
struct Store<kBf16F32> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T put(double x) {
    return __float2bfloat16_rn(__double2float_rn(x));
  }
};
template <>
struct Store<kBf16F64> : Store<kBf16F32> {};
template <>
struct Store<kF32F32> {
  using T = __half;  // exact: beta <= 11 with an f32 accumulator
  static __device__ __forceinline__ T put(double x) {
    return __float2half_rn(__double2float_rn(x));
  }
};
template <>
struct Store<kF32F64> {
  using T = float;
  static __device__ __forceinline__ T put(double x) { return __double2float_rn(x); }
};

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

template <typename T>
__device__ __forceinline__ uint32_t pair_at(const T *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

template <int V, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
ozgemm_narrow_kernel(In a, In b, const double *__restrict__ alpha,
                     const double *__restrict__ beta_s, In c, Out o, int m,
                     int n, int k, int bk, int beta, int n_slices, int n_diag,
                     int epilogue, long long stride_a, long long stride_b,
                     long long stride_c) {
  using T = typename Store<V>::T;
  using Acc = typename std::conditional<V == kBf16F32 || V == kF32F32, float,
                                        double>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = kstride(bk);
  T *sa = reinterpret_cast<T *>(smem_raw);       // [n_slices][BM][ks]
  T *sb = sa + (size_t)n_slices * BM * ks;       // [n_slices][BN][ks]
  double *sig = reinterpret_cast<double *>(sb + (size_t)n_slices * BN * ks);
  double *sc = sig + BM + BN;   // [BM + BN]: _normalize_slices' scale
  double *isc = sc + BM + BN;   // [BM + BN]: 1 / sc, exact
  bool *nz = reinterpret_cast<bool *>(isc + BM + BN);  // [BM + BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long za = BATCHED ? blockIdx.z * stride_a : 0;
  const long long zb = BATCHED ? blockIdx.z * stride_b : 0;
  const double up = dd::pow2(53 - beta);
  const double step = dd::pow2(-beta);
  const int kpad = (bk + 15) / 16 * 16;

  // this thread's outputs: rows wr + g + 8i, columns wc + 8(jj/2) + 2q + jj%2
  double acc[2][8][K];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int l = 0; l < K; ++l) acc[i][jj][l] = 0.0;

  // the depth padding beyond bk stays zero for every slab
  for (int idx = threadIdx.x; idx < n_slices * (BM + BN) * (kpad - bk); idx += THREADS) {
    int row = idx / (kpad - bk), kk = bk + idx % (kpad - bk);
    sa[(size_t)row * ks + kk] = Store<V>::put(0.0);
  }

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kd = min(bk, k - k0);
    // 1. anchors and scales: thread r < BM takes A's row r, BM <= thread <
    //    BM + BN takes B's column; NaN propagates as in torch.amax
    if (threadIdx.x < BM + BN) {
      const bool is_a = threadIdx.x < BM;
      const int r = is_a ? threadIdx.x : threadIdx.x - BM;
      const int gi = (is_a ? row0 : col0) + r;
      const bool in = gi < (is_a ? m : n);
      double mu = 0.0;
      for (int kk = 0; in && kk < kd; ++kk)
        mu = nan_max(mu, fabs(__ldg(is_a ? &a.p[0][za + (long long)gi * k + k0 + kk]
                                         : &b.p[0][zb + (long long)(k0 + kk) * n + gi])));
      const double sigma = dd::mul(pow2_near(mu), up);
      const bool nonzero = mu > 0.0;
      double top = 0.0;  // max |slice 0|
      for (int kk = 0; in && kk < kd; ++kk) {
        double x = __ldg(is_a ? &a.p[0][za + (long long)gi * k + k0 + kk]
                              : &b.p[0][zb + (long long)(k0 + kk) * n + gi]);
        double s0 = nonzero ? dd::sub(dd::add(x, sigma), sigma) : 0.0;
        top = nan_max(top, fabs(s0));
      }
      const double scale = pow2_near(top);
      sig[threadIdx.x] = sigma;
      sc[threadIdx.x] = scale;
      isc[threadIdx.x] = __ddiv_rn(1.0, scale);
      nz[threadIdx.x] = nonzero;
    }
    __syncthreads();
    // 2. the normalized slices of every slab element
    for (int idx = threadIdx.x; idx < BM * bk; idx += THREADS) {
      const int r = idx / bk, kk = idx % bk;
      const int gr = row0 + r;
      const bool ok = gr < m && kk < kd;
      const long long off = za + (long long)gr * k + k0 + kk;
      double v[K];
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = ok ? __ldg(&a.p[l][off]) : 0.0;
      double sigma = sig[r];
      const double inv = isc[r];
      const bool nonzero = nz[r] && ok;
      T *dst = sa + (size_t)r * ks + kk;
      for (int s = 0; s < n_slices; ++s) {
        double sl = slice_step(v, sigma, nonzero);
        dst[(size_t)s * BM * ks] = Store<V>::put(dd::mul(dd::mul(sl, dd::pow2(s * beta)), inv));
        sigma = dd::mul(sigma, step);
      }
    }
    for (int idx = threadIdx.x; idx < bk * BN; idx += THREADS) {
      const int kk = idx / BN, cc = idx % BN;
      const int gc = col0 + cc;
      const bool ok = gc < n && kk < kd;
      const long long off = zb + (long long)(k0 + kk) * n + gc;
      double v[K];
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = ok ? __ldg(&b.p[l][off]) : 0.0;
      double sigma = sig[BM + cc];
      const double inv = isc[BM + cc];
      const bool nonzero = nz[BM + cc] && ok;
      T *dst = sb + (size_t)cc * ks + kk;
      for (int s = 0; s < n_slices; ++s) {
        double sl = slice_step(v, sigma, nonzero);
        dst[(size_t)s * BN * ks] = Store<V>::put(dd::mul(dd::mul(sl, dd::pow2(s * beta)), inv));
        sigma = dd::mul(sigma, step);
      }
    }
    __syncthreads();
    // 3. diagonals, most significant first: the exact sum of the pair dots
    //    in the accumulator type, rescaled and folded once
    for (int d = 0; d < n_diag; ++d) {
      Acc ds[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) ds[i][jj] = 0;
      const int s_lo = max(0, d - n_slices + 1), s_hi = min(d, n_slices - 1);
      for (int s = s_lo; s <= s_hi; ++s) {
        const T *pa = sa + ((size_t)s * BM + wr + g) * ks;
        const T *pb = sb + ((size_t)(d - s) * BN + wc + g) * ks;
        if constexpr (V == kBf16F32) {
          for (int kb = 0; kb < kpad; kb += 16) {
            const T *a_lo = pa + kb + 2 * q, *a_hi = a_lo + 8 * ks;
            const uint32_t a0 = pair_at(a_lo), a1 = pair_at(a_hi);
            const uint32_t a2 = pair_at(a_lo + 8), a3 = pair_at(a_hi + 8);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const T *bp = pb + (size_t)8 * j * ks + kb + 2 * q;
              float p[4];
              mma_bf16(p, a0, a1, a2, a3, pair_at(bp), pair_at(bp + 8));
              ds[0][2 * j] = __fadd_rn(ds[0][2 * j], p[0]);
              ds[0][2 * j + 1] = __fadd_rn(ds[0][2 * j + 1], p[1]);
              ds[1][2 * j] = __fadd_rn(ds[1][2 * j], p[2]);
              ds[1][2 * j + 1] = __fadd_rn(ds[1][2 * j + 1], p[3]);
            }
          }
        } else {
          // rows g, g + 8 of the warp's block; columns 8(jj/2) + 2q + jj%2
          for (int kk = 0; kk < kd; ++kk) {
            Acc av[2], bv[8];
            av[0] = (Acc)widen(pa[kk]);
            av[1] = (Acc)widen(pa[8 * ks + kk]);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              bv[jj] = (Acc)widen(pb[(size_t)(8 * (jj / 2) + 2 * q + jj % 2 - g) * ks + kk]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) ds[i][jj] = fma(av[i], bv[jj], ds[i][jj]);
          }
        }
      }
      const double p2 = dd::pow2(-d * beta);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double sca = sc[wr + g + 8 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const double scb = sc[BM + wc + 8 * (jj / 2) + 2 * q + jj % 2];
          fold(acc[i][jj], dd::mul((double)ds[i][jj], dd::mul(dd::mul(sca, scb), p2)));
        }
      }
    }
    __syncthreads();
  }

  // drain: the fused Rgemm epilogue, then the store
  const Scalars scal = load_scalars(alpha, beta_s, epilogue);
  const long long zc = BATCHED ? blockIdx.z * stride_c : 0;
  const long long zo = BATCHED ? blockIdx.z * (long long)m * n : 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + wr + g + 8 * i;
    if (r >= m) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int cc = col0 + wc + 8 * (jj / 2) + 2 * q + jj % 2;
      if (cc >= n) continue;
      const long long off = (long long)r * n + cc;
      drain_one(acc[i][jj], scal, epilogue, c, zc + off, o, zo + off);
    }
  }
}

}  // namespace

// Shared memory one CTA needs for a slab depth, slice count and variant
// (0 bf16/f32, 1 f32/f32, 2 bf16/f64, 3 f32/f64).
extern "C" int ozgemm_narrow_smem_bytes(int bk, int n_slices, int variant) {
  return smem_bytes(bk, n_slices, variant);
}

// out = epilogue(A @ B) at KLIMBS limbs over `batch` entries, with the
// slices and pair dots of `variant`, which must be this library's
// OZ_VARIANT.  The arguments are csrc/ozgemm.cu's ozgemm() (see there) plus
// the variant.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int ozgemm_narrow(const double *const *a, const double *const *b,
                             const double *alpha, const double *beta_s,
                             const double *const *c, double *const *o, int m,
                             int n, int k, int batch, long long stride_a,
                             long long stride_b, long long stride_c, int bk,
                             int beta, int n_slices, int n_diag, int epilogue,
                             int variant, cudaStream_t stream) {
  if (n_slices < 1 || bk < 1 || variant != OZ_VARIANT)
    return (int)cudaErrorInvalidValue;
  In ai, bi, ci;
  Out oo;
  for (int l = 0; l < K; ++l) {
    ai.p[l] = a[l];
    bi.p[l] = b[l];
    ci.p[l] = c[l];
    oo.p[l] = o[l];
  }
  auto kernel = batch > 1 ? ozgemm_narrow_kernel<OZ_VARIANT, true>
                          : ozgemm_narrow_kernel<OZ_VARIANT, false>;
  const int smem = ozgemm_narrow_smem_bytes(bk, n_slices, variant);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, smem, stream>>>(ai, bi, alpha, beta_s, ci, oo, m, n,
                                          k, bk, beta, n_slices, n_diag,
                                          epilogue, stride_a, stride_b,
                                          stride_c);
  return (int)cudaGetLastError();
}
