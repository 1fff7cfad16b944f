// Kernel #2: the fused Ozaki-slice GEMM at KLIMBS limbs (2 = dd, 3 = td,
// 4 = qd), f64 slices, with the Rgemm epilogue fused into its drain and an
// optional batch grid axis.
//
// Replaces the Pallas kernel repro/kernels/ozgemm.py (_ozgemm_kernel /
// ozgemm_kernel_call, with _slab_update and _fold_diagonal): the engine's
// `ozaki-pallas` backend, f64 slices, f64 accumulation (bf16 and f32
// slices are csrc/ozgemm_narrow.cu; the pieces both share are in
// oz_device.cuh).  The build compiles this file once per limb count
// (-DKLIMBS=2|3|4, see kernels/_build.py).
//
// What it computes, per 64x64 output tile and per K slab of the plan's
// depth bk, in slab order:
//   1. the per-row max mu of |A limb 0| over the slab and the per-column
//      max of |B limb 0|; the anchor sigma = pow2_near(mu) * 2^(53-beta);
//   2. n_slices error-free slices per element, s = (r0 + sigma) - sigma
//      (never reassociated or contracted), the residual r updated in its
//      own tier by mp.sub(r, from_float(s)) -- dd.add at dd, renorm_list
//      over 2k terms at td/qd -- then sigma *= 2^-beta;
//   3. for each diagonal d = 0..n_diag-1, the sum in f64 of the pair dots
//      sa[s] . sb[t] with s + t = d, folded into the accumulator once:
//      dd.add_float at dd, renorm_list(acc + [dsum], k, sweeps=3) at td/qd.
// The drain applies the `none` / `alpha` / `full` epilogue in tier
// arithmetic (alpha * acc, plus beta * C, where beta == 0 selects zero so
// C's NaN/Inf never leak).  beta, n_slices and bk come from the plan;
// nothing is re-derived here.  The bits depend on bk, beta and n_slices,
// not on the tile size, and the plain version (repro_torch/kernels/
// ozgemm.py, ozgemm_plain) agrees with this kernel bit for bit.
//
// Batching: blockIdx.z walks the flattened batch; A, B and C carry batch
// strides in elements (0 for an operand shared by every entry).
//
// Bound on the H100: compute.  The pair dots are 2*m*n*k*P flops (P pair
// dots per slab: 15 at dd's 5 slices, 36 at td's 8, 55 at qd's 10) against
// the 34 TFLOP/s f64 peak; the extraction adds a tier subtraction per
// operand element per slice and the folds a renormalization per output
// per diagonal per slab (chip_smoke.py counts both).  The f64 tensor cores
// (67 TFLOP/s, DMMA) are the later design: every pair product is exact and
// every diagonal sum is exact by the slice_params headroom, so any
// summation order, and fused multiply-add, give the same bits.  That is
// also why the dot loop below uses fma() explicitly: the one place in the
// port where fusing cannot change a bit.
//
// Design: one CTA of 256 threads per 64x64 output tile, a 4x4 micro-tile
// of K-limb accumulators per thread in registers.  Per slab the CTA
// extracts both operands' slices into shared memory (n_slices * bk *
// (64 + 64) f64 values: 80 KB at dd, 128 KB at td, 160 KB at qd, bk = 16;
// dynamic shared memory above 48 KB), then runs the diagonal dots out of
// shared memory.  Ragged edges are masked; a zero entry slices to zero and
// leaves every max unchanged, so masking equals the reference's padding.
#include <cuda_runtime.h>

#include "oz_device.cuh"

namespace {

using namespace oz;

constexpr int TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;  // 16 x 16 threads
constexpr int THREADS = TX * TY;

// Slices of one operand element on its row's (or column's) anchor ladder;
// out[s * stride] receives slice s.
__device__ __forceinline__ void extract(double (&r)[K], double sigma, bool nonzero,
                                        int beta, int n_slices, double *out,
                                        int stride) {
  const double step = dd::pow2(-beta);
  for (int s = 0; s < n_slices; ++s) {
    out[s * stride] = slice_step(r, sigma, nonzero);
    sigma = dd::mul(sigma, step);
  }
}

// BATCHED = false is the unbatched launch: no per-entry offset arithmetic,
// which measurably slowed the dd kernel at 4096^3 on the H100.
template <bool BATCHED>
__global__ void __launch_bounds__(THREADS)
ozgemm_kernel(In a, In b, const double *__restrict__ alpha,
              const double *__restrict__ beta_s, In c, Out o, int m, int n,
              int k, int bk, int beta, int n_slices, int n_diag, int epilogue,
              long long stride_a, long long stride_b, long long stride_c) {
  extern __shared__ double smem[];
  double *sa = smem;                       // [n_slices][bk][BM]
  double *sb = sa + n_slices * bk * BM;    // [n_slices][bk][BN]
  double *sig_a = sb + n_slices * bk * BN; // [BM] row anchors
  double *sig_b = sig_a + BM;              // [BN] column anchors
  bool *nz_a = reinterpret_cast<bool *>(sig_b + BN);  // [BM]
  bool *nz_b = nz_a + BM;                              // [BN]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long za = BATCHED ? blockIdx.z * stride_a : 0;
  const long long zb = BATCHED ? blockIdx.z * stride_b : 0;
  const double up = dd::pow2(53 - beta);

  double acc[TM][TN][K];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int l = 0; l < K; ++l) acc[i][j][l] = 0.0;

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kd = min(bk, k - k0);
    // 1. anchors: thread r < BM scans A's row r, BM <= thread < BM + BN
    //    scans B's column; NaN propagates into mu as in torch.amax
    if (threadIdx.x < BM + BN) {
      bool is_a = threadIdx.x < BM;
      int r = is_a ? threadIdx.x : threadIdx.x - BM;
      int g = (is_a ? row0 : col0) + r;
      double mu = 0.0;
      if (g < (is_a ? m : n)) {
        for (int kk = 0; kk < kd; ++kk) {
          const double *src =
              is_a ? &a.p[0][za + (long long)g * k + k0 + kk]
                   : &b.p[0][zb + (long long)(k0 + kk) * n + g];
          mu = nan_max(mu, fabs(__ldg(src)));
        }
      }
      (is_a ? sig_a : sig_b)[r] = dd::mul(pow2_near(mu), up);
      (is_a ? nz_a : nz_b)[r] = mu > 0.0;
    }
    __syncthreads();
    // 2. slices of every slab element into shared memory (zero beyond the
    //    ragged edges and beyond the slab's depth kd)
    for (int idx = threadIdx.x; idx < BM * bk; idx += THREADS) {
      int r = idx / bk, kk = idx % bk;
      int gr = row0 + r;
      bool ok = gr < m && kk < kd;
      long long off = za + (long long)gr * k + k0 + kk;
      double v[K];
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = ok ? __ldg(&a.p[l][off]) : 0.0;
      extract(v, sig_a[r], nz_a[r] && ok, beta, n_slices, sa + kk * BM + r,
              bk * BM);
    }
    for (int idx = threadIdx.x; idx < bk * BN; idx += THREADS) {
      int kk = idx / BN, cc = idx % BN;
      int gc = col0 + cc;
      bool ok = gc < n && kk < kd;
      long long off = zb + (long long)(k0 + kk) * n + gc;
      double v[K];
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = ok ? __ldg(&b.p[l][off]) : 0.0;
      extract(v, sig_b[cc], nz_b[cc] && ok, beta, n_slices, sb + kk * BN + cc,
              bk * BN);
    }
    __syncthreads();
    // 3. diagonals, most significant first; each exact sum folds once
    for (int d = 0; d < n_diag; ++d) {
      double dsum[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dsum[i][j] = 0.0;
      int s_lo = max(0, d - n_slices + 1), s_hi = min(d, n_slices - 1);
      for (int s = s_lo; s <= s_hi; ++s) {
        const double *pa = sa + (s * bk) * BM;
        const double *pb = sb + ((d - s) * bk) * BN;
        for (int kk = 0; kk < kd; ++kk) {
          double av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = pa[kk * BM + ty + TY * i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = pb[kk * BN + tx + TX * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) dsum[i][j] = fma(av[i], bv[j], dsum[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) fold(acc[i][j], dsum[i][j]);
    }
    __syncthreads();
  }

  // drain: the fused Rgemm epilogue, then the store
  const Scalars sc = load_scalars(alpha, beta_s, epilogue);
  const long long zc = BATCHED ? blockIdx.z * stride_c : 0;
  const long long zo = BATCHED ? blockIdx.z * (long long)m * n : 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int cc = col0 + tx + TX * j;
      if (cc >= n) continue;
      long long off = (long long)r * n + cc;
      drain_one(acc[i][j], sc, epilogue, c, zc + off, o, zo + off);
    }
  }
}

}  // namespace

// Shared memory one CTA needs for a slab depth and slice count.
extern "C" int ozgemm_smem_bytes(int bk, int n_slices) {
  return smem_bytes(bk, n_slices, kF64);
}

// out = epilogue(A @ B) at KLIMBS limbs over `batch` entries.  a, b, c and
// o point at KLIMBS limb pointers each (host arrays; c may hold nulls
// unless epilogue == 2); A (m, k), B (k, n), C and out (m, n) per entry,
// row-major contiguous f64 on the device; entry z of A starts at
// a[l] + z * stride_a (0: shared), of B and C likewise, of out at
// z * m * n.  alpha and beta_s point at KLIMBS limbs each.  epilogue:
// 0 none, 1 alpha (alpha * AB), 2 full (alpha * AB + beta * C).  Launches
// on `stream`; returns the launch's cudaGetLastError() (0 on success).
extern "C" int ozgemm(const double *const *a, const double *const *b,
                      const double *alpha, const double *beta_s,
                      const double *const *c, double *const *o, int m, int n,
                      int k, int batch, long long stride_a, long long stride_b,
                      long long stride_c, int bk, int beta, int n_slices,
                      int n_diag, int epilogue, cudaStream_t stream) {
  if (n_slices < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  In ai, bi, ci;
  Out oo;
  for (int l = 0; l < K; ++l) {
    ai.p[l] = a[l];
    bi.p[l] = b[l];
    ci.p[l] = c[l];
    oo.p[l] = o[l];
  }
  int smem = ozgemm_smem_bytes(bk, n_slices);
  auto kernel = batch > 1 ? ozgemm_kernel<true> : ozgemm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      ai, bi, alpha, beta_s, ci, oo, m, n, k, bk, beta, n_slices, n_diag,
      epilogue, stride_a, stride_b, stride_c);
  return (int)cudaGetLastError();
}
