// Kernel #2's slicing pre-pass at KLIMBS limbs (2 = dd, 3 = td, 4 = qd):
// each operand element is cut into its error-free slices once per call,
// into a workspace that the GEMMs (csrc/ozgemm.cu, csrc/ozgemm_narrow.cu)
// stream into shared memory slab by slab.
//
// Replaces the slicing half of the Pallas kernel repro/kernels/ozgemm.py
// (_slab_update: _extract_slices, and with narrow slices
// _normalize_slices, of repro/core/ozaki.py), which the TPU kernel ran per
// output tile.  Done per tile on the card, a row of A was sliced n/64
// times and a column of B m/64 times; here once.  The build compiles this
// file once per limb count (-DKLIMBS=2|3|4, kernels/_build.py); each
// library holds every slice type.
//
// What it computes, per row of A (or column of B) and per K slab of the
// plan's depth bk, in the plain version's order (kernels/ozslice.py,
// ozslice_plain):
//   1. the max mu of |limb 0| over the slab (NaN propagates, as in
//      torch.amax) and the anchor sigma = pow2_near(mu) * 2^(53-beta);
//   2. with narrow slices, sc = pow2_near(max |slice 0|) and its exact
//      inverse;
//   3. the n_slices error-free slices s = (r0 + sigma) - sigma, the
//      residual r updated in its own tier, sigma *= 2^-beta; a narrow slice
//      is stored as (s * 2^(i*beta)) * (1 / sc) rounded as torch's .to().
// A zero or masked entry (beyond the ragged edges, or beyond bk up to the
// MMA depth) stores zero slices, as the reference's zero padding does.
//
// Workspace layout, per batch entry and K slab j of the launch:
//   slices  [entry][j][slice][rows_padded(R)][kdepth(bk)]  (oz_device.cuh)
//   scales  [entry][j][rows_padded(R)]                     (narrow only)
// R being m for A and n for B: K runs contiguous per row of A and per
// column of B, whole CTA tiles of rows, so every copy of a GEMM's stage is
// 16 aligned bytes and needs no mask.
//
// Bound on the H100: the f64 work of the extraction (a tier subtraction
// and the anchor step per element per slice), against 17e12 f64
// instructions per second, or the bytes (the limbs read once, the slices
// written once) against 3.35 TB/s; chip_smoke.py counts both.
//
// Design: one block of 256 threads per 64 rows (columns of B) and slab.
// The block stages the slab's limbs in shared memory, each load coalesced
// along whichever axis is contiguous (K for A, the columns for B); 64
// threads take a row's anchor and scale each; then every thread slices
// elements with K fastest across threads, so each slice's stores are
// contiguous.
#include <cuda_runtime.h>

#include "oz_device.cuh"

namespace {

using namespace oz;

constexpr int ROWS = 64, THREADS = 256;

// Shared memory of one block: the slab's limbs ([K][ROWS][bk + 1] f64),
// per row the anchor and 1 / sc, and the nonzero flags.
__host__ __device__ constexpr int slice_smem_bytes(int bk) {
  return (K * ROWS * (bk + 1) + 2 * ROWS) * (int)sizeof(double) + ROWS;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
ozslice_kernel(In x, typename Store<V>::T *__restrict__ ws, double *__restrict__ scale,
               int rows, int k, int k0, int nslab, int bk, long long ld_row,
               long long ld_k, long long stride_x, int beta, int n_slices) {
  using T = typename Store<V>::T;
  constexpr bool narrow = V != kF64;
  extern __shared__ double xs[];            // [K][ROWS][bk + 1]
  const int st = bk + 1;
  double *sig = xs + K * ROWS * st;         // [ROWS] anchors
  double *inv = sig + ROWS;                 // [ROWS] 1 / sc
  bool *nz = reinterpret_cast<bool *>(inv + ROWS);  // [ROWS] mu > 0
  const int rp = rows_padded(rows), kp = kdepth(bk, V);
  const int r0 = blockIdx.x * ROWS, j = blockIdx.y;
  const int kb = k0 + j * bk, kd = min(bk, k - kb);
  const long long base = blockIdx.z * stride_x + kb * ld_k;
  const long long slab = (long long)blockIdx.z * nslab + j;

  // 1. the slab's limbs, zero beyond the edges
  for (int idx = threadIdx.x; idx < ROWS * bk; idx += THREADS) {
    const int r = ld_k == 1 ? idx / bk : idx % ROWS;
    const int kk = ld_k == 1 ? idx % bk : idx / ROWS;
    const bool ok = r0 + r < rows && kk < kd;
    const long long off = base + (long long)(r0 + r) * ld_row + kk * ld_k;
#pragma unroll
    for (int l = 0; l < K; ++l) xs[(l * ROWS + r) * st + kk] = ok ? __ldg(&x.p[l][off]) : 0.0;
  }
  __syncthreads();
  // 2. per row, the anchor and, with narrow slices, the scale
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    const double *xr = xs + r * st;  // limb 0
    double mu = 0.0;
    for (int kk = 0; kk < kd; ++kk) mu = nan_max(mu, fabs(xr[kk]));
    const double sigma = dd::mul(pow2_near(mu), dd::pow2(53 - beta));
    const bool nonzero = mu > 0.0;
    sig[r] = sigma;
    nz[r] = nonzero;
    if (narrow) {
      double top = 0.0;  // max |slice 0|, the scale of _normalize_slices
      for (int kk = 0; kk < kd; ++kk)
        top = nan_max(top, fabs(nonzero ? dd::sub(dd::add(xr[kk], sigma), sigma) : 0.0));
      const double sc = pow2_near(top);
      scale[slab * rp + r0 + r] = sc;
      inv[r] = __ddiv_rn(1.0, sc);
    }
  }
  __syncthreads();
  // 3. the slices of every element, zero beyond the slab; K fastest
  const double step = dd::pow2(-beta);
  T *dst = ws + (slab * n_slices * rp + r0) * kp;
  for (int idx = threadIdx.x; idx < ROWS * kp; idx += THREADS) {
    const int r = idx / kp, kk = idx % kp;
    const bool ok = r0 + r < rows && kk < kd;
    double v[K];
#pragma unroll
    for (int l = 0; l < K; ++l) v[l] = ok ? xs[(l * ROWS + r) * st + kk] : 0.0;
    double sigma = sig[r];
    const bool nonzero = nz[r] && ok;
    for (int s = 0; s < n_slices; ++s) {
      const double sl = slice_step(v, sigma, nonzero);
      dst[(size_t)s * rp * kp + idx] =
          Store<V>::put(narrow ? dd::mul(dd::mul(sl, dd::pow2(s * beta)), inv[r]) : sl);
      sigma = dd::mul(sigma, step);
    }
  }
}

template <int V>
cudaError_t launch(const In &x, void *ws, double *scale, int rows, int k, int k0,
                   int nslab, int batch, int bk, long long ld_row, long long ld_k,
                   long long stride_x, int beta, int n_slices, cudaStream_t stream) {
  const int smem = slice_smem_bytes(bk);
  cudaError_t err = cudaFuncSetAttribute(
      ozslice_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(rows_padded(rows) / ROWS, nslab, batch);
  ozslice_kernel<V><<<grid, THREADS, smem, stream>>>(
      x, static_cast<typename Store<V>::T *>(ws), scale, rows, k, k0, nslab, bk, ld_row,
      ld_k, stride_x, beta, n_slices);
  return cudaGetLastError();
}

}  // namespace

// The slices of `nslab` K slabs of depth bk, from K index k0 on, of one
// operand at KLIMBS limbs over `batch` entries.  x points at KLIMBS limb
// pointers (a host array) of row-major f64 on the device; element (row,
// kk) of entry z sits at z * stride_x + row * ld_row + kk * ld_k (A (m, k):
// ld_row = k, ld_k = 1; B (k, n), a row being a column: ld_row = 1,
// ld_k = n).  ws and scale (null for f64 slices) receive the layout above.
// variant: -1 f64, 0 bf16/f32, 1 f32/f32, 2 bf16/f64, 3 f32/f64.  Launches
// on `stream`; returns the launch's cudaGetLastError() (0 on success).
extern "C" int ozslice(const double *const *x, void *ws, double *scale, int rows,
                       int k, int k0, int nslab, int batch, int bk, long long ld_row,
                       long long ld_k, long long stride_x, int beta, int n_slices,
                       int variant, cudaStream_t stream) {
  if (n_slices < 1 || bk < 1 || nslab < 1 || (variant != kF64 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  In xi;
  for (int l = 0; l < K; ++l) xi.p[l] = x[l];
  cudaError_t err;
  switch (variant) {
    case kF64:
      err = launch<kF64>(xi, ws, scale, rows, k, k0, nslab, batch, bk, ld_row, ld_k,
                         stride_x, beta, n_slices, stream);
      break;
    case kBf16F32:
      err = launch<kBf16F32>(xi, ws, scale, rows, k, k0, nslab, batch, bk, ld_row, ld_k,
                             stride_x, beta, n_slices, stream);
      break;
    case kF32F32:
      err = launch<kF32F32>(xi, ws, scale, rows, k, k0, nslab, batch, bk, ld_row, ld_k,
                            stride_x, beta, n_slices, stream);
      break;
    case kBf16F64:
      err = launch<kBf16F64>(xi, ws, scale, rows, k, k0, nslab, batch, bk, ld_row, ld_k,
                             stride_x, beta, n_slices, stream);
      break;
    case kF32F64:
      err = launch<kF32F64>(xi, ws, scale, rows, k, k0, nslab, batch, bk, ld_row, ld_k,
                            stride_x, beta, n_slices, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
