// Kernel #2: the fused Ozaki-slice GEMM at KLIMBS limbs (2 = dd, 3 = td,
// 4 = qd), f64 slices, with the Rgemm epilogue fused into its drain and an
// optional batch grid axis.
//
// Replaces the Pallas kernel repro/kernels/ozgemm.py (_ozgemm_kernel /
// ozgemm_kernel_call, with _slab_update and _fold_diagonal): the engine's
// `ozaki-pallas` backend, f64 slices, f64 accumulation (bf16 and f32
// slices are csrc/ozgemm_narrow.cu; the slicing of both is the pre-pass
// csrc/ozslice.cu; the pieces all three share are in oz_device.cuh).  The
// build compiles this file once per limb count (-DKLIMBS=2|3|4, see
// kernels/_build.py).
//
// What it computes, per 64x64 output tile and per K slab of the plan's
// depth bk, in slab order, from the pre-pass's workspace (n_slices
// error-free slices per element on its row's or column's anchor ladder):
// for each diagonal d = 0..n_diag-1, the sum in f64 of the pair dots
// sa[s] . sb[t] with s + t = d, folded into the accumulator once: dd.add_float
// at dd, renorm_list(acc + [dsum], k, sweeps=3) at td/qd.  The drain
// applies the `none` / `alpha` / `full` epilogue in tier arithmetic (alpha
// * acc, plus beta * C, where beta == 0 selects zero so C's NaN/Inf never
// leak).  beta, n_slices and bk come from the plan; nothing is re-derived
// here.  The bits depend on bk, beta and n_slices, not on the tile size,
// and the plain version (repro_torch/kernels/ozgemm.py, ozgemm_plain)
// agrees with this kernel bit for bit.
//
// The pair dots run on the f64 tensor cores: mma.sync.m16n8k4 f64, each
// diagonal summed in C fragments (two sets, added at the end; the loop is
// oz_device.cuh dmma_diagonal, which csrc/ozgemm_narrow.cu runs on f32
// slices too).  Every pair product has at most
// 2*beta bits and every partial sum of a diagonal lies on the diagonal's
// common grid within 53 bits (2*beta + ceil(log2 bk) + ceil(log2 n_slices)
// <= 53, slice_params' headroom), so each is exact, and the f64 tensor
// cores, which run IEEE f64 multiply-adds, give the exact sum in any order
// of accumulation: the plain version's bits.  chip_smoke.py's phase 2
// holds an adversarial case (every digit at its largest) to the same dots
// summed by DFMA.
//
// Bound on the H100: the pair dots are m*n*k*P multiply-adds (P pair dots
// per slab: 15 at dd's 5 slices, 36 at td's 8, 55 at qd's 10) against the
// f64 tensor cores' 67 TFLOP/s (33.5e12 multiply-adds per second); the
// folds, a renormalization per output per diagonal per slab, and the
// epilogue are f64 instructions at 17e12 per second, as is the pre-pass's
// extraction (chip_smoke.py counts both parts and takes the larger).
//
// Design: one CTA per 64x64 output tile, 16 warps at dd and 8 at td/qd
// (oz_device.cuh nt_of: the dd folds want warps to hide their latency,
// the wider accumulators want registers).  The slices stream from the
// workspace into shared memory with cp.async, one stage per slab (the
// slab's slices of the tile's 64 rows and 64 columns, K contiguous, rows
// padded by 32 bytes so that eight rows' fragment loads take two
// wavefronts): two stages where two fit (dd), so slab j + 1 lands while
// slab j is dotted and folded, else one.  Warp w owns rows 16*(w % 4) ..
// +16 and NT n8 column tiles from 8*NT*(w / 4) on, NT m16n8k4 DMMA tiles;
// their C fragments (rows g, g + 8, columns 2q, 2q + 1 for lane = 4g + q)
// put each thread's outputs where csrc/ozgemm_narrow.cu's m16n8 fragments
// put them, so both share the fold and drain (oz_device.cuh).  Ragged edges: the workspace holds zero slices beyond
// them, and the drain masks the store.  A K panel (kernels/ozgemm.py
// walks K in panels when the workspace outgrows its budget) starts from
// the accumulator the previous panel stored, and only the last one drains
// with the epilogue.
#include <cuda_runtime.h>

#include "oz_device.cuh"

namespace {

using namespace oz;

constexpr int NT = nt_of(kF64), THREADS = threads_of(kF64);

// One slab from one stage: each diagonal's exact f64 sum on the tensor
// cores (oz_device.cuh dmma_diagonal), folded once, most significant
// first.
__device__ __forceinline__ void slab_update(double (&acc)[2][2 * NT][K], const double *stage,
                                            int ks, int kp, int n_slices, int n_diag) {
  const double *sa = stage;                            // [n_slices][BM][ks]
  const double *sb = sa + (size_t)n_slices * BM * ks;  // [n_slices][BN][ks]
  for (int d = 0; d < n_diag; ++d) {
    double dsum[2][2 * NT];
    dmma_diagonal<double, NT>(dsum, sa, sb, max(0, d - n_slices + 1), min(d, n_slices - 1), d,
                              ks, kp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2 * NT; ++jj) fold(acc[i][jj], dsum[i][jj]);
  }
}

// BATCHED = false is the unbatched launch: no per-entry offset arithmetic.
template <bool BATCHED, int STAGES>
__global__ void __launch_bounds__(THREADS)
ozgemm_kernel(const double *__restrict__ wa, const double *__restrict__ wb,
              const double *__restrict__ alpha, const double *__restrict__ beta_s, In c,
              Out o, int m, int n, int nslab, int bk, int n_slices, int n_diag,
              int epilogue, int flags, long long swa, long long swb,
              long long stride_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = kstride(bk, kF64), kp = kdepth(bk, kF64);
  const int rpa = rows_padded(m), rpb = rows_padded(n);
  const int sbytes = stage_bytes(bk, n_slices, kF64);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long zo = BATCHED ? blockIdx.z * (long long)m * n : 0;
  const double *ea = wa + (BATCHED ? blockIdx.z * swa : 0);
  const double *eb = wb + (BATCHED ? blockIdx.z * swb : 0);
  const long long slab_a = (long long)n_slices * rpa * kp, slab_b = (long long)n_slices * rpb * kp;

  double acc[2][2 * NT][K];
  start_acc<NT>(acc, flags, o, zo, row0, col0, m, n);
  auto load = [&](int j) {
    load_stage(smem_raw + (STAGES == 2 ? (j & 1) * sbytes : 0), ea + j * slab_a,
               (const double *)nullptr, eb + j * slab_b, (const double *)nullptr, kp, ks,
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
    slab_update(acc,
                reinterpret_cast<const double *>(smem_raw + (STAGES == 2 ? (j & 1) * sbytes : 0)),
                ks, kp, n_slices, n_diag);
    __syncthreads();
  }
  drain_tile<NT>(acc, alpha, beta_s, epilogue, flags, c,
             BATCHED ? blockIdx.z * stride_c : 0, o, zo, row0, col0, m, n);
}

}  // namespace

// Shared memory one CTA needs for a slab depth and slice count.
extern "C" int ozgemm_smem_bytes(int bk, int n_slices) {
  return smem_bytes(bk, n_slices, kF64);
}

// out = epilogue(A @ B) at KLIMBS limbs over `batch` entries, from the
// pre-pass's f64-slice workspaces of A and B (csrc/ozslice.cu): wa and wb
// hold the slices of `nslab` K slabs of depth bk, entry z of A's at
// z * swa elements (0: one workspace shared by every entry), of B's at
// z * swb.  c and o point at KLIMBS limb pointers (host arrays; c may hold
// nulls unless the epilogue is 2 on the last panel); C and out (m, n) per
// entry, row-major contiguous f64 on the device, entry z of C at
// z * stride_c, of out at z * m * n.  alpha and beta_s point at KLIMBS
// limbs each.  epilogue: 0 none, 1 alpha (alpha * AB), 2 full (alpha * AB
// + beta * C).  flags (oz_device.cuh PanelFlags): 1 start from the
// accumulator in out, 2 the last panel (drain with the epilogue; otherwise
// store the raw accumulator).  Launches on `stream`; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ozgemm(const double *wa, const double *wb, const double *alpha,
                      const double *beta_s, const double *const *c, double *const *o,
                      int m, int n, int nslab, int batch, long long swa, long long swb,
                      long long stride_c, int bk, int n_slices, int n_diag, int epilogue,
                      int flags, cudaStream_t stream) {
  if (n_slices < 1 || bk < 1 || nslab < 0) return (int)cudaErrorInvalidValue;
  In ci;
  Out oo;
  for (int l = 0; l < K; ++l) {
    ci.p[l] = c[l];
    oo.p[l] = o[l];
  }
  const int smem = ozgemm_smem_bytes(bk, n_slices);
  const bool two = stages(bk, n_slices, kF64) == 2;
  auto kernel = batch > 1 ? (two ? ozgemm_kernel<true, 2> : ozgemm_kernel<true, 1>)
                          : (two ? ozgemm_kernel<false, 2> : ozgemm_kernel<false, 1>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, smem, stream>>>(wa, wb, alpha, beta_s, ci, oo, m, n, nslab, bk,
                                          n_slices, n_diag, epilogue, flags, swa, swb,
                                          stride_c);
  return (int)cudaGetLastError();
}
