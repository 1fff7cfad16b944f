// Kernel #1: the dd systolic-tile GEMM, C = A @ B at two limb planes.
//
// Replaces the Pallas kernel repro/kernels/mlgemm.py (_mlgemm_kernel /
// mlgemm_kernel_call) at 2 planes, also reached through
// repro/kernels/ddgemm.py (ddgemm_kernel_call): the engine's `pallas`
// backend, the paper's PE array.
//
// What it computes: per output element, the sequential left fold over
// k = 0..K-1 of acc = dd.fma(acc, a[i,k], b[k,j]) from acc = 0, where
// dd.fma = dd.add(acc, dd.mul(a, b)) with the rescue/mask-split two_prod.
// The fold order is the reference's, so the bits depend on no block size,
// and the plain version (repro_torch/kernels/mlgemm.py, mlgemm_plain)
// agrees with this kernel bit for bit.
//
// Bound on the H100: compute.  One dd FMA issues 51 f64 add/sub/mul
// operations in the inner loop below (two_prod 4 mul + 3 two_sum + 2 add;
// the dd.mul tail 2 mul + 2 add + quick_two_sum; Li's add 20), none of them
// fusable, plus a few integer and compare ops; each A and B element is
// split once per K step, amortized over 4 outputs.  m*n*k*51 operations
// over the card's 34 TFLOP/s f64 (non-tensor-core) peak; every operand is
// read once per 64-wide tile, so bytes are far below that line.
//
// Design: one CTA per 64x64 output tile (the paper's PE array), K staged
// through shared memory 16 deep (the paper's M_Tile), both limbs of the
// 4x4 accumulator micro-tile of each of the 256 threads in registers.
// Each thread splits its 4 A and 4 B operands once per K step and reuses
// the splits across its 16 outputs, which is bit-identical because the
// split depends on the operand alone.  Ragged edges are masked, not padded
// (a zero FMA leaves a normalized accumulator unchanged, so masking and
// the reference's zero padding give the same bits).  No FMA contraction
// anywhere (see dd_device.cuh).  wgmma/TMA play no part: the work is
// scalar f64 EFT chains, not a product the tensor cores can take.
#include <cuda_runtime.h>

#include "dd_device.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;  // 16 x 16 threads
constexpr int THREADS = TX * TY;

__global__ void __launch_bounds__(THREADS)
mlgemm_dd_kernel(const double *__restrict__ a_hi, const double *__restrict__ a_lo,
                 const double *__restrict__ b_hi, const double *__restrict__ b_lo,
                 double *__restrict__ c_hi, double *__restrict__ c_lo,
                 int m, int n, int k) {
  // K-major tiles; the +1 pad spreads the transposed stores over the banks
  __shared__ double as_hi[BK][BM + 1], as_lo[BK][BM + 1];
  __shared__ double bs_hi[BK][BN], bs_lo[BK][BN];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  double acc_hi[TM][TN], acc_lo[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_hi[i][j] = acc_lo[i][j] = 0.0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      int r = idx / BK, kk = idx % BK;
      int gr = row0 + r, gk = k0 + kk;
      bool ok = gr < m && gk < k;
      size_t off = (size_t)gr * k + gk;
      as_hi[kk][r] = ok ? a_hi[off] : 0.0;
      as_lo[kk][r] = ok ? a_lo[off] : 0.0;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      int kk = idx / BN, c = idx % BN;
      int gk = k0 + kk, gc = col0 + c;
      bool ok = gk < k && gc < n;
      size_t off = (size_t)gk * n + gc;
      bs_hi[kk][c] = ok ? b_hi[off] : 0.0;
      bs_lo[kk][c] = ok ? b_lo[off] : 0.0;
    }
    __syncthreads();

    const int kmax = min(BK, k - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      double ah[TM], al[TM], bh[TN], bl[TN];
      dd::Split asp[TM], bsp[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ah[i] = as_hi[kk][ty + TY * i];
        al[i] = as_lo[kk][ty + TY * i];
        asp[i] = dd::split(ah[i]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bh[j] = bs_hi[kk][tx + TX * j];
        bl[j] = bs_lo[kk][tx + TX * j];
        bsp[j] = dd::split(bh[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          double ph, pl;
          dd::mul_split(ah[i], al[i], asp[i], bh[j], bl[j], bsp[j], ph, pl);
          dd::add_to(acc_hi[i][j], acc_lo[i][j], ph, pl);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col0 + tx + TX * j;
      if (c >= n) continue;
      c_hi[(size_t)r * n + c] = acc_hi[i][j];
      c_lo[(size_t)r * n + c] = acc_lo[i][j];
    }
  }
}

}  // namespace

// C = A @ B, dd limbs: A (m, k), B (k, n), C (m, n), all row-major and
// contiguous f64 on the device.  Launches on `stream`; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int mlgemm_dd(const double *a_hi, const double *a_lo,
                         const double *b_hi, const double *b_lo,
                         double *c_hi, double *c_lo, int m, int n, int k,
                         cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mlgemm_dd_kernel<<<grid, THREADS, 0, stream>>>(a_hi, a_lo, b_hi, b_lo,
                                                 c_hi, c_lo, m, n, k);
  return (int)cudaGetLastError();
}
