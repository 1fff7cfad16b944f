// Kernel #1: the systolic-tile multi-limb GEMM, C = A @ B at KLIMBS limb
// planes (2 = dd, 3 = td, 4 = qd), with an optional batch grid axis.
//
// Replaces the Pallas kernel repro/kernels/mlgemm.py (_mlgemm_kernel /
// mlgemm_kernel_call), also reached through repro/kernels/ddgemm.py
// (ddgemm_kernel_call) and repro/kernels/qdgemm.py (qdgemm_kernel_call):
// the engine's `pallas` backend, the paper's PE array.  The build compiles
// this file once per limb count (-DKLIMBS=2|3|4, see kernels/_build.py).
//
// What it computes: per output element, the sequential left fold over
// k = 0..K-1 of acc = mp.fma(acc, a[i,k], b[k,j]) from acc = 0.  At dd that
// is dd.fma = dd.add(acc, dd.mul(a, b)) (dd_device.cuh); at td/qd it is
// mp.fma_limbs = renorm_list(acc + mul_limbs(a, b), sweeps=3)
// (ml_device.cuh).  The fold order is the reference's, so the bits depend
// on no block size, and the plain version (repro_torch/kernels/mlgemm.py,
// mlgemm_plain) agrees with this kernel bit for bit.
//
// Batching: blockIdx.z walks the flattened batch; each operand carries a
// batch stride in elements (0 for an operand shared by every batch entry),
// so one launch serves one batched engine call.
//
// Bound on the H100: compute.  f64 add/sub/mul operations per FMA in the
// inner loops below: 51 at dd (two_prod 4 mul + 3 two_sum + 2 add; the
// dd.mul tail 2 mul + 2 add + quick_two_sum; Li's add 20), none fusable.
// At td/qd the exact-product expansion (18 / 34 terms) is renormalized
// over three sweeps and added to the accumulator by a second renorm
// (chip_smoke.py counts the operations from the same recipe).  m*n*k
// times that count over the card's 34 TFLOP/s f64 peak; every operand is
// read once per tile, so bytes are far below that line.
//
// Design: one CTA of 256 threads per output tile, K staged through shared
// memory 16 deep (the paper's M_Tile), every limb of the thread's
// accumulator micro-tile in registers.  The micro-tile shrinks with the
// limb count, because one td/qd FMA holds its whole term expansion in
// registers: 4x4 (64x64 tile) at dd, 2x2 (32x32 tile) at td and qd.  Each
// thread splits its A and B operands once per K step and reuses the splits
// across its outputs, which is bit-identical because a split depends on
// the operand alone.  Ragged edges are masked, not padded (a zero FMA
// leaves a normalized accumulator unchanged, so masking and the
// reference's zero padding give the same bits).  No FMA contraction
// anywhere.  wgmma/TMA play no part: the work is scalar f64 EFT chains,
// not a product the tensor cores can take.
#include <cuda_runtime.h>

#include "dd_device.cuh"
#include "ml_device.cuh"

#ifndef KLIMBS
#error "build with -DKLIMBS=2, 3 or 4"
#endif

namespace {

constexpr int K = KLIMBS;
constexpr int BK = 16;
constexpr int TM = K == 2 ? 4 : 2, TN = TM;
constexpr int TX = 16, TY = 16;  // 256 threads
constexpr int BM = TM * TY, BN = TN * TX;
constexpr int THREADS = TX * TY;

struct In {
  const double *p[K];
};
struct Out {
  double *p[K];
};

// Per-element multiply-accumulate of one thread's micro-tile at K step kk.
__device__ __forceinline__ void fma_step(double (&acc)[TM][TN][K],
                                         const double (&av)[TM][K],
                                         const double (&bv)[TN][K]) {
  if constexpr (K == 2) {
    dd::Split asp[TM], bsp[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) asp[i] = dd::split(av[i][0]);
#pragma unroll
    for (int j = 0; j < TN; ++j) bsp[j] = dd::split(bv[j][0]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        double ph, pl;
        dd::mul_split(av[i][0], av[i][1], asp[i], bv[j][0], bv[j][1], bsp[j], ph, pl);
        dd::add_to(acc[i][j][0], acc[i][j][1], ph, pl);
      }
  } else {
    ml::Split asp[TM][K - 1], bsp[TN][K - 1];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int l = 0; l < K - 1; ++l) asp[i][l] = ml::split(av[i][l]);
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int l = 0; l < K - 1; ++l) bsp[j][l] = ml::split(bv[j][l]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        double p[K], s[K];
        ml::mul_limbs_split<K>(av[i], asp[i], bv[j], bsp[j], p);
        ml::add_limbs<K>(acc[i][j], p, s);
#pragma unroll
        for (int l = 0; l < K; ++l) acc[i][j][l] = s[l];
      }
  }
}

__global__ void __launch_bounds__(THREADS)
mlgemm_kernel(In a, In b, Out c, int m, int n, int k, long long stride_a,
              long long stride_b) {
  // K-major tiles; the +1 pad spreads the transposed stores over the banks
  __shared__ double as[K][BK][BM + 1];
  __shared__ double bs[K][BK][BN];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;

  double acc[TM][TN][K];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int l = 0; l < K; ++l) acc[i][j][l] = 0.0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      int r = idx / BK, kk = idx % BK;
      int gr = row0 + r, gk = k0 + kk;
      bool ok = gr < m && gk < k;
      long long off = z * stride_a + (long long)gr * k + gk;
#pragma unroll
      for (int l = 0; l < K; ++l) as[l][kk][r] = ok ? a.p[l][off] : 0.0;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      int kk = idx / BN, cc = idx % BN;
      int gk = k0 + kk, gc = col0 + cc;
      bool ok = gk < k && gc < n;
      long long off = z * stride_b + (long long)gk * n + gc;
#pragma unroll
      for (int l = 0; l < K; ++l) bs[l][kk][cc] = ok ? b.p[l][off] : 0.0;
    }
    __syncthreads();

    const int kmax = min(BK, k - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      double av[TM][K], bv[TN][K];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int l = 0; l < K; ++l) av[i][l] = as[l][kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int l = 0; l < K; ++l) bv[j][l] = bs[l][kk][tx + TX * j];
      fma_step(acc, av, bv);
    }
    __syncthreads();
  }

  const long long zoff = z * (long long)m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int cc = col0 + tx + TX * j;
      if (cc >= n) continue;
#pragma unroll
      for (int l = 0; l < K; ++l) c.p[l][zoff + (long long)r * n + cc] = acc[i][j][l];
    }
  }
}

}  // namespace

// C = A @ B at KLIMBS limbs over `batch` entries: a, b, c point at KLIMBS
// limb pointers each (host arrays); A (m, k), B (k, n), C (m, n) per entry,
// row-major contiguous f64 on the device, entry z of A at a[l] + z *
// stride_a (0: shared), of B likewise, of C at z * m * n.  Launches on
// `stream`; returns the launch's cudaGetLastError() (0 on success).
extern "C" int mlgemm(const double *const *a, const double *const *b,
                      double *const *c, int m, int n, int k, int batch,
                      long long stride_a, long long stride_b,
                      cudaStream_t stream) {
  In ai, bi;
  Out co;
  for (int l = 0; l < K; ++l) {
    ai.p[l] = a[l];
    bi.p[l] = b[l];
    co.p[l] = c[l];
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  mlgemm_kernel<<<grid, THREADS, 0, stream>>>(ai, bi, co, m, n, k, stride_a,
                                              stride_b);
  return (int)cudaGetLastError();
}
