// Batched symmetric eigen-solver: cyclic Jacobi, one warp a matrix (kernel
// K3 of the port).
//
// Replaces jnp.linalg.eigh in the reference's marginalization
// (mmloam_tpu/estimator/solver.py:368 and :376; XLA's eigen-solver, not a
// Pallas kernel), which the port ran as torch.linalg.eigh: that call reads
// its error flags on the host, a sync a CUDA graph cannot capture.  Input:
// B symmetric n x n float32 matrices (n <= 32; the marginalization's are
// 15 x 15, two calls a lockstep scan over the B lanes), read from their
// lower triangles.  Output: each matrix's eigenvalues ascending (B, n) and
// its eigenvectors as columns (B, n, n), as torch.linalg.eigh returns them.
// The algorithm, rotation for rotation, is ops/eigh.py's plain version
// (`jacobi_reference`), whose docstring states it.
//
// Design: one warp a matrix, two warps a block.  A and V sit in shared
// memory as 32 x 33 doubles each (rows padded by one word, so a lane
// walking a column and a lane walking a row spread over the banks).  The
// arithmetic is float64 (ops/eigh.py says why: the marginalization's Schur
// complement needs its eigenvectors' small components); the f32 input
// converts exactly and the results round to f32 once, at the end.  A sweep
// is the n' - 1 rounds of a round-robin tournament over n' = n + n % 2
// indices: n'/2 disjoint pairs a round, a pair with the pad index a bye (7
// pairs and a bye a round for n = 15).  In a round, lane k computes pair
// k's rotation from the round's A; then lane j applies every pair's
// rotation to column j of A's rows p and q, and lane i to row i of A's and
// V's columns p and q (the pairs are disjoint, so the order within a round
// does not matter); then the pairs' entries a_pq, a_qp are set to 0.
// Sweeps run while off(A)^2 > (tol ||A||_F)^2, up to a cap, decided in the
// warp: there is no host read.  At the end lane i takes the rank of a_ii
// among the diagonal (ties by index: a stable sort) and writes its
// eigenvalue and V's column i there.  A matrix with a non-finite entry
// gives NaN.
//
// What bounds it on an H100: nothing the card is short of.  A launch over
// 4 or 16 matrices of 15 x 15 moves ~7-30 KB and does ~0.3 MFLOP (float64)
// a matrix (~9 sweeps of n(n-1)/2 rotations, 18n + 12 operations each),
// ~10-40 ns at either peak; the kernel is one warp's serial chain of ~130
// rounds, each three shared-memory passes and four warp barriers, so its
// time is latency (PERF.md has the numbers).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// cuda_build.py): no contraction, so every product and sum rounds as the
// plain version's do.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 2;
constexpr int kStride = kLanes + 1;
constexpr unsigned kFull = 0xffffffffu;

// Pair k of round r of the tournament over m indices (p < q): m - 1 meets
// r, and (r + k) meets (r - k) modulo m - 1 (ops/eigh.pairs)
__device__ __forceinline__ void pair_of(int r, int k, int m, int& p, int& q) {
  int a, b;
  if (k == 0) {
    a = m - 1;
    b = r;
  } else {
    a = (r + k) % (m - 1);
    b = (r - k + (m - 1)) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum of squares of lane j's column of A (n x n), the diagonal left out
// unless `diag`; the warp's total in every lane
__device__ __forceinline__ double column_sumsq(const double* A, int n,
                                               int lane, bool diag) {
  double x = 0.0;
  if (lane < n) {
    for (int i = 0; i < n; ++i) {
      const double e = A[i * kStride + lane];
      if (diag || i != lane) x += e * e;
    }
  }
  return warp_sum(x);
}

__global__ void __launch_bounds__(kWarps* kLanes)
    eigh_kernel(const float* __restrict__ a, float* __restrict__ w,
                float* __restrict__ v, int batch, int n, int max_sweeps,
                double tol) {
  __shared__ double s_a[kWarps][kLanes * kStride];
  __shared__ double s_v[kWarps][kLanes * kStride];
  __shared__ double s_c[kWarps][kLanes / 2];
  __shared__ double s_s[kWarps][kLanes / 2];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // a whole warp: no block barrier follows
  double* A = s_a[warp];
  double* V = s_v[warp];
  double* C = s_c[warp];
  double* S = s_s[warp];
  const float* in = a + static_cast<size_t>(b) * n * n;
  float* wo = w + static_cast<size_t>(b) * n;
  float* vo = v + static_cast<size_t>(b) * n * n;

  // lane j loads column j from the lower triangle
  bool finite = true;
  if (lane < n) {
    for (int i = 0; i < n; ++i) {
      const float x = i >= lane ? in[i * n + lane] : in[lane * n + i];
      A[i * kStride + lane] = static_cast<double>(x);
      V[i * kStride + lane] = i == lane ? 1.0 : 0.0;
      finite = finite && isfinite(x);
    }
  }
  if (!__all_sync(kFull, finite)) {
    if (lane < n) {
      const float nan = __int_as_float(0x7fc00000);
      wo[lane] = nan;
      for (int i = 0; i < n; ++i) vo[i * n + lane] = nan;
    }
    return;
  }
  __syncwarp();

  const double thr = tol * tol * column_sumsq(A, n, lane, true);
  const int m = n + (n & 1);
  const int half = m / 2;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    if (column_sumsq(A, n, lane, false) <= thr) break;  // warp-uniform
    for (int r = 0; r < m - 1; ++r) {
      if (lane < half) {
        int p, q;
        pair_of(r, lane, m, p, q);
        double c = 1.0, s = 0.0;
        if (q < n) {
          const double apq = A[p * kStride + q];
          if (apq != 0.0) {
            const double theta =
                (A[q * kStride + q] - A[p * kStride + p]) / (2.0 * apq);
            const double u = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
            const double t = theta < 0.0 ? -u : u;
            c = 1.0 / sqrt(t * t + 1.0);
            s = t * c;
          }
        }
        C[lane] = c;
        S[lane] = s;
      }
      __syncwarp();
      if (lane < n) {  // rows p, q of A: lane j their column j
        for (int k = 0; k < half; ++k) {
          int p, q;
          pair_of(r, k, m, p, q);
          if (q >= n) continue;
          const double c = C[k], s = S[k];
          const double ap = A[p * kStride + lane];
          const double aq = A[q * kStride + lane];
          A[p * kStride + lane] = c * ap - s * aq;
          A[q * kStride + lane] = s * ap + c * aq;
        }
      }
      __syncwarp();
      if (lane < n) {  // columns p, q of A and V: lane i their row i
        double* ar = A + lane * kStride;
        double* vr = V + lane * kStride;
        for (int k = 0; k < half; ++k) {
          int p, q;
          pair_of(r, k, m, p, q);
          if (q >= n) continue;
          const double c = C[k], s = S[k];
          const double ap = ar[p], aq = ar[q];
          ar[p] = c * ap - s * aq;
          ar[q] = s * ap + c * aq;
          const double vp = vr[p], vq = vr[q];
          vr[p] = c * vp - s * vq;
          vr[q] = s * vp + c * vq;
        }
      }
      __syncwarp();
      if (lane < half) {
        int p, q;
        pair_of(r, lane, m, p, q);
        if (q < n) {
          A[p * kStride + q] = 0.0;
          A[q * kStride + p] = 0.0;
        }
      }
      __syncwarp();
    }
  }

  // ascending order, ties by index; V's columns follow their values
  if (lane < n) {
    const double d = A[lane * kStride + lane];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double e = A[j * kStride + j];
      rank += (e < d) || (e == d && j < lane);
    }
    wo[rank] = __double2float_rn(d);
    for (int i = 0; i < n; ++i)
      vo[i * n + rank] = __double2float_rn(V[i * kStride + lane]);
  }
}

}  // namespace

// Eigen-decomposition of `batch` symmetric n x n matrices `a` (row-major,
// lower triangle read) into ascending eigenvalues `w` (batch, n) and
// eigenvector columns `v` (batch, n, n) on `stream`, at most `max_sweeps`
// sweeps, stopping once off(A) <= tol ||A||_F.  Returns the launch's CUDA
// error (0 on success); launches nothing for an empty batch.
extern "C" int eigh_launch(const float* a, float* w, float* v, int batch,
                           int n, int max_sweeps, double tol, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > kLanes || max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((batch + kWarps - 1) / kWarps);
  eigh_kernel<<<grid, kWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, v, batch, n, max_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}
