// Damped block-tridiagonal solve of one Levenberg-Marquardt iteration, one
// thread block a lane (kernel K4 of the port).
//
// Replaces no Pallas kernel: it replaces the XLA-fused jnp chain of the
// reference's damped solve (mmloam_tpu/estimator/solver.py, `_damped_solve`
// with `_block_thomas` and `_gj_inv15`), which the port ran as ~400 small
// torch launches an LM iteration (ops/damped_solve.py's plain version).
// Input, per lane of B: the window's normal equations diag (W, 15, 15), up
// (W - 1, 15, 15) (block i couples frames i and i + 1), b (W, 15), the
// damping lam and the trust radius (one float each); output dx (W, 15).
// The arithmetic, operation for operation, is the plain version's
// (ops/damped_solve.py states it), in float32:
//   1. gmax_g = max(0, amax of diag's diagonal over the window and over the
//      group g of three dims); floor_g = 1e-6 max(gmax_g, 1e-12); a dim is
//      observable where its diagonal entry d > floor (NaN propagates
//      through the maxima as in torch.amax and torch.clamp);
//   2. s = 1 / sqrt(d) on observable dims, 0 elsewhere (correctly rounded
//      sqrtf and a true division);
//   3. A_i = (diag_i s_r) s_c + (lam + 1e-5 + [unobservable]) I, U_i =
//      (up_i s_r) s'_c, rhs = -(b s);
//   4. block-Thomas in _block_thomas's order: Dinv_0 = GJ(A_0); L = U^T
//      Dinv_{i-1}, Dinv_i = GJ(A_i - L U), y_i = rhs_i - L y_{i-1}; then
//      x_{W-1} = Dinv y, x_i = Dinv_i (y_i - U_i x_{i+1}).  GJ is the
//      pivot-free Gauss-Jordan of _gj_inv15 on [A | I]: at step k the
//      pivot row is divided by its pivot, every row r gets a_rj - a_rk p_j
//      and row k becomes p;
//   5. dx = s x, a non-finite entry 0, then dx min(radius / max(|dx|,
//      1e-12), 1) over the lane's whole window.
// The sums keep the orders torch's kernels give the plain version of one
// lane on the card (measured on an H100 with torch 2.11, CUDA 12.8), so a
// lane's dx is the plain version's at B = 1 bit for bit: a matrix product
// is cuBLAS's SGEMM, a fused multiply-add a term in index order from 0,
// except L U, which the one-lane SGEMM splits into terms 0-7 and 8-14 added
// at the end; a matrix-vector product (`lie.mv`) is torch's row sum of the
// rounded products, and the window's norm torch's row sum of the squares
// (`torch_row_sum`).  A lane reads only its own inputs and keeps these
// orders at every B, so its bits do not depend on B or on the other
// lanes; torch's own orders change with the batch (its batched SGEMM does
// not split L U, its norm takes 32 threads a row from B = 16 on), so
// against the plain version of a batch the kernel agrees within float32
// rounding.
//
// What bounds it on an H100: latency.  A lane at W = 5 reads 8.7 KB and
// does ~1.3e5 float32 operations (at B = 16: 0.04 us of bytes, 0.03 us of
// operations).  Its time is the dependent chain: W inverses of 15 pivot
// steps each (a division, a product and a difference), W - 1 pairs of
// dependent 15 x 15 block products between them, and 2W - 1 dependent
// matrix-vector products back.  The design: one block a lane (B blocks:
// one wave up to 132 lanes), the lane's whole system in shared memory
// (33 KB at the largest window, static).  Each inverse runs in warp 0
// from registers: lane j holds column j of [S | I], a pivot step takes
// the pivot row's entries of column k by shuffles and needs no barrier.
// The block products between two inverses put one output entry on a
// thread of the block's 15 warps (225 at once); the back substitution
// runs in warp 0 with warp barriers only.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// cuda_build.py): no contraction, so every product and sum rounds alone as
// the plain version's elementwise ones do; the SGEMM's fused terms are
// written out (__fmaf_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kN = 15;               // state dims a frame
constexpr int kN2 = kN * kN;
constexpr int kAug = 2 * kN;         // a row of [S | I]
constexpr int kGroups = kN / 3;      // P phi V bg ba
constexpr int kMaxW = 16;
constexpr int kThreads = kN * 32;    // warp r: row r of [S | I]

struct Shared {
  float a[kMaxW][kN2];     // the damped scaled diagonal blocks, then Dinv
  float u[kMaxW - 1][kN2]; // the scaled coupling blocks
  float y[kMaxW][kN];      // rhs, then the forward substitution's y
  float x[kMaxW][kN];      // the solution, then dx
  float s[kMaxW][kN];      // the Jacobi scale
  float dd[kMaxW][kN];     // the damping added to each diagonal entry
  float gfloor[kGroups];
  float l[kN2];            // L = U^T Dinv
  float t[kN];             // y_i - U_i x_{i+1}
  float q[kMaxW * kN];     // the step's squares
  float p[128];            // their partial sums (torch_row_sum)
};

// torch.amax / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp(a, min=lo) and (a, max=hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return a < lo ? lo : a;
}

__device__ __forceinline__ float clamp_max(float a, float hi) {
  return a > hi ? hi : a;
}

// Entry (i, j) of a 15 x 15 matrix product a b (a's row i at stride sa, b's
// column j at stride sb) in index order from 0, a fused multiply-add a term
// (`lo`, `hi`: terms [lo, hi) only), as cuBLAS's SGEMM sums it.
__device__ __forceinline__ float gemm15(const float* a, int sa,
                                        const float* b, int sb, int lo = 0,
                                        int hi = kN) {
  float acc = 0.0f;
  for (int m = lo; m < hi; ++m) acc = __fmaf_rn(a[m * sa], b[m * sb], acc);
  return acc;
}

// torch's sum of a row of n <= 256 floats p, as its reduction kernel adds a
// row alone on the card: w = the largest power of 2 <= n threads, thread x
// adding p[x] and p[x + w] to its accumulators (from 0, then its two empty
// ones), halved in shared memory from w / 2 down to 32 threads, then
// shuffles down by w / 2 (16 at most), ..., 2, 1.  Run by one whole warp
// (each of its threads gets the sum); `part` holds w floats.
__device__ __forceinline__ float torch_row_sum(const float* p, int n,
                                               float* part) {
  const int t = threadIdx.x & 31;
  int w = 1;
  while (2 * w <= n) w *= 2;
  for (int x = t; x < w; x += 32) {
    const float hi = x + w < n ? 0.0f + p[x + w] : 0.0f;
    part[x] = (((0.0f + p[x]) + hi) + 0.0f) + 0.0f;
  }
  __syncwarp();
  for (int off = w / 2; off >= 32; off >>= 1) {
    for (int x = t; x < off; x += 32) part[x] = part[x] + part[x + off];
    __syncwarp();
  }
  const int dim = w < 32 ? w : 32;
  float v = t < dim ? part[t] : 0.0f;
  for (int off = dim / 2; off > 0; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// The same for a row of 15 products held by one thread (the plain
// version's `lie.mv`): 8 threads a row, thread x adding entries x and
// x + 8, then shuffles down by 4, 2, 1.
__device__ __forceinline__ float torch_sum15(const float (&p)[kN]) {
  float q[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const float hi = x + 8 < kN ? 0.0f + p[x + 8] : 0.0f;
    q[x] = (((0.0f + p[x]) + hi) + 0.0f) + 0.0f;
  }
  return ((q[0] + q[4]) + (q[2] + q[6])) + ((q[1] + q[5]) + (q[3] + q[7]));
}

// Pivot-free Gauss-Jordan of [S | I] (_gj_inv15) in one warp: lane j < 30
// holds column j in a[0..14] (lanes 30, 31 zeros); on return lanes 15 ..
// 29 hold the inverse's columns.  Step k divides lane j's row-k entry by
// the pivot (lane k's), then every row r gets a_rj - a_rk p_j, a_rk from
// lane k, and row k becomes p.
__device__ __forceinline__ void gauss_jordan(float (&a)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float a_k[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) a_k[r] = __shfl_sync(0xffffffffu, a[r], k);
    const float p = a[k] / a_k[k];
#pragma unroll
    for (int r = 0; r < kN; ++r) a[r] = r == k ? p : a[r] - a_k[r] * p;
  }
}

__global__ void __launch_bounds__(kThreads)
lm_damped_solve_kernel(const float* __restrict__ diag,
                       const float* __restrict__ up,
                       const float* __restrict__ b,
                       const float* __restrict__ lam,
                       const float* __restrict__ radius,
                       float* __restrict__ dx, int W) {
  __shared__ Shared sm;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, row = tid >> 5, col = tid & 31;
  const float* d_in = diag + static_cast<size_t>(lane) * W * kN2;
  const float* u_in = up + static_cast<size_t>(lane) * (W - 1) * kN2;
  const float* b_in = b + static_cast<size_t>(lane) * W * kN;
  float* A = &sm.a[0][0];              // the blocks, flat
  float* Us = &sm.u[0][0];
  float* Y = &sm.y[0][0];
  const float* S = &sm.s[0][0];
  for (int i = tid; i < W * kN2; i += kThreads) A[i] = d_in[i];
  for (int i = tid; i < (W - 1) * kN2; i += kThreads) Us[i] = u_in[i];
  for (int i = tid; i < W * kN; i += kThreads) Y[i] = b_in[i];
  __syncthreads();

  // 1. the per-group floors of the diagonal
  if (tid < kGroups) {
    float g = -INFINITY;
    for (int w = 0; w < W; ++w)
      for (int c = 3 * tid; c < 3 * tid + 3; ++c)
        g = max_nan(g, sm.a[w][c * (kN + 1)]);
    g = clamp_min(g, 0.0f);
    sm.gfloor[tid] = static_cast<float>(1e-6) *
                    clamp_min(g, static_cast<float>(1e-12));
  }
  __syncthreads();
  // 2. the scale and the damping of each dim
  if (tid < W * kN) {
    const int w = tid / kN, c = tid % kN;
    const float d = sm.a[w][c * (kN + 1)], fl = sm.gfloor[c / 3];
    const bool observable = d > fl;
    sm.s[w][c] = observable ? 1.0f / sqrtf(max_nan(d, fl)) : 0.0f;
    sm.dd[w][c] = (lam[lane] + static_cast<float>(1e-5)) +
                  (observable ? 0.0f : 1.0f);
  }
  __syncthreads();
  // 3. the damped scaled system
  for (int i = tid; i < W * kN2; i += kThreads) {
    const int w = i / kN2, r = i % kN2 / kN, c = i % kN;
    const float v = A[i] * sm.s[w][r] * sm.s[w][c];
    A[i] = v + sm.dd[w][r] * (r == c ? 1.0f : 0.0f);
  }
  for (int i = tid; i < (W - 1) * kN2; i += kThreads) {
    const int w = i / kN2, r = i % kN2 / kN, c = i % kN;
    Us[i] = Us[i] * sm.s[w][r] * sm.s[w + 1][c];
  }
  for (int i = tid; i < W * kN; i += kThreads) Y[i] = -(Y[i] * S[i]);
  __syncthreads();

  // 4. block-Thomas: forward.  S_i replaces A_i, then Dinv_i replaces S_i
  for (int i = 0; i < W; ++i) {
    if (i > 0) {
      const float* U = sm.u[i - 1];
      const float* Dp = sm.a[i - 1];
      if (col < kN)                       // L = U^T Dinv_{i-1}
        sm.l[row * kN + col] = gemm15(U + row, kN, Dp + col, kN);
      __syncthreads();
      if (col < kN) {                     // S = A_i - L U
        const float* l = sm.l + row * kN;  // as one-lane SGEMM splits it
        sm.a[i][row * kN + col] =
            sm.a[i][row * kN + col] - (gemm15(l, 1, U + col, kN, 0, 8) +
                                       gemm15(l, 1, U + col, kN, 8, kN));
      } else if (col == kN) {             // y_i = rhs_i - L y_{i-1}
        float p[kN];
        for (int m = 0; m < kN; ++m)
          p[m] = sm.l[row * kN + m] * sm.y[i - 1][m];
        sm.y[i][row] = sm.y[i][row] - torch_sum15(p);
      }
      __syncthreads();
    }
    if (row == 0) {
      float a[kN];
#pragma unroll
      for (int r = 0; r < kN; ++r)
        a[r] = col < kN ? sm.a[i][r * kN + col]
                        : (col - kN == r ? 1.0f : 0.0f);
      __syncwarp();
      gauss_jordan(a);
      if (col >= kN && col < kAug) {
#pragma unroll
        for (int r = 0; r < kN; ++r) sm.a[i][r * kN + col - kN] = a[r];
      }
    }
    __syncthreads();
  }

  // 4. back substitution, and 5. the scale and the cap, in warp 0
  if (row != 0) return;
  const int r = col;
  float p[kN];
  if (r < kN) {
    for (int m = 0; m < kN; ++m)
      p[m] = sm.a[W - 1][r * kN + m] * sm.y[W - 1][m];
    sm.x[W - 1][r] = torch_sum15(p);
  }
  __syncwarp();
  for (int i = W - 2; i >= 0; --i) {
    if (r < kN) {
      for (int m = 0; m < kN; ++m)
        p[m] = sm.u[i][r * kN + m] * sm.x[i + 1][m];
      sm.t[r] = sm.y[i][r] - torch_sum15(p);
    }
    __syncwarp();
    if (r < kN) {
      for (int m = 0; m < kN; ++m) p[m] = sm.a[i][r * kN + m] * sm.t[m];
      sm.x[i][r] = torch_sum15(p);
    }
    __syncwarp();
  }
  if (r < kN) {
    for (int w = 0; w < W; ++w) {
      float d = sm.s[w][r] * sm.x[w][r];
      d = isfinite(d) ? d : 0.0f;
      sm.x[w][r] = d;
      sm.q[w * kN + r] = d * d;
    }
  }
  __syncwarp();
  const float sq = torch_row_sum(sm.q, W * kN, sm.p);
  const float scale = clamp_max(
      radius[lane] / clamp_min(sqrtf(sq), static_cast<float>(1e-12)), 1.0f);
  if (r < kN) {
    float* out = dx + static_cast<size_t>(lane) * W * kN;
    for (int w = 0; w < W; ++w) out[w * kN + r] = sm.x[w][r] * scale;
  }
}

}  // namespace

// Launch K4 over `batch` lanes on `stream`: diag (batch, window, 15, 15),
// up (batch, window - 1, 15, 15), b (batch, window, 15), lam and radius
// (batch,), dx (batch, window, 15), float32, contiguous.  Returns the CUDA
// error of the launch (0: launched).
extern "C" int lm_damped_solve_launch(const float* diag, const float* up,
                                      const float* b, const float* lam,
                                      const float* radius, float* dx,
                                      int batch, int window, void* stream) {
  if (batch <= 0) return 0;
  if (window < 1 || window > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  lm_damped_solve_kernel<<<batch, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      diag, up, b, lam, radius, dx, window);
  return static_cast<int>(cudaGetLastError());
}
