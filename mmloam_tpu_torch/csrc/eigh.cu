// Batched symmetric eigen-solver: cyclic Jacobi, one thread block a matrix
// (kernel K3 of the port).
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
// (`jacobi_reference`), whose docstring states it.  The arithmetic is
// float64 (ops/eigh.py says why); the f32 input converts exactly and the
// results round to f32 once, at the end.
//
// A sweep is the n' - 1 rounds of a round-robin tournament over n' = n +
// n % 2 indices: n'/2 disjoint pairs (p, q) a round, a pair with the pad
// index n (odd n) a bye.  The host passes the tournament as a table
// (ops/eigh.schedule, built from the plain version's `pairs`) and, for
// each pair of each round, where its a_pp, a_qq and a_pq lie in the round
// before (ops/eigh.lookahead); the block copies both into shared memory.
//
// Design: one block a matrix (grid = B).  Each thread after warp 0 owns a
// 2 x 2 block: thread (k, l), k, l < n'/2, owns A's entries {p_k, q_k} x
// {p_l, q_l} and V's entries {p_l, q_l} x {p_k, q_k}, so every entry has
// exactly one owner in a round.  It rotates its four entries of A by pair
// k across the rows and then by pair l across the columns (a bye is the
// identity on its one real index; a diagonal block, k = l, zeroes a_pq
// and a_qp), and its four entries of V's columns by pair k.  A round
// reads one of two copies of A in shared memory and writes the other, and
// V in place, and ends in one __syncthreads.  Warp 0 computes rotations,
// lane j pair j, a round ahead: in round r it evaluates the next round's
// a_pp, a_qq and a_pq of its pair from round r's A and rotations exactly
// as their blocks' owners do (`entry00`), takes the rotation (the same
// operations as the plain version's, so the same bits) and publishes it
// for the owners' next round.  So a round's updates and the next round's
// rotations run side by side, in different warps (one thread computing
// two rotations, or a warp its updates and a rotation, runs them one
// after the other: each division and square root is a branch region of
// its own, which the compiler does not interleave).  Round 0's rotations
// come straight from the input, while the other warps copy the tables and
// A.  The last round of a sweep also sums the squares of the off-diagonal
// entries the owners wrote (warp shuffles, then the warps' sums in shared
// memory, added in warp order by every thread) on that round's barrier:
// the stop test off(A)^2 <= (tol ||A||_F)^2 is the same in every thread,
// with no host read.  At the end each warp ranks its share of the
// diagonal by ballots (ties by index: a stable sort) and writes those
// eigenvalues; the block then writes V's columns at their ranks.  A
// matrix with a non-finite entry gives NaN.  Shared memory: two copies of
// A and V, 32 x 34 doubles each (odd n's pad row and column zero), the
// rotations, tables and sums: 30.3 KB, static.  Threads: 32 and the 2 x 2
// blocks rounded up to whole warps (96 at n = 15, 288 at n = 32).
//
// What bounds it on an H100: latency.  A launch over 4 or 16 matrices of
// 15 x 15 moves ~7-30 KB and does ~0.3 MFLOP (float64) a matrix (~9
// sweeps of n(n-1)/2 rotations, 18n + 12 operations each), ~10-40 ns at
// either peak (the roofline bound).  Its time is rounds x warp 0's path:
// the barrier, the loads of the look-ahead's twelve entries and four
// rotation values, four dependent levels of multiply and subtract, and
// one rotation's chain of three float64 divisions and two square roots
// (~490 cycles alone), ~0.5 us a round.  What it does about the costs of
// the earlier design, one warp a matrix: the pairs' rotations run side by
// side, a round ahead, in a warp of their own; no lane walks the pairs in
// turn (each entry is updated once a round, by its owner, in registers);
// the pairs and look-ahead records come from the host's tables, with no
// integer division or modulus in a round; one barrier a round, not four.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// cuda_build.py): no contraction, so every product and sum rounds as the
// plain version's do.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kMaxN = 32;
// rows padded to an even stride: the entries a round reads lie along
// diagonals (a pair's p + q is the same for every pair of a round), and
// with a stride of 2 mod 16 doubles neither diagonals nor anti-diagonals
// fall into one bank
constexpr int kStride = kMaxN + 2;
constexpr int kMaxPairs = kMaxN / 2;
constexpr int kMaxRounds = kMaxN - 1;
// warp 0 computes the rotations; a thread a 2 x 2 block after it
constexpr int kMaxThreads = 32 + kMaxPairs * kMaxPairs;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kLoads = 4;  // n^2 <= 4 x the threads a launch has, n <= 32
constexpr int kRanks = 8;  // n <= 8 x the warps a launch has
constexpr unsigned kFull = 0xffffffffu;

// The tables the host builds (ops/eigh.schedule and lookahead): pair k of
// round r is (p, q) = (pq[2 (r n'/2 + k)], pq[2 (r n'/2 + k) + 1]), p <
// q, q = n a bye; ahead[r n'/2 + j] says where pair (p, q) = j of the
// next round finds its a_pp, a_qq and a_pq in round r's output.  p lies
// in round r's pair kp = {p0, p1}, p = p0, and q in pair kq = {q0, q1},
// q = q0: a_pp is entry (0, 0) of the block of rows and columns (p0, p1),
// a_qq of (q0, q1), a_pq of rows (p0, p1) and columns (q0, q1).  Listing
// a pair's sought index first makes it row (and column) 0: where it is
// the pair's second index, the rotation's s enters negated, which rounds
// exactly as the owner's update of row 1.  Bits 0-4 p0, 5-9 p1, 10-14 q0,
// 15-19 q1, 20-23 kp, 24-27 kq; 28: kp's s negated, 29: kq's; 30: the
// next pair is a bye; 31: a_pq is zeroed (kp = kq).
struct Schedule {
  alignas(16) unsigned char pq[2 * kMaxRounds * kMaxPairs];
  alignas(16) unsigned int ahead[kMaxRounds * kMaxPairs];
};

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The rotation (c, s) that zeroes a_pq, p < q (Numerical Recipes 11.1, as
// ops/eigh._rotation)
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s) {
  c = 1.0;
  s = 0.0;
  if (apq != 0.0) {
    const double theta = (aqq - app) / (2.0 * apq);
    const double u = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
    const double t = theta < 0.0 ? -u : u;
    c = 1.0 / sqrt(t * t + 1.0);
    s = t * c;
  }
}

// Entry (0, 0) of a 2 x 2 block after the round: rows rotated by (cK,
// sK), then columns by (cL, sL).  A bye's (c, s) is (1, 0) and its pad
// row and column are 0, so it leaves the entry as it was but perhaps for
// the sign of a zero, which no rotation computed from it can see.
__device__ __forceinline__ double entry00(double x00, double x01, double x10,
                                          double x11, double cK, double sK,
                                          double cL, double sL) {
  const double y0 = cK * x00 - sK * x10, y1 = cK * x01 - sK * x11;
  return cL * y0 - sL * y1;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    eigh_kernel(const float* __restrict__ a, float* __restrict__ w,
                float* __restrict__ v, int n, int max_sweeps, double tol,
                const __grid_constant__ Schedule sched) {
  __shared__ double s_a[2][kMaxN * kStride];
  __shared__ double s_v[kMaxN * kStride];
  __shared__ double s_rot[2][3][32];  // (c, s, -s) by lane of warp 0
  __shared__ double s_red[3][kMaxWarps];
  __shared__ __align__(16) unsigned char s_pq[2 * kMaxRounds * kMaxPairs];
  __shared__ __align__(16) unsigned int s_ahead[kMaxRounds * kMaxPairs];
  __shared__ int s_rank[kMaxN];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int m = n + (n & 1), half = m / 2, rounds = m - 1;
  const float* in = a + static_cast<size_t>(blockIdx.x) * n * n;
  float* wo = w + static_cast<size_t>(blockIdx.x) * n;
  float* vo = v + static_cast<size_t>(blockIdx.x) * n * n;

  // A read as it lies (coalesced, every load issued first); entry (i, j),
  // i >= j, stored at (i, j) and (j, i); t / n as (t inv) >> 16, exact
  // for t < n^2 <= 1024.  No branch: a slot past n^2, or in the upper
  // triangle, writes a pad word no round reads (row 0, column 33).  V = I,
  // odd n's pad row and column 0; ||A||_F^2 and off(A)^2.
  const unsigned inv = (65536u + n - 1) / n;
  float x[kLoads];
#pragma unroll
  for (int t = 0; t < kLoads; ++t)
    x[t] = in[min(tid + t * static_cast<int>(blockDim.x), n * n - 1)];
  // Warp 0: lane j holds the rotation of pair j mod n'/2 of the round and
  // computes the next round's.  Round 0's it takes from a_pp, a_qq and
  // a_pq as they lie in the input (a_pq, p < q, at (q, p) of the lower
  // triangle, as the block stores it), loaded with the rest, so it need
  // not wait for A in shared memory.
  const bool rot = warp == 0;
  const int j = lane % half;
  const int jp = sched.pq[2 * j], jq = sched.pq[2 * j + 1];
  float a0pp = 0.0f, a0qq = 0.0f, a0pq = 0.0f;
  if (rot) {
    const int q = min(jq, n - 1);
    a0pp = in[jp * n + jp];
    a0qq = in[q * n + q];
    a0pq = in[q * n + jp];
  } else {
    // while the loads are in flight, warps 1 on copy the tables
    const int npq = (2 * rounds * half + 15) / 16;
    const int nall = npq + (4 * rounds * half + 15) / 16;
    for (int idx = tid - 32; idx < nall; idx += blockDim.x - 32) {
      if (idx < npq)
        reinterpret_cast<uint4*>(s_pq)[idx] =
            reinterpret_cast<const uint4*>(sched.pq)[idx];
      else
        reinterpret_cast<uint4*>(s_ahead)[idx - npq] =
            reinterpret_cast<const uint4*>(sched.ahead)[idx - npq];
    }
  }
  if (rot) {  // round 0's rotations
    double c = 1.0, s = 0.0;
    if (jq < n) rotation(a0pp, a0qq, a0pq, c, s);
    s_rot[0][0][lane] = c;
    s_rot[0][1][lane] = s;
    s_rot[0][2][lane] = -s;
  }
  bool finite = true;
  double all = 0.0, off = 0.0;
#pragma unroll
  for (int t = 0; t < kLoads; ++t) {
    const int e = tid + t * blockDim.x;
    const int i = static_cast<int>((e * inv) >> 16), c = e - i * n;
    const bool in_a = e < n * n, low = in_a && i >= c;
    const double d = static_cast<double>(x[t]), d2 = low ? d * d : 0.0;
    s_a[0][low ? i * kStride + c : kStride - 1] = d;
    s_a[0][low ? c * kStride + i : kStride - 1] = d;
    s_v[in_a ? i * kStride + c : kStride - 1] = i == c ? 1.0 : 0.0;
    finite = finite && (!low || isfinite(x[t]));
    const double twice = i != c ? d2 + d2 : 0.0;
    all += i == c ? d2 : twice;
    off += twice;
  }
  if (n & 1) {
    for (int i = tid; i < m; i += blockDim.x) {
      s_a[0][n * kStride + i] = s_a[0][i * kStride + n] = 0.0;
      s_a[1][n * kStride + i] = s_a[1][i * kStride + n] = 0.0;
      s_v[n * kStride + i] = s_v[i * kStride + n] = 0.0;
    }
  }
  all = warp_sum(all);
  off = warp_sum(off);
  if (lane == 0) {
    s_red[0][warp] = all;
    s_red[1][warp] = off;
  }
  if (__syncthreads_or(!finite)) {  // block-uniform
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < n * n; idx += blockDim.x) vo[idx] = nan;
    if (tid < n) wo[tid] = nan;
    return;
  }
  double off2 = 0.0, all2 = 0.0;
  for (int k = 0; k < warps; ++k) {
    all2 += s_red[0][k];
    off2 += s_red[1][k];
  }
  const double thr = tol * tol * all2;
  const int u = tid - 32;
  const bool item = !rot && u < half * half;
  const int k = item ? u / half : 0;
  const int l = item ? u - k * half : 0;
  unsigned h = s_ahead[j];
  int pk = s_pq[2 * k], qk = s_pq[2 * k + 1];
  int pl = s_pq[2 * l], ql = s_pq[2 * l + 1];
  int cur = 0;  // A's copy this round reads; the rotations' too
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    if (off2 <= thr) break;  // block-uniform
    for (int r = 0; r < rounds; ++r) {
      const bool last = r == rounds - 1;
      const int rn = last ? 0 : r + 1;
      const double* Ac = s_a[cur];
      double part = 0.0;
      if (rot) {
        // the next round's a_pp, a_qq, a_pq of pair j, as their blocks'
        // owners compute them, then its rotation
        const int p0 = h & 31, p1 = h >> 5 & 31, q0 = h >> 10 & 31,
                  q1 = h >> 15 & 31, kp = h >> 20 & 15, kq = h >> 24 & 15;
        const double* a0 = Ac + p0 * kStride;
        const double* a1 = Ac + p1 * kStride;
        const double* b0 = Ac + q0 * kStride;
        const double* b1 = Ac + q1 * kStride;
        const double e00 = a0[p0], e01 = a0[p1], e10 = a1[p0], e11 = a1[p1];
        const double f00 = b0[q0], f01 = b0[q1], f10 = b1[q0], f11 = b1[q1];
        const double g00 = a0[q0], g01 = a0[q1], g10 = a1[q0], g11 = a1[q1];
        const double cp = s_rot[cur][0][kp];
        const double sp = s_rot[cur][1 + (h >> 28 & 1)][kp];
        const double cq = s_rot[cur][0][kq];
        const double sq = s_rot[cur][1 + (h >> 29 & 1)][kq];
        const bool bye = h >> 30 & 1;
        const double app = entry00(e00, e01, e10, e11, cp, sp, cp, sp);
        const double aqq = entry00(f00, f01, f10, f11, cq, sq, cq, sq);
        const double gpq = entry00(g00, g01, g10, g11, cp, sp, cq, sq);
        const double apq = h >> 31 ? 0.0 : gpq;
        h = s_ahead[rn * half + j];
        double c = 1.0, s = 0.0;
        if (!bye) rotation(app, aqq, apq, c, s);
        s_rot[cur ^ 1][0][lane] = c;
        s_rot[cur ^ 1][1][lane] = s;
        s_rot[cur ^ 1][2][lane] = -s;
      } else if (item) {
        const double ck = s_rot[cur][0][k], sk = s_rot[cur][1][k];
        const double cl = s_rot[cur][0][l], sl = s_rot[cur][1][l];
        const double x00 = Ac[pk * kStride + pl], x01 = Ac[pk * kStride + ql];
        const double x10 = Ac[qk * kStride + pl], x11 = Ac[qk * kStride + ql];
        double* v0 = s_v + pl * kStride;
        double* v1 = s_v + ql * kStride;
        const double v00 = v0[pk], v01 = v0[qk], v10 = v1[pk], v11 = v1[qk];
        const bool rk = qk < n, rl = ql < n;  // not a bye
        double y00 = x00, y01 = x01, y10 = x10, y11 = x11;
        if (rk) {  // rows p_k, q_k
          y00 = ck * x00 - sk * x10;
          y10 = sk * x00 + ck * x10;
          y01 = ck * x01 - sk * x11;
          y11 = sk * x01 + ck * x11;
        }
        double z00 = y00, z01 = y01, z10 = y10, z11 = y11;
        if (rl) {  // then columns p_l, q_l
          z00 = cl * y00 - sl * y01;
          z01 = sl * y00 + cl * y01;
          z10 = cl * y10 - sl * y11;
          z11 = sl * y10 + cl * y11;
        }
        if (k == l && rk) z01 = z10 = 0.0;
        double* An = s_a[cur ^ 1];
        An[pk * kStride + pl] = z00;
        if (rl) An[pk * kStride + ql] = z01;
        if (rk) An[qk * kStride + pl] = z10;
        if (rk && rl) An[qk * kStride + ql] = z11;
        if (rk) {  // V's columns p_k, q_k in rows p_l, q_l
          v0[pk] = ck * v00 - sk * v01;
          v0[qk] = sk * v00 + ck * v01;
          if (rl) {
            v1[pk] = ck * v10 - sk * v11;
            v1[qk] = sk * v10 + ck * v11;
          }
        }
        if (last && k != l) {  // off-diagonal: all four entries
          part = z00 * z00;
          if (rl) part += z01 * z01;
          if (rk) part += z10 * z10;
          if (rk && rl) part += z11 * z11;
        }
        pk = s_pq[2 * (rn * half + k)];
        qk = s_pq[2 * (rn * half + k) + 1];
        pl = s_pq[2 * (rn * half + l)];
        ql = s_pq[2 * (rn * half + l) + 1];
      }
      cur ^= 1;
      if (last) {
        // the sweep's off(A)^2; slots 1 and 2 alternate, so no thread
        // writes a slot that another may still read
        double* red = s_red[1 + ((sweep + 1) & 1)];
        if (!rot) part = warp_sum(part);  // warp 0 has none
        if (lane == 0) red[warp] = part;
        __syncthreads();
        off2 = 0.0;
        for (int i = 0; i < warps; ++i) off2 += red[i];
      } else {
        __syncthreads();
      }
    }
  }

  // ascending order, ties by index (a stable sort): warp w ranks a_ii, i
  // = w, w + warps, ..., against every lane's a_jj at once by a ballot,
  // its diagonal entries read first; V's columns follow their values
  {
    const double* Af = s_a[cur];
    const double dj = lane < n ? Af[lane * (kStride + 1)] : 0.0;
    double di[kRanks];
#pragma unroll
    for (int t = 0; t < kRanks; ++t)
      di[t] = Af[min(warp + t * warps, n - 1) * (kStride + 1)];
    int rank = 0;
    double dl = 0.0;
#pragma unroll
    for (int t = 0; t < kRanks; ++t) {
      const unsigned before = __ballot_sync(
          kFull, lane < n && (dj < di[t] ||
                              (dj == di[t] && lane < warp + t * warps)));
      if (lane == t) {  // lane t writes the warp's row t
        rank = __popc(before);
        dl = di[t];
      }
    }
    const int i = warp + lane * warps;
    if (lane < kRanks && i < n) {
      s_rank[i] = rank;
      wo[rank] = __double2float_rn(dl);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = static_cast<int>((idx * inv) >> 16), j2 = idx - i * n;
    vo[i * n + s_rank[j2]] = __double2float_rn(s_v[i * kStride + j2]);
  }
}

}  // namespace

// Eigen-decomposition of `batch` symmetric n x n matrices `a` (row-major,
// lower triangle read) into ascending eigenvalues `w` (batch, n) and
// eigenvector columns `v` (batch, n, n) on `stream`, at most `max_sweeps`
// sweeps, stopping once off(A) <= tol ||A||_F.  `schedule` holds the
// sweep's tournament, (n' - 1) x n'/2 pairs (p, q) of bytes, p < q <= n
// (q = n a bye), n' = n + n % 2 (ops/eigh.schedule), then as many
// look-ahead records, 32-bit little-endian (ops/eigh.lookahead); both are
// copied into the launch's arguments.  Returns the launch's CUDA error (0
// on success); launches nothing for an empty batch.
extern "C" int eigh_launch(const float* a, float* w, float* v, int batch,
                           int n, int max_sweeps, double tol,
                           const unsigned char* schedule, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > kMaxN || max_sweeps < 0 || schedule == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = n + (n & 1), half = m / 2, pairs = (m - 1) * half;
  Schedule sched;
  memset(&sched, 0, sizeof sched);
  memcpy(sched.pq, schedule, 2 * pairs);
  for (int i = 0; i < pairs; ++i) {
    const unsigned char* b = schedule + 2 * pairs + 4 * i;
    sched.ahead[i] = b[0] | b[1] << 8 | b[2] << 16 |
                     static_cast<unsigned>(b[3]) << 24;
    const int h = static_cast<int>(sched.ahead[i] & 0x0fffffffu);
    const bool bad_pair =
        sched.pq[2 * i] >= sched.pq[2 * i + 1] || sched.pq[2 * i + 1] > n;
    const bool bad_ahead = (h & 31) > n || (h >> 5 & 31) > n ||
                           (h >> 10 & 31) > n || (h >> 15 & 31) > n ||
                           (h >> 20 & 15) >= half || (h >> 24 & 15) >= half;
    if (bad_pair || bad_ahead)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 32 + (half * half + 31) / 32 * 32;
  if (n * n > kLoads * threads || n > kRanks * (threads / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  eigh_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, v, n, max_sweeps, tol, sched);
  return static_cast<int>(cudaGetLastError());
}
