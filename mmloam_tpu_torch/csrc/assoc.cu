// Fused stencil association (kernel K2 of the port).
//
// Replaces the Pallas TPU kernel scripts/pallas_assoc.py:_assoc_kernel
// (launched by _assoc_pallas, :388) together with the query addressing
// (prepare_queries) and the row gather XLA ran in front of it, and the
// Mosaic lowering probes of scripts/bisect_mosaic.py (_run_stage) and
// scripts/bisect_mosaic2.py (_run_variant, _run_solo), which become this
// kernel's compile-time stages (ops/assoc.py lists them).
//
// Per query point, from the 8 stencil superrows of one map: the query's fine
// voxel, superrow window, torus slots and epoch keys
// (voxelmap.stencil_addresses, computed here); candidate offsets and squared
// distances, rounded to bf16 when the map keeps its dense blocks in bf16
// (voxelmap.query_candidates_dense); validity (epoch key, count > 0, exact
// stencil bounds); the tie-inclusive k-th smallest d2
// (voxelmap.kth_smallest_dense); masked first and second moments; the
// closed-form fit of ops/linalg3.py (plane: TLS normal, 0.2 m planarity over
// the selected candidates, optional scatter-rank gate, |dist| > 1e-5; line:
// PCA direction, e_hi > 3 e_mid, err0 > 1e-5); and the gates n >= k,
// t_k < thres and the query mask.  Output record per query (16 floats):
// [mu(3), vec(3), valid, t_k, n, served, 0...], as the TPU kernel's lanes
// plus `served` (1 where the second map of a rescue pair answered).
//
// Entries.  Fresh: the map rows; when asked, it also writes the four dense
// candidate blocks the estimator caches.  Cached: those blocks shifted by
// pw - pw0 (voxelmap.shift_dense_blocks fused in front of the same
// selection).  Rescue pair (factors' local-map rescue, ops/assoc.py
// associate_with_rescue): the NEED stage against the persistent map writes
// the records and a flag mask & ~valid per query; the RESCUE stage then runs
// a fresh association against the local map for each flagged query whose
// rank among the flags of lower index is below the rescue cap, and
// overwrites that query's record where the local fit is valid.  Queries are
// independent, so this is the compaction, gather, association and scatter
// of the plain version (associate_with_rescue_reference) in two launches.
//
// Design: one warp per query.  Every lane computes the window's per-axis
// superrow coords, slots and key fields (2 per axis: the window is 2x2x2),
// so no lane waits for a broadcast.  The 8 rows (4 KB) come in at once:
// lane j issues its 32 read-only loads (words j, 32+j, 64+j, 96+j of each
// row: sub-cell j, coalesced across the warp) straight into registers, all
// in flight before the first store.  (Landing the rows in shared memory by
// cp.async and reading them from there measured slower on the H100: PERF.md.)
// Each lane keeps its 8 candidates in registers.  Selection is
// k rounds of a warp min over the values above the previous one, each
// followed by a warp count of the values <= it; the first value whose count
// reaches k is t_k (inf when none does).  Moments are xor-butterfly warp
// sums, which leave every lane with the same bits, so every lane runs the
// 3x3 fit and no broadcast is needed; the plane mode's planarity pass then
// checks each lane's own candidates and votes.  A rescue warp finds its rank
// from the flag bytes below it: 16 flags per 16-byte load, popc, warp sum.
//
// What bounds it on an H100: a fresh query reads 4 KB of rows (less where
// neighbouring queries share superrows, which L2 serves) and 16 B of query,
// and writes 64 B (+ 2 KB of bf16 blocks when asked); a flagship surf call
// (M = 2048) must move ~5 MB, about 1.5 us at 3.35 TB/s.  Its arithmetic
// (~30 flops per candidate) is far below the f32 rate.  With 4-16 warps per
// SM, the per-warp chain of dependent steps (query load, rows, 5 selection
// rounds, 9 warp sums, the fit) bounds it, which is why every row load of a
// query is issued at once.
//
// Built with -fmad=false (cuda_build.NVCC_FLAGS): every product rounds before
// its sum as in the plain PyTorch version, so the addresses, d2, its bf16
// rounding, t_k and n are bit-equal to ops/assoc.associate_reference.  The
// voxel index is floor of the correctly rounded quotient q / voxel, as
// voxelmap._voxel_coords divides by a tensor (not by a host scalar, which
// PyTorch's CUDA division turns into a product with the reciprocal).  The
// moment sums run in another order than torch.sum, so mu, the eigenvalues
// and vec agree to a tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// Launch arguments, mirrored field for field by ops/assoc._args_struct
// (ctypes).  Outside the anonymous namespace: assoc_launch takes it, and a
// C entry point must not have a parameter of internal linkage.
struct AssocArgs {
  const float* cells;          // fresh: (rows, 128) map superrows
  const float* pw;             // (m, 3) queries
  const unsigned char* mask;   // (m,) bool (unused by RESCUE)
  const void* blk_in[4];       // cached: dx, dy, dz, d2 blocks (m, 256)
  const float* pw0;            // cached: (m, 3) queries the blocks were made at
  void* blk_out[4];            // fresh: blocks to write, or null
  const float* thres;          // (1,) squared-distance gate
  float* out;                  // (m, 16) records
  unsigned char* valid;        // OUT, NEED, RESCUE: (m,) bool, record's lane
  float* rows;                 // GATHER: (m, 8, 128) rows read
  int* g_v;                    // GATHER: (m, 3) fine-voxel coords
  int* g_sv;                   // GATHER: (m, 8, 3) superrow coords
  int* g_slot;                 // GATHER: (m, 8) torus slots
  float* g_key;                // GATHER: (m, 8) expected epoch keys
  unsigned char* need;         // NEED: (m,) written; RESCUE: read (padded
                               // to a multiple of 16 bytes)
  int* need_count;             // NEED: (1,) number of flags, or null
  int m, mode, bf16, cached, k, rescue_cap;
  int pack[3], stencil[3], sdim[3];
  float voxel, pvs[3], scatter_ratio;
};
static_assert(sizeof(AssocArgs) == 256, "AssocArgs layout changed: update "
              "ops/assoc._args_struct");

namespace {

constexpr int kLanes = 32;             // sub-cells per superrow
constexpr int kRows = 8;               // stencil superrows per query
constexpr int kRowF = 4 * kLanes;      // floats per superrow
constexpr int kCand = kRows * kLanes;  // candidates per query
constexpr int kRec = 16;               // output floats per query
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;         // linalg3._EPS
constexpr float kTwoPiThird = 2.0943951023931953f;

enum Stage { kGather = 0, kSelect, kMoments, kEig, kOut, kNeed, kRescue };
enum Mode { kPlane = 0, kLine = 1 };

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: lane i adds x_i + x_{i^o}, its partner x_{i^o} + x_i,
  // which are the same bits, so all lanes end with one value
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.clamp(x, min=lo) and (lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.div(a, b, rounding_mode="floor") and torch.remainder on integers:
// C's / and % truncate toward zero; the floor quotient is one less where the
// remainder is nonzero and the signs differ, and the floor
// remainder takes the divisor's sign.  A power-of-two divisor (the map's
// torus dims and pack) takes the arithmetic shift and the mask, which give
// the same floor quotient and remainder without an integer division.
__device__ __forceinline__ bool pow2(int b) { return b > 0 && !(b & (b - 1)); }
__device__ __forceinline__ int floor_div(int a, int b) {
  if (pow2(b)) return a >> (__ffs(b) - 1);
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) {
  if (pow2(b)) return a & (b - 1);
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// One axis of voxelmap.stencil_addresses / _super_decompose: the window's
// two superrow coords sv, their torus indices mt and key fields kq
__device__ __forceinline__ void stencil_axis(int v, int st, int p, int sd,
                                             int sv[2], int mt[2],
                                             int kq[2]) {
  const int s0 = floor_div(v - st, p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sv[i] = s0 + i;
    mt[i] = floor_mod(sv[i], sd);
    kq[i] = min(max(floor_div(sv[i] - mt[i], sd) + 16, 0), 31);
  }
}

// floor(q / voxel) as int32: the correctly rounded quotient, floored, then
// converted as torch's .to(torch.int32) converts on the card
__device__ __forceinline__ int voxel_index(float q, float voxel) {
  return static_cast<int>(floorf(__fdiv_rn(q, voxel)));
}

// Number of flagged queries of lower index than q (the rank of q's rescue
// slot, factors._compact_indices): 16 flag bytes (0 or 1) per 16-byte load
__device__ int rescue_rank(const unsigned char* __restrict__ need, int q,
                           int lane) {
  const uint4* f = reinterpret_cast<const uint4*>(need);
  int c = 0;
  for (int j = lane; 16 * j < q; j += kLanes) {
    const uint4 w = f[j];
    const unsigned wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int below = q - (16 * j + 4 * i);  // flags of this word below q
      unsigned bits = below > 0 ? (wd[i] & 0x01010101u) : 0u;
      if (below > 0 && below < 4) bits &= (1u << (8 * below)) - 1u;
      c += __popc(bits);
    }
  }
  return __reduce_add_sync(kFull, c);
}

__device__ __forceinline__ float load_blk(const void* p, long long i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_blk(void* p, long long i, float x,
                                          bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// linalg3.eigvalsh3, formula for formula: ascending eigenvalues of the
// symmetric part read from the upper triangle of A
__device__ void eigvalsh3(const float A[3][3], float ev[3]) {
  const float a00 = A[0][0], a11 = A[1][1], a22 = A[2][2];
  const float a01 = A[0][1], a02 = A[0][2], a12 = A[1][2];
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
  const float p = sqrtf(clamp_min(p2, kEps) / 6.0f);
  const float b00 = d0 / p, b11 = d1 / p, b22 = d2 / p;
  const float b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const float det = b00 * (b11 * b22 - b12 * b12) -
                    b01 * (b01 * b22 - b12 * b02) +
                    b02 * (b01 * b12 - b11 * b02);
  const float r = clamp(det / 2.0f, -1.0f, 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float e_hi = q + 2.0f * p * cosf(phi);
  const float e_lo = q + 2.0f * p * cosf(phi + kTwoPiThird);
  const float e_mid = 3.0f * q - e_hi - e_lo;
  const bool diag = p2 < kEps;
  ev[0] = diag ? q : e_lo;
  ev[1] = diag ? q : e_mid;
  ev[2] = diag ? q : e_hi;
}

// linalg3._largest_column of (A - la I)(A - lb I): the column with the
// largest norm (first on ties), normalized; `fb` where its norm is <= 1e-9
__device__ void eigvec3(const float A[3][3], float la, float lb,
                        const float fb[3], float vec[3]) {
  float L[3][3], R[3][3], M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      L[i][j] = i == j ? A[i][j] - la : A[i][j];
      R[i][j] = i == j ? A[i][j] - lb : A[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = L[i][0] * R[0][j] + L[i][1] * R[1][j] + L[i][2] * R[2][j];
  float nrm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    nrm[j] = sqrtf(M[0][j] * M[0][j] + M[1][j] * M[1][j] + M[2][j] * M[2][j]);
  int best = 0;
  if (nrm[1] > nrm[best]) best = 1;
  if (nrm[2] > nrm[best]) best = 2;
  const float v0 = M[0][best], v1 = M[1][best], v2 = M[2][best];
  const float n = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
  const bool ok = n > 1e-9f;
  const float c = clamp_min(n, 1e-9f);
  vec[0] = ok ? v0 / c : fb[0];
  vec[1] = ok ? v1 / c : fb[1];
  vec[2] = ok ? v2 / c : fb[2];
}

__device__ __forceinline__ void write_record(float* out, int q,
                                             const float rec[kRec]) {
  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(q) *
                                                    kRec);
#pragma unroll
  for (int i = 0; i < kRec / 4; ++i)
    dst[i] = make_float4(rec[4 * i], rec[4 * i + 1], rec[4 * i + 2],
                         rec[4 * i + 3]);
}

template <int kStage>
__global__ void __launch_bounds__(kWarpsPerBlock * kLanes)
    assoc_kernel(const AssocArgs a) {
  const int wid = threadIdx.x / kLanes;
  const int q = blockIdx.x * kWarpsPerBlock + wid;
  const int lane = threadIdx.x % kLanes;
  if (q >= a.m) return;  // the whole warp leaves together
  const float thres = a.thres[0];  // in flight with the query's loads
  bool mask;
  if constexpr (kStage == kRescue) {
    if (!a.need[q]) return;
    if (a.rescue_cap < a.m && rescue_rank(a.need, q, lane) >= a.rescue_cap)
      return;
    mask = true;  // factors' mask_r: every compacted query is live
  } else {
    mask = a.mask[q] != 0;
  }
  const bool bf16 = a.bf16 != 0;
  const long long cand0 = static_cast<long long>(q) * kCand + lane;

  // ---- candidates: offsets (dx, dy, dz) and squared distance d2 ----
  float dx[kRows], dy[kRows], dz[kRows], d2[kRows];
  if (kStage == kRescue || !a.cached) {
    const int px = a.pack[0], py = a.pack[1], pz = a.pack[2];
    const int sub_x = lane / (py * pz);
    const int sub_y = (lane / pz) % py;
    const int sub_z = lane % pz;
    const float off_x = static_cast<float>(sub_x) * a.voxel;
    const float off_y = static_cast<float>(sub_y) * a.voxel;
    const float off_z = static_cast<float>(sub_z) * a.voxel;
    const float qx = a.pw[3 * q], qy = a.pw[3 * q + 1], qz = a.pw[3 * q + 2];

    // stencil addressing (voxelmap.stencil_addresses), per axis
    const int vx = voxel_index(qx, a.voxel), vy = voxel_index(qy, a.voxel);
    const int vz = voxel_index(qz, a.voxel);
    int svx[2], svy[2], svz[2], mx[2], my[2], mz[2], kx[2], ky[2], kz[2];
    stencil_axis(vx, a.stencil[0], px, a.sdim[0], svx, mx, kx);
    stencil_axis(vy, a.stencil[1], py, a.sdim[1], svy, my, ky);
    stencil_axis(vz, a.stencil[2], pz, a.sdim[2], svz, mz, kz);
    int slot[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s)  // meshgrid "ij" order of the window
      slot[s] = (mx[s >> 2] * a.sdim[1] + my[(s >> 1) & 1]) * a.sdim[2] +
                mz[s & 1];

    // every row load of the query in flight before the first use
    float fx[kRows], fy[kRows], fz[kRows], fm[kRows];
    const float* __restrict__ cells = a.cells;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const float* row = cells + static_cast<long long>(slot[s]) * kRowF;
      fx[s] = __ldg(row + lane);
      fy[s] = __ldg(row + kLanes + lane);
      fz[s] = __ldg(row + 2 * kLanes + lane);
      fm[s] = __ldg(row + 3 * kLanes + lane);
    }

    if constexpr (kStage == kGather) {
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        const long long e = static_cast<long long>(q) * kRows + s;
        float* dst = a.rows + e * kRowF;
        dst[lane] = fx[s];
        dst[kLanes + lane] = fy[s];
        dst[2 * kLanes + lane] = fz[s];
        dst[3 * kLanes + lane] = fm[s];
        if (lane == s) {
          a.g_sv[3 * e] = svx[s >> 2];
          a.g_sv[3 * e + 1] = svy[(s >> 1) & 1];
          a.g_sv[3 * e + 2] = svz[s & 1];
          a.g_slot[e] = slot[s];
          a.g_key[e] = static_cast<float>(
              (kx[s >> 2] << 10) | (ky[(s >> 1) & 1] << 5) | kz[s & 1]);
        }
      }
      if (lane == 0) {
        a.g_v[3 * q] = vx;
        a.g_v[3 * q + 1] = vy;
        a.g_v[3 * q + 2] = vz;
      }
      return;
    }

#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int ix = s >> 2, iy = (s >> 1) & 1, iz = s & 1;
      const float key = static_cast<float>((kx[ix] << 10) | (ky[iy] << 5) |
                                           kz[iz]);
      const float key_st = floorf(fm[s] / 128.0f);
      const float cnt = fm[s] - key_st * 128.0f;
      const bool ok = key_st == key && cnt > 0.0f && mask &&
                      abs(svx[ix] * px + sub_x - vx) <= a.stencil[0] &&
                      abs(svy[iy] * py + sub_y - vy) <= a.stencil[1] &&
                      abs(svz[iz] * pz + sub_z - vz) <= a.stencil[2];
      const float inv_cnt = 1.0f / clamp_min(cnt, 1.0f);
      const float bx = static_cast<float>(svx[ix]) * a.pvs[0] - qx;
      const float by = static_cast<float>(svy[iy]) * a.pvs[1] - qy;
      const float bz = static_cast<float>(svz[iz]) * a.pvs[2] - qz;
      float ox = bx + off_x + fx[s] * inv_cnt;
      float oy = by + off_y + fy[s] * inv_cnt;
      float oz = bz + off_z + fz[s] * inv_cnt;
      float dd = ok ? ox * ox + oy * oy + oz * oz : INFINITY;
      if (bf16) {
        ox = round_bf16(ox);
        oy = round_bf16(oy);
        oz = round_bf16(oz);
        dd = round_bf16(dd);
      }
      dx[s] = ox;
      dy[s] = oy;
      dz[s] = oz;
      d2[s] = dd;
    }
    if (kStage != kRescue && a.blk_out[0] != nullptr) {
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        const long long c = cand0 + s * kLanes;
        store_blk(a.blk_out[0], c, dx[s], bf16);
        store_blk(a.blk_out[1], c, dy[s], bf16);
        store_blk(a.blk_out[2], c, dz[s], bf16);
        store_blk(a.blk_out[3], c, d2[s], bf16);
      }
    }
  } else {
    const float ex = a.pw[3 * q] - a.pw0[3 * q];
    const float ey = a.pw[3 * q + 1] - a.pw0[3 * q + 1];
    const float ez = a.pw[3 * q + 2] - a.pw0[3 * q + 2];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const long long c = cand0 + s * kLanes;
      // torch.isfinite: false for inf and NaN
      const bool ok = fabsf(load_blk(a.blk_in[3], c, bf16)) < INFINITY;
      float ox = load_blk(a.blk_in[0], c, bf16) - ex;
      float oy = load_blk(a.blk_in[1], c, bf16) - ey;
      float oz = load_blk(a.blk_in[2], c, bf16) - ez;
      float dd = ok ? ox * ox + oy * oy + oz * oz : INFINITY;
      if (bf16) {
        ox = round_bf16(ox);
        oy = round_bf16(oy);
        oz = round_bf16(oz);
        dd = round_bf16(dd);
      }
      dx[s] = ox;
      dy[s] = oy;
      dz[s] = oz;
      d2[s] = dd;
    }
  }

  float rec[kRec];
#pragma unroll
  for (int i = 0; i < kRec; ++i) rec[i] = 0.0f;

  // ---- selection: tie-inclusive k-th smallest d2 (NaN never selected) ----
  float t_k = INFINITY;
  float last = -INFINITY;
  for (int i = 0; i < a.k; ++i) {
    float mn = INFINITY;
#pragma unroll
    for (int s = 0; s < kRows; ++s)
      mn = fminf(mn, d2[s] > last ? d2[s] : INFINITY);
    mn = warp_min(mn);
    int c = 0;
#pragma unroll
    for (int s = 0; s < kRows; ++s) c += d2[s] <= mn;
    if (__reduce_add_sync(kFull, c) >= a.k) {
      t_k = mn;
      break;
    }
    last = mn;
  }
  float w[kRows];
  int nl = 0;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    w[s] = d2[s] <= t_k ? 1.0f : 0.0f;
    nl += d2[s] <= t_k;
  }
  const float n = static_cast<float>(__reduce_add_sync(kFull, nl));
  if constexpr (kStage == kSelect) {
    if (lane == 0) {
      rec[7] = t_k;
      rec[8] = n;
      write_record(a.out, q, rec);
    }
    return;
  }

  // ---- moments of the selected offsets ----
  float s1x = 0.f, s1y = 0.f, s1z = 0.f, sxx = 0.f, sxy = 0.f, sxz = 0.f;
  float syy = 0.f, syz = 0.f, szz = 0.f;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const float wx = dx[s] * w[s], wy = dy[s] * w[s], wz = dz[s] * w[s];
    s1x += wx;
    s1y += wy;
    s1z += wz;
    sxx += wx * dx[s];
    sxy += wx * dy[s];
    sxz += wx * dz[s];
    syy += wy * dy[s];
    syz += wy * dz[s];
    szz += wz * dz[s];
  }
  s1x = warp_sum(s1x);
  s1y = warp_sum(s1y);
  s1z = warp_sum(s1z);
  sxx = warp_sum(sxx);
  sxy = warp_sum(sxy);
  sxz = warp_sum(sxz);
  syy = warp_sum(syy);
  syz = warp_sum(syz);
  szz = warp_sum(szz);
  if constexpr (kStage == kMoments) {
    if (lane == 0) {
      const float r[11] = {s1x, s1y, s1z, sxx, sxy, sxz, syy, syz, szz, t_k, n};
#pragma unroll
      for (int i = 0; i < 11; ++i) rec[i] = r[i];
      write_record(a.out, q, rec);
    }
    return;
  }

  // ---- closed-form fit (every lane holds the same sums) ----
  const float nf = clamp_min(n, 1.0f);
  const float mu[3] = {s1x / nf, s1y / nf, s1z / nf};
  const float S2[3][3] = {{sxx, sxy, sxz}, {sxy, syy, syz}, {sxz, syz, szz}};
  float A[3][3];
  const bool line = a.mode == kLine;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = line ? S2[i][j] / nf - mu[j] * mu[i]
                     : S2[i][j] - nf * mu[j] * mu[i];
  float ev[3], vec[3];
  eigvalsh3(A, ev);
  if (line) {
    const float fb[3] = {1.0f, 0.0f, 0.0f};
    eigvec3(A, ev[1], ev[0], fb, vec);
  } else {
    const float fb[3] = {0.0f, 0.0f, 1.0f};
    eigvec3(A, ev[1], ev[2], fb, vec);
  }
  if constexpr (kStage == kEig) {
    if (lane == 0) {
      const float r[6] = {ev[0], ev[1], ev[2], vec[0], vec[1], vec[2]};
#pragma unroll
      for (int i = 0; i < 6; ++i) rec[i] = r[i];
      write_record(a.out, q, rec);
    }
    return;
  }

  // ---- gates ----
  bool shape_ok;
  float err0;
  if (line) {
    shape_ok = ev[2] > 3.0f * ev[1];
    const float ax = -mu[0], ay = -mu[1], az = -mu[2];
    const float c0 = ay * vec[2] - az * vec[1];
    const float c1 = az * vec[0] - ax * vec[2];
    const float c2 = ax * vec[1] - ay * vec[0];
    err0 = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
  } else {
    const float dist = -(vec[0] * mu[0] + vec[1] * mu[1] + vec[2] * mu[2]);
    bool bad = false;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const float dev =
          w[s] * (dx[s] * vec[0] + dy[s] * vec[1] + dz[s] * vec[2] + dist);
      bad = bad || !(fabsf(dev) <= 0.2f);
    }
    shape_ok = !__any_sync(kFull, bad);
    if (a.scatter_ratio > 0.0f)
      shape_ok = shape_ok && ev[1] > a.scatter_ratio * ev[2];
    err0 = fabsf(dist);
  }
  const bool valid = mask && n >= static_cast<float>(a.k) && t_k < thres &&
                     shape_ok && err0 > 1e-5f;
  if (lane == 0) {
    if constexpr (kStage == kRescue) {
      if (!valid) return;  // the first map's record stays
    }
    const float r[10] = {mu[0],  mu[1], mu[2], vec[0], vec[1], vec[2],
                         valid ? 1.0f : 0.0f, t_k, n,
                         kStage == kRescue ? 1.0f : 0.0f};
#pragma unroll
    for (int i = 0; i < 10; ++i) rec[i] = r[i];
    write_record(a.out, q, rec);
    a.valid[q] = valid ? 1 : 0;
    if constexpr (kStage == kNeed) {
      const bool need = mask && !valid;
      a.need[q] = need ? 1 : 0;
      if (need && a.need_count != nullptr) atomicAdd(a.need_count, 1);
    }
  }
}

template <int kStage>
int launch(const AssocArgs& a, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * kLanes);
  const dim3 grid((a.m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  assoc_kernel<kStage><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the association kernel stopped after `stage` (0 GATHER, 1
// SELECT, 2 MOMENTS, 3 EIG, 4 OUT, 5 NEED, 6 RESCUE) on `stream`; returns
// cudaGetLastError() (0 on success).  `args` is read on the host only.
extern "C" int assoc_launch(int stage, const AssocArgs* args, void* stream) {
  if (args->m <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fresh = !args->cached;
  switch (stage) {
    case kGather:
      if (!fresh) return static_cast<int>(cudaErrorInvalidValue);
      return launch<kGather>(*args, s);
    case kSelect: return launch<kSelect>(*args, s);
    case kMoments: return launch<kMoments>(*args, s);
    case kEig: return launch<kEig>(*args, s);
    case kOut: return launch<kOut>(*args, s);
    case kNeed: return launch<kNeed>(*args, s);
    case kRescue:
      if (!fresh) return static_cast<int>(cudaErrorInvalidValue);
      return launch<kRescue>(*args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
