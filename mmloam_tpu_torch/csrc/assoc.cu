// Fused stencil association (kernel K2 of the port).
//
// Replaces the Pallas TPU kernel scripts/pallas_assoc.py:_assoc_kernel
// (launched by _assoc_pallas, :388) together with the query addressing
// (prepare_queries) and the row gather XLA ran in front of it, and the
// Mosaic lowering probes of scripts/bisect_mosaic.py (_run_stage) and
// scripts/bisect_mosaic2.py (_run_variant, _run_solo), which become this
// kernel's compile-time stages (ops/assoc.py lists them).
//
// Per query point, from the stencil superrows of one map: the query's fine
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
// Lanes.  A batch of independent sequences (the lockstep replay's lanes) is
// one launch: queries, masks, records, dense blocks and GATHER outputs are
// lane-major (lanes, m, ...) and a warp's query row q belongs to lane q / m.
// Each lane reads its own map (lane * cells_stride floats in), its own
// distance gate and dedup bound, and writes, counts and ranks its own rescue
// flags (need_stride bytes a lane), so every result equals a launch on that
// lane alone.  The per-warp table and buffer are a warp's, whatever its
// lane: the grid grows with the lanes, a block's shared memory does not.
//
// Other maps.  The above is the default window's instance (32 cells a row,
// a 2x2x2-superrow window; with MapConfig.dedup_gather too).  Any other
// pack and stencil (S superrows of cpr cells, voxelmap._super_window, C = S
// cpr candidates a query) runs a general instance; ops/assoc.instance picks
// it on the host and passes it in the arguments.  Candidate c lives on lane
// c mod 32, in the reference's order (window meshgrid "ij", then sub-cell
// meshgrid "ij").  The warp first addresses each window row once: lane r
// computes rows r, r+32, ... (slot, expected key, the row's offset from the
// query, its stencil base) into a per-warp table in shared memory, 32 B a
// row.  A lane then walks its candidates c, c+32, ... with no division: the
// step of 32 candidates is q32 rows and r32 sub-cells (32 = q32 cpr + r32),
// added digit by digit in the pack's mixed radix.  A row of one cell
// (pack (1,1,1)) is read by one 16-byte load.  Instances of 4, 8 and 16
// candidates a lane keep them in registers (up to 512 a query); a larger
// window stages them in the per-warp buffer (d2 and three offsets, 16 B a
// candidate, 8 B with bf16 dense blocks: 864 candidates take 13.8 or 6.9
// KB), and selection (from each lane's 8 smallest d2), moments and the
// planarity vote run over the staged values.  The buffer is dynamic shared
// memory (above 48 KB by cudaFuncSetAttribute, with fewer warps a block
// where 8 do not fit), or a slice of a device buffer the wrapper allocates
// when one warp's does not fit in a block's 227 KB.  Padding candidates
// hold d2 = NaN, so they are never selected, counted or weighted.  With
// MapConfig.dedup_gather the wrapper computes one bound a launch on the
// device (voxelmap.dedup_threshold: the largest slot whose unique rank is
// below the compact table's capacity); a row above it is invalid and reads
// the bound's row, which is what the reference's compact table serves it
// (voxelmap._dedup_gather_rows), so the candidates agree bit for bit.
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
#include <limits.h>
#include <math.h>

#include <type_traits>

// Launch arguments, mirrored field for field by ops/assoc._args_struct
// (ctypes).  Outside the anonymous namespace: assoc_launch takes it, and a
// C entry point must not have a parameter of internal linkage.
struct AssocArgs {
  const float* cells;          // fresh: (rows, 4 cpr) map superrows
  const float* pw;             // (lanes, m, 3) queries
  const unsigned char* mask;   // (m,) bool (unused by RESCUE)
  const void* blk_in[4];       // cached: dx, dy, dz, d2 blocks (m, ncand)
  const float* pw0;            // cached: (m, 3) queries the blocks were made at
  void* blk_out[4];            // fresh: blocks to write, or null
  const float* thres;          // (lanes,) squared-distance gate of each lane
  float* out;                  // (m, 16) records
  unsigned char* valid;        // OUT, NEED, RESCUE: (m,) bool, record's lane
  float* rows;                 // GATHER: (m, S, 4 cpr) rows read
  int* g_v;                    // GATHER: (m, 3) fine-voxel coords
  int* g_sv;                   // GATHER: (m, S, 3) superrow coords
  int* g_slot;                 // GATHER: (m, S) torus slots
  float* g_key;                // GATHER: (m, S) expected epoch keys
  unsigned char* need;         // NEED: (lanes, need_stride) written;
                               // RESCUE: read (16-byte rows)
  int* need_count;             // NEED: (lanes,) number of flags, or null
  const int* dedup_thr;        // fresh: (lanes,) dedup bound of each lane
                               // (MapConfig.dedup_gather), or null
  unsigned char* g_keep;       // GATHER: (m, S) rows the dedup kept
  float* scratch;              // (lanes m, warp_words) per-warp buffers in
                               // device memory, or null: in shared memory
  long long cells_stride;      // floats from one lane's map to the next's
  int m;                       // queries a lane; the arrays above that have
                               // an m axis hold lanes x m rows, lane-major
  int lanes;                   // lanes of the batch, one launch for all
  int need_stride;             // flag bytes a lane (m padded to 16)
  int mode, bf16, cached, k, rescue_cap;
  int pack[3], stencil[3], sdim[3];
  int nb[3];                   // superrows of the window per axis (S = their
                               // product)
  int cpr, ncand;              // cells a row; candidates a query, S cpr
  int inst;                    // ops/assoc.INSTANCES: 0 default window, 1-3
                               // 4, 8, 16 candidates a lane, 4 staged
  int wpb, warp_words;         // warps a block; floats of a warp's buffer
  float voxel, pvs[3], scatter_ratio;
};
static_assert(sizeof(AssocArgs) == 328, "AssocArgs layout changed: update "
              "ops/assoc._args_struct");

namespace {

constexpr int kLanes = 32;             // sub-cells per superrow
constexpr int kRows = 8;               // stencil superrows per query
constexpr int kRowF = 4 * kLanes;      // floats per superrow
constexpr int kCand = kRows * kLanes;  // candidates per query
constexpr int kRec = 16;               // output floats per query
constexpr int kMaxWarps = 8;          // warps a block (fewer where a
                                       // warp's buffer is large)
constexpr int kStaged = 0;             // kPer of the staged instance
constexpr int kRowWords = 8;           // table words a window row
constexpr int kBatch = 8;              // staged candidates loaded together
constexpr int kTop = 8;                // staged d2 a lane keeps to select
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

// What differs between the lanes of a batch, for one query: its lane's map
// rows, dedup bound (INT_MAX without one), rescue flags and flag count, and
// the query's index within the lane
struct LaneView {
  const float* cells;
  int thr;
  unsigned char* need;
  int* need_count;
  int i;
};

// A lane's candidates, in registers (kPer of them) ...
template <int kPer>
struct RegCands {
  static constexpr bool kRegs = true;
  static constexpr int kN = kPer;
  float dx[kPer], dy[kPer], dz[kPer], d2[kPer];
  __device__ __forceinline__ int n() const { return kPer; }
  __device__ __forceinline__ float& x(int i) { return dx[i]; }
  __device__ __forceinline__ float& y(int i) { return dy[i]; }
  __device__ __forceinline__ float& z(int i) { return dz[i]; }
  __device__ __forceinline__ float& d(int i) { return d2[i]; }
};

// ... or staged in the warp's buffer: four arrays (dx, dy, dz, d2) of `per`
// x 32 values, the lane's i-th candidate at [i * 32 + lane], so a warp's
// accesses touch consecutive words.  With bf16 dense blocks the values are
// bf16 already (rounded as the blocks are), so they are staged as bf16,
// exactly, in half the shared memory.
struct StagedCands {
  static constexpr bool kRegs = false;
  static constexpr int kN = 0;
  float* p;
  int per, lane;
  bool half;
  __device__ __forceinline__ int n() const { return per; }
  __device__ __forceinline__ float at(int a, int i) const {
    const int k = (a * per + i) * kLanes + lane;
    return half ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[k])
                : p[k];
  }
  __device__ __forceinline__ void set(int a, int i, float v) {
    const int k = (a * per + i) * kLanes + lane;
    if (half)
      reinterpret_cast<__nv_bfloat16*>(p)[k] = __float2bfloat16_rn(v);
    else
      p[k] = v;
  }
  __device__ __forceinline__ float x(int i) const { return at(0, i); }
  __device__ __forceinline__ float y(int i) const { return at(1, i); }
  __device__ __forceinline__ float z(int i) const { return at(2, i); }
  __device__ __forceinline__ float d(int i) const { return at(3, i); }
};

template <int kPer>
__device__ __forceinline__ void put(RegCands<kPer>& st, int i, float x,
                                    float y, float z, float d) {
  st.dx[i] = x;
  st.dy[i] = y;
  st.dz[i] = z;
  st.d2[i] = d;
}

__device__ __forceinline__ void put(StagedCands& st, int i, float x, float y,
                                    float z, float d) {
  st.set(0, i, x);
  st.set(1, i, y);
  st.set(2, i, z);
  st.set(3, i, d);
}

// padding: d2 NaN is never below a threshold, never counted, zero weight
template <class St>
__device__ __forceinline__ void pad(St& st, int i) {
  put(st, i, 0.0f, 0.0f, 0.0f, __int_as_float(0x7fc00000));
}

// Candidate c of a query: window row s = c / cpr and sub-cell j = c % cpr,
// (jx, jy, jz) in the pack's meshgrid "ij"
struct Walk {
  int s, j, jx, jy, jz;
};

__device__ __forceinline__ Walk walk_at(int c, int cpr, const int p[3]) {
  Walk w;
  w.s = c / cpr;
  w.j = c - w.s * cpr;
  w.jx = w.j / (p[1] * p[2]);
  w.jy = (w.j / p[2]) % p[1];
  w.jz = w.j % p[2];
  return w;
}

// From candidate c to c + 32 (32 = q32 cpr + r32): r32 sub-cells added digit
// by digit in the pack's mixed radix, the carry out of the x digit and q32
// to the row
__device__ __forceinline__ void walk_next(Walk& w, const Walk& r32, int q32,
                                          int cpr, const int p[3]) {
  w.j += r32.j;
  if (w.j >= cpr) w.j -= cpr;
  w.jz += r32.jz;
  int c = w.jz >= p[2];
  if (c) w.jz -= p[2];
  w.jy += r32.jy + c;
  c = w.jy >= p[1];
  if (c) w.jy -= p[1];
  w.jx += r32.jx + c;
  c = w.jx >= p[0];
  if (c) w.jx -= p[0];
  w.s += q32 + c;
}

// The per-warp table of the general window's S rows, kRowWords words a row
// as arrays of S: the row read (the dedup bound's row where the dedup drops
// it), its expected key (NaN where dropped: never matched), the offset of
// its superrow corner from the query (sv * pack * voxel - q) and its stencil
// base (sv * pack - v) per axis
struct Table {
  int* slot;
  float* key;
  float* b;
  int* base;
  __device__ __forceinline__ Table(float* p, int S)
      : slot(reinterpret_cast<int*>(p)), key(p + S), b(p + 2 * S),
        base(reinterpret_cast<int*>(p + 5 * S)) {}
};

// The default window's candidates, fresh (or RESCUE), into st; GATHER
// writes the rows read and the addresses instead and returns true.
// kDedup: the launch carries a dedup bound (a launch without one compiles
// to no dedup code at all)
template <int kStage, bool kDedup, class St>
__device__ __forceinline__ bool default_fresh(const AssocArgs& a,
                                              const LaneView& lv, int q,
                                              int lane, bool mask, St& st) {
  const bool bf16 = a.bf16 != 0;
  const long long cand0 = static_cast<long long>(q) * kCand + lane;
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
  // a row whose slot is above the dedup bound is dropped and reads the
  // bound's row, as the reference's compact table serves it
  const int thr = kDedup ? lv.thr : INT_MAX;
  const int thr_row = max(thr, 0);  // a bound below every slot reads row 0
  int slot[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s)  // meshgrid "ij" order of the window
    slot[s] = (mx[s >> 2] * a.sdim[1] + my[(s >> 1) & 1]) * a.sdim[2] +
              mz[s & 1];

  // every row load of the query in flight before the first use
  float fx[kRows], fy[kRows], fz[kRows], fm[kRows];
  const float* __restrict__ cells = lv.cells;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int rs = slot[s] <= thr ? slot[s] : thr_row;
    const float* row = cells + static_cast<long long>(rs) * kRowF;
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
        a.g_keep[e] = slot[s] <= thr ? 1 : 0;
      }
    }
    if (lane == 0) {
      a.g_v[3 * q] = vx;
      a.g_v[3 * q + 1] = vy;
      a.g_v[3 * q + 2] = vz;
    }
    return true;
  }

#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int ix = s >> 2, iy = (s >> 1) & 1, iz = s & 1;
    const float key = static_cast<float>((kx[ix] << 10) | (ky[iy] << 5) |
                                         kz[iz]);
    const float key_st = floorf(fm[s] / 128.0f);
    const float cnt = fm[s] - key_st * 128.0f;
    const bool ok = slot[s] <= thr && key_st == key && cnt > 0.0f && mask &&
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
    put(st, s, ox, oy, oz, dd);
  }
  if (kStage != kRescue && a.blk_out[0] != nullptr) {
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const long long c = cand0 + s * kLanes;
      store_blk(a.blk_out[0], c, st.x(s), bf16);
      store_blk(a.blk_out[1], c, st.y(s), bf16);
      store_blk(a.blk_out[2], c, st.z(s), bf16);
      store_blk(a.blk_out[3], c, st.d(s), bf16);
    }
  }
  return false;
}

// The general window's candidates, fresh (or RESCUE): the row table first,
// then each lane's candidates into st; GATHER writes the rows read and the
// addresses instead and returns true
template <int kStage, class St>
__device__ __forceinline__ bool general_fresh(const AssocArgs& a,
                                              const LaneView& lv, int q,
                                              int lane, bool mask,
                                              float* wbuf, St& st) {
  const bool bf16 = a.bf16 != 0;
  const int cpr = a.cpr, S = a.ncand / cpr;
  const float qv[3] = {a.pw[3 * q], a.pw[3 * q + 1], a.pw[3 * q + 2]};
  int v[3], s0[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    v[ax] = voxel_index(qv[ax], a.voxel);
    s0[ax] = floor_div(v[ax] - a.stencil[ax], a.pack[ax]);
  }
  const int thr = lv.thr;
  const int thr_row = max(thr, 0);  // a bound below every slot reads row 0

  // each window row addressed once a warp: lane r takes rows r, r+32, ...
  const Table t(wbuf, S);
  const int nb12 = a.nb[1] * a.nb[2];
  for (int s = lane; s < S; s += kLanes) {
    const int o[3] = {s / nb12, (s / a.nb[2]) % a.nb[1], s % a.nb[2]};
    int sv[3], mt[3], kq[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      sv[ax] = s0[ax] + o[ax];
      mt[ax] = floor_mod(sv[ax], a.sdim[ax]);
      kq[ax] = min(max(floor_div(sv[ax] - mt[ax], a.sdim[ax]) + 16, 0), 31);
      t.base[ax * S + s] = sv[ax] * a.pack[ax] - v[ax];
      t.b[ax * S + s] = static_cast<float>(sv[ax]) * a.pvs[ax] - qv[ax];
    }
    const int slot = (mt[0] * a.sdim[1] + mt[1]) * a.sdim[2] + mt[2];
    const float key = static_cast<float>((kq[0] << 10) | (kq[1] << 5) | kq[2]);
    const bool keep = slot <= thr;
    t.slot[s] = keep ? slot : thr_row;
    t.key[s] = keep ? key : __int_as_float(0x7fc00000);
    if constexpr (kStage == kGather) {
      const long long es = static_cast<long long>(q) * S + s;
      a.g_sv[3 * es] = sv[0];
      a.g_sv[3 * es + 1] = sv[1];
      a.g_sv[3 * es + 2] = sv[2];
      a.g_slot[es] = slot;
      a.g_key[es] = key;
      a.g_keep[es] = keep ? 1 : 0;
    }
  }
  __syncwarp();

  const long long rowf = 4LL * cpr;
  const float* __restrict__ cells = lv.cells;
  // a row of one cell is one 16-byte load
  const bool vec4 =
      cpr == 1 && (reinterpret_cast<unsigned long long>(cells) & 15) == 0;
  const int q32 = kLanes / cpr;
  const Walk r32 = walk_at(kLanes - q32 * cpr, cpr, a.pack);
  // the words of candidate w's cell (a padding candidate, w.s >= S, reads
  // the window's first: every load is issued, none waits on a branch)
  auto words = [&](const Walk& w, auto vec_tag) {
    const bool in = w.s < S;
    const float* row = cells + t.slot[in ? w.s : 0] * rowf + (in ? w.j : 0);
    if constexpr (decltype(vec_tag)::value)
      return __ldg(reinterpret_cast<const float4*>(row));
    else
      return make_float4(__ldg(row), __ldg(row + cpr), __ldg(row + 2 * cpr),
                         __ldg(row + 3 * cpr));
  };

  if constexpr (kStage == kGather) {
    for (Walk w = walk_at(lane, cpr, a.pack); w.s < S;
         walk_next(w, r32, q32, cpr, a.pack)) {
      const float4 wd = vec4 ? words(w, std::true_type{})
                             : words(w, std::false_type{});
      float* dst = a.rows + (static_cast<long long>(q) * S + w.s) * rowf + w.j;
      dst[0] = wd.x;
      dst[cpr] = wd.y;
      dst[2 * cpr] = wd.z;
      dst[3 * cpr] = wd.w;
    }
    if (lane == 0) {
      a.g_v[3 * q] = v[0];
      a.g_v[3 * q + 1] = v[1];
      a.g_v[3 * q + 2] = v[2];
    }
    return true;
  }

  // offsets (bx + sub * voxel) + sum * inv_cnt and d2, as the plain version
  // rounds them
  auto value = [&](const Walk& w, const float4& wd, int i) {
    const float key_st = floorf(wd.w / 128.0f);
    const float cnt = wd.w - key_st * 128.0f;
    const bool ok =
        key_st == t.key[w.s] && cnt > 0.0f && mask &&
        abs(t.base[w.s] + w.jx) <= a.stencil[0] &&
        abs(t.base[S + w.s] + w.jy) <= a.stencil[1] &&
        abs(t.base[2 * S + w.s] + w.jz) <= a.stencil[2];
    const float inv_cnt = 1.0f / clamp_min(cnt, 1.0f);
    float ox = t.b[w.s] + static_cast<float>(w.jx) * a.voxel + wd.x * inv_cnt;
    float oy = t.b[S + w.s] + static_cast<float>(w.jy) * a.voxel +
               wd.y * inv_cnt;
    float oz = t.b[2 * S + w.s] + static_cast<float>(w.jz) * a.voxel +
               wd.z * inv_cnt;
    float dd = ok ? ox * ox + oy * oy + oz * oz : INFINITY;
    if (bf16) {
      ox = round_bf16(ox);
      oy = round_bf16(oy);
      oz = round_bf16(oz);
      dd = round_bf16(dd);
    }
    put(st, i, ox, oy, oz, dd);
  };

  // the candidates, the row layout's loads chosen once (vec_tag)
  auto fill = [&](auto vec_tag) {
    if constexpr (St::kRegs) {
      // every row load of the query in flight before the first use
      float4 wd[St::kN];
      Walk w = walk_at(lane, cpr, a.pack);
#pragma unroll
      for (int i = 0; i < St::kN; ++i) {
        wd[i] = words(w, vec_tag);
        walk_next(w, r32, q32, cpr, a.pack);
      }
      w = walk_at(lane, cpr, a.pack);
#pragma unroll
      for (int i = 0; i < St::kN; ++i) {
        if (w.s < S)
          value(w, wd[i], i);
        else
          pad(st, i);
        walk_next(w, r32, q32, cpr, a.pack);
      }
    } else {
      // kBatch candidates at a time, their row loads in flight together
      Walk w = walk_at(lane, cpr, a.pack);
      for (int i0 = 0; i0 < st.n(); i0 += kBatch) {
        Walk ws[kBatch];
        float4 wd[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          ws[j] = w;
          wd[j] = words(w, vec_tag);
          walk_next(w, r32, q32, cpr, a.pack);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (i0 + j >= st.n()) break;
          if (ws[j].s < S)
            value(ws[j], wd[j], i0 + j);
          else
            pad(st, i0 + j);
        }
      }
    }
  };
  if (vec4)
    fill(std::true_type{});
  else
    fill(std::false_type{});
  if (kStage != kRescue && a.blk_out[0] != nullptr) {
    const long long cand0 = static_cast<long long>(q) * a.ncand + lane;
#pragma unroll
    for (int i = 0; i < st.n(); ++i) {
      if (lane + kLanes * i >= a.ncand) break;
      const long long c = cand0 + i * kLanes;
      store_blk(a.blk_out[0], c, st.x(i), bf16);
      store_blk(a.blk_out[1], c, st.y(i), bf16);
      store_blk(a.blk_out[2], c, st.z(i), bf16);
      store_blk(a.blk_out[3], c, st.d(i), bf16);
    }
  }
  return false;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The cached entry of a general window: its blocks (of type T) read a
// batch at a time (all of a lane's candidates when they are in registers,
// kBatch when staged), every load of a batch in flight together, a padding
// candidate reading the query's first
template <class T, class Shift, class St>
__device__ __forceinline__ void cached_general(const AssocArgs& a, int q,
                                               int lane, int ncand,
                                               long long cand0, Shift& shift,
                                               St& st) {
  constexpr int kB = St::kRegs ? St::kN : kBatch;
  const T* __restrict__ blk[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) blk[f] = static_cast<const T*>(a.blk_in[f]);
  const long long first = static_cast<long long>(q) * ncand;
  for (int s0 = 0; s0 < st.n(); s0 += kB) {
    T v[4][kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const bool in = lane + kLanes * (s0 + j) < ncand;
      const long long c = in ? cand0 + (s0 + j) * kLanes : first;
#pragma unroll
      for (int f = 0; f < 4; ++f) v[f][j] = __ldg(blk[f] + c);
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (s0 + j >= st.n()) break;
      if (lane + kLanes * (s0 + j) >= ncand)
        pad(st, s0 + j);
      else
        shift(s0 + j, to_float(v[0][j]), to_float(v[1][j]),
              to_float(v[2][j]), to_float(v[3][j]));
    }
  }
}

// The cached entry: the round-0 blocks shifted by pw - pw0
template <bool kDefault, class St>
__device__ __forceinline__ void cached_cands(const AssocArgs& a, int q,
                                             int lane, St& st) {
  const bool bf16 = a.bf16 != 0;
  const int ncand = kDefault ? kCand : a.ncand;
  const long long cand0 = static_cast<long long>(q) * ncand + lane;
  const float ex = a.pw[3 * q] - a.pw0[3 * q];
  const float ey = a.pw[3 * q + 1] - a.pw0[3 * q + 1];
  const float ez = a.pw[3 * q + 2] - a.pw0[3 * q + 2];
  auto shift = [&](int s, float bx, float by, float bz, float bd) {
    // torch.isfinite: false for inf and NaN
    const bool ok = fabsf(bd) < INFINITY;
    float ox = bx - ex, oy = by - ey, oz = bz - ez;
    float dd = ok ? ox * ox + oy * oy + oz * oz : INFINITY;
    if (bf16) {
      ox = round_bf16(ox);
      oy = round_bf16(oy);
      oz = round_bf16(oz);
      dd = round_bf16(dd);
    }
    put(st, s, ox, oy, oz, dd);
  };
  if constexpr (kDefault) {
#pragma unroll
    for (int s = 0; s < St::kN; ++s) {
      const long long c = cand0 + s * kLanes;
      shift(s, load_blk(a.blk_in[0], c, bf16), load_blk(a.blk_in[1], c, bf16),
            load_blk(a.blk_in[2], c, bf16), load_blk(a.blk_in[3], c, bf16));
    }
  } else if (bf16) {
    cached_general<__nv_bfloat16>(a, q, lane, ncand, cand0, shift, st);
  } else {
    cached_general<float>(a, q, lane, ncand, cand0, shift, st);
  }
}

// A lane's kTop smallest d2 of a staged window, ascending (+inf where it
// has fewer finite ones)
struct TopCands {
  float v[kTop];
  __device__ __forceinline__ int n() const { return kTop; }
  __device__ __forceinline__ float& d(int i) { return v[i]; }
  __device__ __forceinline__ void insert(float x) {
    if (!(x < v[kTop - 1])) return;  // NaN, inf and the larger stay out
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      const float lo = fminf(v[j], x);
      x = fmaxf(v[j], x);
      v[j] = lo;
    }
  }
};

// The tie-inclusive k-th smallest d2 of a query (NaN never selected): k
// rounds of a warp min over the values above the previous one, each followed
// by a warp count of the values <= it; the first value whose count reaches
// k (inf when none does)
template <class St>
__device__ __forceinline__ float kth_smallest(St& st, int k) {
  float last = -INFINITY;
  for (int i = 0; i < k; ++i) {
    float mn = INFINITY;
#pragma unroll
    for (int s = 0; s < st.n(); ++s)
      mn = fminf(mn, st.d(s) > last ? st.d(s) : INFINITY);
    mn = warp_min(mn);
    int c = 0;
#pragma unroll
    for (int s = 0; s < st.n(); ++s) c += st.d(s) <= mn;
    if (__reduce_add_sync(kFull, c) >= k) return mn;
    last = mn;
  }
  return INFINITY;
}

// Selection, moments, the fit and the gates over a query's candidates st,
// and its record (each stage's cut where kStage stops earlier)
template <int kStage, class St>
__device__ __forceinline__ void finish(const AssocArgs& a, const LaneView& lv,
                                       int q, int lane, bool mask,
                                       float thres, St& st) {
  float rec[kRec];
#pragma unroll
  for (int i = 0; i < kRec; ++i) rec[i] = 0.0f;

  // ---- selection: tie-inclusive k-th smallest d2 (NaN never selected) ----
  float t_k;
  if constexpr (St::kRegs) {
    t_k = kth_smallest(st, a.k);
  } else if (a.k <= kTop) {
    // each lane's kTop smallest, in registers, decide as all would: a lane
    // with more values <= a candidate t_k than it keeps has k of them
    TopCands top;
#pragma unroll
    for (int j = 0; j < kTop; ++j) top.v[j] = INFINITY;
    for (int s = 0; s < st.n(); ++s) top.insert(st.d(s));
    t_k = kth_smallest(top, a.k);
  } else {
    t_k = kth_smallest(st, a.k);
  }
  // the selection weights, kept where the candidates are in registers
  float wr[St::kRegs ? St::kN : 1];
  int nl = 0;
#pragma unroll
  for (int s = 0; s < st.n(); ++s) {
    if constexpr (St::kRegs) wr[s] = st.d(s) <= t_k ? 1.0f : 0.0f;
    nl += st.d(s) <= t_k;
  }
  auto weight = [&](int s) {
    if constexpr (St::kRegs)
      return wr[s];
    else
      return st.d(s) <= t_k ? 1.0f : 0.0f;
  };
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
  for (int s = 0; s < st.n(); ++s) {
    const float w = weight(s);
    const float dx = st.x(s), dy = st.y(s), dz = st.z(s);
    const float wx = dx * w, wy = dy * w, wz = dz * w;
    s1x += wx;
    s1y += wy;
    s1z += wz;
    sxx += wx * dx;
    sxy += wx * dy;
    sxz += wx * dz;
    syy += wy * dy;
    syz += wy * dz;
    szz += wz * dz;
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
    for (int s = 0; s < st.n(); ++s) {
      const float dev = weight(s) * (st.x(s) * vec[0] + st.y(s) * vec[1] +
                                     st.z(s) * vec[2] + dist);
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
      lv.need[lv.i] = need ? 1 : 0;
      if (need && lv.need_count != nullptr) atomicAdd(lv.need_count, 1);
    }
  }
}

// One query a warp, the queries of every lane in one grid (lane-major, so a
// block's warps share a lane's map rows in L2).  kDefault: the default
// window (kPer = 8, compile-time addressing); else the general window with
// kPer candidates a lane in registers, or staged in the warp's buffer
// (kPer = kStaged).
template <int kStage, int kPer, bool kDefault>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
    assoc_kernel(const AssocArgs a) {
  static_assert(!kDefault || kPer == kRows, "the default window is 8 rows");
  extern __shared__ float4 smem[];  // a.wpb warp buffers of a.warp_words
  const int wid = threadIdx.x / kLanes;
  const int q = blockIdx.x * a.wpb + wid;  // the query's row, all lanes
  const int lane = threadIdx.x % kLanes;
  if (q >= a.m * a.lanes) return;  // the whole warp leaves together
  const int b = q / a.m;           // its lane of the batch
  LaneView lv;
  lv.cells = a.cells != nullptr ? a.cells + b * a.cells_stride : nullptr;
  lv.thr = a.dedup_thr != nullptr ? a.dedup_thr[b] : INT_MAX;
  lv.need = a.need != nullptr
                ? a.need + static_cast<long long>(b) * a.need_stride
                : nullptr;
  lv.need_count = a.need_count != nullptr ? a.need_count + b : nullptr;
  lv.i = q - b * a.m;
  const float thres = a.thres[b];  // in flight with the query's loads
  bool mask;
  if constexpr (kStage == kRescue) {
    if (!lv.need[lv.i]) return;
    if (a.rescue_cap < a.m &&
        rescue_rank(lv.need, lv.i, lane) >= a.rescue_cap)
      return;
    mask = true;  // factors' mask_r: every compacted query is live
  } else {
    mask = a.mask[q] != 0;
  }
  float* wbuf = a.scratch != nullptr
                    ? a.scratch + static_cast<long long>(q) * a.warp_words
                    : reinterpret_cast<float*>(smem) + wid * a.warp_words;
  const bool fresh = kStage == kRescue || !a.cached;
  auto query = [&](auto& st) {
    if (fresh) {
      if constexpr (kDefault) {
        if (a.dedup_thr != nullptr
                ? default_fresh<kStage, true>(a, lv, q, lane, mask, st)
                : default_fresh<kStage, false>(a, lv, q, lane, mask, st))
          return;
      } else {
        if (general_fresh<kStage>(a, lv, q, lane, mask, wbuf, st)) return;
      }
    } else {
      cached_cands<kDefault>(a, q, lane, st);
    }
    finish<kStage>(a, lv, q, lane, mask, thres, st);
  };
  if constexpr (kPer == kStaged) {
    const int table = fresh ? kRowWords * (a.ncand / a.cpr) : 0;
    StagedCands st{wbuf + table, (a.ncand + kLanes - 1) / kLanes, lane,
                   a.bf16 != 0};
    query(st);
  } else {
    RegCands<kPer> st;
    query(st);
  }
}

template <int kStage, int kPer, bool kDefault>
int launch_one(const AssocArgs& a, cudaStream_t stream) {
  const auto kern = assoc_kernel<kStage, kPer, kDefault>;
  const size_t smem = a.scratch != nullptr
                          ? 0
                          : sizeof(float) * static_cast<size_t>(a.wpb) *
                                static_cast<size_t>(a.warp_words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(a.wpb * kLanes);
  const dim3 grid((a.m * a.lanes + a.wpb - 1) / a.wpb);
  kern<<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instance ops/assoc.instance chose (AssocArgs.inst)
template <int kStage>
int launch(const AssocArgs& a, cudaStream_t stream) {
  switch (a.inst) {
    case 0: return launch_one<kStage, kRows, true>(a, stream);
    case 1: return launch_one<kStage, 4, false>(a, stream);
    case 2: return launch_one<kStage, 8, false>(a, stream);
    case 3: return launch_one<kStage, 16, false>(a, stream);
    case 4: return launch_one<kStage, kStaged, false>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether the chosen instance holds the launch's window and its buffer
// fits it (ops/assoc.plan computes both)
bool plan_ok(const AssocArgs& a) {
  const bool fresh = !a.cached;
  if (a.wpb < 1 || a.wpb > kMaxWarps || a.warp_words < 0) return false;
  if (fresh && a.ncand % a.cpr != 0) return false;
  const int per = (a.ncand + kLanes - 1) / kLanes;
  const int table = fresh ? kRowWords * (a.ncand / a.cpr) : 0;
  switch (a.inst) {
    case 0:
      return fresh ? a.cpr == kLanes && a.nb[0] == 2 && a.nb[1] == 2 &&
                         a.nb[2] == 2
                   : a.ncand == kCand;
    case 1: return per <= 4 && a.warp_words >= table;
    case 2: return per <= 8 && a.warp_words >= table;
    case 3: return per <= 16 && a.warp_words >= table;
    case 4:  // 4 values a candidate, bf16 with bf16 blocks
      return a.warp_words >= table + (a.bf16 ? 2 : 4) * kLanes * per;
    default: return false;
  }
}

}  // namespace

// Launches the association kernel stopped after `stage` (0 GATHER, 1
// SELECT, 2 MOMENTS, 3 EIG, 4 OUT, 5 NEED, 6 RESCUE) on `stream`, once for
// every lane of the batch; returns
// cudaGetLastError() (0 on success).  `args` is read on the host only.
extern "C" int assoc_launch(int stage, const AssocArgs* args, void* stream) {
  if (args->m <= 0 || args->lanes <= 0) return 0;
  if (static_cast<long long>(args->m) * args->lanes > INT_MAX / kLanes ||
      args->need_stride < args->m || args->need_stride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->ncand < 1 || args->cpr < 1 || args->k < 1 ||
      args->k > args->ncand || !plan_ok(*args))
    return static_cast<int>(cudaErrorInvalidValue);
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
