// Batched voxel-map insert: per-row aggregation and read-modify-write
// (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel mmloam_tpu/ops/pallas_insert.py:_rmw_kernel
// (driven by insert_batched) together with the segment sum and compaction
// XLA ran in front of it (aggregate_updates).  Input: the points of each
// batch element stably sorted by superrow slot (the one torch.sort that
// stays outside, as lax.sort stays outside Pallas), read through the sort's
// permutation: slot, sub-cell and epoch key from the torch addressing, the
// point and its fine voxel.  For every UNIQUE superrow touched by one insert
// the kernel sums the corner-relative offsets and counts of its points per
// sub-cell, reads the row [sum_x(cpr) | sum_y(cpr) | sum_z(cpr) |
// meta(cpr)] (cpr = cells a row: 32 at the default pack, a 512-byte row),
// keeps each cell only if its stored epoch key matches the row's
// (the key of the segment's last point) and its count is above 0 (otherwise
// the cell is reset: the MapMove-equivalent eviction), adds the sums, caps
// the count at count_cap by rescaling the sums, writes meta = key*128 +
// min(cnt, cap), leaves cells without a point as they were, and writes the
// row back in place.
//
// Design of the default instance (32 cells a row): one warp per sorted
// position.  A warp whose slot equals its predecessor's (or that holds a
// masked point, sorted to the end) leaves at once; a warp at a segment start
// walks its segment 32 points a round: lane i loads point i's slot and
// permutation entry together, then its record (every load of the round in
// flight at once), then the warp takes the points one after another by
// shuffle, and lane `sub` adds the point to its own sums and count.  Each
// cell's sum is therefore taken in stable-sort order, one term after
// another.  The warp then does the row's RMW, lane j on words j, 32+j, 64+j
// and 96+j (coalesced 128-byte transactions).  The same kernel with cpr read
// at run time (the "rows" instance) takes any other pack: lanes j >= cpr
// hold no cell, and a row of more than 32 cells is done in chunks of 32
// (pack (4,4,4): two walks of the segment), a template instance of its own
// so that rows of up to 32 cells run the one-pass code.
//
// The group instance takes rows of one cell (pack (1,1,1)), where the
// warp-a-position kernel leaves 31 lanes idle in the RMW; on an H100 it was
// the faster of the two there and the slower at 8 cells a row (PERF.md).
// It runs any cpr.  A window of 32 consecutive sorted positions finds its
// segment starts by one ballot of slot[i] != slot[i-1].  A warp splits into 32 / G groups of G lanes (G the
// power of two >= cpr, at most 32), which take those starts in turn, a
// round a warp (G + 1 warps a window; a warp with no start of its own
// leaves at once, so the rounds run in parallel): lane i loads position
// i's point where it lies in the round's segments (all loads in flight at
// once), the points are broadcast one after another by shuffle, and lane t
// of a group adds each point of its segment whose cell is t.  A segment
// that starts in the window and runs past its last position is the
// window's last warp's: it reads the rest 32 points a round, as the default
// instance does, each round's slots read while the round before's points
// arrive.  At cpr = 1 a lane owns a segment and does its RMW with one
// 16-byte load and store.  A row of more than 32 cells is done in chunks
// of 32 cells.  Sums keep stable-sort order in every instance.
// Rows are unique per segment, so no atomics are needed and rows never
// race; there is no (B, N, 4 cpr) intermediate.
//
// What bounds it on an H100: each point is read once (44 B through the
// permutation) and each touched row read and written once (1 KB); a
// flagship insert (B=16, N=2048, ~15 k rows) must move ~17 MB, ~5 us at
// 3.35 TB/s.  The segment walk is serial per row, but rows hold a few points
// each, and the warps of different rows overlap.
//
// Built with -fmad=false: every product rounds before its sum as in the
// plain PyTorch version (ops/map_insert.rmw_reference after
// aggregate_updates), so the meta lanes agree bit for bit; the sums are
// taken in another order than the plain version's associative scan and
// agree within map_insert.sum_tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;           // lanes a warp
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// kCells > 0: rows of kCells cells (the default 32), one a lane;
// kCells == 0: rows of cpr <= 32 cells read at run time (lanes j >= cpr
// hold no cell); kCells < 0: rows of any cpr, in chunks of 32 cells (lane
// j on cells c0 + j), the segment walked once a chunk
template <int kCells>
__global__ void __launch_bounds__(kWarpsPerBlock * kLanes)
    map_insert_kernel(float* __restrict__ cells,
                      const int* __restrict__ slot_s,
                      const long long* __restrict__ perm,
                      const int* __restrict__ sub,
                      const float* __restrict__ key,
                      const float* __restrict__ pts,
                      const int* __restrict__ vox, int n, long long cs,
                      int cpr_rt, float voxel, float cap) {
  const int cpr = kCells > 0 ? kCells : cpr_rt;
  const int b = blockIdx.y;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kLanes);
  const int lane = threadIdx.x % kLanes;
  if (u >= n) return;
  const long long base = static_cast<long long>(b) * n;
  const int slot = slot_s[base + u];
  const int prev = u > 0 ? slot_s[base + u - 1] : -1;
  if (slot < 0 || slot >= cs) return;  // masked point
  if (prev == slot) return;            // not a segment start

  const int span = kCells < 0 ? cpr : 1;  // one pass unless chunked
  for (int c0 = 0; c0 < span; c0 += kLanes) {
    const int cell = c0 + lane;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f, row_key = 0.0f;
    for (int i0 = u;; i0 += kLanes) {
      const int i = i0 + lane;
      // the slot and the permutation are read together, then the point
      const int si = i < n ? slot_s[base + i] : -1;
      const long long pi = i < n ? perm[base + i] : 0;
      const bool in = si == slot;
      int s = -1;
      float k = 0.0f, rx = 0.0f, ry = 0.0f, rz = 0.0f;
      if (in) {
        const long long p = base + pi;
        s = sub[p];
        k = key[p];
        // rel = pts - v * voxel, rounded as the plain version rounds it
        rx = pts[3 * p] - static_cast<float>(vox[3 * p]) * voxel;
        ry = pts[3 * p + 1] - static_cast<float>(vox[3 * p + 1]) * voxel;
        rz = pts[3 * p + 2] - static_cast<float>(vox[3 * p + 2]) * voxel;
      }
      // the segment's positions are contiguous: lanes 0..c-1 hold its
      // points
      const int c = __popc(__ballot_sync(kFull, in));
      if (c == 0) break;
      for (int t = 0; t < c; ++t) {
        const int st = __shfl_sync(kFull, s, t);
        const float ax = __shfl_sync(kFull, rx, t);
        const float ay = __shfl_sync(kFull, ry, t);
        const float az = __shfl_sync(kFull, rz, t);
        if (cell == st) {
          sx += ax;
          sy += ay;
          sz += az;
          cnt += 1.0f;
        }
      }
      row_key = __shfl_sync(kFull, k, c - 1);  // the row's: its last point's
      if (c < kLanes) break;
    }

    if (!(cnt > 0.0f)) continue;  // no point in this cell: untouched
    float* row = cells + (static_cast<long long>(b) * cs + slot) * (4 * cpr);
    const float ometa = row[3 * cpr + cell];
    const float okey = floorf(ometa * (1.0f / 128.0f));
    const float ocnt = ometa - okey * 128.0f;
    const float keep = (okey == row_key && ocnt > 0.0f) ? 1.0f : 0.0f;
    const float cnt1 = keep * ocnt + cnt;
    const float scale = fminf(1.0f, cap / fmaxf(cnt1, 1.0f));
    const float add[3] = {sx, sy, sz};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int w = f * cpr + cell;
      row[w] = (keep * row[w] + add[f]) * scale;
    }
    row[3 * cpr + cell] = row_key * 128.0f + fminf(cnt1, cap);
  }
}

// Lanes a group of the group instance: the power of two >= cpr, at most 32
// (host and device alike; no count of leading zeros of 0)
__host__ __device__ __forceinline__ int group_lanes(int cpr) {
  int g = 1;
  while (g < cpr && g < kLanes) g <<= 1;
  return g;
}

// The warp's points, as the group instance holds them: lane i the point
// at sorted position u0 + i (slot su, sub-cell s, key kk, offsets r)
struct WarpPoints {
  int su, s;
  float kk, rx, ry, rz;
};

// One segment (one row) of the group instance, done by a group of G lanes
// (mask gmask, this lane its t-th) for rows of cpr cells: its points among
// the warp's positions [lo, hi) (has: the group has a segment this round),
// then, from sorted position `from` on (-1: none), the rest of it, G points
// a round; each cell's sum in sorted order; then the row's RMW.
__device__ __forceinline__ void segment_rmw(
    float* __restrict__ cells, const int* __restrict__ slot_s,
    const long long* __restrict__ perm, const int* __restrict__ sub,
    const float* __restrict__ key, const float* __restrict__ pts,
    const int* __restrict__ vox, int n, long long base, long long row0,
    int cpr, float voxel, float cap, const WarpPoints& w, int G, int t,
    unsigned gmask, bool has, int slot, int lo, int hi, int from,
    bool vec4) {
  float* row = cells + (row0 + slot) * (4 * cpr);
  for (int c0 = 0; c0 < cpr; c0 += G) {  // chunks of G cells
    const int cell = c0 + t;             // this lane's cell
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f, row_key = 0.0f;
    // the warp's points in sorted order, each to the lane of its cell
    for (int j = lo; j < hi; ++j) {
      const int sj = __shfl_sync(kFull, w.su, j);
      const int st = __shfl_sync(kFull, w.s, j);
      const float ax = __shfl_sync(kFull, w.rx, j);
      const float ay = __shfl_sync(kFull, w.ry, j);
      const float az = __shfl_sync(kFull, w.rz, j);
      const float kj = __shfl_sync(kFull, w.kk, j);
      if (has && sj == slot) {
        row_key = kj;  // the row's key: its last point's
        if (st == cell) {
          sx += ax;
          sy += ay;
          sz += az;
          cnt += 1.0f;
        }
      }
    }
    if (has && from >= 0) {  // the rest of the segment, G positions a round
      // the slot and the permutation of the round after are read while
      // this round's points arrive
      int i = from + t;
      int si = i < n ? slot_s[base + i] : -1;
      long long pi = i < n ? perm[base + i] : 0;
      for (;; i += G) {
        const bool in = si == slot;
        int s2 = -1;
        float k2 = 0.0f, x2 = 0.0f, y2 = 0.0f, z2 = 0.0f;
        if (in) {
          const long long p = base + pi;
          s2 = sub[p];
          k2 = key[p];
          x2 = pts[3 * p] - static_cast<float>(vox[3 * p]) * voxel;
          y2 = pts[3 * p + 1] - static_cast<float>(vox[3 * p + 1]) * voxel;
          z2 = pts[3 * p + 2] - static_cast<float>(vox[3 * p + 2]) * voxel;
        }
        // the segment's positions are contiguous: lanes 0..c-1 of the
        // group hold its points
        const int c = __popc(__ballot_sync(gmask, in) & gmask);
        if (c == 0) break;
        if (c == G) {
          si = i + G < n ? slot_s[base + i + G] : -1;
          pi = i + G < n ? perm[base + i + G] : 0;
        }
        for (int j = 0; j < c; ++j) {
          const int st = __shfl_sync(gmask, s2, j, G);
          const float ax = __shfl_sync(gmask, x2, j, G);
          const float ay = __shfl_sync(gmask, y2, j, G);
          const float az = __shfl_sync(gmask, z2, j, G);
          if (st == cell) {
            sx += ax;
            sy += ay;
            sz += az;
            cnt += 1.0f;
          }
        }
        row_key = __shfl_sync(gmask, k2, c - 1, G);
        if (c < G) break;
      }
    }

    if (!(cnt > 0.0f)) continue;  // no point in this cell: untouched
    if (vec4) {                   // the row is this lane's one cell
      float4* r4 = reinterpret_cast<float4*>(row);
      const float4 o = *r4;
      const float okey = floorf(o.w * (1.0f / 128.0f));
      const float ocnt = o.w - okey * 128.0f;
      const float keep = (okey == row_key && ocnt > 0.0f) ? 1.0f : 0.0f;
      const float cnt1 = keep * ocnt + cnt;
      const float scale = fminf(1.0f, cap / fmaxf(cnt1, 1.0f));
      *r4 = make_float4((keep * o.x + sx) * scale, (keep * o.y + sy) * scale,
                        (keep * o.z + sz) * scale,
                        row_key * 128.0f + fminf(cnt1, cap));
      continue;
    }
    const float ometa = row[3 * cpr + cell];
    const float okey = floorf(ometa * (1.0f / 128.0f));
    const float ocnt = ometa - okey * 128.0f;
    const float keep = (okey == row_key && ocnt > 0.0f) ? 1.0f : 0.0f;
    const float cnt1 = keep * ocnt + cnt;
    const float scale = fminf(1.0f, cap / fmaxf(cnt1, 1.0f));
    const float add[3] = {sx, sy, sz};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int w3 = f * cpr + cell;
      row[w3] = (keep * row[w3] + add[f]) * scale;
    }
    row[3 * cpr + cell] = row_key * 128.0f + fminf(cnt1, cap);
  }
}

// A window of 32 sorted positions, as a warp reads it first: lane i's slot
// and permutation entry (read together), the segment starts among the
// positions (one ballot of slot[i] != slot[i-1]), and the segment that
// starts here and runs past the window, whose start `starts` then leaves out
struct Window {
  int su;
  long long pu;
  unsigned starts;
  int last_start, last_slot;
  bool runs_on;
};

__device__ __forceinline__ Window read_window(
    const int* __restrict__ slot_s, const long long* __restrict__ perm,
    int n, long long cs, long long base, int u0, int lane) {
  Window w;
  const int u = u0 + lane;
  w.su = u < n ? slot_s[base + u] : -1;
  w.pu = u < n ? perm[base + u] : 0;
  int prev = __shfl_up_sync(kFull, w.su, 1);
  if (lane == 0) prev = u0 > 0 ? slot_s[base + u0 - 1] : -1;
  int next = -1;  // the slot after the window
  if (lane == kLanes - 1 && u + 1 < n) next = slot_s[base + u + 1];
  next = __shfl_sync(kFull, next, kLanes - 1);
  const bool valid = w.su >= 0 && w.su < cs;  // masked points sort last
  w.starts = __ballot_sync(kFull, valid && w.su != prev);
  w.last_start = w.starts != 0u ? 31 - __clz(w.starts) : -1;
  w.last_slot = __shfl_sync(kFull, w.su, kLanes - 1);
  w.runs_on = w.last_start >= 0 && next == w.last_slot &&
              __shfl_sync(kFull, w.su, w.last_start & 31) == w.last_slot;
  if (w.runs_on) w.starts &= ~(1u << w.last_start);
  return w;
}

// Lane i's point (sub-cell, key, offsets from its voxel corner), where
// `load`; sub-cell -1 otherwise
__device__ __forceinline__ WarpPoints load_point(
    const Window& win, bool load, long long base,
    const int* __restrict__ sub, const float* __restrict__ key,
    const float* __restrict__ pts, const int* __restrict__ vox, float voxel) {
  WarpPoints w;
  w.su = win.su;
  w.s = -1;
  w.kk = w.rx = w.ry = w.rz = 0.0f;
  if (load) {
    const long long p = base + win.pu;
    w.s = sub[p];
    w.kk = key[p];
    // rel = pts - v * voxel, rounded as the plain version rounds it
    w.rx = pts[3 * p] - static_cast<float>(vox[3 * p]) * voxel;
    w.ry = pts[3 * p + 1] - static_cast<float>(vox[3 * p + 1]) * voxel;
    w.rz = pts[3 * p + 2] - static_cast<float>(vox[3 * p + 2]) * voxel;
  }
  return w;
}

// Rows of any cpr: groups of G lanes, one segment a group, a warp a round
// of a window of 32 sorted positions (see above)
__global__ void __launch_bounds__(kWarpsPerBlock * kLanes)
    map_insert_groups(float* __restrict__ cells,
                      const int* __restrict__ slot_s,
                      const long long* __restrict__ perm,
                      const int* __restrict__ sub,
                      const float* __restrict__ key,
                      const float* __restrict__ pts,
                      const int* __restrict__ vox, int n, long long cs,
                      int cpr, float voxel, float cap) {
  // groups of G lanes (G the power of two >= cpr, at most 32): a window of
  // 32 positions holds at most 32 starts, so G rounds of 32 / G groups, a
  // warp each, and a warp for the segment that runs past the window
  const int G = group_lanes(cpr);
  const int groups = kLanes / G, g = threadIdx.x % kLanes / G;
  const int t = threadIdx.x % G;
  const unsigned gmask = G == kLanes ? kFull : ((1u << G) - 1u) << (g * G);
  const int wid = blockIdx.x * kWarpsPerBlock + threadIdx.x / kLanes;
  const int u0 = wid / (G + 1) * kLanes, round = wid % (G + 1);
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.y;
  if (u0 >= n) return;
  const long long base = static_cast<long long>(b) * n;
  const long long row0 = static_cast<long long>(b) * cs;
  const Window win = read_window(slot_s, perm, n, cs, base, u0, lane);
  const bool valid = win.su >= 0 && win.su < cs;
  const bool tail = win.runs_on && round == G;  // the runner: round G

  // this warp's round: group g takes start round * groups + g
  unsigned m = win.starts;
  for (int j = 0; j < round * groups && m != 0u; ++j) m &= m - 1u;
  if (m == 0u && !tail) return;  // the whole warp leaves together
  unsigned mine = m;
  for (int j = 0; j < g && mine != 0u; ++j) mine &= mine - 1u;
  unsigned rest = m;
  for (int j = 0; j < groups && rest != 0u; ++j) rest &= rest - 1u;
  // the round's segments lie between its first start and the next round's
  // first (or the window's end)
  const int lo = m != 0u ? __ffs(m) - 1 : kLanes;
  const int hi = rest != 0u ? __ffs(rest) - 1 : kLanes;
  // the points of those positions (and of the tail's), loads in flight at
  // once
  const WarpPoints w = load_point(
      win, valid && ((lane >= lo && lane < hi) ||
                     (tail && lane >= win.last_start)),
      base, sub, key, pts, vox, voxel);
  const bool vec4 =
      cpr == 1 && (reinterpret_cast<unsigned long long>(cells) & 15) == 0;
  if (m != 0u) {
    const bool has = mine != 0u;
    const int slot = __shfl_sync(kFull, w.su, has ? __ffs(mine) - 1 : 0);
    segment_rmw(cells, slot_s, perm, sub, key, pts, vox, n, base, row0, cpr,
                voxel, cap, w, G, t, gmask, has, slot, lo, hi, -1, vec4);
  }
  if (tail)  // the whole warp, lane j on cells j, j+32, ...
    segment_rmw(cells, slot_s, perm, sub, key, pts, vox, n, base, row0, cpr,
                voxel, cap, w, kLanes, lane, kFull, true, win.last_slot,
                win.last_start, kLanes, u0 + kLanes, false);
}

}  // namespace

// cells (B, cs, 4 cpr) f32 updated in place; slot_s (B, n) i32 slots
// sorted per batch element (masked points hold a slot >= cs, sorted last);
// perm (B, n) i64 the stable sort's permutation (indices within the
// element); sub (B, n) i32, key (B, n) f32, pts (B, n, 3) f32, vox (B, n, 3)
// i32 in the points' own order.  `inst` is an index into
// ops/map_insert.INSTANCES: 0 the default instance (cpr = 32), 1 the group
// instance, 2 the warp-a-position instance at run-time cpr (any cpr >= 1).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int map_insert_launch(float* cells, const int* slot_s,
                                 const long long* perm, const int* sub,
                                 const float* key, const float* pts,
                                 const int* vox, int batch, int n,
                                 long long cs, int cpr, float voxel,
                                 float cap, int inst, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 block(kWarpsPerBlock * kLanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int windows = (n + kLanes - 1) / kLanes;
  auto grid = [&](int warps) {
    return dim3((warps + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
  };
  if (inst == 0 && cpr == kLanes) {
    map_insert_kernel<kLanes><<<grid(n), block, 0, s>>>(
        cells, slot_s, perm, sub, key, pts, vox, n, cs, cpr, voxel, cap);
  } else if (inst == 1 && cpr >= 1) {
    // a warp a round of a window: G + 1 warps a window
    map_insert_groups<<<grid(windows * (group_lanes(cpr) + 1)), block, 0,
                        s>>>(cells, slot_s, perm, sub, key, pts, vox, n,
                             cs, cpr, voxel, cap);
  } else if (inst == 2 && cpr >= 1 && cpr <= kLanes) {
    map_insert_kernel<0><<<grid(n), block, 0, s>>>(
        cells, slot_s, perm, sub, key, pts, vox, n, cs, cpr, voxel, cap);
  } else if (inst == 2 && cpr > kLanes) {
    map_insert_kernel<-1><<<grid(n), block, 0, s>>>(
        cells, slot_s, perm, sub, key, pts, vox, n, cs, cpr, voxel, cap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
