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
// sub-cell, reads the 512-byte row [sum_x(32) | sum_y(32) | sum_z(32) |
// meta(32)], keeps each cell only if its stored epoch key matches the row's
// (the key of the segment's last point) and its count is above 0 (otherwise
// the cell is reset: the MapMove-equivalent eviction), adds the sums, caps
// the count at count_cap by rescaling the sums, writes meta = key*128 +
// min(cnt, cap), leaves cells without a point as they were, and writes the
// row back in place.
//
// Design: one warp per sorted position.  A warp whose slot equals its
// predecessor's (or that holds a masked point, sorted to the end) leaves at
// once; a warp at a segment start walks its segment 32 points a round:
// lane i loads point i's slot and permutation entry together, then its
// record (every load of the round in flight at once), then the warp takes
// the points one after another by shuffle, and lane `sub` adds the point to
// its own sums and count.  Each cell's sum is therefore taken in stable-sort
// order, one term after another.  The warp then does
// the row's RMW, lane j on words j, 32+j, 64+j and 96+j (coalesced 128-byte
// transactions).  Rows are unique per segment, so no atomics are needed and
// rows never race; there is no (B, N, 128) intermediate.
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

constexpr int kLanes = 32;           // cells per superrow
constexpr int kRow = 4 * kLanes;     // floats per superrow
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * kLanes)
    map_insert_kernel(float* __restrict__ cells,
                      const int* __restrict__ slot_s,
                      const long long* __restrict__ perm,
                      const int* __restrict__ sub,
                      const float* __restrict__ key,
                      const float* __restrict__ pts,
                      const int* __restrict__ vox, int n, long long cs,
                      float voxel, float cap) {
  const int b = blockIdx.y;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kLanes);
  const int lane = threadIdx.x % kLanes;
  if (u >= n) return;
  const long long base = static_cast<long long>(b) * n;
  const int slot = slot_s[base + u];
  const int prev = u > 0 ? slot_s[base + u - 1] : -1;
  if (slot < 0 || slot >= cs) return;  // masked point
  if (prev == slot) return;            // not a segment start

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
    // the segment's positions are contiguous: lanes 0..c-1 hold its points
    const int c = __popc(__ballot_sync(kFull, in));
    if (c == 0) break;
    for (int t = 0; t < c; ++t) {
      const int st = __shfl_sync(kFull, s, t);
      const float ax = __shfl_sync(kFull, rx, t);
      const float ay = __shfl_sync(kFull, ry, t);
      const float az = __shfl_sync(kFull, rz, t);
      if (lane == st) {
        sx += ax;
        sy += ay;
        sz += az;
        cnt += 1.0f;
      }
    }
    row_key = __shfl_sync(kFull, k, c - 1);  // the row's key: its last point's
    if (c < kLanes) break;
  }

  if (!(cnt > 0.0f)) return;         // no point in this cell: untouched
  float* row = cells + (static_cast<long long>(b) * cs + slot) * kRow;
  const float ometa = row[3 * kLanes + lane];
  const float okey = floorf(ometa * (1.0f / 128.0f));
  const float ocnt = ometa - okey * 128.0f;
  const float keep = (okey == row_key && ocnt > 0.0f) ? 1.0f : 0.0f;
  const float cnt1 = keep * ocnt + cnt;
  const float scale = fminf(1.0f, cap / fmaxf(cnt1, 1.0f));
  const float add[3] = {sx, sy, sz};
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int w = f * kLanes + lane;
    row[w] = (keep * row[w] + add[f]) * scale;
  }
  row[3 * kLanes + lane] = row_key * 128.0f + fminf(cnt1, cap);
}

}  // namespace

// cells (B, cs, 128) f32 updated in place; slot_s (B, n) i32 slots sorted
// per batch element (masked points hold a slot >= cs, sorted last); perm
// (B, n) i64 the stable sort's permutation (indices within the element);
// sub (B, n) i32, key (B, n) f32, pts (B, n, 3) f32, vox (B, n, 3) i32 in
// the points' own order.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int map_insert_launch(float* cells, const int* slot_s,
                                 const long long* perm, const int* sub,
                                 const float* key, const float* pts,
                                 const int* vox, int batch, int n,
                                 long long cs, float voxel, float cap,
                                 void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 block(kWarpsPerBlock * kLanes);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
  map_insert_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      cells, slot_s, perm, sub, key, pts, vox, n, cs, voxel, cap);
  return static_cast<int>(cudaGetLastError());
}
