// Batched voxel-map row read-modify-write (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel mmloam_tpu/ops/pallas_insert.py:_rmw_kernel
// (driven by insert_batched).  For every UNIQUE superrow touched by one
// insert the kernel reads the 512-byte row [sum_x(32) | sum_y(32) |
// sum_z(32) | meta(32)], keeps each cell only if its stored epoch key
// matches and its count is above 0 (otherwise the cell is reset: the
// MapMove-equivalent eviction), adds the aggregated [sum|cnt] update, caps
// the count at count_cap by rescaling the sums, writes meta = key*128 +
// min(cnt, cap), leaves cells without an update as they were, and writes
// the row back in place.
//
// Design: one warp per touched row, one lane per sub-cell.  Lane j touches
// words j, 32+j, 64+j and 96+j of the row and of its update, so every
// access is one coalesced 128-byte transaction.  Rows are unique within one
// insert (the host-side prep aggregates per row), so no atomics are needed
// and rows never race; entries at index >= nv[b] (the compacted tail)
// return before they touch memory.  The TPU kernel's DMA/semaphore
// pipeline has no counterpart: the warp scheduler overlaps the row loads.
//
// What bounds it on an H100: a touched row moves ~1.5 KB (row read and
// write, update read).  A flagship lockstep scan at B=16 touches well under
// 0.2 M rows over its four inserts, i.e. < 0.3 GB — tens of microseconds at
// 3.35 TB/s — so the kernel is bound by launch latency, not bandwidth.
//
// Built with -fmad=false: every product rounds before its sum exactly as
// in the plain PyTorch version (ops/map_insert.rmw_reference), so the two
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;           // cells per superrow
constexpr int kRow = 4 * kLanes;     // floats per superrow
constexpr int kWarpsPerBlock = 8;

__global__ void map_insert_rmw_kernel(float* __restrict__ cells,
                                      const int* __restrict__ row_slot,
                                      const float* __restrict__ row_key,
                                      const float* __restrict__ row_upd,
                                      const int* __restrict__ nv,
                                      int np, long long cs, float cap) {
  const int b = blockIdx.y;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kLanes);
  const int lane = threadIdx.x % kLanes;
  if (u >= np || u >= nv[b]) return;

  const long long e = static_cast<long long>(b) * np + u;
  const int slot = row_slot[e];
  const float key = row_key[e];
  float* row = cells + (static_cast<long long>(b) * cs + slot) * kRow;
  const float* upd = row_upd + e * kRow;

  const float add_cnt = upd[3 * kLanes + lane];
  if (!(add_cnt > 0.0f)) return;     // no update for this cell: untouched

  const float ometa = row[3 * kLanes + lane];
  const float okey = floorf(ometa * (1.0f / 128.0f));
  const float ocnt = ometa - okey * 128.0f;
  const float keep = (okey == key && ocnt > 0.0f) ? 1.0f : 0.0f;
  const float cnt1 = keep * ocnt + add_cnt;
  const float scale = fminf(1.0f, cap / fmaxf(cnt1, 1.0f));
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int w = f * kLanes + lane;
    row[w] = (keep * row[w] + upd[w]) * scale;
  }
  row[3 * kLanes + lane] = key * 128.0f + fminf(cnt1, cap);
}

}  // namespace

// cells (B, cs, 128) f32 updated in place; row_slot (B, np) i32;
// row_key (B, np) f32; row_upd (B, np, 128) f32; nv (B,) i32 valid entries
// per batch element (compacted to the front).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int map_insert_rmw(float* cells, const int* row_slot,
                              const float* row_key, const float* row_upd,
                              const int* nv, int batch, int np, long long cs,
                              float cap, void* stream) {
  if (batch <= 0 || np <= 0) return 0;
  const dim3 block(kWarpsPerBlock * kLanes);
  const dim3 grid((np + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
  map_insert_rmw_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cells, row_slot, row_key, row_upd, nv, np, cs, cap);
  return static_cast<int>(cudaGetLastError());
}
