// Verdict-grid fold kernels for the audit sweep (Hopper, sm_90a).
//
// Replaces the two Pallas kernels of gatekeeper_tpu/ops/pallas_topk.py:
//   - _fused_fold_kernel (fused_fold_pallas): per constraint row of the RAW
//     [C, N] verdict grid and the [C, N] match mask, block = raw & mask;
//     count = row sum of block, occ = row sum of mask, and the FIRST k set
//     indices of block, lowest first.
//   - _epilogue_kernel (topk_violations_counts_pallas): the same over an
//     already-masked grid, without the occupancy.
// Both entry points share one kernel template (HAS_MASK).
//
// Bound: each input byte is read once (C*N bytes per grid), outputs are
// O(C*k).  At the sweep's shapes (C <= 46, N = 32,768) that is ~3 MB, under
// a microsecond of HBM time, so launch latency sets the pace; the kernel is
// written to be right and simple, not to saturate the card.
//
// Design: one block per constraint row; the block strides over N in tiles
// of blockDim.x.  In each tile every warp ballots its verdict bits; the
// ballot popcounts are summed across warps in shared memory, which gives
// the tile's hit count and each warp's offset.  A set lane writes its index
// at found + (hits of lower warps) + (hits of lower lanes) while that slot
// is < k: an ordered prefix compaction in one pass, in place of the TPU
// kernel's k min-passes.  The block keeps counting after k hits.  Slots past
// the row's hits get index 0 and valid = 0.  There is no 128-lane output
// tile, so any k <= N is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <bool HAS_MASK>
__global__ void __launch_bounds__(kThreads)
fold_rows(const uint8_t* __restrict__ grid, const uint8_t* __restrict__ mask,
          int n, int k, int32_t* __restrict__ idx, uint8_t* __restrict__ valid,
          int32_t* __restrict__ counts, int32_t* __restrict__ occ) {
  __shared__ int s_hits[kWarps];
  __shared__ int s_occ[kWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint8_t* g = grid + (size_t)row * n;
  const uint8_t* m = HAS_MASK ? mask + (size_t)row * n : nullptr;
  int32_t* out_idx = idx + (size_t)row * k;
  const unsigned lower_lanes = (1u << lane) - 1u;

  int found = 0;     // hits in the tiles before this one (all threads agree)
  int occupied = 0;  // mask bits in the tiles before this one
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool in_scope = true;
    bool hit = false;
    if (i < n) {
      hit = g[i] != 0;
      if (HAS_MASK) {
        in_scope = m[i] != 0;
        hit = hit && in_scope;
      }
    } else {
      in_scope = false;
    }
    const unsigned hit_bits = __ballot_sync(0xffffffffu, hit);
    const unsigned occ_bits = HAS_MASK ? __ballot_sync(0xffffffffu, in_scope)
                                       : 0u;
    if (lane == 0) {
      s_hits[warp] = __popc(hit_bits);
      if (HAS_MASK) s_occ[warp] = __popc(occ_bits);
    }
    __syncthreads();
    int before = 0;
    int tile_hits = 0;
    int tile_occ = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = s_hits[w];
      before += (w < warp) ? h : 0;
      tile_hits += h;
      if (HAS_MASK) tile_occ += s_occ[w];
    }
    if (hit) {
      const int slot = found + before + __popc(hit_bits & lower_lanes);
      if (slot < k) out_idx[slot] = i;
    }
    found += tile_hits;
    occupied += tile_occ;
    __syncthreads();  // s_hits/s_occ are rewritten by the next tile
  }

  const int kept = found < k ? found : k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    if (j >= kept) out_idx[j] = 0;
    valid[(size_t)row * k + j] = j < kept ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    counts[row] = found;
    if (HAS_MASK) occ[row] = occupied;
  }
}

}  // namespace

extern "C" {

// grid, mask: [c, n] bool (one byte each), row-major and contiguous.
// idx [c, k] int32, valid [c, k] bool, counts [c] int32, occ [c] int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int gk_fused_fold(const void* grid, const void* mask, int c, int n, int k,
                  void* idx, void* valid, void* counts, void* occ,
                  void* stream) {
  if (c > 0) {
    fold_rows<true><<<c, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)grid, (const uint8_t*)mask, n, k, (int32_t*)idx,
        (uint8_t*)valid, (int32_t*)counts, (int32_t*)occ);
  }
  return (int)cudaGetLastError();
}

// grid: [c, n] bool, already masked.  Same outputs without occ.
int gk_epilogue(const void* grid, int c, int n, int k, void* idx, void* valid,
                void* counts, void* stream) {
  if (c > 0) {
    fold_rows<false><<<c, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)grid, nullptr, n, k, (int32_t*)idx, (uint8_t*)valid,
        (int32_t*)counts, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
