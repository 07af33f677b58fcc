// Verdict-grid fold kernels for the audit sweep (Hopper, sm_90a).
//
// Replaces the two Pallas kernels of gatekeeper_tpu/ops/pallas_topk.py:
//   - gk_fused_fold replaces _fused_fold_kernel (fused_fold_pallas): per
//     constraint row of the RAW [C, N] verdict grid and the [C, N] match
//     mask, hit = raw & mask; count = row sum of hits, occ = row sum of the
//     mask, and the FIRST k hit indices, lowest first.
//   - gk_epilogue replaces _epilogue_kernel (topk_violations_counts_pallas):
//     the same over an already-masked grid, without the occupancy.
// Both entry points share one kernel template (HAS_MASK).
//
// Bound: every input byte is read once and used once; the outputs are
// O(C*k).  At the sweep's shape (C=44, N=32,768) the fused kernel moves
// 2.9 MB, under a microsecond at the H100's 3.35 TB/s and below the cost of
// one launch.  So the kernel is bound by latency: how many dependent round
// trips to memory a row costs, how many bytes each SM has in flight, and
// how many SMs pull at once.
//
// Design:
//   - A row is split over a thread-block cluster: grid (C, S), cluster
//     (1, S, 1), S a power of two <= 8 (the portable cluster limit).  In each
//     pass over the row, block r of the cluster owns one contiguous segment
//     of 256 threads * 16 bytes; at N = 32,768 and S = 8 one pass covers the
//     row, and C = 44 rows give 352 blocks on 132 SMs.  Longer rows loop in
//     passes, carrying the row offset.  Rows lie on grid.x, so C has no
//     limit below 2^31.
//   - Each thread reads 16 bytes per array per pass: one uint4 load on the
//     vector path (taken only when N % 16 == 0 and every input is 16-byte
//     aligned), 16 byte loads on the byte path.  All loads of a pass are
//     issued before the first is used, and each 16 bytes become a 16-bit hit
//     mask (bytes tested != 0) and, fused, a 16-bit scope mask.  Counts and
//     occupancy are __popc of those masks.  Nothing is staged in shared
//     memory: each byte is used once, so TMA or cp.async staging would buy
//     nothing.  What matters is bytes in flight per SM and SMs pulling.
//   - One rank scan per block per pass: a warp-shuffle inclusive scan of the
//     per-thread hit counts, warp totals through shared memory, and __popc
//     of the bits below a hit within the thread give every hit its rank in
//     the segment.
//   - Blocks exchange counts, not lists: after cluster.sync() each block
//     reads its siblings' segment counts through distributed shared memory;
//     the lower ranks' sum is its segment's offset in the row.  A thread
//     writes the indices of its hits whose row rank is < k straight from
//     registers.
//   - Block 0 of the cluster writes count and occupancy; the row's k output
//     slots past the hits (idx 0, valid = j < kept) are striped over the
//     cluster's blocks.  A last cluster.sync() keeps each block's shared
//     memory alive until its siblings' remote reads are done.
// Any k <= N is taken; there is no output tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // bytes a thread reads per array per pass

// One bit per nonzero byte of w, byte 0 -> bit 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned t = __vcmpne4(w, 0u) & 0x01010101u;
  return (t * 0x01020408u) >> 24;
}

// 16-bit mask of the nonzero bytes of p[i, i + 16); bytes at or past n read
// as zero.
template <bool VEC>
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ p,
                                              long long i, long long n) {
  if constexpr (VEC) {
    // n % 16 == 0: a chunk lies wholly before the end or wholly past it
    if (i >= n) return 0u;
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
    return nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 |
           nonzero_bytes(q.z) << 8 | nonzero_bytes(q.w) << 12;
  }
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (i + j < n && __ldg(p + i + j) != 0) bits |= 1u << j;
  }
  return bits;
}

template <bool HAS_MASK, bool VEC>
__global__ void __launch_bounds__(kThreads)
fold_rows(const uint8_t* __restrict__ grid, const uint8_t* __restrict__ mask,
          int n, int k, int32_t* __restrict__ idx, uint8_t* __restrict__ valid,
          int32_t* __restrict__ counts, int32_t* __restrict__ occ) {
  __shared__ int s_warp_hits[kWarps];
  __shared__ int s_warp_occ[kWarps];
  __shared__ int2 s_seg[2];  // this block's (hits, occ) by pass parity

  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long len = n;
  const uint8_t* g = grid + (size_t)row * n;
  const uint8_t* m = HAS_MASK ? mask + (size_t)row * n : nullptr;
  int32_t* out_idx = idx + (size_t)row * k;
  constexpr long long seg_bytes = (long long)kThreads * kChunk;
  const long long pass_bytes = seg_bytes * blocks;

  int row_hits = 0;  // hits of the row in earlier passes (all threads agree)
  int row_occ = 0;
  int parity = 0;
  for (long long base = 0; base < len; base += pass_bytes, parity ^= 1) {
    const long long i =
        base + rank * seg_bytes + (long long)threadIdx.x * kChunk;
    unsigned hit = load_bits<VEC>(g, i, len);
    int occ_cnt = 0;
    if (HAS_MASK) {
      const unsigned scope = load_bits<VEC>(m, i, len);
      hit &= scope;
      occ_cnt = __popc(scope);
    }
    const int cnt = __popc(hit);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (HAS_MASK) occ_cnt = __reduce_add_sync(0xffffffffu, occ_cnt);
    if (lane == 31) {
      s_warp_hits[warp] = incl;
      if (HAS_MASK) s_warp_occ[warp] = occ_cnt;
    }
    __syncthreads();
    // hits of the segment before this thread's chunk, and in all of it
    int before = 0;
    int seg_hits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = s_warp_hits[w];
      before += w < warp ? h : 0;
      seg_hits += h;
    }
    if (threadIdx.x == 0) {
      int seg_occ = 0;
      if (HAS_MASK) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) seg_occ += s_warp_occ[w];
      }
      s_seg[parity] = make_int2(seg_hits, seg_occ);
    }
    cluster.sync();
    int offset = row_hits;  // hits of the row before this segment
    int pass_hits = 0;
    int pass_occ = 0;
    for (int r = 0; r < blocks; ++r) {
      const int2 sib = *cluster.map_shared_rank(&s_seg[parity], r);
      offset += r < rank ? sib.x : 0;
      pass_hits += sib.x;
      pass_occ += sib.y;
    }
    unsigned bits = hit;
    int slot = offset + before + incl - cnt;
    while (bits != 0u && slot < k) {
      out_idx[slot++] = (int32_t)(i + __ffs(bits) - 1);
      bits &= bits - 1u;
    }
    row_hits += pass_hits;
    row_occ += pass_occ;
  }

  const int kept = row_hits < k ? row_hits : k;
  for (int j = rank * kThreads + threadIdx.x; j < k; j += blocks * kThreads) {
    if (j >= kept) out_idx[j] = 0;
    valid[(size_t)row * k + j] = j < kept ? 1 : 0;
  }
  if (rank == 0 && threadIdx.x == 0) {
    counts[row] = row_hits;
    if (HAS_MASK) occ[row] = row_occ;
  }
  cluster.sync();  // siblings may still be reading this block's s_seg
}

__global__ void empty_kernel() {}

template <bool HAS_MASK, bool VEC>
cudaError_t launch_plan(const void* grid, const void* mask, int c, int n,
                        int k, int s, void* idx, void* valid, void* counts,
                        void* occ, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)s;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)c, (unsigned)s, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fold_rows<HAS_MASK, VEC>,
                            (const uint8_t*)grid, (const uint8_t*)mask, n, k,
                            (int32_t*)idx, (uint8_t*)valid, (int32_t*)counts,
                            (int32_t*)occ);
}

// Checks the plan, launches, and returns the launch's error (0 = launched).
template <bool HAS_MASK>
int launch(const void* grid, const void* mask, int c, int n, int k, int s,
           int vec, void* idx, void* valid, void* counts, void* occ,
           void* stream) {
  const uintptr_t addr = (uintptr_t)grid | (uintptr_t)mask;
  if (c < 0 || n < 0 || k < 0 || k > n ||
      (s != 1 && s != 2 && s != 4 && s != 8) ||
      (vec && (n % kChunk != 0 || addr % kChunk != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSuccess;
  if (c > 0) {
    err = vec ? launch_plan<HAS_MASK, true>(grid, mask, c, n, k, s, idx,
                                            valid, counts, occ,
                                            (cudaStream_t)stream)
              : launch_plan<HAS_MASK, false>(grid, mask, c, n, k, s, idx,
                                             valid, counts, occ,
                                             (cudaStream_t)stream);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Bytes one block reads per array per pass (threads x 16): the wrapper's
// launch plan is computed from the same number.
int gk_fold_block_bytes() { return kThreads * kChunk; }

// grid, mask: [c, n] bool (one byte each), row-major and contiguous.
// idx [c, k] int32, valid [c, k] bool, counts [c] int32, occ [c] int32.
// Plan: s blocks per row in a cluster, vec = 1 for the 16-byte load path.
// Returns the launch's CUDA error (0 = launched).
int gk_fused_fold(const void* grid, const void* mask, int c, int n, int k,
                  int s, int vec, void* idx, void* valid, void* counts,
                  void* occ, void* stream) {
  return launch<true>(grid, mask, c, n, k, s, vec, idx, valid, counts, occ,
                      stream);
}

// grid: [c, n] bool, already masked.  Same plan and outputs without occ.
int gk_epilogue(const void* grid, int c, int n, int k, int s, int vec,
                void* idx, void* valid, void* counts, void* stream) {
  return launch<false>(grid, nullptr, c, n, k, s, vec, idx, valid, counts,
                       nullptr, stream);
}

// One launch of an empty kernel: the launch-floor probe for timing.
int gk_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
