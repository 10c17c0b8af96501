// Fused DIGC: pairwise squared distance + running sorted top-kd, for sm_90a.
//
// Replaces repro/kernels/digc_topk.py::digc_topk_pallas (unpacked, bitonic,
// non-causal, no pos_bias variant). For each (b, row) it keeps the kd
// co-nodes with the smallest (sq_x - 2 x.y) + sq_y, ascending by
// (distance, index): the lowest index wins a tie, as lax.top_k does.
//
// What bounds it on an H100: the distance tile is 2*N*M*D fp32 FMA
// operations on the CUDA cores (data-sheet peak 67 TFLOP/s for the SXM
// part), and the inputs are a few MB, so the product bounds it at the main
// path's shapes; the outputs are tiny.
// The design keeps the N x M matrix out of device memory: one block owns
// BN query rows and walks the co-node tiles in a loop (the TPU's
// sequential "arbitrary" grid axis), staging x and y chunks of DC features
// through shared memory so any D fits. Each row's running top-kd list lives
// in shared memory. One warp merges a tile into a row's list: the
// candidates that beat the list's worst entry are bitonic-sorted across
// the warp (the paper's local sort) and merged into the list by rank (its
// global merge), every lane placing its own entries; a tile with no such
// candidate costs one ballot. BN is small so that a batch of 196-node
// images still spreads over the 132 SMs. Tensor cores (wgmma) are later
// work.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int BN = 16;            // query rows per block
constexpr int BM = 64;            // co-node columns per tile (2 per lane)
constexpr int DC = 64;            // features staged per step
constexpr int THREADS = 256;      // 8 warps; tile layout 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KD = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool dist_idx_less(float da, int ia, float db,
                                              int ib) {
  return da < db || (da == db && ia < ib);
}

// Keep the smaller (take_min) or larger of (ad, ai) and (bd, bi) in a.
__device__ __forceinline__ void keep(float& ad, int& ai, float bd, int bi,
                                     bool take_min) {
  if (dist_idx_less(bd, bi, ad, ai) == take_min) {
    ad = bd;
    ai = bi;
  }
}

// Bitonic sort of the warp's 64 (distance, index) pairs, ascending:
// element e lives in lane e % 32, register e / 32.
__device__ void warp_sort64(float (&d)[2], int (&id)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // pairs (lane, lane + 32), size 64: ascending
        if (dist_idx_less(d[1], id[1], d[0], id[0])) {
          const float td = d[0];
          const int ti = id[0];
          d[0] = d[1];
          id[0] = id[1];
          d[1] = td;
          id[1] = ti;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float pd = __shfl_xor_sync(FULL, d[h], stride);
          const int pi = __shfl_xor_sync(FULL, id[h], stride);
          const bool ascending = ((lane + 32 * h) & size) == 0;
          const bool lower = (lane & stride) == 0;
          keep(d[h], id[h], pd, pi, lower == ascending);
        }
      }
    }
  }
}

// Number of entries of the sorted (ad, ai)[0, n) ordered before (vd, vi).
__device__ __forceinline__ int count_before(const float* ad, const int* ai,
                                            int n, float vd, int vi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dist_idx_less(ad[mid], ai[mid], vd, vi)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merge one row's BM tile candidates into its sorted list (ld, li) of kd
// entries. Called by a whole warp; (sd, si) is the warp's 64-entry
// scratch. Candidates that do not beat the list's worst entry are
// dropped; the rest are sorted and merged by rank: an entry's place in
// the merged list is its place in its own list plus the number of
// entries of the other list ordered before it.
__device__ void merge_row(const float* trow, int m0, int M, float* ld,
                          int* li, int kd, int lane, float* sd, int* si) {
  const float wd = ld[kd - 1];
  const int wi = li[kd - 1];
  float d[2];
  int id[2];
  int q = 0;  // candidates that beat the worst entry
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = m0 + lane + 32 * h;
    const float v = trow[lane + 32 * h];
    const bool want = col < M && dist_idx_less(v, col, wd, wi);
    d[h] = want ? v : INFINITY;
    id[h] = want ? col : INT_MAX;
    q += __popc(__ballot_sync(FULL, want));
  }
  if (q == 0) return;  // warp-uniform
  warp_sort64(d, id, lane);
  sd[lane] = d[0];
  si[lane] = id[0];
  sd[lane + 32] = d[1];
  si[lane + 32] = id[1];
  __syncwarp();
  float vd[MAX_KD / 32];
  int vi[MAX_KD / 32];
  int vp[MAX_KD / 32];
#pragma unroll
  for (int j = 0; j < MAX_KD / 32; ++j) {
    const int a = lane + 32 * j;
    vp[j] = kd;  // kd = not kept
    if (a < kd) {
      vd[j] = ld[a];
      vi[j] = li[a];
      vp[j] = a + count_before(sd, si, q, vd[j], vi[j]);
    }
  }
  int tp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = lane + 32 * h;
    tp[h] = t < q ? t + count_before(ld, li, kd, d[h], id[h]) : kd;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MAX_KD / 32; ++j) {
    if (vp[j] < kd) {
      ld[vp[j]] = vd[j];
      li[vp[j]] = vi[j];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tp[h] < kd) {
      ld[tp[h]] = d[h];
      li[tp[h]] = id[h];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
digc_topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out_d, int* __restrict__ out_i, int N,
                 int M, int D, int kd) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float ys[BM][DC + 1];
  __shared__ float tile[BN][BM + 1];
  __shared__ float scratch_d[WARPS][BM];
  __shared__ int scratch_i[WARPS][BM];
  extern __shared__ float run[];  // [BN][kd] distances, then [BN][kd] ids
  float* run_d = run;
  int* run_i = reinterpret_cast<int*>(run + BN * kd);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const float* xb = x + static_cast<size_t>(b) * N * D;
  const float* yb = y + static_cast<size_t>(b) * M * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % 16;  // columns tx + 16 j, j < 4
  const int ty = tid / 16;  // row ty

  for (int e = tid; e < BN * kd; e += THREADS) {
    run_d[e] = INFINITY;
    run_i[e] = INT_MAX;
  }

  for (int m0 = 0; m0 < M; m0 += BM) {
    // Each thread's product entries and the norms of its row and columns,
    // from the same staged fp32 values.
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float sq_y[4] = {0.f, 0.f, 0.f, 0.f};
    float sq_x = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      for (int e = tid; e < BN * DC; e += THREADS) {
        const int r = e / DC, c = e % DC;
        const int gr = row0 + r, gc = d0 + c;
        xs[r][c] = (gr < N && gc < D) ? xb[static_cast<size_t>(gr) * D + gc]
                                      : 0.f;
      }
      for (int e = tid; e < BM * DC; e += THREADS) {
        const int r = e / DC, c = e % DC;
        const int gr = m0 + r, gc = d0 + c;
        ys[r][c] = (gr < M && gc < D) ? yb[static_cast<size_t>(gr) * D + gc]
                                      : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float a = xs[ty][c];
        sq_x = fmaf(a, a, sq_x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = ys[tx + 16 * j][c];
          acc[j] = fmaf(a, bv, acc[j]);
          sq_y[j] = fmaf(bv, bv, sq_y[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tile[ty][tx + 16 * j] = (sq_x - 2.f * acc[j]) + sq_y[j];
    }
    __syncthreads();
    for (int r = warp; r < BN; r += WARPS) {
      if (row0 + r >= N) continue;  // warp-uniform
      merge_row(tile[r], m0, M, run_d + r * kd, run_i + r * kd, kd, lane,
                scratch_d[warp], scratch_i[warp]);
    }
    __syncthreads();
  }

  for (int r = warp; r < BN; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= N) continue;
    const size_t o = (static_cast<size_t>(b) * N + gr) * kd;
    for (int j = lane; j < kd; j += 32) {
      out_d[o + j] = run_d[r * kd + j];
      out_i[o + j] = run_i[r * kd + j];
    }
  }
}

}  // namespace

// x (B, N, D), y (B, M, D) fp32 contiguous on the current device; dist
// (B, N, kd) fp32 and idx (B, N, kd) int32 are written. Requires
// 1 <= kd <= min(M, MAX_KD), B, N >= 1. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int digc_topk_launch(const void* x, const void* y, void* dist,
                                void* idx, int B, int N, int M, int D, int kd,
                                void* stream) {
  const int dyn = 2 * BN * kd * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      digc_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, B);
  digc_topk_kernel<<<grid, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(dist), static_cast<int*>(idx), N, M, D, kd);
  return static_cast<int>(cudaGetLastError());
}
