// Fused DIGC: pairwise squared distance + running sorted top-kd, for sm_90a.
//
// Replaces repro/kernels/digc_topk.py::digc_topk_pallas (its bitonic merge;
// the legacy kd-pass merge is not ported). For each (b, row) it keeps the kd
// co-nodes with the smallest (sq_x - 2 x.y) + sq_y (+ pos[b, row, col]),
// ascending by (distance, index): the lowest index wins a tie, as lax.top_k
// does. The running list of the exact kernel holds one 64-bit key per entry
// (the distance's order-preserving bits above the index), so a compare is
// one integer compare. Variants, as in the TPU kernel:
//   PACKED  the running list holds one int32 key per entry: the distance's
//           IEEE total-order bits with the low idx_bits cleared, and the
//           index in those bits (core/packedkey.py). One integer compare
//           orders entries; the output is unpacked (truncated distance).
//   BF16    x and y are rounded to bf16 (RNE) as they are staged; norms and
//           products are taken from the rounded values in fp32 (a bf16 x
//           bf16 product is exact in fp32), the TPU kernel's rule.
//   causal  columns with col > row get distance BIG and keep their index.
//           A tile entirely above the block's rows is skipped once every
//           row's list is full (m0 >= kd): its BIG entries, with indices
//           above all the list's, could not enter. So the output is the
//           stable sort's, BIG lanes included, and never a fill sentinel.
//   pos     pos[b * pos_bstride + row * M + col] is added before masking;
//           pos_bstride 0 shares one (N, M) bias across the batch.
//
// What bounds it on an H100: the distance tile is 2*N*M*D fp32 FMA
// operations on the CUDA cores (data-sheet peak 67 TFLOP/s for the SXM
// part; the BF16 variant's bound is the tensor-core rate, which this
// scalar form does not reach), and the inputs are a few MB, so the product
// bounds it at the main path's shapes; the outputs are tiny.
// The design keeps the N x M matrix out of device memory: one block owns
// BN query rows and walks the co-node tiles in a loop (the TPU's
// sequential "arbitrary" grid axis), staging x and y chunks of DC features
// through shared memory so any D fits. Each row's running top-kd list lives
// in shared memory. One warp merges a tile into a row's list: the
// candidates that beat the list's worst entry are bitonic-sorted across
// the warp (the paper's local sort) and merged into the list by rank (its
// global merge), every lane placing its own entries; a tile with no such
// candidate costs one ballot. BN is small so that a batch of 196-node
// images still spreads over the 132 SMs. Tensor cores (mma/wgmma) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int BN = 16;            // query rows per block
constexpr int BM = 64;            // co-node columns per tile (2 per lane)
constexpr int DC = 64;            // features staged per step
constexpr int THREADS = 256;      // 8 warps; tile layout 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KD = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;

// Launch flags (digc_topk_launch).
constexpr int FLAG_PACKED = 1;
constexpr int FLAG_BF16 = 2;
constexpr int FLAG_CAUSAL = 4;

// A list entry is one integer key whose unsigned (PairKey) or signed
// (PackedKey) integer order is the (distance, index) order, so one integer
// compare orders two entries and one or two shuffles move one. A row's
// list is kd keys in shared memory.

// The exact key: the distance's IEEE total-order bits (an order-preserving
// bijection of the float) above the 32-bit index. Unpacking gives back the
// distance bit for bit.
struct PairKey {
  unsigned long long k;
  static __device__ PairKey fill() { return {~0ull}; }
  static __device__ PairKey make(float v, int col, int) {
    const unsigned b = __float_as_uint(v);
    const unsigned flip = b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
    return {(static_cast<unsigned long long>(flip) << 32) |
            static_cast<unsigned>(col)};
  }
  __device__ void store(float* od, int* oi, int) const {
    const unsigned u = static_cast<unsigned>(k >> 32);
    *od = __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
    *oi = static_cast<int>(static_cast<unsigned>(k));
  }
};

// The packed key: one int32, the truncated distance above idx_bits index
// bits (core/packedkey.py).
struct PackedKey {
  int k;
  static __device__ PackedKey fill() { return {INT_MAX}; }
  static __device__ PackedKey make(float v, int col, int idx_bits) {
    const int bits = __float_as_int(v);
    const int flip = bits >= 0 ? bits : (~bits ^ INT_MIN);
    const int mask = (1 << idx_bits) - 1;
    return {(flip & ~mask) | (col & mask)};
  }
  __device__ void store(float* od, int* oi, int idx_bits) const {
    const int mask = (1 << idx_bits) - 1;
    const int hi = k & ~mask;
    *od = __int_as_float(hi >= 0 ? hi : ~(hi ^ INT_MIN));
    *oi = k & mask;
  }
};

template <class Key>
__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  return a.k < b.k;
}

template <class Key>
__device__ __forceinline__ Key shfl_xor(const Key& a, int s) {
  return {__shfl_xor_sync(FULL, a.k, s)};
}

// Bitonic sort of the warp's 64 keys, ascending: element e lives in lane
// e % 32, register e / 32.
template <class Key>
__device__ __forceinline__ void warp_sort64(Key (&v)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // pairs (lane, lane + 32), size 64: ascending
        if (key_less(v[1], v[0])) {
          const Key t = v[0];
          v[0] = v[1];
          v[1] = t;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const Key p = shfl_xor(v[h], stride);
          const bool ascending = ((lane + 32 * h) & size) == 0;
          const bool lower = (lane & stride) == 0;
          // Keep the smaller of the pair in the lower lane of an ascending
          // run (and in the upper lane of a descending one).
          if (key_less(p, v[h]) == (lower == ascending)) v[h] = p;
        }
      }
    }
  }
}

// Number of entries of the sorted list[0, n) ordered before v.
template <class Key>
__device__ __forceinline__ int count_before(const Key* list, int n,
                                            const Key& v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(list[mid], v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merge one row's BM tile candidates into its sorted list of kd entries.
// Called by a whole warp; scratch is the warp's BM-entry buffer.
// Candidates that do not beat the list's worst entry are dropped; the rest
// are sorted and merged by rank: an entry's place in the merged list is its
// place in its own list plus the number of entries of the other list
// ordered before it. Keys are unique (each carries its column), so the
// places are distinct.
template <class Key>
__device__ __forceinline__ void merge_row(const float* trow, int m0, int M,
                                          int idx_bits, Key* list, int kd,
                                          int lane, Key* scratch) {
  const Key worst = list[kd - 1];
  Key v[2];
  int q = 0;  // candidates that beat the worst entry
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = m0 + lane + 32 * h;
    const Key c = Key::make(trow[lane + 32 * h], col, idx_bits);
    const bool want = col < M && key_less(c, worst);
    v[h] = want ? c : Key::fill();
    q += __popc(__ballot_sync(FULL, want));
  }
  if (q == 0) return;  // warp-uniform
  warp_sort64(v, lane);
  scratch[lane] = v[0];
  scratch[lane + 32] = v[1];
  __syncwarp();
  Key lv[MAX_KD / 32];
  int lp[MAX_KD / 32];
#pragma unroll
  for (int j = 0; j < MAX_KD / 32; ++j) {
    const int a = lane + 32 * j;
    lp[j] = kd;  // kd = not kept
    if (a < kd) {
      lv[j] = list[a];
      lp[j] = a + count_before(scratch, q, lv[j]);
    }
  }
  int tp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = lane + 32 * h;
    tp[h] = t < q ? t + count_before(list, kd, v[h]) : kd;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MAX_KD / 32; ++j) {
    if (lp[j] < kd) list[lp[j]] = lv[j];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tp[h] < kd) list[tp[h]] = v[h];
  }
  __syncwarp();
}

// A chunk of R rows x DC features, staged through shared memory. Each
// thread issues all its global loads before its first shared store, so
// they are in flight together: with one block per SM (a batch of 196-node
// images) nothing else hides their latency.
template <int R>
struct Chunk {
  static constexpr int PER = R * DC / THREADS;
  static_assert(R * DC % THREADS == 0, "chunk must split evenly");
  float v[PER];

  // Rows [r0, r0 + R) and features [d0, d0 + DC) of src (rows x D),
  // zero outside.
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0,
                                       int rows, int d0, int D, int tid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * THREADS;
      const int gr = r0 + e / DC, gc = d0 + e % DC;
      v[u] = (gr < rows && gc < D) ? src[static_cast<size_t>(gr) * D + gc]
                                   : 0.f;
    }
  }

  // BF16 rounds each value to bf16 (RNE) and back.
  template <bool BF16>
  __device__ __forceinline__ void store(float (*dst)[DC + 1], int tid) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * THREADS;
      dst[e / DC][e % DC] =
          BF16 ? __bfloat162float(__float2bfloat16_rn(v[u])) : v[u];
    }
  }
};

// Two blocks per SM: the batched loads need about 110 registers, and a
// tighter cap makes ptxas spill.
template <bool PACKED, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
digc_topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ pos, long long pos_bstride,
                 float* __restrict__ out_d, int* __restrict__ out_i, int N,
                 int M, int D, int kd, bool causal, int idx_bits) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  __shared__ float xs[BN][DC + 1];
  __shared__ float ys[BM][DC + 1];
  __shared__ float tile[BN][BM + 1];
  __shared__ Key scratch[WARPS][BM];
  extern __shared__ __align__(16) unsigned char smem[];
  Key* run = reinterpret_cast<Key*>(smem);  // BN lists of kd keys

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int last_row = min(row0 + BN, N) - 1;
  const float* xb = x + static_cast<size_t>(b) * N * D;
  const float* yb = y + static_cast<size_t>(b) * M * D;
  const float* pb = pos == nullptr ? nullptr : pos + b * pos_bstride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % 16;  // columns tx + 16 j, j < 4
  const int ty = tid / 16;  // row ty

  for (int e = tid; e < BN * kd; e += THREADS) run[e] = Key::fill();

  for (int m0 = 0; m0 < M; m0 += BM) {
    // Causal: every later column lies above all of this block's rows.
    if (causal && m0 > last_row && m0 >= kd) break;  // block-uniform
    // Each thread's product entries and the norms of its row and columns,
    // from the same staged values.
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float sq_y[4] = {0.f, 0.f, 0.f, 0.f};
    float sq_x = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      Chunk<BN> xc;
      Chunk<BM> yc;
      xc.load(xb, row0, N, d0, D, tid);
      yc.load(yb, m0, M, d0, D, tid);
      xc.store<BF16>(xs, tid);
      yc.store<BF16>(ys, tid);
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
    const int row = row0 + ty;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = m0 + tx + 16 * j;
      float v = (sq_x - 2.f * acc[j]) + sq_y[j];
      if (pb != nullptr && row < N && col < M) {
        v += pb[static_cast<size_t>(row) * M + col];
      }
      if (causal && col > row) v = BIG;
      tile[ty][tx + 16 * j] = v;
    }
    __syncthreads();
    for (int r = warp; r < BN; r += WARPS) {
      if (row0 + r >= N) continue;  // warp-uniform
      merge_row(tile[r], m0, M, idx_bits, run + r * kd, kd, lane,
                scratch[warp]);
    }
    __syncthreads();
  }

  for (int r = warp; r < BN; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= N) continue;
    const size_t o = (static_cast<size_t>(b) * N + gr) * kd;
    for (int j = lane; j < kd; j += 32) {
      run[r * kd + j].store(out_d + o + j, out_i + o + j, idx_bits);
    }
  }
}

template <bool PACKED, bool BF16>
int launch(const void* x, const void* y, const void* pos,
           long long pos_bstride, void* dist, void* idx, int B, int N, int M,
           int D, int kd, bool causal, int idx_bits, cudaStream_t stream) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  const int dyn = BN * kd * static_cast<int>(sizeof(Key));
  cudaError_t err = cudaFuncSetAttribute(
      digc_topk_kernel<PACKED, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, B);
  digc_topk_kernel<PACKED, BF16><<<grid, THREADS, dyn, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(pos), pos_bstride, static_cast<float*>(dist),
      static_cast<int*>(idx), N, M, D, kd, causal, idx_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N, D), y (B, M, D) fp32 contiguous on the current device; pos null
// or fp32 with rows of M entries, image b's (N, M) block at b * pos_bstride;
// dist (B, N, kd) fp32 and idx (B, N, kd) int32 are written. flags: 1
// packed keys (idx_bits index bits, 1 << idx_bits >= M), 2 bf16 operands,
// 4 causal. Requires 1 <= kd <= min(M, MAX_KD), B, N >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int digc_topk_launch(const void* x, const void* y, const void* pos,
                                long long pos_bstride, void* dist, void* idx,
                                int B, int N, int M, int D, int kd, int flags,
                                int idx_bits, void* stream) {
  const bool causal = (flags & FLAG_CAUSAL) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flags & (FLAG_PACKED | FLAG_BF16)) {
    case 0:
      return launch<false, false>(x, y, pos, pos_bstride, dist, idx, B, N, M,
                                  D, kd, causal, idx_bits, s);
    case FLAG_PACKED:
      return launch<true, false>(x, y, pos, pos_bstride, dist, idx, B, N, M,
                                 D, kd, causal, idx_bits, s);
    case FLAG_BF16:
      return launch<false, true>(x, y, pos, pos_bstride, dist, idx, B, N, M,
                                 D, kd, causal, idx_bits, s);
    default:
      return launch<true, true>(x, y, pos, pos_bstride, dist, idx, B, N, M, D,
                                kd, causal, idx_bits, s);
  }
}
