// Fused DIGC: pairwise squared distance + running sorted top-kd, for sm_90a.
//
// Replaces repro/kernels/digc_topk.py::digc_topk_pallas with both of its
// merges (kernel_merge "bitonic" and "legacy") and the legacy merge's
// bucket_rounds pre-reduction. For each (b, row) it keeps the kd co-nodes
// with the smallest (sq_x - 2 x.y) + sq_y (+ pos[b, row, col]), ascending
// by (distance, index): the lowest index wins a tie, as lax.top_k does.
// A list entry is one integer key whose integer order is that order:
//   exact   64 bits, the distance's order-preserving bits above the index;
//   PACKED  one int32: the distance's IEEE total-order bits with the low
//           idx_bits cleared, the index in those bits (core/packedkey.py);
//           the output is unpacked (truncated distance).
// Variants, as in the TPU kernel:
//   BF16    x and y are rounded to bf16 (RNE) as they are staged; norms and
//           products are taken from the rounded values in fp32 (a bf16 x
//           bf16 product is exact in fp32), the TPU kernel's rule.
//   causal  columns with col > row get distance BIG and keep their index.
//   pos     pos[b * pos_bstride + row * M + col] is added before masking;
//           pos_bstride 0 shares one (N, M) bias across the batch.
//
// Merges, one kernel each (digc_topk_kernel, digc_legacy_kernel), sharing
// the staging and the distance tile. Columns are grouped into logical
// tiles of block_m; the merge runs once per tile:
//   bitonic  (_digc_kernel's sorting-network LSM + GMM.) Every staged chunk
//            (block_m = 64): the candidates that beat the list's worst
//            entry are bitonic-sorted across the warp (the paper's local
//            sort) and merged into the list by rank (its global merge),
//            every lane placing its own entries; a chunk with no such
//            candidate costs one ballot. Exact. A causal tile entirely
//            above the block's rows is skipped once every row has seen kd
//            columns: its BIG entries, with indices above all the list's,
//            could not enter; the output is the stable sort's, BIG lanes
//            included.
//   legacy   (_merge_body / _merge_body_packed.) The candidates that beat
//            the list's worst entry are buffered (a full buffer merges
//            early); at a tile's end kd extraction passes over [list |
//            buffer] each take the smallest key, one warp-wide min
//            reduction per pass. The TPU kernel pads M to a block_m
//            multiple and walks every tile a row block reaches, so
//            this merge walks the same columns (pad columns get distance
//            BIG and keep their column, cut to idx_bits when packed) and
//            skips the same causal tiles (row blocks of row_tile rows).
//            Exact keys start as (BIG, index 0) and a pass removes one
//            position, so BIG lanes carry index 0; packed keys start as
//            INT_BIG and a pass removes every copy of its key (pad columns
//            can alias one another's key).
//   bucket   (_bucket_reduce, packed legacy only.) Bucket g of a tile holds
//            its columns [g w, (g + 1) w), w = block_m / kd; each keeps its
//            `rounds` smallest distinct keys (INT_BIG where it has fewer)
//            while the chunks stream, and the tile's kd * rounds survivors
//            go through the packed legacy merge. Approximate by design.
//
// What bounds it on an H100: the distance tile is 2*N*M*D fp32 FMA
// operations on the CUDA cores (data-sheet peak 67 TFLOP/s for the SXM
// part; the BF16 variant's bound is the tensor-core rate, which this
// scalar form does not reach), and the inputs are a few MB, so the product
// bounds it at the main path's shapes; the outputs are tiny. The legacy
// merge adds kd passes over kd + (buffered candidates) keys per row and
// tile; buffering only candidates that beat the list's worst entry keeps
// that near kd per pass once the lists fill, and a tile with no candidate
// costs nothing.
// The design keeps the N x M matrix out of device memory: one block owns
// BN query rows and walks the co-node tiles in a loop (the TPU's
// sequential "arbitrary" grid axis), staging x and y chunks of DC features
// through shared memory so any D fits. Each row's running list and its
// legacy buffer live in shared memory; one warp merges for a row. BN is
// small so that a batch of 196-node images still spreads over the 132 SMs.
// Tensor cores (mma/wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int BN = 16;            // query rows per block
constexpr int BM = 64;            // co-node columns per staged chunk
constexpr int DC = 64;            // features staged per step
constexpr int THREADS = 256;      // 8 warps; tile layout 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KD = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;
constexpr int INT_BIG = 0x7F7F0000;  // core/packedkey.py

// Launch flags (digc_topk_launch).
constexpr int FLAG_PACKED = 1;
constexpr int FLAG_BF16 = 2;
constexpr int FLAG_CAUSAL = 4;
constexpr int FLAG_LEGACY = 8;
constexpr int FLAG_BUCKET = 16;

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
  // The legacy merge's initial entry: (BIG, index 0).
  static __device__ PairKey legacy_fill() { return make(BIG, 0, 0); }
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
  static __device__ PackedKey legacy_fill() { return {INT_BIG}; }
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

// The legacy merge: kd extraction passes over cand[0, n), whose first kd
// entries are the row's list, the rest the candidates; the new list goes
// to out and back into cand[0, kd). Called by a whole warp. Pass t takes
// the smallest (key, position) after pass t - 1's: positions run list
// first, then candidates in column order, so among equal keys the lowest
// position goes first and one position leaves per pass (_merge_body's
// argmin). DEDUP (packed keys) takes the smallest key after the last one
// instead, so every copy of a key leaves at once (_merge_body_packed's
// compare-mask), and INT_BIG once the candidates are spent.
template <class Key, bool DEDUP>
__device__ __forceinline__ void merge_legacy(Key* cand, int n, int kd,
                                             Key* out, int lane) {
  Key pk = Key::fill();
  int pp = -1;
  for (int t = 0; t < kd; ++t) {
    Key best = Key::fill();
    int bp = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const Key c = cand[j];
      const bool after = t == 0 || key_less(pk, c) ||
                         (!DEDUP && c.k == pk.k && j > pp);
      if (after && (bp == INT_MAX || key_less(c, best))) {
        best = c;
        bp = j;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const Key ob = shfl_xor(best, s);
      const int op = __shfl_xor_sync(FULL, bp, s);
      const bool take = bp == INT_MAX || key_less(ob, best) ||
                        (ob.k == best.k && op < bp);
      if (op != INT_MAX && take) {
        best = ob;
        bp = op;
      }
    }
    // DEDUP only: spent, or no smaller than the fill (_merge_body_packed
    // masks to INT_BIG, so nothing above it is ever taken).
    if (DEDUP && (bp == INT_MAX || !key_less(best, Key::legacy_fill()))) {
      best = Key::legacy_fill();
    }
    if (lane == 0) out[t] = best;
    pk = best;
    pp = bp;
  }
  __syncwarp();
  for (int j = lane; j < kd; j += 32) cand[j] = out[j];
  __syncwarp();
}

// Everything a launch fixes.
struct Args {
  const float* x;
  const float* y;
  const float* pos;
  long long pos_bstride;
  float* out_d;
  int* out_i;
  int N, M, D, kd, idx_bits;
  bool causal;
  int block_m;   // columns per logical tile (one merge each)
  int cap;       // per-row buffer: candidates (legacy) or kd * rounds
                 // survivors (bucket)
  int rounds;    // bucket_rounds
  int m_walk;    // columns walked: M (bitonic) or M padded to block_m
  int row_tile;  // legacy causal tile skip: rows per row block
};

// One past the last column a legacy row walks: the end of the last tile
// that the TPU kernel's row block reaches (j * block_m <= last row of the
// block), all of M padded when not causal.
__device__ __forceinline__ int legacy_limit(const Args& a, int row) {
  if (!a.causal) return a.m_walk;
  const int last = (row / a.row_tile) * a.row_tile + a.row_tile - 1;
  return min(a.m_walk, (last / a.block_m + 1) * a.block_m);
}

// Append the columns [c0, c1) of a staged chunk (trow holds columns
// [m0, m0 + 64)) to a row's legacy buffer: those whose key beats the
// list's worst entry. A buffer that cannot take them is merged first.
template <class Key>
__device__ __forceinline__ void buffer_columns(const Args& a,
                                               const float* trow, int m0,
                                               int c0, int c1, Key* list,
                                               int& cnt, int lane, Key* out) {
  Key* buf = list + a.kd;
  Key k[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = c0 + lane + 32 * h;
    in[h] = col < c1;
    k[h] = in[h] ? Key::make(trow[col - m0], col, a.idx_bits) : Key::fill();
  }
  unsigned bal[2];
  for (int attempt = 0; attempt < 2; ++attempt) {
    const Key worst = list[a.kd - 1];
    int q = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bal[h] = __ballot_sync(FULL, in[h] && key_less(k[h], worst));
      q += __popc(bal[h]);
    }
    if (q == 0) return;  // warp-uniform
    if (cnt + q <= a.cap) break;
    merge_legacy<Key, std::is_same<Key, PackedKey>::value>(
        list, a.kd + cnt, a.kd, out, lane);
    cnt = 0;
  }
  const unsigned lt = (1u << lane) - 1u;
  if (bal[0] & (1u << lane)) buf[cnt + __popc(bal[0] & lt)] = k[0];
  if (bal[1] & (1u << lane)) {
    buf[cnt + __popc(bal[0]) + __popc(bal[1] & lt)] = k[1];
  }
  cnt += __popc(bal[0]) + __popc(bal[1]);
  __syncwarp();
}

// Fold the columns [c0, c1) of the tile starting at column t0 into their
// buckets' survivor lists (rounds sorted distinct keys each, INT_BIG where
// a bucket has fewer). Each lane owns whole buckets.
__device__ __forceinline__ void bucket_columns(const Args& a,
                                               const float* trow, int m0,
                                               int c0, int c1, int t0,
                                               PackedKey* surv, int lane) {
  const int w = a.block_m / a.kd;
  const int r = a.rounds;
  const int g0 = (c0 - t0) / w;
  const int g1 = (c1 - 1 - t0) / w;
  for (int g = g0 + lane; g <= g1; g += 32) {
    PackedKey* s = surv + g * r;
    const int lo = max(c0, t0 + g * w);
    const int hi = min(c1, t0 + (g + 1) * w);
    for (int col = lo; col < hi; ++col) {
      const PackedKey k = PackedKey::make(trow[col - m0], col, a.idx_bits);
      if (!key_less(k, s[r - 1])) continue;
      int p = 0;
      while (key_less(s[p], k)) ++p;
      if (s[p].k == k.k) continue;  // already a survivor
      for (int i = r - 1; i > p; --i) s[i] = s[i - 1];
      s[p] = k;
    }
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

// The (BN x BM) distance tile of rows [row0, row0 + BN) and columns
// [m0, m0 + BM) into tile: each thread's four products and the norms of
// its row and columns from the same staged values, then the bias and the
// masks (columns at or past M and, when causal, columns past the row get
// distance BIG).
template <bool BF16>
__device__ __forceinline__ void distance_tile(
    const float* __restrict__ xb, const float* __restrict__ yb,
    const float* __restrict__ pb, int row0, int m0, int N, int M, int D,
    bool causal, int tid, float (*xs)[DC + 1], float (*ys)[DC + 1],
    float (*tile)[BM + 1]) {
  const int tx = tid % 16;  // columns tx + 16 j, j < 4
  const int ty = tid / 16;  // row ty
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
      const float av = xs[ty][c];
      sq_x = fmaf(av, av, sq_x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = ys[tx + 16 * j][c];
        acc[j] = fmaf(av, bv, acc[j]);
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
    if (col >= M || (causal && col > row)) v = BIG;
    tile[ty][tx + 16 * j] = v;
  }
}

// The bitonic merge. Two blocks per SM: the batched loads need about 110
// registers, and a tighter cap makes ptxas spill.
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

  for (int e = tid; e < BN * kd; e += THREADS) run[e] = Key::fill();

  for (int m0 = 0; m0 < M; m0 += BM) {
    // Causal: every later column lies above all of this block's rows.
    if (causal && m0 > last_row && m0 >= kd) break;  // block-uniform
    distance_tile<BF16>(xb, yb, pb, row0, m0, N, M, D, causal, tid, xs, ys,
                        tile);
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

// The legacy merge (BUCKET: with the bucket_rounds pre-reduction).
template <bool PACKED, bool BF16, bool BUCKET>
__global__ void __launch_bounds__(THREADS, 2)
digc_legacy_kernel(const Args a) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  __shared__ float xs[BN][DC + 1];
  __shared__ float ys[BM][DC + 1];
  __shared__ float tile[BN][BM + 1];
  __shared__ int counts[BN];  // buffered candidates per row
  extern __shared__ __align__(16) unsigned char smem[];
  // Per row: its list of kd keys, then its buffer of cap keys; then one
  // kd-key output list per warp.
  const int stride = a.kd + a.cap;
  Key* rows = reinterpret_cast<Key*>(smem);
  Key* outs = rows + BN * stride;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int last_row = min(row0 + BN, a.N) - 1;
  const float* xb = a.x + static_cast<size_t>(b) * a.N * a.D;
  const float* yb = a.y + static_cast<size_t>(b) * a.M * a.D;
  const float* pb = a.pos == nullptr ? nullptr : a.pos + b * a.pos_bstride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < BN * stride; e += THREADS) {
    rows[e] = Key::legacy_fill();
  }
  if (tid < BN) counts[tid] = 0;

  const int m_end = legacy_limit(a, last_row);
  for (int m0 = 0; m0 < m_end; m0 += BM) {
    distance_tile<BF16>(xb, yb, pb, row0, m0, a.N, a.M, a.D, a.causal, tid,
                        xs, ys, tile);
    __syncthreads();
    for (int r = warp; r < BN; r += WARPS) {
      const int gr = row0 + r;
      if (gr >= a.N) continue;  // warp-uniform
      Key* list = rows + r * stride;
      Key* out = outs + warp * a.kd;
      int cnt = counts[r];
      const int hi = min(m0 + BM, legacy_limit(a, gr));
      for (int c = m0; c < hi;) {
        const int t0 = c / a.block_m * a.block_m;
        const int seg = min(hi, t0 + a.block_m);
        if constexpr (BUCKET) {
          bucket_columns(a, tile[r], m0, c, seg, t0, list + a.kd, lane);
        } else {
          buffer_columns(a, tile[r], m0, c, seg, list, cnt, lane, out);
        }
        if (seg == t0 + a.block_m) {  // the tile ends: merge
          if constexpr (BUCKET) {
            merge_legacy<Key, true>(list, stride, a.kd, out, lane);
            for (int j = a.kd + lane; j < stride; j += 32) {
              list[j] = Key::legacy_fill();
            }
            __syncwarp();
          } else if (cnt > 0) {
            merge_legacy<Key, PACKED>(list, a.kd + cnt, a.kd, out, lane);
            cnt = 0;
          }
        }
        c = seg;
      }
      if (lane == 0) counts[r] = cnt;
      __syncwarp();
    }
    __syncthreads();
  }

  // Tiles end on the padded M: every buffer is merged by now.
  for (int r = warp; r < BN; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= a.N) continue;
    const size_t o = (static_cast<size_t>(b) * a.N + gr) * a.kd;
    for (int j = lane; j < a.kd; j += 32) {
      rows[r * stride + j].store(a.out_d + o + j, a.out_i + o + j,
                                 a.idx_bits);
    }
  }
}

template <bool PACKED, bool BF16>
int launch(const Args& a, int B, cudaStream_t stream) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  const int dyn = BN * a.kd * static_cast<int>(sizeof(Key));
  cudaError_t err = cudaFuncSetAttribute(
      digc_topk_kernel<PACKED, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + BN - 1) / BN, B);
  digc_topk_kernel<PACKED, BF16><<<grid, THREADS, dyn, stream>>>(
      a.x, a.y, a.pos, a.pos_bstride, a.out_d, a.out_i, a.N, a.M, a.D, a.kd,
      a.causal, a.idx_bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED, bool BF16, bool BUCKET>
int launch_legacy(const Args& a, int B, cudaStream_t stream) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  const int dyn = (BN * (a.kd + a.cap) + WARPS * a.kd) *
                  static_cast<int>(sizeof(Key));
  cudaError_t err = cudaFuncSetAttribute(
      digc_legacy_kernel<PACKED, BF16, BUCKET>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + BN - 1) / BN, B);
  digc_legacy_kernel<PACKED, BF16, BUCKET><<<grid, THREADS, dyn, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N, D), y (B, M, D) fp32 contiguous on the current device; pos null
// or fp32 with rows of M entries, image b's (N, M) block at b * pos_bstride;
// dist (B, N, kd) fp32 and idx (B, N, kd) int32 are written. flags: 1
// packed keys (idx_bits index bits, 1 << idx_bits >= M), 2 bf16 operands,
// 4 causal, 8 the legacy merge, 16 bucket_rounds (with 1 and 8). block_m:
// columns per merge; cap: the per-row buffer (at least 64; kd * rounds for
// buckets, block_m a multiple of kd); m_walk: M, or M padded to a block_m
// multiple for the legacy merge; row_tile: the legacy causal row block.
// Requires 1 <= kd <= min(M, MAX_KD), B, N >= 1. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int digc_topk_launch(const void* x, const void* y, const void* pos,
                                long long pos_bstride, void* dist, void* idx,
                                int B, int N, int M, int D, int kd, int flags,
                                int idx_bits, int block_m, int cap, int rounds,
                                int m_walk, int row_tile, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.pos = static_cast<const float*>(pos);
  a.pos_bstride = pos_bstride;
  a.out_d = static_cast<float*>(dist);
  a.out_i = static_cast<int*>(idx);
  a.N = N;
  a.M = M;
  a.D = D;
  a.kd = kd;
  a.idx_bits = idx_bits;
  a.causal = (flags & FLAG_CAUSAL) != 0;
  a.block_m = block_m;
  a.cap = cap;
  a.rounds = rounds;
  a.m_walk = m_walk;
  a.row_tile = row_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = (flags & FLAG_BF16) != 0;
  if (flags & FLAG_BUCKET) {
    return bf16 ? launch_legacy<true, true, true>(a, B, s)
                : launch_legacy<true, false, true>(a, B, s);
  }
  const bool packed = (flags & FLAG_PACKED) != 0;
  if (flags & FLAG_LEGACY) {
    if (packed) {
      return bf16 ? launch_legacy<true, true, false>(a, B, s)
                  : launch_legacy<true, false, false>(a, B, s);
    }
    return bf16 ? launch_legacy<false, true, false>(a, B, s)
                : launch_legacy<false, false, false>(a, B, s);
  }
  if (packed) {
    return bf16 ? launch<true, true>(a, B, s) : launch<true, false>(a, B, s);
  }
  return bf16 ? launch<false, true>(a, B, s) : launch<false, false>(a, B, s);
}
