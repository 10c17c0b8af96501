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
// The design keeps the N x M matrix out of device memory: one block owns
// BN query rows and walks the co-node chunks in a loop (the TPU's
// sequential "arbitrary" grid axis). Each row's running list and its
// legacy buffer live in shared memory; one warp merges for a row. BN is
// small so that a batch of 196-node images still spreads over the 132 SMs.
//
// What bounds it on an H100 (data-sheet rates of the SXM part): the
// bytes are x once, y once per 16-row block (from the 50 MB L2 after the
// first block of an image), the outputs and the bias: 0.8 us at the iso
// shape at 3.35 TB/s. The product is 2*N*M*D operations; the fp32
// variants take three TF32 tensor-core products for each (split TF32,
// below), 6*N*M*D at 495 TFLOP/s, 0.9 us at the iso shape; bf16 takes one
// at 989 TFLOP/s. The merge's integer work depends on the data: a chunk
// whose candidates all lose to the lists' worst entries costs one ballot,
// a chunk early in the walk a 64-key sort per row. The scalar-FMA form of
// this kernel spent 65% of a block's cycles at the iso shape staging and
// multiplying (tools/digc_split.py); this design attacks that part.
// Measured the same way, a block of this kernel at the iso shape spends
// about half its cycles between ring barriers (copy issue and products)
// and a third merging; at pyr stage 0 and the causal KNN shape the merge
// takes 61-68%:
//   x once    the block's 16 query rows are staged once (features in
//             slabs of XMAX, re-staged per chunk only past XMAX), split or
//             rounded as they are staged, their norms taken once from the
//             staged values;
//   y ring    co-node pieces of 64 columns x 128 features (64 in 8-warp
//             blocks) stream through a shared-memory ring of 3 pieces:
//             piece p + 2 is in flight while piece p is multiplied and
//             its chunk merged, by 16-byte cp.async (4-byte where rows
//             are not 16-byte aligned), zero-filled past M and D. Each
//             piece costs a barrier and a wait, so pieces are as wide as
//             shared memory allows;
//   warps     16 where the grid fits on the SMs (one block a SM), else
//             8 (two blocks a SM, so that one block's merge overlaps the
//             other's products). Warp w multiplies the 16 x 8 slice w % 8
//             of the 16 x 64 tile; with 16 warps two share a slice, each
//             taking every other MMA step, and their sums meet in shared
//             memory at the chunk's end. Slices whose columns are all
//             masked are skipped. Warp w merges rows w, w + NW;
//   products  mma.sync on the tensor cores: m16n8k8 TF32 for the fp32
//             variants, as split TF32 (a = hi + lo, hi = rna_tf32(a),
//             lo = rna_tf32(a - hi); x.y = hi.hi + hi.lo + lo.hi,
//             relative error ~2^-21, and exact on small integers; each
//             term in its own accumulator), m16n8k16 bf16 for BF16 (exact
//             products of the rounded operands, fp32 sums). A column's
//             norm is summed once per chunk from the warps' own B
//             fragments. One-pass TF32 (2^-11 per operand) would miss
//             the distance tolerance at D = 192.
// Within an 8- (16-) feature MMA step the feature order is permuted so
// that a lane's A and B elements are adjacent in shared memory (one
// vector load each); the dot product is the same sum in another order.
// The tile goes to shared memory with bias and masks as before, and the
// merges compute what they did (the bitonic one gathers at most 32
// candidates into one key a lane and sorts them in 15 stages instead of
// 21). mma.sync and not wgmma: wgmma takes 64 rows a warpgroup,
// and 64-row blocks would leave 32 blocks for 132 SMs at the iso shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int BN = 16;            // query rows per block
constexpr int BM = 64;            // co-node columns per chunk
constexpr int XMAX = 256;         // features of x held at once
constexpr int TS = BM + 8;        // tile row stride (floats)
constexpr int STAGES = 3;         // y pieces in the ring
// Warps a block: 16 (one block a SM) where the grid fits on the SMs, else
// 8 (two blocks a SM). Warp w merges rows w, w + NW (walk: products).
constexpr int NW_WIDE = 16;
constexpr int NW_NARROW = 8;
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

// Bitonic sort of the warp's 32 keys, ascending: element e in lane e.
template <class Key>
__device__ __forceinline__ void warp_sort32(Key& v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key p = shfl_xor(v, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      if (key_less(p, v) == (lower == ascending)) v = p;
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
// are sorted (at most 32 of them: gathered into one key a lane and sorted
// across the warp in 15 stages instead of 21 over two keys a lane) and
// merged by rank: an entry's place in the merged list is its place in its
// own list plus the number of entries of the other list ordered before
// it. Keys are unique (each carries its column), so the places are
// distinct.
template <class Key>
__device__ __forceinline__ void merge_row(const float* trow, int m0, int M,
                                          int idx_bits, Key* list, int kd,
                                          int lane, Key* scratch) {
  const Key worst = list[kd - 1];
  Key v[2];
  unsigned bal[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = m0 + lane + 32 * h;
    const Key c = Key::make(trow[lane + 32 * h], col, idx_bits);
    const bool want = col < M && key_less(c, worst);
    v[h] = want ? c : Key::fill();
    bal[h] = __ballot_sync(FULL, want);
  }
  // candidates that beat the worst entry
  const int q = __popc(bal[0]) + __popc(bal[1]);
  if (q == 0) return;  // warp-uniform
  if (q <= 32) {  // warp-uniform
    const unsigned lt = (1u << lane) - 1u;
    if (bal[0] & (1u << lane)) scratch[__popc(bal[0] & lt)] = v[0];
    if (bal[1] & (1u << lane)) {
      scratch[__popc(bal[0]) + __popc(bal[1] & lt)] = v[1];
    }
    __syncwarp();
    v[0] = lane < q ? scratch[lane] : Key::fill();
    v[1] = Key::fill();
    __syncwarp();
    warp_sort32(v[0], lane);
  } else {
    warp_sort64(v, lane);
  }
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
  bool vec;      // 16-byte copies of y: D % 4 == 0 and y 16-byte aligned
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

// ---------------------------------------------------------------------------
// The distance tile on the tensor cores.

// Per operand type: the MMA depth and the floats one staged x feature
// takes (hi and lo for split TF32).
template <bool BF16>
struct Geo {
  static constexpr int KSTEP = BF16 ? 16 : 8;
  static constexpr int XW = BF16 ? 1 : 2;
};

// The y ring of an NW-warp block: pieces of DP features (128 for 16-warp
// blocks, one a SM; 64 for 8-warp blocks, two a SM, whose shared memory
// halves) and the ring's row stride. Strides keep a warp's vector loads
// free of bank conflicts: 8-byte B loads (TF32) want a row stride of 8
// mod 32 floats, 16-byte loads 16 mod 32.
template <bool BF16, int NW>
struct Ring {
  static constexpr int DP = NW == NW_WIDE ? 128 : 64;
  static constexpr int YS = BF16 ? DP + 16 : DP + 8;
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Features of x staged at once, and its row stride (16 mod 32 floats).
template <bool BF16>
__host__ __device__ constexpr int x_width(int D) {
  return round_up(D, Geo<BF16>::KSTEP) < XMAX ? round_up(D, Geo<BF16>::KSTEP)
                                               : XMAX;
}
template <bool BF16>
__host__ __device__ constexpr int x_stride(int D) {
  return Geo<BF16>::XW * x_width<BF16>(D) +
         (Geo<BF16>::XW * x_width<BF16>(D) % 32 == 16 ? 0 : 16);
}

__device__ __forceinline__ unsigned tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Two fp32 values (bf16-representable) as one bf16x2 register, lo in the
// low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// cp.async of `bytes` (the copy size, or 0 to write zeros) from global to
// shared memory.
template <int SIZE>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (SIZE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Stage x's rows [row0, row0 + BN) and features [f0, f0 + width) (zero
// outside x) into xs: split into (hi, lo) TF32 pairs, or rounded to bf16.
// With `norms`, add each row's squared norm of the staged (rounded)
// values to sqx (`first`: start from 0). 32 NW / BN threads a row, each
// of which issues
// all its loads before its first store, so that they are in flight
// together.
template <bool BF16, int NW>
__device__ __forceinline__ void stage_x(const Args& a, const float* xb,
                                        int row0, int f0, int width, int xs_n,
                                        float* xs, float* sqx, bool norms,
                                        bool first, int tid) {
  constexpr int TPR = NW * 32 / BN;  // threads a row
  constexpr int PER = XMAX / TPR;
  const int r = tid / TPR, l = tid % TPR;
  const int gr = row0 + r;
  const float* src = xb + static_cast<size_t>(gr < a.N ? gr : 0) * a.D + f0;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int f = l + TPR * i;
    v[i] = (f < width && gr < a.N && f0 + f < a.D) ? __ldg(src + f) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int f = l + TPR * i;
    if (f >= width) break;
    if constexpr (BF16) {
      v[i] = round_bf16(v[i]);
      xs[r * xs_n + f] = v[i];
    } else {
      const float hi = __uint_as_float(tf32(v[i]));
      const float lo = __uint_as_float(tf32(v[i] - hi));
      reinterpret_cast<float2*>(xs + r * xs_n)[f] = make_float2(hi, lo);
    }
    s = fmaf(v[i], v[i], s);
  }
  if (norms) {
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (l == 0) sqx[r] = (first ? 0.f : sqx[r]) + s;
  }
}

// Copy piece (chunk m0, features [d0, d0 + DP)) of y into a ring stage:
// the features up to the MMA depth past D, zero past M and D.
template <bool BF16, int NW>
__device__ __forceinline__ void issue_piece(const Args& a, const float* yb,
                                            int m0, int d0, float* st,
                                            int tid) {
  constexpr int DP = Ring<BF16, NW>::DP, YS = Ring<BF16, NW>::YS;
  constexpr int THREADS = NW * 32;
  const int width = min(DP, round_up(a.D - d0, Geo<BF16>::KSTEP));
  if (a.vec) {  // vector tid % (DP / 4) of every THREADS / (DP / 4)-th column
    const int v = 4 * (tid % (DP / 4));
    if (v >= width) return;
    for (int c = tid / (DP / 4); c < BM; c += THREADS / (DP / 4)) {
      const int col = m0 + c, f = d0 + v;
      const bool ok = col < a.M && f < a.D;
      cp_async<16>(st + c * YS + v,
                   ok ? yb + static_cast<size_t>(col) * a.D + f : yb,
                   ok ? 16 : 0);
    }
  } else {  // feature tid % DP of every THREADS / DP-th column
    const int v = tid % DP;
    if (v >= width) return;
    for (int c = tid / DP; c < BM; c += THREADS / DP) {
      const int col = m0 + c, f = d0 + v;
      const bool ok = col < a.M && f < a.D;
      cp_async<4>(st + c * YS + v,
                  ok ? yb + static_cast<size_t>(col) * a.D + f : yb,
                  ok ? 4 : 0);
    }
  }
}

// Floats the second half of a 16-warp block hands the first (per slice
// and lane: four products and a column norm).
constexpr int RED = 8 * 5 * 32;

// Floats of the tile pipeline's shared memory: the y ring, x, the
// distance tile, the row norms and the k-split's hand-over.
template <bool BF16, int NW>
__host__ __device__ constexpr int tile_floats(int D) {
  return STAGES * BM * Ring<BF16, NW>::YS + BN * x_stride<BF16>(D) + BN * TS +
         BN + RED;
}

// One MMA step (KSTEP features at feature ks * KSTEP of the piece) into
// the warp's 16 x 8 accumulators, and its column's squared norm (column
// 8 slice + lane / 4, partial over the lane's features). Fragment
// element (row g, k) of the step is feature 2 t + (k >= 4) for t = k % 4
// (TF32; bf16: 4 t + ...): the same permutation for A and B. The
// split-TF32 terms go to three accumulators, so that no MMA waits on the
// one before it; bf16 steps go to accumulator S.
template <bool BF16, int S>
__device__ __forceinline__ void mma_step(const float* yrow, const float* x0,
                                         const float* x1, int ks, int t,
                                         float (&acc)[3][4], float& sqy) {
  const float4 a0 = *reinterpret_cast<const float4*>(x0 + 16 * ks);
  const float4 a1 = *reinterpret_cast<const float4*>(x1 + 16 * ks);
  if constexpr (BF16) {
    float4 b = *reinterpret_cast<const float4*>(yrow + 16 * ks + 4 * t);
    b = make_float4(round_bf16(b.x), round_bf16(b.y), round_bf16(b.z),
                    round_bf16(b.w));
    sqy = fmaf(b.x, b.x, sqy);
    sqy = fmaf(b.y, b.y, sqy);
    sqy = fmaf(b.z, b.z, sqy);
    sqy = fmaf(b.w, b.w, sqy);
    mma_bf16(acc[S], bf16x2(a0.x, a0.y), bf16x2(a1.x, a1.y),
             bf16x2(a0.z, a0.w), bf16x2(a1.z, a1.w), bf16x2(b.x, b.y),
             bf16x2(b.z, b.w));
  } else {
    // a0 = (hi, lo) of row g's features 2t and 2t + 1; a1 row g + 8's.
    const float2 b = *reinterpret_cast<const float2*>(yrow + 8 * ks + 2 * t);
    sqy = fmaf(b.x, b.x, sqy);
    sqy = fmaf(b.y, b.y, sqy);
    const unsigned bh0 = tf32(b.x), bh1 = tf32(b.y);
    const unsigned bl0 = tf32(b.x - __uint_as_float(bh0));
    const unsigned bl1 = tf32(b.y - __uint_as_float(bh1));
    const unsigned ah0 = __float_as_uint(a0.x), ah1 = __float_as_uint(a1.x);
    const unsigned ah2 = __float_as_uint(a0.z), ah3 = __float_as_uint(a1.z);
    mma_tf32(acc[0], ah0, ah1, ah2, ah3, bh0, bh1);
    mma_tf32(acc[1], ah0, ah1, ah2, ah3, bl0, bl1);
    mma_tf32(acc[2], __float_as_uint(a0.y), __float_as_uint(a1.y),
             __float_as_uint(a0.w), __float_as_uint(a1.w), bh0, bh1);
  }
}

// One piece's products for the warp's slice: MMA steps half, half + H,
// ... of nk (H = NW / 8 warps share a slice), unrolled without a branch
// when the piece is whole, so that the next steps' loads go out early.
template <bool BF16, int NW>
__device__ __forceinline__ void mma_piece(const float* st, const float* xs,
                                          int xs_n, int fx, int nk, int slice,
                                          int half, int lane,
                                          float (&acc)[3][4], float& sqy) {
  constexpr int H = NW / 8;
  constexpr int NK = Ring<BF16, NW>::DP / Geo<BF16>::KSTEP;
  const int g = lane >> 2, t = lane & 3;
  const float* yrow = st + (8 * slice + g) * Ring<BF16, NW>::YS;
  const float* x0 = xs + g * xs_n + Geo<BF16>::XW * fx + 4 * t;
  const float* x1 = x0 + 8 * xs_n;
  if (nk == NK) {
#pragma unroll
    for (int ks = 0; ks < NK; ks += 2 * H) {
      mma_step<BF16, 0>(yrow, x0, x1, ks + half, t, acc, sqy);
      mma_step<BF16, 1>(yrow, x0, x1, ks + H + half, t, acc, sqy);
    }
  } else {
    for (int ks = half; ks < nk; ks += 2 * H) {
      mma_step<BF16, 0>(yrow, x0, x1, ks, t, acc, sqy);
      if (ks + H < nk) mma_step<BF16, 1>(yrow, x0, x1, ks + H, t, acc, sqy);
    }
  }
}

// The 16 x 8 slice `slice` of the distance tile of rows [row0, row0 +
// BN) and columns [m0, m0 + BM), from its products and its columns'
// partial norms: (sq_x - 2 x.y) + sq_y, then the bias and the masks
// (columns at or past M and, when causal, columns past the row get
// distance BIG).
__device__ __forceinline__ void epilogue(const Args& a, const float* pb,
                                         int row0, int m0, int slice,
                                         int lane, const float (&dot)[4],
                                         float sqy, const float* sqx,
                                         float* tile) {
  const int g = lane >> 2, t = lane & 3;
  sqy += __shfl_xor_sync(FULL, sqy, 1);
  sqy += __shfl_xor_sync(FULL, sqy, 2);
  float sy[2];
  sy[0] = __shfl_sync(FULL, sqy, 8 * t);      // column 2 t's group
  sy[1] = __shfl_sync(FULL, sqy, 8 * t + 4);  // column 2 t + 1's
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const int row = row0 + r;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * slice + 2 * t + e;
      const int col = m0 + c;
      float v = (sqx[r] - 2.f * dot[2 * h + e]) + sy[e];
      if (pb != nullptr && row < a.N && col < a.M) {
        v += pb[static_cast<size_t>(row) * a.M + col];
      }
      if (col >= a.M || (a.causal && col > row)) v = BIG;
      tile[r * TS + c] = v;
    }
  }
}

// Walk `chunks` chunks of BM columns for the block's rows: each chunk's
// distance tile is formed piece by piece from the ring and left in
// shared memory, then merge(m0, tile) runs on the whole block. Warp w
// multiplies slice w % 8 over MMA steps w / 8, w / 8 + NW / 8, ... of
// each piece; with 16 warps the second half hands its sums to the first
// at the chunk's end. A slice whose columns are all masked (at or past M,
// or causal and past the block's rows) is not multiplied. Every thread
// of the block calls it; smem holds tile_floats<BF16, NW>(D).
template <bool BF16, int NW, class Merge>
__device__ __forceinline__ void walk(const Args& a, int b, int row0,
                                     int chunks, float* smem, Merge&& merge) {
  constexpr int DP = Ring<BF16, NW>::DP, YS = Ring<BF16, NW>::YS;
  const float* xb = a.x + static_cast<size_t>(b) * a.N * a.D;
  const float* yb = a.y + static_cast<size_t>(b) * a.M * a.D;
  const float* pb = a.pos == nullptr ? nullptr : a.pos + b * a.pos_bstride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xs_n = x_stride<BF16>(a.D), xw = x_width<BF16>(a.D);
  float* ring = smem;
  float* xs = ring + STAGES * BM * YS;
  float* tile = xs + BN * xs_n;
  float* sqx = tile + BN * TS;
  float* red = sqx + BN;
  const int slice = warp % 8, half = warp / 8;
  const int last_row = min(row0 + BN, a.N) - 1;
  const int pieces = (a.D + DP - 1) / DP;  // per chunk
  const int total = chunks * pieces;
  const bool slabs = a.D > XMAX;  // x re-staged per chunk, XMAX at a time
  auto issue = [&](int p) {
    if (p < total) {
      issue_piece<BF16, NW>(a, yb, p / pieces * BM, p % pieces * DP,
                            ring + p % STAGES * BM * YS, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) issue(p);
  if (!slabs) {
    stage_x<BF16, NW>(a, xb, row0, 0, xw, xs_n, xs, sqx, true, true, tid);
  }
  float acc[3][4];
  float sqy = 0.f;
  for (int p = 0; p < total; ++p) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // piece p is in; piece p - 1's stage is free
    issue(p + STAGES - 1);
    const int chunk = p / pieces, j = p % pieces;
    const int d0 = j * DP;
    if (slabs && d0 % XMAX == 0) {
      stage_x<BF16, NW>(a, xb, row0, d0, XMAX, xs_n, xs, sqx, chunk == 0,
                        j == 0, tid);
      __syncthreads();
    }
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[i / 4][i % 4] = 0.f;
      sqy = 0.f;
    }
    const int nk = (min(DP, a.D - d0) + Geo<BF16>::KSTEP - 1) /
                   Geo<BF16>::KSTEP;
    constexpr int H = NW / 8;  // warps a slice
    const int c0 = chunk * BM + 8 * slice;  // the slice's first column
    if (c0 < a.M && !(a.causal && c0 > last_row)) {  // warp-uniform
      mma_piece<BF16, NW>(ring + p % STAGES * BM * YS, xs, xs_n,
                         slabs ? d0 % XMAX : d0, nk, slice, half, lane, acc,
                         sqy);
    }
    if (j == pieces - 1) {
      float dot[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dot[i] = (acc[1][i] + acc[2][i]) + acc[0][i];
      float* hand = red + slice * 5 * 32 + lane;
      if (H == 2) {
        if (half == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) hand[32 * i] = dot[i];
          hand[128] = sqy;
        }
        __syncthreads();
        if (half == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dot[i] += hand[32 * i];
          sqy += hand[128];
        }
      }
      if (half == 0) {
        epilogue(a, pb, row0, chunk * BM, slice, lane, dot, sqy, sqx, tile);
      }
      __syncthreads();
      merge(chunk * BM, tile);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The bitonic merge.
template <bool PACKED, bool BF16, int NW>
__global__ void __launch_bounds__(NW * 32, NW_WIDE / NW)
digc_topk_kernel(const Args a) {
  constexpr int THREADS = NW * 32, WARPS = NW;
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem);
  Key* scratch = reinterpret_cast<Key*>(fs + tile_floats<BF16, NW>(a.D));
  Key* run = scratch + WARPS * BM;  // BN lists of kd keys

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int last_row = min(row0 + BN, a.N) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kd = a.kd;

  for (int e = tid; e < BN * kd; e += THREADS) run[e] = Key::fill();

  // Causal: a chunk past every row of the block (and past the first kd
  // columns) and all later ones are skipped.
  int chunks = (a.M + BM - 1) / BM;
  if (a.causal) {
    chunks = min(chunks, max((last_row + 1 + BM - 1) / BM, (kd + BM - 1) / BM));
  }
  walk<BF16, NW>(a, b, row0, chunks, fs, [&](int m0, const float* tile) {
    for (int r = warp; r < BN; r += WARPS) {
      if (row0 + r >= a.N) continue;  // warp-uniform
      merge_row(tile + r * TS, m0, a.M, a.idx_bits, run + r * kd, kd, lane,
                scratch + warp * BM);
    }
  });

  for (int r = warp; r < BN; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= a.N) continue;
    const size_t o = (static_cast<size_t>(b) * a.N + gr) * kd;
    for (int j = lane; j < kd; j += 32) {
      run[r * kd + j].store(a.out_d + o + j, a.out_i + o + j, a.idx_bits);
    }
  }
}

// The legacy merge (BUCKET: with the bucket_rounds pre-reduction).
template <bool PACKED, bool BF16, bool BUCKET, int NW>
__global__ void __launch_bounds__(NW * 32, NW_WIDE / NW)
digc_legacy_kernel(const Args a) {
  constexpr int THREADS = NW * 32, WARPS = NW;
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  __shared__ int counts[BN];  // buffered candidates per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem);
  // Per row: its list of kd keys, then its buffer of cap keys; then one
  // kd-key output list per warp.
  const int stride = a.kd + a.cap;
  Key* rows = reinterpret_cast<Key*>(fs + tile_floats<BF16, NW>(a.D));
  Key* outs = rows + BN * stride;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int last_row = min(row0 + BN, a.N) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < BN * stride; e += THREADS) {
    rows[e] = Key::legacy_fill();
  }
  if (tid < BN) counts[tid] = 0;

  const int m_end = legacy_limit(a, last_row);
  walk<BF16, NW>(a, b, row0, (m_end + BM - 1) / BM, fs,
                     [&](int m0, const float* tile) {
    for (int r = warp; r < BN; r += WARPS) {
      const int gr = row0 + r;
      if (gr >= a.N) continue;  // warp-uniform
      const float* trow = tile + r * TS;
      Key* list = rows + r * stride;
      Key* out = outs + warp * a.kd;
      int cnt = counts[r];
      const int hi = min(m0 + BM, legacy_limit(a, gr));
      for (int c = m0; c < hi;) {
        const int t0 = c / a.block_m * a.block_m;
        const int seg = min(hi, t0 + a.block_m);
        if constexpr (BUCKET) {
          bucket_columns(a, trow, m0, c, seg, t0, list + a.kd, lane);
        } else {
          buffer_columns(a, trow, m0, c, seg, list, cnt, lane, out);
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
  });

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

// 16 warps a block where the grid fits on the card's SMs at one block
// each, else 8 at two.
bool wide_grid(const Args& a, int B) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<long long>((a.N + BN - 1) / BN) * B <= sms;
}

template <class Kernel>
int launch_with(Kernel kernel, int threads, const Args& a, int B, int dyn,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + BN - 1) / BN, B);
  kernel<<<grid, threads, dyn, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED, bool BF16>
int launch(const Args& a, int B, cudaStream_t stream) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  const int nw = wide_grid(a, B) ? NW_WIDE : NW_NARROW;
  const int dyn = (nw == NW_WIDE ? tile_floats<BF16, NW_WIDE>(a.D)
                                 : tile_floats<BF16, NW_NARROW>(a.D)) * 4 +
                  (nw * BM + BN * a.kd) * static_cast<int>(sizeof(Key));
  return nw == NW_WIDE
             ? launch_with(digc_topk_kernel<PACKED, BF16, NW_WIDE>, nw * 32,
                           a, B, dyn, stream)
             : launch_with(digc_topk_kernel<PACKED, BF16, NW_NARROW>, nw * 32,
                           a, B, dyn, stream);
}

template <bool PACKED, bool BF16, bool BUCKET>
int launch_legacy(const Args& a, int B, cudaStream_t stream) {
  using Key = std::conditional_t<PACKED, PackedKey, PairKey>;
  const int nw = wide_grid(a, B) ? NW_WIDE : NW_NARROW;
  const int dyn = (nw == NW_WIDE ? tile_floats<BF16, NW_WIDE>(a.D)
                                 : tile_floats<BF16, NW_NARROW>(a.D)) * 4 +
                  (BN * (a.kd + a.cap) + nw * a.kd) *
                      static_cast<int>(sizeof(Key));
  return nw == NW_WIDE
             ? launch_with(digc_legacy_kernel<PACKED, BF16, BUCKET, NW_WIDE>,
                           nw * 32, a, B, dyn, stream)
             : launch_with(
                   digc_legacy_kernel<PACKED, BF16, BUCKET, NW_NARROW>,
                   nw * 32, a, B, dyn, stream);
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
  a.vec = D % 4 == 0 && reinterpret_cast<size_t>(y) % 16 == 0;
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
