// Routed experts of a Mixture-of-Experts layer over (token, expert) pairs
// grouped by expert, for sm_90a.
//
//   h[p]   = silu(x[t] W_gate[e]) * (x[t] W_up[e])     pass 1, p = (t, j)
//   y[p]   = h[p] W_down[e]                              pass 2, unscaled
//   out[t] = sum_j gate[t, j] * y[(t, j)]                combine, fp32
//
// with e = sel[t, j]. It replaces no TPU kernel: JAX's single-device MoE
// (repro/models/moe.py::_dense_moe) runs every expert on every token as
// batched products and has no Pallas call. This kernel computes each live
// pair once and reads only the weights of experts that have rows.
//
// Input: the pairs' flat indices t * K + j sorted stably by expert on the
// device (perm), a dead row's pairs given the sentinel expert E and so
// sorted last, and each expert's rows [row_off[e], row_off[e + 1]) of that
// order. Nothing is read back to the host: the grid is sized for the worst
// case, ceil(P / BM) + E row tiles (P = T * K pairs) times the column tiles,
// and each block finds its expert and rows from row_off (tiles numbered
// expert by expert, ceil(rows / BM) each); a block past the last tile
// returns at once, so an expert with no rows reads none of its weights.
//
// What bounds it on an H100 (data-sheet rates of the SXM part, 3.35 TB/s
// and 989 TFLOP/s bf16): in decode (a few rows an expert) the selected
// experts' weight bytes, 3 D F bf16 an expert; in a prefill of ~1,000
// tokens (~100 rows an expert) bytes and operations are of one order (2 P
// 3 D F operations). The design:
//   - a block computes BM rows x 64 columns of one expert through the whole
//     depth; its weight tiles (64 deep x 64 wide, 16-byte rows of 128 bytes)
//     stream through a cp.async ring of 3-4 stages, so every block keeps
//     ~50-60 KB of weights in flight, which is what keeps the bytes moving
//     when only a few rows use them;
//   - pass 1 gathers its A rows x[t] by index inside the copy (no gathered
//     copy in device memory) and multiplies gate and up in the same loop
//     (the tile is read once), SiLU(gate) * up in the epilogue from the
//     fp32 sums, rounded where JAX's dense form rounds in bf16 (each
//     product, the SiLU, their product), h stored once in bf16 in sorted
//     order; pass 2 reads h's rows in order and writes y at the pair's
//     flat row;
//   - bf16 products are mma.sync m16n8k16 with fp32 accumulation, fed by
//     ldmatrix from padded rows (144 bytes: no bank conflicts); BM is 16
//     (decode: 4 warps side by side over the columns), 64 (2 x 2 warps of
//     32 x 32) or 128 (4 x 2 warps: each weight tile serves twice the rows),
//     chosen by the wrapper from the mean rows an expert, T K / E;
//   - fp32 operands (tests, checks) take a plain FMA tile of 16 x 32;
//   - D and F need only be multiples of 8 (a 16-byte bf16 chunk): the last
//     column tile and the last depth stage load zeros past the width and
//     the depth, and the epilogue stores no column past the width, so the
//     small test configurations' widths (32, 64, 96) run the same tiles;
//   - the combine sums each token's K pairs in j order in fp32 with no
//     atomics, so a captured run equals an eager one bit for bit; a dead
//     row's output is 0. A row's result never depends on other rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int BN = 64;        // output columns a block (bf16)
constexpr int BK = 64;        // depth a ring stage (bf16)
constexpr int LD = BK + 8;    // a staged row: 72 elements, 144 bytes
constexpr int FBM = 16;       // fp32 tile: rows
constexpr int FBN = 32;       // fp32 tile: columns
constexpr int FBK = 32;       // fp32 tile: depth a step
constexpr int MAX_E = 256;    // experts (the tile table lives in shared memory)
constexpr int UNIT = 8;       // D and F: multiples of a 16-byte bf16 chunk
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;       // (T, D) tokens
  const void* w_gate;  // (E, D, F)
  const void* w_up;    // (E, D, F)
  const void* w_down;  // (E, F, D)
  const long long* perm;  // (P,) flat pair index of each sorted pair
  const int* row_off;     // (E + 1,)
  const float* gates;     // (T, K)
  const unsigned char* live;  // (T,) bool, or null: every row live
  void* h;                // (P, F), sorted order
  void* y;                // (P, D), flat order
  void* out;              // (T, D)
  int T, K, E, D, F;
};

// The block's row tile `tile`: expert e and sorted rows [r0, r1). Each
// expert has ceil(rows / BM) tiles, numbered expert by expert. False (for
// the whole block) past the last tile.
template <int BM>
__device__ bool find_tile(const int* row_off, int E, int tile, int& e,
                          int& r0, int& r1) {
  __shared__ int off[MAX_E + 1];  // tiles of the experts before e
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    off[i + 1] = (row_off[i + 1] - row_off[i] + BM - 1) / BM;
  }
  if (threadIdx.x == 0) off[0] = 0;
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp scans off[1..E], a run of entries a lane
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int begin = 1 + lane * per;
    const int end = min(begin + per, E + 1);
    int sum = 0;
    for (int i = begin; i < end; ++i) sum += off[i];
    int incl = sum;
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, s);
      if (lane >= s) incl += v;
    }
    int run = incl - sum;
    for (int i = begin; i < end; ++i) {
      run += off[i];
      off[i] = run;
    }
  }
  __syncthreads();
  if (tile >= off[E]) return false;
  int lo = 0, hi = E;  // off[lo] <= tile < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (off[mid] <= tile) lo = mid; else hi = mid;
  }
  e = lo;
  r0 = row_off[e] + (tile - off[e]) * BM;
  r1 = min(r0 + BM, row_off[e + 1]);
  return true;
}

// Element offsets of the tile's rows: where each A row starts (pass 1: its
// token's row of x; pass 2: its sorted row of h) and where its output row
// starts (pass 1: its sorted row of h; pass 2: its flat row of y); -1 past
// the tile's rows.
template <int BM, bool GATED>
__device__ void tile_rows(const Args& a, int r0, int r1, long long* src,
                          long long* dst) {
  const int depth = GATED ? a.D : a.F;
  const int width = GATED ? a.F : a.D;
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    const int p = r0 + i;
    if (p < r1) {
      const long long flat = a.perm[p];
      src[i] = (GATED ? flat / a.K : p) * static_cast<long long>(depth);
      dst[i] = (GATED ? p : flat) * static_cast<long long>(width);
    } else {
      src[i] = -1;
      dst[i] = -1;
    }
  }
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// SiLU(gate) * up from the fp32 sums, rounded where the dense form rounds
// in bf16: each product, the SiLU and the product of the two (the caller
// rounds the last).
__device__ __forceinline__ float swiglu(float g, float u) {
  return round_bf16(silu(round_bf16(g))) * round_bf16(u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block's tile of BM rows x BN columns: warps side by side over the
// columns at BM = 16 (a warp 16 x 16), 2 x 2 at 64 and 4 x 2 at 128 (a warp
// 32 x 32); a ring of STAGES pieces of BK depth.
template <int BM, bool GATED>
struct Tile {
  static constexpr int WARPS_M = BM == 16 ? 1 : BM / 32;
  static constexpr int WARPS_N = BM == 16 ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // a warp's rows: 16 or 32
  static constexpr int WN = BN / WARPS_N;  // a warp's columns: 16 or 32
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int NMAT = GATED ? 2 : 1;
  static constexpr int STAGES = BM == 16 ? 4 : 3;
  static constexpr int A_ELEMS = BM * LD;
  static constexpr int B_ELEMS = BK * LD;
  static constexpr int STAGE = A_ELEMS + NMAT * B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE * 2;  // bytes
};

// Pass 1 (GATED: h from x through gate and up) or pass 2 (y from h through
// down) in bf16 on the tensor cores. grid (ceil(width / BN), row tiles).
template <int BM, bool GATED>
__global__ void __launch_bounds__(Tile<BM, GATED>::THREADS, 2)
expert_mma_kernel(Args a) {
  using G = Tile<BM, GATED>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ long long src[BM], dst[BM];
  int e, r0, r1;
  if (!find_tile<BM>(a.row_off, a.E, blockIdx.y, e, r0, r1)) return;
  tile_rows<BM, GATED>(a, r0, r1, src, dst);
  __syncthreads();

  const int depth = GATED ? a.D : a.F;
  const int width = GATED ? a.F : a.D;
  const int n0 = blockIdx.x * BN;
  const size_t expert = static_cast<size_t>(e) * a.D * a.F;
  const bf16* A = static_cast<const bf16*>(GATED ? a.x : a.h);
  const bf16* W0 = static_cast<const bf16*>(GATED ? a.w_gate : a.w_down) + expert;
  const bf16* W1 = static_cast<const bf16*>(a.w_up) + expert;

  auto load_stage = [&](int stage, int kt) {
    bf16* sa = smem + stage * G::STAGE;
    const int k0 = kt * BK;
    for (int c = threadIdx.x; c < BM * (BK / 8); c += G::THREADS) {
      const int r = c / (BK / 8), ch = c % (BK / 8);
      const long long s = src[r];
      const bool in = s >= 0 && k0 + ch * 8 < depth;
      cp_async16(sa + r * LD + ch * 8, in ? A + s + k0 + ch * 8 : A,
                 in ? 16 : 0);  // past the rows or the depth: zeros
    }
#pragma unroll
    for (int m = 0; m < G::NMAT; ++m) {
      const bf16* W = m == 0 ? W0 : W1;
      bf16* sb = sa + G::A_ELEMS + m * G::B_ELEMS;
      for (int c = threadIdx.x; c < BK * (BN / 8); c += G::THREADS) {
        const int r = c / (BN / 8), ch = c % (BN / 8);
        const bool in = k0 + r < depth && n0 + ch * 8 < width;
        cp_async16(sb + r * LD + ch * 8,
                   in ? W + static_cast<size_t>(k0 + r) * width + n0 + ch * 8
                      : W,
                   in ? 16 : 0);  // past the depth or the width: zeros
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  float acc[G::NMAT][G::MT][G::NT][4];
#pragma unroll
  for (int m = 0; m < G::NMAT; ++m)
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][j][q] = 0.f;

  const int KT = (depth + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    const int next = kt + G::STAGES - 1;
    if (next < KT) load_stage(next % G::STAGES, next);
    cp_async_commit();
    const bf16* sa = smem + (kt % G::STAGES) * G::STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[G::MT][4];
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        ldmatrix_x4(af[i], sa + (wm * G::WM + i * 16 + (lane & 15)) * LD +
                               kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int m = 0; m < G::NMAT; ++m) {
        const bf16* sb = sa + G::A_ELEMS + m * G::B_ELEMS;
#pragma unroll
        for (int jp = 0; jp < G::NT / 2; ++jp) {
          unsigned bfr[4];
          ldmatrix_x4_trans(
              bfr, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       wn * G::WN + jp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < G::MT; ++i) {
            mma_bf16(acc[m][i][2 * jp], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[m][i][2 * jp + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* O = static_cast<bf16*>(GATED ? a.h : a.y);
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * G::WM + i * 16 + (lane >> 2) + half * 8;
      const long long d = dst[r];
      if (d < 0) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int c = n0 + wn * G::WN + j * 8 + (lane & 3) * 2;
        if (c >= width) continue;
        float v0 = acc[0][i][j][2 * half], v1 = acc[0][i][j][2 * half + 1];
        if constexpr (GATED) {
          v0 = swiglu(v0, acc[G::NMAT - 1][i][j][2 * half]);
          v1 = swiglu(v1, acc[G::NMAT - 1][i][j][2 * half + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(O + d + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The same passes on fp32 operands, plain FMAs over 16 x 32 tiles (for
// tests and fp32 checks; the served model is bf16). grid (ceil(width / FBN),
// row tiles of FBM).
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
expert_fp32_kernel(Args a) {
  constexpr int NMAT = GATED ? 2 : 1;
  __shared__ float As[FBM][FBK + 1];
  __shared__ __align__(16) float Bs[NMAT][FBK][FBN];
  __shared__ long long src[FBM], dst[FBM];
  int e, r0, r1;
  if (!find_tile<FBM>(a.row_off, a.E, blockIdx.y, e, r0, r1)) return;
  tile_rows<FBM, GATED>(a, r0, r1, src, dst);
  __syncthreads();

  const int depth = GATED ? a.D : a.F;
  const int width = GATED ? a.F : a.D;
  const int n0 = blockIdx.x * FBN;
  const size_t expert = static_cast<size_t>(e) * a.D * a.F;
  const float* A = static_cast<const float*>(GATED ? a.x : a.h);
  const float* W0 = static_cast<const float*>(GATED ? a.w_gate : a.w_down) + expert;
  const float* W1 = static_cast<const float*>(a.w_up) + expert;
  const int r = threadIdx.x / (FBN / 4), c = (threadIdx.x % (FBN / 4)) * 4;
  float acc[NMAT][4] = {};
  for (int k0 = 0; k0 < depth; k0 += FBK) {
    for (int i = threadIdx.x; i < FBM * FBK; i += THREADS) {
      const int rr = i / FBK, kk = i % FBK;
      As[rr][kk] = src[rr] < 0 || k0 + kk >= depth ? 0.f : A[src[rr] + k0 + kk];
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const float* W = m == 0 ? W0 : W1;
      for (int i = threadIdx.x; i < FBK * FBN; i += THREADS) {
        const int kk = k0 + i / FBN, n = n0 + i % FBN;
        Bs[m][i / FBN][i % FBN] =
            kk < depth && n < width ? W[static_cast<size_t>(kk) * width + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FBK; ++kk) {
      const float av = As[r][kk];
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[m][kk][c]);
        acc[m][0] += av * b.x;
        acc[m][1] += av * b.y;
        acc[m][2] += av * b.z;
        acc[m][3] += av * b.w;
      }
    }
    __syncthreads();
  }
  if (dst[r] < 0 || n0 + c >= width) return;
  float4 v = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  if constexpr (GATED) {
    v = make_float4(silu(v.x) * acc[1][0], silu(v.y) * acc[1][1],
                    silu(v.z) * acc[1][2], silu(v.w) * acc[1][3]);
  }
  *reinterpret_cast<float4*>(static_cast<float*>(GATED ? a.h : a.y) + dst[r] +
                             n0 + c) = v;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// out[t] = sum_j gate[t, j] y[t K + j] in fp32, j in order; 0 for a dead
// row (its pairs were not computed). grid (T).
template <class T>
__global__ void __launch_bounds__(THREADS) combine_kernel(Args a) {
  const int t = blockIdx.x;
  const bool live = a.live == nullptr || a.live[t] != 0;
  const T* y = static_cast<const T*>(a.y) + static_cast<size_t>(t) * a.K * a.D;
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(t) * a.D;
  for (int d = threadIdx.x * 2; d < a.D; d += THREADS * 2) {
    float2 s = make_float2(0.f, 0.f);
    if (live) {
      for (int j = 0; j < a.K; ++j) {
        const float g = a.gates[static_cast<size_t>(t) * a.K + j];
        const float2 v = load2(y + static_cast<size_t>(j) * a.D + d);
        s.x += g * v.x;
        s.y += g * v.y;
      }
    }
    store2(out + d, s);
  }
}

template <class Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, int smem, const Args& a,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_mma(const Args& a, long long tiles, cudaStream_t s) {
  using G1 = Tile<BM, true>;
  using G2 = Tile<BM, false>;
  int err = launch_one(expert_mma_kernel<BM, true>,
                       dim3((a.F + BN - 1) / BN, static_cast<unsigned>(tiles)),
                       G1::THREADS, G1::SMEM, a, s);
  if (err) return err;
  return launch_one(expert_mma_kernel<BM, false>,
                    dim3((a.D + BN - 1) / BN, static_cast<unsigned>(tiles)),
                    G2::THREADS, G2::SMEM, a, s);
}

}  // namespace

// x (T, D), w_gate / w_up (E, D, F), w_down (E, F, D) in one type (bf16:
// bf16 != 0, else fp32), perm (T K,) int64, row_off (E + 1,) int32, gates
// (T, K) fp32, live (T,) bool or null, contiguous on the current device;
// h (T K, F) and y (T K, D) are scratch in the same type, out (T, D) is
// written. bm: rows a tile, 16, 64 or 128 (bf16; fp32 takes 16). Requires D
// and F multiples of 8, 1 <= E <= 256, T, K >= 1 and
// T K / bm + E < 65536. Returns cudaGetLastError() after the launches (0
// on success).
extern "C" int moe_experts_launch(const void* x, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  const void* perm, const void* row_off,
                                  const void* gates, const void* live, void* h,
                                  void* y, void* out, int T, int K, int E,
                                  int D, int F, int bf16_ops, int bm,
                                  void* stream) {
  if (T < 1 || K < 1 || E < 1 || E > MAX_E || D % UNIT || F % UNIT ||
      (bf16_ops ? (bm != 16 && bm != 64 && bm != 128) : bm != FBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(T) * K + bm - 1) / bm + E;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w_gate = w_gate;
  a.w_up = w_up;
  a.w_down = w_down;
  a.perm = static_cast<const long long*>(perm);
  a.row_off = static_cast<const int*>(row_off);
  a.gates = static_cast<const float*>(gates);
  a.live = static_cast<const unsigned char*>(live);
  a.h = h;
  a.y = y;
  a.out = out;
  a.T = T;
  a.K = K;
  a.E = E;
  a.D = D;
  a.F = F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (bf16_ops) {
    err = bm == 16   ? launch_mma<16>(a, tiles, s)
          : bm == 64 ? launch_mma<64>(a, tiles, s)
                     : launch_mma<128>(a, tiles, s);
    if (err) return err;
    return launch_one(combine_kernel<bf16>, dim3(T), THREADS, 0, a, s);
  }
  err = launch_one(expert_fp32_kernel<true>,
                   dim3((F + FBN - 1) / FBN, static_cast<unsigned>(tiles)),
                   THREADS, 0, a,
                   s);
  if (err) return err;
  err = launch_one(expert_fp32_kernel<false>,
                   dim3((D + FBN - 1) / FBN, static_cast<unsigned>(tiles)),
                   THREADS, 0, a,
                   s);
  if (err) return err;
  return launch_one(combine_kernel<float>, dim3(T), THREADS, 0, a, s);
}

// Message for a code returned by this library's launch function.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
