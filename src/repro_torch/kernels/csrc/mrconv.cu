// Max-relative graph aggregation (MRConv), for sm_90a.
//
//   out[b, i, :] = max_{j < k} (y[b, idx[b, i, j], :] - x[b, i, :])
//
// Replaces repro/kernels/mrconv.py::mrconv_pallas. The TPU kernel gathers
// rows as a one-hot product on its matrix unit, because row gathers are
// slow on its vector unit; here a lane reads the neighbour rows directly.
//
// What bounds it on an H100: bytes, in principle. Each output element
// costs k loads of y and two flops, so device memory (data-sheet peak
// 3.35 TB/s for the H100 SXM) and the L2 cache that holds the gathered
// rows are the limit, not arithmetic. At the main path's sizes (3.6 MB of
// reads at the iso shape, ~1 us at that rate) the time is latency: the
// launch itself, the id -> row load chain, and a lane that walks its k
// neighbours one dependent load at a time keeps one row load in flight.
// The design:
//   - the grid is launched with programmatic stream serialization: its
//     blocks are resident, their index arithmetic done, while the kernel
//     ahead of it in the stream finishes, and wait for it at
//     griddepcontrol.wait before the first load. Back to back, a launch
//     of one row costs ~2 us instead of ~3 (PERF.md);
//   - a lane owns one vector of one row: a row is P parts of L lanes (at
//     D = 192, 48 float4 in 3 parts of 16; 2 parts a warp), L in {8, 16,
//     32} chosen so the fewest lanes idle. One vector a lane gives three
//     times the warps of a lane walking 3 vectors, and warps in flight are
//     what hides the gather's latency. Blocks walk one image's rows along
//     x and the images along y, so the only division a lane makes is its
//     slot by the row's slots;
//   - the warp loads its parts' ids once, up to 32 a row (one id per lane
//     and batch of 8 neighbours), and hands each lane its row's ids with
//     __shfl_sync;
//   - a lane issues a batch's 8 row loads before its first max, with
//     predicates in place of branches.
// Rows are read as 16-byte vectors where D and the pointers allow. The
// running max starts at -1e30 in fp32 and takes the neighbours in order.
// Ids follow the JAX wrapper, which pads M to Mpad zero rows: an id in
// [M, Mpad) reads a zero row (it contributes -x), an id outside [0, Mpad)
// contributes nothing. A NaN propagates, as torch.amax does, so the result
// equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 4;   // warps per block
constexpr int BATCH = 8;   // neighbour loads in flight per lane
constexpr int IDS = 32;    // neighbour ids a warp loads at once (a row's)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ float splat(float v, float) { return v; }
__device__ __forceinline__ float4 splat(float v, float4) {
  return make_float4(v, v, v, v);
}

__device__ __forceinline__ float max_rel(float acc, float y, float x) {
  return max_nan(acc, y - x);
}
__device__ __forceinline__ float4 max_rel(float4 acc, float4 y, float4 x) {
  return make_float4(max_nan(acc.x, y.x - x.x), max_nan(acc.y, y.y - x.y),
                     max_nan(acc.z, y.z - x.z), max_nan(acc.w, y.w - x.w));
}

// T is float4 (W = D / 4 vectors a row) or float (W = D). A row is S =
// P * L slots, one vector a lane, P parts of L = 1 << lsh lanes; a warp
// takes 32 / L parts. Blocks walk an image's N * S slots along x and the
// images along y (up to 65535 a launch), so a lane finds its row and
// vector with one division.
template <class T>
__global__ void __launch_bounds__(32 * WARPS)
mrconv_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ idx, float* __restrict__ out, int N,
              int M, int Mpad, int W, int K, int S, int lsh) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (32 * WARPS) + threadIdx.x;
  const int row = t / S;  // the lane's row of its image
  const int c = t - row * S;
  const bool live = row < N && c < W;
  const int sub = lane >> lsh;  // the lane's part in the warp
  // Id loads: lane i fetches neighbour i % BATCH of the warp's part
  // i / BATCH, whose row is that of the part's first lane.
  const int id_row = __shfl_sync(FULL, row, (lane / BATCH) << lsh);
  const bool id_live = lane / BATCH < (32 >> lsh) && id_row < N;
  const T zero = splat(0.f, T());
  // Launched with programmatic stream serialization, the grid is resident
  // before the kernel ahead of it in the stream (the DIGC kernel that
  // wrote idx) has finished; it waits here, before its first load, for
  // that kernel's end and its writes.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int b = blockIdx.y;
  const size_t r = static_cast<size_t>(b) * N + (live ? row : 0);
  const T* yb = reinterpret_cast<const T*>(y) + static_cast<size_t>(b) * M * W;
  const T xv = live ? reinterpret_cast<const T*>(x)[r * W + c] : zero;
  const int* ir = idx + (static_cast<size_t>(b) * N + (id_live ? id_row : 0)) * K;
  T acc = splat(NEG, T());
  for (int j1 = 0; j1 < K; j1 += IDS) {  // warp-uniform
    // The ids of neighbours [j1, j1 + IDS), all loaded before the first
    // row load: lane i holds neighbour j1 + 8 q + i % 8 of part i / 8.
    int mine[IDS / BATCH];
#pragma unroll
    for (int q = 0; q < IDS / BATCH; ++q) {
      const int j = j1 + q * BATCH + lane % BATCH;
      mine[q] = id_live && j < K ? __ldg(ir + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < IDS / BATCH; ++q) {
      if (j1 + q * BATCH < K) {  // warp-uniform
        int nb[BATCH];
        bool ok[BATCH];
        T v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          nb[u] = __shfl_sync(FULL, mine[q], sub * BATCH + u);
          ok[u] = live && nb[u] >= 0 && nb[u] < Mpad;  // false past k
          v[u] = ok[u] && nb[u] < M ? yb[static_cast<size_t>(nb[u]) * W + c]
                                    : zero;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (ok[u]) acc = max_rel(acc, v[u], xv);
        }
      }
    }
  }
  if (live) reinterpret_cast<T*>(out)[r * W + c] = acc;
}

// log2 of the lanes a part of a row: of 8, 16 and 32, the one that
// leaves the fewest lanes idle over the row's W vectors, the widest among
// equals.
int lanes_per_row_log2(int W) {
  int best = 5;
  long long best_slots = 0;
  for (int lsh = 5; lsh >= 3; --lsh) {
    const int L = 1 << lsh;
    const long long slots = static_cast<long long>((W + L - 1) / L) * L;
    if (lsh == 5 || slots < best_slots) {
      best = lsh;
      best_slots = slots;
    }
  }
  return best;
}

template <class T>
int launch(const void* x, const void* y, const void* idx, void* out, int B,
           int N, int M, int Mpad, int W, int K, cudaStream_t stream) {
  const int lsh = lanes_per_row_log2(W);
  const int L = 1 << lsh;
  const long long S = static_cast<long long>((W + L - 1) / L) * L;
  const long long blocks = (N * S + 32 * WARPS - 1) / (32 * WARPS);
  constexpr size_t VEC = sizeof(T) / sizeof(float);  // floats a vector
  if (N * S > INT32_MAX - 32 * WARPS || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b0 = 0; b0 < B; b0 += 65535) {  // grid.y takes 65535 at most
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const size_t rows = static_cast<size_t>(b0) * N;
    cudaLaunchAttribute early;
    early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks), nb);
    cfg.blockDim = dim3(32 * WARPS);
    cfg.stream = stream;
    cfg.attrs = &early;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, mrconv_kernel<T>, static_cast<const float*>(x) + rows * W * VEC,
        static_cast<const float*>(y) + static_cast<size_t>(b0) * M * W * VEC,
        static_cast<const int*>(idx) + rows * K,
        static_cast<float*>(out) + rows * W * VEC, N, M, Mpad, W, K,
        static_cast<int>(S), lsh);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N, D), y (B, M, D) fp32 and idx (B, N, K) int32, contiguous on the
// current device; out (B, N, D) fp32 is written. Mpad >= M is the JAX
// wrapper's padded row count. Requires B, N, M >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mrconv_launch(const void* x, const void* y, const void* idx,
                             void* out, int B, int N, int M, int Mpad, int D,
                             int K, void* stream) {
  const bool vec4 = D % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y) |
                      reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    return launch<float4>(x, y, idx, out, B, N, M, Mpad, D / 4, K, s);
  }
  return launch<float>(x, y, idx, out, B, N, M, Mpad, D, K, s);
}

// Message for a code returned by any launch function of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
