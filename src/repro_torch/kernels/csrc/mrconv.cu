// Max-relative graph aggregation (MRConv), for sm_90a.
//
//   out[b, i, :] = max_{j < k} (y[b, idx[b, i, j], :] - x[b, i, :])
//
// Replaces repro/kernels/mrconv.py::mrconv_pallas. The TPU kernel gathers
// rows as a one-hot product on its matrix unit, because row gathers are
// slow on its vector unit; here a thread reads the neighbour row directly.
//
// What bounds it on an H100: bytes. Each output element costs k loads of
// y and two flops, so device memory (data-sheet peak 3.35 TB/s for the
// H100 SXM) and the L2 cache that holds the gathered rows are the limit,
// not arithmetic. One warp owns one output row and loads it with 16-byte
// vectors where D and the pointers allow; the k neighbour ids are
// broadcast loads shared by the warp. The
// running max starts at -1e30 in fp32. Ids follow the JAX wrapper, which
// pads M to Mpad zero rows: an id in [M, Mpad) reads a zero row (it
// contributes -x), an id outside [0, Mpad) contributes nothing. A NaN
// propagates, as torch.amax does, so the result equals the plain PyTorch
// version bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROWS = 4;  // output rows (one warp each) per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

template <bool VEC4>
__global__ void __launch_bounds__(32 * ROWS)
mrconv_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ idx, float* __restrict__ out, int rows,
              int N, int M, int Mpad, int D, int K) {
  const int row = blockIdx.x * ROWS + threadIdx.y;
  if (row >= rows) return;
  const int b = row / N;
  const float* xr = x + static_cast<size_t>(row) * D;
  const float* yb = y + static_cast<size_t>(b) * M * D;
  const int* ir = idx + static_cast<size_t>(row) * K;
  float* orow = out + static_cast<size_t>(row) * D;
  if (VEC4) {
    const int d4 = D / 4;
    for (int c = threadIdx.x; c < d4; c += 32) {
      const float4 xv = reinterpret_cast<const float4*>(xr)[c];
      float4 acc = make_float4(NEG, NEG, NEG, NEG);
      for (int j = 0; j < K; ++j) {
        const int nb = __ldg(ir + j);
        if (nb < 0 || nb >= Mpad) continue;
        const float4 yv =
            nb < M ? reinterpret_cast<const float4*>(
                         yb + static_cast<size_t>(nb) * D)[c]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        acc.x = max_nan(acc.x, yv.x - xv.x);
        acc.y = max_nan(acc.y, yv.y - xv.y);
        acc.z = max_nan(acc.z, yv.z - xv.z);
        acc.w = max_nan(acc.w, yv.w - xv.w);
      }
      reinterpret_cast<float4*>(orow)[c] = acc;
    }
  } else {
    for (int c = threadIdx.x; c < D; c += 32) {
      const float xv = xr[c];
      float acc = NEG;
      for (int j = 0; j < K; ++j) {
        const int nb = __ldg(ir + j);
        if (nb < 0 || nb >= Mpad) continue;
        const float yv = nb < M ? yb[static_cast<size_t>(nb) * D + c] : 0.f;
        acc = max_nan(acc, yv - xv);
      }
      orow[c] = acc;
    }
  }
}

}  // namespace

// x (B, N, D), y (B, M, D) fp32 and idx (B, N, K) int32, contiguous on the
// current device; out (B, N, D) fp32 is written. Mpad >= M is the JAX
// wrapper's padded row count. Requires B, N, M >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mrconv_launch(const void* x, const void* y, const void* idx,
                             void* out, int B, int N, int M, int Mpad, int D,
                             int K, void* stream) {
  const int rows = B * N;
  const dim3 block(32, ROWS);
  const dim3 grid((rows + ROWS - 1) / ROWS);
  const bool vec4 = D % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y) |
                      reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const int* ii = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (vec4) {
    mrconv_kernel<true>
        <<<grid, block, 0, s>>>(xf, yf, ii, of, rows, N, M, Mpad, D, K);
  } else {
    mrconv_kernel<false>
        <<<grid, block, 0, s>>>(xf, yf, ii, of, rows, N, M, Mpad, D, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by any launch function of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
