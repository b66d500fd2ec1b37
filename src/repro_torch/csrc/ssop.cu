// SS-OP, the fused low-rank rotation of ELSA's channel, for Hopper (sm_90a):
//
//     out[t, :] = H[t, :] + ((H[t, :] U) W) U^T
//
// with H (T, D), U (D, r) and W (r, r), accumulated in fp32 and rounded once
// to the type of H: the semantics of the plain version in
// repro_torch/kernels/ssop/ref.py.  W = V^T - I gives the rotation H Q^T,
// W = V - I its inverse, and W^T the backward of either (the map is
// H -> H (I + U W U^T), so its VJP is g -> g (I + U W^T U^T)).
//
// Replaces the TPU kernel repro/kernels/ssop/kernel.py::_ssop_kernel
// (ssop_apply_td), which streams (128, D) tiles of H through VMEM with U and
// W resident there and does the three products on the MXU.
//
// What bounds it on an H100: at the training shapes (T = 512 rows, D = 2048,
// r = 16) the work is 4 T D r = 67 Mflop against 2 T D elements of H and out
// (4 MB in bf16), about 16 flops a byte: the bytes bound it (1.3 us at
// 3.35 TB/s).  So the design reads each row of H from device memory once
// (the second pass finds it in L2) and keeps H U and (H U) W on chip.
//
// Design (right and simple first):
//   * A block of 256 threads owns kRows = 4 rows of H; rows past T are zero.
//   * Pass 1: each thread walks its columns d (stride 256) and sums
//     H[t, d] U[d, j] for the block's rows and one strip of kStrip = 16 of
//     the r columns, in registers; warps reduce by butterfly shuffles, then
//     the 8 warps' partials are summed through shared memory in warp order.
//     r <= 64 takes up to four strips.  The order of every sum is fixed, so
//     the result does not depend on scheduling.
//   * (H U) W, at most 4 x 64 values, is one thread per value.
//   * Pass 2: each thread rereads its columns of H, adds sum_j P W[t, j]
//     U[d, j] and rounds once.
//   * CUDA cores in fp32 throughout: 16 flops a byte does not need the tensor
//     cores, and f32 there would round to TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of H per block
constexpr int kStrip = 16;     // columns of U per pass-1 strip
constexpr int kMaxRank = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssop_kernel(const T* __restrict__ h, const T* __restrict__ u,
            const T* __restrict__ w, T* __restrict__ out, int n_rows, int D,
            int r) {
  __shared__ float red[kWarps][kRows * kStrip];
  __shared__ float p[kRows][kMaxRank];
  __shared__ float pw[kRows][kMaxRank];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kRows;
  int n_t = n_rows - row0;
  n_t = n_t < kRows ? n_t : kRows;

  // pass 1: p = H U, one strip of kStrip columns at a time
  for (int j0 = 0; j0 < r; j0 += kStrip) {
    float acc[kRows][kStrip];
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int c = 0; c < kStrip; ++c) acc[t][c] = 0.f;
    for (int d = tid; d < D; d += kThreads) {
      float hv[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        hv[t] = t < n_t ? to_f(h[(size_t)(row0 + t) * D + d]) : 0.f;
      const T* ud = u + (size_t)d * r + j0;
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        if (j0 + c < r) {
          const float uv = to_f(ud[c]);
#pragma unroll
          for (int t = 0; t < kRows; ++t) acc[t][c] += hv[t] * uv;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        float v = acc[t][c];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][t * kStrip + c] = v;
      }
    __syncthreads();
    if (tid < kRows * kStrip) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
      const int t = tid / kStrip, c = tid % kStrip;
      if (j0 + c < r) p[t][j0 + c] = s;
    }
    __syncthreads();
  }

  // pw = p W
  if (tid < kRows * r) {
    const int t = tid / r, j = tid % r;
    float s = 0.f;
    for (int k = 0; k < r; ++k) s += p[t][k] * to_f(w[k * r + j]);
    pw[t][j] = s;
  }
  __syncthreads();

  // pass 2: out = H + pw U^T
  for (int d = tid; d < D; d += kThreads) {
    float upd[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) upd[t] = 0.f;
    const T* ud = u + (size_t)d * r;
    for (int j = 0; j < r; ++j) {
      const float uv = to_f(ud[j]);
#pragma unroll
      for (int t = 0; t < kRows; ++t) upd[t] += pw[t][j] * uv;
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (t < n_t) {
        const size_t i = (size_t)(row0 + t) * D + d;
        out[i] = from_f<T>(to_f(h[i]) + upd[t]);
      }
    }
  }
}

template <typename T>
int launch(const void* h, const void* u, const void* w, void* out, int n_rows,
           int D, int r, void* stream) {
  if (n_rows <= 0 || D <= 0) return 0;
  if (r < 1 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + kRows - 1) / kRows;
  ssop_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(u),
      static_cast<const T*>(w), static_cast<T*>(out), n_rows, D, r);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Device pointers, row-major and
// contiguous: h and out (n_rows, D), u (D, r), w (r, r), all of one type;
// 1 <= r <= 64.  out must not alias h.  Returns the launch's
// cudaGetLastError().
extern "C" int ssop_apply_bf16(const void* h, const void* u, const void* w,
                               void* out, int n_rows, int D, int r,
                               void* stream) {
  return launch<__nv_bfloat16>(h, u, w, out, n_rows, D, r, stream);
}

extern "C" int ssop_apply_f32(const void* h, const void* u, const void* w,
                              void* out, int n_rows, int D, int r,
                              void* stream) {
  return launch<float>(h, u, w, out, n_rows, D, r, stream);
}
