// Count-sketch compress and median decode of ELSA's channel, with their
// backwards, for Hopper (sm_90a).  A plan has Y hash rows over D features and
// Z buckets: bucket[y, d] in [0, Z) and sign[y, d] in {-1, +1}.
//
// Replaces the TPU kernels repro/kernels/count_sketch/kernel.py::
// _compress_kernel (sketch_compress_tz) and _decompress_kernel + _median_rows
// (sketch_decompress_tz).  The TPU had no fast scatter or gather, so those
// kernels multiply by the dense signed-selection tensor S (Y, D, Z) on the
// MXU: D x Z multiplies for every output where about D / Z are nonzero.  On
// Hopper the hash is a scatter and a gather, as the paper's Eqs. 20-21 state
// it, and S is never built.
//
// Two kernels, each with two modes:
//
//   scatter, one output (t, y, z) per thread and pass over its bucket's
//   feature list, read from the plan's inverse index (CSR: for each (y, z)
//   the d with bucket[y, d] = z, ascending), so every output sums its own
//   list in a fixed order, with no atomics:
//     mode 0, compress:        out[t,y,z] = sum_d sign[y,d] x[t,d]
//     mode 1, median backward: out[t,y,z] = sum_d sign[y,d] m[t,y,d] x[t,d]
//       where x is the gradient of the decoded (T, D) estimate and m[t,y,d]
//       the weight the median network gives row y of column d.  m is
//       recomputed here from the sketch u (T, Y, Z) by replaying the network,
//       not saved from the forward.
//   gather, one output (t, d) per thread:
//     mode 0, decompress: est[y] = sign[y,d] u[t,y,bucket[y,d]], then the
//       median over y by the compare-exchange network of _median_rows (an even
//       Y averages the middle two);
//     mode 1, compress backward: sum_y sign[y,d] u[t,y,bucket[y,d]], y
//       ascending.
//
// The median network's gradient follows JAX's rule for min and max: at a tie
// each input takes half.  The backward replays the network forward, keeping
// the outcome of each compare, then carries the output's weight back through
// the compares in reverse.
//
// What bounds them on an H100: at the training shapes (T = 512, D = 2048,
// Y = 3, Z = 325) each moves T D + T Y Z elements (3 MB in bf16) for about
// 2 T Y D flops: the bytes bound them (about 1 us).  A block owns kRows = 4
// rows: it copies their x and u rows into shared memory once as fp32 (so
// the scattered reads by bucket hit shared memory, not device memory) and
// reuses each index and sign it reads for all 4 rows.  Sums are fp32,
// rounded once to the input type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;     // rows of x / u per block
constexpr int kMaxY = 8;

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

// Copy rows [row0, row0 + kRows) of a (n_rows, n) matrix into dst (kRows, n)
// as fp32, zeros past n_rows.
template <typename T>
__device__ void load_rows(float* dst, const T* src, int row0, int n_rows,
                          int n) {
  for (int i = threadIdx.x; i < kRows * n; i += kThreads) {
    const int t = i / n;
    dst[i] = row0 + t < n_rows ? to_f(src[(size_t)row0 * n + i]) : 0.f;
  }
}

// The median network of _median_rows over v[0..Y): returns the median.  With
// kKeep, rel[c] records compare c's outcome (0: a < b, 1: a > b, 2: tie).
template <int kY, bool kKeep>
__device__ __forceinline__ float median_network(float (&v)[kY],
                                                int (&rel)[kY * kY]) {
#pragma unroll
  for (int i = 0; i < kY; ++i)
#pragma unroll
    for (int j = 0; j < kY - 1 - i; ++j) {
      const float a = v[j], b = v[j + 1];
      if (kKeep) rel[i * kY + j] = a < b ? 0 : (a > b ? 1 : 2);
      v[j] = fminf(a, b);
      v[j + 1] = fmaxf(a, b);
    }
  if (kY % 2) return v[(kY - 1) / 2];
  return __fmul_rn(0.5f, __fadd_rn(v[kY / 2 - 1], v[kY / 2]));
}

// The weight row `y` of the input takes in the median, given the outcomes
// of the forward compares: the output's unit gradient carried back through
// the network, a tie splitting it in halves.
template <int kY>
__device__ __forceinline__ float median_weight(const int (&rel)[kY * kY],
                                               int y) {
  float g[kY];
#pragma unroll
  for (int i = 0; i < kY; ++i) g[i] = 0.f;
  if (kY % 2) {
    g[(kY - 1) / 2] = 1.f;
  } else {
    g[kY / 2 - 1] = 0.5f;
    g[kY / 2] = 0.5f;
  }
#pragma unroll
  for (int i = kY - 1; i >= 0; --i)
#pragma unroll
    for (int j = kY - 2 - i; j >= 0; --j) {
      const float glo = g[j], ghi = g[j + 1];
      const int c = rel[i * kY + j];
      if (c == 0) {          // a was the min: lo <- a, hi <- b
        g[j] = glo;
        g[j + 1] = ghi;
      } else if (c == 1) {   // a was the max
        g[j] = ghi;
        g[j + 1] = glo;
      } else {               // tie: each input takes half of each output
        const float half = 0.5f * (glo + ghi);
        g[j] = half;
        g[j + 1] = half;
      }
    }
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < kY; ++i)
    if (i == y) out = g[i];
  return out;
}

// ---------------------------------------------------------------------------
// scatter: out (n_rows, Y, Z) from x (n_rows, D) [and u (n_rows, Y, Z)]
// ---------------------------------------------------------------------------

// kY > 0 is the median backward (mode 1) for Y = kY; kY == 0 is compress.
template <typename T, int kY>
__global__ void __launch_bounds__(kThreads)
sketch_scatter_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const int* __restrict__ ptr, const int* __restrict__ idx,
                      const float* __restrict__ sign,
                      const int* __restrict__ bucket, T* __restrict__ out,
                      int n_rows, int D, int Y, int Z) {
  extern __shared__ float smem[];
  float* xs = smem;                    // (kRows, D)
  float* us = smem + kRows * D;        // (kRows, Y * Z), median backward only
  const int YZ = Y * Z;
  const int row0 = blockIdx.x * kRows;
  int n_t = n_rows - row0;
  n_t = n_t < kRows ? n_t : kRows;
  load_rows(xs, x, row0, n_rows, D);
  if (kY > 0) load_rows(us, u, row0, n_rows, YZ);
  __syncthreads();

  for (int yz = threadIdx.x; yz < YZ; yz += kThreads) {
    const int y = yz / Z;
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
    const int end = ptr[yz + 1];
    for (int k = ptr[yz]; k < end; ++k) {
      const int d = idx[k];
      const float s = sign[(size_t)y * D + d];
      if constexpr (kY == 0) {
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] += s * xs[t * D + d];
      } else {
        int bk[kY];
        float sg[kY];
#pragma unroll
        for (int yy = 0; yy < kY; ++yy) {
          bk[yy] = bucket[(size_t)yy * D + d];
          sg[yy] = sign[(size_t)yy * D + d];
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          float v[kY];
          int rel[kY * kY];
#pragma unroll
          for (int yy = 0; yy < kY; ++yy)
            v[yy] = sg[yy] * us[t * YZ + yy * Z + bk[yy]];
          median_network<kY, true>(v, rel);
          acc[t] += s * (median_weight<kY>(rel, y) * xs[t * D + d]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      if (t < n_t) out[(size_t)(row0 + t) * YZ + yz] = from_f<T>(acc[t]);
  }
}

// ---------------------------------------------------------------------------
// gather: out (n_rows, D) from u (n_rows, Y, Z)
// ---------------------------------------------------------------------------

template <typename T, int kY, bool kMedian>
__global__ void __launch_bounds__(kThreads)
sketch_gather_kernel(const T* __restrict__ u, const int* __restrict__ bucket,
                     const float* __restrict__ sign, T* __restrict__ out,
                     int n_rows, int D, int Z) {
  extern __shared__ float smem[];
  float* us = smem;                    // (kRows, kY * Z)
  const int YZ = kY * Z;
  const int row0 = blockIdx.x * kRows;
  int n_t = n_rows - row0;
  n_t = n_t < kRows ? n_t : kRows;
  load_rows(us, u, row0, n_rows, YZ);
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kThreads) {
    int bk[kY];
    float sg[kY];
#pragma unroll
    for (int yy = 0; yy < kY; ++yy) {
      bk[yy] = bucket[(size_t)yy * D + d];
      sg[yy] = sign[(size_t)yy * D + d];
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (t >= n_t) break;
      float v[kY];
#pragma unroll
      for (int yy = 0; yy < kY; ++yy)
        v[yy] = sg[yy] * us[t * YZ + yy * Z + bk[yy]];
      float res;
      if constexpr (kMedian) {
        int rel[kY * kY];
        res = median_network<kY, false>(v, rel);
      } else {
        res = 0.f;
#pragma unroll
        for (int yy = 0; yy < kY; ++yy) res += v[yy];
      }
      out[(size_t)(row0 + t) * D + d] = from_f<T>(res);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Allow `smem` bytes of dynamic shared memory for the kernel (above 48 KB
// it must be asked for, once per kernel), then launch it over the row blocks.
template <auto kKernel, typename... Args>
int launch_rows(int smem, int n_rows, cudaStream_t s, Args... args) {
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int blocks = (n_rows + kRows - 1) / kRows;
  kKernel<<<blocks, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int kY>
int scatter_median_bwd(const T* x, const T* u, const int* ptr, const int* idx,
                       const float* sign, const int* bucket, T* out,
                       int n_rows, int D, int Z, cudaStream_t s) {
  const int smem = kRows * (D + kY * Z) * (int)sizeof(float);
  return launch_rows<sketch_scatter_kernel<T, kY>>(smem, n_rows, s, x, u, ptr,
                                                  idx, sign, bucket, out,
                                                  n_rows, D, kY, Z);
}

template <typename T, int kY>
int gather(const T* u, const int* bucket, const float* sign, T* out,
           int n_rows, int D, int Z, int mode, cudaStream_t s) {
  const int smem = kRows * kY * Z * (int)sizeof(float);
  if (mode == 0)
    return launch_rows<sketch_gather_kernel<T, kY, true>>(
        smem, n_rows, s, u, bucket, sign, out, n_rows, D, Z);
  return launch_rows<sketch_gather_kernel<T, kY, false>>(
      smem, n_rows, s, u, bucket, sign, out, n_rows, D, Z);
}

#define SKETCH_FOR_EACH_Y(F, ...)            \
  switch (Y) {                               \
    case 1: return F<T, 1>(__VA_ARGS__);     \
    case 2: return F<T, 2>(__VA_ARGS__);     \
    case 3: return F<T, 3>(__VA_ARGS__);     \
    case 4: return F<T, 4>(__VA_ARGS__);     \
    case 5: return F<T, 5>(__VA_ARGS__);     \
    case 6: return F<T, 6>(__VA_ARGS__);     \
    case 7: return F<T, 7>(__VA_ARGS__);     \
    case 8: return F<T, 8>(__VA_ARGS__);     \
    default: return (int)cudaErrorInvalidValue; \
  }

template <typename T>
int scatter(const void* x, const void* u, const void* ptr, const void* idx,
            const void* sign, const void* bucket, void* out, int n_rows, int D,
            int Y, int Z, int mode, void* stream) {
  if (n_rows <= 0) return 0;
  if (D <= 0 || Z <= 0 || Y < 1 || Y > kMaxY || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* up = static_cast<const T*>(u);
  const int* pp = static_cast<const int*>(ptr);
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(sign);
  const int* bp = static_cast<const int*>(bucket);
  T* op = static_cast<T*>(out);
  if (mode == 0) {
    const int smem = kRows * D * (int)sizeof(float);
    return launch_rows<sketch_scatter_kernel<T, 0>>(
        smem, n_rows, s, xp, up, pp, ip, sp, bp, op, n_rows, D, Y, Z);
  }
  SKETCH_FOR_EACH_Y(scatter_median_bwd, xp, up, pp, ip, sp, bp, op, n_rows, D,
                    Z, s)
}

template <typename T>
int gather_any(const void* u, const void* bucket, const void* sign, void* out,
               int n_rows, int D, int Y, int Z, int mode, void* stream) {
  if (n_rows <= 0) return 0;
  if (D <= 0 || Z <= 0 || Y < 1 || Y > kMaxY || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  SKETCH_FOR_EACH_Y(gather, static_cast<const T*>(u),
                    static_cast<const int*>(bucket),
                    static_cast<const float*>(sign), static_cast<T*>(out),
                    n_rows, D, Z, mode, s)
}

}  // namespace

// C interface, loaded with ctypes.  Device pointers, row-major and
// contiguous.  x (n_rows, D) and out/u (n_rows, Y, Z) of one type; ptr
// (Y Z + 1) and idx (Y D) int32, the plan's inverse index; sign (Y, D)
// float32; bucket (Y, D) int32; 1 <= Y <= 8.  mode 0 is compress, mode 1
// the median's backward (which reads u and bucket).  Shared memory holds
// 4 (D + Y Z) floats.  Returns the launch's cudaGetLastError().
extern "C" int sketch_scatter_bf16(const void* x, const void* u,
                                   const void* ptr, const void* idx,
                                   const void* sign, const void* bucket,
                                   void* out, int n_rows, int D, int Y, int Z,
                                   int mode, void* stream) {
  return scatter<__nv_bfloat16>(x, u, ptr, idx, sign, bucket, out, n_rows, D,
                                Y, Z, mode, stream);
}

extern "C" int sketch_scatter_f32(const void* x, const void* u,
                                  const void* ptr, const void* idx,
                                  const void* sign, const void* bucket,
                                  void* out, int n_rows, int D, int Y, int Z,
                                  int mode, void* stream) {
  return scatter<float>(x, u, ptr, idx, sign, bucket, out, n_rows, D, Y, Z,
                        mode, stream);
}

// u (n_rows, Y, Z) -> out (n_rows, D) of the same type; bucket (Y, D) int32,
// sign (Y, D) float32.  mode 0 is the median decode, mode 1 the sum over y
// (compress's backward).  Shared memory holds 4 Y Z floats.
extern "C" int sketch_gather_bf16(const void* u, const void* bucket,
                                  const void* sign, void* out, int n_rows,
                                  int D, int Y, int Z, int mode, void* stream) {
  return gather_any<__nv_bfloat16>(u, bucket, sign, out, n_rows, D, Y, Z, mode,
                                   stream);
}

extern "C" int sketch_gather_f32(const void* u, const void* bucket,
                                 const void* sign, void* out, int n_rows,
                                 int D, int Y, int Z, int mode, void* stream) {
  return gather_any<float>(u, bucket, sign, out, n_rows, D, Y, Z, mode,
                           stream);
}
