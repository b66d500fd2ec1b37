// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention with grouped-query heads,
//
//     o[b, s, h, :] = sum_t softmax_t(scale q[b, s, h, :] . k[b, t, h/G, :])
//                     v[b, t, h/G, :]
//
// over the unmasked t (causal: t <= s; window w > 0: t > s - w), with fp32
// scores, masked scores set to the finite NEG_INF = -1e30, fp32 running row
// maximum m, row sum l and accumulator, and the output acc / max(l, 1e-30)
// rounded once to q's type.  It also writes m and l (fp32, (B, H, Sq)) for
// the backward.  These are the semantics of the plain version in
// repro_torch/kernels/flash_attention/ref.py.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _attn_kernel (flash_attention_bhsd), which walks a (B*H, Sq/512, Sk/512)
// grid with the kv axis innermost, keeps m, l and acc in VMEM scratch across
// kv steps, maps GQA in its index maps and needs tile-multiple lengths.
//
// What bounds it on an H100: 4 Sq Sk Dh operations per (b, h) against
// (2 Sq + 2 Sk) Dh elements, so for the lengths of this repository (S 64 to
// 4096) operations bound it.  This first version does them on the CUDA cores
// in fp32 (f32 inputs must not round to TF32), so it is far from the bf16
// tensor-core bound; wgmma, TMA and a bf16 P V are later work.
//
// Design (right and simple first):
//   * One block of 256 threads per (tile of 64 query rows, head h, batch b).
//     The query tile is staged once in shared memory as fp32; kv tiles of 64
//     rows of K and V follow, one at a time, also as fp32.  Rows of shared
//     memory are padded by one float, so the column reads of K are free of
//     bank conflicts.
//   * Thread (ty, tx) of a 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, the
//     score columns tx + 16 j (j < 4) of each kv tile and the output columns
//     tx + 16 c (c < Dh / 16).  A row's maximum and sum are reduced over its
//     16 threads by butterfly shuffles inside a half warp, so every thread of
//     the row holds the same m and l.
//   * The probabilities go through shared memory for the P V product.
//   * q, k and v are read in place with their (batch, sequence, head) strides
//     (the last dimension must be contiguous); GQA maps query head h to kv
//     head h / G.  Query rows >= Sq and kv rows >= Sk are masked, so any
//     length works.  kv tiles wholly masked for the block (above the causal
//     diagonal, or before the window of its first row) are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // kv rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kRowsPerThread = kBlockQ / 16;
constexpr int kColsPerThread = kBlockK / 16;
constexpr int kLdP = kBlockK + 1;
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  return 3 * kBlockQ * (D + 1) + kBlockQ * kLdP;
}

struct Strides {
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int Sq, int Sk, int H, int G, Strides qs, Strides ks,
                 Strides vs, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                    // [kBlockQ][LD]
  float* sk = sq + kBlockQ * LD;       // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;       // [kBlockK][LD]
  float* sp = sv + kBlockK * LD;       // [kBlockQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    sq[r * LD + c] = s < Sq ? to_f(qb[s * qs.s + c]) : 0.f;
  }

  float acc[kRowsPerThread][kOut];
  float m_i[kRowsPerThread];
  float l_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // the kv range any row of this block attends to
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers (and the q tile) are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      sk[r * LD + c] = t < Sk ? to_f(kb[t * ks.s + c]) : 0.f;
      sv[r * LD + c] = t < Sk ? to_f(vb[t * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = sq[(ty * kRowsPerThread + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = ty * kRowsPerThread + i;
      const int qp = q0 + row;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk && qp < Sq;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_i[i], rmax);
      const float corr = expf(m_i[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[row * kLdP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * corr + rsum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = sp[(ty * kRowsPerThread + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = sv[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = q0 + ty * kRowsPerThread + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((long long)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      orow[tx + 16 * c] = from_f<T>(acc[i][c] / denom);
    if (tx == 0) {
      const long long ml = ((long long)b * H + h) * Sq + s;
      m_out[ml] = m_i[i];
      l_out[ml] = l_i[i];
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int B, int Sq, int Sk, int H, int KV, Strides qs,
             Strides ks, Strides vs, float scale, int causal, int window,
             cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(m),
      static_cast<float*>(l), Sq, Sk, H, H / KV, qs, ks, vs, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int B, int Sq, int Sk, int H, int KV, int D,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, float scale, int causal, int window,
           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_d<T, 64>(q, k, v, o, m, l, B, Sq, Sk, H, KV, qs, ks, vs,
                           scale, causal, window, s);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, m, l, B, Sq, Sk, H, KV, qs, ks, vs,
                            scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes.  q (B, Sq, H, D), k and v (B, Sk, KV, D)
// are device pointers read with the given element strides of their batch,
// sequence and head dimensions; the last dimension is contiguous.  o is a
// contiguous (B, Sq, H, D) tensor of q's type; m and l are contiguous fp32
// (B, H, Sq).  D is 64 or 128 and H a multiple of KV.  window <= 0 means no
// window.  Returns the launch's cudaGetLastError() (or the error of setting
// the kernel's shared-memory size).
#define FLASH_C_API(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      void* m, void* l, int B, int Sq, int Sk, int H, int KV, \
                      int D, long long q_sb, long long q_ss, long long q_sh,  \
                      long long k_sb, long long k_ss, long long k_sh,         \
                      long long v_sb, long long v_ss, long long v_sh,         \
                      float scale, int causal, int window, void* stream) {    \
    return launch<T>(q, k, v, o, m, l, B, Sq, Sk, H, KV, D, q_sb, q_ss, q_sh, \
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,       \
                     window, stream);                                         \
  }

FLASH_C_API(flash_attention_fwd_bf16, __nv_bfloat16)
FLASH_C_API(flash_attention_fwd_f32, float)
