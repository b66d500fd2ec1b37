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
//   the d with bucket[y, d] = z, ascending, each stored as a signed index:
//   d where sign[y, d] = +1, ~d where it is -1), so every output sums its own
//   list in a fixed order, with no atomics:
//     mode 0, compress:        out[t,y,z] = sum_d sign[y,d] x[t,d]
//     mode 1, median backward: out[t,y,z] = sum_d sign[y,d] m[t,y,d] x[t,d]
//       where x is the gradient of the decoded (T, D) estimate and m[t,y,d]
//       the weight the median network gives row y of column d.  m is
//       recomputed here from the sketch u (T, Y, Z) by replaying the network,
//       not saved from the forward.
//   gather, a run of 16 bytes of outputs (t, d..d+V) per thread and row,
//   read through the plan's packed index gidx[y, d] (bucket[y, d] where
//   sign[y, d] = +1, ~bucket[y, d] where it is -1):
//     mode 0, decompress: est[y] = sign[y,d] u[t,y,bucket[y,d]], then the
//       median over y by the compare-exchange network of _median_rows (an even
//       Y averages the middle two);
//     mode 1, compress backward: sum_y sign[y,d] u[t,y,bucket[y,d]], y
//       ascending.
//
// The median network's gradient follows JAX's rule for min and max: at a tie
// each input takes half.  The backward replays the network forward, keeping
// the outcome of each compare, then carries the output's weight back through
// the compares in reverse, for all Y inputs at once.
//
// What bounds them on an H100: at the training shapes (T = 512, D = 2048,
// Y = 3, Z = 325) each moves T D + T Y Z elements (3 MB in bf16) for about
// 2 T Y D flops: the bytes bound them (about 1 us).  Sums are fp32, rounded
// once to the input type.  The median backward also runs T D median
// networks with their backward, some 70 instructions each: at these shapes
// that costs the card more time than its bytes.
//
// The scatter (the tile route, chosen by scatter_plan()): a block of 512
// threads owns R rows (the most of 8, 4, 2 and 1 for compress, of 4, 2 and
// 1 for the median backward, that leave 128 blocks).  Its rows
// of x, in mode 1 of u, and the plan's ptr, order and sidx are contiguous in
// memory: each comes in by one 1-D bulk asynchronous copy (cp.async.bulk,
// reported to an mbarrier) of its 16-byte aligned middle, the few bytes at
// either end by the threads, kept in shared memory in their own type.  Each
// index entry is read once and serves all R rows.  Mode 1 runs in two
// stages: a coalesced sweep over the columns runs each (t, d) median network
// once, for all y, and leaves sign[y,d] m[t,y,d] x[t,d] in shared memory
// (fp32, R x Y x D); then each (y, z) sums its list from there.  The threads
// take the lists longest first (the plan's order), so the lists of a warp
// are about equally long, and the sums leave through shared memory in
// coalesced stores.  Where no tile fits in shared memory, the first,
// simpler kernel takes the call (the rows route: 4 rows a block, copied as
// fp32, the median network replayed for every list entry).
//
// The gather: a block owns a tile of R rows by a slice of Dc columns
// (gather_plan(): D in slices of at most 512 columns, then the most of 8,
// 4, 2 and 1 rows that leave 256 blocks: 8 x 512 at olmo-1b's shape, 8 x
// 384 at the federation's, the best of chip_smoke.py's sweep at both).
// Its R rows of u (contiguous) come in by bulk copies in their own type,
// one a row, each reported to that row's mbarrier, so a row is read as
// soon as its bytes are in.  A
// thread takes a run of V = 16 / sizeof(T) columns (8 bf16, 4 f32): it
// reads its run's Y x V entries of the packed index gidx once, by 16-byte
// loads issued before anything else, for all its rows; then for each of
// its rows it gathers Y x V values from shared memory and writes its V
// outputs by one 16-byte store (element stores only at a ragged end of D
// or where a row does not start 16-byte aligned).  Strides are products,
// never divisions.  Bulk-copying the index into shared memory as well (so
// a block reads each entry once) was slower: every row then waited for the
// index too.  It is bound by the latency of its copies and of the gathers
// from shared memory (random buckets meet bank conflicts), not by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the scatter's rows route
constexpr int kTileThreads = 512;  // the scatter's tile route
constexpr int kRows = 4;     // rows of x / u per block (rows route)
constexpr int kMaxY = 8;
// rows a block of the tile route at most (compress, the median backward),
// and the blocks they leave at least
constexpr int kMaxScatterRows[2] = {8, 4};
constexpr int kScatterTargetBlocks = 128;
constexpr int kMaxSmem = 232448;          // dynamic shared memory of a block
// the gather: rows a block at most (the rule's; and any forced: one thread
// of warp 0 copies each row), the blocks the rule aims at, the columns of
// its slices at most, and threads a block (about; at most)
constexpr int kGatherRuleRows = 8;
constexpr int kGatherMaxRows = 32;
constexpr int kGatherTargetBlocks = 256;
constexpr int kGatherMaxCols = 512;
constexpr int kGatherThreads = 256;

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

// The weights the Y inputs take in the median, given the outcomes of the
// forward compares: the output's unit gradient carried back through the
// network, a tie splitting it in halves.
template <int kY>
__device__ __forceinline__ void median_weights(const int (&rel)[kY * kY],
                                               float (&g)[kY]) {
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
      if (c == 1) {          // a was the max: lo <- b, hi <- a
        g[j] = ghi;
        g[j + 1] = glo;
      } else if (c == 2) {   // tie: each input takes half of each output
        const float half = 0.5f * (glo + ghi);
        g[j] = half;
        g[j + 1] = half;
      }
    }
}

// ---------------------------------------------------------------------------
// scatter: out (n_rows, Y, Z) from x (n_rows, D) [and u (n_rows, Y, Z)]
// ---------------------------------------------------------------------------

// The rows route.  kY > 0 is the median backward (mode 1) for Y = kY; kY ==
// 0 is compress.
template <typename T, int kY>
__global__ void __launch_bounds__(kThreads)
sketch_scatter_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const int* __restrict__ ptr, const int* __restrict__ sidx,
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
      const int e = sidx[k];
      const int d = e < 0 ? ~e : e;
      const float s = e < 0 ? -1.f : 1.f;
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
          float m[kY];
          median_network<kY, true>(v, rel);
          median_weights<kY>(rel, m);
          float my = 0.f;   // m[y], selected without a local-memory index
#pragma unroll
          for (int yy = 0; yy < kY; ++yy)
            if (yy == y) my = m[yy];
          acc[t] += s * (my * xs[t * D + d]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      if (t < n_t) out[(size_t)(row0 + t) * YZ + yz] = from_f<T>(acc[t]);
  }
}

// The tile route.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// A contiguous run of `bytes` at `src`, to be kept in shared memory from
// `dst` + src % 16 on (so that its 16-byte aligned middle lands aligned):
// `head` bytes before the middle, `body` bytes of middle (a multiple of 16,
// for one bulk copy) and the rest after it.
struct Run {
  const unsigned char* src;
  unsigned char* dst;
  int head, body, bytes;
};

__device__ __forceinline__ Run make_run(const void* src, int bytes,
                                        unsigned char* region) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  Run run;
  run.src = static_cast<const unsigned char*>(src);
  run.dst = region + a % 16;
  run.head = (int)((16 - a % 16) % 16);
  run.head = run.head < bytes ? run.head : bytes;
  run.body = (bytes - run.head) & ~15;
  run.bytes = bytes;
  return run;
}

// one thread: `bytes` (a multiple of 16, both ends 16-byte aligned) by one
// bulk copy, reported to `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// thread 0: the run's middle by one bulk copy, reported to `bar`
__device__ __forceinline__ void copy_body(const Run& run, uint64_t* bar) {
  bulk_copy(run.dst + run.head, run.src + run.head, run.body, bar);
}

// threads tid of n: the run's ends, element by element
template <typename T>
__device__ __forceinline__ void copy_ends(const Run& run, int tid, int n) {
  constexpr int el = (int)sizeof(T);
  const int n_head = run.head / el;
  const int n_tail = (run.bytes - run.head - run.body) / el;
  const T* s = reinterpret_cast<const T*>(run.src);
  T* d = reinterpret_cast<T*>(run.dst);
  const int tail0 = (run.head + run.body) / el;
  for (int i = tid; i < n_head + n_tail; i += n) {
    const int e = i < n_head ? i : tail0 + i - n_head;
    d[e] = s[e];
  }
}

// Byte offsets in a tile block's shared memory: the mbarrier, the plan's
// ptr (Y Z + 1), order (Y Z) and sidx (Y D), R rows of x, in mode 1 R rows
// of u and the (R, Y, D) fp32 values of the first stage, then the R rows of
// the output.  Each run copied in has 16 bytes of room for its shift
// (src % 16).
struct ScatterLayout {
  int ptr, order, sidx, xs, us, vs, ob, total;
};

__host__ __device__ inline int round16(int a) { return (a + 15) / 16 * 16; }

__host__ __device__ inline ScatterLayout scatter_layout(int R, int D, int Y,
                                                        int Z, int mode,
                                                        int el) {
  ScatterLayout L;
  L.ptr = 16;
  L.order = L.ptr + round16((Y * Z + 1) * 4) + 16;
  L.sidx = L.order + round16(Y * Z * 4) + 16;
  L.xs = L.sidx + round16(Y * D * 4) + 16;
  L.us = L.xs + round16(R * D * el) + 16;
  L.vs = L.us + (mode ? round16(R * Y * Z * el) + 16 : 0);
  L.ob = L.vs + (mode ? R * Y * D * 4 : 0);
  L.total = L.ob + round16(R * Y * Z * el);
  return L;
}

// kY > 0: the median backward (mode 1) for Y = kY; kY == 0: compress.
template <typename T, int kY, int kR>
__global__ void __launch_bounds__(kTileThreads)
sketch_scatter_tile_kernel(const T* __restrict__ x, const T* __restrict__ u,
                           const int* __restrict__ ptr,
                           const int* __restrict__ order,
                           const int* __restrict__ sidx,
                           const float* __restrict__ sign,
                           const int* __restrict__ bucket, T* __restrict__ out,
                           int n_rows, int D, int Y, int Z) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  constexpr int kMode = kY > 0 ? 1 : 0;
  const ScatterLayout L = scatter_layout(kR, D, Y, Z, kMode, (int)sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int YZ = Y * Z;
  const int row0 = blockIdx.x * kR;
  const int n_t = min(kR, n_rows - row0);

  const Run rp = make_run(ptr, (YZ + 1) * 4, smem + L.ptr);
  const Run ro = make_run(order, YZ * 4, smem + L.order);
  const Run rs = make_run(sidx, Y * D * 4, smem + L.sidx);
  const Run rx = make_run(x + (size_t)row0 * D, n_t * D * (int)sizeof(T),
                          smem + L.xs);
  Run ru = rx;
  if (kMode)
    ru = make_run(u + (size_t)row0 * YZ, n_t * YZ * (int)sizeof(T),
                  smem + L.us);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        smem_u32(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(rp.body + ro.body + rs.body + rx.body + (kMode ? ru.body : 0))
        : "memory");
    copy_body(rp, bar);
    copy_body(ro, bar);
    copy_body(rs, bar);
    copy_body(rx, bar);
    if (kMode) copy_body(ru, bar);
  }
  copy_ends<int>(rp, threadIdx.x, blockDim.x);
  copy_ends<int>(ro, threadIdx.x, blockDim.x);
  copy_ends<int>(rs, threadIdx.x, blockDim.x);
  copy_ends<T>(rx, threadIdx.x, blockDim.x);
  if (kMode) copy_ends<T>(ru, threadIdx.x, blockDim.x);
  const int* ps = reinterpret_cast<const int*>(rp.dst);
  const int* os = reinterpret_cast<const int*>(ro.dst);
  const int* ss = reinterpret_cast<const int*>(rs.dst);
  const T* xs = reinterpret_cast<const T*>(rx.dst);
  const T* us = reinterpret_cast<const T*>(ru.dst);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  __syncthreads();   // the mbarrier is initialised and the ends are in

  if constexpr (kMode) {
    // stage 1: each (t, d) network once; vs[t][y][d] = sign m x.  A thread
    // reads the bucket and sign of kB columns at once, while the copies fly.
    constexpr int kB = 4;
    for (int d0 = threadIdx.x; d0 < D; d0 += kB * kTileThreads) {
      int bk[kB][kY];
      float sg[kB][kY];
#pragma unroll
      for (int c = 0; c < kB; ++c) {
        const int d = d0 + c * kTileThreads;
#pragma unroll
        for (int y = 0; y < kY; ++y) {
          bk[c][y] = d < D ? bucket[(size_t)y * D + d] : 0;
          sg[c][y] = d < D ? sign[(size_t)y * D + d] : 0.f;
        }
      }
      if (d0 == (int)threadIdx.x) mbar_wait(bar, 0);
#pragma unroll
      for (int c = 0; c < kB; ++c) {
        const int d = d0 + c * kTileThreads;
        if (d >= D) break;
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          if (t < n_t) {
            float v[kY], m[kY];
            int rel[kY * kY];
#pragma unroll
            for (int y = 0; y < kY; ++y)
              v[y] = sg[c][y] * to_f(us[t * YZ + y * Z + bk[c][y]]);
            median_network<kY, true>(v, rel);
            median_weights<kY>(rel, m);
            const float g = to_f(xs[t * D + d]);
#pragma unroll
            for (int y = 0; y < kY; ++y)
              vs[(t * kY + y) * D + d] = sg[c][y] * (m[y] * g);
          }
        }
      }
    }
    if ((int)threadIdx.x >= D) mbar_wait(bar, 0);
    __syncthreads();
  } else {
    mbar_wait(bar, 0);
  }

  // stage 2: each (y, z) sums its list, ascending d, kE entries at a time
  // (their loads in flight together).  Threads take the lists in the plan's
  // order, longest first, so the lists of a warp are about equally long; the
  // sums go to shared memory and then to `out` in coalesced stores.
  constexpr int kE = 4;
  T* ob = reinterpret_cast<T*>(smem + L.ob);     // (R, Y Z)
  for (int i = threadIdx.x; i < YZ; i += kTileThreads) {
    const int yz = os[i];
    float acc[kR];
#pragma unroll
    for (int t = 0; t < kR; ++t) acc[t] = 0.f;
    const int end = ps[yz + 1];
    const float* vy = vs + (yz / Z) * D;
    for (int k0 = ps[yz]; k0 < end; k0 += kE) {
      int e[kE];
#pragma unroll
      for (int c = 0; c < kE; ++c) e[c] = k0 + c < end ? ss[k0 + c] : 0;
#pragma unroll
      for (int c = 0; c < kE; ++c) {
        if (k0 + c < end) {
          const int d = e[c] < 0 ? ~e[c] : e[c];
#pragma unroll
          for (int t = 0; t < kR; ++t) {
            if constexpr (kMode) {
              acc[t] += vy[t * kY * D + d];
            } else {
              const float xv = to_f(xs[t * D + d]);
              acc[t] += e[c] < 0 ? -xv : xv;
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kR; ++t) ob[t * YZ + yz] = from_f<T>(acc[t]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_t * YZ; i += kTileThreads)
    out[(size_t)row0 * YZ + i] = ob[i];
}

// ---------------------------------------------------------------------------
// gather: out (n_rows, D) from u (n_rows, Y, Z)
// ---------------------------------------------------------------------------

// Bytes of a gather block's shared memory: one mbarrier a row, then the R
// rows of u in their own type (16 bytes of room for the shift).
__host__ __device__ inline int gather_smem(int R, int Y, int Z, int el) {
  return round16(R * 8) + round16(R * Y * Z * el) + 16;
}

// Row groups of a gather block: blockDim.y, so that a block of Dc / V
// column runs has about kGatherThreads threads, each taking every
// blockDim.y-th row of the tile.
__host__ __device__ inline int gather_row_groups(int R, int runs) {
  const int p = runs < kGatherThreads ? kGatherThreads / runs : 1;
  return p < R ? p : R;
}

// Block (blockIdx.x, blockIdx.y) owns rows [R bx, R bx + R) and columns
// [Dc by, Dc by + Dc); thread (x, y) the run of kV columns from Dc by + kV x
// and rows y, y + blockDim.y, ....  kMedian: the median decode (mode 0),
// else the sum over y (mode 1).
template <typename T, int kY, bool kMedian>
__global__ void __launch_bounds__(kGatherThreads)
sketch_gather_kernel(const T* __restrict__ u, const int* __restrict__ gidx,
                     T* __restrict__ out, int n_rows, int D, int Z, int R,
                     int Dc) {
  constexpr int kV = 16 / (int)sizeof(T);   // columns a thread: 16 bytes
  extern __shared__ __align__(128) unsigned char gather_smem_[];
  unsigned char* smem = gather_smem_;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int YZ = kY * Z;
  const int row0 = blockIdx.x * R;
  const int n_t = min(R, n_rows - row0);
  const int c0 = blockIdx.y * Dc + kV * threadIdx.x;   // the thread's run
  const bool busy = c0 < D && (int)threadIdx.y < n_t;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int row_bytes = YZ * (int)sizeof(T);

  // The run's Y x kV index entries, once for all its rows, straight from
  // global memory (16-byte loads where the run is whole and aligned),
  // issued first so that they fly while the rows of u are copied.
  int gi[kY][kV];
  if (busy) {
#pragma unroll
    for (int y = 0; y < kY; ++y) {
      const int* src = gidx + (size_t)y * D + c0;
      if (c0 + kV <= D && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < kV / 4; ++q) {
          const int4 w = __ldg(reinterpret_cast<const int4*>(src) + q);
          gi[y][4 * q] = w.x;
          gi[y][4 * q + 1] = w.y;
          gi[y][4 * q + 2] = w.z;
          gi[y][4 * q + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j)
          gi[y][j] = c0 + j < D ? __ldg(src + j) : 0;
      }
    }
  }

  const Run ru = make_run(u + (size_t)row0 * YZ, n_t * row_bytes,
                          smem + round16(R * 8));
  if (tid < 32) {
    if (tid == 0) {
      for (int k = 0; k < n_t; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
            smem_u32(bar + k)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp(n_threads < 32 ? (1u << n_threads) - 1 : 0xffffffffu);
    // thread k of warp 0: the 16-byte aligned bytes from row k's start to
    // row k + 1's, by one bulk copy to barrier k, so that a row can be read
    // as soon as its own bytes are in
    const int k = tid;
    if (k < n_t) {
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(ru.src);
      const uintptr_t lo = a0 + ru.head, hi = lo + ru.body;
      const auto up = [&](uintptr_t a) {
        a = (a + 15) & ~(uintptr_t)15;
        return a < lo ? lo : (a > hi ? hi : a);
      };
      const uintptr_t p0 = up(a0 + (size_t)k * row_bytes);
      const uintptr_t p1 = up(a0 + (size_t)(k + 1) * row_bytes);
      const int bytes = (int)(p1 - p0);
      if (bytes > 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(bar + k)),
            "r"(bytes)
            : "memory");
      else
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_u32(bar + k))
                     : "memory");
      bulk_copy(ru.dst + (p0 - a0), reinterpret_cast<const void*>(p0), bytes,
                bar + k);
    }
  }
  copy_ends<T>(ru, tid, n_threads);
  __syncthreads();   // the mbarriers are set up and the ends are in
  if (!busy) return;

  // each entry decoded once: the byte offset of u[t, y, bucket] in row t,
  // and the sign as the float's sign bit (columns past D read bucket 0 and
  // are not stored)
  unsigned sg[kY][kV];
#pragma unroll
  for (int y = 0; y < kY; ++y)
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int e = gi[y][j];
      sg[y][j] = (unsigned)e & 0x80000000u;
      gi[y][j] = (y * Z + (e ^ (e >> 31))) * (int)sizeof(T);
    }

  const unsigned char* us = ru.dst;
  int waited = 0;
  for (int t = threadIdx.y; t < n_t; t += blockDim.y) {
    while (waited <= t) {
      mbar_wait(bar + waited, 0);
      ++waited;
    }
    const unsigned char* ur = us + t * row_bytes;
    float r[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      float v[kY];
#pragma unroll
      for (int y = 0; y < kY; ++y) {
        const float x = to_f(*reinterpret_cast<const T*>(ur + gi[y][j]));
        v[y] = __uint_as_float(__float_as_uint(x) ^ sg[y][j]);
      }
      if constexpr (kMedian) {
        int rel[kY * kY];
        r[j] = median_network<kY, false>(v, rel);
      } else {
        r[j] = v[0];
#pragma unroll
        for (int y = 1; y < kY; ++y) r[j] += v[y];
      }
    }
    T* op = out + (size_t)(row0 + t) * D + c0;
    if (c0 + kV <= D && (reinterpret_cast<uintptr_t>(op) & 15) == 0) {
      uint4 w;
      if constexpr (sizeof(T) == 2) {
        unsigned h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 b2 =
              __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
          h[i] = *reinterpret_cast<const unsigned*>(&b2);
        }
        w = make_uint4(h[0], h[1], h[2], h[3]);
      } else {
        w = make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                       __float_as_uint(r[2]), __float_as_uint(r[3]));
      }
      *reinterpret_cast<uint4*>(op) = w;
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j)
        if (c0 + j < D) op[j] = from_f<T>(r[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Allow `smem` bytes of dynamic shared memory for the kernel (above 48 KB
// it must be asked for, once per kernel), then launch `blocks` blocks.
template <auto kKernel, typename... Args>
int launch_blocks(int smem, dim3 blocks, dim3 threads, cudaStream_t s,
                  Args... args) {
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kKernel<<<blocks, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// the same over blocks of kRows rows
template <auto kKernel, typename... Args>
int launch_rows(int smem, int n_rows, cudaStream_t s, Args... args) {
  return launch_blocks<kKernel>(smem, (n_rows + kRows - 1) / kRows,
                                kThreads, s, args...);
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

// The scatter's route: rows a block of the tile route (the most of
// kMaxScatterRows[mode], ..., 2 and 1 that leave kScatterTargetBlocks
// blocks, halved until its shared memory fits), 0 for the rows route (the
// first kernel) where no tile fits, -1 where neither fits.
// rows_force > 0 forces the tile route's rows, -1 the rows route.
int scatter_plan(int n_rows, int D, int Y, int Z, int mode, int el,
                 int rows_force) {
  const int rows_smem = kRows * (D + (mode ? Y * Z : 0)) * 4;
  if (rows_force < 0) return rows_smem <= kMaxSmem ? 0 : -1;
  int R = rows_force;
  if (R == 0) {
    R = 1;
    for (int cand = kMaxScatterRows[mode]; cand > 1; cand /= 2)
      if ((n_rows + cand - 1) / cand >= kScatterTargetBlocks) {
        R = cand;
        break;
      }
    while (R > 1 && scatter_layout(R, D, Y, Z, mode, el).total > kMaxSmem)
      R /= 2;
  } else if (R != 1 && R != 2 && R != 4 && R != 8) {
    return -1;
  }
  if (scatter_layout(R, D, Y, Z, mode, el).total <= kMaxSmem) return R;
  if (rows_force > 0) return -1;
  return rows_smem <= kMaxSmem ? 0 : -1;
}

template <typename T, int kY, int kR>
int scatter_tile(const T* x, const T* u, const int* ptr, const int* order,
                 const int* sidx, const float* sign, const int* bucket, T* out,
                 int n_rows, int D, int Y, int Z, cudaStream_t s) {
  const int smem =
      scatter_layout(kR, D, Y, Z, kY > 0, (int)sizeof(T)).total;
  return launch_blocks<sketch_scatter_tile_kernel<T, kY, kR>>(
      smem, (n_rows + kR - 1) / kR, kTileThreads, s, x, u, ptr, order, sidx,
      sign, bucket, out, n_rows, D, Y, Z);
}

template <typename T, int kY>
int scatter_y(const T* x, const T* u, const int* ptr, const int* order,
              const int* sidx, const float* sign, const int* bucket, T* out,
              int n_rows, int D, int Y, int Z, int rows, cudaStream_t s) {
  switch (rows) {
    case 0: {   // the rows route
      const int smem = kRows * (D + (kY > 0 ? Y * Z : 0)) * (int)sizeof(float);
      return launch_rows<sketch_scatter_kernel<T, kY>>(
          smem, n_rows, s, x, u, ptr, sidx, sign, bucket, out, n_rows, D, Y,
          Z);
    }
    case 1: return scatter_tile<T, kY, 1>(x, u, ptr, order, sidx, sign,
                                          bucket, out, n_rows, D, Y, Z, s);
    case 2: return scatter_tile<T, kY, 2>(x, u, ptr, order, sidx, sign,
                                          bucket, out, n_rows, D, Y, Z, s);
    case 4: return scatter_tile<T, kY, 4>(x, u, ptr, order, sidx, sign,
                                          bucket, out, n_rows, D, Y, Z, s);
    default: return scatter_tile<T, kY, 8>(x, u, ptr, order, sidx, sign,
                                           bucket, out, n_rows, D, Y, Z, s);
  }
}

template <typename T>
int scatter(const void* x, const void* u, const void* ptr, const void* order,
            const void* sidx, const void* sign, const void* bucket, void* out,
            int n_rows, int D, int Y, int Z, int mode, int rows_force,
            void* stream) {
  if (n_rows <= 0) return 0;
  if (D <= 0 || Z <= 0 || Y < 1 || Y > kMaxY || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const int rows =
      scatter_plan(n_rows, D, Y, Z, mode, (int)sizeof(T), rows_force);
  if (rows < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* up = static_cast<const T*>(u);
  const int* pp = static_cast<const int*>(ptr);
  const int* orp = static_cast<const int*>(order);
  const int* ip = static_cast<const int*>(sidx);
  const float* sp = static_cast<const float*>(sign);
  const int* bp = static_cast<const int*>(bucket);
  T* op = static_cast<T*>(out);
  if (mode == 0)
    return scatter_y<T, 0>(xp, up, pp, orp, ip, sp, bp, op, n_rows, D, Y, Z,
                           rows, s);
  SKETCH_FOR_EACH_Y(scatter_y, xp, up, pp, orp, ip, sp, bp, op, n_rows, D, Y,
                    Z, rows, s)
}

// The gather's tile: returns R, the rows a block, and sets *cols to Dc, the
// columns of a slice (a multiple of the kV-column run), or returns -1 where
// none fits.  The rule: D in the fewest slices of at most kGatherMaxCols
// columns, split evenly; the most of kGatherRuleRows, ..., 2 and 1 rows a
// block that leave kGatherTargetBlocks blocks, halved until the rows fit in
// shared memory.  rows_force > 0 and cols_force > 0 force the tile (1 <= R
// <= kGatherMaxRows; a multiple of the run with at most kGatherThreads
// runs), -1 where it does not fit.
int gather_plan(int n_rows, int D, int Y, int Z, int el, int rows_force,
                int cols_force, int* cols) {
  const int V = 16 / el;
  if (rows_force > 0 || cols_force > 0) {
    if (rows_force < 1 || rows_force > kGatherMaxRows || cols_force < V ||
        cols_force % V || cols_force / V > kGatherThreads ||
        gather_smem(rows_force, Y, Z, el) > kMaxSmem)
      return -1;
    *cols = cols_force;
    return rows_force;
  }
  const int slices = (D + kGatherMaxCols - 1) / kGatherMaxCols;
  int R = 1;
  for (int cand = kGatherRuleRows; cand > 1; cand /= 2)
    if ((long long)((n_rows + cand - 1) / cand) * slices >=
        kGatherTargetBlocks) {
      R = cand;
      break;
    }
  while (R > 1 && gather_smem(R, Y, Z, el) > kMaxSmem) R /= 2;
  if (gather_smem(R, Y, Z, el) > kMaxSmem) return -1;
  *cols = ((D + slices - 1) / slices + V - 1) / V * V;
  return R;
}

template <typename T, int kY>
int gather_y(const T* u, const int* gidx, T* out, int n_rows, int D, int Z,
             int mode, int R, int Dc, cudaStream_t s) {
  constexpr int el = (int)sizeof(T);
  const int smem = gather_smem(R, kY, Z, el);
  const int runs = Dc / (16 / el);
  const dim3 grid((n_rows + R - 1) / R, (D + Dc - 1) / Dc);
  const dim3 block(runs, gather_row_groups(R, runs));
  if (mode == 0)
    return launch_blocks<sketch_gather_kernel<T, kY, true>>(
        smem, grid, block, s, u, gidx, out, n_rows, D, Z, R, Dc);
  return launch_blocks<sketch_gather_kernel<T, kY, false>>(
      smem, grid, block, s, u, gidx, out, n_rows, D, Z, R, Dc);
}

template <typename T>
int gather(const void* u, const void* gidx, void* out, int n_rows, int D,
           int Y, int Z, int mode, int rows_force, int cols_force,
           void* stream) {
  if (n_rows <= 0) return 0;
  if (D <= 0 || Z <= 0 || Y < 1 || Y > kMaxY || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  int Dc = 0;
  const int R = gather_plan(n_rows, D, Y, Z, (int)sizeof(T), rows_force,
                            cols_force, &Dc);
  if (R < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  SKETCH_FOR_EACH_Y(gather_y, static_cast<const T*>(u),
                    static_cast<const int*>(gidx), static_cast<T*>(out),
                    n_rows, D, Z, mode, R, Dc, s)
}

}  // namespace

// C interface, loaded with ctypes.  Device pointers, row-major and
// contiguous.  x (n_rows, D) and out/u (n_rows, Y, Z) of one type; ptr
// (Y Z + 1) and sidx (Y D) int32, the plan's inverse index with each entry
// signed (d, or ~d where sign[y, d] = -1); order (Y Z) int32, the lists
// longest first; sign (Y, D) float32; bucket (Y, D) int32; 1 <= Y <= 8.  mode 0 is compress, mode 1 the median's backward
// (which reads u, bucket and sign).  The route and its shared memory are
// scatter_plan's.  Returns the launch's cudaGetLastError().
extern "C" int sketch_scatter_bf16(const void* x, const void* u,
                                   const void* ptr, const void* order,
                                   const void* sidx, const void* sign,
                                   const void* bucket, void* out, int n_rows,
                                   int D, int Y, int Z, int mode,
                                   void* stream) {
  return scatter<__nv_bfloat16>(x, u, ptr, order, sidx, sign, bucket, out,
                                n_rows, D, Y, Z, mode, 0, stream);
}

extern "C" int sketch_scatter_f32(const void* x, const void* u,
                                  const void* ptr, const void* order,
                                  const void* sidx, const void* sign,
                                  const void* bucket, void* out, int n_rows,
                                  int D, int Y, int Z, int mode,
                                  void* stream) {
  return scatter<float>(x, u, ptr, order, sidx, sign, bucket, out, n_rows, D,
                        Y, Z, mode, 0, stream);
}

// The same with the route forced, for timing and testing the routes (the
// port itself calls the functions above): rows > 0 is the tile route with
// that many rows a block (1, 2, 4 or 8; an error if it does not fit), -1
// the rows route, 0 the rule.
extern "C" int sketch_scatter_route_bf16(const void* x, const void* u,
                                         const void* ptr, const void* order,
                                         const void* sidx, const void* sign,
                                         const void* bucket, void* out,
                                         int n_rows, int D, int Y, int Z,
                                         int mode, int rows, void* stream) {
  return scatter<__nv_bfloat16>(x, u, ptr, order, sidx, sign, bucket, out,
                                n_rows, D, Y, Z, mode, rows, stream);
}

extern "C" int sketch_scatter_route_f32(const void* x, const void* u,
                                        const void* ptr, const void* order,
                                        const void* sidx, const void* sign,
                                        const void* bucket, void* out,
                                        int n_rows, int D, int Y, int Z,
                                        int mode, int rows, void* stream) {
  return scatter<float>(x, u, ptr, order, sidx, sign, bucket, out, n_rows, D,
                        Y, Z, mode, rows, stream);
}

// The scatter's route for these shapes: out[0] is the tile route's rows a
// block, 0 for the rows route, -1 where no route fits; out[1] the blocks and
// out[2] the dynamic shared memory in bytes.  Lets the caller check its
// mirror of the rule (kernels/count_sketch/ops.py) and print the grid.
extern "C" int sketch_scatter_plan(int n_rows, int D, int Y, int Z, int mode,
                                   int elem_bytes, int* out) {
  const int rows = scatter_plan(n_rows, D, Y, Z, mode, elem_bytes, 0);
  out[0] = rows;
  out[1] = rows > 0 ? (n_rows + rows - 1) / rows
                    : (rows == 0 ? (n_rows + kRows - 1) / kRows : 0);
  out[2] = rows > 0 ? scatter_layout(rows, D, Y, Z, mode, elem_bytes).total
                    : (rows == 0 ? kRows * (D + (mode ? Y * Z : 0)) * 4 : 0);
  return 0;
}

// u (n_rows, Y, Z) -> out (n_rows, D) of the same type; gidx (Y, D) int32,
// the plan's packed index: bucket[y, d] where sign[y, d] = +1, ~bucket[y, d]
// where it is -1.  mode 0 is the median decode, mode 1 the sum over y
// (compress's backward).  rows = cols = 0 takes gather_plan's tile (what the
// port calls); rows R and cols Dc both > 0 force the tile, for timing and
// testing (an error if it does not fit or Dc is not a multiple of the
// 16-byte run).
extern "C" int sketch_gather_bf16(const void* u, const void* gidx, void* out,
                                  int n_rows, int D, int Y, int Z, int mode,
                                  int rows, int cols, void* stream) {
  return gather<__nv_bfloat16>(u, gidx, out, n_rows, D, Y, Z, mode, rows,
                               cols, stream);
}

extern "C" int sketch_gather_f32(const void* u, const void* gidx, void* out,
                                 int n_rows, int D, int Y, int Z, int mode,
                                 int rows, int cols, void* stream) {
  return gather<float>(u, gidx, out, n_rows, D, Y, Z, mode, rows, cols,
                       stream);
}

// The gather's tile for these shapes (rows = cols = 0: the rule's; both > 0:
// that tile forced): out[0] the rows a block (-1 where it does not fit),
// out[1] the columns of a slice, out[2] the blocks, out[3] the dynamic
// shared memory in bytes and out[4] the threads a block.  Lets the caller
// check its mirror of the rule (kernels/count_sketch/ops.py) and print the
// grid.
extern "C" int sketch_gather_plan(int n_rows, int D, int Y, int Z,
                                  int elem_bytes, int rows, int cols,
                                  int* out) {
  int Dc = 0;
  const int R = gather_plan(n_rows, D, Y, Z, elem_bytes, rows, cols, &Dc);
  const int runs = R > 0 ? Dc / (16 / elem_bytes) : 0;
  out[0] = R;
  out[1] = R > 0 ? Dc : 0;
  out[2] = R > 0 ? (n_rows + R - 1) / R * ((D + Dc - 1) / Dc) : 0;
  out[3] = R > 0 ? gather_smem(R, Y, Z, elem_bytes) : 0;
  out[4] = R > 0 ? runs * gather_row_groups(R, runs) : 0;
  return 0;
}
