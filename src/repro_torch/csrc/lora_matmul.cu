// Fused LoRA projection for Hopper (sm_90a):
//
//     y[t, o] = sum_k x[t, k] W[k, o]  +  s * sum_j (sum_k x[t, k] A[k, j]) B[j, o]
//
// accumulated in fp32 and rounded once to the input type, the semantics of
// the plain version in repro_torch/kernels/lora/ref.py.
//
// Replaces the TPU kernel repro/kernels/lora/kernel.py::_lora_kernel
// (lora_matmul_td).  That kernel walks a sequential (t, o, k) grid and carries
// two VMEM accumulators across the k steps.  Here blocks run in parallel in no
// order, so the K loop lives inside the block instead of in the grid.
//
// What bounds it on an H100: on the serving path x is the decode batch
// (T = 8 rows) and W is a frozen projection of llama3-8b (4096 x 4096 for
// q and o, 4096 x 1024 for k and v), in bf16.  That is a weight-streaming
// GEMV: 2*T*K*O flops against 2*K*O bytes of W, about 8 flops a byte, far
// below the ~295 flops a byte where the tensor cores would be the limit.
// So the bound is the bytes of W at 3.35 TB/s (about 10 us for q or o).
// But 8 flops a byte is more than the CUDA cores sustain once the loads and
// conversions around each FMA are counted, so bf16 multiplies on the tensor
// cores (mma.sync m16n8k16, fp32 accumulation), and the design aims at
// reading W once, in 16-byte copies, with several chunks in flight.
//
// Design (right and simple first; wgmma/TMA come later):
//   * A tile is BO output columns for 8 rows of x: BO = 64 in bf16 (mma
//     path), 32 in f32 (FMA path).  Its K rows are split over a thread block
//     cluster of up to 8 blocks (grid z), chosen by the host so that about
//     one block per SM is in flight: at batch 8, q and o (64 tiles) take 3
//     splits, k and v (16 tiles) take 8.  On the card, fewer and longer
//     blocks beat more and shorter ones (tried up to 4 blocks per SM).
//   * Each block walks its K range in chunks (128 rows in bf16, a 16 KB W
//     tile; 128 rows in f32).  A chunk's tiles -- W[chunk, BO columns],
//     x[8 rows, chunk] and A[chunk, r] -- are copied global -> shared with
//     16-byte cp.async into a ring of kStages buffers, so kStages - 1 chunks
//     are in flight while one is computed, zero-filled past the edges of K,
//     O and T.  Where K or O is not a multiple of 16 bytes' worth of
//     elements, or a pointer not 16-byte aligned, the same tiles are filled
//     by element loads instead.
//   * bf16 (mma path): the tile is computed transposed, y^T = W^T x^T, so the
//     8 rows of x are the mma's n = 8 and nothing is padded.  Each warp owns
//     one 16-column strip and half of the chunk's k16 steps; W^T fragments
//     come from shared memory by ldmatrix.trans (the W tile's 16-byte pieces
//     are XOR-swizzled so that 8 rows of a matrix hit 8 different bank
//     groups), x^T fragments are 32-bit loads from x rows padded by 16 bytes.
//     x A^T is the same product with A^T in place of W^T, on strips of 16 of
//     the r columns.
//   * f32 (FMA path; the tensor cores would round f32 to TF32): CUDA-core
//     FMAs, each thread summing 4 rows of the chunk for 4 columns; x A by one
//     column j per thread group.
//   * Partial sums are reduced across warps through shared memory; block 0
//     of the cluster then sums the blocks' partial x W and x A through
//     distributed shared memory, in rank order (so the result does not depend
//     on scheduling), applies B and rounds once.  x A never leaves the chip.
//
// Every tile recomputes the same x A (A is K x r, at most 64 columns): that
// costs L2 reads of A and r / BO more multiplies, not device-memory bytes,
// and keeps the kernel to one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;          // rows of x per block
constexpr int kBO = 32;         // output columns per block (FMA path)
constexpr int kMmaBO = 64;      // output columns per block (mma path)
constexpr int kMaxRank = 64;
constexpr int kRowsPerThread = 4;
constexpr int kStages = 3;
constexpr int kMaxSplits = 8;        // portable cluster size
constexpr int kTargetBlocks = 132;   // about one block per SM
constexpr int kXPad = 8;             // bf16 elements of padding per x row

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};

// Rows of K per chunk of the FMA path (instantiated for f32 only: 128).
template <typename T>
__host__ __device__ constexpr int chunk_rows() {
  return kThreads / (kBO / Traits<T>::kVec) * kRowsPerThread;
}

// Rows of K per chunk of the mma path: a 16 KB W tile of BO columns.
template <int BO>
__host__ __device__ constexpr int mma_chunk_rows() {
  return 8192 / BO;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Elements of one pipeline stage of C rows: W tile (BO columns), x tile
// (rows padded by `x_pad`), then A chunk with rows of `a_row` elements plus
// kMaxRank of slack (an mma strip may read past the last row's r columns;
// those products are dropped).
template <typename T, int C, int BO>
__host__ __device__ int stage_elems(int a_row, int x_pad) {
  return C * BO + kBT * (C + x_pad) +
         round_up(C * a_row + kMaxRank, Traits<T>::kVec);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset of element (row, col) of a W tile of BO columns.  In the mma path
// the 16-byte pieces of a bf16 row are XOR-swizzled so that the same piece of
// 8 consecutive rows lands in 8 different groups of 4 banks: by (row / 2) % 4
// for 4 pieces a row, by row % 8 for 8 or 16.
template <bool kSwizzle, int BO>
__device__ __forceinline__ int w_off(int row, int col) {
  if constexpr (kSwizzle) {
    const int sw = BO == 32 ? (row >> 1) & 3 : row & 7;
    return row * BO + (((col >> 3) ^ sw) << 3) + (col & 7);
  } else {
    return row * BO + col;
  }
}

// Zero elements [from, to) of a shared tile: the A rows past the end of K up
// to the next k16 step, which an mma would otherwise multiply (by zeros of x,
// but stale shared memory may hold a NaN).
template <typename T>
__device__ __forceinline__ void zero_tail(T* as, int from, int to) {
  for (int i = from + (int)threadIdx.x; i < to; i += kThreads)
    as[i] = Traits<T>::from_f(0.f);
}

// Copy chunk `c` of W, x and A into one stage of shared memory: x rows are
// `x_row` elements apart, A rows `a_row` (>= r, zero-padded).  With kVecLoad
// W and x are 16-byte cp.async copies, and A too when it is packed
// (a_row == r); everything else is filled by element loads.
template <typename T, bool kVecLoad, bool kSwizzle, int C, int BO>
__device__ __forceinline__ void load_chunk(
    T* ws, T* xs, T* as, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ a, int c, int t0, int n_t, int o_base, int K, int O,
    int r, int a_row, int x_row) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  constexpr int kLanesPerRow = BO / V;
  const int tid = threadIdx.x;
  const int k0 = c * C;
  const int k_len = min(C, K - k0);
  const T zero = Tr::from_f(0.f);
  if constexpr (kVecLoad) {
    // W: C rows x kLanesPerRow 16-byte pieces
#pragma unroll
    for (int i = 0; i < C * kLanesPerRow / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int row = p / kLanesPerRow, lane = p % kLanesPerRow;
      const int col = o_base + lane * V;
      const bool ok = row < k_len && col < O;
      cp_async16(ws + w_off<kSwizzle, BO>(row, lane * V),
                 ok ? w + (size_t)(k0 + row) * O + col : w, ok ? 16 : 0);
    }
    // x: kBT rows x C / V pieces (one per thread)
    for (int p = tid; p < kBT * C / V; p += kThreads) {
      const int t = p / (C / V), kk = (p % (C / V)) * V;
      const bool ok = t < n_t && kk < k_len;
      cp_async16(xs + t * x_row + kk,
                 ok ? x + (size_t)(t0 + t) * K + k0 + kk : x, ok ? 16 : 0);
    }
    if (a_row == r) {
      // A: rows k0 .. k0 + k_len are contiguous, k_len * r elements
      const int a_len = k_len * r;
      for (int p = tid; p * V < a_len; p += kThreads) {
        const int left = (a_len - p * V) * (int)sizeof(T);
        cp_async16(as + p * V, a + (size_t)k0 * r + p * V,
                   left < 16 ? left : 16);
      }
      zero_tail(as, round_up(a_len, V), min(C, round_up(k_len, 16)) * a_row);
      return;
    }
  } else {
    for (int i = tid; i < C * BO; i += kThreads) {
      const int row = i / BO, cc = i % BO, col = o_base + cc;
      ws[w_off<kSwizzle, BO>(row, cc)] =
          (row < k_len && col < O) ? w[(size_t)(k0 + row) * O + col] : zero;
    }
    for (int i = tid; i < kBT * C; i += kThreads) {
      const int t = i / C, kk = i % C;
      xs[t * x_row + kk] =
          (t < n_t && kk < k_len) ? x[(size_t)(t0 + t) * K + k0 + kk] : zero;
    }
  }
  for (int i = tid; i < k_len * a_row; i += kThreads) {
    const int kk = i / a_row, j = i % a_row;
    as[i] = j < r ? a[(size_t)(k0 + kk) * r + j] : zero;
  }
  zero_tail(as, k_len * a_row, min(C, round_up(k_len, 16)) * a_row);
}

// Sum the cluster's partial tiles and write y.  part[t * BO + c] is this
// block's x W, xa[t][j] its x A; `scratch` holds >= kBT * r floats.  Block 0
// of the cluster reads every block's partial sums through distributed shared
// memory and adds them in rank order.
template <typename T, int BO>
__device__ __forceinline__ void cluster_epilogue(
    cg::cluster_group& cluster, float* part, float (*xa)[kMaxRank],
    float* scratch, const T* __restrict__ b, T* __restrict__ y, int t0,
    int n_t, int o_base, int O, int r, float scale) {
  using Tr = Traits<T>;
  const int tid = threadIdx.x;
  const int n_splits = (int)cluster.num_blocks();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = tid; i < kBT * r; i += kThreads) {
      float s = 0.f;
      for (int q = 0; q < n_splits; ++q)
        s += cluster.map_shared_rank(&xa[0][0], q)[(i / r) * kMaxRank + i % r];
      scratch[i] = s;               // the tile's x A, (t, j)
    }
    __syncthreads();
    for (int i = tid; i < kBT * BO; i += kThreads) {
      const int t = i / BO, o = o_base + i % BO;
      if (t < n_t && o < O) {
        float s = 0.f;
        for (int q = 0; q < n_splits; ++q)
          s += cluster.map_shared_rank(part, q)[i];
        float d = 0.f;
        for (int j = 0; j < r; ++j)
          d = fmaf(scratch[t * r + j], Tr::to_f(b[(size_t)j * O + o]), d);
        y[(size_t)(t0 + t) * O + o] = Tr::from_f(s + scale * d);
      }
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// ---------------------------------------------------------------------------
// tensor-core path: bf16
// ---------------------------------------------------------------------------

// BO output columns per block: BO / 16 strips of 16 columns, each worked by
// 8 / (BO / 16) warps that share out the chunk's k16 steps (4 steps each).
template <int BO, bool kVecLoad>
__global__ void __launch_bounds__(kThreads)
lora_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b,
                       __nv_bfloat16* __restrict__ y, int n_rows, int K, int O,
                       int r, float scale, int chunks_per_split) {
  using T = __nv_bfloat16;
  constexpr int C = mma_chunk_rows<BO>();
  constexpr int kSteps = C / 16;                     // k16 steps per chunk
  constexpr int kStrips = BO / 16;
  constexpr int kWarpsPerStrip = kWarps / kStrips;
  constexpr int XR = C + kXPad;                      // padded x row
  static_assert(kSteps % kWarpsPerStrip == 0, "k16 steps split evenly");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ float xa[kBT][kMaxRank];                // this block's x A
  __shared__ float part[kBT * BO];                   // this block's x W
  __shared__ float red[kWarps * 16 * kBT];           // per-warp W fragments
  __shared__ float red_a[kWarps * 16 * kBT];         // per-warp x A fragments

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;             // mma fragment coordinates
  const int t0 = blockIdx.y * kBT;
  const int n_t = min(kBT, n_rows - t0);
  const int o_base = blockIdx.x * BO;
  const int n_chunks = (K + C - 1) / C;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int a_row = round_up(r, 8);
  const int stage = stage_elems<T, C, BO>(a_row, kXPad);

  // W: warp -> strip warp % kStrips, k16 steps warp / kStrips + kWarpsPerStrip * i
  const int strip = warp % kStrips;
  const int kq = warp / kStrips;
  // x A: strips of 16 of the r columns, their count rounded up to 1, 2 or 4
  // so that it divides the 8 warps: warp -> strip warp % n_js, k16 steps
  // warp / n_js, + 8 / n_js, ...
  const int n_js = r <= 16 ? 1 : (r <= 32 ? 2 : 4);
  const int js = warp % n_js;
  const int a_kq = warp / n_js, a_nkq = kWarps / n_js;
  const bool a_active = r > 0 && js * 16 < r;

  // ldmatrix.x4.trans: lane -> matrix lane / 8; matrices 2, 3 are rows k + 8,
  // matrices 1, 3 columns + 8
  const int lm_k = (lane & 7) + ((lane >> 4) << 3);
  const int lm_c = ((lane >> 3) & 1) << 3;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_a[4] = {0.f, 0.f, 0.f, 0.f};

  auto prefetch = [&](int c) {
    if (c < c_end) {
      T* st = smem + ((c - c_begin) % kStages) * stage;
      load_chunk<T, kVecLoad, true, C, BO>(st, st + C * BO,
                                           st + C * BO + kBT * XR, x, w, a, c,
                                           t0, n_t, o_base, K, O, r, a_row,
                                           XR);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(c_begin + s);

  for (int c = c_begin; c < c_end; ++c) {
    prefetch(c + kStages - 1);
    cp_async_wait<kStages - 1>();   // this thread's copies of chunk c landed
    __syncthreads();                // ... and every other thread's

    const T* ws = smem + ((c - c_begin) % kStages) * stage;
    const T* xs = ws + C * BO;
    const T* as = xs + kBT * XR;
    const T* xrow = xs + g * XR + 2 * tq;  // x^T fragment: n = g, k = 2tq, +1

#pragma unroll
    for (int i = 0; i < kSteps / kWarpsPerStrip; ++i) {
      const int k = (kq + kWarpsPerStrip * i) * 16;
      unsigned af[4];
      ldmatrix_x4_trans(af, ws + w_off<true, BO>(k + lm_k, strip * 16 + lm_c));
      mma_bf16(acc, af, *reinterpret_cast<const unsigned*>(xrow + k),
               *reinterpret_cast<const unsigned*>(xrow + k + 8));
    }
    if (a_active) {
      const int a_steps = (min(C, K - c * C) + 15) / 16;
      for (int ks = a_kq; ks < a_steps; ks += a_nkq) {
        const int k = ks * 16;
        unsigned af[4];
        ldmatrix_x4_trans(af, as + (k + lm_k) * a_row + js * 16 + lm_c);
        mma_bf16(acc_a, af, *reinterpret_cast<const unsigned*>(xrow + k),
                 *reinterpret_cast<const unsigned*>(xrow + k + 8));
      }
    }
    __syncthreads();  // the stage is refilled by the next prefetch
  }

  // fragments: acc[0], acc[1] = (column g; rows 2tq, 2tq + 1), acc[2], acc[3]
  // the same for column g + 8; stored per warp as [column][row]
  float* rw = red + warp * 16 * kBT;
  rw[g * kBT + 2 * tq] = acc[0];
  rw[g * kBT + 2 * tq + 1] = acc[1];
  rw[(g + 8) * kBT + 2 * tq] = acc[2];
  rw[(g + 8) * kBT + 2 * tq + 1] = acc[3];
  float* ra = red_a + warp * 16 * kBT;
  ra[g * kBT + 2 * tq] = acc_a[0];
  ra[g * kBT + 2 * tq + 1] = acc_a[1];
  ra[(g + 8) * kBT + 2 * tq] = acc_a[2];
  ra[(g + 8) * kBT + 2 * tq + 1] = acc_a[3];
  __syncthreads();
  for (int i = tid; i < kBT * BO; i += kThreads) {
    // part[t][col]: the sum over the warps of the column's strip
    const int t = i / BO, col = i % BO;
    const int s = col / 16, m = col % 16;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarpsPerStrip; ++q)
      v += red[(s + kStrips * q) * 16 * kBT + m * kBT + t];
    part[i] = v;
  }
  for (int i = tid; i < kBT * r; i += kThreads) {
    const int t = i / r, j = i % r;
    float v = 0.f;
    for (int q = 0; q < a_nkq; ++q)
      v += red_a[(j / 16 + n_js * q) * 16 * kBT + (j % 16) * kBT + t];
    xa[t][j] = v;
  }
  cluster_epilogue<T, BO>(cluster, part, xa, red, b, y, t0, n_t, o_base, O,
                          r, scale);
}

// ---------------------------------------------------------------------------
// CUDA-core path: f32
// ---------------------------------------------------------------------------

template <typename T, bool kVecLoad>
__global__ void __launch_bounds__(kThreads)
lora_matmul_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ y, int n_rows, int K, int O, int r,
                       float scale, int chunks_per_split) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;                   // columns per thread
  constexpr int kLanesPerRow = kBO / V;         // 4 (bf16) or 8 (f32)
  constexpr int kRowsPerStep = kThreads / kLanesPerRow;
  constexpr int C = chunk_rows<T>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ float xf[kBT][C];                       // x chunk in fp32
  __shared__ float xa[kBT][kMaxRank];                // this block's x A
  __shared__ float part[kBT * kBO];                  // this block's x W
  __shared__ float red[kWarps * kBT * kBO];          // in-block reduction

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();       // K split of the tile

  const int tid = threadIdx.x;
  const int lane_col = tid % kLanesPerRow;
  const int krow = tid / kLanesPerRow;
  const int t0 = blockIdx.y * kBT;
  const int n_t = min(kBT, n_rows - t0);
  const int o_base = blockIdx.x * kBO;
  const int n_chunks = (K + C - 1) / C;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int stage = stage_elems<T, C, kBO>(r, 0);

  // x A ownership: thread (kg, j) sums column j over the rows kg, kg + G, ...
  // of each chunk, where G = kThreads / r groups fit in the block.
  const int a_groups = r > 0 ? kThreads / r : 0;
  const bool a_owner = r > 0 && tid < a_groups * r;
  const int a_j = r > 0 ? tid % r : 0;
  const int a_kg = r > 0 ? tid / r : 0;

  float acc[kBT][V];
  float acc_a[kBT];
#pragma unroll
  for (int t = 0; t < kBT; ++t) {
    acc_a[t] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
  }

  auto prefetch = [&](int c) {
    if (c < c_end) {
      T* st = smem + ((c - c_begin) % kStages) * stage;
      load_chunk<T, kVecLoad, false, C, kBO>(st, st + C * kBO,
                                             st + C * kBO + kBT * C, x, w, a,
                                             c, t0, n_t, o_base, K, O, r, r, C);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(c_begin + s);

  for (int c = c_begin; c < c_end; ++c) {
    prefetch(c + kStages - 1);
    cp_async_wait<kStages - 1>();   // this thread's copies of chunk c landed
    __syncthreads();                // ... and every other thread's

    const T* ws = smem + ((c - c_begin) % kStages) * stage;
    const T* xs = ws + C * kBO;
    const T* as = xs + kBT * C;
    const int k_len = min(C, K - c * C);
    for (int i = tid; i < kBT * C; i += kThreads) xf[i / C][i % C] = Tr::to_f(xs[i]);
    __syncthreads();

    if (a_owner) {
      for (int kk = a_kg; kk < k_len; kk += a_groups) {
        const float av = Tr::to_f(as[kk * r + a_j]);
#pragma unroll
        for (int t = 0; t < kBT; ++t) acc_a[t] = fmaf(xf[t][kk], av, acc_a[t]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      const int kk = rr * kRowsPerStep + krow;
      alignas(16) T wv[V];
      *reinterpret_cast<uint4*>(wv) =
          *reinterpret_cast<const uint4*>(ws + kk * kBO + lane_col * V);
      float wf[V];
#pragma unroll
      for (int v = 0; v < V; ++v) wf[v] = Tr::to_f(wv[v]);
#pragma unroll
      for (int t = 0; t < kBT; ++t) {
        const float xv = xf[t][kk];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[t][v] = fmaf(xv, wf[v], acc[t][v]);
      }
    }
    __syncthreads();  // stage and xf are refilled by the next chunk
  }

  // this block's x A: reduce over the K groups through red[kg][t][j]
  if (r > 0) {
    if (a_owner) {
#pragma unroll
      for (int t = 0; t < kBT; ++t) red[(a_kg * kBT + t) * r + a_j] = acc_a[t];
    }
    __syncthreads();
    for (int i = tid; i < kBT * r; i += kThreads) {
      const int t = i / r, j = i % r;
      float s = 0.f;
      for (int g = 0; g < a_groups; ++g) s += red[(g * kBT + t) * r + j];
      xa[t][j] = s;
    }
  }

  // this block's x W: reduce over the K rows of a warp by shuffles, then
  // across warps
#pragma unroll
  for (int t = 0; t < kBT; ++t) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1)
        acc[t][v] += __shfl_xor_sync(0xffffffffu, acc[t][v], off);
    }
  }
  __syncthreads();  // red is free again
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int t = 0; t < kBT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(warp * kBT + t) * kBO + lane * V + v] = acc[t][v];
  }
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kBT * kBO + tid];
    part[tid] = s;
  }
  cluster_epilogue<T, kBO>(cluster, part, xa, red, b, y, t0, n_t, o_base, O,
                           r, scale);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Launch `kernel` over tiles of BO columns x 8 rows, K in chunks of C rows.
template <typename T, auto kernel, int C, int BO>
int launch_kernel(int smem, const T* x, const T* w, const T* a, const T* b,
                  T* y, int n_rows, int K, int O, int r, float scale,
                  cudaStream_t stream) {
  // dynamic shared memory above 48 KB must be allowed, once per kernel
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  // Split K over a cluster of up to kMaxSplits blocks when the output has
  // too few tiles to fill the card: aim at kTargetBlocks blocks in all.
  const int tiles = ((O + BO - 1) / BO) * ((n_rows + kBT - 1) / kBT);
  const int n_chunks = (K + C - 1) / C;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  const int per = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per - 1) / per;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + BO - 1) / BO, (n_rows + kBT - 1) / kBT, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, a, b, y, n_rows,
                                           K, O, r, scale, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BO, bool kVecLoad>
int launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
               const __nv_bfloat16* a, const __nv_bfloat16* b,
               __nv_bfloat16* y, int n_rows, int K, int O, int r, float scale,
               cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int C = mma_chunk_rows<BO>();
  const int smem =
      kStages * stage_elems<T, C, BO>(round_up(r, 8), kXPad) * (int)sizeof(T);
  return launch_kernel<T, lora_matmul_mma_kernel<BO, kVecLoad>, C, BO>(
      smem, x, w, a, b, y, n_rows, K, O, r, scale, s);
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b, void* y,
           int n_rows, int K, int O, int r, float scale, int vec_load,
           void* stream) {
  if (n_rows <= 0 || O <= 0) return 0;
  if (K <= 0 || r < 0 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if constexpr (sizeof(T) == 2) {
    return vec_load ? launch_mma<kMmaBO, true>(xp, wp, ap, bp, yp, n_rows, K, O,
                                               r, scale, s)
                    : launch_mma<kMmaBO, false>(xp, wp, ap, bp, yp, n_rows, K,
                                                O, r, scale, s);
  } else {
    constexpr int C = chunk_rows<T>();
    const int smem = kStages * stage_elems<T, C, kBO>(r, 0) * (int)sizeof(T);
    return vec_load
               ? launch_kernel<T, lora_matmul_fma_kernel<T, true>, C, kBO>(
                     smem, xp, wp, ap, bp, yp, n_rows, K, O, r, scale, s)
               : launch_kernel<T, lora_matmul_fma_kernel<T, false>, C, kBO>(
                     smem, xp, wp, ap, bp, yp, n_rows, K, O, r, scale, s);
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; x is
// (n_rows, K), w (K, O), a (K, r), b (r, O), y (n_rows, O), all row-major and
// contiguous.  vec_load = 1 asks for 16-byte copies: K and O must then be
// multiples of 16 / sizeof(element) and x, w, a 16-byte aligned.  Returns
// the launch's cudaGetLastError().
extern "C" int lora_matmul_bf16(const void* x, const void* w, const void* a,
                                const void* b, void* y, int n_rows, int K,
                                int O, int r, float scale, int vec_load,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w, a, b, y, n_rows, K, O, r, scale, vec_load,
                               stream);
}

extern "C" int lora_matmul_f32(const void* x, const void* w, const void* a,
                               const void* b, void* y, int n_rows, int K, int O,
                               int r, float scale, int vec_load, void* stream) {
  return launch<float>(x, w, a, b, y, n_rows, K, O, r, scale, vec_load, stream);
}
