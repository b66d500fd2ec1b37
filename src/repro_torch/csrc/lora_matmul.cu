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
//
// Two routes behind the same C functions, chosen by shape (uses_tiles):
// the kernels above for decode (T below a cut of 64 rows), and from the cut
// on, where the 16-byte copies hold and r is a multiple of 8, two tile
// kernels for the GEMM that training and the federation run (T 512 to
// 2048).  There x W is 2 T K O operations against (T K + K O) elements, so
// the products bound it, and a block takes 128 rows of x so that each W
// tile read feeds 128 rows:
//   * bf16 (lora_matmul_wgmma_kernel): two warpgroups take 64 rows each of
//     a 128 x BO tile (BO 64 or 128, by waves: tile_width).  x W is four
//     m64nBOk16 wgmmas a 64-row chunk of K, x K-major and W MN-major, both
//     read from shared memory through descriptors (no register A operand).
//     x A is a second accumulator (64 x 16, or 64 x 64 for r > 16), a wgmma
//     with A's chunk as its MN-major B operand (in the 32-byte swizzle at 16
//     columns, the 128-byte one at 64), so A is never transposed.  x, W and
//     A arrive by TMA (thread 0 issues them, an mbarrier a stage reports
//     them; zero past T, K, O and r) into a ring of up to 6 stages; one
//     group of wgmmas stays in flight.  With 16-byte cp.async copies and A
//     transposed by the threads, the same design took 29 us at T 512 on an
//     H100 (700 W): the copies and the transpose bounded it, not the tensor
//     cores.
//   * f32 (lora_matmul_sgemm_kernel): the federation's parity needs exact
//     fp32 products, so CUDA-core FMAs (no TF32): a register-tiled SGEMM,
//     256 threads each with 8 rows x 2 NC2 columns (BO = 32 NC2: 64, 96 or
//     128) and x A as RA more columns a thread, x's chunk transposed in
//     shared memory so that a thread reads float4s along T and float2s
//     along O; K split over a cluster (block 0 sums in rank order) where the
//     tiles alone leave SMs idle.
// Both: the epilogue adds s (x A) B in fp32 FMAs (x A never rounded) and
// rounds once.

#include <cooperative_groups.h>
#include <cuda.h>
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
// large T: tiles of 128 rows of x (bf16 on wgmma, f32 on register-tiled FMAs)
// ---------------------------------------------------------------------------

constexpr int kTileT = 128;        // rows of x per block, both tile kernels
constexpr int kTileK = 64;         // bf16: k rows per chunk (a 128-byte x row)
constexpr int kMaxTileStages = 6;  // bf16: chunks in the ring, at most
constexpr int kSmemBytes = 232448; // shared memory a block can have
constexpr int kSgemmK = 16;        // f32: k rows per chunk
constexpr int kSgemmXRow = kTileT + 4;  // f32: padded row of the x chunk's
                                        // transpose (16-byte aligned)

// The tile kernels take a call when T reaches the cut, the 16-byte copies
// hold (vec_load) and r is a multiple of 8 (bf16 reads A's rows by TMA,
// which needs 16-byte rows; f32 keeps the same rule).  Below the cut the
// decode kernels above are faster, in both types (the cut sweep of
// chip_smoke.py's phase 3).  Mirrored by kernels/lora/ops.py::_uses_tiles.
constexpr int kTileMinRows = 64;

// route argument of lora_matmul_route_*: by shape, the decode kernels, the
// tile kernels at the width tile_width picks, or the tile kernels at width
// `route` (64, 96 or 128 columns)
constexpr int kRouteAuto = 0;
constexpr int kRouteDecode = 1;
constexpr int kRouteTile = 2;

constexpr bool uses_tiles(int n_rows, int r, int vec_load) {
  return vec_load != 0 && r % 8 == 0 && n_rows >= kTileMinRows;
}

// Output columns of a tile kernel's block, by waves: each candidate width
// costs (its blocks / the card's SMs, rounded up) x its width, the time of
// the slowest SM in units of one column tile; the cheapest wins, the widest
// on a tie.  bf16 takes 128 or 64, f32 128, 96 or 64.
inline int tile_width(int n_rows, int O, int elem_bytes) {
  const int row_tiles = (n_rows + kTileT - 1) / kTileT;
  const int widths[3] = {128, 96, 64};
  int best = 0, best_cost = 0;
  for (int bo : widths) {
    if (elem_bytes == 2 && bo == 96) continue;
    const int blocks = row_tiles * ((O + bo - 1) / bo);
    const int cost = (blocks + kTargetBlocks - 1) / kTargetBlocks * bo;
    if (best == 0 || cost < best_cost) best = bo, best_cost = cost;
  }
  return best;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmmas are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma writes its accumulators after it is issued, until the wait: these
// empty statements, placed after the wait, keep the compiler from reading
// them before it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]),
                 "+f"(d[i][3])::"memory");
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// wgmma's descriptor of a tile from `tile` on, in the swizzle of kSwizzle
// bytes (128: rows of 64 bf16, 32: rows of 16), as TMA writes it (tiles
// start 1024-byte aligned): 8-row groups are 8 rows apart (the stride byte
// offset); `lbo`, the leading byte offset, is the distance of the 64-column
// halves of an MN-major operand (its N runs across them), unused (16) for a
// K-major one or a single half.
template <int kSwizzle>
__device__ __forceinline__ uint64_t tile_desc(const void* tile, int lbo) {
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 3;  // 128 or 32 bytes
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4)      // start address
         | ((uint64_t)(lbo >> 4) << 16)      // leading byte offset
         | ((uint64_t)(8 * kSwizzle >> 4) << 32)  // 8-row groups
         | (kLayout << 62);
}

// d (64 x N) += x (64 x 16, K-major) W (16 x N, MN-major), N = 128 or 64
// (also x A at N = 64)
__device__ __forceinline__ void wgmma_xw(float (&d)[16][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N) += x (64 x 16, K-major) W (16 x N, MN-major), N = 128 or 64
// (also x A at N = 64)
__device__ __forceinline__ void wgmma_xw(float (&d)[8][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 16) += x (64 x 16, K-major) A (16 x 16, MN-major)
__device__ __forceinline__ void wgmma_xw(float (&d)[2][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(1));
}

// --- bf16 -------------------------------------------------------------------

// mbarrier and TMA (the Tensor Memory Accelerator): one thread asks for a
// whole tile, the copy engine writes it in wgmma's 128-byte swizzle and
// reports its bytes to an mbarrier that the consumers wait on.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// this thread arrives and announces `bytes` more to come from the copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
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

// box (c0, c1) of the 2-D tensor `map` into shared memory at `dst`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Elements of one ring stage: x (128 rows of 64 k, K-major), W (BO / 64
// MN-major halves of 64 k rows x 64 columns) and A (64 k rows x NA, MN-major
// as it lies in memory), each a multiple of 1024 bytes.
template <int BO, int NA>
__host__ __device__ constexpr int wgmma_stage_elems() {
  return kTileT * kTileK + kTileK * BO + kTileK * NA;
}

// Bytes of shared memory beside the ring: the B tile in fp32 (NA x BO) and
// room to align to 1024 bytes.
template <int BO, int NA>
__host__ __device__ constexpr int wgmma_fixed_bytes() {
  return NA * BO * 4 + 1024;
}

// Stages of the ring: as many as fit, up to kMaxTileStages.
template <int BO, int NA>
__host__ __device__ constexpr int wgmma_stages() {
  constexpr int fit = (kSmemBytes - wgmma_fixed_bytes<BO, NA>()) /
                      (wgmma_stage_elems<BO, NA>() * 2);
  return fit < kMaxTileStages ? fit : kMaxTileStages;
}

template <int BO, int NA>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  return wgmma_stages<BO, NA>() * wgmma_stage_elems<BO, NA>() * 2 +
         wgmma_fixed_bytes<BO, NA>();
}

// y[128 x BO tile] = x W + s (x A) B for bf16 on the tensor cores.  Two
// warpgroups take 64 rows each.  NA is r padded to 16 or 64 (0: no
// adapter): x A is a second accumulator of 64 x NA per warpgroup, a wgmma
// with A's chunk as its MN-major B operand (in the 32-byte swizzle at NA 16,
// the 128-byte one at 64), so A is never transposed.  x, W and A arrive by
// TMA (maps: x K x T in boxes of 64 x 128, W O x K in 64 x 64, A r x K in
// NA x 64; zero past every edge, r included); thread 0 issues the copies,
// an mbarrier a stage reports them.
template <int BO, int NA>
__global__ void __launch_bounds__(kThreads, 1)
lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap a_map,
                         const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ y, int n_rows, int K,
                         int O, int r, float scale) {
  using T = __nv_bfloat16;
  constexpr int S = wgmma_stages<BO, NA>();
  constexpr int kStage = wgmma_stage_elems<BO, NA>();
  constexpr int kX = kTileT * kTileK;
  constexpr int kW = kTileK * BO;
  constexpr int kWPieces = BO / 8;       // 16-byte pieces of an output row
  constexpr int XA = NA + 1;             // padded row of x A in the epilogue
  static_assert(NA == 0 || NA == 16 || NA == 64, "x A's width");
  static_assert(S >= 4, "the ring holds four chunks or more");
  static_assert(kTileT * XA * 4 + kTileT * BO * 2 <= S * kStage * 2,
                "the epilogue fits in the ring");
  extern __shared__ __align__(16) unsigned char wgmma_smem[];
  __shared__ uint64_t full[S];           // chunk landed in stage s
  T* ring = reinterpret_cast<T*>(   // TMA's swizzle: 1024-byte aligned tiles
      wgmma_smem + ((1024 - (smem_u32(wgmma_smem) & 1023)) & 1023));
  float* bs = reinterpret_cast<float*>(ring + S * kStage);  // [NA][BO]

  const int tid = threadIdx.x;
  const int wg = tid / 128;              // rows 64 wg .. 64 wg + 63
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // accumulator fragment coordinates
  const int t0 = blockIdx.y * kTileT;
  const int o_base = blockIdx.x * BO;
  const int n_chunks = (K + kTileK - 1) / kTileK;

  // thread 0: chunk c's x, W and A into stage c % S
  auto issue = [&](int c) {
    if (c >= n_chunks) return;
    T* st = ring + (c % S) * kStage;
    uint64_t* bar = &full[c % S];
    mbar_expect_tx(bar, kStage * 2);
    tma_2d(st, &x_map, c * kTileK, t0, bar);
#pragma unroll
    for (int h = 0; h < BO / 64; ++h)
      tma_2d(st + kX + h * 4096, &w_map, o_base + h * 64, c * kTileK, bar);
    if constexpr (NA > 0) tma_2d(st + kX + kW, &a_map, 0, c * kTileK, bar);
  };

  float acc[BO / 8][4];
  float acc_a[NA > 0 ? NA / 8 : 1][4];
#pragma unroll
  for (int i = 0; i < BO / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (NA > 0 ? NA / 8 : 1); ++i)
    acc_a[i][0] = acc_a[i][1] = acc_a[i][2] = acc_a[i][3] = 0.f;

  // set up: the barriers, and the B tile in fp32 (zero past r and O), read
  // now so that its latency hides under the first copies
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (NA > 0) {
    for (int i = tid; i < NA * BO; i += kThreads) {
      const int j = i / BO, col = o_base + i % BO;
      bs[i] = j < r && col < O ? __bfloat162float(b[(size_t)j * O + col])
                               : 0.f;
    }
  }
  __syncthreads();

  // The products of chunk c are issued while those of c - 1 may still run
  // (one group of wgmmas stays in flight), and chunk c + S - 2 is copied
  // meanwhile into the stage of chunk c - 2.
  if (tid == 0)
    for (int s = 0; s < S - 2; ++s) issue(s);
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(&full[c % S], (c / S) & 1);  // chunk c landed
    __syncthreads();                     // the wgmmas of c - 2 are done
    if (tid == 0) issue(c + S - 2);      // into the stage of chunk c - 2
    const T* st = ring + (c % S) * kStage;
    const T* xs = st + wg * 4096;        // the warpgroup's 64 rows
    // four k16 steps: x's descriptor advances 32 bytes in its 128-byte
    // rows, W's 16 k rows (2 KB), A's 16 k rows (NA 16: 512 bytes)
    reg_fence(acc);
    if constexpr (NA > 0) reg_fence(acc_a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_xw(acc, tile_desc<128>(xs + kk * 16, 16),
               tile_desc<128>(st + kX + kk * 16 * 64, 8192));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (NA == 16)
        wgmma_xw(acc_a, tile_desc<128>(xs + kk * 16, 16),
                 tile_desc<32>(st + kX + kW + kk * 16 * 16, 16));
      else if constexpr (NA == 64)
        wgmma_xw(acc_a, tile_desc<128>(xs + kk * 16, 16),
                 tile_desc<128>(st + kX + kW + kk * 16 * 64, 8192));
    }
    wgmma_commit();
    wgmma_wait<1>();                     // the products of c - 1 are done
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if constexpr (NA > 0) reg_fence(acc_a);
  __syncthreads();                       // the ring is free

  // epilogue: y = acc + s (x A) B in fp32 FMAs (x A is never rounded), one
  // rounding to bf16, through shared memory into 16-byte stores.  Fragment
  // (i, e) of a thread is row row0 + 8 (e / 2), column 8 i + 2 tq + e % 2.
  const int row0 = wg * 64 + warp * 16 + g;
  float* xa_s = reinterpret_cast<float*>(ring);   // [128][XA]
  T* ys = reinterpret_cast<T*>(xa_s + kTileT * XA);  // [128][BO], swizzled
  if constexpr (NA > 0) {
#pragma unroll
    for (int i = 0; i < NA / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa_s[(row0 + 8 * (e >> 1)) * XA + 8 * i + 2 * tq + (e & 1)] =
            acc_a[i][e];
    __syncthreads();
    float d[BO / 8][4];
#pragma unroll
    for (int i = 0; i < BO / 8; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
    for (int j = 0; j < r; ++j) {
      const float x0 = xa_s[row0 * XA + j], x1 = xa_s[(row0 + 8) * XA + j];
#pragma unroll
      for (int i = 0; i < BO / 8; ++i) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bs + j * BO + 8 * i + 2 * tq);
        d[i][0] = fmaf(x0, bv.x, d[i][0]);
        d[i][1] = fmaf(x0, bv.y, d[i][1]);
        d[i][2] = fmaf(x1, bv.x, d[i][2]);
        d[i][3] = fmaf(x1, bv.y, d[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < BO / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(scale, d[i][e], acc[i][e]);
  }
#pragma unroll
  for (int i = 0; i < BO / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      *reinterpret_cast<unsigned*>(ys + row * BO + ((i ^ (row & 7)) << 3) +
                                   2 * tq) =
          pack_bf16(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  __syncthreads();
  for (int p = tid; p < kTileT * kWPieces; p += kThreads) {
    const int row = p / kWPieces, pc = p % kWPieces;
    if (t0 + row < n_rows && o_base + pc * 8 < O)
      *reinterpret_cast<uint4*>(y + (size_t)(t0 + row) * O + o_base + pc * 8) =
          *reinterpret_cast<const uint4*>(ys + row * BO +
                                          ((pc ^ (row & 7)) << 3));
  }
}

// --- f32 --------------------------------------------------------------------

// Floats a thread sums of x W and x A
template <int NC2, int RA>
__host__ __device__ constexpr int sgemm_sums() {
  return 8 * 2 * NC2 + 8 * (RA > 0 ? RA : 1);
}

// Bytes of shared memory: the double-buffered chunks (x^T, W, A), the
// split's partial sums, or the epilogue's x A (rows padded by one) and B
// tile, whichever is largest.
template <int NC2, int RA>
__host__ __device__ constexpr int sgemm_smem_bytes() {
  constexpr int ring = 2 * kSgemmK * (kSgemmXRow + 32 * NC2 + 16 * RA);
  constexpr int part = sgemm_sums<NC2, RA>() * kThreads;
  constexpr int epi = kTileT * (16 * RA + 1) + 16 * RA * 32 * NC2;
  constexpr int m = ring > part ? ring : part;
  return (m > epi ? m : epi) * 4;
}

// Blocks an SM of the f32 tile kernel: two where its registers allow (BO 64
// and 96), else one
__host__ __device__ constexpr int sgemm_blocks_per_sm(int nc2) {
  return nc2 <= 3 ? 2 : 1;
}

// K split of the f32 tile kernel over a cluster (grid z): enough blocks for
// `per_sm` an SM, at most kMaxSplits, each split one chunk or more; sets
// the chunks of a split
inline int sgemm_splits(int blocks, int n_chunks, int per_sm,
                       int* chunks_per_split) {
  int splits = per_sm * kTargetBlocks / blocks;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  const int per = (n_chunks + splits - 1) / splits;
  *chunks_per_split = per;
  return (n_chunks + per - 1) / per;
}



// y[128 x BO tile] = x W + s (x A) B for f32 on the CUDA cores (exact fp32
// FMAs; no TF32).  BO = 32 NC2.  Thread (ty, tx) of a 16 x 16 grid holds
// rows 4 ty .. 4 ty + 3 and 64 + 4 ty .. + 3 for columns 2 tx + 32 p, + 1
// (p < NC2), and x A for the same rows and columns tx + 16 q (q < RA; r is
// padded to 16 RA with zeros): x A is RA / NC2 / 2 more work per k.  Where
// the tiles alone leave SMs idle, K is split over a cluster of blocks (grid
// z) and block 0 sums their x W and x A in rank order through distributed
// shared memory, so the result does not depend on scheduling.
template <int NC2, int RA>
__global__ void __launch_bounds__(kThreads, sgemm_blocks_per_sm(NC2))
lora_matmul_sgemm_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ y,
                         int n_rows, int K, int O, int r, float scale,
                         int chunks_per_split) {
  constexpr int BO = 32 * NC2;
  constexpr int NAc = 16 * RA;
  constexpr int BK = kSgemmK;
  constexpr int XR = kSgemmXRow;
  constexpr int XA = NAc + 1;
  constexpr int kWPieces = BK * BO / 4;
  constexpr int kXLoads = kTileT * BK / 4 / kThreads;  // float4s a thread
  constexpr int kALoads = BK * NAc / kThreads;         // floats a thread
  constexpr int RA1 = RA > 0 ? RA : 1;
  static_assert(kXLoads * kThreads * 4 == kTileT * BK, "x chunk in float4s");
  extern __shared__ __align__(16) float sgemm_smem[];
  float* xs = sgemm_smem;               // [2][BK][XR]: x chunk, transposed
  float* ws = xs + 2 * BK * XR;         // [2][BK][BO]
  float* as = ws + 2 * BK * BO;         // [2][BK][NAc]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.y * kTileT;
  const int o_base = blockIdx.x * BO;
  const int c_begin = split * chunks_per_split;
  const int c_end = min((K + BK - 1) / BK, c_begin + chunks_per_split);

  float acc[8][2 * NC2];
  float acc_a[8][RA1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 2 * NC2; ++c) acc[i][c] = 0.f;
#pragma unroll
    for (int q = 0; q < RA1; ++q) acc_a[i][q] = 0.f;
  }

  // the next chunk's x and A pass through registers (x is transposed on its
  // way into shared memory); W goes by cp.async
  float4 xr[kXLoads];
  float ar[kALoads > 0 ? kALoads : 1];
  auto load_regs = [&](int c) {
    const int k0 = c * BK;
#pragma unroll
    for (int h = 0; h < kXLoads; ++h) {
      const int p = tid + h * kThreads, row = p / (BK / 4), kq = p % (BK / 4);
      const bool ok = t0 + row < n_rows && k0 + kq * 4 < K;
      xr[h] = ok ? *reinterpret_cast<const float4*>(
                       x + (size_t)(t0 + row) * K + k0 + kq * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if constexpr (RA > 0) {
#pragma unroll
      for (int h = 0; h < kALoads; ++h) {
        const int e = tid + h * kThreads, kk = e / NAc, j = e % NAc;
        ar[h] = k0 + kk < K && j < r ? a[(size_t)(k0 + kk) * r + j] : 0.f;
      }
    }
  };
  auto store_regs = [&](int buf) {
    float* xb = xs + buf * BK * XR;
#pragma unroll
    for (int h = 0; h < kXLoads; ++h) {
      const int p = tid + h * kThreads, row = p / (BK / 4), kq = p % (BK / 4);
      xb[(kq * 4 + 0) * XR + row] = xr[h].x;
      xb[(kq * 4 + 1) * XR + row] = xr[h].y;
      xb[(kq * 4 + 2) * XR + row] = xr[h].z;
      xb[(kq * 4 + 3) * XR + row] = xr[h].w;
    }
#pragma unroll
    for (int h = 0; h < kALoads; ++h)
      as[buf * BK * NAc + tid + h * kThreads] = ar[h];
  };
  auto copy_w = [&](int c, int buf) {
    const int k0 = c * BK;
    float* wb = ws + buf * BK * BO;
#pragma unroll
    for (int h = 0; h < (kWPieces + kThreads - 1) / kThreads; ++h) {
      const int p = tid + h * kThreads;
      if (p < kWPieces) {
        const int kr = p / (BO / 4), pc = p % (BO / 4);
        const int col = o_base + pc * 4;
        const bool ok = k0 + kr < K && col < O;
        cp_async16(wb + kr * BO + pc * 4,
                   ok ? w + (size_t)(k0 + kr) * O + col : w, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  load_regs(c_begin);
  copy_w(c_begin, 0);
  store_regs(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const bool more = c + 1 < c_end;
    if (more) {                         // chunk c + 1 under this one's FMAs
      load_regs(c + 1);
      copy_w(c + 1, buf ^ 1);
    }
    const float* xb = xs + buf * BK * XR;
    const float* wb = ws + buf * BK * BO;
    const float* ab = as + buf * BK * NAc;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(xb + kk * XR + ty * 4);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xb + kk * XR + 64 + ty * 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float2 wv[NC2];
#pragma unroll
      for (int p = 0; p < NC2; ++p)
        wv[p] = *reinterpret_cast<const float2*>(wb + kk * BO + 32 * p + 2 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int p = 0; p < NC2; ++p) {
          acc[i][2 * p] = fmaf(xv[i], wv[p].x, acc[i][2 * p]);
          acc[i][2 * p + 1] = fmaf(xv[i], wv[p].y, acc[i][2 * p + 1]);
        }
#pragma unroll
      for (int q = 0; q < RA; ++q) {
        const float av = ab[kk * NAc + 16 * q + tx];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc_a[i][q] = fmaf(xv[i], av, acc_a[i][q]);
      }
    }
    if (more) store_regs(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();                    // buf is refilled in the next step
  }

  // the split's partial sums into block 0, in rank order; the others leave
  const int n_splits = (int)cluster.num_blocks();
  if (n_splits > 1) {
    float* part = sgemm_smem;           // [sum][thread]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2 * NC2; ++c)
        part[(i * 2 * NC2 + c) * kThreads + tid] = acc[i][c];
#pragma unroll
      for (int q = 0; q < RA1; ++q)
        part[(16 * NC2 + i * RA1 + q) * kThreads + tid] = acc_a[i][q];
    }
    cluster.sync();
    if (split == 0) {
      for (int q = 1; q < n_splits; ++q) {
        const float* rp = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2 * NC2; ++c)
            acc[i][c] += rp[(i * 2 * NC2 + c) * kThreads + tid];
#pragma unroll
          for (int qq = 0; qq < RA1; ++qq)
            acc_a[i][qq] += rp[(16 * NC2 + i * RA1 + qq) * kThreads + tid];
        }
      }
    }
    cluster.sync();  // no block leaves while block 0 reads its shared memory
    if (split != 0) return;
  }

  // epilogue: y = acc + s (x A) B in fp32, stored as float2s
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + 4 * ty + (i & 3); };
  if constexpr (RA > 0) {
    float* xa_s = sgemm_smem;           // [128][XA]
    float* bs = xa_s + kTileT * XA;     // [r][BO]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < RA; ++q) xa_s[row_of(i) * XA + 16 * q + tx] = acc_a[i][q];
    for (int e = tid; e < r * BO; e += kThreads) {
      const int col = o_base + e % BO;
      bs[e] = col < O ? b[(size_t)(e / BO) * O + col] : 0.f;
    }
    __syncthreads();
    float d[8][2 * NC2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2 * NC2; ++c) d[i][c] = 0.f;
    for (int j = 0; j < r; ++j) {
      float2 bv[NC2];
#pragma unroll
      for (int p = 0; p < NC2; ++p)
        bv[p] = *reinterpret_cast<const float2*>(bs + j * BO + 32 * p + 2 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = xa_s[row_of(i) * XA + j];
#pragma unroll
        for (int p = 0; p < NC2; ++p) {
          d[i][2 * p] = fmaf(xv, bv[p].x, d[i][2 * p]);
          d[i][2 * p + 1] = fmaf(xv, bv[p].y, d[i][2 * p + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2 * NC2; ++c) acc[i][c] = fmaf(scale, d[i][c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + row_of(i);
    if (t >= n_rows) continue;
#pragma unroll
    for (int p = 0; p < NC2; ++p) {
      const int col = o_base + 32 * p + 2 * tx;
      if (col < O)
        *reinterpret_cast<float2*>(y + (size_t)t * O + col) =
            make_float2(acc[i][2 * p], acc[i][2 * p + 1]);
    }
  }
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

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// TMA's map of a bf16 matrix of `rows` rows of `cols` contiguous elements,
// read in boxes of `box_cols` x `box_rows` into the swizzle of `box_cols` x
// 2 bytes (128 or 32), zero past the edges
int bf16_map(CUtensorMap* map, const void* base, int cols, int rows,
             int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult e = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return e == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BO, int NA>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                 const __nv_bfloat16* a, const __nv_bfloat16* b,
                 __nv_bfloat16* y, int n_rows, int K, int O, int r,
                 float scale, cudaStream_t s) {
  CUtensorMap x_map, w_map, a_map = {};
  int e = bf16_map(&x_map, x, K, n_rows, kTileK, kTileT);
  if (e == 0) e = bf16_map(&w_map, w, O, K, 64, kTileK);
  if (e == 0 && NA > 0) e = bf16_map(&a_map, a, r, K, NA, kTileK);
  if (e != 0) return e;
  constexpr int smem = wgmma_smem_bytes<BO, NA>();
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t ea = cudaFuncSetAttribute(
        lora_matmul_wgmma_kernel<BO, NA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (ea != cudaSuccess) return (int)ea;
    allowed = true;
  }
  const dim3 grid((O + BO - 1) / BO, (n_rows + kTileT - 1) / kTileT);
  lora_matmul_wgmma_kernel<BO, NA><<<grid, kThreads, smem, s>>>(
      x_map, w_map, a_map, b, y, n_rows, K, O, r, scale);
  return (int)cudaGetLastError();
}

template <int BO>
int launch_wgmma_rank(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      const __nv_bfloat16* a, const __nv_bfloat16* b,
                      __nv_bfloat16* y, int n_rows, int K, int O, int r,
                      float scale, cudaStream_t s) {
  if (r == 0) return launch_wgmma<BO, 0>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  if (r <= 16) return launch_wgmma<BO, 16>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  return launch_wgmma<BO, 64>(x, w, a, b, y, n_rows, K, O, r, scale, s);
}

template <int NC2, int RA>
int launch_sgemm(const float* x, const float* w, const float* a,
                 const float* b, float* y, int n_rows, int K, int O, int r,
                 float scale, cudaStream_t s) {
  constexpr auto kernel = lora_matmul_sgemm_kernel<NC2, RA>;
  constexpr int smem = sgemm_smem_bytes<NC2, RA>();
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int gx = (O + 32 * NC2 - 1) / (32 * NC2);
  const int gy = (n_rows + kTileT - 1) / kTileT;
  int per = 0;
  const int splits = sgemm_splits(gx * gy, (K + kSgemmK - 1) / kSgemmK,
                                  sgemm_blocks_per_sm(NC2), &per);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;   // a tile's K splits form a cluster
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, a, b, y, n_rows,
                                           K, O, r, scale, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x A's columns per thread: r padded to 16, 32 or 64 (48 takes 64)
template <int NC2>
int launch_sgemm_rank(const float* x, const float* w, const float* a,
                      const float* b, float* y, int n_rows, int K, int O,
                      int r, float scale, cudaStream_t s) {
  if (r == 0) return launch_sgemm<NC2, 0>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  if (r <= 16) return launch_sgemm<NC2, 1>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  if (r <= 32) return launch_sgemm<NC2, 2>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  return launch_sgemm<NC2, 4>(x, w, a, b, y, n_rows, K, O, r, scale, s);
}

// One tile kernel at `bo` output columns a block.
template <typename T>
int launch_tiles(const T* x, const T* w, const T* a, const T* b, T* y,
                 int n_rows, int K, int O, int r, float scale, int bo,
                 cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (bo == 128)
      return launch_wgmma_rank<128>(x, w, a, b, y, n_rows, K, O, r, scale, s);
    if (bo == 64)
      return launch_wgmma_rank<64>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  } else {
    if (bo == 128)
      return launch_sgemm_rank<4>(x, w, a, b, y, n_rows, K, O, r, scale, s);
    if (bo == 96)
      return launch_sgemm_rank<3>(x, w, a, b, y, n_rows, K, O, r, scale, s);
    if (bo == 64)
      return launch_sgemm_rank<2>(x, w, a, b, y, n_rows, K, O, r, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b, void* y,
           int n_rows, int K, int O, int r, float scale, int vec_load,
           void* stream, int route = kRouteAuto) {
  if (n_rows <= 0 || O <= 0) return 0;
  if (K <= 0 || r < 0 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  // large T: a tile kernel, at the width the waves pick
  if (route == kRouteAuto ? uses_tiles(n_rows, r, vec_load)
                          : route != kRouteDecode) {
    if (!vec_load || r % 8 != 0) return (int)cudaErrorInvalidValue;
    const int bo =
        route > kRouteTile ? route : tile_width(n_rows, O, (int)sizeof(T));
    return launch_tiles<T>(xp, wp, ap, bp, yp, n_rows, K, O, r, scale, bo, s);
  }
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

// The same with the kernel chosen by the caller (kRouteDecode, kRouteTile,
// or a tile width: 64 or 128 in bf16, 64, 96 or 128 in f32), for timing the
// two routes against each other and testing each width; the port itself
// calls the functions above.
extern "C" int lora_matmul_route_bf16(const void* x, const void* w,
                                      const void* a, const void* b, void* y,
                                      int n_rows, int K, int O, int r,
                                      float scale, int vec_load, int route,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, w, a, b, y, n_rows, K, O, r, scale,
                               vec_load, stream, route);
}

extern "C" int lora_matmul_route_f32(const void* x, const void* w,
                                     const void* a, const void* b, void* y,
                                     int n_rows, int K, int O, int r,
                                     float scale, int vec_load, int route,
                                     void* stream) {
  return launch<float>(x, w, a, b, y, n_rows, K, O, r, scale, vec_load,
                       stream, route);
}

// The kernel a call of these shapes takes, by the rule above: out[0] is 1
// for a tile kernel and 0 for a decode kernel; for a tile kernel out[1] and
// out[2] are a block's rows and columns, out[3] to out[5] the grid (z: the
// K split).  Lets the caller check its mirror of the rule (kernels/lora/
// ops.py) and print the waves.
extern "C" int lora_matmul_plan(int n_rows, int K, int O, int r,
                                int elem_bytes, int vec_load, int* out) {
  (void)K;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (n_rows <= 0 || O <= 0 || !uses_tiles(n_rows, r, vec_load))
    return 0;
  const int bo = tile_width(n_rows, O, elem_bytes);
  out[0] = 1;
  out[1] = kTileT;
  out[2] = bo;
  out[3] = (O + bo - 1) / bo;
  out[4] = (n_rows + kTileT - 1) / kTileT;
  int per = 0;
  out[5] = elem_bytes == 2
               ? 1
               : sgemm_splits(out[3] * out[4], (K + kSgemmK - 1) / kSgemmK,
                              sgemm_blocks_per_sm(bo / 32), &per);
  return 0;
}
