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
// r = 16, bf16) the work is 4 T D r = 67 Mflop against 2 T D elements of H
// and out (4 MB), about 16 flops a byte: the bytes bound it (1.3 us at 3.35
// TB/s); at the federation's (T = 2048, D = 768, r = 8, f32) likewise (3.8
// us).  But 2 T D r multiply-adds are also about 1 us of the card's fp32
// FMA rate, so the operands must come from registers, not shared memory, as
// much as they can.
//
// Two routes behind the same C functions, chosen by tile_plan():
//
// The tile route (16-byte rows: D x element size a multiple of 16 and h and
// out 16-byte aligned; and its shared memory fits), which reads each element
// of H from device memory once and writes out once:
//   * D is split over a thread-block cluster of C blocks (2 to 8, slices of
//     at most 1024 columns where they fit): block `rank` owns the columns
//     [rank Ds, rank Ds + Ds), Ds a multiple of 16.  A cluster takes one
//     tile of R rows, so the grid is C x tiles blocks; where it exceeds
//     what the card holds at once, the hardware queues the rest.
//     A block copies its slice of U into shared memory (one bulk copy of
//     its rows as they lie, then transposed to (r, Ds) in H's type, by
//     ldmatrix where the rows allow it).
//   * Its tile is R rows x the slice of H, brought in by 1-D bulk
//     asynchronous copies (cp.async.bulk, one a row, completing on an
//     mbarrier).
//   * P_rank = H_slice U_slice (R x r): bf16 on the tensor cores (mma.sync
//     m16n8k16, exact products, fp32 sums; the 8 warps split the slice's
//     16-column steps), f32 on fp32 FMAs (each thread a 4 x 4 block of P over
//     a share of the columns).  The warps' (threads') partial sums are added
//     in a fixed order.
//   * Each block sends P_rank into slot `rank` of every block of the cluster
//     (stores to distributed shared memory, only once every block of the
//     cluster has started: a cluster barrier arrived at after the mbarriers'
//     set-up and waited on before the first store), and after one more
//     cluster barrier each sums the slots in rank order, so every block
//     holds the same P whatever the scheduling; then
//     P W (fp32 FMAs) and out = H_slice + (P W) U_slice^T (fp32 FMAs, each
//     thread 4 rows x one 16-byte chunk of columns, the U chunk read once
//     for the 4 rows), from the tile still in shared memory, stored with
//     16-byte stores.  P W is never rounded to bf16.
//   * Rows of a tile past T are neither copied nor written.
//
// The rows route (anything else, e.g. D = 300 in bf16 or an offset pointer),
// the first, simpler kernel: a block of 256 threads owns kRows = 4 rows;
// pass 1 sums H U in registers and reduces across warps in warp order, one
// thread a value of (H U) W, pass 2 rereads H and adds (H U W) U^T.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of H per block (rows route)
constexpr int kStrip = 16;     // columns of U per pass-1 strip (rows route)
constexpr int kMaxRank = 64;

// tile route
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kSliceCols = 1024;    // a block's D-slice is at most this wide
constexpr int kMinCluster = 2;      // D is split over at least 2 blocks
constexpr int kTargetBlocks = 256;  // about two blocks on each of 132 SMs
constexpr int kMaxTileRows = 32;
constexpr int kMaxSmem = 232448;    // dynamic shared memory of a block

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

// ---------------------------------------------------------------------------
// rows route
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// tile route
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The rank padded to what the products take: 8, 16, 32 or 64.
__host__ __device__ constexpr int padded_rank(int r) {
  return r <= 8 ? 8 : (r <= 16 ? 16 : (r <= 32 ? 32 : 64));
}

// Where everything lives in a tile block's shared memory (byte offsets), for
// a slice of Ds columns, tiles of R rows, rank padded to kR, elements of
// `el` bytes and a cluster of C blocks.  Rows of H and of
// U^T are ld = Ds + 16 / el elements apart: 16-byte aligned for the bulk
// copies, and for the mma fragments' 4-byte reads 8 rows land on 8 different
// groups of 4 banks.
struct TileLayout {
  int ld, rows_alloc, n_red;
  int ut, ustage, hs, red, part, pfull, pwt, w, bar, total;
};

__host__ __device__ inline TileLayout tile_layout(int Ds, int R, int kR,
                                                  int el, int C) {
  TileLayout L{};
  L.ld = Ds + 16 / el;
  L.rows_alloc = round_up(R, 16);          // whole m16 tiles for the mma
  // partial sums of P: 8 warps' fragments (bf16), or one 4 x 4 block of P per
  // thread, (kThreads / blocks) shares of the columns (f32)
  L.n_red = el == 2 ? kWarps : kThreads / ((R / 4) * (kR / 4));
  int off = 0;
  L.ut = off;
  off += round_up(kR * L.ld * el, 16);
  L.ustage = off;                          // U's rows as they lie, + shift
  off += round_up(Ds * kR * el, 16) + 16;
  L.hs = off;                              // the tile of H
  off += round_up(L.rows_alloc * L.ld * el, 16);
  L.red = off;     // (rows_alloc x kR) x (n_red + 1): no bank conflicts
  off += round_up(L.rows_alloc * kR * (L.n_red + 1) * 4, 16);
  L.part = off;    // the cluster's C partials of P
  off += C * R * kR * 4;
  L.pfull = off;
  off += R * kR * 4;
  L.pwt = off;
  off += kR * R * 4;
  L.w = off;
  off += kR * kR * 4;
  L.bar = round_up(off, 16);               // H's and U's mbarriers
  L.total = L.bar + 16;
  return L;
}

// A launch of the tile route: cluster size, rows a tile, tiles (clusters),
// slice width, padded rank and shared memory.
struct TilePlan {
  int C, R, tiles, Ds, kR, smem;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, reported to `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A contiguous run of `bytes` at `src`, kept in shared memory from `region` +
// src % 16 on, so that its 16-byte aligned middle lands aligned: `head`
// bytes before the middle, `body` bytes of middle (a multiple of 16, one
// bulk copy) and the rest after it, copied by the threads.
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

// every thread: the run's ends, element by element
template <typename T>
__device__ __forceinline__ void copy_ends(const Run& run) {
  constexpr int el = (int)sizeof(T);
  const int n_head = run.head / el;
  const int n_tail = (run.bytes - run.head - run.body) / el;
  const T* s = reinterpret_cast<const T*>(run.src);
  T* d = reinterpret_cast<T*>(run.dst);
  const int tail0 = (run.head + run.body) / el;
  for (int i = threadIdx.x; i < n_head + n_tail; i += kThreads) {
    const int e = i < n_head ? i : tail0 + i - n_head;
    d[e] = s[e];
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Warp 0 asks for the n_t rows from t0 on in this block's slice: one bulk
// copy a row, their bytes announced to `bar` first.
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* h, int t0,
                                           int n_t, int D, int d0, int dl,
                                           int ld, uint64_t* bar, int lane) {
  const int bytes = dl * (int)sizeof(T);
  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, n_t * bytes);
  }
  __syncwarp();
  if (bytes > 0)
    for (int t = lane; t < n_t; t += 32)
      bulk_g2s(dst + (size_t)t * ld, h + (size_t)(t0 + t) * D + d0, bytes,
               bar);
}

template <typename T, int kR>
__global__ void __launch_bounds__(kThreads)
ssop_tile_kernel(const T* __restrict__ h, const T* __restrict__ u,
                 const T* __restrict__ w, T* __restrict__ out, int n_rows,
                 int D, int r, int R, int Ds) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int el = (int)sizeof(T);
  constexpr int V = 16 / el;            // elements in 16 bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const TileLayout L = tile_layout(Ds, R, kR, el, C);
  const int ld = L.ld;
  T* ut = reinterpret_cast<T*>(smem + L.ut);
  T* hs = reinterpret_cast<T*>(smem + L.hs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* pfull = reinterpret_cast<float*>(smem + L.pfull);
  float* pwt = reinterpret_cast<float*>(smem + L.pwt);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* ubar = hbar + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d0 = rank * Ds;
  const int dl = max(0, min(Ds, D - d0));   // columns this block owns
  const int t0 = (int)(blockIdx.x / C) * R; // the cluster's tile
  const int n_t = min(R, n_rows - t0);

  const Run ur = make_run(u + (size_t)d0 * r, dl * r * el, smem + L.ustage);
  if (tid == 0) {
    mbar_init(hbar, 1);
    mbar_init(ubar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Other blocks of the cluster may store into this one's shared memory
  // only once it has started: arrive here, wait before the first such store
  // (the copies fly meanwhile).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (warp == 0) issue_tile(hs, h, t0, n_t, D, d0, dl, ld, hbar, lane);
  if (tid == 32) {   // the block's rows of U, as they lie
    mbar_expect_tx(ubar, ur.body);
    if (ur.body > 0) bulk_g2s(ur.dst + ur.head, ur.src + ur.head, ur.body,
                              ubar);
  }
  copy_ends<T>(ur);

  // while the copies fly: W in fp32 (zero past r), and zeros where no copy
  // writes that the products read (columns past the slice, rows past R)
  for (int i = tid; i < kR * kR; i += kThreads) {
    const int k = i / kR, j = i % kR;
    ws[i] = k < r && j < r ? to_f(w[k * r + j]) : 0.f;
  }
  for (int t = warp; t < L.rows_alloc; t += kWarps)
    for (int c = (t < R ? dl : 0) + lane; c < ld; c += 32)
      hs[t * ld + c] = from_f<T>(0.f);
  __syncthreads();   // U's ends are in
  mbar_wait(ubar, 0);
  // U^T in shared memory, zero past r and past the slice
  const T* us = reinterpret_cast<const T*>(ur.dst);
  if (el == 2 && r % 8 == 0 && reinterpret_cast<uintptr_t>(us) % 16 == 0) {
    // 8 x 8 blocks of U transposed by ldmatrix: a warp takes 4 blocks down
    // U's rows at a time; each lane gets two consecutive k of one row j
    const int kb_n = dl / 8;
    for (int jb = 0; jb < r / 8; ++jb)
      for (int kb0 = 4 * warp; kb0 < kb_n; kb0 += 4 * kWarps) {
        const int kb = min(kb0 + lane / 8, kb_n - 1);
        const unsigned addr = smem_u32(us + (kb * 8 + lane % 8) * r + jb * 8);
        uint32_t v[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
            : "r"(addr));
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            ut + (jb * 8 + lane / 4) * ld + kb0 * 8 + 2 * (lane % 4));
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (kb0 + m < kb_n) dst[m * 4] = v[m];
      }
    for (int j = warp; j < kR; j += kWarps)
      for (int k = (j < r ? dl : 0) + lane; k < Ds; k += 32)
        ut[j * ld + k] = from_f<T>(0.f);
  } else {
    for (int i = tid; i < Ds * kR; i += kThreads) {   // along U's rows
      const int k = i / kR, j = i % kR;
      ut[j * ld + k] = j < r && k < dl ? us[k * r + j] : from_f<T>(0.f);
    }
  }
  __syncthreads();

  mbar_wait(hbar, 0);

  // P_rank = H_slice U_slice, partial sums into red
  if constexpr (el == 2) {
    constexpr int kN = kR / 8;
    const int g = lane / 4, q = lane % 4;
    const int n_m = L.rows_alloc / 16;
    float acc[kMaxTileRows / 16][kN][4];
#pragma unroll
    for (int m = 0; m < kMaxTileRows / 16; ++m)
#pragma unroll
      for (int n = 0; n < kN; ++n)
        acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
    const int ksteps = (dl + 15) / 16;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      const int k = ks * 16 + 2 * q;
      uint32_t b0[kN], b1[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const T* bp = ut + (n * 8 + g) * ld + k;
        b0[n] = ld_u32(bp);
        b1[n] = ld_u32(bp + 8);
      }
#pragma unroll
      for (int m = 0; m < kMaxTileRows / 16; ++m) {
        if (m < n_m) {
          const T* ap = hs + (m * 16 + g) * ld + k;
          const uint32_t a0 = ld_u32(ap), a1 = ld_u32(ap + 8 * ld);
          const uint32_t a2 = ld_u32(ap + 8), a3 = ld_u32(ap + 8 * ld + 8);
#pragma unroll
          for (int n = 0; n < kN; ++n)
            mma_bf16(acc[m][n], a0, a1, a2, a3, b0[n], b1[n]);
        }
      }
    }
    const int nr = L.n_red + 1;
#pragma unroll
    for (int m = 0; m < kMaxTileRows / 16; ++m)
      if (m < n_m)
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int i = (m * 16 + g) * kR + n * 8 + 2 * q;
          red[i * nr + warp] = acc[m][n][0];
          red[(i + 1) * nr + warp] = acc[m][n][1];
          red[(i + 8 * kR) * nr + warp] = acc[m][n][2];
          red[(i + 8 * kR + 1) * nr + warp] = acc[m][n][3];
        }
  } else {
    constexpr int kJB = kR / 4;
    const int n_share = L.n_red;           // shares of the columns
    const int sh = tid % n_share, ob = tid / n_share;
    const int tb = (ob / kJB) * 4, jb = (ob % kJB) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c = sh; c < dl / 4; c += n_share) {
      float4 hv[4], uv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hv[i] = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(hs) + (tb + i) * ld + 4 * c);
        uv[i] = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(ut) + (jb + i) * ld + 4 * c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(hv[i].x, uv[j].x, a);
          a = fmaf(hv[i].y, uv[j].y, a);
          a = fmaf(hv[i].z, uv[j].z, a);
          a = fmaf(hv[i].w, uv[j].w, a);
          acc[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[((tb + i) * kR + jb + j) * (n_share + 1) + sh] = acc[i][j];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // this block's P_rank, sent to slot `rank` of every block of the cluster
  for (int i = tid; i < R * kR; i += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < L.n_red; ++q) sum += red[i * (L.n_red + 1) + q];
    for (int q = 0; q < C; ++q)
      cluster.map_shared_rank(part, q)[rank * R * kR + i] = sum;
  }
  cluster.sync();   // every block's partial P has arrived everywhere

  // P = sum of the cluster's partials in rank order, then P W
  for (int i = tid; i < R * kR; i += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < C; ++q) sum += part[q * R * kR + i];
    pfull[i] = sum;
  }
  __syncthreads();
  for (int i = tid; i < R * kR; i += kThreads) {
    const int t = i / kR, j = i % kR;
    float sum = 0.f;   // P and W are zero past r
#pragma unroll
    for (int k = 0; k < kR; ++k) sum += pfull[t * kR + k] * ws[k * kR + j];
    pwt[j * R + t] = sum;
  }
  __syncthreads();

  // out = H + (P W) U^T: 4 rows x one 16-byte chunk of columns a thread,
  // each chunk of U^T read once for the 4 rows
  const int chunks = dl / V;
  for (int i = tid; i < (R / 4) * chunks; i += kThreads) {
    const int c = i % chunks, tr = (i / chunks) * 4;
    if (tr >= n_t) continue;
    const int k = c * V;
    float acc[4][V];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[e][v] = 0.f;
#pragma unroll 4
    for (int j = 0; j < r; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pwt + j * R + tr);
      const uint4 raw = *reinterpret_cast<const uint4*>(ut + j * ld + k);
      const T* uv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float uf = to_f(uv[v]);
        acc[0][v] = fmaf(p.x, uf, acc[0][v]);
        acc[1][v] = fmaf(p.y, uf, acc[1][v]);
        acc[2][v] = fmaf(p.z, uf, acc[2][v]);
        acc[3][v] = fmaf(p.w, uf, acc[3][v]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (tr + e < n_t) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(hs + (tr + e) * ld + k);
        const T* hv = reinterpret_cast<const T*>(&raw);
        uint4 res;
        T* ov = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int v = 0; v < V; ++v)
          ov[v] = from_f<T>(to_f(hv[v]) + acc[e][v]);
        *reinterpret_cast<uint4*>(out + (size_t)(t0 + tr + e) * D + d0 +
                                  k) = res;
      }
    }
  }
  // Nothing crosses blocks after the second cluster barrier: every partial
  // was written into its reader's shared memory before it.
}

// The tile route's launch for these shapes, or false for the rows route.
// c_force and r_force > 0 force the cluster size and the rows a tile (for
// timing and testing); 0 chooses.
bool tile_plan(int n_rows, int D, int r, int el, bool aligned, int c_force,
               int r_force, TilePlan* p) {
  if (!aligned || (D * el) % 16 != 0 || r < 1 || r > kMaxRank) return false;
  const int kR = padded_rank(r);
  int C = c_force > 0 ? c_force : (D + kSliceCols - 1) / kSliceCols;
  if (c_force <= 0) {   // at least kMinCluster blocks, none without columns
    C = C < kMinCluster ? kMinCluster : C;
    C = C < (D + 15) / 16 ? C : (D + 15) / 16;
  }
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  // where a slice does not fit, split D over more blocks
  int R, Ds;
  for (;; ++C) {
    Ds = round_up((D + C - 1) / C, 16);
    R = r_force;
    if (R <= 0) {   // the largest tile that leaves kTargetBlocks blocks
      R = 8;
      for (int cand = kMaxTileRows; cand > 8; cand /= 2)
        if ((long)((n_rows + cand - 1) / cand) * C >= kTargetBlocks) {
          R = cand;
          break;
        }
    }
    if (R != 8 && R != 16 && R != 32) return false;
    if (tile_layout(Ds, R, kR, el, C).total <= kMaxSmem) break;
    if (c_force > 0 || C == kMaxCluster) return false;
  }
  *p = TilePlan{C, R, (n_rows + R - 1) / R, Ds, kR,
                tile_layout(Ds, R, kR, el, C).total};
  return true;
}

template <typename T, int kR>
int launch_tile_k(const T* h, const T* u, const T* w, T* out, int n_rows,
                  int D, int r, const TilePlan& p, cudaStream_t s) {
  auto kernel = ssop_tile_kernel<T, kR>;
  static int allowed = 0;   // dynamic shared memory above 48 KB, once
  if (p.smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    allowed = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.tiles, 1, 1);   // cluster q: tile q
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, h, u, w, out, n_rows,
                                           D, r, p.R, p.Ds);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// route < 0 forces the rows route; otherwise (c, rows) as in tile_plan.
template <typename T>
int launch(const void* h, const void* u, const void* w, void* out, int n_rows,
           int D, int r, int route, int c, int rows, void* stream) {
  if (n_rows <= 0 || D <= 0) return 0;
  if (r < 1 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* hp = static_cast<const T*>(h);
  const T* up = static_cast<const T*>(u);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  TilePlan p;
  if (route >= 0 &&
      tile_plan(n_rows, D, r, (int)sizeof(T), aligned, c, rows, &p)) {
    switch (p.kR) {
      case 8: return launch_tile_k<T, 8>(hp, up, wp, op, n_rows, D, r, p, s);
      case 16: return launch_tile_k<T, 16>(hp, up, wp, op, n_rows, D, r, p, s);
      case 32: return launch_tile_k<T, 32>(hp, up, wp, op, n_rows, D, r, p, s);
      default: return launch_tile_k<T, 64>(hp, up, wp, op, n_rows, D, r, p, s);
    }
  }
  if (route > 0) return (int)cudaErrorInvalidValue;   // tile route refused
  const int blocks = (n_rows + kRows - 1) / kRows;
  ssop_kernel<T><<<blocks, kThreads, 0, s>>>(hp, up, wp, op, n_rows, D, r);
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
  return launch<__nv_bfloat16>(h, u, w, out, n_rows, D, r, 0, 0, 0, stream);
}

extern "C" int ssop_apply_f32(const void* h, const void* u, const void* w,
                              void* out, int n_rows, int D, int r,
                              void* stream) {
  return launch<float>(h, u, w, out, n_rows, D, r, 0, 0, 0, stream);
}

// The same with the route forced, for timing and testing the routes (the
// port itself calls the functions above): route -1 is the rows route, 1 the
// tile route (an error if these shapes cannot take it), 0 the rule; c and
// rows > 0 force the tile route's cluster size and rows a tile.
extern "C" int ssop_apply_route_bf16(const void* h, const void* u,
                                     const void* w, void* out, int n_rows,
                                     int D, int r, int route, int c, int rows,
                                     void* stream) {
  return launch<__nv_bfloat16>(h, u, w, out, n_rows, D, r, route, c, rows,
                               stream);
}

extern "C" int ssop_apply_route_f32(const void* h, const void* u,
                                    const void* w, void* out, int n_rows,
                                    int D, int r, int route, int c, int rows,
                                    void* stream) {
  return launch<float>(h, u, w, out, n_rows, D, r, route, c, rows, stream);
}

// The route a call of these shapes takes, by the rule above: out[0] is 1 for
// the tile route and 0 for the rows route; for the tile route out[1] to
// out[5] are the cluster size, rows a tile, tiles (clusters), slice width
// and shared memory in bytes.  Lets the caller check its mirror of the rule
// (kernels/ssop/ops.py) and print the grid.
extern "C" int ssop_plan(int n_rows, int D, int r, int elem_bytes,
                         int aligned, int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  TilePlan p;
  if (n_rows <= 0 || D <= 0 ||
      !tile_plan(n_rows, D, r, elem_bytes, aligned != 0, 0, 0, &p))
    return 0;
  out[0] = 1;
  out[1] = p.C;
  out[2] = p.R;
  out[3] = p.tiles;
  out[4] = p.Ds;
  out[5] = p.smem;
  return 0;
}
