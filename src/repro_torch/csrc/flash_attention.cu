// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention with grouped-query heads,
//
//     o[b, s, h, :] = sum_t softmax_t(scale q[b, s, h, :] . k[b, t, h/G, :])
//                     v[b, t, h/G, :]
//
// with a query/key head dim Dqk and a value head dim Dv: (64, 64), (128,
// 128), and (192, 128), multi-head latent attention's expanded form
// (deepseek-v2: 128 nope + 64 rope dims of q.k, 128 of v), where v is read
// at its own width (no padding to 192).
// over the unmasked t (causal: t <= s; window w > 0: t > s - w), with fp32
// scores, fp32 running row maximum m, row sum l and accumulator, and the
// output acc / max(l, 1e-30) rounded once to q's type.  It also writes m and
// l (fp32, (B, H, Sq), m in natural-log units of scale q.k) for the
// backward.  These are the semantics of the plain version in
// repro_torch/kernels/flash_attention/ref.py, with one rounding more in bf16:
// P is rounded to bf16 before P V, as the JAX package's cache-free attention
// rounds it (p.astype(v.dtype)); l is summed from the fp32 P.  A masked score
// is -inf here and contributes nothing, which is what the plain version's
// finite NEG_INF = -1e30 gives in every row that attends to at least one key.
// A row that attends to none (a window with Sq >= Sk + window) would get o =
// 0, l = 0 and m = NEG_INF here and the mean of v from the plain version, so
// the wrapper refuses such inputs; with Sk = 0 both give o = 0, l = 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _attn_kernel (flash_attention_bhsd), which walks a (B*H, Sq/512, Sk/512)
// grid with the kv axis innermost, keeps m, l and acc in VMEM scratch across
// kv steps, maps GQA in its index maps and needs tile-multiple lengths.
//
// What bounds it on an H100: 4 Sq Sk Dh operations per (b, h) against
// (2 Sq + 2 Sk) Dh elements, so at S 512 and above the products bound it,
// and at this repository's training lengths (S 64 to 128) the bytes and the
// latency of one tile.  Two kernels, one per type, each on the hardware that
// type is meant for:
//
//   * bf16 (flash_fwd_bf16_kernel): both products on the tensor cores with
//     bf16 operands and fp32 accumulation, by wgmma (sm_90a).  A block of
//     two warpgroups (256 threads) takes 64 query rows; each warpgroup takes
//     every other kv tile of 64 rows (tiles wg, wg + 2, ..), so a long kv
//     range is walked by two independent pipelines that keep the SM's
//     tensor cores busy in turn, and a causal block's chain of tiles is half
//     as long.  At the end group 1 hands its (acc, m, l) to group 0 through
//     shared memory and group 0 merges them as one more online-softmax step.
//     In a warpgroup, warp w owns query rows 16 w .. 16 w + 15 of the
//     accumulators.  S = q K^T is eight (Dh 64: four) m64n64k16 wgmmas with
//     q and K both read from shared memory through descriptors (q is not
//     kept in registers across the kv loop: see wgmma_qk).  The online
//     softmax works on the accumulator, which has the m16n8 fragment
//     layout: a row's maximum and sum are shuffles among the 4 lanes that
//     hold it, and exp2 takes scale log2(e) folded into one FMA.  P is
//     rounded to bf16 in registers and is the A operand of P V directly (the
//     C fragments of two adjacent n8 tiles of S are the A fragment of one
//     k16 step), so P never touches shared memory; l is summed from the fp32
//     P.  P V is four m64nDk16 wgmmas (N = Dh) with V as the MN-major B
//     operand.  Tiles are stored with the 128-byte swizzle wgmma reads
//     (64-column halves of 64 rows x 128 bytes, 16-byte pieces XOR-ed by
//     row % 8).  Each warpgroup runs its K and V tiles
//     through a ring of two stages filled by 16-byte cp.async copies: its
//     tile i + 1 is in flight while tile i's products run.  Shared memory is
//     q 16 KB + 2 groups x 2 stages x (K 16 + V 16) KB = 144 KB at Dh 128
//     and q 24 KB + 2 x 2 x (K 24 + V 16) KB = 184 KB (+ 1 KB to align) at
//     (192, 128), where S takes twelve k16 steps and P V the same four
//     m64n128k16 wgmmas as at 128 (one block an SM, 8 warps).  Blocks of the
//     heaviest query tiles (most kv tiles under a causal mask) are launched
//     first.  The output goes through the (by then free) q tile in shared
//     memory so that it leaves in 16-byte stores.
//   * f32 (flash_fwd_f32_kernel): the federation runs f32 and its parity
//     checks need products that are not rounded to TF32, so both products
//     are exact fp32 FMAs on the CUDA cores (67 TFLOP/s at most): no TF32,
//     no 3xTF32.  The design keeps those FMAs fed: 128 threads, each with a
//     register tile of 8 query rows x 4 kv columns of S and 8 rows x Dh/16
//     columns of O, fed by float4 reads from shared memory (12 reads per
//     128 FMAs; rows padded by 16 bytes so that float4 reads of 8 rows hit 8
//     different bank groups; rows Dqk + 4 or Dv + 4 floats apart).  K and V
//     have a buffer each, refilled in turn
//     by 16-byte cp.async copies: K of tile j + 1 is in flight while P V of
//     tile j runs, V of tile j + 1 while S of tile j + 1 runs.  P goes
//     through shared memory.  72 KB of shared memory and at most 170
//     registers at Dh 64 (bert-base), so three blocks share an SM and the
//     federation's 384 blocks run in one wave; 151 KB at (192, 128).  Its exponentials are expf of
//     the scaled score less m, as in the plain version.
//
// Both kernels: one block per (64 query rows, head h, batch b); q, k and v
// are read in place with their (batch, sequence, head) strides (the last
// dimension contiguous; 16-byte copies need 16-byte-aligned base pointers
// and strides, which the wrapper checks); GQA maps query head h to kv head
// h / G.  Query rows >= Sq and kv rows >= Sk are zero-filled by the copies
// (src-size 0), the kv ones masked; kv tiles wholly masked for the block
// (above the causal diagonal, before the window of its first row) are
// skipped, and only tiles that cross the diagonal, the window's edge or Sk
// are masked element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                  // query rows per block
constexpr int kBlockK = 64;                  // kv rows per tile
constexpr int kThreads = 128;                // f32: 4 warps
constexpr int kGroups = 2;                   // bf16: warpgroups (kv split)
constexpr int kThreadsBf16 = 128 * kGroups;  // bf16: 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// PTX helpers (the same idioms as lora_matmul.cu, kept local to this source)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
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

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The kv tiles the block's query rows [q0, q0 + kBlockQ) attend to: from
// tile `first` (a multiple of kBlockK), `count` of them.
struct KvRange {
  int first, count;
};

__device__ __forceinline__ KvRange kv_range(int q0, int Sq, int Sk,
                                            int causal, int window) {
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int first = window > 0 ? max(0, q0 - window + 1) / kBlockK * kBlockK
                               : 0;
  return {first, k_end > first ? (k_end - first + kBlockK - 1) / kBlockK : 0};
}

// Whether tile k0 has a masked (query, kv) pair for the block's rows: it
// crosses Sk, the causal diagonal or the window's edge.
__device__ __forceinline__ bool tile_needs_mask(int k0, int q0, int Sk,
                                                int causal, int window) {
  return k0 + kBlockK > Sk || (causal && k0 + kBlockK - 1 > q0) ||
         (window > 0 && k0 <= q0 + kBlockQ - 1 - window);
}

__device__ __forceinline__ bool attends(int qp, int kp, int Sk, int causal,
                                        int window) {
  return kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Element offset of 16-byte piece `chunk` of row `row` in a bf16 tile of 64
// rows: the tile is stored as 64-column halves of 64 rows x 128 bytes, and in
// each row the pieces are XOR-swizzled by row % 8.  That is the 128-byte
// swizzle of wgmma's shared-memory operands (the tile starts 1024-byte
// aligned), and the same piece of 8 consecutive rows lies in 8 different
// groups of 4 banks, so ldmatrix reads are free of conflicts too.
__device__ __forceinline__ int swz(int row, int chunk) {
  return (chunk >> 3) * (kBlockK * 64) + row * 64 +
         (((chunk & 7) ^ (row & 7)) << 3);
}

constexpr int kHalfBytes = kBlockK * 128;  // a 64-column half of a tile

// wgmma's descriptor of a swizzled tile from `tile` on: 8-row groups are
// 1024 bytes apart (the stride byte offset); `lbo`, the leading byte offset,
// is the distance of the 64-column halves for the MN-major V operand (its N
// runs across them) and unused (16) for the K-major K operand.
__device__ __forceinline__ uint64_t tile_desc(const void* tile, int lbo) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4)      // start address
         | ((uint64_t)(lbo >> 4) << 16)      // leading byte offset
         | ((uint64_t)(1024 >> 4) << 32)     // 8-row groups
         | ((uint64_t)1 << 62);              // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma reads its A registers and writes its accumulators after it is
// issued, until the wait: these empty statements, placed after the wait,
// keep the compiler from reading the accumulators or reusing the A registers
// before it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]),
                 "+f"(d[i][3])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3])::"memory");
}

// d (64 x N fp32, N / 2 per thread, in the layout of N / 8 m16n8 C fragments
// per warp) = a (64 x 16) * b (16 x N), plus d unless `first`.
//
// S = q K^T (N 64): q and K both from shared memory, K-major, through their
// descriptors.  q is not held in registers as the A operand across the kv
// loop: that way (at Dh 64) ptxas gave q's registers to other values inside
// the loop, and from a warpgroup's second tile on S was P times K^T.
__device__ __forceinline__ void wgmma_qk(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int first) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(first));
}

// O += P V (N = Dh): P from registers (per warp the m16k16 A fragment of
// its 16 rows, made in this kv step), V the MN-major B operand (by kv row,
// its columns contiguous: the transposed B).
__device__ __forceinline__ void wgmma_pv(float (&d)[8][4],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[16][4],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DQK, int DV>
__host__ __device__ constexpr int bf16_smem_bytes() {
  // q, the K/V rings, and room to align them to 1024 bytes
  return (kBlockQ * DQK + kGroups * 2 * kBlockK * (DQK + DV)) * 2 + 1024;
}

// Copy rows [row0, row0 + 64) of a (sequence, D) bf16 slice with row stride
// `stride` into a swizzled tile, with NT threads (thread `tid`); rows >=
// n_rows are zero-filled.  Thread tid copies the 16-byte pieces tid + i NT
// of the tile in row order, stepping its row, piece, source and
// destination by NT pieces (D / 8 pieces a row: 24 at D 192).  Where NT
// pieces are a whole number of 8-row groups, a thread keeps its piece and
// its swizzle, and the destination steps by whole rows.
template <int D, int NT>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* s,
                                               const __nv_bfloat16* g,
                                               long long stride, int row0,
                                               int n_rows, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kPieces = kBlockK * kChunks;
  constexpr bool kSameSwizzle = NT % (8 * kChunks) == 0;
  static_assert(kPieces % NT == 0, "a tile's pieces split over NT");
  int r = tid / kChunks, c = tid % kChunks, d = swz(r, c);
  const __nv_bfloat16* src = g + (row0 + r) * stride + c * 8;
#pragma unroll
  for (int i = 0; i < kPieces / NT; ++i) {
    const bool ok = row0 + r < n_rows;
    cp_async16(s + d, ok ? src : g, ok ? 16 : 0);
    r += NT / kChunks;
    c += NT % kChunks;
    src += (NT / kChunks) * stride + (NT % kChunks) * 8;
    if (c >= kChunks) {
      c -= kChunks;
      ++r;
      src += stride - kChunks * 8;
    }
    d = kSameSwizzle ? d + (NT / kChunks) * 64 : swz(r, c);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int Sq, int Sk, int H, int G,
                      Strides qs, Strides ks, Strides vs, float scale,
                      int causal, int window) {
  constexpr int kKD = DQK / 16;       // k16 steps of q.k
  constexpr int kND = DV / 8;         // n8 tiles of the output
  constexpr int kNS = kBlockK / 8;    // n8 tiles of S
  constexpr int kKP = kBlockK / 16;   // k16 steps of P V
  constexpr int kTileK = kBlockK * DQK;  // elements of a K tile
  constexpr int kStage = kTileK + kBlockK * DV;  // a K tile and a V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // wgmma's swizzle needs 1024-byte aligned tiles
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;         // warpgroup: takes kv tiles wg, wg + 2, ..
  const int gt = tid % 128;         // thread within the warpgroup
  const int warp = gt / 32;         // owns query rows 16 warp .. + 15
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row and pair
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;  // heaviest first
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;
  const KvRange kr = kv_range(q0, Sq, Sk, causal, window);
  const int n_mine = (kr.count - wg + 1) / 2;  // this group's kv tiles
  // [2 stages][K, V]
  __nv_bfloat16* sk = sq + kBlockQ * DQK + wg * 2 * kStage;

  load_tile_bf16<DQK, kThreadsBf16>(sq, qb, qs.s, q0, Sq, tid);
  cp_async_commit();
  if (n_mine > 0) {
    const int k0 = kr.first + wg * kBlockK;
    load_tile_bf16<DQK, 128>(sk, kb, ks.s, k0, Sk, gt);
    load_tile_bf16<DV, 128>(sk + kTileK, vb, vs.s, k0, Sk, gt);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  fence_async_smem();  // both groups' wgmmas read it
  __syncthreads();

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g, g + 8; raw q.k
  float l_r[2] = {0.f, 0.f};                      // this lane's share
  const float sl2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // query position of rows g, g + 8

  for (int i = 0; i < n_mine; ++i) {
    const int k0 = kr.first + (wg + 2 * i) * kBlockK;
    __nv_bfloat16* skt = sk + (i & 1) * kStage;
    const __nv_bfloat16* svt = skt + kTileK;
    if (i + 1 < n_mine) {  // the group's next tile is copied under this one
      __nv_bfloat16* nxt = sk + ((i + 1) & 1) * kStage;
      load_tile_bf16<DQK, 128>(nxt, kb, ks.s, k0 + 2 * kBlockK, Sk, gt);
      load_tile_bf16<DV, 128>(nxt + kTileK, vb, vs.s, k0 + 2 * kBlockK, Sk,
                              gt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();  // this thread's copies, seen by wgmma's reads
    group_sync(wg);

    // S = q K^T on the warpgroup's tensor cores: one wgmma per k16 step,
    // q's and K's descriptors advanced 32 bytes a step inside a 64-column
    // half
    float s[kNS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      const int off = (kk / 4) * kBlockK * 64 + (kk % 4) * 16;
      wgmma_qk(s, tile_desc(sq + off, 16), tile_desc(skt + off, 16), kk == 0);
    }
    wgmma_commit_wait();
    reg_fence(s);

    if (tile_needs_mask(k0, q0, Sk, causal, window)) {
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!attends(row_a + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1), Sk,
                       causal, window))
            s[n][e] = -CUDART_INF_F;
    }

    // online softmax on the fragments: lanes 4g .. 4g + 3 hold rows g, g + 8
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ms[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r] * sl2;
      const float corr = fast_exp2(m_r[r] * sl2 - ms[r]);  // 0 while -inf
      m_r[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(fmaf(s[n][e], sl2, -ms[e >> 1]));
        l_r[e >> 1] += s[n][e];
      }

    // O += P V on the warpgroup's tensor cores: P rounded to bf16 in
    // registers is the A operand (the C fragments of n8 tiles 2 kk and
    // 2 kk + 1 are the A fragment of k16 step kk), V the MN-major B operand,
    // its descriptor advanced 16 kv rows (2 KB) a step.  The A registers are
    // read while the products run, so all are packed first.
    unsigned pa[kKP][4];
#pragma unroll
    for (int kk = 0; kk < kKP; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKP; ++kk)
      wgmma_pv(acc, pa[kk], tile_desc(svt + kk * 16 * 64, kHalfBytes));
    wgmma_commit_wait();
    reg_fence(acc);
    reg_fence(pa);
    group_sync(wg);  // this stage is free for the group's next copy
  }
  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings

  // merge: group 1 hands its (acc, m, l) to group 0 through its ring, each
  // value at (register, thread) so that the lanes read and write in order
  float* xf = reinterpret_cast<float*>(sq + kBlockQ * DQK + 2 * kStage);
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xf[(4 * n + e) * 128 + gt] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xf[(4 * kND + r) * 128 + gt] = m_r[r];
      xf[(4 * kND + 2 + r) * 128 + gt] = l_r[r];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xf[(4 * kND + r) * 128 + gt];
    const float mx = fmaxf(m_r[r], m1);
    const float ms = mx == -CUDART_INF_F ? 0.f : mx * sl2;
    const float c0 = fast_exp2(m_r[r] * sl2 - ms);
    const float c1 = fast_exp2(m1 * sl2 - ms);
    m_r[r] = mx;
    l_r[r] = l_r[r] * c0 + xf[(4 * kND + 2 + r) * 128 + gt] * c1;
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        acc[n][e] = acc[n][e] * c0 + xf[(4 * n + e) * 128 + gt] * c1;
  }

  // epilogue: the warp's rows, normalised and rounded, through its own rows
  // of the q tile (no other warp of group 0 reads them) into 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  __nv_bfloat16* so = sq;  // the warp's rows 16 warp .. 16 warp + 15
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<unsigned*>(so + swz(warp * 16 + g + 8 * r, n) +
                                   2 * t) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kND / 32; ++i) {
    const int p = lane + 32 * i;
    const int r = p / kND, c = p % kND;
    const int qp = q0 + warp * 16 + r;
    if (qp < Sq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + qp) * H + h) * DV +
                                c * 8) =
          *reinterpret_cast<const uint4*>(so + swz(warp * 16 + r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row_a + 8 * r;
      if (qp >= Sq) continue;
      const long long ml = ((long long)b * H + h) * Sq + qp;
      m_out[ml] = m_r[r] == -CUDART_INF_F ? kNegInf : m_r[r] * scale;
      l_out[ml] = l_r[r];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: exact fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLdP = kBlockK + 16;  // P rows: 16 floats apart in banks

template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;  // rows 16 bytes apart in banks, 16-byte aligned
}

template <int DQK, int DV>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (2 * kBlockQ * f32_ld<DQK>() + kBlockK * f32_ld<DV>() +
          kBlockQ * kLdP) * 4;  // q, K, V, P
}

// Copy rows [row0, row0 + 64) of a (sequence, D) f32 slice into a tile of
// rows f32_ld<D>() apart; rows >= n_rows are zero-filled.  As in
// load_tile_bf16, thread tid steps through the pieces tid + i kThreads of
// the tile in row order (D / 4 pieces a row: 48 at D 192).
template <int D>
__device__ __forceinline__ void load_tile_f32(float* s, const float* g,
                                              long long stride, int row0,
                                              int n_rows) {
  constexpr int kChunks = D / 4;
  constexpr int kPieces = kBlockK * kChunks;
  static_assert(kPieces % kThreads == 0, "a tile's pieces split evenly");
  int r = (int)threadIdx.x / kChunks, c = (int)threadIdx.x % kChunks;
  const float* src = g + (row0 + r) * stride + c * 4;
#pragma unroll
  for (int i = 0; i < kPieces / kThreads; ++i) {
    const bool ok = row0 + r < n_rows;
    cp_async16(s + r * f32_ld<D>() + c * 4, ok ? src : g, ok ? 16 : 0);
    r += kThreads / kChunks;
    c += kThreads % kChunks;
    src += (kThreads / kChunks) * stride + (kThreads % kChunks) * 4;
    if (c >= kChunks) {
      c -= kChunks;
      ++r;
      src += stride - kChunks * 4;
    }
  }
}

// Dh 64 (bert-base) keeps three blocks on an SM: 72 KB of shared memory and
// at most 170 registers each
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK == 64 ? 3 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Sq, int Sk, int H, int G, Strides qs, Strides ks,
                     Strides vs, float scale, int causal, int window) {
  constexpr int LD = f32_ld<DQK>();   // q and K rows
  constexpr int LDV = f32_ld<DV>();   // V rows
  constexpr int kRows = 8;        // query rows per thread: ty + 8 i
  constexpr int kCols = 4;        // kv columns per thread: tx + 16 j
  constexpr int kOut = DV / 64;   // float4 output groups: 4 tx + 64 c
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                // [kBlockQ][LD]
  float* sk = sq + kBlockQ * LD;   // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;   // [kBlockK][LDV]
  float* sp = sv + kBlockK * LDV;  // [kBlockQ][kLdP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;  // a half warp shares ty
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / G) * ks.h;
  const float* vb = v + b * vs.b + (h / G) * vs.h;
  const KvRange kr = kv_range(q0, Sq, Sk, causal, window);

  // K and V have a buffer each, refilled in turn: K of tile j + 1 is copied
  // while P V of tile j runs, V of tile j + 1 while S of tile j + 1 runs
  load_tile_f32<DQK>(sq, qb, qs.s, q0, Sq);
  if (kr.count > 0) load_tile_f32<DQK>(sk, kb, ks.s, kr.first, Sk);
  cp_async_commit();
  if (kr.count > 0) load_tile_f32<DV>(sv, vb, vs.s, kr.first, Sk);
  cp_async_commit();

  float acc[kRows][4 * kOut];
  float m_i[kRows], l_i[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kOut; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < kr.count; ++j) {
    const int k0 = kr.first + j * kBlockK;
    const bool more = j + 1 < kr.count;
    cp_async_wait<1>();  // K of tile j (and q) has landed; V may be in flight
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[i][jj] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DQK; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (ty + 8 * i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(sk + (tx + 16 * jj) * LD +
                                                  d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }
    __syncthreads();  // K is free
    if (more) load_tile_f32<DQK>(sk, kb, ks.s, k0 + kBlockK, Sk);
    cp_async_commit();

    const bool masked = tile_needs_mask(k0, q0, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + 8 * i;
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        s[i][jj] = (!masked || attends(q0 + row, k0 + tx + 16 * jj, Sk,
                                       causal, window))
                       ? s[i][jj] * scale
                       : -CUDART_INF_F;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_i[i], rmax);
      const float corr = expf(m_i[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = expf(s[i][jj] - m_new);  // a masked score gives 0
        sp[row * kLdP + tx + 16 * jj] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * corr + rsum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kOut; ++c) acc[i][c] *= corr;
    }
    cp_async_wait<1>();  // V of tile j has landed (K of j + 1 may not)
    __syncthreads();     // and P: a row is written and read by one half warp

#pragma unroll 1
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] =
            *reinterpret_cast<const float4*>(sp + (ty + 8 * i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kOut];
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          vv[c] = *reinterpret_cast<const float4*>(sv + (kk + u) * LDV +
                                                   4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kOut; ++c) {
            acc[i][4 * c] = fmaf(p, vv[c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(p, vv[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // V and P are free
    if (more) load_tile_f32<DV>(sv, vb, vs.s, k0 + kBlockK, Sk);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block (q when no tile ran)

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + s) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * c) = make_float4(
          acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
          acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
    if (tx == 0) {
      const long long ml = ((long long)b * H + h) * Sq + s;
      m_out[ml] = m_i[i];
      l_out[ml] = l_i[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int B, int Sq, int Sk, int H, int KV, Strides qs,
             Strides ks, Strides vs, float scale, int causal, int window,
             cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int bytes =
      kBf16 ? bf16_smem_bytes<DQK, DV>() : f32_smem_bytes<DQK, DV>();
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    cudaError_t e;
    if constexpr (kBf16)
      e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    else
      e = cudaFuncSetAttribute(flash_fwd_f32_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // query tiles in grid z, launched last-first: under a causal mask the
  // heaviest tiles start first
  const dim3 grid(H, B, (Sq + kBlockQ - 1) / kBlockQ);
  if constexpr (kBf16)
    flash_fwd_bf16_kernel<DQK, DV><<<grid, kThreadsBf16, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(m),
        static_cast<float*>(l), Sq, Sk, H, H / KV, qs, ks, vs, scale, causal,
        window);
  else
    flash_fwd_f32_kernel<DQK, DV><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(m),
        static_cast<float*>(l), Sq, Sk, H, H / KV, qs, ks, vs, scale, causal,
        window);
  return (int)cudaGetLastError();
}

// 16-byte copies: base pointers 16-byte aligned, strides whole 16-byte pieces
bool aligned16(const void* p, long long sb, long long ss, long long sh,
               int elem) {
  const long long vec = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % vec == 0 &&
         ss % vec == 0 && sh % vec == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, float scale, int causal, int window,
           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || B > 65535 || Sk < 0 ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int el = (int)sizeof(T);
  if (!aligned16(q, q_sb, q_ss, q_sh, el) ||
      !aligned16(k, k_sb, k_ss, k_sh, el) ||
      !aligned16(v, v_sb, v_ss, v_sh, el) ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64)
    return launch_d<T, 64, 64>(q, k, v, o, m, l, B, Sq, Sk, H, KV, qs, ks,
                               vs, scale, causal, window, s);
  if (D == 128 && Dv == 128)
    return launch_d<T, 128, 128>(q, k, v, o, m, l, B, Sq, Sk, H, KV, qs, ks,
                                 vs, scale, causal, window, s);
  if (D == 192 && Dv == 128)
    return launch_d<T, 192, 128>(q, k, v, o, m, l, B, Sq, Sk, H, KV, qs, ks,
                                 vs, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes.  q (B, Sq, H, D), k (B, Sk, KV, D) and v
// (B, Sk, KV, Dv) are device pointers read with the given element strides of
// their batch, sequence and head dimensions; the last dimension is
// contiguous, and the pointers and strides are whole 16-byte pieces.  o is a
// contiguous (B, Sq, H, Dv) tensor of q's type; m and l are contiguous fp32
// (B, H, Sq).  (D, Dv) is (64, 64), (128, 128) or (192, 128), and H a
// multiple of KV.  window <= 0 means no window.  Returns the
// launch's cudaGetLastError() (or the error of setting the kernel's
// shared-memory size, or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments it does not take).
#define FLASH_C_API(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      void* m, void* l, int B, int Sq, int Sk, int H, int KV, \
                      int D, int Dv, long long q_sb, long long q_ss,          \
                      long long q_sh,                                         \
                      long long k_sb, long long k_ss, long long k_sh,         \
                      long long v_sb, long long v_ss, long long v_sh,         \
                      float scale, int causal, int window, void* stream) {    \
    return launch<T>(q, k, v, o, m, l, B, Sq, Sk, H, KV, D, Dv, q_sb, q_ss,   \
                     q_sh,                                                    \
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,       \
                     window, stream);                                         \
  }

FLASH_C_API(flash_attention_fwd_bf16, __nv_bfloat16)
FLASH_C_API(flash_attention_fwd_f32, float)
