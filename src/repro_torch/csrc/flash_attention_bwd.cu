// Flash attention backward for NVIDIA Hopper, sm_90a: dq, dk and dv of the
// forward in flash_attention.cu, from q, k, v, the forward's output o, the
// output's gradient dO and the forward's row log-sum-exp (lse).
//
// The TPU path has no Pallas backward: JAX differentiates the XLA
// `blockwise_attention` (src/repro/models/attention.py:136-139), whose
// jax.checkpoint over each query block recomputes the scores in the
// backward.  This kernel is the port's counterpart of that recompute.  Per
// (batch, q head) with kv head = q head / rep, with x = (q . k) * scale,
// soft-capped (y = cap * tanh(x / cap)), masked like the forward (causal,
// prefix-LM, window, ragged S and Sk):
//
//   P  = exp(y - lse)          (0 where masked; lse comes from the forward)
//   D  = sum_d dO . O          (per row, float32)
//   dP = dO . V^T
//   dY = P * (dP - D),  dX = dY * (1 - tanh^2) under softcap, else dY
//   dq = scale * dX . K,  dk = scale * dX^T . Q,  dv = P^T . dO
//
// A row with no allowed key has the forward's sentinel lse = 1e30, so its
// P, and with it every gradient it sends, is 0.
//
// What bounds it on the H100: operations, five products of S x Sk x hd per
// head (halved under causal), so the products run on the tensor cores and
// the tiles arrive by TMA while the warpgroups compute.  Deterministic, with
// no atomics: two kernels, each owning what it writes, so S and dP are
// computed twice (seven products where five would do, the price of
// determinism without a cross-CTA order):
//
// - dQ (launched first): one CTA per (q tile of 64 x QWG rows, q head,
//   batch, key split), QWG consumer warpgroups (64 q rows each) and the
//   producer threads.  One producer thread loads the Q and dO tiles once, then streams
//   the K and V tiles of the CTA's share of the q tile's walk (the forward's
//   walk) through a ring of stages, each guarded by a `full` mbarrier (TMA
//   transaction bytes) and an `empty` one (the consumers' arrivals).  While
//   the first loads fly, the consumers compute D = rowsum(dO . O) of their
//   rows from global memory and write (lse, D) for every row of the tile,
//   padded rows included (lse 1e30, D 0), into a (B, H, S_pad, 2) float32
//   scratch for the dK / dV kernel: D has no pass of its own.  Per key tile:
//   S = Q . K^T and dP = dO . V^T, then P and dS in registers, then
//   dQ += dS . K.  The q tiles are launched last one first (the longest
//   causal walks first).
// - dK / dV: one CTA per (key tile of 64 x KWG keys, kv head, batch, split,
//   column half), KWG consumer warpgroups (64 keys each) and the producer
//   threads.  K and V are loaded once; the producer streams, for each (q head
//   of the group, q tile of BQ rows) of the CTA's share of the walk, the Q
//   and dO tiles by TMA and the tile's (lse, D) pairs by a bulk copy.  Per
//   step: S^T = K . Q^T and dP^T = V . dO^T as two wgmma groups; P^T (in
//   registers) and dV += P^T . dO run while dP^T is still on the tensor
//   cores, then dS^T and dK += dS^T . Q.  The `rep` q heads of a GQA / MQA
//   group are summed in registers.
// - A grid that fills the card: where (key tiles x kv heads x batch) is
//   small (MQA, GQA, short key ranges), the (head, q tile) list of a key
//   tile is cut into `split_kv` contiguous shares, one CTA each, which write
//   float32 partial dK / dV; where (q tiles x heads x batch) is small and
//   the key range long (cross-attention), the key tiles of a q tile are cut
//   into `split_q` shares writing float32 partial dQ.  A third small kernel
//   sums the partials in split order (fixed: two calls are bit-equal),
//   scales and converts them.  At width 256 the dK / dV columns are cut in
//   two halves (`CS`), one CTA each (both recompute S and dP), so that the
//   accumulators fit the registers.
// - bfloat16: every product is `wgmma` with float32 accumulators in
//   registers.  S^T / S and dP^T / dP are m64nNk16 with both operands
//   K-major in 128-byte-swizzled shared memory (N = BQ keys or q rows);
//   head-dim k-steps of 16 wholly past hd are skipped.  P and dS are
//   rounded to bf16 in registers and are the A operand of the second
//   products (the accumulator layout is the A fragment's), with Q, dO or K
//   as B read MN-major (transpose bit), per 64-column slab of the head dim;
//   width 80 (stablelm-3b's head dim) ends in a slab of N = 16, so no
//   product multiplies padding.
// - float32: 3xTF32 on `mma.sync.m16n8k8` with round-to-nearest-free hi /
//   lo splits (hi = tf32(x), lo = tf32(x - hi), hi.hi + hi.lo + lo.hi), the
//   forward's scheme; one TF32 term fails 5e-5.  P and dS are A operands
//   straight from the accumulator layout, with the K index of each 8-block
//   permuted so that they need no shuffle; k-steps and column blocks wholly
//   past hd are skipped.
// - Each warpgroup masks element by element only on the tiles the forward
//   would mask, and skips a step whose q tile and 64 keys share no allowed
//   pair (it still waits for and releases the stage).
//
// Registers: with two consumer warpgroups the producer is a whole warpgroup
// (384 threads, compiled for 168 registers a thread, one CTA an SM) that
// hands 144 registers a thread to the consumers by setmaxnreg (240 each):
// setmaxnreg moves registers only within the CTA's own allocation, so a
// lone producer warp (288 threads) would leave the consumers at 168.  Where
// the accumulators need more (bf16 dK / dV at widths 128 and 256, and the
// dQ kernel at 256, float32 dK / dV at 128 and 256) the CTA has one consumer
// warpgroup and a producer warp (160 threads, 255 registers), which ran
// faster on the H100 than two warpgroups whose accumulators spilled.  The
// tiling of each width (`dispatch` below) was chosen by timing variants on
// the card (scripts/tune_flash_bwd.py).  A wait on an
// mbarrier that does not complete within seconds traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
//
// Host side: one C entry point encodes the eight tensor maps (q, k, v, dO,
// with the boxes of each kernel), launches dQ, dK / dV and, where a split
// writes partials, the reduction, on PyTorch's current stream; it never
// synchronises, allocates nothing (the wrapper passes the scratch), refuses
// a plan that differs from the instantiation, and returns the first
// cudaGetLastError() that is not 0.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWG = 128;           // threads of a consumer warpgroup
constexpr int kSlabBytes = 128;    // one 128-byte swizzle row
constexpr float kLseEmpty = 1e30f; // lse of a padded row or a row with no key
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

// Producer threads: a warp beside one consumer warpgroup; a whole
// warpgroup beside two, because setmaxnreg moves registers only within the
// CTA's own allocation: 384 threads are compiled for 168 registers each
// (one CTA an SM), the producer warpgroup gives back 144 of them and the
// consumers take 72 more, 240.
template <int NWG>
constexpr int producer_threads() {
  return NWG == 2 ? kWG : 32;
}

struct Params {
  const void *o, *dO;
  void *dq, *dk, *dv;
  float *dq_part, *dk_part, *dv_part;  // float32 partials (split > 1), else unused
  const float* lse;                    // (B, H, S)
  float* ld;                           // (B, H, s_pad, 2): lse log2(e), D
  // (batch, head, seq) element strides of q, k, v, o, dO, dq, dk, dv
  int64_t st[8][3];
  int B, H, KVH, S, Sk, hd, rep, s_pad, split_kv, split_q;
  float scale, softcap, inv_softcap;
  float scale_log2, cap_log2;  // scale and softcap times log2(e)
  int causal, window, prefix_len;
};

// dK / dV kernel: KWG warpgroups of 64 keys, q tiles of BQ rows, column
// halves CS.  Shared memory: K slabs, V slabs, STAGES x (Q slabs, dO slabs),
// STAGES x (lse, D) of BQ rows, the mbarriers.
template <typename T, int W, int KWG, int BQ, int STAGES, int CS>
struct KvShape {
  static constexpr int kSlabW = kSlabBytes / (int)sizeof(T);
  static constexpr int kSlabs = (W + kSlabW - 1) / kSlabW;
  static constexpr int kBK = 64 * KWG;
  static constexpr int kKSlab = kBK * kSlabBytes;
  static constexpr int kQSlab = BQ * kSlabBytes;
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kLdBytes = 8 * BQ;
  static constexpr int kStageOff = 2 * kKBytes;
  static constexpr int kLdOff = kStageOff + STAGES * 2 * kQBytes;
  static constexpr int kBarOff = kLdOff + STAGES * kLdBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int kWC = W / CS;  // dK / dV columns of a CTA
  static constexpr int kThreads = KWG * kWG + producer_threads<KWG>();
  static_assert(BQ % 16 == 0 && BQ <= 64, "q tile");
  static_assert(CS == 1 || (kWC % 64 == 0 && W % 64 == 0), "column halves are whole slabs");
};

// dQ kernel: QWG warpgroups of 64 q rows, key tiles of BK keys.  Shared
// memory: Q slabs, dO slabs, STAGES x (K slabs, V slabs), D of the rows, the
// mbarriers.
template <typename T, int W, int QWG, int BK, int STAGES>
struct QShape {
  static constexpr int kSlabW = kSlabBytes / (int)sizeof(T);
  static constexpr int kSlabs = (W + kSlabW - 1) / kSlabW;
  static constexpr int kBQ = 64 * QWG;
  static constexpr int kQSlab = kBQ * kSlabBytes;
  static constexpr int kKSlab = BK * kSlabBytes;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kStageOff = 2 * kQBytes;
  static constexpr int kDOff = kStageOff + STAGES * 2 * kKBytes;
  static constexpr int kBarOff = kDOff + 4 * kBQ;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int kThreads = QWG * kWG + producer_threads<QWG>();
  static_assert(BK % 16 == 0 && BK <= 64, "key tile");
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete.  A phase that does
// not complete within 4 s means a fault in the pipeline: trap.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int row, int head,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Synchronise the 128 threads of one warpgroup (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWG) : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (1024 bytes: the next 8-row
// group; only the stride one is read for the tiles used here), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups pending
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The register hand-over of a CTA with two consumer warpgroups (see
// producer_threads).
template <int NWG>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
}
template <int NWG>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
}

// Ties the registers to this point of the program, so that the compiler
// neither reads them before an asynchronous wgmma has written them nor
// writes them after it was issued.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A in registers (bf16 pairs), B in
// shared memory MN-major (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 inputs, f32 accumulate.  Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi, lo tf32 (low 13 mantissa bits zero); x - hi is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h)) & 0xffffe000u;
}

// c[4j..4j+3] += a . b_j in 3xTF32 for N column blocks j: the small cross
// terms first, then hi . hi, each pass over all N blocks, so that no product
// waits on the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t (*bhi)[2],
                                           const uint32_t (*blo)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c + 4 * j, alo, bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c + 4 * j, ahi, blo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c + 4 * j, ahi, bhi[j]);
}

// float at (row, d) of a 128-byte-swizzled float tile whose slabs are
// slab_bytes apart; key = row & 7, the swizzle's XOR.
__device__ __forceinline__ float ld_swz(const unsigned char* tile, int slab_bytes,
                                        int row, int d, int key) {
  const int slab = d >> 5, c = d & 31;
  const int off = slab * slab_bytes + row * kSlabBytes + (((c >> 2) ^ key) << 4) +
                  ((c & 3) << 2);
  return *reinterpret_cast<const float*>(tile + off);
}

// The forward's tanh for the softcap, so that P here is the forward's P.
template <typename T>
__device__ __forceinline__ float softcap_tanh(float y) {
  if constexpr (sizeof(T) == 2) {
    return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * y) + 1.f);
  } else {
    return tanhf(y);
  }
}

// acc + the dot product of two 16-byte chunks of T
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
      acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u),
                 acc);
    } else {
      acc = fmaf(__uint_as_float(x[i]), __uint_as_float(y[i]), acc);
    }
  }
  return acc;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dS = pf (dP - D) for a packed bf16 pair of pf, packed again in place
__device__ __forceinline__ uint32_t ds_pair(uint32_t pf, float dp0, float dp1, float d0,
                                            float d1) {
  return pack_bf16(__uint_as_float(pf << 16) * (dp0 - d0),
                   __uint_as_float(pf & 0xffff0000u) * (dp1 - d1));
}

// ------------------------------------------------------------ the masks

__device__ __forceinline__ bool allowed(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= max(qpos, p.prefix_len - 1);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// Does some pair of rows q0 .. q_last and keys k0 .. k_last meet the masks?
// (The allowed keys of row q are (q - window, max(q, prefix_len - 1)], both
// ends growing with q.)
__device__ __forceinline__ bool tiles_meet(const Params& p, int q0, int q_last, int k0,
                                          int k_last) {
  bool ok = q0 <= q_last && k0 <= k_last;
  if (p.causal) ok = ok && k0 <= max(q_last, p.prefix_len - 1);
  if (p.window > 0) ok = ok && k_last >= q0 - p.window + 1;
  return ok;
}

// The forward's test (`tile_needs_mask`): must the scores of keys k0 ..
// k0 + bk - 1 be masked element by element for rows q0 .. q_last?
__device__ __forceinline__ bool needs_mask(const Params& p, int k0, int bk, int q0,
                                           int q_last) {
  return (k0 + bk > p.Sk) || (p.causal && k0 + bk - 1 > max(q0, p.prefix_len - 1)) ||
         (p.window > 0 && q_last - k0 >= p.window);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, 2^-22 relative
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P of one score s = q . k from lse2 = lse log2(e), 0 where masked; pf =
// P (1 - tanh^2) under the softcap (CAP), else P, so that dS = pf (dP - D).
// One FFMA and one ex2 without the softcap.
template <typename T, bool CAP>
__device__ __forceinline__ float prob(const Params& p, float s, float lse2, bool masked,
                                     float& pf) {
  if constexpr (CAP) {
    const float th = softcap_tanh<T>(s * p.scale * p.inv_softcap);
    const float pr = masked ? 0.f : ex2(fmaf(p.cap_log2, th, -lse2));
    pf = pr * (1.f - th * th);
    return pr;
  } else {
    const float pr = masked ? 0.f : ex2(fmaf(s, p.scale_log2, -lse2));
    pf = pr;
    return pr;
  }
}

// f(mask, cap) with both flags as compile-time constants: the elementwise
// pass of a tile is compiled four times, so that an unmasked tile tests no
// position and only a soft-capped call computes a tanh.
template <typename F>
__device__ __forceinline__ void with_flags(bool mask, bool cap, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (mask) f(Y{}, Y{}); else f(N{}, Y{});
  } else {
    if (mask) f(Y{}, N{}); else f(N{}, N{});
  }
}

// ---------------------------------------------- products of one warpgroup
//
// Register layout (the m16n8 accumulator, which is also wgmma's m64nN
// layout for warp w): thread (warp w, lane = 4 g + t) holds, for each
// 8-column block j, entries 4j + {0, 1} of row 16 w + g at columns
// 8j + 2t + {0, 1}, and entries 4j + {2, 3} of row 16 w + g + 8.

// bf16: acc[64 x N] = A[64 x W] . B[N x W]^T, A's and B's slabs K-major in
// shared memory (a, b: the first row's slab-0 address).  No branch between
// the products: control flow around wgmma makes ptxas copy the accumulators
// and wait after every product (so a head dim below the instantiated width
// multiplies its zero padding; the widths are those of the configurations).
template <int N, int KSTEPS>
__device__ __forceinline__ void nt_wgmma(float* acc, uint32_t a, int a_slab, uint32_t b,
                                         int b_slab) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk & 3) << 5;  // 16 bf16 = 32 bytes along the row
    wgmma_ss<N>(acc, smem_desc(a + (kk >> 2) * a_slab + off),
                smem_desc(b + (kk >> 2) * b_slab + off), kk > 0);
  }
}

// bf16: acc += A[64 x 16 KSTEPS] . B[16 KSTEPS x cols] over the column slabs
// s0 .. s0 + NSL - 1 of width W, A in registers, B's slabs MN-major in shared
// memory; a last slab narrower than 64 columns (W % 64) is one product of
// N = W % 64.  No branch between the products (see nt_wgmma).
template <int W, int NSL, int KSTEPS>
__device__ __forceinline__ void pn_wgmma(float* acc, const uint32_t (*a)[4], uint32_t b,
                                         int b_slab, int s0) {
#pragma unroll
  for (int i = 0; i < NSL; ++i) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // 16 rows = two 8-row groups of 1024 bytes
      const uint64_t db = smem_desc(b + (s0 + i) * b_slab + kk * 2048);
      if (W % 64 == 0 || 64 * (i + 1) <= W) {
        wgmma_rs<64>(acc + 32 * i, a[kk], db);
      } else {
        wgmma_rs<(W % 64 == 0 ? 64 : W % 64)>(acc + 32 * i, a[kk], db);
      }
    }
  }
}

// float32: acc[16 x 8 NB] = A[a_row .. a_row + 15, :hd] . B[8j + g, :hd]^T
// for this warp, in 3xTF32; both 128-byte-swizzled float tiles; k-steps of 8
// past hd skipped.
template <int NB, int KSTEPS>
__device__ __forceinline__ void nt_mma(float* acc, const unsigned char* a, int a_slab,
                                       int a_row, const unsigned char* b, int b_slab,
                                       int hd, int g, int t) {
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    if (8 * kk >= hd) break;
    const int d = 8 * kk + t;
    uint32_t ahi[4], alo[4];
    split_tf32(ld_swz(a, a_slab, a_row + g, d, g), ahi[0], alo[0]);
    split_tf32(ld_swz(a, a_slab, a_row + g + 8, d, g), ahi[1], alo[1]);
    split_tf32(ld_swz(a, a_slab, a_row + g, d + 4, g), ahi[2], alo[2]);
    split_tf32(ld_swz(a, a_slab, a_row + g + 8, d + 4, g), ahi[3], alo[3]);
    uint32_t bhi[NB][2], blo[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      split_tf32(ld_swz(b, b_slab, 8 * j + g, d, g), bhi[j][0], blo[j][0]);
      split_tf32(ld_swz(b, b_slab, 8 * j + g, d + 4, g), bhi[j][1], blo[j][1]);
    }
    mma_3xtf32<NB>(acc, ahi, alo, bhi, blo);
  }
}

__host__ __device__ constexpr int group_of(int n) {  // the largest divisor of n that is at most 8
  return n % 8 == 0 ? 8 : n % 5 == 0 ? 5 : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// float32: acc[16 x 8 NBO] += P[16 x 8 KB] . B[8 KB rows x columns c0 ..] for
// this warp, in 3xTF32.  P is in the accumulator layout of the product
// before: its column 2t of each 8-block is the A fragment's k index t, 2t + 1
// is t + 4, so B's rows are read in that order.  Column groups at or past hd
// skipped.
template <int KB, int NBO>
__device__ __forceinline__ void pn_mma(float* acc, const float* pm, const unsigned char* b,
                                       int b_slab, int c0, int hd, int g, int t) {
  constexpr int G = group_of(NBO);
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t ahi[4], alo[4];
    split_tf32(pm[4 * kb + 0], ahi[0], alo[0]);
    split_tf32(pm[4 * kb + 2], ahi[1], alo[1]);
    split_tf32(pm[4 * kb + 1], ahi[2], alo[2]);
    split_tf32(pm[4 * kb + 3], ahi[3], alo[3]);
    const int row = 8 * kb + 2 * t;
#pragma unroll
    for (int n0 = 0; n0 < NBO; n0 += G) {
      if (c0 + 8 * n0 >= hd) break;
      uint32_t bhi[G][2], blo[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int d = c0 + 8 * (n0 + j) + g;
        split_tf32(ld_swz(b, b_slab, row, d, 2 * t), bhi[j][0], blo[j][0]);
        split_tf32(ld_swz(b, b_slab, row + 1, d, 2 * t + 1), bhi[j][1], blo[j][1]);
      }
      mma_3xtf32<G>(acc + 4 * n0, ahi, alo, bhi, blo);
    }
  }
}

// ------------------------------------------------------------------- dQ

template <typename T, int W, int QWG, int BK, int STAGES>
__global__ void __launch_bounds__(QShape<T, W, QWG, BK, STAGES>::kThreads, 1)
flash_bwd_dq(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
             __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
             const Params p) {
  using L = QShape<T, W, QWG, BK, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, g_s = base + L::kQBytes;   // Q slabs, dO slabs
  const uint32_t st_s = base + L::kStageOff;            // stages: K slabs, V slabs
  float* d_s = reinterpret_cast<float*>(smem + L::kDOff);
  const uint32_t bar_q = base + L::kBarOff;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int n_qt = (p.S + L::kBQ - 1) / L::kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.split_q);  // longest causal tiles first
  const int chunk = blockIdx.x % p.split_q;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.rep;
  const int q0 = qt * L::kBQ, q_last = min(q0 + L::kBQ - 1, p.S - 1);
  // the forward's walk for this q tile, and this CTA's share of it
  int kt_hi = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_hi = min(kt_hi, max(q_last, p.prefix_len - 1) / BK + 1);
  const int kt_lo = p.window > 0 ? max(q0 - p.window + 1, 0) / BK : 0;
  const int nk = max(kt_hi - kt_lo, 0);
  const int j0 = kt_lo + nk * chunk / p.split_q, j1 = kt_lo + nk * (chunk + 1) / p.split_q;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, QWG * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= QWG * kWG) {
    // ---------------------------------------------------- producer threads
    producer_regs<QWG>();
    if (threadIdx.x == QWG * kWG) {
      mbar_expect_tx(bar_q, 2 * L::kQBytes);
      for (int s = 0; s < L::kSlabs; ++s) {
        tma_load(q_s + s * L::kQSlab, &tq, bar_q, s * L::kSlabW, q0, h, b);
        tma_load(g_s + s * L::kQSlab, &tdo, bar_q, s * L::kSlabW, q0, h, b);
      }
      for (int kt = j0; kt < j1; ++kt) {
        const int n = kt - j0, st = n % STAGES, use = n / STAGES;
        if (use > 0) mbar_wait(bar_empty + 8 * st, (use - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t ks = st_s + st * 2 * L::kKBytes, vs = ks + L::kKBytes;
        mbar_expect_tx(full, 2 * L::kKBytes);
        for (int s = 0; s < L::kSlabs; ++s) {
          tma_load(ks + s * L::kKSlab, &tk, full, s * L::kSlabW, kt * BK, kvh, b);
          tma_load(vs + s * L::kKSlab, &tv, full, s * L::kSlabW, kt * BK, kvh, b);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  consumer_regs<QWG>();
  const int wg = threadIdx.x / kWG, lt = threadIdx.x % kWG;
  const int warp = lt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = (int64_t)b * p.H + h;

  // D = rowsum(dO . O) of the warpgroup's 64 rows, two threads a row, while
  // the first tiles load: 16-byte loads, eight in flight a thread (a load
  // loop of single elements waited on global memory once an element);
  // (lse, D) of every row of the tile for the dK / dV kernel (padded rows:
  // the empty-row sentinel and 0)
  {
    const int r = 64 * wg + (lt >> 1), q = q0 + r;
    constexpr int kChunks = W * (int)sizeof(T) / 16;  // 16-byte chunks of a row
    const int chunks = q < p.S ? p.hd * (int)sizeof(T) / 16 : 0;
    const uint4* o = reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.o) + b * p.st[kO][0] + h * p.st[kO][1] + q * p.st[kO][2]);
    const uint4* go = reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.dO) + b * p.st[kDO][0] + h * p.st[kDO][1] + q * p.st[kDO][2]);
    float acc = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kChunks; c0 += 8) {
      uint4 x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 2 * u + (lt & 1);
        x[u] = y[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < chunks) {
          x[u] = __ldg(o + c);
          y[u] = __ldg(go + c);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = dot16<T>(x[u], y[u], acc);
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if ((lt & 1) == 0) {
      d_s[r] = acc;
      if (chunk == 0) {
        const float lse = q < p.S ? p.lse[bh * p.S + q] : kLseEmpty;
        *reinterpret_cast<float2*>(p.ld + 2 * (bh * p.s_pad + q)) =
            make_float2(lse * kLog2e, acc);
      }
    }
  }
  wg_sync(wg);

  const int r0 = 64 * wg + 16 * warp + g;  // tile rows r0 and r0 + 8
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const float lse0 = (qpos0 < p.S ? p.lse[bh * p.S + qpos0] : kLseEmpty) * kLog2e;
  const float lse1 = (qpos1 < p.S ? p.lse[bh * p.S + qpos1] : kLseEmpty) * kLog2e;
  const float dd0 = d_s[r0], dd1 = d_s[r0 + 8];
  const int qw0 = q0 + 64 * wg, qw_last = min(qw0 + 63, p.S - 1);  // the warpgroup's rows

  constexpr int NS = BK / 2;  // score entries a thread
  constexpr int NA = W / 2;   // dQ entries a thread
  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = j0; kt < j1; ++kt) {
    const int n = kt - j0, st = n % STAGES;
    const int k0 = kt * BK;
    const uint32_t ks = st_s + st * 2 * L::kKBytes, vs = ks + L::kKBytes;
    mbar_wait(bar_full + 8 * st, (n / STAGES) & 1);
    if (tiles_meet(p, qw0, qw_last, k0, min(k0 + BK, p.Sk) - 1)) {
      float s[NS], dp[NS];
      const bool mask = needs_mask(p, k0, BK, qw0, qw_last);
      // P (1 - tanh^2) of entries i and i + 1 (rows r0: i & 2 == 0, r0 + 8:
      // i & 2 != 0)
      auto pf2 = [&](int i, auto kmask, auto kcap, float& f0, float& f1) {
        constexpr bool M = decltype(kmask)::value, C = decltype(kcap)::value;
        const int kpos = k0 + 8 * (i >> 2) + 2 * t;
        const int qpos = (i & 2) ? qpos1 : qpos0;
        const float lse = (i & 2) ? lse1 : lse0;
        prob<T, C>(p, s[i], lse, M && !allowed(p, qpos, kpos), f0);
        prob<T, C>(p, s[i + 1], lse, M && !allowed(p, qpos, kpos + 1), f1);
      };
      auto dd = [&](int i) { return (i & 2) ? dd1 : dd0; };
      if constexpr (sizeof(T) == 2) {
        // S = Q . K^T and dP = dO . V^T as two groups: P runs while dP is on
        // the tensor cores.  No other instruction writes an accumulator while
        // a group is in flight (ptxas would serialise every wgmma): P (1 -
        // tanh^2) goes to packed bf16 registers, and dS replaces it there.
        fence_regs<NS>(s);
        fence_regs<NS>(dp);
        wgmma_fence();
        nt_wgmma<BK, (W + 15) / 16>(s, q_s + wg * 64 * kSlabBytes, L::kQSlab, ks,
                                    L::kKSlab);
        wgmma_commit();
        nt_wgmma<BK, (W + 15) / 16>(dp, g_s + wg * 64 * kSlabBytes, L::kQSlab, vs,
                                    L::kKSlab);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<NS>(s);
        uint32_t da[BK / 16][4];
        with_flags(mask, p.softcap > 0.f, [&](auto km, auto kc) {
#pragma unroll
          for (int i = 0; i < NS; i += 2) {
            float f0, f1;
            pf2(i, km, kc, f0, f1);
            da[i >> 3][(i & 7) >> 1] = pack_bf16(f0, f1);
          }
        });
        wgmma_wait<0>();
        fence_regs<NS>(dp);
#pragma unroll
        for (int i = 0; i < NS; i += 2) {
          uint32_t& a = da[i >> 3][(i & 7) >> 1];
          a = ds_pair(a, dp[i], dp[i + 1], dd(i), dd(i + 1));
        }
        // dQ += dS . K
        fence_regs<NA>(dq);
        wgmma_fence();
        pn_wgmma<W, (W + 63) / 64, BK / 16>(dq, da, ks, L::kKSlab, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NA>(dq);
      } else {
        nt_mma<BK / 8, (W + 7) / 8>(s, smem, L::kQSlab, 64 * wg + 16 * warp,
                                    smem + (ks - base), L::kKSlab, p.hd, g, t);
        nt_mma<BK / 8, (W + 7) / 8>(dp, smem + (g_s - base), L::kQSlab, 64 * wg + 16 * warp,
                                    smem + (vs - base), L::kKSlab, p.hd, g, t);
        with_flags(mask, p.softcap > 0.f, [&](auto km, auto kc) {
#pragma unroll
          for (int i = 0; i < NS; i += 2) {  // dS
            float f0, f1;
            pf2(i, km, kc, f0, f1);
            dp[i] = f0 * (dp[i] - dd(i));
            dp[i + 1] = f1 * (dp[i + 1] - dd(i));
          }
        });
        pn_mma<BK / 8, W / 8>(dq, dp, smem + (ks - base), L::kKSlab, 0, p.hd, g, t);
      }
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // ---- epilogue: rows < S, columns < hd
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= p.hd) continue;
    if (p.split_q == 1) {
      T* out = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1] + col;
      if (qpos0 < p.S)
        store2(out + qpos0 * p.st[kDQ][2], dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      if (qpos1 < p.S)
        store2(out + qpos1 * p.st[kDQ][2], dq[4 * j + 2] * p.scale,
               dq[4 * j + 3] * p.scale);
    } else {
      float* out = p.dq_part + ((int64_t)chunk * p.B * p.H + bh) * p.S * p.hd + col;
      if (qpos0 < p.S) store2(out + (int64_t)qpos0 * p.hd, dq[4 * j], dq[4 * j + 1]);
      if (qpos1 < p.S) store2(out + (int64_t)qpos1 * p.hd, dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------ dK and dV

template <typename T, int W, int KWG, int BQ, int STAGES, int CS>
__global__ void __launch_bounds__(KvShape<T, W, KWG, BQ, STAGES, CS>::kThreads, 1)
flash_bwd_dkv(__grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
              __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
              const Params p) {
  using L = KvShape<T, W, KWG, BQ, STAGES, CS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + L::kKBytes;   // K slabs, V slabs
  const uint32_t st_s = base + L::kStageOff;            // stages: Q slabs, dO slabs
  const uint32_t ld_s = base + L::kLdOff;               // stages: (lse, D) pairs
  const uint32_t bar_kv = base + L::kBarOff;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * STAGES;

  const int per_kt = p.split_kv * CS;
  const int kt = blockIdx.x / per_kt;  // first key tiles first: the longest causal walks
  const int chunk = (blockIdx.x % per_kt) / CS, cs = blockIdx.x % CS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * L::kBK, k_last = min(k0 + L::kBK, p.Sk) - 1;
  // the q tiles that meet a key of this tile, [qlo, qhi): the forward's walk
  // transposed (`bwd_q_tiles` in kernels/flash_attention/kernel.py)
  const int n_qt = (p.S + BQ - 1) / BQ;
  int qlo = 0, qhi = n_qt;
  if (p.causal && k0 > p.prefix_len - 1) qlo = k0 < p.S ? k0 / BQ : n_qt;
  if (p.window > 0) qhi = min(qhi, (k_last + p.window - 1) / BQ + 1);
  const int nq = max(qhi - qlo, 0);
  // this CTA's share of the (q head of the group, q tile) list
  const int items = p.rep * nq;
  const int it0 = (int)((int64_t)items * chunk / p.split_kv);
  const int it1 = (int)((int64_t)items * (chunk + 1) / p.split_kv);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, KWG * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= KWG * kWG) {
    // ---------------------------------------------------- producer threads
    producer_regs<KWG>();
    if (threadIdx.x == KWG * kWG) {
      mbar_expect_tx(bar_kv, 2 * L::kKBytes);
      for (int s = 0; s < L::kSlabs; ++s) {
        tma_load(k_s + s * L::kKSlab, &tk, bar_kv, s * L::kSlabW, k0, kvh, b);
        tma_load(v_s + s * L::kKSlab, &tv, bar_kv, s * L::kSlabW, k0, kvh, b);
      }
      for (int it = it0; it < it1; ++it) {
        const int n = it - it0, st = n % STAGES, use = n / STAGES;
        if (use > 0) mbar_wait(bar_empty + 8 * st, (use - 1) & 1);
        const int h = kvh * p.rep + it / nq, q0 = (qlo + it % nq) * BQ;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t qs = st_s + st * 2 * L::kQBytes, gs = qs + L::kQBytes;
        mbar_expect_tx(full, 2 * L::kQBytes + L::kLdBytes);
        for (int s = 0; s < L::kSlabs; ++s) {
          tma_load(qs + s * L::kQSlab, &tq, full, s * L::kSlabW, q0, h, b);
          tma_load(gs + s * L::kQSlab, &tdo, full, s * L::kSlabW, q0, h, b);
        }
        bulk_load(ld_s + st * L::kLdBytes,
                  p.ld + 2 * (((int64_t)b * p.H + h) * p.s_pad + q0), L::kLdBytes, full);
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  consumer_regs<KWG>();
  const int wg = threadIdx.x / kWG, warp = (threadIdx.x % kWG) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wg, kw_last = min(kw0 + 63, p.Sk - 1);  // the warpgroup's keys
  const int kpos0 = kw0 + 16 * warp + g, kpos1 = kpos0 + 8;     // this thread's two keys
  const int c0 = cs * L::kWC;                                  // the CTA's first column

  constexpr int NS = BQ / 2;       // score entries a thread
  constexpr int NA = L::kWC / 2;   // dK (and dV) entries a thread
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = it0; it < it1; ++it) {
    const int n = it - it0, st = n % STAGES;
    const int q0 = (qlo + it % nq) * BQ, q_last = min(q0 + BQ - 1, p.S - 1);
    const uint32_t qs = st_s + st * 2 * L::kQBytes, gs = qs + L::kQBytes;
    const float* lds = reinterpret_cast<const float*>(smem + L::kLdOff + st * L::kLdBytes);
    mbar_wait(bar_full + 8 * st, (n / STAGES) & 1);
    if (tiles_meet(p, q0, q_last, kw0, kw_last)) {
      float s[NS], dp[NS];
      const bool mask = needs_mask(p, kw0, 64, q0, q_last);
      // (lse2, D) of q rows 8j + 2t and 8j + 2t + 1 of the tile: the columns
      // of entries 4j .. 4j + 3
      auto ld4 = [&](int j) {
        return *reinterpret_cast<const float4*>(lds + 2 * (8 * j + 2 * t));
      };
      // P^T of entries 4j .. 4j + 3 (keys kpos0, kpos0, kpos1, kpos1), and in
      // f P^T (1 - tanh^2)
      auto pr4 = [&](int j, auto kmask, auto kcap, float* pm, float* f) {
        constexpr bool M = decltype(kmask)::value, C = decltype(kcap)::value;
        const float4 l = ld4(j);
        const int qpos = q0 + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pm[e] = prob<T, C>(p, s[4 * j + e], (e & 1) ? l.z : l.x,
                             M && !allowed(p, qpos + (e & 1), (e & 2) ? kpos1 : kpos0), f[e]);
      };
      if constexpr (sizeof(T) == 2) {
        // S^T = K . Q^T and dP^T = V . dO^T (rows: keys, columns: q rows) as
        // two groups: P^T and the dV product run while dP^T is on the tensor
        // cores; then dS^T and the dK product (the CTA's columns).  No other
        // instruction writes an accumulator while a group is in flight
        // (ptxas would serialise every wgmma): P^T and P^T (1 - tanh^2) go to
        // packed bf16 registers, and dS^T replaces the second.
        fence_regs<NS>(s);
        fence_regs<NS>(dp);
        wgmma_fence();
        nt_wgmma<BQ, (W + 15) / 16>(s, k_s + wg * 64 * kSlabBytes, L::kKSlab, qs,
                                    L::kQSlab);
        wgmma_commit();
        nt_wgmma<BQ, (W + 15) / 16>(dp, v_s + wg * 64 * kSlabBytes, L::kKSlab, gs,
                                    L::kQSlab);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<NS>(s);
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        with_flags(mask, p.softcap > 0.f, [&](auto km, auto kc) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j) {
            float pm[4], f[4];
            pr4(j, km, kc, pm, f);
            pa[j >> 1][2 * (j & 1)] = pack_bf16(pm[0], pm[1]);
            pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pm[2], pm[3]);
            da[j >> 1][2 * (j & 1)] = pack_bf16(f[0], f[1]);
            da[j >> 1][2 * (j & 1) + 1] = pack_bf16(f[2], f[3]);
          }
        });
        // dv and dk are written by nothing but their wgmma until the fences
        // after the last wait
        wgmma_fence();
        pn_wgmma<W, (L::kWC + 63) / 64, BQ / 16>(dv, pa, gs, L::kQSlab, c0 / 64);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done; the dV product may still run
        fence_regs<NS>(dp);
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          const float4 l = ld4(j);
          uint32_t* a = &da[j >> 1][2 * (j & 1)];
          a[0] = ds_pair(a[0], dp[4 * j], dp[4 * j + 1], l.y, l.w);
          a[1] = ds_pair(a[1], dp[4 * j + 2], dp[4 * j + 3], l.y, l.w);
        }
        wgmma_fence();
        pn_wgmma<W, (L::kWC + 63) / 64, BQ / 16>(dk, da, qs, L::kQSlab, c0 / 64);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NA>(dv);
        fence_regs<NA>(dk);
      } else {
        nt_mma<BQ / 8, (W + 7) / 8>(s, smem, L::kKSlab, 64 * wg + 16 * warp,
                                    smem + (qs - base), L::kQSlab, p.hd, g, t);
        nt_mma<BQ / 8, (W + 7) / 8>(dp, smem + (v_s - base), L::kKSlab, 64 * wg + 16 * warp,
                                    smem + (qs - base) + L::kQBytes, L::kQSlab, p.hd, g, t);
        with_flags(mask, p.softcap > 0.f, [&](auto km, auto kc) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j) {
            float pm[4], f[4];
            pr4(j, km, kc, pm, f);
            const float4 l = ld4(j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dp[4 * j + e] = f[e] * (dp[4 * j + e] - ((e & 1) ? l.w : l.y));  // dS^T
              s[4 * j + e] = pm[e];                                          // P^T
            }
          }
        });
        pn_mma<BQ / 8, L::kWC / 8>(dv, s, smem + (gs - base), L::kQSlab, c0, p.hd, g, t);
        pn_mma<BQ / 8, L::kWC / 8>(dk, dp, smem + (qs - base), L::kQSlab, c0, p.hd, g, t);
      }
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // ---- epilogue: keys < Sk, columns < hd
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= p.hd) continue;
    if (p.split_kv == 1) {
      T* ok = static_cast<T*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1] + col;
      T* ov = static_cast<T*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1] + col;
      if (kpos0 < p.Sk) {
        store2(ok + kpos0 * p.st[kDK][2], dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
        store2(ov + kpos0 * p.st[kDV][2], dv[4 * j], dv[4 * j + 1]);
      }
      if (kpos1 < p.Sk) {
        store2(ok + kpos1 * p.st[kDK][2], dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
        store2(ov + kpos1 * p.st[kDV][2], dv[4 * j + 2], dv[4 * j + 3]);
      }
    } else {
      const int64_t at = (((int64_t)chunk * p.B + b) * p.KVH + kvh) * p.Sk * p.hd + col;
      if (kpos0 < p.Sk) {
        store2(p.dk_part + at + (int64_t)kpos0 * p.hd, dk[4 * j], dk[4 * j + 1]);
        store2(p.dv_part + at + (int64_t)kpos0 * p.hd, dv[4 * j], dv[4 * j + 1]);
      }
      if (kpos1 < p.Sk) {
        store2(p.dk_part + at + (int64_t)kpos1 * p.hd, dk[4 * j + 2], dk[4 * j + 3]);
        store2(p.dv_part + at + (int64_t)kpos1 * p.hd, dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------------- partial sums

// out[b, h, l, d] = mult * sum over splits c in order of part[c, b, h, l, d]
// (part contiguous, `per` elements a split), written through out's strides.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce(const float* part, int splits, int64_t per, T* out, int64_t sb, int64_t sh,
                 int64_t ss, int heads, int rows, int hd, float mult) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; 2 * i < per; i += stride) {
    float a = 0.f, c = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float2 x = reinterpret_cast<const float2*>(part + k * per)[i];
      a += x.x;
      c += x.y;
    }
    const int64_t e = 2 * i;
    const int d = (int)(e % hd);
    const int64_t r = e / hd;
    const int l = (int)(r % rows), h = (int)(r / rows % heads), bb = (int)(r / rows / heads);
    store2(out + bb * sb + h * sh + l * ss + d, a * mult, c * mult);
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                                   12000, cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                          cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// Error codes beyond the runtime's: the wrapper names them.
constexpr int kErrNoEncode = 10001;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10002;     // it refused a map (alignment, strides)
constexpr int kErrPlan = 10003;       // plan differs from every instantiation

// (d, seq, head, batch) view of a (batch, head, seq, d) tensor with element
// strides sb, sh, ss and a unit-stride d; boxes of one slab x rows.
int encode(EncodeTiled enc, CUtensorMap* map, int dtype, const void* ptr, int hd,
           int seq, int heads, int batch, const int64_t* st, int slab_w, int rows) {
  const int es = dtype == 0 ? 4 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)(st[2] * es), (cuuint64_t)(st[1] * es),
                           (cuuint64_t)(st[0] * es)};
  cuuint32_t box[4] = {(cuuint32_t)slab_w, (cuuint32_t)rows, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = enc(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The shared-memory opt-in of one kernel, once per device.
template <typename K>
cudaError_t opt_in(K kern, int smem, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

struct Tensors {
  int dtype;
  const void *q, *k, *v, *dO;
  const int64_t* strides;  // 24: (batch, head, seq) of q, k, v, o, dO, dq, dk, dv
};

// The plan, as the wrapper's `FlashBwdPlan` passes it.
enum {
  kPlanKwg = 0, kPlanBq, kPlanKvStages, kPlanCs, kPlanQwg, kPlanBk, kPlanQStages,
  kPlanSmemKv, kPlanSmemQ, kPlanSplitKv, kPlanSplitQ, kPlanLen
};

template <typename T>
int reduce(const float* part, int splits, void* out, const int64_t* st, int B, int heads,
           int rows, int hd, float mult, cudaStream_t stream) {
  const int64_t per = (int64_t)B * heads * rows * hd;
  const int64_t want = (per / 2 + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  flash_bwd_reduce<T><<<blocks, 256, 0, stream>>>(part, splits, per, static_cast<T*>(out),
                                                 st[0], st[1], st[2], heads, rows, hd, mult);
  return (int)cudaGetLastError();
}

// One instantiation: dK / dV (KWG, BQ, KV_ST, CS) and dQ (QWG, BK, Q_ST).
template <typename T, int W, int KWG, int BQ, int KV_ST, int CS, int QWG, int BK, int Q_ST>
struct Instance {
  using KL = KvShape<T, W, KWG, BQ, KV_ST, CS>;
  using QL = QShape<T, W, QWG, BK, Q_ST>;

  static bool matches(const int* plan) {
    return plan[kPlanKwg] == KWG && plan[kPlanBq] == BQ && plan[kPlanKvStages] == KV_ST &&
           plan[kPlanCs] == CS && plan[kPlanQwg] == QWG && plan[kPlanBk] == BK &&
           plan[kPlanQStages] == Q_ST && plan[kPlanSmemKv] == KL::kSmem &&
           plan[kPlanSmemQ] == QL::kSmem;
  }

  static int opt_in_both() {
    static bool done_q[64] = {}, done_kv[64] = {};
    cudaError_t e = opt_in(flash_bwd_dq<T, W, QWG, BK, Q_ST>, QL::kSmem, done_q);
    if (e == cudaSuccess)
      e = opt_in(flash_bwd_dkv<T, W, KWG, BQ, KV_ST, CS>, KL::kSmem, done_kv);
    return (int)e;
  }

  static int run(const Tensors& x, Params& p, const int* plan, cudaStream_t stream) {
    if (!matches(plan)) return kErrPlan;
    static const EncodeTiled enc = lookup_encode();
    if (enc == nullptr) return kErrNoEncode;
    const int64_t* s = x.strides;
    const int sw = KL::kSlabW;
    CUtensorMap q_q, do_q, k_q, v_q, k_kv, v_kv, q_kv, do_kv;
    int rc = encode(enc, &q_q, x.dtype, x.q, p.hd, p.S, p.H, p.B, s + 3 * kQ, sw, QL::kBQ);
    if (rc == 0) rc = encode(enc, &do_q, x.dtype, x.dO, p.hd, p.S, p.H, p.B, s + 3 * kDO, sw, QL::kBQ);
    if (rc == 0) rc = encode(enc, &k_q, x.dtype, x.k, p.hd, p.Sk, p.KVH, p.B, s + 3 * kK, sw, BK);
    if (rc == 0) rc = encode(enc, &v_q, x.dtype, x.v, p.hd, p.Sk, p.KVH, p.B, s + 3 * kV, sw, BK);
    if (rc == 0) rc = encode(enc, &k_kv, x.dtype, x.k, p.hd, p.Sk, p.KVH, p.B, s + 3 * kK, sw, KL::kBK);
    if (rc == 0) rc = encode(enc, &v_kv, x.dtype, x.v, p.hd, p.Sk, p.KVH, p.B, s + 3 * kV, sw, KL::kBK);
    if (rc == 0) rc = encode(enc, &q_kv, x.dtype, x.q, p.hd, p.S, p.H, p.B, s + 3 * kQ, sw, BQ);
    if (rc == 0) rc = encode(enc, &do_kv, x.dtype, x.dO, p.hd, p.S, p.H, p.B, s + 3 * kDO, sw, BQ);
    if (rc != 0) return rc;
    rc = opt_in_both();
    if (rc != 0) return rc;
    const int n_qt = (p.S + QL::kBQ - 1) / QL::kBQ, n_kt = (p.Sk + KL::kBK - 1) / KL::kBK;
    flash_bwd_dq<T, W, QWG, BK, Q_ST>
        <<<dim3(n_qt * p.split_q, p.H, p.B), QL::kThreads, QL::kSmem, stream>>>(
            q_q, do_q, k_q, v_q, p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    flash_bwd_dkv<T, W, KWG, BQ, KV_ST, CS>
        <<<dim3(n_kt * p.split_kv * CS, p.KVH, p.B), KL::kThreads, KL::kSmem, stream>>>(
            k_kv, v_kv, q_kv, do_kv, p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    if (p.split_q > 1) {
      rc = reduce<T>(p.dq_part, p.split_q, p.dq, s + 3 * kDQ, p.B, p.H, p.S, p.hd, p.scale,
                     stream);
      if (rc != 0) return rc;
    }
    if (p.split_kv > 1) {
      rc = reduce<T>(p.dk_part, p.split_kv, p.dk, s + 3 * kDK, p.B, p.KVH, p.Sk, p.hd,
                     p.scale, stream);
      if (rc == 0)
        rc = reduce<T>(p.dv_part, p.split_kv, p.dv, s + 3 * kDV, p.B, p.KVH, p.Sk, p.hd,
                       1.f, stream);
    }
    return rc;
  }

  // CTAs an SM, registers a thread and local (spilled) bytes of the two
  // kernels: dQ, then dK / dV
  static int occupancy(int* out) {
    int rc = opt_in_both();
    if (rc != 0) return rc;
    cudaFuncAttributes a;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], flash_bwd_dq<T, W, QWG, BK, Q_ST>, QL::kThreads, QL::kSmem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, flash_bwd_dq<T, W, QWG, BK, Q_ST>);
    if (e != cudaSuccess) return (int)e;
    out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], flash_bwd_dkv<T, W, KWG, BQ, KV_ST, CS>, KL::kThreads, KL::kSmem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, flash_bwd_dkv<T, W, KWG, BQ, KV_ST, CS>);
    if (e != cudaSuccess) return (int)e;
    out[4] = a.numRegs;
    out[5] = (int)a.localSizeBytes;
    return 0;
  }
};

// Calls F with the instantiation for (dtype, width); kErrPlan if none.
// Instance<T, width, dK / dV warpgroups, q rows a step, stages, column
// halves, dQ warpgroups, keys a step, stages>: kernels/flash_attention/
// kernel.py's BWD_TILING mirrors this list.
template <typename F>
int dispatch(int dtype, int width, F&& f) {
  if (dtype == 1) {
    if (width == 64) return f(Instance<__nv_bfloat16, 64, 2, 64, 3, 1, 2, 64, 3>());
    if (width == 80) return f(Instance<__nv_bfloat16, 80, 2, 32, 4, 1, 2, 64, 3>());
    if (width == 128) return f(Instance<__nv_bfloat16, 128, 1, 64, 2, 1, 2, 64, 3>());
    if (width == 256) return f(Instance<__nv_bfloat16, 256, 1, 64, 2, 2, 1, 64, 2>());
  } else if (dtype == 0) {
    if (width == 32) return f(Instance<float, 32, 2, 64, 3, 1, 2, 64, 3>());
    if (width == 64) return f(Instance<float, 64, 2, 64, 2, 1, 2, 64, 2>());
    if (width == 80) return f(Instance<float, 80, 2, 32, 2, 1, 2, 64, 2>());
    if (width == 128) return f(Instance<float, 128, 1, 32, 2, 1, 2, 32, 2>());
    if (width == 256) return f(Instance<float, 256, 1, 16, 2, 2, 1, 16, 2>());
  }
  return kErrPlan;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 24 element strides, (batch,
// head, seq) for q, k, v, o, dO, dq, dk, dv in that order; every head dim
// has stride 1, and q, k, v, dO are TMA-readable (16-byte aligned base and
// strides).  lse: the forward's (B, H, S) float32.  ld: (B, H, s_pad, 2)
// float32 scratch, s_pad the q rows of the dQ kernel's tiles.  dq_part /
// dk_part / dv_part: float32 scratch of split_q x (B, H, S, hd) and
// split_kv x (B, KVH, Sk, hd) (unused where the split is 1).  width and
// plan (kPlanLen ints): the wrapper's launch plan.
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dO, void* dq, void* dk, void* dv,
                        const float* lse, float* ld, float* dq_part, float* dk_part,
                        float* dv_part, int B, int H, int KVH, int S, int Sk, int hd,
                        const int64_t* strides, float scale, int causal, int window,
                        int prefix_len, float softcap, int width, int s_pad,
                        const int* plan, void* stream) {
  if (B == 0 || S == 0 || Sk == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > width || plan[kPlanSplitKv] < 1 ||
      plan[kPlanSplitQ] < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.dO = dO;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dq_part = dq_part;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.lse = lse;
  p.ld = ld;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.Sk = Sk;
  p.hd = hd;
  p.rep = H / KVH;
  p.s_pad = s_pad;
  p.split_kv = plan[kPlanSplitKv];
  p.split_q = plan[kPlanSplitQ];
  p.scale = scale;
  p.softcap = softcap;
  p.inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.scale_log2 = scale * kLog2e;
  p.cap_log2 = softcap * kLog2e;
  p.causal = causal;
  p.window = window;
  p.prefix_len = prefix_len;
  const Tensors x{dtype, q, k, v, dO, strides};
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(dtype, width, [&](auto inst) { return decltype(inst)::run(x, p, plan, s); });
}

// out[6]: the dQ kernel's CTAs an SM, registers a thread and spilled bytes,
// then the dK / dV kernel's, for the instantiation of (dtype, width).
int flash_attention_bwd_occupancy(int dtype, int width, int* out) {
  return dispatch(dtype, width, [&](auto inst) { return decltype(inst)::occupancy(out); });
}

}  // extern "C"
