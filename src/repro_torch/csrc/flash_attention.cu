// Flash attention forward (online softmax) for NVIDIA Hopper, sm_90a:
// tensor cores fed by TMA.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (_kernel).  It computes what
// that kernel computes: per (batch, q head) with kv head = q head / rep
// (GQA, MQA), scores = (q . k) * scale, soft-capped (cap * tanh(s / cap))
// BEFORE the causal, prefix-LM and sliding-window masks, masked scores set to -1e30,
// an online softmax with a float32 running max m, sum l and accumulator,
// and out = acc / max(l, 1e-30) written in q's dtype.  For training it also
// writes each row's log-sum-exp m + log(l) (float32), which the backward in
// flash_attention_bwd.cu reads; inference passes no buffer for it.  KV tiles that are
// wholly masked for the q tile (past the causal frontier, older than the
// window) are skipped, as the TPU kernel's pl.when guard skips them.  Unlike
// the TPU kernel it needs no divisibility: a ragged sequence length is
// masked (padded keys score -1e30, padded query rows are not written), and
// Sk may differ from S (cross-attention).  The prefix-LM mask of the JAX
// package's attention (`_mask` in src/repro/models/attention.py), which the
// TPU kernel lacks, is here too: under `causal` a key is also allowed where
// kpos < prefix_len, and the window still applies after that.  So a row's
// causal frontier is max(qpos, prefix_len - 1), computed once: the masks
// cost what they cost without a prefix.
//
// What bounds it on the H100: at serving lengths (S <= 256) a call is a few
// MFLOP per head and sits near launch latency; from S ~ 1024 it is bound by
// operations, two matrix products per tile.  So the products run on the
// tensor cores and the loads are asynchronous:
//
// - One CTA per (q tile of 64 rows, q head, batch), 160 threads: one
//   consumer warpgroup (warps 0-3, 16 q rows a warp) and one producer warp.
//   The grid is (heads, batch, q tiles) with the q tile reversed, so the
//   longest causal tiles are launched first.
// - The producer's lane 0 loads the Q tile once by TMA, then keeps the K and
//   V tiles of the live range in flight in a ring of 2-3 stages in shared
//   memory, each stage guarded by a `full` mbarrier (TMA transaction bytes)
//   and an `empty` one (the 128 consumers' arrivals).
// - Shared tiles use the 128-byte swizzle, so a tile is split along the head
//   dim into slabs of 128 bytes (64 bf16 or 32 float), one TMA box each.
//   The head dim is zero-padded to an instantiated width (64 / 128 / 256
//   bf16, 32 / 64 / 128 / 256 float) by TMA's out-of-bounds fill.
// - bfloat16: S = Q.K^T by `wgmma` m64n64k16 with both operands in shared
//   memory (K-major), f32 accumulate in registers.  Softcap, then masks (only
//   on tiles that cross the causal diagonal, the window edge or the ragged
//   end), then the online softmax in registers: in the accumulator layout a
//   thread holds two rows, so row reductions are shuffles over a quad.  P is
//   rounded to bf16 in registers and is the A operand of the second `wgmma`
//   (m64n64k16 per 64-wide slab of the head dim); V is B from shared memory,
//   stored (key, d), i.e. MN-major, read with the transpose bit.
// - float32: 3xTF32 on `mma.sync.m16n8k8` (each operand split as
//   hi = tf32(x), lo = tf32(x - hi), and hi.hi + hi.lo + lo.hi summed in
//   f32, which keeps float32 accuracy where one TF32 product does not).
//   mma.sync rather than wgmma: tf32 wgmma takes K-major operands only, so
//   V would have to be transposed, and every hi / lo split of a B operand
//   written back, into shared memory for each tile; mma.sync reads both
//   operands from registers, splits them there, and its fragments read the
//   swizzled tiles without bank conflicts.  Scores and P reuse one register
//   layout (the m16n8 accumulator), as in the bf16 path, with the key order
//   inside each 8-key block permuted so that P needs no shuffle.  The three
//   products of a pair are issued as three passes over all column blocks,
//   so that consecutive mma.sync never share an accumulator (three in a row
//   on one stall the warp on the tensor core's latency).  At widths <= 64
//   the split Q fragments stay in registers across key tiles.  Head-dim
//   steps wholly in the padding are skipped.
// - The softcap's tanh is tanhf for float32; for bf16 it is 1 - 2 / (e^2y
//   + 1) on the special-function unit, about 1e-7 absolute.
// - No software pipelining inside the warpgroup: issuing the next tile's
//   Q . K^T before this tile's softmax (with K and V on separate barriers)
//   ran slower at S 1024-4096 on the H100, where two CTAs an SM already
//   interleave one's softmax with the other's wgmma.
//
// No setmaxnreg: the producer is one warp of five, so giving its registers
// to the consumers buys little; instead the instantiations that fit two
// CTAs per SM in shared memory are compiled for two (at most 200 registers
// a thread), the others for one (255).  A wait on an mbarrier that does not
// complete within seconds traps, so a fault in the pipeline ends the launch
// with an error instead of hanging the card.
//
// Host side: the three CUtensorMaps (q, k, v) are encoded per call (the
// pointers change) with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that no link against libcuda is needed, and
// passed as __grid_constant__ parameters.  Tensors are read through any
// (batch, head, seq) strides that are multiples of 16 bytes with a
// unit-stride head dim, so the model's (b, s, h, d) layout needs no copy;
// the output is written through its strides.  The launch plan (width, tile
// rows, stages, shared memory) comes from the Python wrapper's
// `launch_plan`, and the launcher refuses a plan that differs from its
// instantiation.  It takes PyTorch's current stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() (or the encode's error)
// for the wrapper.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                    // q rows per CTA
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSlabBytes = 128;            // one 128-byte swizzle row
constexpr float kNegInf = -1e30f;
constexpr float kLseEmpty = 1e30f;         // lse of a row with no allowed key
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int HDP, int BK, int STAGES>
struct Shape {
  static constexpr int kSlabW = kSlabBytes / (int)sizeof(T);
  static constexpr int kSlabs = HDP / kSlabW;
  static constexpr int kQSlab = kBQ * kSlabBytes;   // bytes of a Q slab
  static constexpr int kKSlab = BK * kSlabBytes;    // bytes of a K or V slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKSlab;  // one of K, V per stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = kQBytes + STAGES * kStageBytes;
  // barriers, and slack to align the base to the swizzle's 1024 bytes
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(HDP % kSlabW == 0, "width is whole slabs");
  static_assert(BK % 16 == 0 && BK <= 64, "key tile");
};

struct Params {
  void* o;
  float* lse;          // (B, H, S) row log-sum-exp for the backward, or null
  int64_t ob, oh, os;  // output strides in elements
  int S, Sk, hd, rep, n_qtiles;
  float scale, softcap, inv_softcap;
  int causal, window, prefix_len;
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties the registers to this point of the program, so that the compiler
// neither reads them before an asynchronous wgmma has written them nor
// writes them after it was issued.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
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

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B in
// shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
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
// waits on the one before it (three in a row on one accumulator would stall
// the warp on the tensor core's latency).
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
// slab_bytes apart; key = row & 7, the swizzle's XOR (the callers know it
// per thread, so it is not recomputed per load).
__device__ __forceinline__ float ld_swz(const unsigned char* tile, int slab_bytes,
                                        int row, int d, int key) {
  const int slab = d >> 5, c = d & 31;
  const int off = slab * slab_bytes + row * kSlabBytes + (((c >> 2) ^ key) << 4) +
                  ((c & 3) << 2);
  return *reinterpret_cast<const float*>(tile + off);
}

// tanh for the softcap.  float32: tanhf.  bfloat16: 1 - 2 / (e^2y + 1) on
// the special-function unit (ex2 and a fast divide), absolute error about
// 1e-7, three orders inside what bf16 P keeps; at +-inf it gives +-1.
template <typename T>
__device__ __forceinline__ float softcap_tanh(float y) {
  if constexpr (sizeof(T) == 2) {
    return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * y) + 1.f);
  } else {
    return tanhf(y);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
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

// ------------------------------------------------------------- the kernel
//
// Register layout shared by both paths (the m16n8 accumulator, which is
// also wgmma's m64nN layout for warp w): thread (warp w, lane = 4 g + t)
// holds, for each 8-column block j, entries 4j + {0, 1} of row 16 w + g at
// columns 8j + 2t + {0, 1}, and entries 4j + {2, 3} of row 16 w + g + 8.

template <typename T, int HDP, int BK, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_fwd(__grid_constant__ const CUtensorMap tq,
          __grid_constant__ const CUtensorMap tk,
          __grid_constant__ const CUtensorMap tv, const Params p) {
  using L = Shape<T, HDP, BK, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                    // Q slabs
  const uint32_t kv_s = base + L::kQBytes;      // stages: K slabs, V slabs
  const uint32_t bar_q = base + L::kBarOff;
  const uint32_t bar_full = bar_q + 8;          // STAGES of them
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = p.n_qtiles - 1 - (int)blockIdx.z;  // longest causal tiles first
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ - 1, p.S - 1);
  const int kvh = h / p.rep;

  // the causal frontier of the tile's first row: every row sees the prefix
  const int frontier = max(q0, p.prefix_len - 1);

  // live KV tiles for this q tile: [kt_lo, kt_lo + n_tiles)
  int kt_hi = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_hi = min(kt_hi, max(q_last, p.prefix_len - 1) / BK + 1);
  int kt_lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;  // oldest key any row may see
    if (first > 0) kt_lo = first / BK;
  }
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------- producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int s = 0; s < L::kSlabs; ++s)
        tma_load(q_s + s * L::kQSlab, &tq, bar_q, s * L::kSlabW, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, use = it / STAGES;
        if (use > 0) mbar_wait(bar_empty + 8 * st, (use - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t ks = kv_s + st * L::kStageBytes, vs = ks + L::kKVBytes;
        const int k0 = (kt_lo + it) * BK;
        mbar_expect_tx(full, L::kStageBytes);
        for (int s = 0; s < L::kSlabs; ++s) {
          tma_load(ks + s * L::kKSlab, &tk, full, s * L::kSlabW, k0, kvh, b);
          tma_load(vs + s * L::kKSlab, &tv, full, s * L::kSlabW, k0, kvh, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;                  // rows r0 and r0 + 8
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const int klim0 = max(qpos0, p.prefix_len - 1);  // the rows' causal frontiers
  const int klim1 = max(qpos1, p.prefix_len - 1);
  constexpr int NS = BK / 2;                     // score entries per thread
  constexpr int NO = HDP / 2;                    // output entries per thread
  float sacc[NS];
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);

  // float32, width <= 64: the Q fragments, split once, stay in registers
  // (64 at width 64) for every key tile; wider ones are read per tile
  constexpr bool kQRegs = sizeof(T) == 4 && HDP <= 64;
  uint32_t qhi[kQRegs ? HDP / 8 : 1][4], qlo[kQRegs ? HDP / 8 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk) {
      const int d = 8 * kk + t;
      split_tf32(ld_swz(smem, L::kQSlab, r0, d, g), qhi[kk][0], qlo[kk][0]);
      split_tf32(ld_swz(smem, L::kQSlab, r0 + 8, d, g), qhi[kk][1], qlo[kk][1]);
      split_tf32(ld_swz(smem, L::kQSlab, r0, d + 4, g), qhi[kk][2], qlo[kk][2]);
      split_tf32(ld_swz(smem, L::kQSlab, r0 + 8, d + 4, g), qhi[kk][3], qlo[kk][3]);
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt_lo + it) * BK;
    const uint32_t ks = kv_s + st * L::kStageBytes, vs = ks + L::kKVBytes;
    mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);

    // ---- S = Q . K^T
    if constexpr (sizeof(T) == 2) {
      fence_regs<NS>(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk & 3) << 5;  // 16 bf16 = 32 bytes along the row
        const uint64_t da = smem_desc(q_s + (kk >> 2) * L::kQSlab + off);
        const uint64_t db = smem_desc(ks + (kk >> 2) * L::kKSlab + off);
        wgmma_ss(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(sacc);
    } else {
      const unsigned char* kt_s = smem + (ks - base);
#pragma unroll
      for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
      // head-dim steps of 8 past hd only multiply zero padding: skipped
#pragma unroll
      for (int kk = 0; kk < HDP / 8; ++kk) {
        if (8 * kk >= p.hd) break;
        const int d = 8 * kk + t;
        uint32_t ahi[4], alo[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[i] = qhi[kk][i];
            alo[i] = qlo[kk][i];
          }
        } else {
          split_tf32(ld_swz(smem, L::kQSlab, r0, d, g), ahi[0], alo[0]);
          split_tf32(ld_swz(smem, L::kQSlab, r0 + 8, d, g), ahi[1], alo[1]);
          split_tf32(ld_swz(smem, L::kQSlab, r0, d + 4, g), ahi[2], alo[2]);
          split_tf32(ld_swz(smem, L::kQSlab, r0 + 8, d + 4, g), ahi[3], alo[3]);
        }
        uint32_t bhi[BK / 8][2], blo[BK / 8][2];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          split_tf32(ld_swz(kt_s, L::kKSlab, 8 * j + g, d, g), bhi[j][0], blo[j][0]);
          split_tf32(ld_swz(kt_s, L::kKSlab, 8 * j + g, d + 4, g), bhi[j][1], blo[j][1]);
        }
        mma_3xtf32<BK / 8>(sacc, ahi, alo, bhi, blo);
      }
    }

    // ---- scale, softcap, masks, online softmax (rows r0: e < 2, r0 + 8: e >= 2)
    const bool need_mask =
        (k0 + BK > p.Sk) ||
        (p.causal && k0 + BK - 1 > frontier) ||
        (p.window > 0 && q_last - k0 >= p.window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = sacc[i] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * softcap_tanh<T>(x * p.inv_softcap);
      sacc[i] = x;
    }
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        const int klim = (i & 2) ? klim1 : klim0;
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= klim;
        if (p.window > 0) ok = ok && (qpos - kpos < p.window);
        if (!ok) sacc[i] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sacc[i]);
      else mx0 = fmaxf(mx0, sacc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    // (s - m) first: where a row has seen only masked keys, s = m = -1e30
    // and the difference is exactly 0, as in the plain version's softmax
    float s0 = 0.f, s1 = 0.f;   // this thread's part of the row sums
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float e = exp2f((sacc[i] - ((i & 2) ? mn1 : mn0)) * kLog2e);
      sacc[i] = e;
      if (i & 2) s1 += e;
      else s0 += e;
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= (i & 2) ? alpha1 : alpha0;

    // ---- O += P . V
    if constexpr (sizeof(T) == 2) {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      fence_regs<NO>(oacc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // 16 keys = two 8-row groups of 1024 bytes
          const uint64_t db = smem_desc(vs + s * L::kKSlab + kk * 2048);
          wgmma_rs(oacc + 32 * s, pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(oacc);
    } else {
      const unsigned char* vt_s = smem + (vs - base);
#pragma unroll
      for (int kb = 0; kb < BK / 8; ++kb) {
        // A column t <-> key 2t, column t + 4 <-> key 2t + 1 of this block
        uint32_t ahi[4], alo[4];
        split_tf32(sacc[4 * kb + 0], ahi[0], alo[0]);
        split_tf32(sacc[4 * kb + 2], ahi[1], alo[1]);
        split_tf32(sacc[4 * kb + 1], ahi[2], alo[2]);
        split_tf32(sacc[4 * kb + 3], ahi[3], alo[3]);
        const int key = 8 * kb + 2 * t;
        // column blocks in groups of up to 8 (64 columns); groups wholly
        // past hd only multiply zero padding: skipped
        constexpr int G = HDP / 8 < 8 ? HDP / 8 : 8;
#pragma unroll
        for (int n0 = 0; n0 < HDP / 8; n0 += G) {
          if (8 * n0 >= p.hd) break;
          uint32_t bhi[G][2], blo[G][2];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const int d = 8 * (n0 + j) + g;
            split_tf32(ld_swz(vt_s, L::kKSlab, key, d, 2 * t), bhi[j][0], blo[j][0]);
            split_tf32(ld_swz(vt_s, L::kKSlab, key + 1, d, 2 * t + 1), bhi[j][1],
                       blo[j][1]);
          }
          mma_3xtf32<G>(oacc + 4 * n0, ahi, alo, bhi, blo);
        }
      }
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // ---- epilogue: out = acc / max(l, 1e-30), rows < S and columns < hd
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (p.lse != nullptr && t == 0) {
    // m + log(l) of the scaled, soft-capped, masked scores; a row that saw
    // no allowed key (m stayed -1e30) gets a sentinel whose P is 0
    float* lp = p.lse + ((int64_t)b * gridDim.x + h) * p.S;
    if (qpos0 < p.S) lp[qpos0] = m0 == kNegInf ? kLseEmpty : m0 + logf(l0);
    if (qpos1 < p.S) lp[qpos1] = m1 == kNegInf ? kLseEmpty : m1 + logf(l1);
  }
  T* op = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int nb = 0; nb < HDP / 8; ++nb) {
    const int col = 8 * nb + 2 * t;
    if (col < p.hd) {
      if (qpos0 < p.S)
        store2(op + qpos0 * p.os + col, oacc[4 * nb] / d0, oacc[4 * nb + 1] / d0);
      if (qpos1 < p.S)
        store2(op + qpos1 * p.os + col, oacc[4 * nb + 2] / d1, oacc[4 * nb + 3] / d1);
    }
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

template <typename T, int HDP, int BK, int STAGES, int MINB>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, int H, int smem, cudaStream_t stream) {
  using L = Shape<T, HDP, BK, STAGES>;
  if (smem != L::kSmem) return kErrPlan;
  auto kern = flash_fwd<T, HDP, BK, STAGES, MINB>;
  static bool attr_set[64] = {};  // per device: the shared-memory opt-in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  dim3 grid(H, B, p.n_qtiles);
  kern<<<grid, kThreads, L::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v, o in that order; the head dim has stride 1.
// lse: null, or a (B, H, S) float32 buffer for each row's log-sum-exp.
// width / tile_k / stages / smem: the wrapper's launch plan.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int KVH, int S, int Sk, int hd,
                        const int64_t* strides, float scale, int causal,
                        int window, int prefix_len, float softcap, int width, int tile_k,
                        int stages, int smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > width || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  static const EncodeTiled enc = lookup_encode();
  if (enc == nullptr) return kErrNoEncode;
  const int slab_w = dtype == 0 ? 32 : 64;
  CUtensorMap tq, tk, tv;
  int rc = encode(enc, &tq, dtype, q, hd, S, H, B, strides, slab_w, kBQ);
  if (rc == 0) rc = encode(enc, &tk, dtype, k, hd, Sk, KVH, B, strides + 3, slab_w, tile_k);
  if (rc == 0) rc = encode(enc, &tv, dtype, v, hd, Sk, KVH, B, strides + 6, slab_w, tile_k);
  if (rc != 0) return rc;
  Params p;
  p.o = o;
  p.lse = lse;
  p.ob = strides[9];
  p.oh = strides[10];
  p.os = strides[11];
  p.S = S;
  p.Sk = Sk;
  p.hd = hd;
  p.rep = H / KVH;
  p.n_qtiles = (S + kBQ - 1) / kBQ;
  p.scale = scale;
  p.softcap = softcap;
  p.inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.causal = causal;
  p.window = window;
  p.prefix_len = prefix_len;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (width == 64 && tile_k == 64 && stages == 3)
      return launch<__nv_bfloat16, 64, 64, 3, 2>(tq, tk, tv, p, B, H, smem, s);
    if (width == 128 && tile_k == 64 && stages == 2)
      return launch<__nv_bfloat16, 128, 64, 2, 2>(tq, tk, tv, p, B, H, smem, s);
    if (width == 256 && tile_k == 64 && stages == 3)
      return launch<__nv_bfloat16, 256, 64, 3, 1>(tq, tk, tv, p, B, H, smem, s);
  } else if (dtype == 0) {
    if (width == 32 && tile_k == 64 && stages == 3)
      return launch<float, 32, 64, 3, 2>(tq, tk, tv, p, B, H, smem, s);
    if (width == 64 && tile_k == 64 && stages == 2)
      return launch<float, 64, 64, 2, 2>(tq, tk, tv, p, B, H, smem, s);
    if (width == 128 && tile_k == 64 && stages == 3)
      return launch<float, 128, 64, 3, 1>(tq, tk, tv, p, B, H, smem, s);
    if (width == 256 && tile_k == 32 && stages == 2)
      return launch<float, 256, 32, 2, 1>(tq, tk, tv, p, B, H, smem, s);
  }
  return kErrPlan;
}

}  // extern "C"
