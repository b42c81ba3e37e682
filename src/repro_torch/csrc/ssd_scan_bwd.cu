// Mamba-2 SSD chunked scan, backward, for NVIDIA Hopper (sm_90a): chunks and
// 64-row tiles in parallel, products on the tensor cores.
//
// Replaces JAX's autodiff of src/repro/models/ssm.py::ssd_chunked (:25),
// which the reference's train step differentiates under jax.value_and_grad
// (src/repro/launch/steps.py:59); there is no Pallas backward.  It computes
// what the plain version kernels/ssd/ref.py::ssd_bwd_ref computes: given
// dy (b, l, nh, hd) and the final state's gradient dS (b, nh, hd, ds; zero
// when null), per (batch, head) and per chunk of c rows, with cs the
// forward's prefix sums, L_ij = exp(cs_i - cs_j) for j <= i, S_in the
// state entering the chunk and dS_out the gradient of the state leaving it,
//
//   dx_j = sum_{i>=j} (C_i.B_j) L_ij dt_j dy_i + dt_j e^{cs_last-cs_j} dS_out B_j + D dy_j
//   dC_i = sum_{j<=i} (dy_i.x_j) L_ij dt_j B_j + e^{cs_i} S_in^T dy_i
//   dB_j = sum_{i>=j} (dy_i.x_j) L_ij dt_j C_i + dt_j e^{cs_last-cs_j} dS_out^T x_j
//   dS_in = e^{cs_last} dS_out + sum_i e^{cs_i} dy_i C_i^T     (in reverse over the chunks)
//   dD = sum dy.x,  ddt = direct terms + A dL/da,  dA = sum dt dL/da   (a = dt A)
//
// dL/da_k is taken in its straddling form: the intra-chunk weights W_ij =
// (C_i.B_j)(dy_i.x_j) L_ij dt_j of the pairs i >= k > j (an exclusive prefix
// along each row carried across the j tiles, then a sum down the column
// over the rows i >= k), plus the incoming-state terms of the rows i >= k,
// the state decay's term, and the outgoing-state terms of the rows j < k.
// Every partial sum holds terms of the sum it ends in.  Only exponents that
// are never positive are formed (j <= i, cs_last - cs_j, cs_i), and the
// exponent is masked before exp, as in the forward.
//
// Design: five kernels a call on PyTorch's current stream (float32: six,
// see 2b).
//
// 1. ssd_bwd_local, grid (batch x chunks, heads): each chunk's own
//    sum_i e^{cs_i} dy_i C_i^T, (e o dy)^T . C over 64-row tiles in a
//    cp.async ring, as the forward's chunk-state kernel (chunk 0's is not
//    needed and not formed);
// 2. ssd_bwd_pass, grid (hd ds / 1024, heads, batch), four state elements
//    a thread: dS_out[k] = e^{cs_last[k+1]} dS_out[k+1] + local[k+1] in
//    order from the last chunk, starting from dS (bf16: written as hi and
//    lo planes, as the forward writes S_in); and per block the partial sum
//    of <dS_out, S_in> for the state decay's term;
//    2b. float32 only: ssd_bwd_cb, grid (batch x chunks, tile pairs, 2):
//    C_i . B_j^T and B_j . C_i^T once per chunk, as the forward's float32
//    C.B^T kernel: the heads share B and C, and in 3xTF32 that product
//    formed per head and owning tile took a third of the chunk kernel's
//    operations;
// 3. ssd_bwd_chunk, grid (batch x chunks, head groups, row tiles), 128
//    threads, tile 0 first (it holds the most column products), two CTAs
//    an SM.  A CTA takes G heads one after another (G = 4, 2 or 1: the
//    plan's largest that leaves two waves) and for each of them tile t
//    twice:
//    - as column tile j = t, the i tiles >= t in order: C.B^T and dy.x^T
//      formed transposed (rows j), so that M^T = (C.B^T o L o dt_j)^T and
//      N^T are wgmma's register A operand as they stand; dx_j += M^T dy_i,
//      dB_j += N^T C_i; then the outgoing state's terms (B_j . dS_out^T,
//      x_j . dS_out), dx_j written, ddt's direct terms and U_j;
//    - as row tile i = t, the j tiles <= t in order: C.B^T, dy.x^T, dC_i +=
//      N . B_j, and the straddling prefix of W = C.B^T o N along each row
//      (pair sums, an inclusive scan over the four lanes of a quad by
//      shuffles, the 8-column blocks in order, carried across the j tiles),
//      then its column sums over this tile's rows i >= k (a butterfly over
//      the 8 lane rows of a warp, the 4 warps in order), written per row
//      tile; then the incoming state's terms (dy_i . S_in) and V_i.
//    Below the diagonal the decay is exp(cs_i - cs_e) exp(cs_e - cs_j), e
//    the j tile's last row: two factors each <= 1, 18 exps a thread, not 32.
//    The group's heads are summed in order into one dB and one dC partial
//    in registers: nh / G partials instead of nh; the fixed B_j or C_i tile
//    is loaded once for the group;
// 4. ssd_bwd_finish, grid (batch x chunks, heads): dL/da_k = the row
//    tiles' straddle partials in order + sum_{i>=k} V_i + E + sum_{j<k} U_j
//    (scans of 128 threads: own rows in order, shuffles up within a warp,
//    the 4 warps in order), ddt, and the per-chunk partials of dA and dD;
// 5. ssd_bwd_reduce: dB and dC summed over the head groups, dA and dD over
//    batch and chunks, each in a fixed order.
// No atomics: two calls are bit-equal.
//
// Products formed a call: dy.x^T twice for each causal 64-row tile pair and
// head (once as a column tile, once as a row tile: a CTA owns one tile, so
// the pair's two owners each form it), C.B^T as often in bf16 (float32:
// twice per chunk, 2b), M^T dy, N^T C and N B once, the state products of
// each tile (bf16: dS_out's and S_in's two planes each), the local state
// once per chunk, all at whole tiles and padded widths; against the
// bound's count of C.B^T once per (batch, chunk) and the rest once over
// the causal half.  kernel.py's ``bwd_products`` counts them: at
// mamba2-780m's train shape 68.5 GFLOP in bf16, 2.1 times the bound's 32.4
// (float32 3.8 times, each 3xTF32 product counted three times).
//
// The forward's values are reused, not recomputed: cs (its chunk-state
// kernel's prefix sums in XLA's blocks-of-16 order, so the decays are the
// forward's bit for bit) and the entering states S_in (bfloat16: the hi and
// lo bf16 planes its chunk scan multiplies, read as they are).
//
// Arithmetic.  bfloat16: x, B, C and dy are exact bf16 operands of
// m64n64k16 wgmma with float32 accumulators: C.B^T and dy.x^T one chain
// each (both operands K-major in shared memory), S_in^T dy_i two (the
// forward's hi and lo planes, read MN-major).  Of the float32 operands, e o
// dy (the local state) and dS_out (the pass writes its hi and lo planes)
// are split into bf16 hi + lo, two products against the exact operand:
// they feed ddt and dA, float32 outputs, which a single rounding moves past
// float32's tolerance (5e-5, dA 1e-4).  M and N feed only dx, dB and dC,
// written in bf16: each is rounded once (one product), which keeps them
// within 0.3 of the tolerance of 2e-2 and within 2.5e-3 of their largest
// entry of a hi + lo split (the CPU emulation,
// tests/test_torch_ssd_bwd_mma.py).  float32: 3xTF32 on mma.sync.m16n8k8
// with hi and lo rounded to nearest, each 8-deep step summed from zero and
// added in float32, as in ssd_scan.cu.
//
// Tiles are 64 rows in their own dtype, in the 128-byte swizzle, filled by
// 16-byte cp.async with zero fill (rows past the chunk, columns past hd or
// ds; hd is padded to 64, ds to 64 or 128): a ring of two stages in bf16
// (the state planes of the head prefetched beside the first), one in
// float32 (the state over it after the walk).  No mbarriers: a cp.async
// group cannot wait forever.  Shared memory and __launch_bounds__(128, 2)
// leave two chunk CTAs an SM at ds 128 (108 KB bf16, 100 KB float32).
//
// What bounds it on the H100: at mamba2-780m's train shape (b 4, l 1024,
// 48 heads x 64, ds 128, c 256) the function needs about 32 GFLOP (the
// causal half of the dy.x^T, M^T dy, N^T C and N B products per head, the
// four (c x hd x ds) state products) and moves about 88 MB in bf16 (x, dy,
// dx, B, C, dB, dC, dt, ddt, dS): 0.033 ms at bf16's tensor-core peak against
// 0.026 ms of HBM time, so bound by operations.  What holds this design
// above that: each CTA's chain of dependent steps (copies, products, the
// masked decay, the prefix steps) with one wgmma group in flight at a
// time; in float32, the operand splits and scalar fragment loads from the
// swizzled tiles around each mma.sync, and a 64-float dB / dC accumulator
// that leaves the registers short.
//
// Inputs are read through strides: x, B and C as views into the mixer's
// xBC activation (unit stride in their last dim, 16-byte aligned bases and
// strides, as the forward takes them); dx, dB and dC are written through
// their own strides (the wrapper hands out views of one xBC-shaped
// buffer); dy is contiguous.  The wrapper allocates outputs and scratch and
// passes its launch plan; the launcher refuses a plan that differs from its
// instantiations, never synchronises, allocates nothing, and returns
// cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kPassThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kMaxChunk = 1024;      // the finish kernel's scans: 8 rows a thread
constexpr int kErrPlan = 10003;      // plan differs from every instantiation

template <typename T, int DSP>
struct BwdTiles {
  static constexpr bool kBf = sizeof(T) == 2;
  static constexpr int kW = 128 / (int)sizeof(T);      // elements in a slab row
  static constexpr int kHBytes = kHdp / kW * kSlab;    // x or dy: 64 rows x 64
  static constexpr int kSBytes = DSP / kW * kSlab;     // B, C or a state: 64 rows x DSP
  static constexpr int kPair = kHBytes + kSBytes;
  static constexpr int kStages = kBf ? 2 : 1;
  // chunk kernel: the fixed pair, a ring of kStages pairs, then (bf16) two
  // state planes; float32's state tile lies over stage 0, after the walk
  static constexpr int kState = kBf ? (1 + kStages) * kPair : kPair;
  static constexpr int kTiles = kBf ? kState + 2 * kSBytes : (1 + kStages) * kPair;
  // cs and dt of the fixed tile and of each stage, the column sums of the
  // 4 warps, the block-sum scratch
  static constexpr int kRowFloats = 2 * kT + 2 * kStages * kT + 4 * kT + 32;
  static constexpr int kChunk = kTiles + 4 * kRowFloats + 1024;
  // local kernel: a ring of (dy, C) pairs and the cs of each
  static constexpr int kLocalStages = kBf ? 3 : 2;
  static constexpr int kLocal = kLocalStages * (kPair + 4 * kT) + 1024;
  // float32 C.B^T: a C and a B tile
  static constexpr int kCB = 2 * kSBytes + 1024;
};

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const void* dy;        // (b, l, nh, hd) contiguous, x's dtype
  const float* dstate;   // (b, nh, hd, ds) or null
  const float* cs;       // (b, nc, nh, c): the forward's prefix sums
  const void* sin;       // the forward's entering states: float32 (b, nc, nh, hd, ds),
                         // bf16 hi and lo planes (b, nc, nh, 2, hd, ds)
  float* local;          // (b, nc, nh, hd, ds) scratch
  void* dsout;           // gradient of the state leaving each chunk: float32 (b, nc, nh, hd, ds),
                         // bf16 hi and lo planes (b, nc, nh, 2, hd, ds)
  float* pE;             // (b, nc, nh, pass blocks): partial sums of <dS_out, S_in>
  float* rows;           // (b, nc, nh, 2 + nt, c): U, V, the row tiles' straddle partials
  float* pDt;            // (b, nc, nh, nt): dy_j . x_j over each column tile
  void* dx;              // x's dtype, strided
  float* ddt;            // (b, l, nh) contiguous
  float* dA;             // (nh,)
  float* dD;             // (nh,)
  void* dB;              // x's dtype, strided
  void* dC;
  float* pB;             // (b, nc, head groups, c, ds) partials of dB
  float* pC;             // ... of dC
  float* pA;             // (b, nc, nh) per-chunk partials of dA
  float* pD;             // ... of dD
  float* cbt;            // float32: C_i . B_j^T and B_j . C_i^T per (b x chunk, tile pair j <= i),
                         // 64 x 64 each in the accumulator's register order; null for bf16
  int batch, L, nh, hd, ds, c, nc, nt, group, ngroups, npass, npairs;
  // element strides: x (batch, seq, head), dt (batch, seq, head), B and C
  // (batch, seq), dx (batch, seq, head), dB and dC (batch, seq)
  int64_t xb, xl, xh, tb, tl, th, bb, bl, cb, cl, gxb, gxl, gxh, gbb, gbl, gcb, gcl;
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// two floats as one bf16 pair, each rounded once
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of k-step kk (16 columns) of a 64-row K-major bf16 tile,
// rows r0 and r0 + 8: the layout of a packed accumulator.
__device__ __forceinline__ void frag_a(uint32_t* a, const unsigned char* tile, int kk, int r0,
                                       int t) {
  const int k = 16 * kk + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(tile + swz<__nv_bfloat16>(r0, k));
  a[1] = *reinterpret_cast<const uint32_t*>(tile + swz<__nv_bfloat16>(r0 + 8, k));
  a[2] = *reinterpret_cast<const uint32_t*>(tile + swz<__nv_bfloat16>(r0, k + 8));
  a[3] = *reinterpret_cast<const uint32_t*>(tile + swz<__nv_bfloat16>(r0 + 8, k + 8));
}

// bfloat16: acc[32 x DSP / 64] += A . B, A in registers (4 k-steps of a 64 x
// 64 operand), B a 64-row MN-major tile (rows = A's columns) DSP wide.
template <int DSP>
__device__ __forceinline__ void wgmma_rb(float* acc, uint32_t (*a)[4], uint32_t b) {
#pragma unroll
  for (int s2 = 0; s2 < DSP / 64; ++s2)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc + 32 * s2, a[kk], smem_desc(b + s2 * kSlab + kk * 2048));
}

// two floats (r, e) and (r, e + 1) of a swizzled float32 tile, e even
__device__ __forceinline__ float2 ld2(const unsigned char* tile, int r, int e) {
  return *reinterpret_cast<const float2*>(tile + swz<float>(r, e));
}

// The float32 products, 3xTF32 on mma.sync.m16n8k8.  Where A comes from a
// K-major tile, A's columns t and t + 4 of each 8-deep step are k = 2t and
// 2t + 1 (B's rows follow), so a thread's two values of a row are adjacent:
// one 8-byte load.  A is split once a step for every column block.

// acc[4 NB] += A . B over the first kdim (<= 64) columns of A, rows r0, r0
// + 8 of a K-major tile; B NB column blocks of an MN-major tile.
template <int NB>
__device__ __forceinline__ void mma_ab_f32(float* acc, const unsigned char* a,
                                           const unsigned char* b, int kdim, int r0, int g,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < kHdp / 8; ++kk) {
    if (8 * kk >= kdim) break;
    const int d = 8 * kk + 2 * t;
    const float2 a0 = ld2(a, r0, d), a1 = ld2(a, r0 + 8, d);
    uint32_t ahi[4], alo[4];
    split_tf32(a0.x, ahi[0], alo[0]);
    split_tf32(a1.x, ahi[1], alo[1]);
    split_tf32(a0.y, ahi[2], alo[2]);
    split_tf32(a1.y, ahi[3], alo[3]);
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += 4) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(ld_tile<float>(b, d, 8 * (n0 + j) + g), bhi[j][0], blo[j][0]);
        split_tf32(ld_tile<float>(b, d + 1, 8 * (n0 + j) + g), bhi[j][1], blo[j][1]);
      }
      mma_3xtf32<4>(acc + 4 * n0, ahi, alo, bhi, blo);
    }
  }
}

// acc[32] = A . B^T over the first kdim columns (<= KP), A rows r0, r0 + 8
// of one K-major tile, B rows 0..63 of another.
template <int KP>
__device__ __forceinline__ void mma_abt_f32_pairs(float* acc, const unsigned char* a,
                                                  const unsigned char* b, int kdim, int r0,
                                                  int g, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP / 8; ++kk) {
    if (8 * kk >= kdim) break;
    const int d = 8 * kk + 2 * t;
    const float2 a0 = ld2(a, r0, d), a1 = ld2(a, r0 + 8, d);
    uint32_t ahi[4], alo[4];
    split_tf32(a0.x, ahi[0], alo[0]);
    split_tf32(a1.x, ahi[1], alo[1]);
    split_tf32(a0.y, ahi[2], alo[2]);
    split_tf32(a1.y, ahi[3], alo[3]);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bv = ld2(b, 8 * (n0 + j) + g, d);
        split_tf32(bv.x, bhi[j][0], blo[j][0]);
        split_tf32(bv.y, bhi[j][1], blo[j][1]);
      }
      mma_3xtf32<4>(acc + 4 * n0, ahi, alo, bhi, blo);
    }
  }
}

// acc[4 NB] += P . B, P a 64 x 64 operand in registers in the accumulator
// layout, B NB column blocks of an MN-major tile (rows = P's columns).  A's
// column t holds P's column 2t of each 8, its column t + 4 P's 2t + 1.
template <int NB>
__device__ __forceinline__ void mma_pb_f32(float* acc, const float* pv, const unsigned char* b,
                                           int g, int t) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    uint32_t ahi[4], alo[4];
    split_tf32(pv[4 * kb + 0], ahi[0], alo[0]);
    split_tf32(pv[4 * kb + 2], ahi[1], alo[1]);
    split_tf32(pv[4 * kb + 1], ahi[2], alo[2]);
    split_tf32(pv[4 * kb + 3], ahi[3], alo[3]);
    const int key = 8 * kb + 2 * t;
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += 4) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(ld_tile<float>(b, key, 8 * (n0 + j) + g), bhi[j][0], blo[j][0]);
        split_tf32(ld_tile<float>(b, key + 1, 8 * (n0 + j) + g), bhi[j][1], blo[j][1]);
      }
      mma_3xtf32<4>(acc + 4 * n0, ahi, alo, bhi, blo);
    }
  }
}

// acc[32 x DSP / 64] = 0 (+)= P . B with P (64 x 64, accumulator layout)
// rounded once to bf16 (bf16) or in 3xTF32 (float32); B MN-major, DSP wide
template <typename T, int DSP>
__device__ __forceinline__ void pb_product(float* acc, const float* pv, uint32_t b,
                                           const unsigned char* bt, int g, int t) {
  constexpr int NA = DSP / 2;
  if constexpr (sizeof(T) == 2) {
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[kk][q] = pack_bf16(pv[8 * kk + 2 * q], pv[8 * kk + 2 * q + 1]);
    fence_regs<NA>(acc);
    wgmma_fence();
    wgmma_rb<DSP>(acc, a, b);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NA>(acc);
  } else {
    mma_pb_f32<DSP / 8>(acc, pv, bt, g, t);
  }
}

// acc[32] = A . B^T over K = KP columns (both K-major 64-row tiles; the
// padding past kdim is zeros); bf16: B the sum of NS planes, one chain
template <typename T, int KP, int NS = 1>
__device__ __forceinline__ void abt_product(float* acc, uint32_t a, uint32_t b,
                                            const unsigned char* at, const unsigned char* bt,
                                            int kdim, int r0, int g, int t) {
  if constexpr (sizeof(T) == 2) {
    fence_regs<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NS; ++q) wgmma_abt<KP>(acc, a, b + q * (KP / 64) * kSlab, q > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(acc);
  } else {
    mma_abt_f32_pairs<KP>(acc, at, bt, kdim, r0, g, t);
  }
}

// acc[32 x DSP / 64] = A . S over K = hd: A a K-major 64-row tile (x_j or
// dy_i), S one or two (bf16 hi and lo) MN-major state tiles (rows p, cols s)
template <typename T, int DSP, int NS>
__device__ __forceinline__ void as_product(float* acc, uint32_t a, uint32_t s,
                                           const unsigned char* at, const unsigned char* st,
                                           int hd, int r0, int g, int t) {
  constexpr int NA = DSP / 2;
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  if constexpr (sizeof(T) == 2) {
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag_a(fa[kk], at, kk, r0, t);
    fence_regs<NA>(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NS; ++q) wgmma_rb<DSP>(acc, fa, s + q * BwdTiles<T, DSP>::kSBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NA>(acc);
  } else {
    mma_ab_f32<DSP / 8>(acc, at, st, hd, r0, g, t);
  }
}

// The sum over the 4 lanes of a quad (one row): xor 1, then 2.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// The sum over the 8 lane rows g of a warp: xor 4, 8, 16.
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Sum over the 4 warps of a 128-thread CTA of one value a warp (lane 0's),
// in order; every thread calls it, thread 0 gets the sum.
__device__ __forceinline__ float warps_sum(float v, float* red) {
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float s = ((red[0] + red[1]) + red[2]) + red[3];
  __syncthreads();
  return s;
}

// The decays L_ij = exp(cs_i - cs_j) (j <= i < c, else 0; the exponent
// masked before exp) of a 64 x 64 tile pair in the accumulator layout, rows
// from cs_r (the fixed tile) and columns from cs_c (the walked one), i0 the
// first row of the i tile.  cols_i: the columns are i (rows j), else the
// rows are.  On the diagonal pair exp of each difference; below it exp(cs_i
// - cs_e) exp(cs_e - cs_j), e the last row of the j tile (a whole tile):
// two factors each <= 1, and 18 exps a thread instead of 32.
template <bool kBf>
__device__ __forceinline__ void decay(float* lv, const float* cs_r, const float* cs_c, bool diag,
                                      int i0, int c, int r0, int t, bool cols_i) {
  auto ex = [](float d) { return kBf ? __expf(d) : expf(d); };
  const float ninf = __int_as_float(0xff800000);
  if (diag) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = r0 + ((e & 2) ? 8 : 0), col = 8 * (e >> 2) + 2 * t + (e & 1);
      const bool ok = cols_i ? row <= col && i0 + col < c : col <= row && i0 + row < c;
      lv[e] = ex(ok ? (cols_i ? cs_c[col] - cs_r[row] : cs_r[row] - cs_c[col]) : ninf);
    }
    return;
  }
  const float ce = (cols_i ? cs_r : cs_c)[kT - 1];
  float fr[2], fc[16];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    fr[hh] = cols_i ? ex(ce - cs_r[row]) : ex(i0 + row < c ? cs_r[row] - ce : ninf);
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int col = 8 * (q >> 1) + 2 * t + (q & 1);
    fc[q] = cols_i ? ex(i0 + col < c ? cs_c[col] - ce : ninf) : ex(ce - cs_c[col]);
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) lv[e] = fc[2 * (e >> 2) + (e & 1)] * fr[(e >> 1) & 1];
}

// ------------------------------------------------- 1. each chunk's own dS_in

template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_local(const BwdArgs p) {
  using L = BwdTiles<T, DSP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  constexpr int S = L::kLocalStages;
  float* sCs = reinterpret_cast<float*>(smem + S * L::kPair);  // S x 64
  const int tid = threadIdx.x;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc;
  if (k == 0) return;  // the pass never reads chunk 0's
  const int c = p.c;
  const int64_t t0 = (int64_t)k * c, bkh = (int64_t)bk * p.nh + h;
  const int64_t dyl = (int64_t)p.nh * p.hd;
  const T* dyp = static_cast<const T*>(p.dy) + ((int64_t)b * p.L + t0) * dyl + (int64_t)h * p.hd;
  const T* cp = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* csp = p.cs + bkh * c;

  auto stage = [&](int it) {  // one cp.async group, empty past the last tile
    if (it < p.nt) {
      const int s = it % S, i0 = it * kT, n = min(kT, c - i0);
      load_tile<T, kHdp>(base + s * L::kPair, dyp + i0 * dyl, dyl, n, p.hd, tid);
      load_tile<T, DSP>(base + s * L::kPair + L::kHBytes, cp + i0 * p.cl, p.cl, n, p.ds, tid);
      if (tid < kT) {
        const bool ok = tid < n;
        cp_async4(smem_u32(sCs + s * kT + tid), ok ? csp + i0 + tid : csp, ok);
      }
    }
    cp_async_commit();
  };
  for (int it = 0; it < S - 1; ++it) stage(it);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int p0 = 16 * warp + g;  // state rows p0 and p0 + 8 (the head dim)
  constexpr int NA = DSP / 2;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  auto ex = [](float d) { return sizeof(T) == 2 ? __expf(d) : expf(d); };
  const float ninf = __int_as_float(0xff800000);

  for (int it = 0; it < p.nt; ++it) {
    stage(it + S - 1);
    cp_async_wait<S - 1>();
    fence_proxy_async();
    __syncthreads();
    const int s = it % S, i0 = it * kT;
    const unsigned char* dys = smem + s * L::kPair;
    const uint32_t cs_b = base + s * L::kPair + L::kHBytes;
    // e_i = exp(cs_i), zero past the chunk (masked before exp)
    auto ev = [&](int ii) { return ex(i0 + ii < c ? sCs[s * kT + ii] : ninf); };
    if constexpr (sizeof(T) == 2) {
      // A = (e o dy)^T (rows: head dim, columns: chunk rows), split hi + lo
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ja = 16 * kk + 2 * t;
        const float e0 = ev(ja), e1 = ev(ja + 1), e8 = ev(ja + 8), e9 = ev(ja + 9);
        pack_split(ld_tile<T>(dys, ja, p0) * e0, ld_tile<T>(dys, ja + 1, p0) * e1, ahi[kk][0],
                   alo[kk][0]);
        pack_split(ld_tile<T>(dys, ja, p0 + 8) * e0, ld_tile<T>(dys, ja + 1, p0 + 8) * e1,
                   ahi[kk][1], alo[kk][1]);
        pack_split(ld_tile<T>(dys, ja + 8, p0) * e8, ld_tile<T>(dys, ja + 9, p0) * e9,
                   ahi[kk][2], alo[kk][2]);
        pack_split(ld_tile<T>(dys, ja + 8, p0 + 8) * e8, ld_tile<T>(dys, ja + 9, p0 + 8) * e9,
                   ahi[kk][3], alo[kk][3]);
      }
      fence_regs<NA>(acc);
      wgmma_fence();
      wgmma_rb<DSP>(acc, ahi, cs_b);  // C read MN-major
      wgmma_rb<DSP>(acc, alo, cs_b);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NA>(acc);
    } else {
      const unsigned char* ct = smem + (cs_b - base);
#pragma unroll
      for (int ks = 0; ks < kT / 8; ++ks) {
        if (i0 + 8 * ks >= c) break;
        const int ja = 8 * ks + t;
        const float e0 = ev(ja), e4 = ev(ja + 4);
        uint32_t ahi[4], alo[4];
        split_tf32(ld_tile<float>(dys, ja, p0) * e0, ahi[0], alo[0]);
        split_tf32(ld_tile<float>(dys, ja, p0 + 8) * e0, ahi[1], alo[1]);
        split_tf32(ld_tile<float>(dys, ja + 4, p0) * e4, ahi[2], alo[2]);
        split_tf32(ld_tile<float>(dys, ja + 4, p0 + 8) * e4, ahi[3], alo[3]);
#pragma unroll
        for (int n0 = 0; n0 < DSP / 8; n0 += 4) {
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            const int sc = 8 * (n0 + jb) + g;
            split_tf32(ld_tile<float>(ct, ja, sc), bhi[jb][0], blo[jb][0]);
            split_tf32(ld_tile<float>(ct, ja + 4, sc), bhi[jb][1], blo[jb][1]);
          }
          mma_3xtf32<4>(acc + 4 * n0, ahi, alo, bhi, blo);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }
  float* out = p.local + bkh * p.hd * p.ds;
#pragma unroll
  for (int nb = 0; nb < DSP / 8; ++nb) {
    const int col = 8 * nb + 2 * t;
    if (col < p.ds) {
      if (p0 < p.hd) store2(out + p0 * p.ds + col, acc[4 * nb], acc[4 * nb + 1]);
      if (p0 + 8 < p.hd) store2(out + (p0 + 8) * p.ds + col, acc[4 * nb + 2], acc[4 * nb + 3]);
    }
  }
}

// ------------------------------------------------- 2. reverse state pass

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass(const BwdArgs p) {
  __shared__ float red[kPassThreads / 32];
  const int64_t n = (int64_t)p.hd * p.ds;  // a multiple of 64
  const int64_t idx = 4 * ((int64_t)blockIdx.x * kPassThreads + threadIdx.x);
  const bool live = idx < n;
  const int h = blockIdx.y, b = blockIdx.z;
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  if (live && p.dstate) {
    const float4 v = *reinterpret_cast<const float4*>(p.dstate + ((int64_t)b * p.nh + h) * n + idx);
    run[0] = v.x, run[1] = v.y, run[2] = v.z, run[3] = v.w;
  }
  for (int k = p.nc - 1; k >= 0; --k) {
    const int64_t bkh = ((int64_t)b * p.nc + k) * p.nh + h;
    float v = 0.f, loc[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      float si[4];
      if constexpr (sizeof(T) == 2) {  // dS_out as hi and lo planes, S_in read from its planes
        uint32_t h0, l0, h1, l1;
        pack_split(run[0], run[1], h0, l0);
        pack_split(run[2], run[3], h1, l1);
        __nv_bfloat16* dp = static_cast<__nv_bfloat16*>(p.dsout) + bkh * 2 * n + idx;
        *reinterpret_cast<uint2*>(dp) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(dp + n) = make_uint2(l0, l1);
        const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(p.sin) + bkh * 2 * n + idx;
#pragma unroll
        for (int e = 0; e < 4; ++e) si[e] = __bfloat162float(sp[e]) + __bfloat162float(sp[n + e]);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.dsout) + bkh * n + idx) =
            make_float4(run[0], run[1], run[2], run[3]);
        const float4 sv = *reinterpret_cast<const float4*>(static_cast<const float*>(p.sin) +
                                                           bkh * n + idx);
        si[0] = sv.x, si[1] = sv.y, si[2] = sv.z, si[3] = sv.w;
      }
      v = run[0] * si[0];
#pragma unroll
      for (int e = 1; e < 4; ++e) v = v + run[e] * si[e];
      if (k > 0) {
        const float4 lv = *reinterpret_cast<const float4*>(p.local + bkh * n + idx);
        loc[0] = lv.x, loc[1] = lv.y, loc[2] = lv.z, loc[3] = lv.w;
      }
    }
    // this block's part of <dS_out, S_in>, in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = red[0];
      for (int w = 1; w < kPassThreads / 32; ++w) sum += red[w];
      p.pE[bkh * p.npass + blockIdx.x] = sum;
    }
    __syncthreads();
    if (k > 0) {
      const float carry = expf(p.cs[bkh * p.c + p.c - 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) run[e] = __fadd_rn(__fmul_rn(run[e], carry), loc[e]);
    }
  }
}

// ------------------------------------------- float32: C.B^T once per chunk

// C_i . B_j^T (blockIdx.z 0) or B_j . C_i^T (1) for one (batch x chunk,
// tile pair j <= i), in 3xTF32, written in the chunk kernel's accumulator
// order (float4 q of thread tid at q x 128 + tid): the heads share B and
// C, so the float32 chunk kernel reads them instead of forming them per
// head and per owning tile.
template <int DSP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb(const BwdArgs p) {
  using L = BwdTiles<float, DSP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int bk = blockIdx.x, pair = blockIdx.y, z = blockIdx.z;  // pair = it (it + 1) / 2 + jt
  int it = (int)((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  while (it * (it + 1) / 2 > pair) --it;
  const int jt = pair - it * (it + 1) / 2;
  const int b = bk / p.nc, k = bk - b * p.nc, c = p.c;
  const int64_t t0 = (int64_t)k * c;
  const int i0 = it * kT, j0 = jt * kT;
  const float* cpp = static_cast<const float*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* bpp = static_cast<const float*>(p.Bm) + b * p.bb + t0 * p.bl;
  // tile 0 the product's A operand, tile 1 its B
  load_tile<float, DSP>(base + z * L::kSBytes, cpp + i0 * p.cl, p.cl, min(kT, c - i0), p.ds, tid);
  load_tile<float, DSP>(base + (1 - z) * L::kSBytes, bpp + j0 * p.bl, p.bl, min(kT, c - j0),
                        p.ds, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[32];
  mma_abt_f32_pairs<DSP>(acc, smem, smem + L::kSBytes, p.ds, 16 * warp + g, g, t);
  float4* o = reinterpret_cast<float4*>(p.cbt) +
              (((int64_t)bk * p.npairs + pair) * 2 + z) * 8 * kThreads + tid;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    o[q * kThreads] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// ------------------------------------------------- 3. chunk gradients

template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk(const BwdArgs p) {
  using L = BwdTiles<T, DSP>;
  constexpr int S = L::kStages, NA = DSP / 2;
  constexpr bool kBf = L::kBf;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t fixH = base, fixS = base + L::kHBytes;       // the fixed pair
  auto ringH = [&](int s) { return base + (1 + s) * L::kPair; };
  auto ringS = [&](int s) { return ringH(s) + L::kHBytes; };
  const uint32_t stS = base + L::kState;                       // state tile(s)
  auto at = [&](uint32_t a) { return smem + (a - base); };
  float* fCs = reinterpret_cast<float*>(smem + L::kTiles);
  float* fDt = fCs + kT;
  float* rCs = fDt + kT;           // S x 64
  float* rDt = rCs + S * kT;       // S x 64
  float* sCol = rDt + S * kT;      // 4 x 64
  float* sRed = sCol + 4 * kT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // rows r0 and r0 + 8 of a tile
  const int bk = blockIdx.x, grp = blockIdx.y, tile = blockIdx.z;
  const int b = bk / p.nc, k = bk - b * p.nc, c = p.c;
  const int64_t t0 = (int64_t)k * c, n = (int64_t)p.hd * p.ds;
  const int64_t dyl = (int64_t)p.nh * p.hd;
  const int t0r = tile * kT, nrow = min(kT, c - t0r);  // the CTA's tile
  const T* bp = static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bl;
  const T* cp = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cl;
  auto ex = [](float d) { return kBf ? __expf(d) : expf(d); };
  const float ninf = __int_as_float(0xff800000);
  const int h_end = min(p.nh, (grp + 1) * p.group);
  // C_i . B_j^T (z 0, rows i) or B_j . C_i^T (z 1, rows j) of tile pair
  // (it, jt): bf16 one wgmma chain on the staged tiles, float32 read from
  // ssd_bwd_cb's output
  auto cb_product = [&](float* acc, int it, int jt, int z, uint32_t a, uint32_t bt) {
    if constexpr (kBf) {
      abt_product<T, DSP>(acc, a, bt, at(a), at(bt), p.ds, r0, g, t);
    } else {
      const float4* sp = reinterpret_cast<const float4*>(p.cbt) +
                         (((int64_t)bk * p.npairs + it * (it + 1) / 2 + jt) * 2 + z) * 8 * kThreads +
                         tid;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v4 = sp[q * kThreads];
        acc[4 * q] = v4.x;
        acc[4 * q + 1] = v4.y;
        acc[4 * q + 2] = v4.z;
        acc[4 * q + 3] = v4.w;
      }
    }
  };

  // One head's walk over `count` tiles: the fixed pair (and, for bf16, the
  // state planes) in group 0, then tile n of the walk into stage n % S.
  auto walk = [&](int count, auto&& load_fixed, auto&& load_stage, auto&& body) {
    load_fixed();
    cp_async_commit();
    auto stage = [&](int m) {
      if (m < count) load_stage(m, m % S);
      cp_async_commit();
    };
    for (int m = 0; m < S - 1; ++m) stage(m);
    for (int m = 0; m < count; ++m) {
      stage(m + S - 1);
      cp_async_wait<S - 1>();
      fence_proxy_async();
      __syncthreads();
      body(m, m % S);
      __syncthreads();  // this stage is consumed before it is loaded again
    }
  };
  auto load_rows4 = [&](float* dst, const float* src, int64_t stride, int r, int nr) {
    if (tid < kT) {
      const bool ok = tid < nr;
      cp_async4(smem_u32(dst + tid), ok ? src + (r + tid) * stride : src, ok);
    }
  };
  // float32: the state tile(s) over stage 0, after the walk
  auto load_state_late = [&](const T* src) {
    if constexpr (!kBf) {
      load_tile<T, DSP>(stS, src, p.ds, p.hd, p.ds, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
  };

  // ---- as column tile j = tile: dx_j, the group's dB_j, ddt's direct terms
  {
    const int jt = tile, j0 = t0r, nj = nrow;
    float accB[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) accB[i] = 0.f;
    for (int h = grp * p.group; h < h_end; ++h) {
      const int64_t bkh = (int64_t)bk * p.nh + h;
      const T* xp = static_cast<const T*>(p.x) + b * p.xb + t0 * p.xl + h * p.xh;
      const T* dyp = static_cast<const T*>(p.dy) + ((int64_t)b * p.L + t0) * dyl + (int64_t)h * p.hd;
      const float* csp = p.cs + bkh * c;
      const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
      const T* dsop = static_cast<const T*>(p.dsout) + bkh * (kBf ? 2 : 1) * n;
      const float dco = p.D[h];
      float accX[32], gd[2] = {0.f, 0.f}, dd = 0.f;
      walk(
          p.nt - jt,
          [&] {
            load_tile<T, kHdp>(fixH, xp + j0 * p.xl, p.xl, nj, p.hd, tid);
            if (h == grp * p.group)  // B_j: the same for every head of the group
              load_tile<T, DSP>(fixS, bp + j0 * p.bl, p.bl, nj, p.ds, tid);
            load_rows4(fCs, csp, 1, j0, nj);
            load_rows4(fDt, dtp, p.tl, j0, nj);
            if constexpr (kBf) {
              load_tile<T, DSP>(stS, dsop, p.ds, p.hd, p.ds, tid);
              load_tile<T, DSP>(stS + L::kSBytes, dsop + n, p.ds, p.hd, p.ds, tid);
            }
          },
          [&](int m, int s) {
            const int i0 = (jt + m) * kT, ni = min(kT, c - i0);
            load_tile<T, kHdp>(ringH(s), dyp + i0 * dyl, dyl, ni, p.hd, tid);
            load_tile<T, DSP>(ringS(s), cp + i0 * p.cl, p.cl, ni, p.ds, tid);
            load_rows4(rCs + s * kT, csp, 1, i0, ni);
          },
          [&](int m, int s) {
            const int i0 = (jt + m) * kT;
            float tacc[32], uacc[32];
            // B_j . C_i^T and x_j . dy_i^T: rows j, columns i
            cb_product(tacc, jt + m, jt, 1, fixS, ringS(s));
            abt_product<T, kHdp>(uacc, fixH, ringH(s), at(fixH), at(ringH(s)), p.hd, r0, g, t);
            if (m == 0) {  // the diagonal tile: dy_i is dy_j; + D dy_j, and dy_j . x_j
#pragma unroll
              for (int e = 0; e < 32; ++e) {
                const int row = r0 + ((e & 2) ? 8 : 0), col = 8 * (e >> 2) + 2 * t + (e & 1);
                accX[e] = dco * ld_tile<T>(at(ringH(s)), row, col);
                if (row == col) dd += uacc[e];
              }
            }
            // M^T and N^T (j <= i < c), ddt's direct term sum_i G_ji per row
            float lv[32];
            decay<kBf>(lv, fCs, rCs + s * kT, m == 0, i0, c, r0, t, true);
            float gs[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int hh = (e >> 1) & 1, row = r0 + 8 * hh;
              const float l = lv[e];
              const float dtj = fDt[row];
              gs[hh] = gs[hh] + tacc[e] * uacc[e] * l;
              tacc[e] = tacc[e] * l * dtj;
              uacc[e] = uacc[e] * l * dtj;
            }
            gd[0] = gd[0] + quad_sum(gs[0]);
            gd[1] = gd[1] + quad_sum(gs[1]);
            // dx_j += M^T dy_i, dB_j += N^T C_i (dy_i, C_i read MN-major)
            pb_product<T, kHdp>(accX, tacc, ringH(s), at(ringH(s)), g, t);
            pb_product<T, DSP>(accB, uacc, ringS(s), at(ringS(s)), g, t);
          });
      load_state_late(dsop);
      // the outgoing state's terms: sx = B_j . dS_out^T (rows j, cols p)
      float sx[32];
      abt_product<T, DSP, kBf ? 2 : 1>(sx, fixS, stS, at(fixS), at(stS), p.ds, r0, g, t);
      const float last = p.cs[bkh * c + c - 1];
      float wl[2], w[2], hp[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        wl[hh] = ex(row < nj ? last - fCs[row] : ninf);  // e^{cs_last - cs_j}
        w[hh] = fDt[row] * wl[hh];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1, row = r0 + 8 * hh;
        const int col = 8 * (e >> 2) + 2 * t + (e & 1);
        hp[hh] = hp[hh] + ld_tile<T>(at(fixH), row, col) * sx[e];
        accX[e] = accX[e] + w[hh] * sx[e];
      }
      T* dxp = static_cast<T*>(p.dx) + b * p.gxb + t0 * p.gxl + h * p.gxh;
      float* ddtp = p.ddt + ((int64_t)b * p.L + t0) * p.nh + h;
      float* up = p.rows + bkh * (2 + p.nt) * c;  // U
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh, j = j0 + row;
        const float H = quad_sum(hp[hh]);
        if (row >= nj) continue;
        if (t == 0) {
          ddtp[(int64_t)j * p.nh] = gd[hh] + wl[hh] * H;
          up[j] = w[hh] * H;
        }
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int col = 8 * jb + 2 * t;
          if (col < p.hd) store2(dxp + j * p.gxl + col, accX[4 * jb + 2 * hh], accX[4 * jb + 2 * hh + 1]);
        }
      }
      // dB_j += w_j (x_j . dS_out)
      float sb[NA];
      as_product<T, DSP, kBf ? 2 : 1>(sb, fixH, stS, at(fixH), at(stS), p.hd, r0, g, t);
#pragma unroll
      for (int e = 0; e < NA; ++e) accB[e] = accB[e] + w[(e >> 1) & 1] * sb[e];
      // dy_j . x_j over the tile, for dD
      const float dsum = warps_sum(rows_sum(quad_sum(dd)), sRed);
      if (tid == 0) p.pDt[bkh * p.nt + jt] = dsum;
      __syncthreads();  // the fixed pair is read before the next head loads it
    }
    float* pb = p.pB + (((int64_t)bk * p.ngroups + grp) * c + j0) * p.ds;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= nj) continue;
#pragma unroll
      for (int nb = 0; nb < DSP / 8; ++nb) {
        const int col = 8 * nb + 2 * t;
        if (col < p.ds) store2(pb + row * p.ds + col, accB[4 * nb + 2 * hh], accB[4 * nb + 2 * hh + 1]);
      }
    }
  }

  // ---- as row tile i = tile: the group's dC_i, the straddling sums, V_i
  {
    const int it = tile, i0 = t0r, ni = nrow;
    float accC[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) accC[i] = 0.f;
    for (int h = grp * p.group; h < h_end; ++h) {
      const int64_t bkh = (int64_t)bk * p.nh + h;
      const T* xp = static_cast<const T*>(p.x) + b * p.xb + t0 * p.xl + h * p.xh;
      const T* dyp = static_cast<const T*>(p.dy) + ((int64_t)b * p.L + t0) * dyl + (int64_t)h * p.hd;
      const float* csp = p.cs + bkh * c;
      const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
      const T* sinp = static_cast<const T*>(p.sin) + bkh * (kBf ? 2 : 1) * n;
      float* rowp = p.rows + bkh * (2 + p.nt) * c;
      float R[2] = {0.f, 0.f};  // the carried row prefixes
      walk(
          it + 1,
          [&] {
            load_tile<T, kHdp>(fixH, dyp + i0 * dyl, dyl, ni, p.hd, tid);
            if (h == grp * p.group)  // C_i: the same for every head of the group
              load_tile<T, DSP>(fixS, cp + i0 * p.cl, p.cl, ni, p.ds, tid);
            load_rows4(fCs, csp, 1, i0, ni);
            if constexpr (kBf) {
              load_tile<T, DSP>(stS, sinp, p.ds, p.hd, p.ds, tid);
              load_tile<T, DSP>(stS + L::kSBytes, sinp + n, p.ds, p.hd, p.ds, tid);
            }
          },
          [&](int m, int s) {
            const int j0 = m * kT, nj = min(kT, c - j0);
            load_tile<T, kHdp>(ringH(s), xp + j0 * p.xl, p.xl, nj, p.hd, tid);
            load_tile<T, DSP>(ringS(s), bp + j0 * p.bl, p.bl, nj, p.ds, tid);
            load_rows4(rCs + s * kT, csp, 1, j0, nj);
            load_rows4(rDt + s * kT, dtp, p.tl, j0, nj);
          },
          [&](int m, int s) {
            const int jt = m, j0 = m * kT;
            float sacc[32], xacc[32];
            // C_i . B_j^T and dy_i . x_j^T: rows i, columns j
            cb_product(sacc, it, jt, 0, fixS, ringS(s));
            abt_product<T, kHdp>(xacc, fixH, ringH(s), at(fixH), at(ringH(s)), p.hd, r0, g, t);
            // N = dy.x^T o L o dt_j, W = C.B^T o N (j <= i < c)
            float lv[32];
            decay<kBf>(lv, fCs, rCs + s * kT, jt == it, i0, c, r0, t, false);
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int col = 8 * (e >> 2) + 2 * t + (e & 1);
              const float l = lv[e];
              xacc[e] = xacc[e] * l * rDt[s * kT + col];
              sacc[e] = sacc[e] * xacc[e];
            }
            // dC_i += N . B_j (B_j read MN-major)
            pb_product<T, DSP>(accC, xacc, ringS(s), at(ringS(s)), g, t);
            // the exclusive prefix of W along each row, from the carry
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float run = R[hh];
#pragma unroll
              for (int jb = 0; jb < 8; ++jb) {
                const float v0 = sacc[4 * jb + 2 * hh], v1 = sacc[4 * jb + 2 * hh + 1];
                const float pp = v0 + v1;
                const float u1 = __shfl_up_sync(0xffffffffu, pp, 1, 4);
                const float s1 = t >= 1 ? pp + u1 : pp;
                const float u2 = __shfl_up_sync(0xffffffffu, s1, 2, 4);
                const float incl = t >= 2 ? s1 + u2 : s1;
                const float u3 = __shfl_up_sync(0xffffffffu, incl, 1, 4);
                const float tot = __shfl_sync(0xffffffffu, incl, 3, 4);
                const float q0 = run + (t >= 1 ? u3 : 0.f);
                sacc[4 * jb + 2 * hh] = q0;
                sacc[4 * jb + 2 * hh + 1] = q0 + v0;
                run = run + tot;
              }
              R[hh] = run;
            }
            // the column sums over this tile's rows i >= k
#pragma unroll
            for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
              for (int e01 = 0; e01 < 2; ++e01) {
                const int col = 8 * jb + 2 * t + e01;
                float q0 = sacc[4 * jb + e01], q1 = sacc[4 * jb + 2 + e01];
                if (jt == it) {
                  q0 = r0 >= col ? q0 : 0.f;
                  q1 = r0 + 8 >= col ? q1 : 0.f;
                }
                const float v = rows_sum(q0 + q1);
                if (g == 0) sCol[warp * kT + col] = v;
              }
            }
            __syncthreads();
            if (tid < kT && j0 + tid < c)
              rowp[(2 + it) * c + j0 + tid] =
                  ((sCol[tid] + sCol[kT + tid]) + sCol[2 * kT + tid]) + sCol[3 * kT + tid];
          });
      load_state_late(sinp);
      // the incoming state's terms: st = dy_i . S_in (rows i, cols s)
      float st[NA];
      as_product<T, DSP, kBf ? 2 : 1>(st, fixH, stS, at(fixH), at(stS), p.hd, r0, g, t);
      float ei[2], vp[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        ei[hh] = ex(row < ni ? fCs[row] : ninf);
      }
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        const int hh = (e >> 1) & 1, row = r0 + 8 * hh;
        const int col = 8 * (e >> 2) + 2 * t + (e & 1);
        vp[hh] = vp[hh] + ld_tile<T>(at(fixS), row, col) * st[e];
        accC[e] = accC[e] + ei[hh] * st[e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        const float V = ei[hh] * quad_sum(vp[hh]);
        if (row < ni && t == 0) rowp[c + i0 + row] = V;
      }
      __syncthreads();  // the fixed pair is read before the next head loads it
    }
    float* pc = p.pC + (((int64_t)bk * p.ngroups + grp) * c + i0) * p.ds;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= ni) continue;
#pragma unroll
      for (int nb = 0; nb < DSP / 8; ++nb) {
        const int col = 8 * nb + 2 * t;
        if (col < p.ds) store2(pc + row * p.ds + col, accC[4 * nb + 2 * hh], accC[4 * nb + 2 * hh + 1]);
      }
    }
  }
}

// ------------------------------------------------- 4. dL/da, ddt, dA and dD terms

// Inclusive prefix sums of the `per` values a thread holds (consecutive
// rows, in order), over the 128 threads: own rows in order, the thread
// totals scanned in each warp by shuffles up by 1, 2, 4, 8, 16, the 4 warp
// totals in order; each value is its own running sum plus what came
// before the thread.
template <int kPer>
__device__ __forceinline__ void block_scan(float* v, int per, float* red) {
#pragma unroll
  for (int e = 1; e < kPer; ++e)
    if (e < per) v[e] = v[e - 1] + v[e];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v[0];
#pragma unroll
  for (int e = 1; e < kPer; ++e)
    if (e < per) incl = v[e];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = incl + u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float wbase = 0.f;
  for (int w = 1; w <= warp; ++w) wbase = wbase + red[w - 1];
  const float before = excl + wbase;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (e < per) v[e] = v[e] + before;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const BwdArgs p) {
  constexpr int kPer = kMaxChunk / kThreads;
  __shared__ float sSuf[kMaxChunk], sInc[kMaxChunk], red[4];
  const int tid = threadIdx.x, lane = tid & 31;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc, c = p.c;
  const int64_t bkh = (int64_t)bk * p.nh + h, t0 = (int64_t)k * c;
  const float* U = p.rows + bkh * (2 + p.nt) * c;
  const float* V = U + c;
  const float* P = V + c;
  const int per = (c + kThreads - 1) / kThreads, r0 = tid * per;
  float v[kPer];
  // sum_{i>=k} V_i: a scan of the reversed rows
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = (e < per && r0 + e < c) ? V[c - 1 - (r0 + e)] : 0.f;
  block_scan<kPer>(v, per, red);
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (e < per && r0 + e < c) sSuf[c - 1 - (r0 + e)] = v[e];
  // sum_{j<=k} U_j
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = (e < per && r0 + e < c) ? U[r0 + e] : 0.f;
  block_scan<kPer>(v, per, red);
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (e < per && r0 + e < c) sInc[r0 + e] = v[e];
  // E = e^{cs_last} <dS_out, S_in>: the pass blocks' partials in order
  float ep = p.pE[bkh * p.npass];
  for (int q = 1; q < p.npass; ++q) ep = ep + p.pE[bkh * p.npass + q];
  const float E = expf(p.cs[bkh * c + c - 1]) * ep;
  __syncthreads();
  const float a = p.A[h];
  const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
  float* ddtp = p.ddt + ((int64_t)b * p.L + t0) * p.nh + h;
  float ap = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int kq = r0 + e;
    if (e >= per || kq >= c) continue;
    const int kt = kq / kT;
    float sd = P[kt * c + kq];  // the row tiles' straddle partials, in order
    for (int q = kt + 1; q < p.nt; ++q) sd = sd + P[q * c + kq];
    const float pre = kq > 0 ? sInc[kq - 1] : 0.f;
    const float da = ((sd + sSuf[kq]) + E) + pre;
    ddtp[(int64_t)kq * p.nh] = ddtp[(int64_t)kq * p.nh] + a * da;
    const float term = dtp[kq * p.tl] * da;
    ap = e == 0 ? term : ap + term;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ap += __shfl_xor_sync(0xffffffffu, ap, o);
  if (lane == 0) red[tid >> 5] = ap;
  __syncthreads();
  if (tid == 0) {
    p.pA[bkh] = ((red[0] + red[1]) + red[2]) + red[3];
    float sd = p.pDt[bkh * p.nt];
    for (int q = 1; q < p.nt; ++q) sd = sd + p.pDt[bkh * p.nt + q];
    p.pD[bkh] = sd;
  }
}

// ------------------------------------------------- 5. ordered reductions

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_reduce(const BwdArgs p) {
  const int64_t total = (int64_t)p.batch * p.L * p.ds;
  const int64_t e = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e < total) {
    const int s = (int)(e % p.ds);
    const int64_t bt = e / p.ds;
    const int t = (int)(bt % p.L), b = (int)(bt / p.L);
    const int k = t / p.c, i = t - k * p.c;
    const int64_t gs = (int64_t)p.c * p.ds;
    const int64_t base = ((int64_t)b * p.nc + k) * p.ngroups * gs + (int64_t)i * p.ds + s;
    float sb = p.pB[base], sc = p.pC[base];
    for (int q = 1; q < p.ngroups; ++q) {  // head groups in order
      sb = sb + p.pB[base + q * gs];
      sc = sc + p.pC[base + q * gs];
    }
    store1(static_cast<T*>(p.dB) + b * p.gbb + t * p.gbl + s, sb);
    store1(static_cast<T*>(p.dC) + b * p.gcb + t * p.gcl + s, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < p.nh; h += kReduceThreads) {
      float sa = p.pA[h], sd = p.pD[h];
      for (int bk = 1; bk < p.batch * p.nc; ++bk) {  // batch and chunks in order
        sa = sa + p.pA[(int64_t)bk * p.nh + h];
        sd = sd + p.pD[(int64_t)bk * p.nh + h];
      }
      p.dA[h] = sa;
      p.dD[h] = sd;
    }
  }
}

// ------------------------------------------------------------------- host

// The shared-memory opt-ins of an instantiation, once per device.
template <typename T, int DSP>
int opt_in() {
  using L = BwdTiles<T, DSP>;
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && attr_set[dev]) return 0;
  e = cudaFuncSetAttribute(ssd_bwd_chunk<T, DSP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kChunk);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_local<T, DSP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kLocal);
  if constexpr (!L::kBf) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_cb<DSP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kCB);
  }
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) attr_set[dev] = true;
  return 0;
}

// The chunk kernel's CTAs an SM, registers a thread and local (spilled)
// bytes, as the CUDA runtime reports them.
template <typename T, int DSP>
int occupancy(int* out) {
  int rc = opt_in<T, DSP>();
  if (rc != 0) return rc;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], ssd_bwd_chunk<T, DSP>, kThreads, BwdTiles<T, DSP>::kChunk);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, ssd_bwd_chunk<T, DSP>);
  if (e != cudaSuccess) return (int)e;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

template <typename T, int DSP>
int launch(const BwdArgs& a, int smem_chunk, int smem_local, cudaStream_t stream) {
  using L = BwdTiles<T, DSP>;
  if (smem_chunk != L::kChunk || smem_local != L::kLocal) return kErrPlan;
  int rc = opt_in<T, DSP>();
  if (rc != 0) return rc;
  cudaError_t e;
  ssd_bwd_local<T, DSP><<<dim3(a.batch * a.nc, a.nh), kThreads, L::kLocal, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_pass<T><<<dim3(a.npass, a.nh, a.batch), kPassThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (!L::kBf) {
    ssd_bwd_cb<DSP><<<dim3(a.batch * a.nc, a.npairs, 2), kThreads, L::kCB, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_bwd_chunk<T, DSP><<<dim3(a.batch * a.nc, a.ngroups, a.nt), kThreads, L::kChunk, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_finish<<<dim3(a.batch * a.nc, a.nh), kThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)a.batch * a.L * a.ds;
  ssd_bwd_reduce<T><<<dim3((unsigned)((total + kReduceThreads - 1) / kReduceThreads)),
                      kReduceThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, B, C, dy, dx, dB and dC: 0 = float32, 1 = bfloat16; dt, A,
// D, dstate (null: zero), cs, ddt, dA, dD and the scratch are float32;
// sin is the forward's entering-state buffer and dsout its gradient's
// (float32, or bf16 hi and lo planes).  Scratch: local and dsout (b x
// chunks x nh x hd x ds float32), pE (b x chunks x nh x pass blocks),
// rows (b x chunks x nh x (2 + row tiles) x chunk), pDt (b x chunks x nh x
// row tiles), pB and pC (b x chunks x head groups x chunk x ds), pA and pD
// (b x chunks x nh), float32 only cbt (b x chunks x tile pairs x 2 x 64 x
// 64; null for bf16).  strides: 17 element strides, (batch, seq, head) for x
// and dt, (batch, seq) for B and C, (batch, seq, head) for dx, (batch, seq)
// for dB and dC.  L % chunk == 0.  state_pad / group / smem_chunk /
// smem_local: the wrapper's launch plan.
int ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* D, const void* dy, const void* dstate,
                 const void* cs, const void* sin, void* local, void* dsout, void* pE,
                 void* rows, void* pDt, void* dx, void* ddt, void* dA, void* dB, void* dC,
                 void* dD, void* pB, void* pC, void* pA, void* pD, void* cbt, int batch, int L,
                 int nh, int hd, int ds, int chunk, const int64_t* strides, int state_pad,
                 int group, int smem_chunk, int smem_local, void* stream) {
  if (batch == 0 || nh == 0) return 0;
  if (L <= 0 || chunk <= 0 || chunk > kMaxChunk || L % chunk != 0 || hd <= 0 || hd > kHdp ||
      hd % 8 != 0 || ds <= 0 || ds > state_pad || ds % 8 != 0 || batch > 65535 ||
      nh > 65535 || group <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.D = static_cast<const float*>(D);
  a.dy = dy;
  a.dstate = static_cast<const float*>(dstate);
  a.cs = static_cast<const float*>(cs);
  a.sin = sin;
  a.local = static_cast<float*>(local);
  a.dsout = dsout;
  a.pE = static_cast<float*>(pE);
  a.rows = static_cast<float*>(rows);
  a.pDt = static_cast<float*>(pDt);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.dB = dB;
  a.dC = dC;
  a.pB = static_cast<float*>(pB);
  a.pC = static_cast<float*>(pC);
  a.pA = static_cast<float*>(pA);
  a.pD = static_cast<float*>(pD);
  a.batch = batch;
  a.L = L;
  a.nh = nh;
  a.hd = hd;
  a.ds = ds;
  a.c = chunk;
  a.nc = L / chunk;
  a.nt = (chunk + kT - 1) / kT;
  a.group = group;
  a.ngroups = (nh + group - 1) / group;
  a.npass = (hd * ds + 4 * kPassThreads - 1) / (4 * kPassThreads);
  a.npairs = a.nt * (a.nt + 1) / 2;
  a.cbt = static_cast<float*>(cbt);
  a.xb = strides[0];
  a.xl = strides[1];
  a.xh = strides[2];
  a.tb = strides[3];
  a.tl = strides[4];
  a.th = strides[5];
  a.bb = strides[6];
  a.bl = strides[7];
  a.cb = strides[8];
  a.cl = strides[9];
  a.gxb = strides[10];
  a.gxl = strides[11];
  a.gxh = strides[12];
  a.gbb = strides[13];
  a.gbl = strides[14];
  a.gcb = strides[15];
  a.gcl = strides[16];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (state_pad == 64) return launch<__nv_bfloat16, 64>(a, smem_chunk, smem_local, s);
    if (state_pad == 128) return launch<__nv_bfloat16, 128>(a, smem_chunk, smem_local, s);
  } else if (dtype == 0) {
    if (state_pad == 64) return launch<float, 64>(a, smem_chunk, smem_local, s);
    if (state_pad == 128) return launch<float, 128>(a, smem_chunk, smem_local, s);
  }
  return kErrPlan;
}

// The chunk kernel's CTAs an SM, registers and spilled bytes for
// dtype and state_pad as ssd_scan_bwd takes them.
int ssd_scan_bwd_occupancy(int dtype, int state_pad, int* out) {
  if (dtype == 1) {
    if (state_pad == 64) return occupancy<__nv_bfloat16, 64>(out);
    if (state_pad == 128) return occupancy<__nv_bfloat16, 128>(out);
  } else if (dtype == 0) {
    if (state_pad == 64) return occupancy<float, 64>(out);
    if (state_pad == 128) return occupancy<float, 128>(out);
  }
  return kErrPlan;
}

}  // extern "C"
