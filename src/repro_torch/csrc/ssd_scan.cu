// Mamba-2 SSD chunked scan (forward) for NVIDIA Hopper, sm_90a: chunks in
// parallel, products on the tensor cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` in
// src/repro/kernels/ssd/kernel.py (_kernel, launched at :80).  It computes
// what that kernel, and its oracle models/ssm.py::ssd_chunked, compute: per
// (batch, head) and per chunk of c rows, with cs the inclusive prefix sum of
// dt * A over the chunk,
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//         + exp(cs_i) (C_i . state) + D x_i                  (written in x's dtype)
//   state = state exp(cs_last) + sum_j x_j^T B_j dt_j exp(cs_last - cs_j)
//
// with the (hd x ds) float32 state carried from chunk to chunk and written
// out after the last one.  Only pairs j <= i contribute, and the exponent is
// masked before exp, so the positive exponents of the upper triangle (inf,
// then inf * 0 = NaN) are never formed, as in the reference.
//
// Design (Mamba-2's own GPU decomposition, arXiv:2405.21060 §6): chunks run
// in parallel and only the (hd x ds) states cross chunks.  One call enqueues
// three kernels on PyTorch's current stream (float32: four, see 0):
//
// 0. float32 only: ssd_chunk_cb, grid (batch x chunks, tile pairs j <= i):
//    C_i . B_j^T once per chunk, as the heads share B and C.  In 3xTF32 the
//    operand splits make that product the float32 scan's largest cost when
//    it is repeated per head.
// 1. ssd_chunk_state, grid (batch x chunks, heads, float32: ds / 64),
//    128 threads: the prefix sum cs of the chunk, w_j = dt_j exp(cs_last -
//    cs_j) and v_j = dt_j exp(cs_e - cs_j), e the last row of j's 64-row
//    tile (cs and v written out for 3), and the chunk's own state
//    (x o w)^T . B, a (hd x c) . (c x ds) product over 64-row tiles of x
//    and B in a cp.async ring (4 stages bf16, 2 float32).
// 2. ssd_state_pass, grid (hd ds / 1024, heads, batch), 4 elements a
//    thread: S_in[k] = S_in[k-1] exp(cs_last[k-1]) + state[k-1] in order over
//    the chunks, the same multiply-then-add as the reference, with the loads
//    of 8 chunks in flight together; it writes the final state and S_in,
//    for bf16 already split into the hi and lo planes the scan copies.
// 3. ssd_chunk_scan, grid (batch x chunks, heads, row tiles of 64), longest
//    causal row tiles launched first: y_i = exp(cs_i) (C_i . S_in^T), then
//    for each j tile <= i: S = C_i . B_j^T, P = S o decay o dt_j masked in
//    registers, y_i += P . x_j; then + D x_i.  On the diagonal tile the
//    decay is exp(cs_i - cs_j); below it, exp(cs_i - cs_e) v_j, two factors
//    that are each <= 1 and one exp per row instead of one per pair.  The
//    entering state and the second stage of B_j, x_j share one region.  bf16
//    recomputes C.B^T per head: one wgmma a k-step, ~0.8 GFLOP extra at
//    mamba2, about 1 us, less than a fourth kernel's launch and bytes.  bf16
//    is compiled for three CTAs an SM, float32 for two.
//
// Tiles are 64 rows, staged in shared memory in the 128-byte swizzle that
// TMA writes (16-byte chunk index XOR row % 8, slabs of 128 bytes across the
// width), here filled by 16-byte cp.async with zero fill for rows past the
// chunk and columns past hd / ds.  hd is padded to 64, ds to 64 or 128.
// No mbarriers: a cp.async group cannot wait forever, so nothing can hang.
//
// Arithmetic.  bfloat16: x, B and C are exact in bf16, products accumulate
// in float32.  C . B^T is one `wgmma` (both K-major, m64n64k16).  The f32
// operands that meet a bf16 product are split into hi + lo bf16 parts, two
// products each (the other operand is exact): x o w in the state product
// and P in P . x (A from registers, B and x read MN-major), and S_in in
// C . S_in^T (hi and lo tiles).  Rounding any one of them to a single bf16
// misses the tolerances (tests/test_torch_ssd.py).  float32: 3xTF32 on
// mma.sync.m16n8k8 (hi.hi + hi.lo + lo.hi) with hi and lo rounded to
// nearest, and each 8-deep step summed from zero and added in float32:
// truncated splits, or the tensor core's own accumulation (it rounds
// toward zero) over a whole K loop, reach the float32 tolerance of 2e-5 at
// mamba2 widths, where |C.B| ~ 40 at ds 128.
//
// The prefix sum takes the order of the reference's jnp.cumsum, which XLA
// rewrites into a scan over blocks of 16: dt * A rounded (no FMA), a
// sequential float32 sum inside each block of 16 (one thread a block), the
// block totals scanned by the same rule (one level at chunk 256, two up to
// chunk 4096; in order once there are at most 16), then each element plus
// the previous block's prefix.  The decays are differences of cs, which
// reaches about -80 within a chunk, so another summation order moves them
// by an ulp of 80 (7.6e-6) and uses up the float32 tolerance of y.
//
// What bounds it on the H100: at mamba2-780m (b 1, l 1024, nh 48, hd 64,
// ds 128, c 256) the function needs 2.45 GFLOP (the causal half of C.B^T
// once per (batch, chunk), the scores x dt.x, C.state and state products
// per head) and 15 MB (x, y in bf16, B, C, dt, the state): 2.5 us of bf16
// tensor-core time against 4.4 us of HBM time, so bound by bytes; in
// float32 (3xTF32, 495 / 3 TFLOP/s) bound by operations, 14.8 us.  What
// holds it above that is latency along each CTA's chain of dependent
// steps (copies, products, the masked decay), not throughput.
//
// Inputs are read through strides: x, B and C are views into the mixer's
// xBC activation (row stride d_inner + 2 ds), with unit stride in their
// last dim, 16-byte aligned bases and strides; hd and ds multiples of 8.  y
// and the state are contiguous.  The wrapper allocates the scratch (cs, v,
// the chunk states, the entering states, float32's C.B^T tiles) and passes
// its launch plan; the launcher refuses a plan that differs from its
// instantiations, never synchronises, allocates nothing, and returns
// cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kMaxChunk = 4096;
constexpr int kPassThreads = 256;
constexpr int kErrPlan = 10003;    // plan differs from every instantiation
constexpr int kScanBlock = 16;     // blocks of the prefix sum (XLA's order)
// scratch of the prefix sum: the totals of a chunk's blocks, and of theirs
constexpr int kScanTotals = kMaxChunk / kScanBlock + kScanBlock;

template <typename T, int DSP>
struct Tiles {
  static constexpr int kW = 128 / (int)sizeof(T);      // elements in a slab row
  static constexpr int kXBytes = kHdp / kW * kSlab;    // x tile: 64 rows x 64
  static constexpr int kBBytes = DSP / kW * kSlab;     // B, C, state: 64 rows x DSP
  // chunk state: x and B tiles in a ring of kStages, then dt (becoming w)
  // and cs of the chunk, then the prefix sum's block totals.  A float32 CTA takes 64 of the ds columns (grid z
  // splits ds), a bf16 one all DSP.
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 2;
  static constexpr int kStateW = sizeof(T) == 4 ? 64 : DSP;
  static constexpr int kStateB = kStateW / kW * kSlab;
  static constexpr int kStateTiles = kStages * (kXBytes + kStateB);
  static constexpr int state_smem(int c) {
    return kStateTiles + 8 * c + 4 * kScanTotals + 1024;
  }
  // chunk scan: C_i; stage 0 (B_j, x_j); a region that first holds the
  // entering state (bf16: hi and lo tiles, float32: one), then stage 1;
  // cs_i, and cs_j, dt_j and v_j in two stages
  // (float32 takes C_i . B_j^T from ssd_chunk_cb: no B_j tile)
  static constexpr int kSTiles = sizeof(T) == 2 ? 2 : 1;
  static constexpr bool kCB = sizeof(T) == 4;
  static constexpr int kStageB = kCB ? 0 : kBBytes;
  static constexpr int kStage = kStageB + kXBytes;
  static constexpr int kR1 = kSTiles * kBBytes > kStage ? kSTiles * kBBytes : kStage;
  static constexpr int kScan = kBBytes + kStage + kR1 + 7 * kT * 4 + 1024;
  // float32 C.B^T: a C and a B tile
  static constexpr int kCBSmem = 2 * kBBytes + 1024;
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  void* y;
  float* state;    // (b, nh, hd, ds) final state
  float* cs;       // (b, nc, nh, c) prefix sums
  float* v;        // (b, nc, nh, c): dt_j exp(cs_e - cs_j), e the last row of j's tile
  float* states;   // (b, nc, nh, hd, ds) chunk states
  void* sin;       // the state entering each chunk: float32 (b, nc, nh, hd, ds);
                   // bf16 hi and lo planes (b, nc, nh, 2, hd, ds)
  float* cbt;      // float32: C_i . B_j^T per (b, chunk, tile pair j <= i), 64 x 64
                   // in the accumulator's register order
  int L, nh, hd, ds, c, nc, nt, npairs;
  // element strides: x (batch, seq, head), dt (batch, seq, head), B and C
  // (batch, seq); the last dim of x, B and C has stride 1
  int64_t xb, xl, xh, tb, tl, th, bb, bl, cb, cl;
};

// a[i0], a[i0 + 1], ... a[i1 - 1] replaced by their running float32 sum,
// in order; returns the total
__device__ __forceinline__ float scan_in_order(float* a, int i0, int i1) {
  float run = a[i0];
  for (int i = i0 + 1; i < i1; ++i) {
    run = __fadd_rn(run, a[i]);
    a[i] = run;
  }
  return run;
}

// Inclusive prefix sum of a[0, n), n <= kMaxChunk, in place, in XLA's order
// (see the header): one thread a block of 16, the block totals t1 scanned by
// the same rule (their own blocks' totals in t2), then each element plus
// the previous block's prefix.  t: kScanTotals floats.  Every thread of the
// CTA calls it; it ends with a barrier.
__device__ void prefix_sum16(float* a, int n, float* t, int tid) {
  constexpr int B = kScanBlock;
  float* t1 = t;
  float* t2 = t + kMaxChunk / B;
  const int n1 = (n + B - 1) / B, n2 = (n1 + B - 1) / B;
  for (int i = tid; i < n1; i += kThreads) t1[i] = scan_in_order(a, B * i, min(n, B * i + B));
  __syncthreads();
  if (n1 > B) {  // a second level: n1 <= 256 totals, n2 <= 16
    for (int i = tid; i < n2; i += kThreads) t2[i] = scan_in_order(t1, B * i, min(n1, B * i + B));
    __syncthreads();
    if (tid == 0) scan_in_order(t2, 0, n2);
    __syncthreads();
    for (int i = B + tid; i < n1; i += kThreads) t1[i] = __fadd_rn(t1[i], t2[i / B - 1]);
    __syncthreads();
  } else if (tid == 0) {
    scan_in_order(t1, 0, n1);
  }
  __syncthreads();
  for (int i = B + tid; i < n; i += kThreads) a[i] = __fadd_rn(a[i], t1[i / B - 1]);
  __syncthreads();
}

// ------------------------------------------------------- 1. chunk state

template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const Args p) {
  using L = Tiles<T, DSP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* sW = reinterpret_cast<float*>(smem + L::kStateTiles);  // dt, then w
  float* sCs = sW + p.c;

  const int tid = threadIdx.x;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc;
  const int c = p.c;
  const int64_t t0 = (int64_t)k * c;
  const T* xp = static_cast<const T*>(p.x) + b * p.xb + t0 * p.xl + h * p.xh;
  constexpr int BW = L::kStateW;                 // the ds columns this CTA takes
  const int s0 = (int)blockIdx.z * BW;           // from this one
  const T* bp = static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bl + s0;
  const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
  const int ntj = (c + kT - 1) / kT;
  constexpr int S = L::kStages;

  auto stage = [&](int jt) {  // one cp.async group, empty past the last tile
    if (jt < ntj) {
      const int s = jt % S, j0 = jt * kT, n = min(kT, c - j0);
      load_tile<T, kHdp>(base + s * L::kXBytes, xp + j0 * p.xl, p.xl, n, p.hd, tid);
      load_tile<T, BW>(base + S * L::kXBytes + s * L::kStateB, bp + j0 * p.bl, p.bl, n,
                       p.ds - s0, tid);
    }
    cp_async_commit();
  };
  // dt of the chunk, in a cp.async group ahead of the tiles'
  for (int i = tid; i < c; i += kThreads) cp_async4(smem_u32(sW + i), dtp + i * p.tl, true);
  cp_async_commit();
  for (int jt = 0; jt < S - 1; ++jt) stage(jt);
  cp_async_wait<S - 1>();
  __syncthreads();
  // dt_i A, each rounded, in parallel; then the prefix sum in XLA's order
  const float a = p.A[h];
  for (int i = tid; i < c; i += kThreads) sCs[i] = __fmul_rn(sW[i], a);
  __syncthreads();
  prefix_sum16(sCs, c, sCs + c, tid);
  const float total = sCs[c - 1];
  float* csp = p.cs + ((int64_t)bk * p.nh + h) * c;
  float* vp = p.v + ((int64_t)bk * p.nh + h) * c;
  for (int i = tid; i < c; i += kThreads) {
    if (blockIdx.z == 0) {
      csp[i] = sCs[i];
      const float ce = sCs[min(i | (kT - 1), c - 1)];  // the last row of i's tile
      vp[i] = expf(ce - sCs[i]) * sW[i];
    }
    sW[i] = sW[i] * expf(total - sCs[i]);  // w_j = dt_j exp(total - cs_j)
  }
  // (the __syncthreads in the loop orders these writes before their reads)

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int p0 = 16 * warp + g;  // state rows p0 and p0 + 8 (the head dim)
  constexpr int NA = BW / 2;     // BW / 8 column blocks x 4
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int jt = 0; jt < ntj; ++jt) {
    stage(jt + S - 1);
    cp_async_wait<S - 1>();
    fence_proxy_async();
    __syncthreads();
    const int s = jt % S, j0 = jt * kT;
    const unsigned char* xs = smem + s * L::kXBytes;
    const uint32_t bs = base + S * L::kXBytes + s * L::kStateB;
    auto wv = [&](int jj) { return j0 + jj < c ? sW[j0 + jj] : 0.f; };
    if constexpr (sizeof(T) == 2) {
      // A = (x o w)^T (rows: head dim, columns: chunk rows), split hi + lo
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ja = 16 * kk + 2 * t;
        const float w0 = wv(ja), w1 = wv(ja + 1), w8 = wv(ja + 8), w9 = wv(ja + 9);
        pack_split(ld_tile<T>(xs, ja, p0) * w0, ld_tile<T>(xs, ja + 1, p0) * w1,
                   ahi[kk][0], alo[kk][0]);
        pack_split(ld_tile<T>(xs, ja, p0 + 8) * w0, ld_tile<T>(xs, ja + 1, p0 + 8) * w1,
                   ahi[kk][1], alo[kk][1]);
        pack_split(ld_tile<T>(xs, ja + 8, p0) * w8, ld_tile<T>(xs, ja + 9, p0) * w9,
                   ahi[kk][2], alo[kk][2]);
        pack_split(ld_tile<T>(xs, ja + 8, p0 + 8) * w8,
                   ld_tile<T>(xs, ja + 9, p0 + 8) * w9, ahi[kk][3], alo[kk][3]);
      }
      fence_regs<NA>(acc);
      wgmma_fence();
#pragma unroll
      for (int s2 = 0; s2 < BW / 64; ++s2) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // 16 chunk rows = two 8-row groups of 1024 bytes; B read MN-major
          const uint64_t db = smem_desc(bs + s2 * kSlab + kk * 2048);
          wgmma_rs(acc + 32 * s2, ahi[kk], db);
          wgmma_rs(acc + 32 * s2, alo[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NA>(acc);
    } else {
      const unsigned char* bt = smem + (bs - base);
#pragma unroll
      for (int ks = 0; ks < kT / 8; ++ks) {
        if (j0 + 8 * ks >= c) break;
        const int ja = 8 * ks + t;
        const float w0 = wv(ja), w4 = wv(ja + 4);
        uint32_t ahi[4], alo[4];
        split_tf32(ld_tile<float>(xs, ja, p0) * w0, ahi[0], alo[0]);
        split_tf32(ld_tile<float>(xs, ja, p0 + 8) * w0, ahi[1], alo[1]);
        split_tf32(ld_tile<float>(xs, ja + 4, p0) * w4, ahi[2], alo[2]);
        split_tf32(ld_tile<float>(xs, ja + 4, p0 + 8) * w4, ahi[3], alo[3]);
#pragma unroll
        for (int n0 = 0; n0 < BW / 8; n0 += 8) {
          if (s0 + 8 * n0 >= p.ds) break;
          uint32_t bhi[8][2], blo[8][2];
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            const int sc = 8 * (n0 + jb) + g;
            split_tf32(ld_tile<float>(bt, ja, sc), bhi[jb][0], blo[jb][0]);
            split_tf32(ld_tile<float>(bt, ja + 4, sc), bhi[jb][1], blo[jb][1]);
          }
          mma_3xtf32<8>(acc + 4 * n0, ahi, alo, bhi, blo);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  float* sp = p.states + ((int64_t)bk * p.nh + h) * p.hd * p.ds;
#pragma unroll
  for (int nb = 0; nb < BW / 8; ++nb) {
    const int col = s0 + 8 * nb + 2 * t;
    if (col < p.ds) {
      if (p0 < p.hd) store2(sp + p0 * p.ds + col, acc[4 * nb], acc[4 * nb + 1]);
      if (p0 + 8 < p.hd)
        store2(sp + (p0 + 8) * p.ds + col, acc[4 * nb + 2], acc[4 * nb + 3]);
    }
  }
}

// ------------------------------------------------------- 2. state passing

// One thread per 4 state elements walks the chunks in order; the chunk
// states and decays of kBatch chunks are loaded together, so that a long
// sequence waits on one load latency per batch, not per chunk.
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const Args p) {
  constexpr int kBatch = 8;
  const int n = p.hd * p.ds;  // a multiple of 64
  const int idx = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (idx >= n) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < p.nc; k0 += kBatch) {
    float4 v[kBatch];
    float carry[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (k0 + q < p.nc) {
        const int64_t bkh = ((int64_t)b * p.nc + k0 + q) * p.nh + h;
        v[q] = *reinterpret_cast<const float4*>(p.states + bkh * n + idx);
        carry[q] = expf(p.cs[bkh * p.c + p.c - 1]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (k0 + q < p.nc) {
        const int64_t bkh = ((int64_t)b * p.nc + k0 + q) * p.nh + h;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(static_cast<float*>(p.sin) + bkh * n + idx) =
              make_float4(run[0], run[1], run[2], run[3]);
        } else {  // hi and lo planes: the bf16 operands of C . S_in^T
          uint32_t h0, l0, h1, l1;
          pack_split(run[0], run[1], h0, l0);
          pack_split(run[2], run[3], h1, l1);
          T* sp = static_cast<T*>(p.sin) + bkh * 2 * n + idx;
          *reinterpret_cast<uint2*>(sp) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(sp + n) = make_uint2(l0, l1);
        }
        const float vq[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) run[e] = __fadd_rn(__fmul_rn(run[e], carry[q]), vq[e]);
      }
    }
  }
  *reinterpret_cast<float4*>(p.state + ((int64_t)b * p.nh + h) * n + idx) =
      make_float4(run[0], run[1], run[2], run[3]);
}

// ------------------------------------------------------- 3. chunk scan

// bf16: at most 170 registers, so that three CTAs share an SM (76 KB of
// shared memory each at ds 128); float32: two
template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
ssd_chunk_scan(const Args p) {
  using L = Tiles<T, DSP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sC = base;                          // C_i
  const uint32_t sS = base + L::kBBytes + L::kStage;  // entering state, then stage 1
  // stage s: B_j (bf16) at sB(s), x_j at sB(s) + kStageB
  auto sB = [&](int s) { return s ? sS : base + L::kBBytes; };
  float* csI = reinterpret_cast<float*>(smem + (sS - base) + L::kR1);
  float* csJ = csI + kT;       // two stages
  float* dtJ = csJ + 2 * kT;   // two stages
  float* vJ = dtJ + 2 * kT;    // two stages

  const int tid = threadIdx.x;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc;
  const int c = p.c;
  const int64_t t0 = (int64_t)k * c;
  const T* xp = static_cast<const T*>(p.x) + b * p.xb + t0 * p.xl + h * p.xh;
  const T* bp = static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bl;
  const T* cp = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
  const int64_t bkh = (int64_t)bk * p.nh + h;
  const float* csp = p.cs + bkh * c;
  const float* vp = p.v + bkh * c;
  const bool carry = k > 0;  // the first chunk enters with a zero state

  const int it = p.nt - 1 - (int)blockIdx.z;  // longest causal row tiles first
  const int i0 = it * kT, ni = min(kT, c - i0);

  // group 0: C_i, cs_i and (float32) the entering state
  load_tile<T, DSP>(sC, cp + i0 * p.cl, p.cl, ni, p.ds, tid);
  if (tid < kT) cp_async4(smem_u32(csI + tid), tid < ni ? csp + i0 + tid : csp, tid < ni);
  if (carry) {
    const int64_t n = (int64_t)p.hd * p.ds;
    const T* sinp = static_cast<const T*>(p.sin) + bkh * L::kSTiles * n;
    load_tile<T, DSP>(sS, sinp, p.ds, p.hd, p.ds, tid);
    if constexpr (L::kSTiles == 2)
      load_tile<T, DSP>(sS + L::kBBytes, sinp + n, p.ds, p.hd, p.ds, tid);
  }
  cp_async_commit();

  auto stage = [&](int jt) {
    const int s = jt & 1, j0 = jt * kT, n = min(kT, c - j0);
    if constexpr (!L::kCB) load_tile<T, DSP>(sB(s), bp + j0 * p.bl, p.bl, n, p.ds, tid);
    load_tile<T, kHdp>(sB(s) + L::kStageB, xp + j0 * p.xl, p.xl, n, p.hd, tid);
    if (tid < kT) {
      const bool ok = tid < n;
      cp_async4(smem_u32(csJ + s * kT + tid), ok ? csp + j0 + tid : csp, ok);
      cp_async4(smem_u32(dtJ + s * kT + tid), ok ? dtp + (j0 + tid) * p.tl : dtp, ok);
      cp_async4(smem_u32(vJ + s * kT + tid), ok ? vp + j0 + tid : vp, ok);
    }
    cp_async_commit();
  };
  stage(0);  // group 1

  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  if (carry) {
    // y_i = exp(cs_i) (C_i . S_in^T)
    if constexpr (sizeof(T) == 2) {
      fence_regs<32>(yacc);
      wgmma_fence();
      wgmma_abt<DSP>(yacc, sC, sS, false);
      wgmma_abt<DSP>(yacc, sC, sS + L::kBBytes, true);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(yacc);
    } else {
      mma_abt_f32<DSP>(yacc, smem + (sC - base), smem + (sS - base), p.ds, r0, g, t);
    }
    const float e0 = expf(csI[r0]), e1 = expf(csI[r0 + 8]);
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= (i & 2) ? e1 : e0;
  }
  __syncthreads();  // the entering state is read before stage 1 overwrites it

  for (int jt = 0; jt <= it; ++jt) {
    float sacc[32];
    if constexpr (L::kCB) {  // float32: S = C_i . B_j^T from ssd_chunk_cb
      const float4* sp = reinterpret_cast<const float4*>(p.cbt) +
                         ((int64_t)bk * p.npairs + it * (it + 1) / 2 + jt) * 8 * kThreads + tid;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v4 = sp[q * kThreads];
        sacc[4 * q] = v4.x;
        sacc[4 * q + 1] = v4.y;
        sacc[4 * q + 2] = v4.z;
        sacc[4 * q + 3] = v4.w;
      }
    }
    if (jt < it) stage(jt + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int s = jt & 1, j0 = jt * kT;
    const uint32_t bs = sB(s), xs = bs + L::kStageB;
    const float* cj = csJ + s * kT;
    const float* dj = dtJ + s * kT;
    const float* vj = vJ + s * kT;

    // ---- S = C_i . B_j^T (bf16; float32 loaded it above)
    if constexpr (!L::kCB) {
      fence_regs<32>(sacc);
      wgmma_fence();
      wgmma_abt<DSP>(sacc, sC, bs, false);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sacc);
    }

    // ---- P = S o exp(cs_i - cs_j) o dt_j where j <= i < c, else 0.  The
    // exponent is never positive.  bf16: the special-function unit's exp
    // (2 ulp, far inside bf16's).
    auto ex = [](float d) { return sizeof(T) == 2 ? __expf(d) : expf(d); };
    const float ninf = __int_as_float(0xff800000);
    if (jt < it) {
      // below the diagonal: exp(cs_i - cs_j) = exp(cs_i - cs_e) exp(cs_e - cs_j)
      // with e the last row of tile j (both factors <= 1), the second one
      // times dt_j taken per row j once, in the chunk-state kernel (v_j)
      const float ce = cj[kT - 1];
      const bool ok0 = i0 + r0 < c, ok1 = i0 + r0 + 8 < c;
      const float u0 = ex(ok0 ? csI[r0] - ce : ninf);
      const float u1 = ex(ok1 ? csI[r0 + 8] - ce : ninf);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e >> 2) + 2 * t + (e & 1);
        sacc[e] = ((e & 2) ? ok1 : ok0) ? (sacc[e] * ((e & 2) ? u1 : u0)) * vj[col] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = 8 * (e >> 2) + 2 * t + (e & 1);
        const bool ok = j0 + col <= i0 + row && i0 + row < c;
        sacc[e] = ok ? (sacc[e] * ex(csI[row] - cj[col])) * dj[col] : 0.f;
      }
    }

    // ---- y_i += P . x_j
    if constexpr (sizeof(T) == 2) {
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_split(sacc[8 * kk + 0], sacc[8 * kk + 1], phi[kk][0], plo[kk][0]);
        pack_split(sacc[8 * kk + 2], sacc[8 * kk + 3], phi[kk][1], plo[kk][1]);
        pack_split(sacc[8 * kk + 4], sacc[8 * kk + 5], phi[kk][2], plo[kk][2]);
        pack_split(sacc[8 * kk + 6], sacc[8 * kk + 7], phi[kk][3], plo[kk][3]);
      }
      fence_regs<32>(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(xs + kk * 2048);  // x read MN-major
        wgmma_rs(yacc, phi[kk], db);
        wgmma_rs(yacc, plo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(yacc);
    } else {
      const unsigned char* xt = smem + (xs - base);
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        // A column t <-> chunk row 2t, column t + 4 <-> row 2t + 1 of this block
        uint32_t ahi[4], alo[4];
        split_tf32(sacc[4 * kb + 0], ahi[0], alo[0]);
        split_tf32(sacc[4 * kb + 2], ahi[1], alo[1]);
        split_tf32(sacc[4 * kb + 1], ahi[2], alo[2]);
        split_tf32(sacc[4 * kb + 3], ahi[3], alo[3]);
        const int key = 8 * kb + 2 * t;
        uint32_t bhi[8][2], blo[8][2];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int d = 8 * jb + g;
          split_tf32(ld_tile<float>(xt, key, d), bhi[jb][0], blo[jb][0]);
          split_tf32(ld_tile<float>(xt, key + 1, d), bhi[jb][1], blo[jb][1]);
        }
        mma_3xtf32<8>(yacc, ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // ---- y_i + D x_i (x_i is the last j tile, still staged), rows < c, cols < hd
  const unsigned char* xi = smem + (sB(it & 1) + L::kStageB - base);
  const float dco = p.D[h];
  T* yp = static_cast<T*>(p.y) + ((int64_t)b * p.L + t0 + i0) * p.nh * p.hd +
          (int64_t)h * p.hd;
  const int64_t yl = (int64_t)p.nh * p.hd;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int col = 8 * nb + 2 * t;
    if (col >= p.hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= ni) continue;
      const float v0 = yacc[4 * nb + 2 * half] + dco * ld_tile<T>(xi, row, col);
      const float v1 = yacc[4 * nb + 2 * half + 1] + dco * ld_tile<T>(xi, row, col + 1);
      store2(yp + row * yl + col, v0, v1);
    }
  }
}

// ------------------------------------------- float32: C.B^T once per chunk

// C_i . B_j^T for one (batch x chunk, tile pair j <= i), in 3xTF32, written
// in the chunk scan's accumulator order (float4 q of thread tid at q x 128 +
// tid): the heads share B and C, so the float32 scan reads it instead of
// recomputing it per head.
template <int DSP>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_cb(const Args p) {
  using L = Tiles<float, DSP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int bk = blockIdx.x, pair = blockIdx.y;  // pair = it (it + 1) / 2 + jt
  int it = (int)((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  while (it * (it + 1) / 2 > pair) --it;
  const int jt = pair - it * (it + 1) / 2;
  const int b = bk / p.nc, k = bk - b * p.nc, c = p.c;
  const int64_t t0 = (int64_t)k * c;
  const int i0 = it * kT, j0 = jt * kT;
  const float* cpp = static_cast<const float*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* bpp = static_cast<const float*>(p.Bm) + b * p.bb + t0 * p.bl;
  load_tile<float, DSP>(base, cpp + i0 * p.cl, p.cl, min(kT, c - i0), p.ds, tid);
  load_tile<float, DSP>(base + L::kBBytes, bpp + j0 * p.bl, p.bl, min(kT, c - j0), p.ds,
                        tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[32];
  mma_abt_f32<DSP>(acc, smem, smem + L::kBBytes, p.ds, 16 * warp + g, g, t);
  float4* o = reinterpret_cast<float4*>(p.cbt) + ((int64_t)bk * p.npairs + pair) * 8 * kThreads +
              tid;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    o[q * kThreads] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// ------------------------------------------------------------------- host

template <typename T, int DSP>
int launch(const Args& a, int batch, int smem_state, int smem_scan,
           cudaStream_t stream) {
  using L = Tiles<T, DSP>;
  if (smem_state != L::state_smem(a.c) || smem_scan != L::kScan) return kErrPlan;
  static bool attr_set[64] = {};  // per device: the shared-memory opt-ins
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(ssd_chunk_state<T, DSP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::state_smem(kMaxChunk));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_scan<T, DSP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kScan);
    if constexpr (L::kCB) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(ssd_chunk_cb<DSP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kCBSmem);
    }
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  if constexpr (L::kCB) {
    ssd_chunk_cb<DSP><<<dim3(batch * a.nc, a.npairs), kThreads, L::kCBSmem, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_chunk_state<T, DSP><<<dim3(batch * a.nc, a.nh, DSP / L::kStateW), kThreads, smem_state,
                            stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass<T><<<dim3((a.hd * a.ds + 4 * kPassThreads - 1) / (4 * kPassThreads), a.nh, batch),
                   kPassThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_scan<T, DSP><<<dim3(batch * a.nc, a.nh, a.nt), kThreads, smem_scan, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A, D, the state
// and the scratch are float32: cs and v (b x chunks x nh x chunk), states
// and sin (b x chunks x nh x hd x ds), and for float32 only cbt (b x chunks
// x tile pairs x 64 x 64; null for bf16).  strides: 10 element strides, (batch, seq, head) for x
// and dt, (batch, seq) for B and C.  L % chunk == 0.  state_pad /
// smem_state / smem_scan: the wrapper's launch plan.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* D, void* y,
                 void* state, void* cs, void* v, void* states, void* sin, void* cbt,
                 int batch,
                 int L, int nh,
                 int hd, int ds, int chunk, const int64_t* strides, int state_pad,
                 int smem_state, int smem_scan, void* stream) {
  if (batch == 0 || nh == 0) return 0;
  if (L <= 0 || chunk <= 0 || chunk > kMaxChunk || L % chunk != 0 || hd <= 0 ||
      hd > kHdp || hd % 8 != 0 || ds <= 0 || ds > state_pad || ds % 8 != 0 ||
      batch > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.state = static_cast<float*>(state);
  a.cs = static_cast<float*>(cs);
  a.v = static_cast<float*>(v);
  a.states = static_cast<float*>(states);
  a.sin = sin;
  a.cbt = static_cast<float*>(cbt);
  a.L = L;
  a.nh = nh;
  a.hd = hd;
  a.ds = ds;
  a.c = chunk;
  a.nc = L / chunk;
  a.nt = (chunk + kT - 1) / kT;
  a.npairs = a.nt * (a.nt + 1) / 2;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (state_pad == 64) return launch<__nv_bfloat16, 64>(a, batch, smem_state, smem_scan, s);
    if (state_pad == 128) return launch<__nv_bfloat16, 128>(a, batch, smem_state, smem_scan, s);
  } else if (dtype == 0) {
    if (state_pad == 64) return launch<float, 64>(a, batch, smem_state, smem_scan, s);
    if (state_pad == 128) return launch<float, 128>(a, batch, smem_state, smem_scan, s);
  }
  return kErrPlan;
}

}  // extern "C"
