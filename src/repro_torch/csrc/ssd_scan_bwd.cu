// Mamba-2 SSD chunked scan, backward, for NVIDIA Hopper (sm_90a): chunks in
// parallel, float32 arithmetic on the CUDA cores.
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
// Design: the forward's decomposition transposed; four kernels a call on
// PyTorch's current stream:
//
// 1. ssd_bwd_local, grid (batch x chunks, heads): each chunk's own
//    sum_i e^{cs_i} dy_i C_i^T, a (hd x c) . (c x ds) product (chunk 0's is
//    not needed and not formed);
// 2. ssd_bwd_pass, grid (hd ds / 256, heads, batch), one state element a
//    thread: dS_out[k] = e^{cs_last[k+1]} dS_out[k+1] + local[k+1], in order
//    from the last chunk, starting from dS;
// 3. ssd_bwd_chunk, grid (batch x chunks, heads), 256 threads: C.B^T and
//    dy.x^T of each 64 x 64 tile pair j <= i recomputed; phase 1 walks the j
//    tiles (dx_j, per-head dB_j, ddt's direct term and the straddling sums),
//    phase 2 the i tiles (per-head dC_i, the incoming state's terms); then
//    ddt, and per-chunk partials of dA and dD;
// 4. ssd_bwd_reduce: dB and dC summed over the heads, dA and dD over batch
//    and chunks, each in a fixed order.
// No atomics: two calls are bit-equal.
//
// The forward's values are reused, not recomputed: cs (its chunk-state
// kernel's prefix sums in XLA's blocks-of-16 order, so the decays are the
// forward's bit for bit) and the entering states S_in.  For bfloat16 the
// forward keeps S_in as the hi and lo bf16 planes its chunk scan multiplies
// (ssd_scan.cu); their sum is S_in to 2^-17 of itself, the value the
// forward used, so the backward reads the two planes (the bytes of one
// float32 copy) and adds them instead of keeping another copy.
//
// What bounds it on the H100: at mamba2-780m's train shape (b 4, l 1024,
// 48 heads x 64, ds 128, c 256) the function needs about 32 GFLOP (the
// causal half of the dy.x^T, M^T dy, N^T C and N B products per head, the
// four (c x hd x ds) state products) and moves about 81 MB in bf16 (x, dy,
// dx, B, C, dB, dC, dt, ddt): 0.033 ms at bf16's tensor-core peak against
// 0.024 ms of HBM time, so bound by operations.  This kernel runs them on
// the CUDA cores in float32 with 64-row tiles in shared memory (register
// tiles of 4 x 4 and 4 x ds/16 a thread), one CTA an SM at ds 128: the first
// design that is right, far above its bound; wgmma and TMA are a later
// redesign's.  The per-head partials of dB and dC (b x l x nh x ds float32
// each) cost a write and a read outside the bound.
//
// Inputs are read through strides: x, B and C as views into the mixer's xBC
// activation (unit stride in their last dim, 16-byte aligned bases and
// strides, as the forward takes them); dx, dB and dC are written through
// their own strides (the wrapper hands out views of one xBC-shaped
// buffer); dy is contiguous.  The wrapper allocates outputs and scratch and
// passes its launch plan; the launcher refuses a plan that differs from its
// instantiations, never synchronises, allocates nothing, and returns
// cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows of a tile
constexpr int kHdp = 64;          // head dim padded
constexpr int kHS = kHdp + 1;     // row stride (floats) of x / dy / product tiles: odd, no bank conflicts
constexpr int kThreads = 256;     // 16 x 16: a thread holds rows ty + 16 r, columns tx + 16 q
constexpr int kPassThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kMaxChunk = 1024;
constexpr int kRed = kThreads + 16;  // block-sum scratch
constexpr int kErrPlan = 10003;      // plan differs from every instantiation

template <int DSP>
struct Layout {
  static constexpr int kSS = DSP + 1;    // row stride of B / C / state tiles: odd
  static constexpr int kPer = DSP / 16;  // ds columns a thread holds
  // chunk kernel: x_j, dy_i, M, N, W tiles (M, N, W also hold one hd x ds
  // state tile), B_j, C_i; cs, dt, row carries, straddling sums, ddt's
  // direct term, V, H of the chunk; the block-sum scratch
  static constexpr int chunk_floats(int c) { return 5 * kT * kHS + 2 * kT * kSS + 7 * c + kRed; }
  // local kernel: dy_i, C_i, e^{cs_i}
  static constexpr int kLocalFloats = kT * kHS + kT * kSS + kT;
  static_assert(3 * kT * kHS >= kHdp * kSS, "a state tile fits over M, N, W");
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
  float* dsout;          // (b, nc, nh, hd, ds) scratch: gradient of the state leaving each chunk
  void* dx;              // x's dtype, strided
  float* ddt;            // (b, l, nh) contiguous
  float* dA;             // (nh,)
  float* dD;             // (nh,)
  void* dB;              // x's dtype, strided
  void* dC;
  float* pB;             // (b, nc, nh, c, ds) per-head partials of dB
  float* pC;             // ... of dC
  float* pA;             // (b, nc, nh) per-chunk partials of dA
  float* pD;             // ... of dD
  int batch, L, nh, hd, ds, c, nc, nt;
  // element strides: x (batch, seq, head), dt (batch, seq, head), B and C
  // (batch, seq), dx (batch, seq, head), dB and dC (batch, seq)
  int64_t xb, xl, xh, tb, tl, th, bb, bl, cb, cl, gxb, gxl, gxh, gbb, gbl, gcb, gcl;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// An element of the forward's entering state: float32, or hi + lo planes.
__device__ __forceinline__ float ld_sin(const float* s, int64_t bkh, int64_t n, int64_t idx) {
  return s[bkh * n + idx];
}
__device__ __forceinline__ float ld_sin(const __nv_bfloat16* s, int64_t bkh, int64_t n,
                                        int64_t idx) {
  return __bfloat162float(s[bkh * 2 * n + idx]) + __bfloat162float(s[bkh * 2 * n + n + idx]);
}

// Rows [0, 64) x columns [0, W) of a row-major global matrix (row stride ld)
// into a float tile of row stride S; zero past nrows and ncols.
template <typename T, int W, int S>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t ld, int nrows,
                                          int ncols) {
  for (int e = threadIdx.x; e < kT * W; e += kThreads) {
    const int r = e / W, col = e - r * W;
    dst[r * S + col] = (r < nrows && col < ncols) ? to_f(src[r * ld + col]) : 0.f;
  }
}

// An (hd x ds) float32 state into a tile [hd rows][kSS]; zero past hd, ds.
template <typename T, int DSP>
__device__ __forceinline__ void load_state(float* dst, const T* src, int64_t bkh, int hd,
                                           int ds) {
  constexpr int kSS = DSP + 1;
  const int64_t n = (int64_t)hd * ds;
  for (int e = threadIdx.x; e < kHdp * DSP; e += kThreads) {
    const int r = e / DSP, col = e - r * DSP;
    dst[r * kSS + col] = (r < hd && col < ds) ? ld_sin(src, bkh, n, (int64_t)r * ds + col) : 0.f;
  }
}

// Sum over the 16 threads of one ty (a half warp), in a fixed order.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

// Sum over the CTA, in a fixed order: every thread calls it, every thread
// gets the sum.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += red[i];
    red[kThreads] = s;
  }
  __syncthreads();
  const float s = red[kThreads];
  __syncthreads();
  return s;
}

// ------------------------------------------------- 1. each chunk's own dS_in

template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_local(const BwdArgs p) {
  using Lay = Layout<DSP>;
  constexpr int kSS = Lay::kSS, kPer = Lay::kPer;
  extern __shared__ float sm[];
  float* sDY = sm;
  float* sC = sDY + kT * kHS;
  float* sE = sC + kT * kSS;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc;
  if (k == 0) return;  // the pass never reads chunk 0's
  const int c = p.c;
  const int64_t t0 = (int64_t)k * c, bkh = (int64_t)bk * p.nh + h;
  const int64_t dyl = (int64_t)p.nh * p.hd;
  const T* dyp = static_cast<const T*>(p.dy) + ((int64_t)b * p.L + t0) * dyl + (int64_t)h * p.hd;
  const T* cp = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* csp = p.cs + bkh * c;
  float acc[4][kPer];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[r][q] = 0.f;
  for (int i0 = 0; i0 < c; i0 += kT) {
    const int ni = min(kT, c - i0);
    load_rows<T, kHdp, kHS>(sDY, dyp + i0 * dyl, dyl, ni, p.hd);
    load_rows<T, DSP, kSS>(sC, cp + i0 * p.cl, p.cl, ni, p.ds);
    if (tid < kT) sE[tid] = tid < ni ? expf(csp[i0 + tid]) : 0.f;
    __syncthreads();
    for (int ii = 0; ii < ni; ++ii) {
      const float e = sE[ii];
      float dv[4], cv[kPer];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = sDY[ii * kHS + ty + 16 * r] * e;
#pragma unroll
      for (int q = 0; q < kPer; ++q) cv[q] = sC[ii * kSS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kPer; ++q) acc[r][q] = fmaf(dv[r], cv[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* out = p.local + bkh * p.hd * p.ds;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pr = ty + 16 * r;
    if (pr >= p.hd) continue;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int s = tx + 16 * q;
      if (s < p.ds) out[pr * p.ds + s] = acc[r][q];
    }
  }
}

// ------------------------------------------------- 2. reverse state pass

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass(const BwdArgs p) {
  const int64_t n = (int64_t)p.hd * p.ds;
  const int64_t idx = (int64_t)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= n) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float run = p.dstate ? p.dstate[((int64_t)b * p.nh + h) * n + idx] : 0.f;
  for (int k = p.nc - 1; k >= 0; --k) {
    const int64_t bkh = ((int64_t)b * p.nc + k) * p.nh + h;
    p.dsout[bkh * n + idx] = run;
    if (k > 0)
      run = __fadd_rn(__fmul_rn(run, expf(p.cs[bkh * p.c + p.c - 1])), p.local[bkh * n + idx]);
  }
}

// ------------------------------------------------- 3. chunk gradients

template <typename T, int DSP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const BwdArgs p) {
  using Lay = Layout<DSP>;
  constexpr int kSS = Lay::kSS, kPer = Lay::kPer;
  extern __shared__ float sm[];
  float* sX = sm;               // x_j
  float* sDY = sX + kT * kHS;   // dy_i
  float* sM = sDY + kT * kHS;   // M = C.B^T o L o dt_j, then the straddling prefixes
  float* sN = sM + kT * kHS;    // N = dy.x^T o L o dt_j
  float* sW = sN + kT * kHS;    // G = C.B^T o dy.x^T o L
  float* sSt = sM;              // an (hd x ds) state over M, N, W
  float* sB = sW + kT * kHS;    // B_j
  float* sC = sB + kT * kSS;    // C_i
  const int c = p.c;
  float* sCs = sC + kT * kSS;   // cs of the chunk
  float* sDt = sCs + c;         // dt
  float* sRow = sDt + c;        // per row i: sum of W_ij over the j tiles done
  float* sDa = sRow + c;        // straddling sums of W
  float* sGd = sDa + c;         // ddt's direct term from y: sum_i G_ij
  float* sV = sGd + c;          // e^{cs_i} C_i . S_in^T dy_i
  float* sH = sV + c;           // x_j . dS_out B_j
  float* sRed = sH + c;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bk = blockIdx.x, h = blockIdx.y;
  const int b = bk / p.nc, k = bk - b * p.nc;
  const int64_t t0 = (int64_t)k * c, bkh = (int64_t)bk * p.nh + h;
  const int64_t n = (int64_t)p.hd * p.ds;
  const int64_t dyl = (int64_t)p.nh * p.hd;
  const T* xp = static_cast<const T*>(p.x) + b * p.xb + t0 * p.xl + h * p.xh;
  const T* dyp = static_cast<const T*>(p.dy) + ((int64_t)b * p.L + t0) * dyl + (int64_t)h * p.hd;
  const T* bp = static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bl;
  const T* cp = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cl;
  const float* dtp = p.dt + b * p.tb + t0 * p.tl + h * p.th;
  const T* sinp = static_cast<const T*>(p.sin);

  for (int i = tid; i < c; i += kThreads) {
    sCs[i] = p.cs[bkh * c + i];
    sDt[i] = dtp[i * p.tl];
    sRow[i] = 0.f;
    sDa[i] = 0.f;
    sGd[i] = 0.f;
    sV[i] = 0.f;
    sH[i] = 0.f;
  }
  __syncthreads();
  const float a = p.A[h], dco = p.D[h], last = sCs[c - 1];
  float dsum = 0.f;  // this thread's share of sum_j dy_j . x_j

  // ---- phase 1: j tiles outer; dx_j and dB_j accumulate over the i tiles >= j
  for (int jt = 0; jt < p.nt; ++jt) {
    const int j0 = jt * kT, nj = min(kT, c - j0);
    load_rows<T, kHdp, kHS>(sX, xp + j0 * p.xl, p.xl, nj, p.hd);
    load_rows<T, DSP, kSS>(sB, bp + j0 * p.bl, p.bl, nj, p.ds);
    float adx[4][4], adb[4][kPer];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) adx[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) adb[r][q] = 0.f;
    }
    for (int it = jt; it < p.nt; ++it) {
      const int i0 = it * kT, ni = min(kT, c - i0);
      load_rows<T, kHdp, kHS>(sDY, dyp + i0 * dyl, dyl, ni, p.hd);
      load_rows<T, DSP, kSS>(sC, cp + i0 * p.cl, p.cl, ni, p.ds);
      __syncthreads();
      // C_i . B_j^T and dy_i . x_j^T at rows ty + 16 r (i), columns tx + 16 q (j)
      float cb[4][4], gx[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[r][q] = gx[r][q] = 0.f;
      for (int s = 0; s < p.ds; ++s) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = sC[(ty + 16 * r) * kSS + s];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = sB[(tx + 16 * q) * kSS + s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[r][q] = fmaf(u[r], v[q], cb[r][q]);
      }
      for (int e = 0; e < p.hd; ++e) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = sDY[(ty + 16 * r) * kHS + e];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = sX[(tx + 16 * q) * kHS + e];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) gx[r][q] = fmaf(u[r], v[q], gx[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ii = ty + 16 * r, jj = tx + 16 * q, i = i0 + ii, j = j0 + jj;
          const bool ok = j <= i && i < c;
          const float l = ok ? expf(sCs[i] - sCs[j]) : 0.f;  // exponent <= 0
          const float dtj = ok ? sDt[j] : 0.f;
          sM[ii * kHS + jj] = cb[r][q] * l * dtj;
          sN[ii * kHS + jj] = gx[r][q] * l * dtj;
          sW[ii * kHS + jj] = cb[r][q] * gx[r][q] * l;
          if (it == jt && ii == jj && ok) dsum += gx[r][q];
        }
      }
      __syncthreads();
      // dx_j += M^T dy_i, dB_j += N^T C_i: rows ty + 16 r (j), columns tx + 16 q
      for (int ii = 0; ii < ni; ++ii) {
        float m[4], nn[4], dv[4], cv[kPer];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          m[r] = sM[ii * kHS + ty + 16 * r];
          nn[r] = sN[ii * kHS + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[q] = sDY[ii * kHS + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < kPer; ++q) cv[q] = sC[ii * kSS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) adx[r][q] = fmaf(m[r], dv[q], adx[r][q]);
#pragma unroll
          for (int q = 0; q < kPer; ++q) adb[r][q] = fmaf(nn[r], cv[q], adb[r][q]);
        }
      }
      if (it == jt) {  // + D dy_j (dy_i is dy_j on the diagonal tile)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            adx[r][q] = fmaf(dco, sDY[(ty + 16 * r) * kHS + tx + 16 * q], adx[r][q]);
      }
      __syncthreads();
      if (tid < kT) {
        // ddt's direct term: column sums of G over the rows of this i tile
        if (j0 + tid < c) {
          float s = 0.f;
          for (int ii = 0; ii < ni; ++ii) s += sW[ii * kHS + tid];
          sGd[j0 + tid] += s;
        }
      } else if (tid < 2 * kT) {
        // row ii: the exclusive prefix of W_ij = G_ij dt_j along j, carried
        // over the earlier j tiles, into M's tile
        const int ii = tid - kT;
        if (ii < ni) {
          float run = sRow[i0 + ii];
          for (int kk = 0; kk < kT; ++kk) {
            sM[ii * kHS + kk] = run;
            run += sW[ii * kHS + kk] * (kk < nj ? sDt[j0 + kk] : 0.f);
          }
          sRow[i0 + ii] = run;
        }
      }
      __syncthreads();
      if (tid < kT && tid < nj) {
        // column k: the prefixes of the rows i >= k of this tile
        const int kq = j0 + tid;
        float s = 0.f;
        for (int ii = 0; ii < ni; ++ii)
          if (i0 + ii >= kq) s += sM[ii * kHS + tid];
        sDa[kq] += s;
      }
      __syncthreads();
    }
    // the outgoing state's terms of rows j: dS_out over M, N, W
    load_state<float, DSP>(sSt, p.dsout, bkh, p.hd, p.ds);
    __syncthreads();
    float sx[4][4], sb[4][kPer];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sx[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) sb[r][q] = 0.f;
    }
    for (int s = 0; s < p.ds; ++s) {  // dS_out B_j: rows j, columns p
      float u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = sB[(ty + 16 * r) * kSS + s];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = sSt[(tx + 16 * q) * kSS + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sx[r][q] = fmaf(u[r], v[q], sx[r][q]);
    }
    for (int e = 0; e < p.hd; ++e) {  // dS_out^T x_j: rows j, columns s
      float u[4], v[kPer];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = sX[(ty + 16 * r) * kHS + e];
#pragma unroll
      for (int q = 0; q < kPer; ++q) v[q] = sSt[e * kSS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kPer; ++q) sb[r][q] = fmaf(u[r], v[q], sb[r][q]);
    }
    T* dxp = static_cast<T*>(p.dx) + b * p.gxb + t0 * p.gxl + h * p.gxh;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jj = ty + 16 * r, j = j0 + jj;
      const bool ok = j < c;
      const float w = ok ? sDt[j] * expf(last - sCs[j]) : 0.f;
      float hp = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) hp = fmaf(sX[jj * kHS + tx + 16 * q], sx[r][q], hp);
      hp = sum16(hp);
      if (tx == 0 && ok) sH[j] = hp;
      if (!ok) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pc = tx + 16 * q;
        if (pc < p.hd) store1(dxp + j * p.gxl + pc, fmaf(w, sx[r][q], adx[r][q]));
      }
      float* pb = p.pB + (bkh * c + j) * p.ds;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int s = tx + 16 * q;
        if (s < p.ds) pb[s] = fmaf(w, sb[r][q], adb[r][q]);
      }
    }
    __syncthreads();
  }

  // the state decay's term: e^{cs_last} <dS_out, S_in> (dS_out still staged)
  float ep = 0.f;
  for (int64_t e = tid; e < n; e += kThreads) {
    const int pr = (int)(e / p.ds), s = (int)(e - (int64_t)pr * p.ds);
    ep = fmaf(sSt[pr * kSS + s], ld_sin(sinp, bkh, n, e), ep);
  }
  const float E = expf(last) * block_sum(ep, sRed);

  // ---- phase 2: i tiles outer; dC_i accumulates over the j tiles <= i
  for (int it = 0; it < p.nt; ++it) {
    const int i0 = it * kT, ni = min(kT, c - i0);
    load_rows<T, kHdp, kHS>(sDY, dyp + i0 * dyl, dyl, ni, p.hd);
    load_rows<T, DSP, kSS>(sC, cp + i0 * p.cl, p.cl, ni, p.ds);
    float adc[4][kPer];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kPer; ++q) adc[r][q] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT, nj = min(kT, c - j0);
      load_rows<T, kHdp, kHS>(sX, xp + j0 * p.xl, p.xl, nj, p.hd);
      load_rows<T, DSP, kSS>(sB, bp + j0 * p.bl, p.bl, nj, p.ds);
      __syncthreads();
      float gx[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gx[r][q] = 0.f;
      for (int e = 0; e < p.hd; ++e) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = sDY[(ty + 16 * r) * kHS + e];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = sX[(tx + 16 * q) * kHS + e];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) gx[r][q] = fmaf(u[r], v[q], gx[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ii = ty + 16 * r, jj = tx + 16 * q, i = i0 + ii, j = j0 + jj;
          const bool ok = j <= i && i < c;
          const float l = ok ? expf(sCs[i] - sCs[j]) : 0.f;
          sN[ii * kHS + jj] = gx[r][q] * l * (ok ? sDt[j] : 0.f);
        }
      }
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {  // dC_i += N B_j: rows i, columns s
        float u[4], v[kPer];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = sN[(ty + 16 * r) * kHS + jj];
#pragma unroll
        for (int q = 0; q < kPer; ++q) v[q] = sB[jj * kSS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < kPer; ++q) adc[r][q] = fmaf(u[r], v[q], adc[r][q]);
      }
      __syncthreads();
    }
    // the incoming state's terms of rows i: S_in over M, N, W
    load_state<T, DSP>(sSt, sinp, bkh, p.hd, p.ds);
    __syncthreads();
    float st[4][kPer];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kPer; ++q) st[r][q] = 0.f;
    for (int e = 0; e < p.hd; ++e) {  // S_in^T dy_i: rows i, columns s
      float u[4], v[kPer];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = sDY[(ty + 16 * r) * kHS + e];
#pragma unroll
      for (int q = 0; q < kPer; ++q) v[q] = sSt[e * kSS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kPer; ++q) st[r][q] = fmaf(u[r], v[q], st[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ii = ty + 16 * r, i = i0 + ii;
      const bool ok = i < c;
      const float ei = ok ? expf(sCs[i]) : 0.f;
      float vp = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) vp = fmaf(sC[ii * kSS + tx + 16 * q], st[r][q], vp);
      vp = sum16(vp);
      if (tx == 0 && ok) sV[i] = ei * vp;
      if (!ok) continue;
      float* pc = p.pC + (bkh * c + i) * p.ds;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int s = tx + 16 * q;
        if (s < p.ds) pc[s] = fmaf(ei, st[r][q], adc[r][q]);
      }
    }
    __syncthreads();
  }

  // ---- dL/da_k = straddle_k + sum_{i>=k} V_i + E + sum_{j<k} U_j
  if (tid == 0) {
    float run = 0.f;
    for (int kq = 0; kq < c; ++kq) {
      const float u = sDt[kq] * expf(last - sCs[kq]) * sH[kq];
      sRow[kq] = run;
      run += u;
    }
  } else if (tid == 32) {
    float run = 0.f;
    for (int kq = c - 1; kq >= 0; --kq) {
      run += sV[kq];
      sV[kq] = run;
    }
  }
  __syncthreads();
  float ap = 0.f;
  float* ddtp = p.ddt + ((int64_t)b * p.L + t0) * p.nh + h;
  for (int kq = tid; kq < c; kq += kThreads) {
    const float da = sDa[kq] + sV[kq] + E + sRow[kq];
    ddtp[(int64_t)kq * p.nh] = sGd[kq] + expf(last - sCs[kq]) * sH[kq] + a * da;
    ap = fmaf(sDt[kq], da, ap);
  }
  const float sa = block_sum(ap, sRed);
  const float sd = block_sum(dsum, sRed);
  if (tid == 0) {
    p.pA[bkh] = sa;
    p.pD[bkh] = sd;
  }
}

// ------------------------------------------------- 4. ordered reductions

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
    const int64_t hs = (int64_t)p.c * p.ds;
    const int64_t base = ((int64_t)b * p.nc + k) * p.nh * hs + (int64_t)i * p.ds + s;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < p.nh; ++h) {  // heads in order
      sb += p.pB[base + h * hs];
      sc += p.pC[base + h * hs];
    }
    store1(static_cast<T*>(p.dB) + b * p.gbb + t * p.gbl + s, sb);
    store1(static_cast<T*>(p.dC) + b * p.gcb + t * p.gcl + s, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < p.nh; h += kReduceThreads) {
      float sa = 0.f, sd = 0.f;
      for (int bk = 0; bk < p.batch * p.nc; ++bk) {  // batch and chunks in order
        sa += p.pA[(int64_t)bk * p.nh + h];
        sd += p.pD[(int64_t)bk * p.nh + h];
      }
      p.dA[h] = sa;
      p.dD[h] = sd;
    }
  }
}

// ------------------------------------------------------------------- host

template <typename T, int DSP>
int launch(const BwdArgs& a, int smem_chunk, int smem_local, cudaStream_t stream) {
  using Lay = Layout<DSP>;
  if (smem_chunk != 4 * Lay::chunk_floats(a.c) || smem_local != 4 * Lay::kLocalFloats)
    return kErrPlan;
  static bool attr_set[64] = {};  // per device: the shared-memory opt-ins
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(ssd_bwd_chunk<T, DSP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * Lay::chunk_floats(kMaxChunk));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_local<T, DSP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * Lay::kLocalFloats);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  ssd_bwd_local<T, DSP><<<dim3(a.batch * a.nc, a.nh), kThreads, smem_local, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)a.hd * a.ds;
  ssd_bwd_pass<<<dim3((unsigned)((n + kPassThreads - 1) / kPassThreads), a.nh, a.batch),
                 kPassThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<T, DSP><<<dim3(a.batch * a.nc, a.nh), kThreads, smem_chunk, stream>>>(a);
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
// D, dstate (null: zero), cs, ddt, dA, dD and the scratch are float32; sin
// is the forward's entering-state buffer (float32, or its bf16 hi and lo
// planes).  Scratch: local and dsout (b x chunks x nh x hd x ds), pB and pC
// (b x chunks x nh x chunk x ds), pA and pD (b x chunks x nh).  strides: 17
// element strides, (batch, seq, head) for x and dt, (batch, seq) for B and
// C, (batch, seq, head) for dx, (batch, seq) for dB and dC.  L % chunk == 0.
// state_pad / smem_chunk / smem_local: the wrapper's launch plan.
int ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* D, const void* dy, const void* dstate,
                 const void* cs, const void* sin, void* local, void* dsout, void* dx,
                 void* ddt, void* dA, void* dB, void* dC, void* dD, void* pB, void* pC,
                 void* pA, void* pD, int batch, int L, int nh, int hd, int ds, int chunk,
                 const int64_t* strides, int state_pad, int smem_chunk, int smem_local,
                 void* stream) {
  if (batch == 0 || nh == 0) return 0;
  if (L <= 0 || chunk <= 0 || chunk > kMaxChunk || L % chunk != 0 || hd <= 0 || hd > kHdp ||
      hd % 8 != 0 || ds <= 0 || ds > state_pad || ds % 8 != 0 || batch > 65535 || nh > 65535)
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
  a.dsout = static_cast<float*>(dsout);
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
    if (state_pad == 16) return launch<__nv_bfloat16, 16>(a, smem_chunk, smem_local, s);
    if (state_pad == 32) return launch<__nv_bfloat16, 32>(a, smem_chunk, smem_local, s);
    if (state_pad == 64) return launch<__nv_bfloat16, 64>(a, smem_chunk, smem_local, s);
    if (state_pad == 128) return launch<__nv_bfloat16, 128>(a, smem_chunk, smem_local, s);
  } else if (dtype == 0) {
    if (state_pad == 16) return launch<float, 16>(a, smem_chunk, smem_local, s);
    if (state_pad == 32) return launch<float, 32>(a, smem_chunk, smem_local, s);
    if (state_pad == 64) return launch<float, 64>(a, smem_chunk, smem_local, s);
    if (state_pad == 128) return launch<float, 128>(a, smem_chunk, smem_local, s);
  }
  return kErrPlan;
}

}  // extern "C"
