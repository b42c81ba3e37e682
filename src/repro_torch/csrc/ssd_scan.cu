// Mamba-2 SSD chunked scan (forward) for NVIDIA Hopper, sm_90a.
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
// out after the last one.  Only pairs j <= i are visited, so the positive
// exponents of the upper triangle (inf, then inf * 0 = NaN) are never formed:
// the reference masks the exponent before exp for the same reason.
//
// Layout.  The TPU grid (batch, head, chunk) runs its chunk axis in order
// and keeps the state in VMEM.  Here one block of 256 threads owns one
// (batch, head) and loops over the chunks itself; the state lives in
// registers (8 x 4 values a thread, hd <= 64, ds <= 128) and is mirrored to
// shared memory once per chunk for the inter-chunk term.  A chunk is cut into
// tiles of 64 rows: for each row tile i, the C tile is staged once, and for
// each row tile j <= i the B and x tiles are staged (float, widened from bf16
// on load); P = (C_i B_j^T) * decay * dt on the causal part goes through
// shared memory, then y_i += P x_j.  The last row tile visits every j tile,
// and the state update is taken there from the staged B and x.  Shared
// memory at c 256, hd 64, ds 128: state 33 KB + C, B 66 KB + x 16 KB +
// P 17 KB + dt, cs, w 3 KB = 135 KB of the 227 KB a block may have.
//
// The prefix sum is one thread's sequential float32 loop over the chunk,
// multiply then add, each rounded (no FMA), in the order of PyTorch's CUDA
// cumsum along a non-innermost dim (one sequential loop per column): the
// decays are differences of cs, which reaches about -80 within a chunk, so
// a different summation order would move them by an ulp of 80 (7.6e-6) and
// use up the float32 tolerance against the plain version.
//
// What bounds it on the H100: at mamba2-780m (b 1, l 1024, nh 48, hd 64,
// ds 128, c 256) the function needs 2.45 GFLOP: the causal half of C.B^T,
// c(c+1) ds, once per (batch, chunk), since the heads share B and C, and
// c(c+1) hd + 4 c hd ds per (batch, head, chunk).  The bytes are 15 MB (x, y
// in bf16, B, C, dt, the state).  That is 2.5 us of bf16 tensor-core time
// and 4.4 us of HBM time: bound by bytes.  This first version is the
// simple, exact one: float32 FMAs on the CUDA cores from shared memory with
// 4 x 4 register tiles, no wgmma, no TMA, and one block per (batch, head),
// i.e. 48 blocks for 132 SMs at batch 1; C.B^T is recomputed for every head
// though B and C are shared by all heads (4.0 GFLOP done for the 2.45
// needed).  It will sit far above its bound; the chunk-parallel split
// (state pieces per chunk, then a short pass over the states) and wgmma
// products are later work, and its times are recorded in PERF.md.
//
// Inputs are read through strides: x, B and C are views into the mixer's
// xBC activation (row stride d_inner + 2 ds), with unit stride in their last
// dim.  y and the state are contiguous.  The launcher takes PyTorch's
// current stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // rows per tile of a chunk (i and j)
constexpr int kThreads = 256;    // 16 x 16 for P and y, 8 x 32 for the state
constexpr int kMaxHd = 64;
constexpr int kMaxDs = 128;
constexpr int kMaxChunk = 4096;
constexpr int kStRows = kMaxHd / 8;   // state rows a thread owns
constexpr int kStCols = kMaxDs / 32;  // state columns a thread owns

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// element strides: x (batch, seq, head), dt (batch, seq, head), B and C
// (batch, seq); the last dim of x, B and C has stride 1
struct Strides {
  int64_t xb, xl, xh, tb, tl, th, bb, bl, cb, cl;
};

size_t smem_floats(int hd, int ds, int c) {
  const size_t ldc = ds + 1;
  return hd * ldc + 2 * kT * ldc + (size_t)kT * hd + (size_t)kT * (kT + 1) +
         3 * (size_t)c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ state_out, int L,
                int nh, int hd, int ds, int c, Strides st) {
  extern __shared__ float smem[];
  const int ldc = ds + 1;            // odd row stride: no bank conflicts
  float* sS = smem;                  // hd x ldc: the state entering the chunk
  float* sC = sS + hd * ldc;         // kT x ldc: C rows of tile i
  float* sB = sC + kT * ldc;         // kT x ldc: B rows of tile j
  float* sX = sB + kT * ldc;         // kT x hd:  x rows of tile j
  float* sP = sX + kT * hd;          // kT x (kT + 1): the masked products
  float* sDt = sP + kT * (kT + 1);   // c: dt
  float* sCs = sDt + c;              // c: inclusive prefix sum of dt * A
  float* sW = sCs + c;               // c: dt_j exp(cs_last - cs_j)

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], dcoef = D[h];
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16 r, cols tx + 16 q
  const int py = tid >> 5, sx = tid & 31;  // state rows py + 8 r, cols sx + 32 q

  const T* xp = x + b * st.xb + h * st.xh;
  const float* dtp = dt + b * st.tb + h * st.th;
  const T* bp = Bm + b * st.bb;
  const T* cp = Cm + b * st.cb;
  const int64_t yl = (int64_t)nh * hd;     // y is contiguous (b, l, nh, hd)
  T* yp = y + (int64_t)b * L * yl + (int64_t)h * hd;

  float reg[kStRows][kStCols];
#pragma unroll
  for (int r = 0; r < kStRows; ++r)
#pragma unroll
    for (int q = 0; q < kStCols; ++q) reg[r][q] = 0.f;
  for (int i = tid; i < hd * ldc; i += kThreads) sS[i] = 0.f;

  const int nt = (c + kT - 1) / kT;
  for (int t0 = 0; t0 < L; t0 += c) {
    __syncthreads();  // the previous chunk's reads of sDt / sCs / sW are done
    for (int i = tid; i < c; i += kThreads) sDt[i] = dtp[(int64_t)(t0 + i) * st.tl];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        run = __fadd_rn(run, __fmul_rn(sDt[i], a));
        sCs[i] = run;
      }
    }
    __syncthreads();
    const float total = sCs[c - 1];
    for (int i = tid; i < c; i += kThreads) sW[i] = sDt[i] * expf(total - sCs[i]);
    const float carry = expf(total);
#pragma unroll
    for (int r = 0; r < kStRows; ++r)
#pragma unroll
      for (int q = 0; q < kStCols; ++q) reg[r][q] *= carry;

    for (int it = 0; it < nt; ++it) {
      const int r0 = it * kT, ni = min(kT, c - r0);
      __syncthreads();  // sW is written; the previous tile's sC reads are done
      for (int i = tid; i < kT * ds; i += kThreads) {
        const int r = i / ds, s = i - r * ds;
        sC[r * ldc + s] = r < ni ? load_f(cp + (int64_t)(t0 + r0 + r) * st.cl + s) : 0.f;
      }
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, nj = min(kT, c - j0);
        __syncthreads();  // the previous j tile's sB / sX / sP are consumed
        for (int i = tid; i < kT * ds; i += kThreads) {
          const int r = i / ds, s = i - r * ds;
          sB[r * ldc + s] = r < nj ? load_f(bp + (int64_t)(t0 + j0 + r) * st.bl + s) : 0.f;
        }
        for (int i = tid; i < kT * hd; i += kThreads) {
          const int r = i / hd, p = i - r * hd;
          sX[i] = r < nj ? load_f(xp + (int64_t)(t0 + j0 + r) * st.xl + p) : 0.f;
        }
        __syncthreads();

        // P = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0
        {
          float s4[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) s4[r][q] = 0.f;
          for (int k = 0; k < ds; ++k) {
            float cv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldc + k];
#pragma unroll
            for (int q = 0; q < 4; ++q) bv[q] = sB[(tx + 16 * q) * ldc + k];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) s4[r][q] = fmaf(cv[r], bv[q], s4[r][q]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int li = ty + 16 * r, lj = tx + 16 * q;
              const int i = r0 + li, j = j0 + lj;
              float pv = 0.f;
              if (li < ni && lj < nj && j <= i)
                pv = s4[r][q] * expf(sCs[i] - sCs[j]) * sDt[j];
              sP[li * (kT + 1) + lj] = pv;
            }
        }

        // the last row tile visits every j tile: take the state update here
        if (it == nt - 1) {
          for (int jj = 0; jj < nj; ++jj) {
            const float w = sW[j0 + jj];
            float bw[kStCols];
#pragma unroll
            for (int q = 0; q < kStCols; ++q) {
              const int s = sx + 32 * q;
              bw[q] = s < ds ? sB[jj * ldc + s] * w : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kStRows; ++r) {
              const int p = py + 8 * r;
              const float xv = p < hd ? sX[jj * hd + p] : 0.f;
#pragma unroll
              for (int q = 0; q < kStCols; ++q) reg[r][q] = fmaf(xv, bw[q], reg[r][q]);
            }
          }
        }
        __syncthreads();

        // y_i += P x_j
        for (int jj = 0; jj < nj; ++jj) {
          float pv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * (kT + 1) + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            xv[q] = p < hd ? sX[jj * hd + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(pv[r], xv[q], acc[r][q]);
        }
      }

      // inter-chunk term exp(cs_i) (C_i . state), then D x_i; write y
      float in4[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) in4[r][q] = 0.f;
      for (int k = 0; k < ds; ++k) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldc + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          sv[q] = p < hd ? sS[p * ldc + k] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) in4[r][q] = fmaf(cv[r], sv[q], in4[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int li = ty + 16 * r;
        if (li >= ni) continue;
        const int i = r0 + li;
        const float e = expf(sCs[i]);
        const int64_t row = t0 + i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p >= hd) continue;
          float v = acc[r][q] + in4[r][q] * e;
          v += dcoef * load_f(xp + row * st.xl + p);
          store_f(yp + row * yl + p, v);
        }
      }
    }

    __syncthreads();  // every read of the entering state is done
#pragma unroll
    for (int r = 0; r < kStRows; ++r) {
      const int p = py + 8 * r;
#pragma unroll
      for (int q = 0; q < kStCols; ++q) {
        const int s = sx + 32 * q;
        if (p < hd && s < ds) sS[p * ldc + s] = reg[r][q];
      }
    }
  }

  float* so = state_out + ((int64_t)b * nh + h) * hd * ds;
#pragma unroll
  for (int r = 0; r < kStRows; ++r) {
    const int p = py + 8 * r;
#pragma unroll
    for (int q = 0; q < kStCols; ++q) {
      const int s = sx + 32 * q;
      if (p < hd && s < ds) so[p * ds + s] = reg[r][q];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* state, int batch,
           int L, int nh, int hd, int ds, int c, const Strides& st,
           cudaStream_t stream) {
  const size_t smem = smem_floats(hd, ds, c) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nh, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (T*)y, (float*)state, L, nh, hd, ds, c,
      st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A, D and the state
// are float32.  strides: 10 element strides, (batch, seq, head) for x and
// dt, (batch, seq) for B and C.  L % chunk == 0.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* D, void* y,
                 void* state, int batch, int L, int nh, int hd, int ds,
                 int chunk, const int64_t* strides, void* stream) {
  if (batch == 0 || nh == 0) return 0;
  if (L <= 0 || chunk <= 0 || chunk > kMaxChunk || L % chunk != 0 ||
      hd <= 0 || hd > kMaxHd || ds <= 0 || ds > kMaxDs || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, y, state, batch, L, nh, hd, ds,
                         chunk, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, state, batch, L, nh,
                                 hd, ds, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
