// Flash attention forward (online softmax) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (_kernel).  It computes what
// that kernel computes: per (batch, q head) with kv head = q head / rep
// (GQA, MQA), scores = (q . k) * scale, soft-capped (cap * tanh(s / cap))
// BEFORE the causal and sliding-window masks, masked scores set to -1e30,
// an online softmax with a float32 running max m, sum l and accumulator,
// and out = acc / max(l, 1e-30) written in q's dtype.  KV tiles that are
// wholly masked for the q tile (past the causal frontier, older than the
// window) are skipped, as the TPU kernel's pl.when guard skips them.  Unlike
// the TPU kernel it needs no divisibility: a ragged sequence length is
// masked (padded keys score -1e30, padded query rows are not written), since
// serving requests carry 4 to 256 tokens.
//
// What bounds it on the H100: at the serving shapes (S <= 256, head_dim 32
// to 80) the work is a few MFLOP per head and the inputs a few MB, so a call
// sits near launch latency; in the limit it is bound by operations, two
// matrix products per tile.  This first version is the simple, exact one:
// one block of 128 threads per (q tile of 32 rows, q head, batch); the q
// tile and each 32-row K/V tile are staged in shared memory as float (bf16
// is widened on load, as the TPU kernel widens to float32); scores, the
// softmax and P.V run on the CUDA cores in float32.  It does not use wgmma
// or TMA, so it will not reach the tensor cores' rate; that is later work,
// and its time beside the bound is recorded in PERF.md.  Tensors are read
// through (batch, head, seq) strides with a unit-stride head dim, so the
// model's (b, s, h, d) layout needs no transpose copy.
//
// The launcher takes PyTorch's current stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one warp lane per key)
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

size_t smem_floats(int hd) {
  const int ld = hd + 1;
  return (size_t)kBQ * ld + (size_t)kBK * ld + (size_t)kBK * hd +
         (size_t)kBQ * hd + (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int rep, int S,
                 int Sk, int hd, Strides st, float scale, int causal,
                 int window, float softcap) {
  extern __shared__ float smem[];
  const int ld = hd + 1;                 // odd row stride: no bank conflicts
  float* sQ = smem;                      // kBQ x ld
  float* sK = sQ + kBQ * ld;             // kBK x ld
  float* sV = sK + kBK * ld;             // kBK x hd
  float* sAcc = sV + kBK * hd;           // kBQ x hd
  float* sP = sAcc + kBQ * hd;           // kBQ x (kBK + 1): scores, then p
  float* sM = sP + kBQ * (kBK + 1);      // running max
  float* sL = sM + kBQ;                  // running sum
  float* sAlpha = sL + kBQ;              // per-tile rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + (h / rep) * st.kh;
  const T* vp = v + b * st.vb + (h / rep) * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    sQ[r * ld + d] = q0 + r < S ? load_f(qp + (q0 + r) * st.qs + d) : 0.f;
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // live KV tiles for this q tile: [kt_lo, kt_hi)
  const int q_hi = q0 + kBQ - 1;
  int kt_lo = 0;
  int kt_hi = (Sk + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, q_hi / kBK + 1);
  if (window > 0) {
    const int first = q0 - window + 1;  // oldest key any row may see
    if (first > 0) kt_lo = first / kBK;
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const bool in = k0 + r < Sk;
      sK[r * ld + d] = in ? load_f(kp + (k0 + r) * st.ks + d) : 0.f;
      sV[r * hd + d] = in ? load_f(vp + (k0 + r) * st.vs + d) : 0.f;
    }
    __syncthreads();

    // scores: thread -> query row tid / 4, keys (tid % 4) + 4 j
    {
      const int r = tid >> 2;
      const int qpos = q0 + r;
      for (int j = 0; j < kBK / 4; ++j) {
        const int c = (tid & 3) + 4 * j;
        const float* qr = sQ + r * ld;
        const float* kr = sK + c * ld;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        float s = acc * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kpos = k0 + c;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        sP[r * (kBK + 1) + c] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp -> 8 rows, lane -> key
    for (int rr = 0; rr < kBQ / 4; ++rr) {
      const int r = warp * (kBQ / 4) + rr;
      const float s = sP[r * (kBK + 1) + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      sP[r * (kBK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    for (int i = tid; i < kBQ * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = sP + r * (kBK + 1);
      float pv = 0.f;
      for (int j = 0; j < kBK; ++j) pv = fmaf(pr[j], sV[j * hd + d], pv);
      sAcc[i] = sAcc[i] * sAlpha[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    if (q0 + r < S) store_f(op + (q0 + r) * st.os + d, sAcc[i] / fmaxf(sL[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int S, int Sk, int hd, const Strides& st, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H / KVH, S, Sk, hd, st,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v, o in that order; the head dim has stride 1.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int KVH, int S,
                        int Sk, int hd, const int64_t* strides, float scale,
                        int causal, int window, float softcap, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, KVH, S, Sk, hd, st, scale, causal,
                         window, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KVH, S, Sk, hd, st, scale,
                                 causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
