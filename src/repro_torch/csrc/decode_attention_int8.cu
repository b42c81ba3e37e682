// Decode attention over an int8 KV cache (split-S flash decoding) for
// NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_int8` in
// src/repro/kernels/decode_attention/kernel.py (_kernel).  It computes what
// that kernel computes: one query token per (batch, head) with kv head =
// head / rep (GQA, MQA), keys and values int8 (b, S, nkv, hd) with float32
// per-(position, kv head) scales (b, S, nkv), dequantised after the load,
// scores = (q . k) * scale over the keys k_pos <= pos only, a float32
// softmax, and out = softmax . v written in q's dtype.  Keys past pos are
// never read.  Like the TPU kernel it has no window and no softcap; unlike it
// it needs no S % block == 0 (a ragged last tile is masked), and a pos < 0
// gives zeros, as the TPU kernel's empty sums do.
//
// What bounds it on the H100: bytes.  It reads the int8 K and V rows up to
// pos, their scales, q, and writes the output; its 4 * b * nh * (pos + 1) *
// hd operations are negligible.  The TPU grid (b, nkv, S / block) walks S in
// order inside one program: on the card that is b * nkv blocks (32 at
// stablelm-3b, batch 1) for 132 SMs, each a sequential walk.  So S is split:
// pass 1 runs one block of 128 threads per (S split, kv head, batch) for the
// GQA group's rep query rows; it loads 128-key tiles of int8 K and V with
// 16-byte vector loads into shared memory, dequantises in registers, and
// keeps an online softmax (m, l, acc) in float32, written as partials to
// scratch that the wrapper allocates.  Pass 2 runs one block per (head,
// batch), combines the splits and casts to q's dtype.  The splits are laid
// out over the keys that are live at this step, [0, min(pos + 1, S)), which
// both passes compute from pos on the device (pos is a one-element int32
// tensor the kernel reads, as the TPU's scalar prefetch does; a decode loop
// needs no host sync), so every block of pass 1 with a key to read has one
// tile or more and a block that lies wholly beyond pos exits before it loads
// anything.  The wrapper picks the number of splits so that the grid covers
// the card.  This first version is right, not fast: float32 dot products on
// the CUDA cores, no cp.async, TMA or wgmma.
//
// The launcher takes PyTorch's current stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 128;       // keys per tile
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

__device__ __forceinline__ float int8_at(int word, int byte) {
  return (float)(signed char)(word >> (8 * byte));
}

// Keys live at this step and keys per split: split i covers
// [i * per, min((i + 1) * per, live)), and per is a whole number of tiles.
struct Layout {
  int live, per;
};

__device__ __forceinline__ Layout layout(const int* pos_dev, int pos_host, int S,
                                         int nsplit) {
  const int pos = pos_dev ? *pos_dev : pos_host;
  Layout L;
  L.live = pos < 0 ? 0 : (pos >= S ? S : pos + 1);
  const int tiles = (L.live + kTK - 1) / kTK;
  L.per = ((tiles + nsplit - 1) / nsplit) * kTK;
  return L;
}

size_t split_smem_bytes(int rep, int hd) {
  const int ldw = hd / 4 + 1;
  return sizeof(float) * ((size_t)2 * rep * hd + (size_t)rep * kTK + 2 * kTK + 3 * rep) +
         sizeof(int) * (size_t)2 * kTK * ldw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ pos_dev,
                    int pos_host, int S, int nh, int nkv, int hd, int nsplit,
                    float scale, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc) {
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = nh / nkv;
  const Layout L = layout(pos_dev, pos_host, S, nsplit);
  const int s0 = split * L.per;
  if (s0 >= L.live) return;  // wholly beyond pos: nothing to read
  const int s1 = min(s0 + L.per, L.live);

  extern __shared__ float smem[];
  const int ldw = hd / 4 + 1;            // int8 row stride in words: odd, no bank conflicts
  float* sQ = smem;                      // rep x hd
  float* sAcc = sQ + rep * hd;           // rep x hd
  float* sS = sAcc + rep * hd;           // rep x kTK: scores, then p
  float* sKs = sS + rep * kTK;           // kTK
  float* sVs = sKs + kTK;                // kTK
  float* sM = sVs + kTK;                 // rep: running max
  float* sL = sM + rep;                  // rep: running sum
  float* sAlpha = sL + rep;              // rep: per-tile rescale
  int* sK = reinterpret_cast<int*>(sAlpha + rep);  // kTK x ldw words
  int* sV = sK + kTK * ldw;                        // kTK x ldw words

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h0 = g * rep;  // first query head of the group
  const T* qp = q + ((size_t)b * nh + h0) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) {
    sQ[i] = load_f(qp + i);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  const int vec_per_row = hd / 16;
  for (int t0 = s0; t0 < s1; t0 += kTK) {
    const int n = min(kTK, s1 - t0);
    __syncthreads();  // the previous tile's sK / sV / sS are consumed
    for (int i = tid; i < kTK * vec_per_row; i += kThreads) {
      const int j = i / vec_per_row, c = i - j * vec_per_row;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (j < n) {
        const size_t row = (((size_t)b * S + t0 + j) * nkv + g) * hd + (size_t)c * 16;
        kv = *reinterpret_cast<const int4*>(k + row);
        vv = *reinterpret_cast<const int4*>(v + row);
      }
      int* dk = sK + j * ldw + c * 4;
      int* dv = sV + j * ldw + c * 4;
      dk[0] = kv.x; dk[1] = kv.y; dk[2] = kv.z; dk[3] = kv.w;
      dv[0] = vv.x; dv[1] = vv.y; dv[2] = vv.z; dv[3] = vv.w;
    }
    for (int j = tid; j < kTK; j += kThreads) {
      const size_t si = ((size_t)b * S + t0 + j) * nkv + g;
      sKs[j] = j < n ? ks[si] : 0.f;
      sVs[j] = j < n ? vs[si] : 0.f;
    }
    __syncthreads();

    // scores: thread -> (row r, key j), keys of a warp consecutive
    for (int i = tid; i < rep * kTK; i += kThreads) {
      const int r = i / kTK, j = i - r * kTK;
      float s = kNegInf;
      if (j < n) {
        const float* qr = sQ + r * hd;
        const int* kr = sK + j * ldw;
        float acc = 0.f;
        for (int w = 0; w < hd / 4; ++w) {
          const int word = kr[w];
          acc = fmaf(qr[4 * w + 0], int8_at(word, 0), acc);
          acc = fmaf(qr[4 * w + 1], int8_at(word, 1), acc);
          acc = fmaf(qr[4 * w + 2], int8_at(word, 2), acc);
          acc = fmaf(qr[4 * w + 3], int8_at(word, 3), acc);
        }
        s = acc * sKs[j] * scale;
      }
      sS[r * kTK + j] = s;
    }
    __syncthreads();

    // online softmax: warp -> rows warp, warp + 4, ...; lane -> keys
    for (int r = warp; r < rep; r += kThreads / 32) {
      float* sr = sS + r * kTK;
      float mx = kNegInf;
      for (int j = lane; j < kTK; j += 32) mx = fmaxf(mx, sr[j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += 32) {
        const float p = j < n ? expf(sr[j] - m_new) : 0.f;
        sr[j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . (v * v_scale)
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = sS + r * kTK;
      const int* vc = sV + (d >> 2);
      const int byte = d & 3;
      float pv = 0.f;
      for (int j = 0; j < n; ++j)
        pv = fmaf(pr[j], int8_at(vc[j * ldw], byte) * sVs[j], pv);
      sAcc[i] = sAcc[i] * sAlpha[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    part_acc[(((size_t)b * nh + h0 + r) * nsplit + split) * hd + d] = sAcc[i];
  }
  for (int r = tid; r < rep; r += kThreads) {
    const size_t at = ((size_t)b * nh + h0 + r) * nsplit + split;
    part_m[at] = sM[r];
    part_l[at] = sL[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ pos_dev, int pos_host, int S,
                      int nh, int hd, int nsplit, T* __restrict__ out) {
  extern __shared__ float sW[];  // nsplit: each live split's weight
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const Layout L = layout(pos_dev, pos_host, S, nsplit);
  const int nlive = L.live > 0 ? (L.live + L.per - 1) / L.per : 0;
  const size_t base = ((size_t)b * nh + h) * nsplit;
  float M = kNegInf;
  for (int i = 0; i < nlive; ++i) M = fmaxf(M, part_m[base + i]);
  for (int i = threadIdx.x; i < nlive; i += blockDim.x) sW[i] = expf(part_m[base + i] - M);
  __syncthreads();
  float l = 0.f;
  for (int i = 0; i < nlive; ++i) l = fmaf(part_l[base + i], sW[i], l);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = out + ((size_t)b * nh + h) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < nlive; ++i) acc = fmaf(part_acc[(base + i) * hd + d], sW[i], acc);
    store_f(op + d, acc * inv);
  }
}

template <typename T>
int launch(const void* q, const int8_t* k, const float* ks, const int8_t* v,
           const float* vs, const int* pos_dev, int pos_host, int B, int S,
           int nh, int nkv, int hd, int nsplit, float scale, float* part_m,
           float* part_l, float* part_acc, void* out, cudaStream_t stream) {
  const int rep = nh / nkv;
  const size_t smem = split_smem_bytes(rep, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_split_kernel<T><<<dim3(nsplit, nkv, B), kThreads, smem, stream>>>(
      (const T*)q, k, ks, v, vs, pos_dev, pos_host, S, nh, nkv, hd, nsplit,
      scale, part_m, part_l, part_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<dim3(nh, B), kThreads, nsplit * sizeof(float), stream>>>(
      part_m, part_l, part_acc, pos_dev, pos_host, S, nh, hd, nsplit, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  q (B, nh, hd), k / v
// int8 (B, S, nkv, hd), ks / vs float32 (B, S, nkv), all contiguous, k and v
// 16-byte aligned.  pos_dev: a device int32 holding pos, or null to take
// pos_host.  Scratch: part_m, part_l (B, nh, nsplit), part_acc (B, nh,
// nsplit, hd), float32.  out (B, nh, hd) in q's dtype.
int decode_attention_int8_fwd(int dtype, const void* q, const void* k,
                              const void* ks, const void* v, const void* vs,
                              const void* pos_dev, int pos_host, int B, int S,
                              int nh, int nkv, int hd, int nsplit, float scale,
                              void* part_m, void* part_l, void* part_acc,
                              void* out, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || hd < 16 || hd > 256 || hd % 16 != 0 ||
      nsplit <= 0 || nsplit > 8192 || nkv > 65535 || B > 65535 || nh > 65535 ||
      split_smem_bytes(nh / nkv, hd) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* k8 = (const int8_t*)k;
  const int8_t* v8 = (const int8_t*)v;
  const int* pd = (const int*)pos_dev;
  if (dtype == 0)
    return launch<float>(q, k8, (const float*)ks, v8, (const float*)vs, pd,
                         pos_host, B, S, nh, nkv, hd, nsplit, scale,
                         (float*)part_m, (float*)part_l, (float*)part_acc, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k8, (const float*)ks, v8, (const float*)vs,
                                 pd, pos_host, B, S, nh, nkv, hd, nsplit, scale,
                                 (float*)part_m, (float*)part_l,
                                 (float*)part_acc, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
