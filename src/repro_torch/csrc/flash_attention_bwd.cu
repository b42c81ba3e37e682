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
//   D  = sum_d dO . O          (per row, float32: a pre-pass)
//   dP = dO . V^T
//   dY = P * (dP - D),  dX = dY * (1 - tanh^2) under softcap, else dY
//   dq = scale * dX . K,  dk = scale * dX^T . Q,  dv = P^T . dO
//
// A row with no allowed key has the forward's sentinel lse = 1e30, so its
// P, and with it every gradient it sends, is 0.
//
// Design (simple and deterministic, no atomics; speed is later work):
// - pre-pass: one warp per row computes D in float32;
// - dK / dV: one CTA per (key tile, kv head, batch).  It walks the q tiles
//   for which the forward walks this key tile (the forward's walk, with
//   tile rows BT for both, transposed: `tile_live` below, mirrored by
//   `bwd_q_tiles` in kernels/flash_attention/kernel.py), for each of the
//   `rep` q heads of its group, and sums their contributions in registers,
//   so GQA / MQA needs no atomics;
// - dQ: one CTA per (q tile, q head, batch) over its live key tiles, the
//   forward's walk.
// Both keep all four operand tiles of a step in shared memory as float32
// (rows padded to W + 1 floats: conflict-free column and row reads) and run
// the five products on the CUDA cores in float32, 256 threads as a 16 x 16
// grid, each thread a strided (BT / 16) x (BT / 16) block of a score tile
// and (BT / 16) x (W / 16) of an output tile.  Scores are masked element by
// element only on tiles the forward masks (`tile_needs_mask`); padded q rows
// carry the sentinel lse and zero dO.
//
// What bounds it on the H100: operations, 5 products of S x Sk x hd per
// head (2.5x the forward's 2), halved under causal; on the CUDA cores
// (67 TFLOP/s float32) rather than the tensor cores, a known cost of this
// first version (ROADMAP Queue 2: wgmma / TMA and a fused pre-pass).
//
// Host side: one C entry point launches the three kernels on PyTorch's
// current stream, never synchronises, allocates nothing (the wrapper passes
// D's scratch), and returns the first cudaGetLastError() that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // a 16 x 16 grid
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void *q, *k, *v, *o, *dO;
  void *dq, *dk, *dv;
  const float* lse;   // (B, H, S)
  float* delta;       // (B, H, S)
  // (batch, head, seq) element strides of q, k, v, o, dO, dq, dk, dv
  int64_t st[8][3];
  int S, Sk, hd, H, rep, n_qtiles, n_ktiles;
  float scale, softcap, inv_softcap;
  int causal, window, prefix_len;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

template <typename T, int W, int BT>
struct Shape {
  static constexpr int kLd = W + 1;        // floats per operand row
  static constexpr int kLdP = BT + 1;      // floats per P / dS row
  static constexpr int kTile = BT * kLd;   // floats of one operand tile
  static constexpr int kPTile = BT * kLdP;
  static constexpr int kRA = BT / 16;      // rows per thread
  static constexpr int kNC = W / 16;       // output columns per thread
  static constexpr int kSmem = (4 * kTile + 2 * kPTile + 2 * BT) * 4;
  static_assert(W % 16 == 0 && BT % 16 == 0, "tiles are whole 16-blocks");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The forward's tanh for the softcap, so that P here is the forward's P.
template <typename T>
__device__ __forceinline__ float softcap_tanh(float y) {
  if constexpr (sizeof(T) == 2) {
    return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * y) + 1.f);
  } else {
    return tanhf(y);
  }
}

// The forward's walk (flash_attention.cu, `live_tiles` in kernel.py): is key
// tile kt live for the q tile qt, at BT rows for both?
template <int BT>
__device__ __forceinline__ bool tile_live(const Params& p, int qt, int kt) {
  const int q0 = qt * BT, q_last = min(q0 + BT - 1, p.S - 1);
  int hi = p.n_ktiles;
  if (p.causal) hi = min(hi, max(q_last, p.prefix_len - 1) / BT + 1);
  const int lo = p.window > 0 ? max(q0 - p.window + 1, 0) / BT : 0;
  return lo <= kt && kt < hi;
}

// The forward's test (`tile_needs_mask`): must scores of the key tile at k0
// be masked element by element for the q tile of rows q0 .. q_last?
template <int BT>
__device__ __forceinline__ bool needs_mask(const Params& p, int k0, int q0, int q_last) {
  return (k0 + BT > p.Sk) || (p.causal && k0 + BT - 1 > max(q0, p.prefix_len - 1)) ||
         (p.window > 0 && q_last - k0 >= p.window);
}

__device__ __forceinline__ bool allowed(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= max(qpos, p.prefix_len - 1);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// rows row0 .. row0 + BT - 1 of one (batch, head) slice into a float tile,
// zero past `rows` and past hd
template <typename T, int W, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t ss, int row0,
                                          int rows, int hd) {
  for (int idx = threadIdx.x; idx < BT * W; idx += kThreads) {
    const int r = idx / W, d = idx % W;
    float x = 0.f;
    if (row0 + r < rows && d < hd) x = to_f(src[(int64_t)(row0 + r) * ss + d]);
    dst[r * (W + 1) + d] = x;
  }
}

// acc[a][c] = sum_{d < hd} A[ty + 16a][d] * B[tx + 16c][d]
template <int RA, int LD>
__device__ __forceinline__ void nt_product(float (&acc)[RA][RA], const float* A,
                                           const float* B, int hd, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float av[RA], bv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int c = 0; c < RA; ++c) bv[c] = B[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_{j < BT} P[ty + 16a][j] * X[j][tx + 16c], for the column
// blocks c < nc (those that hold a column < hd)
template <int RA, int NC, int BT, int LDP, int LD>
__device__ __forceinline__ void nn_product(float (&acc)[RA][NC], const float* P,
                                           const float* X, int nc, int ty, int tx) {
#pragma unroll 2
  for (int j = 0; j < BT; ++j) {
    float pv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) pv[a] = P[(ty + 16 * a) * LDP + j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        const float x = X[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(pv[a], x, acc[a][c]);
      }
    }
  }
}

// ------------------------------------------------------------- pre-pass: D

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.S) return;
  const T* o = static_cast<const T*>(p.o) + b * p.st[kO][0] + h * p.st[kO][1] +
               row * p.st[kO][2];
  const T* g = static_cast<const T*>(p.dO) + b * p.st[kDO][0] + h * p.st[kDO][1] +
               row * p.st[kDO][2];
  float s = 0.f;
  for (int d = lane; d < p.hd; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) p.delta[((int64_t)b * p.H + h) * p.S + row] = s;
}

// The scaled, soft-capped score x of one entry; `th` keeps the tanh.
template <typename T>
__device__ __forceinline__ float score(const Params& p, float dot, float& th) {
  float x = dot * p.scale;
  th = 0.f;
  if (p.softcap > 0.f) {
    th = softcap_tanh<T>(x * p.inv_softcap);
    x = p.softcap * th;
  }
  return x;
}

// ------------------------------------------------------------ dK and dV

template <typename T, int W, int BT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_bwd_dkv(const Params p) {
  using L = Shape<T, W, BT>;
  constexpr int RA = L::kRA, NC = L::kNC;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + L::kTile;
  float* qs = vs + L::kTile;
  float* gs = qs + L::kTile;        // dO
  float* ps = gs + L::kTile;        // P^T  [key][q]
  float* dss = ps + L::kPTile;      // dX^T [key][q]
  float* lse_s = dss + L::kPTile;
  float* del_s = lse_s + BT;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = (p.hd + 15) / 16;

  load_tile<T, W, BT>(ks, static_cast<const T*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1],
                      p.st[kK][2], k0, p.Sk, p.hd);
  load_tile<T, W, BT>(vs, static_cast<const T*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1],
                      p.st[kV][2], k0, p.Sk, p.hd);

  float dk[RA][NC], dv[RA][NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int r = 0; r < p.rep; ++r) {
    const int h = kvh * p.rep + r;
    for (int qt = 0; qt < p.n_qtiles; ++qt) {
      if (!tile_live<BT>(p, qt, kt)) continue;
      const int q0 = qt * BT, q_last = min(q0 + BT - 1, p.S - 1);
      __syncthreads();  // the last step's reads of Q, dO, P and dX are done
      load_tile<T, W, BT>(qs, static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1],
                          p.st[kQ][2], q0, p.S, p.hd);
      load_tile<T, W, BT>(gs,
                          static_cast<const T*>(p.dO) + b * p.st[kDO][0] + h * p.st[kDO][1],
                          p.st[kDO][2], q0, p.S, p.hd);
      if (threadIdx.x < BT) {
        const int qpos = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * p.H + h) * p.S + qpos;
        // a padded row: the empty-row sentinel, so its P is 0
        lse_s[threadIdx.x] = qpos < p.S ? p.lse[at] : 1e30f;
        del_s[threadIdx.x] = qpos < p.S ? p.delta[at] : 0.f;
      }
      __syncthreads();

      // S^T[j][i] = K_j . Q_i and dP^T[j][i] = V_j . dO_i (j key, i query)
      float s[RA][RA], dp[RA][RA];
      nt_product<RA, L::kLd>(s, ks, qs, p.hd, ty, tx);
      nt_product<RA, L::kLd>(dp, vs, gs, p.hd, ty, tx);
      const bool mask = needs_mask<BT>(p, k0, q0, q_last);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int c = 0; c < RA; ++c) {
          const int j = ty + 16 * a, i = tx + 16 * c;
          float th;
          const float x = score<T>(p, s[a][c], th);
          float pr = exp2f((x - lse_s[i]) * kLog2e);
          if (mask && !allowed(p, q0 + i, k0 + j)) pr = 0.f;
          float ds = pr * (dp[a][c] - del_s[i]);
          if (p.softcap > 0.f) ds *= 1.f - th * th;
          ps[j * L::kLdP + i] = pr;
          dss[j * L::kLdP + i] = ds;
        }
      }
      __syncthreads();
      nn_product<RA, NC, BT, L::kLdP, L::kLd>(dv, ps, gs, nc, ty, tx);
      nn_product<RA, NC, BT, L::kLdP, L::kLd>(dk, dss, qs, nc, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  T* dvp = static_cast<T*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int kpos = k0 + ty + 16 * a;
    if (kpos >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) {
        put(dkp + kpos * p.st[kDK][2] + d, dk[a][c] * p.scale);
        put(dvp + kpos * p.st[kDV][2] + d, dv[a][c]);
      }
    }
  }
}

// ------------------------------------------------------------------- dQ

template <typename T, int W, int BT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_bwd_dq(const Params p) {
  using L = Shape<T, W, BT>;
  constexpr int RA = L::kRA, NC = L::kNC;
  extern __shared__ float sm[];
  float* qs = sm;
  float* gs = qs + L::kTile;        // dO
  float* ks = gs + L::kTile;
  float* vs = ks + L::kTile;
  float* dss = vs + L::kTile;       // dX [q][key]
  float* lse_s = dss + 2 * L::kPTile;
  float* del_s = lse_s + BT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = p.n_qtiles - 1 - (int)blockIdx.x;  // longest causal tiles first
  const int q0 = qt * BT, q_last = min(q0 + BT - 1, p.S - 1);
  const int kvh = h / p.rep;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = (p.hd + 15) / 16;

  load_tile<T, W, BT>(qs, static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1],
                      p.st[kQ][2], q0, p.S, p.hd);
  load_tile<T, W, BT>(gs, static_cast<const T*>(p.dO) + b * p.st[kDO][0] + h * p.st[kDO][1],
                      p.st[kDO][2], q0, p.S, p.hd);
  if (threadIdx.x < BT) {
    const int qpos = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * p.H + h) * p.S + qpos;
    lse_s[threadIdx.x] = qpos < p.S ? p.lse[at] : 1e30f;
    del_s[threadIdx.x] = qpos < p.S ? p.delta[at] : 0.f;
  }

  // the forward's walk for this q tile
  int kt_hi = p.n_ktiles;
  if (p.causal) kt_hi = min(kt_hi, max(q_last, p.prefix_len - 1) / BT + 1);
  const int kt_lo = p.window > 0 ? max(q0 - p.window + 1, 0) / BT : 0;

  float dq[RA][NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[a][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the last step's reads of K and dX are done
    load_tile<T, W, BT>(ks, static_cast<const T*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1],
                        p.st[kK][2], k0, p.Sk, p.hd);
    load_tile<T, W, BT>(vs, static_cast<const T*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1],
                        p.st[kV][2], k0, p.Sk, p.hd);
    __syncthreads();

    // S[i][j] = Q_i . K_j and dP[i][j] = dO_i . V_j
    float s[RA][RA], dp[RA][RA];
    nt_product<RA, L::kLd>(s, qs, ks, p.hd, ty, tx);
    nt_product<RA, L::kLd>(dp, gs, vs, p.hd, ty, tx);
    const bool mask = needs_mask<BT>(p, k0, q0, q_last);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        float th;
        const float x = score<T>(p, s[a][c], th);
        float pr = exp2f((x - lse_s[i]) * kLog2e);
        if (mask && !allowed(p, q0 + i, k0 + j)) pr = 0.f;
        float ds = pr * (dp[a][c] - del_s[i]);
        if (p.softcap > 0.f) ds *= 1.f - th * th;
        dss[i * L::kLdP + j] = ds;
      }
    }
    __syncthreads();
    nn_product<RA, NC, BT, L::kLdP, L::kLd>(dq, dss, ks, nc, ty, tx);
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qpos = q0 + ty + 16 * a;
    if (qpos >= p.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) put(dqp + qpos * p.st[kDQ][2] + d, dq[a][c] * p.scale);
    }
  }
}

// ------------------------------------------------------------------- host

constexpr int kErrPlan = 10003;  // plan differs from every instantiation

template <typename T, int W, int BT, int MINB>
int launch(const Params& p, int B, int KVH, int smem, cudaStream_t stream) {
  using L = Shape<T, W, BT>;
  if (smem != L::kSmem) return kErrPlan;
  auto dkv = flash_bwd_dkv<T, W, BT, MINB>;
  auto dq = flash_bwd_dq<T, W, BT, MINB>;
  // the shared-memory opt-in of this instantiation's two kernels, once per
  // device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  int rc;
  flash_bwd_delta<T><<<dim3((p.S + 7) / 8, p.H, B), kThreads, 0, stream>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dkv<<<dim3(p.n_ktiles, KVH, B), kThreads, L::kSmem, stream>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dq<<<dim3(p.n_qtiles, p.H, B), kThreads, L::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 24 element strides, (batch,
// head, seq) for q, k, v, o, dO, dq, dk, dv in that order; every head dim
// has stride 1.  lse: the forward's (B, H, S) float32; delta: (B, H, S)
// float32 scratch.  width / tile / smem: the wrapper's launch plan.
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dO, void* dq, void* dk, void* dv,
                        const float* lse, float* delta, int B, int H, int KVH, int S,
                        int Sk, int hd, const int64_t* strides, float scale, int causal,
                        int window, int prefix_len, float softcap, int width, int tile,
                        int smem, void* stream) {
  if (B == 0 || S == 0 || Sk == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > width || tile <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dO = dO;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  p.S = S;
  p.Sk = Sk;
  p.hd = hd;
  p.H = H;
  p.rep = H / KVH;
  p.n_qtiles = (S + tile - 1) / tile;
  p.n_ktiles = (Sk + tile - 1) / tile;
  p.scale = scale;
  p.softcap = softcap;
  p.inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.causal = causal;
  p.window = window;
  p.prefix_len = prefix_len;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (width == 64 && tile == 64) return launch<__nv_bfloat16, 64, 64, 2>(p, B, KVH, smem, s);
    if (width == 128 && tile == 64) return launch<__nv_bfloat16, 128, 64, 1>(p, B, KVH, smem, s);
    if (width == 256 && tile == 32) return launch<__nv_bfloat16, 256, 32, 1>(p, B, KVH, smem, s);
  } else if (dtype == 0) {
    if (width == 32 && tile == 64) return launch<float, 32, 64, 2>(p, B, KVH, smem, s);
    if (width == 64 && tile == 64) return launch<float, 64, 64, 2>(p, B, KVH, smem, s);
    if (width == 128 && tile == 64) return launch<float, 128, 64, 1>(p, B, KVH, smem, s);
    if (width == 256 && tile == 32) return launch<float, 256, 32, 1>(p, B, KVH, smem, s);
  }
  return kErrPlan;
}

}  // extern "C"
