// Decode attention over an int8 KV cache for NVIDIA Hopper, sm_90a: one
// launch a call, the splits of the cache combined inside it.
//
// Replaces the Pallas TPU kernel `decode_attention_int8` in
// src/repro/kernels/decode_attention/kernel.py (_kernel, launched at :77).
// It computes what that kernel computes: one query token per (batch, head)
// with kv head = head / rep (GQA, MQA), keys and values int8 (b, S, nkv, hd)
// with float32 per-(position, kv head) scales (b, S, nkv), scores
// (q . k) k_scale scale over the keys k_pos <= pos only, a float32 softmax,
// and out = softmax . (v v_scale) written in q's dtype.  Keys past pos are
// never read.  Like the TPU kernel it has no window and no softcap; unlike
// it it takes any S (a ragged last slice is zero-filled and masked), and
// pos < 0 gives zeros, as the TPU kernel's empty sums do.
//
// What bounds it on the H100: bytes.  It reads the int8 K and V rows up to
// pos and their scales once (2 b nkv (pos + 1) (hd + 4) bytes) and writes
// the output; its 4 b nh (pos + 1) hd operations run on the CUDA cores.
// At stablelm-3b's decode step (b 1, 32 kv heads, hd 80, pos 1039) that is
// 5.6 MB, 1.7 us at 3.35 TB/s: there the floor is one launch and one trip
// to HBM, not the bytes.
//
// Design.
//
// * Work.  A CTA takes H adjacent kv heads (H = 1, 2 or 4) and R query
//   rows of each head's GQA group (R = 1, 2, 4, 8; rep above 8 takes
//   several row blocks), over a range of the live keys [0, min(pos + 1,
//   S)).  The live keys are cut into stages of 128 / H keys, and the
//   stages of one (batch, head group, row block) into `nsplit` contiguous
//   ranges, balanced to a stage, one CTA each.  pos is read on the device
//   (a one-element int32, as the TPU's scalar prefetch; a decode loop needs
//   no host sync), so a CTA whose range lies past pos loads nothing.  A key
//   row of H heads is H hd contiguous bytes: where the cache is long
//   (bandwidth-bound) the plan takes H = 4, as single heads' rows of 80
//   bytes (stablelm-3b) at a stride of nkv hd bytes drew under half of the
//   HBM rate; where it is short it takes H = 1 and more splits.
// * One launch.  The CTAs of a range of splits form a thread-block cluster
//   (up to 8, launched with cudaLaunchKernelEx): each CTA merges its warps'
//   (m, l, acc) in shared memory, and after a cluster barrier each CTA
//   combines its share of the output elements from every CTA of the
//   cluster through distributed shared memory.  Where b nkv clusters cannot
//   cover the card (MQA at b 1: one kv head), `groups` clusters share a
//   (batch, head group): each CTA writes its share of its cluster's partial
//   (m, l, acc) to a scratch the wrapper caches, fences, and takes a ticket
//   from its rank's counter; the CTA that draws the last ticket combines
//   that share over the groups and resets the counter, so the next call,
//   or a replay of a CUDA graph, finds it at zero.
// * Bytes in flight.  Stages are filled by 16-byte cp.async (4-byte for the
//   scales; zero-filled past the live keys, so nothing waits forever) into
//   a ring of 3, all 128 threads issuing contiguous spans of the key rows.
//   At the path shape every stage of a CTA is in flight before it computes.
// * Each int8 value converted once.  Each warp takes 32 keys of one head in
//   a stage.  Lane = key for q . k: a lane converts its key's row 16 values
//   at a time and uses them for every row of the group; lane = (16-value
//   chunk, key group) for p . v, each V value converted by one lane.  The
//   conversion puts the byte, offset by 128, into the mantissa of 2^23
//   (`__byte_perm` with 0x4B000000) and subtracts 2^23 + 128: exact for all
//   256 values, without I2F.  The scales fold into the score (q . k) k_scale
//   scale and into p v_scale.
// * No idle warps.  Every warp runs its own online softmax: m kept uniform
//   over the warp, l per lane and acc per lane in registers, merged once
//   at the end (over lanes, warps, the cluster, then groups).  A stage's
//   key rows are padded to an odd number of 16-byte chunks, or XOR-swizzled
//   where they are a multiple of 8 chunks, so that a warp's row-per-lane
//   reads hit every bank once.
//
// The launcher takes PyTorch's current stream, never synchronises,
// allocates nothing, refuses a plan it was not compiled for, and returns
// cudaGetLastError() for the wrapper.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;          // keys of a warp's task: one per lane
constexpr int kStages = 3;         // ring of stages
constexpr int kMaxCluster = 8;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrPlan = 10003;    // the plan differs from the kernel's
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const int* pos_dev;  // null: take pos_host
  int pos_host;
  int S, nh, nkv, hd, rep, heads, row_blocks, nsplit, groups;
  float scale;
  float* part;         // groups > 1: (b, nkv / heads, row_blocks, groups, E + 2 H R)
  int* ticket;         // groups > 1: (b, nkv / heads, row_blocks, cluster)
  void* out;
};

// Shared-memory layout, also computed by the wrapper's launch plan.
struct Layout {
  int nc;         // 16-byte chunks of a head's row (hd / 16)
  int hnc;        // chunks of a key row of the CTA's heads (H nc)
  int keys;       // keys of a stage (32 x 4 warps / H)
  bool swz;       // XOR-swizzle the chunk index with row % 8 (hnc % 8 == 0)
  int pitch;      // bytes of a key row in a stage: hnc chunks, padded to odd
  int kg;         // key groups of the p . v lanes (32 / nc)
  int stage;      // bytes of a stage: K and V rows, then their scales
  int fixed;      // q, the warps' m, l and weight, the ticket
  int yoff;       // offset in `work` of the receive region, after the merges
  int work;       // the ring; after it, the merges and the receive region
  int smem;
};

__host__ __device__ inline Layout layout(int rows, int hd, int heads) {
  Layout L;
  L.nc = hd / 16;
  L.hnc = heads * L.nc;
  L.keys = kKeys * kWarps / heads;
  L.swz = L.hnc % 8 == 0;
  L.pitch = 16 * (L.swz ? L.hnc : (L.hnc | 1));
  L.kg = 32 / L.nc;
  const int hr = heads * rows;
  L.stage = 2 * L.keys * L.pitch + 2 * L.keys * heads * 4;
  L.fixed = (4 * (hr * hd + 3 * kWarps * rows + 4) + 127) / 128 * 128;
  const int ring = kStages * L.stage;
  const int merge = 4 * kWarps * L.kg * rows * hd;
  const int comb = 4 * (kMaxCluster + 2) * hr;
  // the receive region: the elements of this CTA's share from every rank
  // (at most hr hd + kMaxCluster), then every rank's m and l per row
  const int recv = 4 * (hr * hd + kMaxCluster + 2 * kMaxCluster * hr);
  L.yoff = merge > comb ? merge : comb;
  L.work = ring > L.yoff + recv ? ring : L.yoff + recv;
  L.smem = L.fixed + L.work;
  return L;
}

// byte offset of 16-byte chunk `col` of key row `row` in a stage
__device__ __forceinline__ int chunk_at(const Layout& L, int row, int col) {
  return row * L.pitch + 16 * (L.swz ? (col ^ (row & 7)) : col);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes where !ok (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 int8 values -> float: (x ^ 0x80) = x + 128 placed in the mantissa of
// 2^23, minus 2^23 + 128.  Exact for every int8.
__device__ __forceinline__ void int8x16_to_float(const int4 w, float* f) {
  const uint32_t u[4] = {(uint32_t)w.x ^ 0x80808080u, (uint32_t)w.y ^ 0x80808080u,
                         (uint32_t)w.z ^ 0x80808080u, (uint32_t)w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i + 0] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7650)) - 8388736.f;
    f[4 * i + 1] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7651)) - 8388736.f;
    f[4 * i + 2] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7652)) - 8388736.f;
    f[4 * i + 3] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7653)) - 8388736.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();

  const int hd = p.hd, H = p.heads;
  const Layout L = layout(R, hd, H);
  const int HR = H * R;                      // query rows of the CTA
  const int E = HR * hd;                     // output elements of the CTA
  float* sQ = reinterpret_cast<float*>(smem);  // HR x hd
  float* sMW = sQ + E;                       // per warp: m, then l, R each
  float* sLW = sMW + kWarps * R;
  int* sTicket = reinterpret_cast<int*>(sLW + 2 * kWarps * R);
  unsigned char* work = smem + L.fixed;      // the ring, then the merges

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int hg = blockIdx.y / p.row_blocks, rb = blockIdx.y - hg * p.row_blocks;
  const int b = blockIdx.z;
  const int g0 = hg * H;                     // first kv head of the CTA
  const int r0 = rb * R;
  const int nrows = min(R, p.rep - r0);

  // the live keys and this CTA's stages [st_lo, st_lo + nmine)
  const int pos = p.pos_dev ? *p.pos_dev : p.pos_host;
  const int live = pos < 0 ? 0 : (pos >= p.S ? p.S : pos + 1);
  const long long nst = (live + L.keys - 1) / L.keys;
  const int st_lo = (int)(split * nst / p.nsplit);
  const int nmine = (int)((split + 1) * nst / p.nsplit) - st_lo;

  const size_t kv_row = (size_t)p.nkv * hd;  // bytes between consecutive keys
  const size_t base = (size_t)b * p.S * p.nkv;
  const int8_t* kbase = p.k + (base + g0) * hd;
  const int8_t* vbase = p.v + (base + g0) * hd;
  const uint32_t ring = smem_u32(work);
  // idx / hnc for idx < 128 nc <= 2048 and hnc <= 64: (idx magic) >> 20
  const uint32_t magic = (1u << 20) / L.hnc + 1;
  // the scales: thread -> (key row, head) of the stage
  const int s_row = tid / H, s_h = tid - s_row * H;

  auto issue = [&](int t) {  // stage t of this CTA into slot t % kStages
    if (t < nmine) {
      const int key0 = (st_lo + t) * L.keys;
      const int valid = min(L.keys, live - key0);
      const uint32_t sk = ring + (t % kStages) * L.stage, sv = sk + L.keys * L.pitch;
      const int8_t* kp = kbase + (size_t)key0 * kv_row;
      const int8_t* vp = vbase + (size_t)key0 * kv_row;
      for (int idx = tid; idx < L.keys * L.hnc; idx += kThreads) {
        const int row = (int)(((uint32_t)idx * magic) >> 20), col = idx - row * L.hnc;
        const bool ok = row < valid;
        const size_t off = (size_t)(ok ? row : 0) * kv_row + 16 * col;
        const int dst = chunk_at(L, row, col);
        cp_async16(sk + dst, kp + off, ok);
        cp_async16(sv + dst, vp + off, ok);
      }
      const bool ok = s_row < valid;
      const size_t so = base + (size_t)(key0 + (ok ? s_row : 0)) * p.nkv + g0 + s_h;
      const uint32_t ss = sv + L.keys * L.pitch + 4 * tid;
      cp_async4(ss, p.ks + so, ok);
      cp_async4(ss + 4 * L.keys * H, p.vs + so, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) issue(t);

  // q of the CTA's heads and rows (row h R + r is head (g0 + h) rep + r0 +
  // r), loaded while the first stages are in flight
  const T* qb = static_cast<const T*>(p.q) + (size_t)b * p.nh * hd;
  for (int i = tid; i < E; i += kThreads) {
    const int hr = i / hd, h = hr / R, r = hr - h * R;
    sQ[i] = r < nrows ? load_f(qb + ((size_t)(g0 + h) * p.rep + r0 + r) * hd + i - hr * hd)
                      : 0.f;
  }

  // this warp's task in every stage: 32 keys of head h_w
  const int h_w = warp % H, sub = warp / H;
  float m[R], l[R], acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.f;
  }
  const int c_pv = lane % L.nc, kg = lane / L.nc;  // p . v: chunk, key group
  const bool pv_lane = kg < L.kg;
  const float* qw = sQ + h_w * R * hd;

  for (int t = 0; t < nmine; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage t (and, first, q) visible to every warp
    const unsigned char* sk = work + (t % kStages) * L.stage;
    const unsigned char* sv = sk + L.keys * L.pitch;
    const float* sks = reinterpret_cast<const float*>(sv + L.keys * L.pitch);
    const float* svs = sks + L.keys * H;
    const int row0 = sub * kKeys;  // the warp's first key row in the stage
    const int valid = min(kKeys, live - (st_lo + t) * L.keys - row0);
    if (valid > 0) {  // uniform over the warp
      const int row = row0 + lane;
      // q . k: lane = key
      float s[R], s1[R];  // two chains per row
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = s1[r] = 0.f;
#pragma unroll 2
      for (int c = 0; c < L.nc; ++c) {
        float kf[16];
        int8x16_to_float(
            *reinterpret_cast<const int4*>(sk + chunk_at(L, row, h_w * L.nc + c)), kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qr = reinterpret_cast<const float4*>(qw + r * hd + 16 * c);
#pragma unroll
          for (int e4 = 0; e4 < 4; e4 += 2) {
            const float4 qa = qr[e4], qb4 = qr[e4 + 1];
            s[r] = fmaf(qa.x, kf[4 * e4 + 0], s[r]);
            s1[r] = fmaf(qb4.x, kf[4 * e4 + 4], s1[r]);
            s[r] = fmaf(qa.y, kf[4 * e4 + 1], s[r]);
            s1[r] = fmaf(qb4.y, kf[4 * e4 + 5], s1[r]);
            s[r] = fmaf(qa.z, kf[4 * e4 + 2], s[r]);
            s1[r] = fmaf(qb4.z, kf[4 * e4 + 6], s1[r]);
            s[r] = fmaf(qa.w, kf[4 * e4 + 3], s[r]);
            s1[r] = fmaf(qb4.w, kf[4 * e4 + 7], s1[r]);
          }
        }
      }
      const bool ok = lane < valid;
      const float kscale = sks[row * H + h_w] * p.scale;
      const float vscale = svs[row * H + h_w];

      // online softmax: m uniform over the warp, l per lane
      float pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sr = ok ? (s[r] + s1[r]) * kscale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float alpha = expf(m[r] - m_new);
        const float pj = ok ? expf(sr - m_new) : 0.f;
        l[r] = l[r] * alpha + pj;
        pv[r] = pj * vscale;
        m[r] = m_new;
        if (alpha != 1.f) {  // uniform over the warp
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[r][e] *= alpha;
        }
      }

      // p . v: lane = (chunk c_pv, keys kg, kg + kg_n, ...)
#pragma unroll 2
      for (int t2 = 0; t2 * L.kg < valid; ++t2) {
        const int j = kg + t2 * L.kg;
        float pr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) pr[r] = __shfl_sync(kFull, pv[r], j & 31);
        if (pv_lane && j < valid) {
          float vf[16];
          int8x16_to_float(*reinterpret_cast<const int4*>(
                               sv + chunk_at(L, row0 + j, h_w * L.nc + c_pv)),
                           vf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
    issue(t + kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // q visible where no stage was waited on; the ring is free

  // the lanes' acc -> X[warp][key group][row][hd]; l over the lanes
  float* X = reinterpret_cast<float*>(work);
  if (pv_lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* xp = reinterpret_cast<float4*>(
          X + (((size_t)warp * L.kg + kg) * R + r) * hd + 16 * c_pv);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
        xp[e4] = make_float4(acc[r][4 * e4], acc[r][4 * e4 + 1], acc[r][4 * e4 + 2],
                             acc[r][4 * e4 + 3]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      sMW[warp * R + r] = m[r];
      sLW[warp * R + r] = lsum;
    }
  }
  __syncthreads();

  // every CTA of the cluster is past its ring: peers may now write into the
  // receive region, which overlays the ring
  cluster.sync();

  // the CTA's partial per head: its warps (w = h, h + H, ...) rescaled to
  // their common max (weights per warp and row first), each element pushed
  // into the receive region of the CTA that combines it (rank e / share),
  // the rows' m and l into every CTA's
  const int wph = kWarps / H;  // warps per head
  const int share = (E + C - 1) / C;
  float* rAcc = reinterpret_cast<float*>(work + L.yoff);  // [source rank][share]
  float* rM = rAcc + share * C;                           // [source rank][HR]
  float* rL = rM + kMaxCluster * HR;
  float* sWW = sLW + kWarps * R;  // per warp and row: its weight
  if (tid < kWarps * R) {
    const int w = tid / R, r = tid - w * R, h = w % H;
    float M = kNegInf;
    for (int j = 0; j < wph; ++j) M = fmaxf(M, sMW[(h + H * j) * R + r]);
    sWW[tid] = expf(sMW[tid] - M);
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int hr = e / hd, h = hr / R, r = hr - h * R, d = e - hr * hd;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < wph) {
        const int w = h + H * j;
        const float* xw = X + ((size_t)w * L.kg * R + r) * hd + d;
        float x0 = 0.f, x1 = 0.f;
        int q = 0;
        for (; q + 1 < L.kg; q += 2) {
          x0 += xw[(size_t)q * R * hd];
          x1 += xw[(size_t)(q + 1) * R * hd];
        }
        if (q < L.kg) x0 += xw[(size_t)q * R * hd];
        a = fmaf(sWW[w * R + r], x0 + x1, a);
      }
    }
    const int owner = e / share;
    cluster.map_shared_rank(rAcc, owner)[crank * share + e - owner * share] = a;
  }
  if (tid < HR) {
    const int h = tid / R, r = tid - h * R;
    float M = kNegInf, lsum = 0.f;
    for (int j = 0; j < wph; ++j) M = fmaxf(M, sMW[(h + H * j) * R + r]);
    for (int j = 0; j < wph; ++j)
      lsum = fmaf(sWW[(h + H * j) * R + r], sLW[(h + H * j) * R + r], lsum);
    for (int c = 0; c < C; ++c) {
      cluster.map_shared_rank(rM, c)[crank * HR + tid] = M;
      cluster.map_shared_rank(rL, c)[crank * HR + tid] = lsum;
    }
  }
  cluster.sync();  // every push has landed; no shared memory is read remotely after this

  // the cluster's partial for this CTA's share of the elements, from the
  // receive region: each source CTA's weight per row, then the elements
  float* W = X;                        // C x HR weights
  float* CM = W + kMaxCluster * HR;    // HR: the cluster's m and l
  float* CL = CM + HR;
  if (tid < HR) {
    float M = kNegInf;
    for (int c = 0; c < C; ++c) M = fmaxf(M, rM[c * HR + tid]);
    CM[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < C * HR; i += kThreads) W[i] = expf(rM[i] - CM[i % HR]);
  __syncthreads();
  if (tid < HR) {
    float lsum = 0.f;
    for (int c = 0; c < C; ++c) lsum = fmaf(W[c * HR + tid], rL[c * HR + tid], lsum);
    CL[tid] = lsum;
  }
  __syncthreads();
  const int e0 = crank * share, e1 = min(E, e0 + share);
  const size_t bgr = ((size_t)b * (p.nkv / H) + hg) * p.row_blocks + rb;
  const int pstride = E + 2 * HR;
  float* my_part = p.groups > 1 ? p.part + (bgr * p.groups + split / C) * pstride : nullptr;
  T* ob = static_cast<T*>(p.out) + (size_t)b * p.nh * hd;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int hr = e / hd;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a = fmaf(W[c * HR + hr], rAcc[c * share + e - e0], a);
    const int h = hr / R, r = hr - h * R;
    if (my_part)
      my_part[e] = a;
    else if (r < nrows)
      store_f(ob + ((size_t)(g0 + h) * p.rep + r0 + r) * hd + e - hr * hd,
              a / fmaxf(CL[hr], 1e-30f));
  }
  if (!my_part) return;

  // groups > 1: this CTA's share of its cluster's (m, l, acc) is in the
  // scratch; of the CTAs of one rank across the groups, the one that draws
  // the last ticket combines that share over the groups
  if (tid < HR) {  // every CTA of the cluster writes the same m and l
    my_part[E + tid] = CM[tid];
    my_part[E + HR + tid] = CL[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = p.ticket + bgr * C + crank;
    const int t = atomicAdd(ctr, 1);
    if (t == p.groups - 1) atomicExch(ctr, 0);  // for the next call
    *sTicket = t;
  }
  __syncthreads();
  if (*sTicket != p.groups - 1) return;
  __threadfence();
  const float* parts = p.part + bgr * p.groups * pstride;
  float* GW = X;  // groups x HR: m, then the weight (the plan bounds groups)
  float* GL = GW + p.groups * HR;
  for (int i = tid; i < p.groups * HR; i += kThreads) {
    const int q = i / HR, hr = i - q * HR;
    GW[i] = __ldcg(parts + (size_t)q * pstride + E + hr);
  }
  __syncthreads();
  if (tid < HR) {
    float M = kNegInf;
    for (int q = 0; q < p.groups; ++q) M = fmaxf(M, GW[q * HR + tid]);
    float lsum = 0.f;
    for (int q = 0; q < p.groups; ++q) {
      const float w = expf(GW[q * HR + tid] - M);
      GW[q * HR + tid] = w;
      lsum = fmaf(w, __ldcg(parts + (size_t)q * pstride + E + HR + tid), lsum);
    }
    GL[tid] = lsum;
  }
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int hr = e / hd, h = hr / R, r = hr - h * R;
    if (r >= nrows) continue;
    float a0 = 0.f, a1 = 0.f;
    int q = 0;
    for (; q + 1 < p.groups; q += 2) {
      a0 = fmaf(GW[q * HR + hr], __ldcg(parts + (size_t)q * pstride + e), a0);
      a1 = fmaf(GW[(q + 1) * HR + hr], __ldcg(parts + (size_t)(q + 1) * pstride + e), a1);
    }
    if (q < p.groups) a0 = fmaf(GW[q * HR + hr], __ldcg(parts + (size_t)q * pstride + e), a0);
    store_f(ob + ((size_t)(g0 + h) * p.rep + r0 + r) * hd + e - hr * hd,
            (a0 + a1) / fmaxf(GL[hr], 1e-30f));
  }
}

// Opts the instantiation in to `smem` bytes of dynamic shared memory on the
// current device.  The attribute only ever rises (to the largest smem asked
// for so far), so that no plan's launch finds it lowered by another plan's
// launch or occupancy query; the lock keeps two host threads from lowering it.
template <typename T, int R>
cudaError_t opt_in(int smem) {
  static std::mutex lock;
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (smem <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_int8_kernel<T, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) opted[dev] = smem;
  return e;
}

template <typename T, int R>
int launch(const Params& p, int batch, int cluster, int smem, cudaStream_t stream) {
  if (smem != layout(R, p.hd, p.heads).smem) return kErrPlan;
  auto kernel = decode_int8_kernel<T, R>;
  cudaError_t e = opt_in<T, R>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsplit, p.nkv / p.heads * p.row_blocks, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int R>
int max_clusters(int cluster, int smem) {
  auto kernel = decode_int8_kernel<T, R>;
  cudaError_t e = opt_in<T, R>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int max_clusters_of(int rows, int cluster, int smem) {
  switch (rows) {
    case 1: return max_clusters<T, 1>(cluster, smem);
    case 2: return max_clusters<T, 2>(cluster, smem);
    case 4: return max_clusters<T, 4>(cluster, smem);
    case 8: return max_clusters<T, 8>(cluster, smem);
    default: return -kErrPlan;
  }
}

template <typename T>
int dispatch(const Params& p, int rows, int batch, int cluster, int smem, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<T, 1>(p, batch, cluster, smem, s);
    case 2: return launch<T, 2>(p, batch, cluster, smem, s);
    case 4: return launch<T, 4>(p, batch, cluster, smem, s);
    case 8: return launch<T, 8>(p, batch, cluster, smem, s);
    default: return kErrPlan;
  }
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  q (B, nh, hd), k / v
// int8 (B, S, nkv, hd), ks / vs float32 (B, S, nkv), all contiguous, k and v
// 16-byte aligned.  pos_dev: a device int32 holding pos, or null to take
// pos_host.  The launch plan (the wrapper's launch_plan): kv heads a CTA
// (1, 2, 4, dividing nkv), query rows a CTA (1, 2, 4, 8) and row_blocks of
// the group, nsplit CTAs per (batch, head group, row block) in clusters of
// `cluster`, nsplit / cluster groups, and the dynamic shared memory.
// groups > 1: part float32 (B, nkv / heads, row_blocks, groups, heads rows
// (hd + 2)) and ticket int32 (B, nkv / heads, row_blocks, cluster), zero
// before the first call (each call leaves it at zero).  out (B, nh, hd) in
// q's dtype.
int decode_attention_int8_fwd(int dtype, const void* q, const void* k, const void* ks,
                              const void* v, const void* vs, const void* pos_dev,
                              int pos_host, int B, int S, int nh, int nkv, int hd,
                              int heads, int rows, int row_blocks, int nsplit,
                              int cluster, int smem, float scale, void* part,
                              void* ticket, void* out, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || hd < 16 || hd > 256 || hd % 16 != 0 ||
      B > 65535 || nsplit <= 0 || cluster <= 0 || rows <= 0 || row_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int rep = nh / nkv;
  const int groups = nsplit / cluster;
  if ((heads != 1 && heads != 2 && heads != 4) || nkv % heads != 0 ||
      (long long)(nkv / heads) * row_blocks > 65535 || cluster > kMaxCluster ||
      nsplit % cluster != 0 || rows * row_blocks < rep || rows * (row_blocks - 1) >= rep ||
      (groups > 1 && (!part || !ticket)) ||
      4 * (groups + 1) * heads * rows > layout(rows, hd, heads).yoff)
    return kErrPlan;
  Params p;
  p.q = q;
  p.k = (const int8_t*)k;
  p.ks = (const float*)ks;
  p.v = (const int8_t*)v;
  p.vs = (const float*)vs;
  p.pos_dev = (const int*)pos_dev;
  p.pos_host = pos_host;
  p.S = S;
  p.nh = nh;
  p.nkv = nkv;
  p.hd = hd;
  p.rep = rep;
  p.heads = heads;
  p.row_blocks = row_blocks;
  p.nsplit = nsplit;
  p.groups = groups;
  p.scale = scale;
  p.part = (float*)part;
  p.ticket = (int*)ticket;
  p.out = out;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, rows, B, cluster, smem, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, rows, B, cluster, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The clusters of this launch configuration that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus an error code.
int decode_attention_int8_max_clusters(int dtype, int rows, int hd, int heads, int cluster,
                                       int smem) {
  if (smem != layout(rows, hd, heads).smem || cluster <= 0 || cluster > kMaxCluster)
    return -kErrPlan;
  if (dtype == 0) return max_clusters_of<float>(rows, cluster, smem);
  if (dtype == 1) return max_clusters_of<__nv_bfloat16>(rows, cluster, smem);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
