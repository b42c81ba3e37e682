// Snapshot patch-apply (base ⊕ diff) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `patch_apply` in
// src/repro/kernels/snapshot_patch/kernel.py (_kernel_replace, _kernel_add).
//
//   replace: out[i] = sel[i] >= 0 ? diff[sel[i]] : base[i]        (rows)
//   add:     out[i] = base[i] + scale * [sel[i] >= 0] * diff[max(sel[i], 0)]
//
// What bounds it on the H100: device memory.  Every output row is read once
// (from the base or from its diff row) and written once, about
// 2 * n * row_bytes bytes at 3.35 TB/s, with no arithmetic worth counting.
// The design spends nothing but that traffic: the grid runs over (output
// row, column block); each block reads its row's selector once (what the
// TPU kernel's scalar prefetch did) and picks one source pointer, so the
// data path has no per-element branch.  Threads move 16 bytes per load and
// store, neighbouring threads on neighbouring addresses, whenever the row
// width and the pointers allow it; otherwise the same kernel falls back to a
// byte loop for the tail.  Replace moves raw bytes and is bit-exact for
// every dtype; add is templated for float and bfloat16 and computes in float
// with explicitly rounded operations (no fused multiply-add), so it matches
// the plain PyTorch version bit for bit.
//
// Launchers take PyTorch's current stream, never synchronise, allocate
// nothing, and return cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlockBytes = 16 * 1024;  // bytes of one row per block

__global__ void __launch_bounds__(kThreads)
patch_replace_kernel(const uint8_t* __restrict__ base,
                     const uint8_t* __restrict__ diff,
                     const int32_t* __restrict__ sel,
                     uint8_t* __restrict__ out, int64_t row_bytes, int vec) {
  const int64_t row = blockIdx.x;
  const int32_t s = sel[row];
  const uint8_t* src = s >= 0 ? diff + (int64_t)s * row_bytes
                              : base + row * row_bytes;
  uint8_t* dst = out + row * row_bytes;
  const int64_t lo = (int64_t)blockIdx.y * kBlockBytes;
  const int64_t hi = min(lo + kBlockBytes, row_bytes);
  int64_t tail = lo;
  if (vec) {
    const int64_t n16 = (hi - lo) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + lo);
    uint4* d4 = reinterpret_cast<uint4*>(dst + lo);
    for (int64_t i = threadIdx.x; i < n16; i += kThreads) d4[i] = s4[i];
    tail = lo + n16 * 16;
  }
  for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads) dst[i] = src[i];
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_add_kernel(const T* __restrict__ base, const T* __restrict__ diff,
                 const int32_t* __restrict__ sel, T* __restrict__ out,
                 int64_t cols, float scale) {
  const int64_t row = blockIdx.x;
  const int32_t s = sel[row];
  // the TPU kernel reads diff row max(sel, 0) and multiplies it by 0 when
  // sel < 0; doing the same keeps signed zeros identical
  const float su = __fmul_rn(scale, s >= 0 ? 1.0f : 0.0f);
  const T* d = diff + (int64_t)(s >= 0 ? s : 0) * cols;
  const T* b = base + row * cols;
  T* o = out + row * cols;
  const int64_t per = kBlockBytes / (int64_t)sizeof(T);
  const int64_t lo = (int64_t)blockIdx.y * per;
  const int64_t hi = min(lo + per, cols);
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    o[i] = from_float<T>(
        __fadd_rn(to_float(b[i]), __fmul_rn(su, to_float(d[i]))));
  }
}

dim3 grid_for(int64_t n, int64_t row_bytes) {
  return dim3((unsigned)n, (unsigned)((row_bytes + kBlockBytes - 1) / kBlockBytes));
}

}  // namespace

extern "C" {

// base (n, row_bytes) bytes, diff (k, row_bytes) bytes, sel (n,) int32.
int snapshot_patch_replace(const void* base, const void* diff, const void* sel,
                           void* out, int64_t n, int64_t row_bytes,
                           void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  const int vec = (row_bytes % 16 == 0) &&
                  (((uintptr_t)base | (uintptr_t)diff | (uintptr_t)out) % 16 == 0);
  patch_replace_kernel<<<grid_for(n, row_bytes), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)base, (const uint8_t*)diff, (const int32_t*)sel,
      (uint8_t*)out, row_bytes, vec);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  base (n, cols), diff (k >= 1, cols).
int snapshot_patch_add(int dtype, const void* base, const void* diff,
                       const void* sel, void* out, int64_t n, int64_t cols,
                       float scale, void* stream) {
  if (n == 0 || cols == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    patch_add_kernel<float><<<grid_for(n, cols * 4), kThreads, 0, st>>>(
        (const float*)base, (const float*)diff, (const int32_t*)sel,
        (float*)out, cols, scale);
  } else if (dtype == 1) {
    patch_add_kernel<__nv_bfloat16><<<grid_for(n, cols * 2), kThreads, 0, st>>>(
        (const __nv_bfloat16*)base, (const __nv_bfloat16*)diff,
        (const int32_t*)sel, (__nv_bfloat16*)out, cols, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
