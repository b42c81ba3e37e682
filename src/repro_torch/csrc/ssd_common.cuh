// Device helpers shared by the SSD scan kernels (ssd_scan.cu, ssd_scan_bwd.cu):
// cp.async copies into 64-row tiles in the 128-byte swizzle, wgmma on
// shared-memory descriptors or register fragments (bf16), 3xTF32 mma.sync
// (float32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;             // rows of a tile: chunk rows, or state rows (hd)
constexpr int kHdp = 64;           // head dim padded
constexpr int kThreads = 128;      // one warpgroup
constexpr int kSlab = kT * 128;    // bytes of one 128-byte-wide slab of a tile

// ------------------------------------------------------------ PTX helpers

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
// orders this thread's shared-memory writes before wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile (as in the
// flash kernel): start address, leading and stride byte offsets 1024 (the
// next 8-row group), layout B128.
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

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 inputs, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to the nearest tf32 (ties away from zero; low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + O(2^-24 x), hi and lo tf32 rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// c[4j..4j+3] += a . b_j in 3xTF32 for N column blocks j, the small cross
// terms first, each pass over all N blocks (no product waits on the one
// before it).  The tensor core adds into its accumulator rounding toward
// zero; carried over a whole K loop into sums of ~40 (C.B^T at ds 128)
// that bias alone misses 2e-5, so each 8-deep step starts from zero and is
// added to c in float32, rounded to nearest.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t (*bhi)[2],
                                           const uint32_t (*blo)[2]) {
  float d[4 * N];
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) d[i] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d + 4 * j, alo, bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d + 4 * j, ahi, blo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d + 4 * j, ahi, bhi[j]);
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) c[i] += d[i];
}

// (a, b) as bf16 pairs hi and lo with a = hi.x + lo.x + O(2^-17 a)
__device__ __forceinline__ void pack_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// byte offset of element (r, e) in a 64-row tile stored as 128-byte slabs
// across its width, each slab 128-byte-swizzled (TMA's SWIZZLE_128B layout)
template <typename T>
__device__ __forceinline__ uint32_t swz(int r, int e) {
  constexpr int W = 128 / (int)sizeof(T);
  const int b = (e % W) * (int)sizeof(T);
  return (uint32_t)((e / W) * kSlab + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15));
}

template <typename T>
__device__ __forceinline__ float ld_tile(const unsigned char* tile, int r, int e) {
  return to_f(*reinterpret_cast<const T*>(tile + swz<T>(r, e)));
}

// rows x cols of a row-major global matrix (row stride ld elements, unit
// column stride) into a 64-row swizzled tile WIDTH elements wide, by 16-byte
// cp.async; rows >= nrows and columns >= ncols are zero-filled.  A thread
// keeps one 16-byte column and steps down the rows.
template <typename T, int WIDTH>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* src, int64_t ld,
                                          int nrows, int ncols, int tid) {
  constexpr int kPer = 16 / (int)sizeof(T);   // elements per copy
  constexpr int kQ = WIDTH / kPer;             // copies per row
  constexpr int kStep = kThreads / kQ;         // rows per pass
  static_assert(kThreads % kQ == 0 && kT % kStep == 0, "tile shape");
  const int e = (tid % kQ) * kPer, r0 = tid / kQ;
  const bool col_ok = e < ncols;
  const T* sp = src + r0 * ld + e;
#pragma unroll
  for (int k = 0; k < kT / kStep; ++k) {
    const int r = r0 + k * kStep;
    const bool ok = col_ok && r < nrows;
    cp_async16(tile + swz<T>(r, e), ok ? sp : src, ok);
    sp += kStep * ld;
  }
}

// float32: acc[32] = A . B^T over the first kdim (<= DSP) columns, A rows
// r0, r0 + 8 of one 64-row tile, B rows 0..63 of another (8 column blocks),
// in 3xTF32.
template <int DSP>
__device__ __forceinline__ void mma_abt_f32(float* acc, const unsigned char* a,
                                            const unsigned char* b, int kdim, int r0,
                                            int g, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DSP / 8; ++kk) {
    if (8 * kk >= kdim) break;
    const int d = 8 * kk + t;
    uint32_t ahi[4], alo[4];
    split_tf32(ld_tile<float>(a, r0, d), ahi[0], alo[0]);
    split_tf32(ld_tile<float>(a, r0 + 8, d), ahi[1], alo[1]);
    split_tf32(ld_tile<float>(a, r0, d + 4), ahi[2], alo[2]);
    split_tf32(ld_tile<float>(a, r0 + 8, d + 4), ahi[3], alo[3]);
    uint32_t bhi[8][2], blo[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(ld_tile<float>(b, 8 * j + g, d), bhi[j][0], blo[j][0]);
      split_tf32(ld_tile<float>(b, 8 * j + g, d + 4), bhi[j][1], blo[j][1]);
    }
    mma_3xtf32<8>(acc, ahi, alo, bhi, blo);
  }
}

// bfloat16: acc[32] (+)= A . B^T over all DSP columns (zero past ds), both
// 64-row K-major swizzled tiles in shared memory.  No branch between the
// products: one would make the compiler wait for each before the next.
template <int DSP>
__device__ __forceinline__ void wgmma_abt(float* acc, uint32_t a, uint32_t b,
                                          bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < DSP / 16; ++kk) {  // the padding past kdim is zeros
    const uint32_t off = (kk >> 2) * kSlab + ((kk & 3) << 5);  // 16 bf16 = 32 bytes
    wgmma_ss(acc, smem_desc(a + off), smem_desc(b + off), accumulate || kk > 0);
  }
}

// Register layout of a 64 x 64 float32 result (the m16n8 accumulator, which
// is also wgmma's m64nN layout for warp w): thread (warp w, lane = 4 g + t)
// holds, for each 8-column block j, entries 4j + {0, 1} of row 16 w + g at
// columns 8j + 2t + {0, 1}, and entries 4j + {2, 3} of row 16 w + g + 8.

}  // namespace
