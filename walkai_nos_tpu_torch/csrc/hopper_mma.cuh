// Building blocks shared by the attention kernels' bf16 arms on Hopper
// (flash_attention.cu: K3, K4; flash_attention_bwd.cu: K5, K6): the
// swizzled bf16 tiles in shared memory, their cp.async loads and 16-byte
// stores, and warpgroup MMA (wgmma.m64n64k16, bf16 in, f32 accumulate)
// over them. Also the (batch, head, row) view and shape arguments every
// attention kernel takes, and the launch-side helpers.
//
// Layouts (see the backward's header for how they were found):
// - a tile is kBlock rows of DMAX bf16 columns, stored as DMAX / 64
//   panels of [kBlock, 64], each with 128-byte rows whose 16-byte chunks
//   are XOR-swizzled by row & 7: the hardware's 128-byte swizzle when a
//   panel starts on a 1024-byte boundary, so one tile is read by wgmma
//   K-major (contraction along the row) or MN-major (down the rows) with
//   no copy;
// - the m64n64 accumulator of one warp (16 of the 64 rows) is float
//   [8][4]: fragment n, element i is row g + 8 * (i >> 1), column
//   8n + 2t + (i & 1), for lane = 4g + t; a register A operand has the
//   layout of an m16n8k16 A fragment, so an accumulator goes to the next
//   product as packed bf16 pairs (to_a_frags) with no shuffle.
//
// Included by one translation unit per shared library; everything here
// has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;      // rows per tile, every attention kernel
constexpr int kThreads = 256;   // the f32 arms' CUDA-core kernels
constexpr int kMmaWarps = 4;    // bf16 arms: one warpgroup, 16 rows a warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of one [batch, head, row, column] view (column stride 1).
struct Layout {
  long long sb, sh, ss;
};

struct Shape {
  int heads, sq, sk, d, kv_len, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk c of row r in a swizzled [kBlock, DMAX]
// bf16 tile: DMAX / 64 panels of [kBlock, 64], one after the other, each
// with 128-byte rows whose chunks are XOR-swizzled by r & 7 (at a
// 1024-byte aligned panel, the hardware's 128-byte swizzle).
template <int DMAX>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (kBlock * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Rows row0 .. row0 + kBlock - 1 of a [rows, d] view (row stride ss) into a
// swizzled tile; rows past `rows` and columns past d are zero. kAsync:
// 16-byte cp.async copies (the view's rows 16-byte aligned, d % 8 == 0;
// the ragged tail zero-filled through src-size), else element by element.
// The CTA's kN threads share the work.
template <int DMAX, bool kAsync, int kN = kMmaThreads>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long ss, int row0,
                                               int rows, int d) {
  constexpr int kChunks = DMAX / 8;
  if constexpr (kAsync) {
    for (int i = threadIdx.x; i < kBlock * kChunks; i += kN) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int row = row0 + r;
      const bool ok = row < rows && c * 8 < d;
      const bf16* p = ok ? src + row * ss + c * 8 : src;
      cp_async16(smem_addr(dst + swz<DMAX>(r, c)), p, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * DMAX; i += kN) {
      const int r = i / DMAX;
      const int e = i % DMAX;
      const int row = row0 + r;
      bf16 x = __float2bfloat16(0.f);
      if (row < rows && e < d) x = src[row * ss + e];
      dst[swz<DMAX>(r, e >> 3) + (e & 7)] = x;
    }
  }
}

// The warp's 16 rows of C fragments (acc[n]: columns 8n + 2t, 8n + 2t + 1
// of rows g and g + 8), times mul, into a swizzled tile as bf16.
template <int DMAX>
__device__ __forceinline__ void frags_to_tile(bf16* tile, int row0,
                                              const float (&acc)[DMAX / 8][4],
                                              float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + swz<DMAX>(row, n) + 2 * (lane & 3)) =
          pack_bf16(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
}

// Rows row0 .. of a swizzled tile into a [rows, d] view (row stride ss):
// rows past `rows` and columns past d are not written; 16-byte stores where
// the view allows them. The CTA's kN threads share the work.
template <int DMAX, int kN = kMmaThreads>
__device__ __forceinline__ void store_tile_bf16(bf16* dst, long long ss,
                                                const bf16* tile, int row0,
                                                int rows, int d) {
  constexpr int kChunks = DMAX / 8;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
                   ss % 8 == 0 && d % 8 == 0;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kN) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    if (row >= rows || c * 8 >= d) continue;
    const bf16* src = tile + swz<DMAX>(r, c);
    bf16* out = dst + row * ss + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < d; ++e) out[e] = src[e];
    }
  }
}

// Descriptor of a swizzled [rows, 64] bf16 tile in shared memory: 128-byte
// rows whose 16-byte chunks are XOR-swizzled by row & 7, which is the
// hardware's 128-byte swizzle when the tile starts on a 1024-byte boundary;
// 8-row groups 1024 bytes apart. Read K-major (contraction along the row),
// a 16-wide step adds 32 bytes (2 in the address field); read MN-major
// (contraction down the rows), a 16-row step adds 2048 bytes (128).
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile) {
  const uint32_t addr = smem_addr(tile);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Descriptor steps: a 64-column panel of a tile is 8 KB further on.
constexpr int kPanelStep = kBlock * 64 * 2 >> 4;

// The 32 f32 accumulator operands of an m64n64 wgmma, %0 .. %31.
#define WG_D                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define WG_ACC4(d, n) \
  "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define WG_ACC(d)                                                   \
  WG_ACC4(d, 0), WG_ACC4(d, 1), WG_ACC4(d, 2), WG_ACC4(d, 3),       \
      WG_ACC4(d, 4), WG_ACC4(d, 5), WG_ACC4(d, 6), WG_ACC4(d, 7)

// d (64 x 64, f32, C-fragment layout per warp) = A B (+ d when accumulate),
// A and B K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      WG_D ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A from registers (16 rows per warp, in the layout of an
// m16n8k16 A fragment), B an MN-major tile in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      WG_D ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Commits the issued wgmma and waits for all of them.
__device__ __forceinline__ void wgmma_finish() {
  wgmma_commit();
  wgmma_wait<0>();
}

// Ties an accumulator to this point, so no read of it moves above the
// wait before it.
__device__ __forceinline__ void fence_acc(float (&a)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(a[n][i])::"memory");
}

// The same for register A operands: they stay untouched until the wait
// for the product that reads them.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// cp.async wrote the tiles through the generic proxy; wgmma reads them
// through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A fragments of the 16-wide steps j of a [16 rows per warp, 64] C-fragment
// array, rounded to bf16 (step j is n-tiles 2j and 2j + 1).
__device__ __forceinline__ void to_a_frags(const float (&x)[8][4],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    a[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    a[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
}

// The 64-column panel p of an accumulator over DMAX columns.
template <int DMAX>
__device__ __forceinline__ float (&panel(float (&acc)[DMAX / 8][4], int p))[8][4] {
  return *reinterpret_cast<float(*)[8][4]>(&acc[8 * p]);
}

// ---------------------------------------------------------------------------
// Launch side.

// Raises a kernel's dynamic shared-memory cap once, before its first
// launch (never during CUDA graph capture). One device per process.
template <typename K>
int allow_smem(K kernel, size_t bytes, bool* ready) {
  if (*ready) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *ready = true;
  return 0;
}

Layout layout(const long long* s, int i) {
  return Layout{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

bool bad_shape(int d, int sq, int sk, int kv_len) {
  return d < 1 || d > 128 || sq < 1 || sk < 1 || kv_len < 1 || kv_len > sk;
}

// Whether a bf16 view can be loaded in 16-byte copies: its base and every
// row start 16-byte aligned.
bool aligned16(const void* p, const Layout& L) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && L.sb % 8 == 0 &&
         L.sh % 8 == 0 && L.ss % 8 == 0;
}

// The bf16 arms take 16-byte copies when every tile they load allows them
// (ptrs[i] has the strides st[3i .. 3i + 2]).
bool async_ok(const void* const* ptrs, int n, const long long* st, int d) {
  if (d % 8) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i], layout(st, i))) return false;
  return true;
}

}  // namespace
