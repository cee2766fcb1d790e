// Hopper building blocks shared by the flash kernels that run on wgmma:
// B1's bf16 sweep (flash_sweep.cuh, which the forward kernel flash_fwd.cu
// and the fused ring's flash_ring.cu and flash_ring_remote.cu run) and the
// bf16 dk/dv (B2) and dq (B3) passes (flash_bwd.cu).  cp.async into
// 128-byte-swizzled tiles, the shared-memory matrix descriptor of such a
// tile, the warpgroup products (m64n64k16, bf16 in, f32 accumulate) with A
// from shared memory or from registers, and the KV-tile stage that the
// sweep and B3 stream through their cp.async rings.  Every function is
// __forceinline__; names stay clear of flash_tile.cuh's, which the sweep
// also includes.
//
// Tiles are 64 columns of bf16 (128 bytes a row); 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), so the tensor cores read them without bank
// conflicts.  A tile starts on a 1,024-byte boundary: the swizzle reads
// address bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Byte offset of 16-byte chunk `c` of row `r` in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, bool valid) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's landed cp.async writes before the tensor cores'
// (async proxy) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of a (n, 64) bf16 matrix into a swizzled tile at
// shared address `dst`, by kThreads threads of which this is number tid;
// rows past n are zero-filled.
template <int kThreads>
__device__ __forceinline__ void load_swizzled(uint32_t dst, const __nv_bfloat16* src, int row0,
                                              int rows, int n, int tid) {
  for (int i = tid; i < rows * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    const bool valid = row0 + r < n;
    cp_async(dst + swz(r, c), src + (valid ? (size_t)(row0 + r) * 64 + c * 8 : 0), 16, valid);
  }
}

// The descriptor of a 128-byte-swizzled tile at shared address `addr`:
// 1,024 bytes between groups of 8 rows (and between groups of 64 columns,
// which a 64-wide tile never crosses).  A k-step of 16 columns along a row
// (K-major) adds 32 bytes to `addr`; one of 16 rows down the tile (MN-major)
// adds 2,048.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed product groups run on.
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an asynchronous product reads or writes until here.
__device__ __forceinline__ void reg_fence(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {  // A fragments
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// The 64 x 64 f32 products of a warpgroup, d a warp's 16 rows in mma
// fragment layout (d[j][e]: row g + 8 (e / 2), column 8 j + 2 t + e % 2, g =
// lane / 4, t = lane % 4).  d = or += A . B^T, A and B 64 x 16 blocks of
// tiles (their rows, K-major) at desc_a and desc_b.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d = or += a . B, a the warp's 16 x 16 A fragment (registers), B the 16 x
// 64 block of a tile at desc: 16 of its rows, read down their columns
// (MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Two floats as bf16x2; the first lands in the low half (lower index).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P (16 x 64 per warp, the accumulator fragments of an earlier product)
// rounded to bf16 as the A fragments of the four 16-row blocks of K.
__device__ __forceinline__ void pack_a_frags(uint32_t (&a)[4][4], const float (&pc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = bf16x2(pc[2 * kk][0], pc[2 * kk][1]);
    a[kk][1] = bf16x2(pc[2 * kk][2], pc[2 * kk][3]);
    a[kk][2] = bf16x2(pc[2 * kk + 1][0], pc[2 * kk + 1][1]);
    a[kk][3] = bf16x2(pc[2 * kk + 1][2], pc[2 * kk + 1][3]);
  }
}

// 2^x on the special-function unit, denormal results flushed to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The KV-tile stage of B1 and B3: keys [c0, c0 + 64) of a (nk, 64) K and V
// ---------------------------------------------------------------------------

constexpr int kKvTileBytes = 64 * 128;                 // one swizzled 64 x 64 bf16 tile
constexpr int kKvMaskOff = 2 * kKvTileBytes;           // the keys' mask words
constexpr int kKvIdsOff = kKvMaskOff + 128;            // the keys' document ids
constexpr int kKvStageBytes = 2 * kKvTileBytes + 1024;  // 17,408: whole swizzle atoms
static_assert(kKvIdsOff + 64 * 4 <= kKvStageBytes, "a stage holds its ids");

// Issues, by kThreads threads of which this is number tid, the cp.async
// copies of one stage at shared address `st`: the swizzled K and V tiles
// (keys past nk zero), the 17 aligned 4-byte words that hold the keys' mask
// bytes when there is a key mask (kvm, this batch row's; key c0 + j's byte
// sits at kv_mask_bytes(...)[j]) and, when kseg is set, the keys' document
// ids (0 past nk).  A mask word is read only when its first byte lies
// inside the row, so no read leaves the mask's words.
template <int kThreads>
__device__ __forceinline__ void load_kv_stage(uint32_t st, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, const uint8_t* kvm,
                                              const int* kseg, int c0, int nk, int tid) {
  static_assert(kThreads >= 128, "a thread per key id");
  load_swizzled<kThreads>(st, k, c0, 64, nk, tid);
  load_swizzled<kThreads>(st + kKvTileBytes, v, c0, 64, nk, tid);
  const int i = tid;
  if (kvm != nullptr && i < 17) {
    const uint8_t* first =
        reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(kvm + c0) & ~uintptr_t(3));
    const uint8_t* word = first + 4 * i;
    const bool valid = word < kvm + nk;
    cp_async(st + kKvMaskOff + 4 * i, valid ? word : first, 4, valid);
  }
  if (kseg != nullptr && i >= 64 && i < 128) {
    const bool valid = c0 + i - 64 < nk;
    cp_async(st + kKvIdsOff + 4 * (i - 64), kseg + (valid ? c0 + i - 64 : 0), 4, valid);
  }
}

// The mask bytes of a landed stage (generic pointer `stp`) for the keys
// from c0 on.
__device__ __forceinline__ const uint8_t* kv_mask_bytes(const unsigned char* stp,
                                                        const uint8_t* kvm, int c0) {
  return stp + kKvMaskOff + (reinterpret_cast<uintptr_t>(kvm + c0) & 3);
}

// ---------------------------------------------------------------------------
// A declared document packing, shared by B1, B2 and B3
// ---------------------------------------------------------------------------

// The tile range [*t_begin, *t_end) that the band gives block `blk`,
// intersected with row `blk` of a doc-tile table: (blocks, 2) int32, the
// [begin, end) tiles of the other side that the block visits under a
// block-aligned packing (ops/cuda_flash.py::doc_tile_ranges).  Each block
// then lies in one document and every tile it drops holds only keys (or
// rows) of other documents.
__device__ __forceinline__ void doc_clip(const int* doc_tiles, int blk, int* t_begin,
                                         int* t_end) {
  *t_begin = max(*t_begin, doc_tiles[2 * blk]);
  *t_end = max(*t_begin, min(*t_end, doc_tiles[2 * blk + 1]));
}

}  // namespace
