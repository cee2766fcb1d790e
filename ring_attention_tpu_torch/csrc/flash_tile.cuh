// Device code shared by the forward flash kernels: the constants, the band
// (its tile range and its score), the mma.sync helpers and the body of one
// 64-key KV tile in bf16 (tensor cores) and f32 (CUDA-core FMA).  The fused
// ring's kernels, flash_ring.cu (B7) and flash_ring_remote.cu (B8), run both
// tile bodies; the forward sweep, flash_fwd.cu (B1), runs the f32 body and
// takes the constants, the band and the bf16 output write from here, while
// its bf16 sweep is a kernel of its own on wgmma (wgmma.cuh).  Every
// function is __forceinline__, so each kernel keeps its own __global__, its
// own Params and its own register budget; a fix to the tile loop is made
// here once for all of them.  Packed sequences (per-token document ids) are
// a template flag of the tile body, kSeg: false, the default, compiles the
// body as it was.
//
// Layouts, as the kernels use them:
//   * bf16: 4 warps, each owns 16 query rows.  The online-softmax state is
//     in mma fragment layout: o[nd][2r + c] is row (r ? row_a + 8 : row_a),
//     column nd * 8 + 2t + c (g = lane / 4, t = lane % 4); m_r[r] is the same
//     on a row's 4 threads and l_r[r] is this thread's share of the row sum.
//     p is rounded to bf16 for the PV product, as the TPU kernel does
//     (p.astype(v.dtype)), while l sums the f32 p;
//   * f32: one query row per thread, qv and acc in registers, keys folded 16
//     at a time per online-softmax update.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.5f * 3.402823466e38f;  // -0.5 * f32 max, finite
constexpr float kEpsilon = 1e-10f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per KV tile

// What turns query row i's dot product with key j into its score, in one
// launch's (or one ring hop's) local coordinates: the band lo <= j - i <= hi,
// the key mask and the scale and soft clamp.  A side of the band left open
// takes a bound no pair can cross (hi >= nk - 1, lo <= 1 - nq): one form for
// every band keeps the tile loop free of flag branches (a causal and a
// windowed flag in the score made the bf16 sweep ~1.35x slower on an H100).
struct Band {
  int hi, lo;
  int nk;                  // keys; a column at or past nk weighs exactly zero
  const uint8_t* kvm;      // this batch row's (and hop's) key mask, or null
  float scale, softclamp;  // softclamp 0 = off
};

// [t_begin, t_end): the KV tiles that rows [r0, r0 + kBlockM) of nq need.
// A block holding a row with an empty band takes every tile, so such a row
// still averages V over every key.
__device__ __forceinline__ void band_tiles(const Band& bd, int nq, int r0, int* t_begin,
                                           int* t_end) {
  *t_begin = 0;
  *t_end = (bd.nk + kBlockN - 1) / kBlockN;
  // row i attends max(0, i + lo) <= j <= min(nk - 1, i + hi); the first row
  // has the narrowest upper bound and the last row the highest lower bound
  const long long r_last = (long long)min(r0 + kBlockM, nq) - 1;
  if ((long long)r0 + bd.hi < 0 || r_last + bd.lo > bd.nk - 1 || bd.lo > bd.hi) return;
  const long long j_min = max((long long)r0 + bd.lo, 0LL);
  const long long j_max = min(r_last + bd.hi, (long long)bd.nk - 1);
  *t_begin = (int)(j_min / kBlockN);
  *t_end = (int)(j_max / kBlockN) + 1;
}

// Packed sequences: this batch row's key ids in device memory (by column)
// and a block's ids in shared memory: [0, kBlockM) those of its query rows
// (the kernel loads them with its Q tile), [kBlockM, kBlockM + kBlockN)
// those of the current KV tile's keys (the tile body loads them with K and
// V).  Only a kSeg instantiation reads it.
struct SegTile {
  const int* kseg;
  int* ids;
};

// The current tile's key ids, keys [c0, c0 + kBlockN), into st.ids; a key
// past nk takes 0 (its score is -inf whatever its id).
__device__ __forceinline__ void load_seg_tile(const SegTile& st, int c0, int nk) {
  for (int i = threadIdx.x; i < kBlockN; i += blockDim.x)
    st.ids[kBlockM + i] = c0 + i < nk ? st.kseg[c0 + i] : 0;
}

// The scaled, soft-clamped score of (row, col); a key outside the band or
// masked out takes the finite mask value, and so does (kSeg) a key of
// another document than the row's (same_doc false).  The document test is
// a template flag and not a runtime one: a flag in the score slows the
// sweep (Band).
template <bool kSeg = false>
__device__ __forceinline__ float band_score(const Band& bd, int row, int col, float dot,
                                            bool same_doc = true) {
  const int off = col - row;
  bool keep = off <= bd.hi && off >= bd.lo;
  if (col >= bd.nk) return -INFINITY;
  float s = dot * bd.scale;
  if (bd.softclamp > 0.f) s = bd.softclamp * tanhf(s / bd.softclamp);
  if (bd.kvm != nullptr) keep = keep && bd.kvm[col] != 0;
  if constexpr (kSeg) keep = keep && same_doc;
  return keep ? s : kMaskValue;
}

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * kLog2e); }

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as bf16x2; the first lands in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into shared memory with a
// row stride of D + 8 elements (staggers the banks); rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kBlockM * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

// The A fragments of this warp's 16 query rows, from the Q tile in shared
// memory.
template <int D>
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* Qs,
                                             uint32_t (&qf)[D / 16][4]) {
  constexpr int kStride = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * kStride + kk * 16 + t * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
}

// One KV tile of the bf16 forward: keys [c0, c0 + 64) of k and v (bd.nk
// rows) into Ks and Vs, s = q k^T, the online-softmax update of (o, m_r,
// l_r) and o += p v, for this warp's rows row_a and row_a + 8; with kSeg,
// only the keys of each row's document (st) count.
template <int D, bool kSeg = false>
__device__ __forceinline__ void bf16_tile(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const Band& bd,
                                          int c0, const uint32_t (&qf)[D / 16][4],
                                          float (&o)[D / 8][4], float (&m_r)[2],
                                          float (&l_r)[2], int row_a,
                                          const SegTile& st = SegTile{}) {
  constexpr int kStride = D + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group id and thread in group
  const int row_b = row_a + 8;
  __syncthreads();  // every warp is done with the previous K/V tile
  load_tile_bf16<D>(Ks, k, c0, bd.nk);
  load_tile_bf16<D>(Vs, v, c0, bd.nk);
  if constexpr (kSeg) load_seg_tile(st, c0, bd.nk);
  __syncthreads();

  // s = q k^T: 8 fragments of 16 rows x 8 keys
  float s[kBlockN / 8][4];
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kb = Ks + (j * 8 + g) * kStride + kk * 16 + t * 2;
      const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kb),
                              *reinterpret_cast<const uint32_t*>(kb + 8)};
      mma_16816(s[j], qf[kk], bf);
    }
  }

  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int col = c0 + j * 8 + t * 2 + (e & 1);
      // kSeg: the ids from shared memory, key by key (held in registers
      // through the products, or folded into a bit mask there, they
      // spilled at the 128-register cap and ran slower)
      s[j][e] = band_score<kSeg>(
          bd, row, col, s[j][e],
          !kSeg || st.ids[kBlockM + j * 8 + t * 2 + (e & 1)] ==
                       st.ids[threadIdx.x / 32 * 16 + g + 8 * (e >> 1)]);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit on 4 threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float alpha = exp_nat(m_r[r] - mx[r]);
    m_r[r] = mx[r];
    l_r[r] *= alpha;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][2 * r] *= alpha;
      o[nd][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp_nat(s[j][e] - m_r[e >> 1]);
      l_r[e >> 1] += s[j][e];
    }
  }

  // o += p v: the score fragments of two key groups form one A fragment
  const uint16_t* Vraw = reinterpret_cast<const uint16_t*>(Vs);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const uint16_t* vb = Vraw + (kk * 16 + t * 2) * kStride + nd * 8 + g;
      const uint32_t bf[2] = {pack_raw(vb[0], vb[kStride]),
                              pack_raw(vb[8 * kStride], vb[9 * kStride])};
      mma_16816(o[nd], a, bf);
    }
  }
}

// out[idx] = o / l in bf16 for row half r of the fragments and lse[idx] =
// m + log l, once l holds the row's whole sum.
template <int D>
__device__ __forceinline__ void store_out_bf16(__nv_bfloat16* out, float* lse,
                                               size_t idx, const float (&o)[D / 8][4],
                                               int r, float m, float l) {
  const int t = threadIdx.x % 4;
  const float l_safe = fmaxf(l, kEpsilon);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    *reinterpret_cast<uint32_t*>(out + idx * D + nd * 8 + t * 2) =
        pack_bf16(o[nd][2 * r] / l_safe, o[nd][2 * r + 1] / l_safe);
  }
  if (t == 0) lse[idx] = m + logf(l_safe);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA, one query row per thread
// ---------------------------------------------------------------------------

// Row `row` of the (n, D) queries into qv (zeros past n), and acc zeroed.
template <int D>
__device__ __forceinline__ void load_q_row_f32(const float* q, int row, int n,
                                               float (&qv)[D], float (&acc)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) x = *reinterpret_cast<const float4*>(q + (size_t)row * D + d);
    qv[d] = x.x; qv[d + 1] = x.y; qv[d + 2] = x.z; qv[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
}

// One KV tile of the f32 forward: keys [c0, c0 + 64) of k and v (bd.nk
// rows) into Ks and Vs, then this thread's row folded into (acc, m, l) 16
// keys at a time; with kSeg, only the keys of the row's document (st; the
// block's row threadIdx.x).
template <int D, bool kSeg = false>
__device__ __forceinline__ void f32_tile(float* Ks, float* Vs, const float* k,
                                         const float* v, const Band& bd, int c0,
                                         const float (&qv)[D], float (&acc)[D],
                                         float& m, float& l, int row,
                                         const SegTile& st = SegTile{}) {
  constexpr int kChunk = 16;  // keys folded per online-softmax update
  __syncthreads();
  for (int i = threadIdx.x; i < kBlockN * D / 4; i += blockDim.x) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (c0 + r < bd.nk) {
      kx = *reinterpret_cast<const float4*>(k + (size_t)(c0 + r) * D + c);
      vx = *reinterpret_cast<const float4*>(v + (size_t)(c0 + r) * D + c);
    }
    *reinterpret_cast<float4*>(Ks + r * D + c) = kx;
    *reinterpret_cast<float4*>(Vs + r * D + c) = vx;
  }
  if constexpr (kSeg) load_seg_tile(st, c0, bd.nk);
  __syncthreads();

  for (int c = 0; c < kBlockN; c += kChunk) {
    float s[kChunk];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float* kr = Ks + (c + jj) * D;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qv[d], kr[d], dot);
      s[jj] = band_score<kSeg>(bd, row, c0 + c + jj, dot,
                               !kSeg || st.ids[kBlockM + c + jj] == st.ids[threadIdx.x]);
      mx = fmaxf(mx, s[jj]);
    }
    const float alpha = exp_nat(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float pj = exp_nat(s[jj] - m);
      l += pj;
      const float* vr = Vs + (c + jj) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
    }
  }
}

// out[idx] = acc / l and lse[idx] = m + log l for one f32 row.
template <int D>
__device__ __forceinline__ void store_out_f32(float* out, float* lse, size_t idx,
                                              const float (&acc)[D], float m, float l) {
  const float l_safe = fmaxf(l, kEpsilon);
  float* row = out + idx * D;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(row + d) =
        make_float4(acc[d] / l_safe, acc[d + 1] / l_safe, acc[d + 2] / l_safe,
                    acc[d + 3] / l_safe);
  lse[idx] = m + logf(l_safe);
}

}  // namespace
