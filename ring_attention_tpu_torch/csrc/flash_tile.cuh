// Device code shared by the forward flash kernels: the constants, the band
// (its tile range and its score), the bf16 output write of the wgmma sweep
// (flash_sweep.cuh) and the body of one 64-key KV tile in f32 (CUDA-core
// FMA).  The forward sweep, flash_fwd.cu (B1), and the fused ring's
// kernels, flash_ring.cu (B7) and flash_ring_remote.cu (B8), run the f32
// body in their f32 instantiations and take the band and the bf16 output
// write from here; their bf16 sweep is flash_sweep.cuh's, on wgmma
// (wgmma.cuh).  Every function is __forceinline__, so each kernel keeps its
// own __global__, its own Params and its own register budget; a fix to the
// tile loop is made here once for all of them.  Packed sequences (per-token
// document ids) are a template flag of the f32 tile body, kSeg: false, the
// default, compiles the body as it was.
//
// Layouts, as the kernels use them:
//   * bf16 output: the online-softmax state in wgmma's fragment layout
//     (wgmma.cuh): o[nd][2r + c] is row (r ? row_a + 8 : row_a), column nd *
//     8 + 2t + c (g = lane / 4, t = lane % 4);
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
// bf16: the output write of the wgmma sweep (flash_sweep.cuh)
// ---------------------------------------------------------------------------

// Two floats as bf16x2; the first lands in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
