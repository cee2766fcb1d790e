// Decode attention over an int8 KV cache for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_flash.py::pallas_flash_decode_q8
// (the pl.pallas_call at :1585; kernel body _decode_q8_kernel :1441), fused
// (out + lse) and partials (acc, m, l) alike.
//
// What it computes, for queries q (B, Hk, R, D) in bf16 or f32 (the GQA
// group folded onto R = (H / Hk) * Nq rows by the wrapper) and a cache of
// int8 values k8, v8 (B, Hk, Nk, D) with one f32 scale per token row
// ks, vs (B, Hk, Nk):
//   k = f32(k8) * ks[token], v = f32(v8) * vs[token]   (dequantized in f32)
//   s = (f32(q) . k) * scale, then c * tanh(s / c) when c > 0;
//   masked keys (kv_mask[b, j] == 0) take the finite mask value;
//   an f32 online softmax: out = acc / max(l, 1e-10) in q's dtype and
//   lse = m + log(max(l, 1e-10)), or the raw (acc, m, l).
// Its numerics do not depend on how the keys are split: each part's
// (acc, m, l) merges exactly as one online-softmax sweep would.
//
// What bounds it on an H100: device-memory bytes.  Each cache row of a kv
// head is read once, 2 * (64 + 4) bytes for k and v at d = 64 (against
// 2 * 128 for a bf16 cache), for about 2R multiply-adds per byte.
//
// Design: a decode has only B * Hk (kv head) rows of work, 32 on a serving
// batch of 4 with 8 kv heads, too few blocks for 132 SMs.  So the keys of
// each kv head are split into parts, one warp each (4 warps a block), enough
// blocks for two waves of the card; a second small kernel merges the parts'
// (acc, m, l) and writes the result.  Within a warp, each lane scores one
// key of a 32-key tile (its k row is 4 16-byte loads), the warp takes the
// tile's row max by shuffles, and for PV each lane owns two of the 64 output
// columns and reads each key's v bytes as one coalesced 64-byte row.  Query
// rows are taken 8 at a time (gridDim.z groups); the serving path has 1
// (8 heads on 8 kv heads) or 4 (8 on 2).
// Not yet: cp.async prefetch of the next tile, the int8 dot on dp4a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.5f * 3.402823466e38f;  // -0.5 * f32 max, finite
constexpr float kEpsilon = 1e-10f;
constexpr int kD = 64;
constexpr int kRows = 8;   // query rows per block (gridDim.z groups)
constexpr int kWarps = 4;  // parts per block

struct Params {
  const void* q;  // (B, Hk, R, D) bf16 or f32
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const uint8_t* kv_mask;  // (B, Nk) or null
  void* out;               // (B, Hk, R, D) in q's dtype, or null
  float* lse;              // (B, Hk, R), or null
  float* acc;              // partials (B, Hk, R, D), or null
  float* m;                // (B, Hk, R)
  float* l;                // (B, Hk, R)
  float* scratch;          // (B*Hk, P, R, D + 2): each part's acc, m, l
  int B, Hk, R, Nk, P, q_bf16;
  float scale, softclamp;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One part of the keys of one kv head, one warp: its (acc, m, l) per row.
__global__ void __launch_bounds__(kWarps * 32) decode_q8_parts_kernel(const Params p) {
  __shared__ float qsh[kRows][kD];
  const int bh = blockIdx.x;  // b * Hk + kv head
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, p.R - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = blockIdx.y * kWarps + warp;

  for (int i = threadIdx.x; i < rows * kD; i += blockDim.x) {
    const size_t at = ((size_t)bh * p.R + r0) * kD + i;
    qsh[i / kD][i % kD] = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
                                   : static_cast<const float*>(p.q)[at];
  }
  __syncthreads();

  const int per_part = ((p.Nk + p.P - 1) / p.P + 31) / 32 * 32;
  const int j_begin = part * per_part;
  const int j_end = min(p.Nk, j_begin + per_part);
  const int8_t* k = p.k + (size_t)bh * p.Nk * kD;
  const int8_t* v = p.v + (size_t)bh * p.Nk * kD;
  const float* ks = p.ks + (size_t)bh * p.Nk;
  const float* vs = p.vs + (size_t)bh * p.Nk;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)(bh / p.Hk) * p.Nk : nullptr;

  float m[kRows], l[kRows], acc[kRows][2];  // lane owns columns 2*lane, 2*lane+1
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }

  for (int j0 = j_begin; j0 < j_end; j0 += 32) {
    const int j = j0 + lane;  // this lane's key
    float s[kRows];
    if (j < j_end) {
      const float kscale = ks[j];
      float kf[kD];
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(k + (size_t)j * kD + c * 16);
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[c * 16 + e] = (float)bytes[e] * kscale;
      }
      const bool keep = kvm == nullptr || kvm[j] != 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) {
          s[r] = -INFINITY;
          continue;
        }
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot = fmaf(qsh[r][d], kf[d], dot);
        float x = dot * p.scale;
        if (p.softclamp > 0.f) x = tanhf(x / p.softclamp) * p.softclamp;
        s[r] = keep ? x : kMaskValue;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = -INFINITY;  // past the part: weighs zero
    }
    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) continue;
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float alpha = expf(m[r] - m_new);
      pr[r] = expf(s[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr[r]);
      acc[r][0] *= alpha;
      acc[r][1] *= alpha;
      m[r] = m_new;
    }
    const int n = min(32, j_end - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int key = j0 + jj;
      const char2 raw = *reinterpret_cast<const char2*>(v + (size_t)key * kD + 2 * lane);
      const float vscale = vs[key];
      const float v0 = (float)raw.x * vscale, v1 = (float)raw.y * vscale;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) continue;
        const float pj = __shfl_sync(0xffffffffu, pr[r], jj);
        acc[r][0] = fmaf(pj, v0, acc[r][0]);
        acc[r][1] = fmaf(pj, v1, acc[r][1]);
      }
    }
  }

  for (int r = 0; r < rows; ++r) {
    float* out = p.scratch + (((size_t)bh * p.P + part) * p.R + r0 + r) * (kD + 2);
    *reinterpret_cast<float2*>(out + 2 * lane) = make_float2(acc[r][0], acc[r][1]);
    if (lane == 0) {
      out[kD] = m[r];
      out[kD + 1] = l[r];
    }
  }
}

// Merge the P parts of each (kv head, row); one block of 64 threads (one per
// output column) per row.
__global__ void __launch_bounds__(kD) decode_q8_merge_kernel(const Params p) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const float* part0 = p.scratch + ((size_t)bh * p.P * p.R + r) * (kD + 2);
  const size_t step = (size_t)p.R * (kD + 2);
  float mx = kMaskValue;
  for (int i = 0; i < p.P; ++i) mx = fmaxf(mx, part0[i * step + kD]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < p.P; ++i) {
    const float* part = part0 + i * step;
    const float w = expf(part[kD] - mx);
    l = fmaf(part[kD + 1], w, l);
    acc = fmaf(part[d], w, acc);
  }
  const size_t row = (size_t)bh * p.R + r;
  if (p.acc != nullptr) {
    p.acc[row * kD + d] = acc;
    if (d == 0) {
      p.m[row] = mx;
      p.l[row] = l;
    }
    return;
  }
  const float l_safe = fmaxf(l, kEpsilon);
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.out)[row * kD + d] = __float2bfloat16_rn(acc / l_safe);
  else
    static_cast<float*>(p.out)[row * kD + d] = acc / l_safe;
  if (d == 0) p.lse[row] = mx + logf(l_safe);
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues the two launches on `stream`
// and returns cudaGetLastError() (0 = launched).  Allocates nothing: the
// caller passes `scratch` of B*Hk*P*R*(D + 2) floats, P a multiple of 4.
// Either (out, lse) or (acc, m, l) is set, the other all null.
extern "C" int flash_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* kv_mask, void* out, void* lse,
                               void* acc, void* m, void* l, void* scratch, int B, int Hk,
                               int R, int Nk, int D, int P, int q_bf16, float scale,
                               float softclamp, void* stream) {
  if (D != kD || R <= 0 || Nk <= 0 || P <= 0 || P % kWarps != 0)
    return (int)cudaErrorInvalidValue;
  const bool partials = acc != nullptr;
  if ((m != nullptr) != partials || (l != nullptr) != partials ||
      (out != nullptr) == partials || (lse != nullptr) == partials)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.ks = static_cast<const float*>(ks);
  p.v = static_cast<const int8_t*>(v);
  p.vs = static_cast<const float*>(vs);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.scratch = static_cast<float*>(scratch);
  p.B = B;
  p.Hk = Hk;
  p.R = R;
  p.Nk = Nk;
  p.P = P;
  p.q_bf16 = q_bf16;
  p.scale = scale;
  p.softclamp = softclamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hk, P / kWarps, (R + kRows - 1) / kRows);
  decode_q8_parts_kernel<<<grid, kWarps * 32, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_q8_merge_kernel<<<dim3(B * Hk, R), kD, 0, s>>>(p);
  return (int)cudaGetLastError();
}
