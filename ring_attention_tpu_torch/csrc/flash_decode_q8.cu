// Split-KV decode attention over an int8 KV cache for NVIDIA Hopper (built
// for sm_90a).
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
// The math stays f32 and p is not rounded; the token scales are folded out
// of the products (s = (q . f32(k8)) * ks * scale, and p * vs weighs
// f32(v8)), a change of rounding only.  The keys are split into S ranges of
// whole 64-key tiles, each range's (acc, m, l) starting at the mask value,
// and the ranges merge as one online-softmax sweep would (csrc/
// flash_decode.cu), so the split changes the f32 rounding only.
//
// What bounds it on an H100: device-memory bytes.  Each cache row of a kv
// head is read once, 2 * (64 + 4) bytes for k and v at d = 64 (against
// 2 * 128 for a bf16 cache), for about 2R multiply-adds per byte.  At B 4,
// Hk 2, Nk 32,768 the cache is 35.7 MB: 0.0107 ms at 3.35 TB/s.
//
// Design (B5's, csrc/flash_decode.cu): a decode has only B * Hk kv heads of
// work, so the keys of each kv head are split over gridDim.y (S ranges,
// chosen by the wrapper from B * Hk, Nk and the SM count) and the folded
// rows are taken kR at a time on gridDim.z (kR, a template argument, the
// power of two at or above R up to 16, so that a decode of one or four rows
// does the work of one or four).  Each block of 4 warps streams its range
// through a ring of kStages stages of int8 K and V tiles with their f32
// scale vectors beside them (cp.async, zero fill past the range), kStages
// - 1 tiles in flight; each lane's key-mask byte loads a tile ahead of its
// use.  Warp w owns keys 16w..16w+15 of every tile and keeps its own
// online-softmax state: for S two lanes share a key, each taking 32 of its
// 64 columns against the rows of q (f32 in shared memory); for P V each
// lane owns two output columns of every row.  int8 becomes f32 through a
// byte permute into the mantissa of 2^23 and a subtraction (exact; the
// conversion instruction runs at an eighth of the FMA rate).  The warps'
// states merge in shared memory, the block writes its range's (acc, m, l)
// to scratch, and the last of a kv head's S blocks to finish (an atomic
// count, left at zero for the next launch) merges the ranges and writes the
// result: a decode is one launch.
// Not yet: TMA bulk copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.5f * 3.402823466e38f;  // -0.5 * f32 max, finite
constexpr float kEpsilon = 1e-10f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 64;
constexpr int kTile = 64;   // keys per stage
constexpr int kWarps = 4;   // each owns 16 keys of every tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;  // folded query rows per block, at most
constexpr int kStages = 4;
// a stage: K (64 rows of 64 bytes, 16-byte chunks swizzled), V (64 rows of
// 64 bytes), the keys' k and v scales
constexpr int kStageV = kTile * kD;
constexpr int kStageKs = 2 * kTile * kD;
constexpr int kStageVs = kStageKs + kTile * 4;
constexpr int kStageBytes = kStageVs + kTile * 4;
constexpr int kQStride = 2 * (32 + 4);  // floats per row of q: two halves, padded
constexpr float kBias = 8388736.0f;  // 2^23 + 128

struct Params {
  const void* q;           // (B, Hk, R, D) bf16 or f32
  const int8_t* k;         // (B, Hk, Nk, D)
  const float* ks;         // (B, Hk, Nk)
  const int8_t* v;         // (B, Hk, Nk, D)
  const float* vs;         // (B, Hk, Nk)
  const uint8_t* kv_mask;  // (B, Nk) or null
  void* out;               // (B, Hk, R, D) in q's dtype, or null
  float* lse;              // (B, Hk, R), or null
  float* acc;              // partials (B, Hk, R, D), or null
  float* m;                // (B, Hk, R)
  float* l;                // (B, Hk, R)
  float* scratch;          // (B * Hk, S, R, D + 2): each range's acc, m, l
  int* counters;           // (B * Hk * gridDim.z): 0 on entry, left at 0
  int B, Hk, R, Nk, S, per_split, q_bf16;
  float scale, softclamp;
};

template <int kR>
constexpr int smem_bytes() {
  return kStages * kStageBytes + (kR * kQStride + kWarps * 16 * kR) * 4;
}

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ void cp_async(uint32_t dst, const void* gmem, int bytes, bool valid) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte i of a word of int8 values biased to unsigned (w ^ 0x80808080) as the
// f32 it stands for: the byte in the mantissa of 2^23, less 2^23 + 128.
__device__ __forceinline__ float s8_to_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + i)) - kBias;
}

// 16-byte chunk c of key row r of a stage's K tile.
__device__ __forceinline__ int k_chunk(int r, int c) { return r * kD + ((c ^ ((r >> 1) & 1)) << 4); }

// This thread's share of a stage's copies: rows r and r + 32 of the K and V
// tiles, 16-byte chunk c; threads 0..63 the k scale of key tid, 64..127 the
// v scale of key tid - 64.  Offsets from the head's first key (device
// memory) and from the stage (shared memory).
struct StageCopy {
  const int8_t* k;  // k + r * kD + 16 c
  const int8_t* v;
  const float* scale;  // ks or vs, + key
  int r, key;
  uint32_t k0, k1, v0, s0;  // shared-memory offsets
};

__device__ __forceinline__ StageCopy stage_copy(const int8_t* k, const int8_t* v, const float* ks,
                                                const float* vs) {
  const int tid = threadIdx.x % kThreads, r = tid / 4, c = tid % 4, key = tid % kTile;
  return StageCopy{k + r * kD + 16 * c,
                   v + r * kD + 16 * c,
                   (tid < kTile ? ks : vs) + key,
                   r,
                   key,
                   (uint32_t)k_chunk(r, c),
                   (uint32_t)k_chunk(r + 32, c),
                   (uint32_t)(kStageV + r * kD + 16 * c),
                   (uint32_t)((tid < kTile ? kStageKs : kStageVs) + 4 * key)};
}

// Keys [c0, c0 + kTile) of k, v and their scales into the stage at shared
// address st; a key at or past j_end is zero-filled (never read from device
// memory).
__device__ __forceinline__ void load_stage(uint32_t st, const StageCopy& sc, int c0, int j_end) {
  const bool valid0 = c0 + sc.r < j_end, valid1 = c0 + sc.r + 32 < j_end;
  const size_t at = (size_t)c0 * kD;
  cp_async(st + sc.k0, sc.k + (valid0 ? at : 0), 16, valid0);
  cp_async(st + sc.k1, sc.k + (valid1 ? at + 32 * kD : 0), 16, valid1);
  cp_async(st + sc.v0, sc.v + (valid0 ? at : 0), 16, valid0);
  cp_async(st + sc.v0 + 32 * kD, sc.v + (valid1 ? at + 32 * kD : 0), 16, valid1);
  const bool valid = c0 + sc.key < j_end;
  cp_async(st + sc.s0, sc.scale + (valid ? c0 : 0), 4, valid);
}

// One warp's online-softmax state for the block's kR rows: m[r] the same on
// every lane, l[r] this lane's share of the row sum, acc[r] the lane's two
// output columns 2 lane, 2 lane + 1.
template <int kR>
struct State {
  float m[kR], l[kR], acc[kR][2];
};

// One tile: warp w's keys 16w..16w+15 scored by lane pairs (key 16w + lane /
// 2, columns 32 (lane % 2) on), the rows' online-softmax update, then P V
// with lane owning columns 2 lane and 2 lane + 1.
template <int kR>
__device__ __forceinline__ void tile_q8(const Params& p, uint8_t keep_byte, const unsigned char* st,
                                        const float* Qs, float* pb, int c0, int j_end,
                                        State<kR>& sw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int key = warp * 16 + lane / 2;  // in the tile

  // two partial sums a row (the key's columns 16c..16c+15 of this half), so
  // that the two chains of FMAs run side by side
  float dot[2][kR];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(st + k_chunk(key, 2 * half + c));
    const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                               raw.w ^ 0x80808080u};
#pragma unroll
    for (int r = 0; r < kR; ++r) dot[c][r] = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kf[i] = s8_to_f32(words[w], i);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + r * kQStride + half * 36 + 16 * c + 4 * w);
        dot[c][r] = fmaf(qv.x, kf[0], dot[c][r]);
        dot[c][r] = fmaf(qv.y, kf[1], dot[c][r]);
        dot[c][r] = fmaf(qv.z, kf[2], dot[c][r]);
        dot[c][r] = fmaf(qv.w, kf[3], dot[c][r]);
      }
    }
  }
  const int col = c0 + key;
  const float kscale = reinterpret_cast<const float*>(st + kStageKs)[key];
  const float vscale = reinterpret_cast<const float*>(st + kStageVs)[key];
  float alpha[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float d = dot[0][r] + dot[1][r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    float s = -INFINITY;  // past the range: weighs exactly zero
    if (col < j_end) {
      s = d * kscale * p.scale;
      if (p.softclamp > 0.f) s = tanhf(s / p.softclamp) * p.softclamp;
      if (keep_byte == 0) s = kMaskValue;
    }
    float mx = s;
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mx = fmaxf(mx, sw.m[r]);
    alpha[r] = exp_nat(sw.m[r] - mx);
    sw.m[r] = mx;
    const float pr = exp_nat(s - mx);
    sw.l[r] = sw.l[r] * alpha[r] + (half == 0 ? pr : 0.f);
    if (half == 0) pb[(lane / 2) * kR + r] = pr * vscale;
  }
  __syncwarp();
  const unsigned char* vt = st + kStageV + warp * 16 * kD + 2 * lane;
  // the tile's P V in two sums a column (even and odd keys), side by side
  float pv[2][kR][2];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint32_t biased = (uint32_t)*reinterpret_cast<const uint16_t*>(vt + kk * kD) ^ 0x8080u;
    const float v0 = s8_to_f32(biased, 0), v1 = s8_to_f32(biased, 1);
    float pk[kR];
    if constexpr (kR % 4 == 0) {
#pragma unroll
      for (int r = 0; r < kR; r += 4) {
        const float4 x = *reinterpret_cast<const float4*>(pb + kk * kR + r);
        pk[r] = x.x, pk[r + 1] = x.y, pk[r + 2] = x.z, pk[r + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) pk[r] = pb[kk * kR + r];
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      pv[kk & 1][r][0] = kk < 2 ? pk[r] * v0 : fmaf(pk[r], v0, pv[kk & 1][r][0]);
      pv[kk & 1][r][1] = kk < 2 ? pk[r] * v1 : fmaf(pk[r], v1, pv[kk & 1][r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    sw.acc[r][0] = fmaf(sw.acc[r][0], alpha[r], pv[0][r][0] + pv[1][r][0]);
    sw.acc[r][1] = fmaf(sw.acc[r][1], alpha[r], pv[0][r][1] + pv[1][r][1]);
  }
  __syncwarp();  // pb is read before the next tile writes it
}

// Merges the S ranges' (acc, m, l) of rows [r0, r0 + rows) of kv head bh
// from scratch as one online-softmax sweep would, and writes the result;
// row_max is shared memory for kMaxRows floats (csrc/flash_decode.cu's).
__device__ __forceinline__ void merge_ranges(const Params& p, int bh, int r0, int rows,
                                             float* row_max) {
  const size_t step = (size_t)p.R * (kD + 2);  // one range to the next
  const float* part0 = p.scratch + ((size_t)bh * p.S * p.R + r0) * (kD + 2);
  static_assert(kThreads == 8 * kMaxRows, "8 threads a row");
  {  // each row's largest m, 8 threads a row
    const int row = threadIdx.x / 8;
    float mx = kMaskValue;
    if (row < rows)
      for (int r = threadIdx.x % 8; r < p.S; r += 8)
        mx = fmaxf(mx, __ldcg(part0 + row * (kD + 2) + r * step + kD));
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x % 8 == 0 && row < rows) row_max[row] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int row = i / kD, d = i % kD;
    const float mx = row_max[row];
    float l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < p.S; ++r) {
      const float* part = part0 + row * (kD + 2) + r * step;
      const float w = exp_nat(__ldcg(part + kD) - mx);
      l = fmaf(__ldcg(part + kD + 1), w, l);
      acc = fmaf(__ldcg(part + d), w, acc);
    }
    const size_t at = (size_t)bh * p.R + r0 + row;
    if (p.acc != nullptr) {
      p.acc[at * kD + d] = acc;
      if (d == 0) {
        p.m[at] = mx;
        p.l[at] = l;
      }
    } else {
      const float l_safe = fmaxf(l, kEpsilon);
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.out)[at * kD + d] = __float2bfloat16_rn(acc / l_safe);
      else
        static_cast<float*>(p.out)[at * kD + d] = acc / l_safe;
      if (d == 0) p.lse[at] = mx + logf(l_safe);
    }
  }
}

// kR of 1 and 2 state their blocks per SM: left to itself ptxas gives them
// 64 registers and spills.
template <int kR>
__global__ void __launch_bounds__(kThreads, kR <= 2 ? 4 : 1) decode_q8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // kR x kQStride
  float* Pb = Qs + kR * kQStride;                                      // kWarps x 16 x kR

  const int bh = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * kR;
  const int j_begin = min(p.Nk, split * p.per_split);
  const int j_end = min(p.Nk, j_begin + p.per_split);
  const int n_tiles = (j_end - j_begin + kTile - 1) / kTile;
  const int8_t* k = p.k + (size_t)bh * p.Nk * kD;
  const int8_t* v = p.v + (size_t)bh * p.Nk * kD;
  const float* ks = p.ks + (size_t)bh * p.Nk;
  const float* vs = p.vs + (size_t)bh * p.Nk;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)(bh / p.Hk) * p.Nk : nullptr;

  // the block's rows of q in f32 (zeros past R), each row's two halves of 32
  // columns apart by 36 floats, then the first kStages - 1 tiles
  for (int i = threadIdx.x; i < kR * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    float x = 0.f;
    if (r0 + r < p.R) {
      const size_t at = ((size_t)bh * p.R + r0 + r) * kD + c;
      x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
                   : static_cast<const float*>(p.q)[at];
    }
    Qs[r * kQStride + (c / 32) * 36 + c % 32] = x;
  }
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const StageCopy sc = stage_copy(k, v, ks, vs);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(ring + s * kStageBytes, sc, j_begin + s * kTile, j_end);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  State<kR> sw;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    sw.m[r] = kMaskValue;
    sw.l[r] = 0.f;
    sw.acc[r][0] = sw.acc[r][1] = 0.f;
  }
  float* pb = Pb + warp * 16 * kR;

  // the key-mask byte of tile i + 1 loads while tile i is consumed
  const int my_key = warp * 16 + lane / 2;
  auto mask_byte = [&](int c0) -> uint8_t {
    return kvm != nullptr && c0 + my_key < j_end ? kvm[c0 + my_key] : (uint8_t)1;
  };
  uint8_t mk_next = mask_byte(j_begin);
  for (int i = 0; i < n_tiles; ++i) {
    const uint8_t mk = mk_next;
    if (i + 1 < n_tiles) mk_next = mask_byte(j_begin + (i + 1) * kTile);
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's part)
    __syncthreads();               // ... and everyone's; slot i - 1 is free
    const int next = i + kStages - 1;
    if (next < n_tiles)
      load_stage(ring + ((unsigned)next % kStages) * kStageBytes, sc, j_begin + next * kTile,
                 j_end);
    cp_async_commit();
    tile_q8<kR>(p, mk, smem + ((unsigned)i % kStages) * kStageBytes, Qs, pb, j_begin + i * kTile,
                j_end,
                sw);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states merge through it

  float* Ow = reinterpret_cast<float*>(smem);  // kWarps x kR x kD
  float* Mw = Ow + kWarps * kR * kD;           // kWarps x kR
  float* Lw = Mw + kWarps * kR;                // kWarps x kR
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float l = sw.l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    *reinterpret_cast<float2*>(Ow + (warp * kR + r) * kD + 2 * lane) =
        make_float2(sw.acc[r][0], sw.acc[r][1]);
    if (lane == 0) {
      Mw[warp * kR + r] = sw.m[r];
      Lw[warp * kR + r] = l;
    }
  }
  __syncthreads();

  const int rows = min(kR, p.R - r0);
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int row = i / kD, d = i % kD;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Mw[w * kR + row]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp_nat(Mw[w * kR + row] - mx);
      acc = fmaf(Ow[(w * kR + row) * kD + d], wt, acc);
      l = fmaf(Lw[w * kR + row], wt, l);
    }
    float* out = p.scratch + (((size_t)bh * p.S + split) * p.R + r0 + row) * (kD + 2);
    out[d] = acc;
    if (d == 0) {
      out[kD] = mx;
      out[kD + 1] = l;
    }
  }

  // the last of the S blocks of this (kv head, row group) merges the ranges
  // and sets the counter back to 0 for the next launch
  __shared__ bool last;
  __shared__ float row_max[kMaxRows];
  __threadfence();  // this range's (acc, m, l) is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.counters + (size_t)bh * gridDim.z + blockIdx.z;
    last = atomicAdd(counter, 1) == p.S - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) merge_ranges(p, bh, r0, rows, row_max);
}

constexpr int kMaxDevices = 64;

template <int kR>
int launch(const Params& p, cudaStream_t s) {
  constexpr int bytes = smem_bytes<kR>();
  static_assert(kStages * kStageBytes >= (kWarps * kR * (kD + 2)) * 4, "the merge reuses the ring");
  // the shared-memory limit, raised once per device (a decode is host-bound
  // at small caches: no per-call attribute call)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(decode_q8_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid(p.B * p.Hk, p.S, (p.R + kR - 1) / kR);
  decode_q8_kernel<kR><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).  Allocates nothing: the caller
// passes `scratch` of B*Hk*S*R*(D + 2) floats and `counters` of
// B*Hk*ceil(R / rows) int32 zeros, which the launch leaves at zero (launches
// that share counters must be ordered, as on one stream).  `rows` (1, 2, 4,
// 8 or 16) is the folded rows a block takes.  Either (out, lse) or (acc, m,
// l) is set, the other all null.  The S ranges hold ceil(ceil(Nk / S) / 64)
// * 64 keys each (the last ones may be short or empty).
extern "C" int flash_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* kv_mask, void* out, void* lse,
                               void* acc, void* m, void* l, void* scratch, void* counters,
                               int B, int Hk, int R, int Nk, int D, int S, int rows, int q_bf16,
                               float scale, float softclamp, void* stream) {
  if (D != kD || B <= 0 || Hk <= 0 || R <= 0 || Nk <= 0 || S <= 0 || S > 65535 ||
      (R + rows - 1) / rows > 65535)
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
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.Hk = Hk;
  p.R = R;
  p.Nk = Nk;
  p.S = S;
  p.per_split = ((Nk + S - 1) / S + kTile - 1) / kTile * kTile;
  p.q_bf16 = q_bf16;
  p.scale = scale;
  p.softclamp = softclamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 4: return launch<4>(p, s);
    case 8: return launch<8>(p, s);
    case 16: return launch<16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
