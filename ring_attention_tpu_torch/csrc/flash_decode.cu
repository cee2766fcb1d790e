// Split-KV decode attention for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_flash.py::pallas_flash_decode
// (:1340), the decode mode of the forward sweep (B5): _flash_fwd_call (the
// pl.pallas_call at :1174) over the GQA head group folded onto query rows
// (_decode_fold_rows :1325), fused (out + lse) and partials (acc, m, l).
//
// What it computes, for queries q (B, Hk, R, D) in bf16 or f32 (the group
// folded onto R = (H / Hk) * Nq rows by the wrapper, query head j reading
// kv head j / (H / Hk)) and a cache k, v (B, Hk, Nk, D) of q's type:
//   s = scale * q . k, then c * tanh(s / c) when c > 0;
//   a key with kv_mask[b, j] == 0 takes the FINITE mask value -0.5 * f32
//   max, so a request whose keys are all masked averages V over all Nk keys
//   and its lse is mask + log Nk;
//   an f32 online softmax: out = acc / max(l, 1e-10) in q's dtype and
//   lse = m + log(max(l, 1e-10)), or the raw (acc, m, l).
// The keys are split into S ranges of whole 64-key tiles; each range gives
// its own f32 (acc, m, l), with m starting at the mask value, so a range
// whose keys are all masked carries m = mask value and l = its key count,
// and an empty range (m = mask value, l = 0) adds nothing.  Keys past the
// range (and past Nk) weigh exactly zero: they do not count in l.  The
// ranges merge as one online-softmax sweep would, so the result differs
// from the unsplit sweep only by the f32 rounding of the merge.
//
// What bounds it on an H100: device-memory bytes.  Each cache row of a kv
// head is read once, 2 * 128 bytes for k and v in bf16 at d = 64, against
// 4 R operations per key: about R / 64 operations per byte, far below the
// card's ~295 bf16 operations per byte.  At B 4, Hk 2, Nk 32,768 the cache
// is 67.1 MB: 0.0200 ms at 3.35 TB/s.
//
// Design: a decode has only B * Hk kv heads of work (8 on 4 requests of 2
// kv heads), so the keys of each kv head are split over gridDim.y (S ranges,
// chosen by the wrapper from B * Hk, Nk and the SM count: about two blocks
// an SM, in one wave, since more ranges cost more in the merge) and the
// folded rows are taken 16 at a time on gridDim.z.  Each block streams its range through a ring of K/V
// tiles in dynamic shared memory (kStages stages of 64 keys, cp.async with
// zero fill past the range), kStages - 1 tiles in flight while one is
// consumed; each lane's key-mask bytes load a tile ahead of their use.
// Each of its 4 warps owns 16 keys of every tile and keeps its own
// online-softmax state for the block's rows; the warps' states merge in
// shared memory at the end and the block writes its range's (acc, m, l) to
// scratch.  The last of a kv head's S blocks to finish (an atomic count,
// left at zero for the next launch) merges the ranges and writes the
// result, so a decode is one launch: it is host-bound at small caches.
// bf16: QK^T and PV on mma.sync.m16n8k16 with the rows padded to 16 (V's B
// fragments by ldmatrix.trans), p rounded to bf16 for PV as the forward
// sweep does.  f32: plain FMA on CUDA cores, each lane scoring one key for 8
// of the 16 rows and owning two output columns for PV.
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
constexpr int kRows = 16;   // folded query rows per block (gridDim.z groups)
constexpr int kWarps = 4;   // each owns 16 keys of every tile
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;           // (B, Hk, R, D)
  const void* k;           // (B, Hk, Nk, D)
  const void* v;           // (B, Hk, Nk, D)
  const uint8_t* kv_mask;  // (B, Nk) or null
  void* out;               // (B, Hk, R, D) in q's dtype, or null
  float* lse;              // (B, Hk, R), or null
  float* acc;              // partials (B, Hk, R, D), or null
  float* m;                // (B, Hk, R)
  float* l;                // (B, Hk, R)
  float* scratch;          // (B * Hk, S, R, D + 2): each range's acc, m, l
  int* counters;           // (B * Hk * gridDim.z): 0 on entry, left at 0
  int B, Hk, R, Nk, S, per_split;
  float scale, softclamp;
};

// Shared-memory geometry of one element type: padded rows (staggered banks
// for the fragment loads), the number of stages, and the bytes they take.
template <typename T>
struct Geometry {
  static constexpr int kStride = kD + 16 / (int)sizeof(T);  // elements per row
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 2;  // 2 blocks an SM either way
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kBytes = (2 * kStages * kTileElems + kRows * kStride) * (int)sizeof(T);
};

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keys [c0, c0 + kTile) of k and v into one stage; a key at or past j_end is
// zero-filled (never read from device memory).
template <typename T>
__device__ __forceinline__ void load_stage(T* Ks, T* Vs, const T* k, const T* v, int c0,
                                           int j_end) {
  using G = Geometry<T>;
  constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int kPer = 16 / (int)sizeof(T);          // elements per chunk
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = c0 + r < j_end;
    const size_t at = valid ? (size_t)(c0 + r) * kD + c * kPer : 0;
    cp_async16(Ks + r * G::kStride + c * kPer, k + at, valid);
    cp_async16(Vs + r * G::kStride + c * kPer, v + at, valid);
  }
}

// This lane's kN key-mask bytes of the tile at c0 (key key_of(n) for byte
// n), loaded a tile ahead of their use so that no score waits on them; 1
// without a mask and at or past j_end.
template <int kN>
struct MaskBytes {
  uint8_t b[kN];
  template <typename KeyOf>
  __device__ __forceinline__ void load(const uint8_t* kvm, int c0, int j_end, KeyOf key_of) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int col = c0 + key_of(n);
      b[n] = kvm != nullptr && col < j_end ? kvm[col] : (uint8_t)1;
    }
  }
};

// The score of key `col` from its dot product: scaled, soft-clamped, the
// mask value where masked (keep 0), -inf (weight exactly zero) at or past
// j_end.
__device__ __forceinline__ float decode_score(const Params& p, uint8_t keep, int col, int j_end,
                                              float dot) {
  if (col >= j_end) return -INFINITY;
  float s = dot * p.scale;
  if (p.softclamp > 0.f) s = p.softclamp * tanhf(s / p.softclamp);
  return keep != 0 ? s : kMaskValue;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, rows padded to 16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The online-softmax state of one warp's 16 rows in mma fragment layout:
// o[nd][2r + c] is row g + 8r, column nd * 8 + 2t + c; m[r] is the same on
// a row's 4 threads, l[r] this thread's share of the row sum.
struct StateBf16 {
  float o[kD / 8][4];
  float m[2], l[2];
};

// Keys of a lane's score fragments: (group j, column c) is byte 2j + c.
struct KeyBf16 {
  int base;  // this warp's first key in the tile plus 2t
  __device__ __forceinline__ int operator()(int n) const { return base + (n >> 1) * 8 + (n & 1); }
};
using MaskBf16 = MaskBytes<4>;

__device__ __forceinline__ void tile_bf16(const Params& p, const MaskBf16& mk,
                                          const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                          const uint32_t (&qf)[kD / 16][4], int c0, int j_end,
                                          StateBf16& st) {
  constexpr int kStride = Geometry<__nv_bfloat16>::kStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = warp * 16;  // this warp's keys in the tile

  float s[2][4];  // 16 rows x 16 keys
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const __nv_bfloat16* kb = Ks + (key0 + j * 8 + g) * kStride + kk * 16 + t * 2;
      const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kb),
                              *reinterpret_cast<const uint32_t*>(kb + 8)};
      mma_16816(s[j], qf[kk], bf);
    }
  }
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = decode_score(p, mk.b[2 * j + (e & 1)], c0 + key0 + j * 8 + t * 2 + (e & 1),
                             j_end, s[j][e]);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 16 scores sit on 4 threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float alpha = exp_nat(st.m[r] - mx[r]);
    st.m[r] = mx[r];
    st.l[r] *= alpha;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      st.o[nd][2 * r] *= alpha;
      st.o[nd][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp_nat(s[j][e] - st.m[e >> 1]);
      st.l[e >> 1] += s[j][e];
    }
  }
  // o += p v: the two key groups' scores form one A fragment; V's B
  // fragments, two column groups at a time, by ldmatrix.trans
  const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                         pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: this lane's matrix and row
#pragma unroll
  for (int nd = 0; nd < kD / 8; nd += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, Vs + (key0 + (mi & 1) * 8 + mr) * kStride + (nd + (mi >> 1)) * 8);
    mma_16816(st.o[nd], a, b);
    mma_16816(st.o[nd + 1], a, b + 2);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA.  Lane (key kl = lane % 16, half h = lane / 16) scores
// its key for rows 2i + h; m[i], l[i] are those rows' state, the same on the
// 16 lanes of a half; for PV each lane owns columns 2 * lane, 2 * lane + 1 of
// all 16 rows.
// ---------------------------------------------------------------------------

struct StateF32 {
  float acc[kRows][2];
  float m[kRows / 2], l[kRows / 2];
};

struct KeyF32 {
  int key;  // this lane's key in the tile
  __device__ __forceinline__ int operator()(int) const { return key; }
};
using MaskF32 = MaskBytes<1>;

__device__ __forceinline__ void tile_f32(const Params& p, const MaskF32& mk, const float* Qs,
                                         const float* Ks, const float* Vs, int c0, int j_end,
                                         StateF32& st) {
  constexpr int kStride = Geometry<float>::kStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = lane % 16, h = lane / 16;
  const int key0 = warp * 16;
  const float4* kr = reinterpret_cast<const float4*>(Ks + (key0 + kl) * kStride);

  float s[kRows / 2];
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 kx = kr[d4];
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const float4 qx = reinterpret_cast<const float4*>(Qs + (2 * i + h) * kStride)[d4];
      s[i] = fmaf(qx.x, kx.x, s[i]);
      s[i] = fmaf(qx.y, kx.y, s[i]);
      s[i] = fmaf(qx.z, kx.z, s[i]);
      s[i] = fmaf(qx.w, kx.w, s[i]);
    }
  }
  float alpha[kRows / 2];
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    s[i] = decode_score(p, mk.b[0], c0 + key0 + kl, j_end, s[i]);
    float mx = s[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mx = fmaxf(mx, st.m[i]);
    alpha[i] = exp_nat(st.m[i] - mx);
    st.m[i] = mx;
    s[i] = exp_nat(s[i] - mx);
    float sum = s[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    st.l[i] = st.l[i] * alpha[i] + sum;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float a = __shfl_sync(0xffffffffu, alpha[r / 2], 16 * (r % 2));
    st.acc[r][0] *= a;
    st.acc[r][1] *= a;
  }
#pragma unroll 4
  for (int jj = 0; jj < 16; ++jj) {
    const float2 vx = *reinterpret_cast<const float2*>(Vs + (key0 + jj) * kStride + 2 * lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pj = __shfl_sync(0xffffffffu, s[r / 2], jj + 16 * (r % 2));
      st.acc[r][0] = fmaf(pj, vx.x, st.acc[r][0]);
      st.acc[r][1] = fmaf(pj, vx.y, st.acc[r][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel: one range of keys a block; the last block of a (kv head, row
// group) to finish merges the ranges
// ---------------------------------------------------------------------------

// Merges the S ranges' (acc, m, l) of rows [r0, r0 + rows) of kv head bh
// from scratch as one online-softmax sweep would, and writes the result;
// row_max is shared memory for kRows floats.
template <typename T>
__device__ __forceinline__ void merge_ranges(const Params& p, int bh, int r0, int rows,
                                             float* row_max) {
  const size_t step = (size_t)p.R * (kD + 2);  // one range to the next
  const float* part0 = p.scratch + ((size_t)bh * p.S * p.R + r0) * (kD + 2);
  static_assert(kThreads == 8 * kRows, "8 threads a row");
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
      static_cast<T*>(p.out)[at * kD + d] = T(acc / l_safe);
      if (d == 0) p.lse[at] = mx + logf(l_safe);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Params p) {
  using G = Geometry<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);               // kStages x (K tile, V tile)
  T* Qs = ring + 2 * G::kStages * G::kTileElems;      // kRows x kStride

  const int bh = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * kRows;
  const int j_begin = min(p.Nk, split * p.per_split);
  const int j_end = min(p.Nk, j_begin + p.per_split);
  const int n_tiles = (j_end - j_begin + kTile - 1) / kTile;
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.Nk * kD;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.Nk * kD;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)(bh / p.Hk) * p.Nk : nullptr;

  // the block's rows of q (zeros past R), then the first kStages - 1 tiles
  const T* q = static_cast<const T*>(p.q) + ((size_t)bh * p.R + r0) * kD;
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    Qs[r * G::kStride + c] = r0 + r < p.R ? q[(size_t)r * kD + c] : T(0.f);
  }
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_tiles)
      load_stage<T>(ring + 2 * s * G::kTileElems, ring + (2 * s + 1) * G::kTileElems, k, v,
                    j_begin + s * kTile, j_end);
    cp_async_commit();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  StateBf16 sb;
  StateF32 sf;
  uint32_t qf[kD / 16][4];
  if constexpr (sizeof(T) == 2) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const T* base = Qs + g * G::kStride + kk * 16 + t * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * G::kStride);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * G::kStride + 8);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sb.m[r] = kMaskValue;
      sb.l[r] = 0.f;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) sb.o[nd][2 * r] = sb.o[nd][2 * r + 1] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      sf.m[i] = kMaskValue;
      sf.l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) sf.acc[r][0] = sf.acc[r][1] = 0.f;
  }

  // the key-mask bytes of tile i + 1 load while tile i is consumed
  const auto key_of = [&] {
    if constexpr (sizeof(T) == 2) return KeyBf16{warp * 16 + (lane % 4) * 2};
    else return KeyF32{warp * 16 + lane % 16};
  }();
  MaskBytes<sizeof(T) == 2 ? 4 : 1> mk, mk_next;
  mk_next.load(kvm, j_begin, j_end, key_of);
  for (int i = 0; i < n_tiles; ++i) {
    mk = mk_next;
    if (i + 1 < n_tiles) mk_next.load(kvm, j_begin + (i + 1) * kTile, j_end, key_of);
    cp_async_wait<G::kStages - 2>();  // tile i has landed (this thread's part)
    __syncthreads();                   // ... and everyone's; slot i - 1 is free
    const int next = i + G::kStages - 1;
    if (next < n_tiles) {
      const int slot = next % G::kStages;
      load_stage<T>(ring + 2 * slot * G::kTileElems, ring + (2 * slot + 1) * G::kTileElems, k,
                    v, j_begin + next * kTile, j_end);
    }
    cp_async_commit();
    const int slot = i % G::kStages;
    const T* Ks = ring + 2 * slot * G::kTileElems;
    const T* Vs = ring + (2 * slot + 1) * G::kTileElems;
    if constexpr (sizeof(T) == 2)
      tile_bf16(p, mk, Ks, Vs, qf, j_begin + i * kTile, j_end, sb);
    else
      tile_f32(p, mk, Qs, Ks, Vs, j_begin + i * kTile, j_end, sf);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states merge through it

  float* Ow = reinterpret_cast<float*>(smem);  // kWarps x kRows x kD
  float* Mw = Ow + kWarps * kRows * kD;        // kWarps x kRows
  float* Lw = Mw + kWarps * kRows;             // kWarps x kRows
  float* ow = Ow + warp * kRows * kD;
  if constexpr (sizeof(T) == 2) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sb.l[r] += __shfl_xor_sync(0xffffffffu, sb.l[r], 1);
      sb.l[r] += __shfl_xor_sync(0xffffffffu, sb.l[r], 2);
      const int row = g + 8 * r;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd)
        *reinterpret_cast<float2*>(ow + row * kD + nd * 8 + t * 2) =
            make_float2(sb.o[nd][2 * r], sb.o[nd][2 * r + 1]);
      if (t == 0) {
        Mw[warp * kRows + row] = sb.m[r];
        Lw[warp * kRows + row] = sb.l[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float2*>(ow + r * kD + 2 * lane) = make_float2(sf.acc[r][0], sf.acc[r][1]);
    if (lane % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        Mw[warp * kRows + 2 * i + lane / 16] = sf.m[i];
        Lw[warp * kRows + 2 * i + lane / 16] = sf.l[i];
      }
    }
  }
  __syncthreads();

  const int rows = min(kRows, p.R - r0);
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int row = i / kD, d = i % kD;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Mw[w * kRows + row]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp_nat(Mw[w * kRows + row] - mx);
      acc = fmaf(Ow[(w * kRows + row) * kD + d], wt, acc);
      l = fmaf(Lw[w * kRows + row], wt, l);
    }
    float* out = p.scratch + (((size_t)bh * p.S + split) * p.R + r0 + row) * (kD + 2);
    out[d] = acc;
    if (d == 0) {
      out[kD] = mx;
      out[kD + 1] = l;
    }
  }

  // the last of the S blocks of this (kv head, row group) merges the ranges
  // (the pattern of CUDA's threadFenceReduction sample) and sets the
  // counter back to 0 for the next launch
  __shared__ bool last;
  __shared__ float row_max[kRows];
  __threadfence();  // this range's (acc, m, l) is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.counters + (size_t)bh * gridDim.z + blockIdx.z;
    last = atomicAdd(counter, 1) == p.S - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) merge_ranges<T>(p, bh, r0, rows, row_max);
}

constexpr int kMaxDevices = 64;

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  constexpr int bytes = Geometry<T>::kBytes;
  static_assert(bytes >= (kWarps * kRows * (kD + 2)) * 4, "the merge reuses the ring");
  // the shared-memory limit, raised once per device (a decode is host-bound
  // at small caches: no per-call attribute call)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid(p.B * p.Hk, p.S, (p.R + kRows - 1) / kRows);
  decode_split_kernel<T><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).  Allocates nothing: the caller
// passes `scratch` of B*Hk*S*R*(D + 2) floats and `counters` of
// B*Hk*ceil(R / 16) int32 zeros, which the launch leaves at zero (launches
// that share counters must be ordered, as on one stream).  Either (out,
// lse) or (acc, m, l) is set, the other all null.  The S ranges hold
// ceil(ceil(Nk / S) / 64) * 64 keys each (the last ones may be short or
// empty).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* kv_mask,
                            void* out, void* lse, void* acc, void* m, void* l, void* scratch,
                            void* counters, int B, int Hk, int R, int Nk, int D, int S,
                            int is_bf16, float scale, float softclamp, void* stream) {
  if (D != kD || B <= 0 || Hk <= 0 || R <= 0 || Nk <= 0 || S <= 0 || S > 65535 ||
      (R + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const bool partials = acc != nullptr;
  if ((m != nullptr) != partials || (l != nullptr) != partials ||
      (out != nullptr) == partials || (lse != nullptr) == partials)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
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
  p.scale = scale;
  p.softclamp = softclamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
