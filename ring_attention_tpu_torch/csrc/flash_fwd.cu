// Forward flash-attention sweep for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_flash.py::_flash_fwd_call (the
// pl.pallas_call at :1174; kernel bodies _fwd_kernel :669, _fwd_tile :823,
// _online_update :776, _fwd_write :645, _tile_keep :240, with its runtime
// segment ids qseg_ref/kseg_ref) in its three modes, one kernel whose
// pointers say which:
//   * fused: normalized `out` in q's dtype plus `lse` in float32;
//   * partials: the raw online-softmax state (acc, m, l) in float32, the
//     mergeable state of one ring hop (`_fwd_write` with fused=False);
//   * resume: either of the above, starting from a carried (acc, m, l)
//     instead of the empty state (the resume load at :732-745).
// A carry crosses hops in natural units, as on the TPU: m is the running
// row max of the scaled scores, out = acc / l, lse = m + log l.  With no
// carry m starts at the finite mask value, so a seed's partials equal the
// empty state merged with the span.  The int8 mode of that launch is not
// ported here.
//
// What it computes, for q (B, H, Nq, D) and k, v (B, Hk, Nk, D), contiguous:
//   s    = scale * q . k, then softclamp c * tanh(s / c) when c > 0;
//   keep = (!causal || (j - i <= hi && (!windowed || j - i >= lo)))
//          && (kv_mask == null || kv_mask[b, j])
//          && (q_seg == null || q_seg[b, i] == kv_seg[b, j]);
//   masked scores take the FINITE mask value -0.5 * f32 max, so a row whose
//   keys are all masked averages V over all Nk keys (dense-oracle semantics);
//   out  = acc / max(l, 1e-10), lse = m + log(max(l, 1e-10)), with the
//   online-softmax state (acc, m, l) in f32.
// A resumed block reads its rows of the carry before the first barrier and
// writes its rows of the partials after it, so the partials may overwrite
// the carry they resume (the ring resumes in place).
// Query head h reads kv head h / (H / Hk) by index (GQA without a repeat).
// Ragged Nq and Nk are masked here: keys past Nk weigh exactly zero.
//
// What bounds it on an H100: the causal forward at long sequence does about
// Nk / 4 operations per byte it must move (d = 64), far above the card's
// ~295 bf16 operations per byte, so it is bound by tensor-core operations.
// Decode (a handful of folded query rows against a long cache) does about
// one operation per cache byte and is bound by device-memory bytes.  A ring
// hop's carry adds (D + 2) f32 per query row, read and written: 0.28 GB for
// 65,536 rows of 8 heads, 0.08 ms at 3.35 TB/s beside the 8.9 ms operation
// bound of a full 65,536-key hop.
//
// Design (right and simple first; the tile body is flash_tile.cuh's, shared
// with flash_ring.cu):
//   * one thread block per (64-row Q tile, b*h); blocks run heaviest causal
//     rows first;
//   * bf16: 4 warps, each owns 16 query rows.  QK^T and PV run on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate); the score tile, p and the
//     output accumulator stay in registers and never touch shared or device
//     memory.  p is rounded to bf16 for the PV product, as the TPU kernel
//     does (p.astype(v.dtype)), while l sums the f32 p;
//   * f32: 64 threads, one query row each, plain FMA on CUDA cores (exact
//     f32, so the card can be held tightly to the CPU);
//   * the block computes its own KV-tile range from (lo, hi) and skips tiles
//     outside the band: the counterpart of the TPU compact band grid and its
//     scalar-prefetched tables, which are therefore not needed.  A block
//     holding a row with an empty band visits every tile, so such a row still
//     averages V over all keys;
//   * packed sequences (q_seg, kv_seg int32 document ids) run a second
//     instantiation of each kernel (kSeg): the document test sits in the
//     score beside the key mask; the block's query ids and each tile's key
//     ids sit in shared memory (the key ids loaded with K and V) and are
//     read there score by score, so they take no registers through the
//     products.  It visits the same tiles as the unsegmented kernel (no
//     tile is skipped on ids, as the TPU kernel skips none on runtime ids),
//     and the unsegmented kernels compile as before.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation and a
// split-KV decode (the decode grid is only b*hk blocks wide).

#include "flash_tile.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // (B, Nk) or null
  void* out;               // (B, H, Nq, D) in q's dtype; null: partials
  float* lse;              // (B, H, Nq); null: partials
  int B, H, Hk, Nq, Nk;
  float scale;
  int causal, hi, windowed, lo;
  float softclamp;  // 0 = off
};

// The ring modes' pointers, a kernel argument of their own, so that Params
// stays as the fused mode had it: as six more fields of Params they slowed
// the fused sweep on an H100 at an unchanged 128 registers.
struct RingIO {
  const float* c_acc;  // carry (B, H, Nq, D), or null: no carry
  const float* c_m;    // carry (B, H, Nq)
  const float* c_l;    // carry (B, H, Nq)
  float* p_acc;        // partials (B, H, Nq, D), or null: fused
  float* p_m;          // partials (B, H, Nq)
  float* p_l;          // partials (B, H, Nq)
};

// Packed sequences: (B, Nq) and (B, Nk) int32 document ids, read by the
// kSeg instantiations only.
struct Segs {
  const int* q;
  const int* kv;
};

// The launch's band in flash_tile.cuh's form: a side that causal or windowed
// leaves open takes a bound no (row, col) pair crosses.
__device__ __forceinline__ Band launch_band(const Params& p, const uint8_t* kvm) {
  return Band{p.causal ? p.hi : p.Nk, p.causal && p.windowed ? p.lo : -p.Nq, p.Nk, kvm,
              p.scale, p.softclamp};
}

// (128, 4): four blocks per SM need at most 128 registers a thread; at 130
// to 132 only three fit and the sweep runs ~50% slower.
template <int D, bool kSeg>
__global__ void __launch_bounds__(128, 4)
    flash_fwd_bf16_kernel(const Params p, const RingIO io, const Segs sg) {
  constexpr int kStride = D + 8;  // staggers shared-memory banks
  __shared__ __align__(16) __nv_bfloat16 Qs[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * kStride];
  __shared__ int Ids[kSeg ? kBlockM + kBlockN : 1];  // SegTile's

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.Nq * D;
  const size_t kv_off = (size_t)(b * p.Hk + kh) * p.Nk * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group id and thread in group
  const int row_a = r0 + warp * 16 + g;  // global row of fragment halves 0, 1
  const int row_b = row_a + 8;           // and of halves 2, 3
  const SegTile st{kSeg ? sg.kv + (size_t)b * p.Nk : nullptr, kSeg ? Ids : nullptr};

  // the online-softmax state in fragment layout (flash_tile.cuh)
  float o[D / 8][4];
  float m_r[2], l_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    const bool resume = io.c_acc != nullptr && row < p.Nq;
    const size_t idx = (size_t)bh * p.Nq + row;
    m_r[r] = resume ? io.c_m[idx] : kMaskValue;  // the same on all 4 threads
    // a row's sum is split over its 4 threads: the carry seeds one of them
    l_r[r] = resume && t == 0 ? io.c_l[idx] : 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      float2 a = make_float2(0.f, 0.f);
      if (resume)
        a = *reinterpret_cast<const float2*>(io.c_acc + idx * D + nd * 8 + t * 2);
      o[nd][2 * r] = a.x;
      o[nd][2 * r + 1] = a.y;
    }
  }

  load_tile_bf16<D>(Qs, q, r0, p.Nq);
  if constexpr (kSeg) {
    for (int i = threadIdx.x; i < kBlockM; i += blockDim.x)
      Ids[i] = r0 + i < p.Nq ? sg.q[(size_t)b * p.Nq + r0 + i] : 0;
  }
  __syncthreads();  // also orders every carry read before any write below
  uint32_t qf[D / 16][4];
  load_q_frags<D>(Qs, qf);

  const Band bd = launch_band(p, kvm);
  int t_begin, t_end;
  band_tiles(bd, p.Nq, r0, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile)
    bf16_tile<D, kSeg>(Ks, Vs, k, v, bd, tile * kBlockN, qf, o, m_r, l_r, row_a, st);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = r == 0 ? row_a : row_b;
    if (row >= p.Nq) continue;
    const size_t idx = (size_t)bh * p.Nq + row;
    if (io.p_acc != nullptr) {  // the raw state, l reduced above
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(io.p_acc + idx * D + nd * 8 + t * 2) =
            make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
      if (t == 0) {
        io.p_m[idx] = m_r[r];
        io.p_l[idx] = l_r[r];
      }
    } else {
      store_out_bf16<D>(static_cast<__nv_bfloat16*>(p.out), p.lse, idx, o, r, m_r[r],
                        l_r[r]);
    }
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_f32_kernel(const Params p, const RingIO io, const Segs sg) {
  __shared__ __align__(16) float Ks[kBlockN * D];
  __shared__ __align__(16) float Vs[kBlockN * D];
  __shared__ int Ids[kSeg ? kBlockM + kBlockN : 1];  // SegTile's

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.Nq * D;
  const size_t kv_off = (size_t)(b * p.Hk + kh) * p.Nk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;
  const int row = r0 + threadIdx.x;
  const SegTile st{kSeg ? sg.kv + (size_t)b * p.Nk : nullptr, kSeg ? Ids : nullptr};
  if constexpr (kSeg) Ids[threadIdx.x] = row < p.Nq ? sg.q[(size_t)b * p.Nq + row] : 0;

  float qv[D], acc[D];
  load_q_row_f32<D>(q, row, p.Nq, qv, acc);
  float m = kMaskValue, l = 0.f;
  const size_t idx = (size_t)bh * p.Nq + row;
  if (io.c_acc != nullptr && row < p.Nq) {  // resume this thread's own row
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(io.c_acc + idx * D + d);
      acc[d] = a.x; acc[d + 1] = a.y; acc[d + 2] = a.z; acc[d + 3] = a.w;
    }
    m = io.c_m[idx];
    l = io.c_l[idx];
  }

  const Band bd = launch_band(p, kvm);
  int t_begin, t_end;
  band_tiles(bd, p.Nq, r0, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile)
    f32_tile<D, kSeg>(Ks, Vs, k, v, bd, tile * kBlockN, qv, acc, m, l, row, st);

  if (row >= p.Nq) return;
  if (io.p_acc != nullptr) {  // the raw state
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(io.p_acc + idx * D + d) =
          make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
    io.p_m[idx] = m;
    io.p_l[idx] = l;
  } else {
    store_out_f32<D>(static_cast<float*>(p.out), p.lse, idx, acc, m, l);
  }
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).  Allocates nothing: the caller
// passes contiguous tensors and preallocated outputs.  The mode follows the
// pointers: (out, lse) or (p_acc, p_m, p_l) is written, and (c_acc, c_m,
// c_l), when given, is resumed; each triple is all null or all set.
// (q_seg, kv_seg), both set, runs the segmented kernel; both null, the
// unsegmented one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* out, void* lse,
                         const void* c_acc, const void* c_m, const void* c_l,
                         void* p_acc, void* p_m, void* p_l, int B, int H,
                         int Hk, int Nq, int Nk, int D, int is_bf16, float scale,
                         int causal, int hi, int windowed, int lo,
                         float softclamp, const void* q_seg, const void* kv_seg,
                         void* stream) {
  if (D != 64 || H % Hk != 0 || Nq <= 0 || Nk <= 0 || (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool carry = c_acc != nullptr;
  const bool partials = p_acc != nullptr;
  if ((c_m != nullptr) != carry || (c_l != nullptr) != carry ||
      (p_m != nullptr) != partials || (p_l != nullptr) != partials ||
      (out != nullptr) == partials || (lse != nullptr) == partials)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.Nq = Nq;
  p.Nk = Nk;
  p.scale = scale;
  p.causal = causal;
  p.hi = hi;
  p.windowed = windowed;
  p.lo = lo;
  p.softclamp = softclamp;
  const RingIO io{static_cast<const float*>(c_acc), static_cast<const float*>(c_m),
                  static_cast<const float*>(c_l), static_cast<float*>(p_acc),
                  static_cast<float*>(p_m), static_cast<float*>(p_l)};
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg)};
  const dim3 grid((Nq + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && q_seg != nullptr)
    flash_fwd_bf16_kernel<64, true><<<grid, 128, 0, s>>>(p, io, sg);
  else if (is_bf16)
    flash_fwd_bf16_kernel<64, false><<<grid, 128, 0, s>>>(p, io, sg);
  else if (q_seg != nullptr)
    flash_fwd_f32_kernel<64, true><<<grid, kBlockM, 0, s>>>(p, io, sg);
  else
    flash_fwd_f32_kernel<64, false><<<grid, kBlockM, 0, s>>>(p, io, sg);
  return (int)cudaGetLastError();
}
