// Fused ring forward, local tier, for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_ring.py::fused_ring_local (the
// pl.pallas_call at :341; kernel body _fused_local_kernel :116) for float
// operands, with its segment ids (q_segment_ids, kv_segment_ids :213, the
// keep test :304-309), and with its int8 feed (kv_quantized :214,
// :257-269; the int8 kernels at the end of this file).
//
// What it computes, for q (B, H, N, D) of one ring rank and the gathered
// k_all, v_all (B, Hk, Ntot, D), rank-major (rank o's block is rows
// [o * N, (o + 1) * N)), contiguous:
//   for hop = 0 .. hops - 1 with works[hop] != 0, the keys of rank
//   origins[hop] in local coordinates j in [0, N):
//     s    = scale * q . k, then softclamp c * tanh(s / c) when c > 0;
//     keep = los[hop] <= j - i <= his[hop] && (kv_mask == null ||
//            kv_mask[b, origins[hop] * N + j]) && (q_seg == null ||
//            q_seg[b, i] == kv_seg[b, origins[hop] * N + j]);
//     masked scores take the FINITE mask value -0.5 * f32 max;
//   the online-softmax state (acc, m, l) in f32 carries across the hops
//   in registers, and the block writes out = acc / max(l, 1e-10) in q's
//   dtype and lse = m + log(max(l, 1e-10)) in f32 once, after the last hop.
// Unbanded hops carry the sentinels his = N, los = -N, vacuous over
// j - i in (-N, N).
//
// It is the port's hop chain (parallel/ring.py::_ring_fwd_cuda on
// csrc/flash_fwd.cu: seed partials, resumes, fused write from the carry)
// in one launch, and it visits exactly the chain's (hop, tile) set: a hop
// whose works flag is 0 is skipped, and within a hop each warpgroup takes
// the forward kernel's tile range for its 64 rows (band_tiles in
// flash_tile.cuh) from the hop's band.  A warpgroup holding a row with an
// empty band visits every tile of that hop, so a row that sees no live key
// in the whole walk (an all-False key-mask row, a band edge) averages V
// over the same keys as the chain.
//
// What bounds it on an H100: rank 3 of a causal ring of 4 at 262,144
// tokens (N 65,536, h 8, d 64) does 3.08e13 operations on 0.27 GB of
// inputs: far above the card's ~295 bf16 operations per byte, so it is
// bound by tensor-core operations (31.1 ms at 989 TFLOP/s).  The hop chain
// it replaces also reads and writes the f32 carry (D + 2 floats a row) at
// every hop boundary, 0.1 ms at 3.35 TB/s, and launches once a hop;
// keeping the carry in registers saves that, not more: the chain's B1 and
// this kernel run the same sweep.
//
// Design:
//   * bf16: B1's sweep (flash_sweep.cuh, the bf16 kernel of flash_fwd.cu):
//     one block of 256 threads per (128-row Q tile, b*h) of the rank,
//     heaviest causal rows first, __launch_bounds__(256, 1) and B1's
//     dynamic shared memory (kFwdSmem).  Each warpgroup keeps its 64 rows
//     of Q resident and walks the live hops, each over the origin's block
//     of the gathered span: its tiles through its own cp.async ring, S = Q
//     K^T and P V on wgmma, the online softmax in the log2 domain.  At a
//     hop's end the walk drains its last P V; before the next live hop the
//     state goes through sweep_hop_boundary, in registers, which does what
//     the chain's launch does at its end and the next at its start (l
//     summed over a row's 4 threads and thread 0 seeded with it, m to
//     natural units and back with the same multiplies), so the output is
//     the chain's bit for bit.  The soft clamp is a template switch, as in
//     B1;
//   * f32: 64 threads, one query row each, plain FMA (exact f32), through
//     flash_tile.cuh's f32 tile body, as B1's f32 kernel;
//   * packed sequences (q_seg (B, N) of the rank's rows, kv_seg (B, Ntot)
//     gathered with k and v) run a second instantiation of each kernel
//     (kSeg), B1's segmented sweep walked hop by hop: each thread's rows'
//     ids in registers, each tile's key ids in its stage beside the key
//     mask (bf16), or in shared memory (f32); the unsegmented kernels
//     compile as before.  A hop whose ids share no document with the rows
//     is skipped by the host, which clears its works flag as the scan ring
//     skips it, so that the visit set stays the segmented chain's;
//   * the hop tables are four int32 device arrays read by every thread;
//   * offsets into the gathered span are 64-bit: at 262,144 tokens, hk 8
//     and d 64 one batch row of k_all holds 1.3e8 elements.
//   * int8 (flash_ring_q8, the JAX kv_quantized feed): q8 (B, H, N, D)
//     with its row scales, and the gathered span as B4 reads it: k8 (B, Hk,
//     Ntot, D) and its row scales, V^T per quantization block of Bk keys
//     (B, Hk, Ntot / Bk, D, Bp) and the block scales, Bk dividing N, so
//     that no block straddles two ranks.  B4's sweep (flash_sweep_q8.cuh)
//     walked hop by hop over the origin's keys and blocks, B4's block of
//     256 threads and its dynamic shared memory; between two live hops
//     q8::hop_boundary does what the chain's partials store and the next
//     launch's load do, so the output is the int8 hop chain's (B4 fed the
//     same feed, impl="cuda") bit for bit.  With ids it runs B4's
//     segmented sweep (kSeg), the keys' ids read from kv_seg.
// Not yet: TMA and warp specialisation, as in B1.

#include "flash_sweep.cuh"
#include "flash_sweep_q8.cuh"

namespace {

struct Params {
  const void* q;           // (B, H, N, D)
  const void* k;           // (B, Hk, Ntot, D), rank-major
  const void* v;           // (B, Hk, Ntot, D)
  const uint8_t* kv_mask;  // (B, Ntot) or null
  const int* origins;      // (hops,) rank whose block each hop reads
  const int* his;          // (hops,) band upper offset, N: unbanded
  const int* los;          // (hops,) band lower offset, -N: unbounded
  const int* works;        // (hops,) 0: skip the hop
  void* out;               // (B, H, N, D) in q's dtype
  float* lse;              // (B, H, N)
  int B, H, Hk, N, Ntot, hops;
  float scale;
  float softclamp;  // 0 = off
};

// Packed sequences: (B, N) int32 document ids of the rank's rows and (B,
// Ntot) of the gathered keys, read by the kSeg instantiations only.
struct Segs {
  const int* q;
  const int* kv;
};

// Hop `hop`'s band in flash_tile.cuh's form, in the hop's local coordinates;
// kvm points at the hop's block of the key mask.
__device__ __forceinline__ Band hop_band(const Params& p, int hop, const uint8_t* kvm) {
  return Band{p.his[hop], p.los[hop], p.N, kvm, p.scale, p.softclamp};
}

template <bool kSeg, bool kClamp>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_ring_bf16_kernel(const Params p, const Segs sg) {
  extern __shared__ unsigned char ring_smem[];
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(ring_smem) + 1023u) & ~1023u;
  const unsigned char* base_ptr =
      ring_smem + (base - (uint32_t)__cvta_generic_to_shared(ring_smem));

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.N * 64;
  const size_t kv_off = ((size_t)b * p.Hk + kh) * (size_t)p.Ntot * 64;

  const SweepWg w = sweep_wg(base, base_ptr, r0);
  const float mask2 = __fmul_rn(kMaskValue, kLog2e);
  // the online-softmax state, empty: the chain's seed launch; (kSeg) the
  // ids of this thread's rows
  float o[8][4], m2[2], l[2];
  int qs_r[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sweep_load_row(nullptr, nullptr, nullptr, 0, false, r, mask2, o, m2, l);
    const int row = w.row_a + 8 * r;
    if constexpr (kSeg) qs_r[r] = row < p.N ? sg.q[(size_t)b * p.N + row] : 0;
  }
  sweep_load_q(w, q, p.N);
  // (kSeg) whether every row of the warpgroup before N holds one document,
  // q_doc, as B1's segmented sweep takes it
  int q_doc = 0;
  bool q_one_doc = false;
  if constexpr (kSeg) {
    const int* qseg = sg.q + (size_t)b * p.N;
    q_doc = w.rw < p.N ? qseg[w.rw] : 0;
    const int lane = threadIdx.x % 32;
    q_one_doc = __all_sync(0xffffffffu,
                           (w.rw + lane >= p.N || qseg[w.rw + lane] == q_doc) &&
                               (w.rw + lane + 32 >= p.N || qseg[w.rw + lane + 32] == q_doc));
  }

  bool first = true;
  for (int hop = 0; hop < p.hops; ++hop) {
    if (p.works[hop] == 0) continue;  // the chain launches nothing here
    // between two live hops: the chain's store and the next launch's load
    if (!first) sweep_hop_boundary(m2, l, mask2);
    first = false;
    const size_t span = (size_t)p.origins[hop] * p.N;  // the origin's first key
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off + span * 64;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off + span * 64;
    const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Ntot + span : nullptr;
    const int* kseg = kSeg ? sg.kv + (size_t)b * p.Ntot + span : nullptr;
    const Band bd = hop_band(p, hop, kvm);
    int t_begin, t_end;
    wg_band_tiles(bd, p.N, w.rw, &t_begin, &t_end);
    const SweepRange rg{bd, k, v, kseg, t_begin, t_end - t_begin};
    sweep_issue_ahead(rg, w);
    SWEEP_WALK(kSeg, kClamp, rg, w, kvm == nullptr && (!kSeg || q_one_doc), q_one_doc, q_doc,
               qs_r, mask2, o, m2, l);
    sweep_wg_sync(w);  // the ring is free for the next hop's tiles
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sweep_sum_row(l[r]);
    const int row = w.row_a + 8 * r;
    if (row >= p.N) continue;
    store_out_bf16<64>(static_cast<__nv_bfloat16*>(p.out), p.lse, (size_t)bh * p.N + row, o,
                       r, sweep_m_nat(m2[r], mask2), l[r]);
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kBlockM)
    flash_ring_f32_kernel(const Params p, const Segs sg) {
  __shared__ __align__(16) float Ks[kBlockN * D];
  __shared__ __align__(16) float Vs[kBlockN * D];
  __shared__ int Ids[kSeg ? kBlockM + kBlockN : 1];  // SegTile's

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.N * D;
  const size_t kv_off = ((size_t)b * p.Hk + kh) * (size_t)p.Ntot * D;
  const int row = r0 + threadIdx.x;
  if constexpr (kSeg) Ids[threadIdx.x] = row < p.N ? sg.q[(size_t)b * p.N + row] : 0;

  float qv[D], acc[D];
  load_q_row_f32<D>(q, row, p.N, qv, acc);
  float m = kMaskValue, l = 0.f;

  for (int hop = 0; hop < p.hops; ++hop) {
    if (p.works[hop] == 0) continue;
    const size_t span = (size_t)p.origins[hop] * p.N;
    const float* k = static_cast<const float*>(p.k) + kv_off + span * D;
    const float* v = static_cast<const float*>(p.v) + kv_off + span * D;
    const uint8_t* kvm =
        p.kv_mask ? p.kv_mask + (size_t)b * p.Ntot + span : nullptr;
    const Band bd = hop_band(p, hop, kvm);
    const SegTile st{kSeg ? sg.kv + (size_t)b * p.Ntot + span : nullptr, kSeg ? Ids : nullptr};
    int t_begin, t_end;
    band_tiles(bd, p.N, r0, &t_begin, &t_end);
    for (int tile = t_begin; tile < t_end; ++tile)
      f32_tile<D, kSeg>(Ks, Vs, k, v, bd, tile * kBlockN, qv, acc, m, l, row, st);
  }

  if (row >= p.N) return;
  store_out_f32<D>(static_cast<float*>(p.out), p.lse, (size_t)bh * p.N + row, acc, m, l);
}

// The int8 kernels' inputs: q8 and its row scales qs; the gathered span's
// k8 and row scales ks, V^T per block vt and block scales vs (Bk keys a
// block, Bp = Bk rounded up to 64), in rank-major order.
struct Q8Params {
  const int8_t* q8;        // (B, H, N, D)
  const float* qs;         // (B, H, N)
  const int8_t* k8;        // (B, Hk, Ntot, D)
  const float* ks;         // (B, Hk, Ntot)
  const int8_t* vt;        // (B, Hk, Ntot / Bk, D, Bp)
  const float* vs;         // (B, Hk, Ntot / Bk)
  const uint8_t* kv_mask;  // (B, Ntot) or null
  const int* origins;
  const int* his;
  const int* los;
  const int* works;
  void* out;  // (B, H, N, D) bf16 or f32
  float* lse;
  int B, H, Hk, N, Ntot, hops, Bk, Bp, out_bf16;
  float scale;
  float softclamp;  // 0 = off
};

template <bool kSeg, bool kClamp>
__global__ void __launch_bounds__(q8::kThreads, 1)
    flash_ring_q8_kernel(const Q8Params p, const Segs sg) {
  extern __shared__ unsigned char ring_q8_smem[];
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(ring_q8_smem);
  const uint32_t base = (smem0 + 1023u) & ~1023u;

  const int r0 = (gridDim.x - 1 - blockIdx.x) * q8::kRows;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const size_t kv_head = (size_t)b * p.Hk + kh;
  const int n_blk = p.Ntot / p.Bk;
  const q8::Wg w = q8::wg_of(base, ring_q8_smem + (base - smem0), r0);

  // the empty state (the chain's seed launch), the rows' scales and ids
  float o[8][4], m_r[2], l_r[2], rs[2];
  int qid[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w.row_a + r * 8;
    const size_t idx = (size_t)bh * p.N + row;
    q8::load_row(nullptr, nullptr, nullptr, 0, false, r, o, m_r, l_r);
    rs[r] = row < p.N ? p.qs[idx] * p.scale : 0.f;
    if constexpr (kSeg) qid[r] = row < p.N ? sg.q[(size_t)b * p.N + row] : 0;
  }
  q8::load_q(w, p.q8 + (size_t)bh * p.N * q8::kD, p.N);

  bool first = true;
  for (int hop = 0; hop < p.hops; ++hop) {
    if (p.works[hop] == 0) continue;  // the chain launches nothing here
    // between two live hops: the chain's store and the next launch's load
    if (!first) q8::hop_boundary(l_r);
    first = false;
    const size_t span = (size_t)p.origins[hop] * p.N;  // the origin's first key
    const size_t blk0 = span / p.Bk;                    // and its first block
    // the hop's band: sentinels (his = N, los = -N) open a side
    const q8::Span sp{p.k8 + (kv_head * p.Ntot + span) * q8::kD,
                      p.vt + (kv_head * n_blk + blk0) * q8::kD * p.Bp,
                      p.ks + kv_head * p.Ntot + span,
                      p.vs + kv_head * n_blk + blk0,
                      p.kv_mask ? p.kv_mask + (size_t)b * p.Ntot + span : nullptr,
                      kSeg ? sg.kv + (size_t)b * p.Ntot + span : nullptr,
                      p.N, p.N, p.Bk, p.Bp, 1, p.his[hop], 1, p.los[hop], p.softclamp};
    int key_begin = 0, key_end = 0;
    if (w.rw < p.N) q8::key_range(sp, w.rw, &key_begin, &key_end);
    q8::sweep<kClamp, kSeg>(sp, w, key_begin, key_end, rs, qid, o, m_r, l_r);
    q8::wg_sync(w);  // the ring is free for the next hop's tiles
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q8::sum_row(l_r[r]);
    const int row = w.row_a + 8 * r;
    if (row >= p.N) continue;
    q8::store_out(p.out, p.lse, p.out_bf16, (size_t)bh * p.N + row, r, o, m_r[r], l_r[r]);
  }
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).  Allocates nothing: the caller
// passes contiguous tensors, the four int32 hop tables on the device and
// the preallocated out and lse.  Every origin must lie in [0, Ntot / N).
// (q_seg, kv_seg), both set, runs the segmented kernel; both null, the
// unsegmented one.
extern "C" int flash_ring(const void* q, const void* k_all, const void* v_all,
                          const void* kv_mask, const void* origins,
                          const void* his, const void* los, const void* works,
                          int hops, void* out, void* lse, int B, int H, int Hk,
                          int N, int Ntot, int D, int is_bf16, float scale,
                          float softclamp, const void* q_seg, const void* kv_seg,
                          void* stream) {
  if (D != 64 || Hk <= 0 || H % Hk != 0 || N <= 0 || Ntot % N != 0 ||
      hops <= 0 || origins == nullptr || his == nullptr || los == nullptr ||
      works == nullptr || out == nullptr || lse == nullptr ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k_all;
  p.v = v_all;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.origins = static_cast<const int*>(origins);
  p.his = static_cast<const int*>(his);
  p.los = static_cast<const int*>(los);
  p.works = static_cast<const int*>(works);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.N = N;
  p.Ntot = Ntot;
  p.hops = hops;
  p.scale = scale;
  p.softclamp = softclamp;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool clamp = softclamp > 0.f;
    const auto kernel = q_seg != nullptr ? (clamp ? flash_ring_bf16_kernel<true, true>
                                                  : flash_ring_bf16_kernel<true, false>)
                                         : (clamp ? flash_ring_bf16_kernel<false, true>
                                                  : flash_ring_bf16_kernel<false, false>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((N + kFwdRows - 1) / kFwdRows, B * H), kFwdThreads, kFwdSmem, s>>>(p, sg);
  } else {
    const dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    if (q_seg != nullptr)
      flash_ring_f32_kernel<64, true><<<grid, kBlockM, 0, s>>>(p, sg);
    else
      flash_ring_f32_kernel<64, false><<<grid, kBlockM, 0, s>>>(p, sg);
  }
  return (int)cudaGetLastError();
}

// The int8 entry point (the JAX kv_quantized feed), bound with ctypes:
// enqueues one launch of the int8 kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Allocates nothing: q8 and qs are q
// quantized per row, k8, ks, vt, vs the gathered span's feed at block Bk
// (Bk divides N), the hop tables and out and lse as for flash_ring.
// (q_seg, kv_seg), both set, runs the segmented kernel.
extern "C" int flash_ring_q8(const void* q8s, const void* qs, const void* k8, const void* ks,
                             const void* vt, const void* vs, const void* kv_mask,
                             const void* origins, const void* his, const void* los,
                             const void* works, int hops, void* out, void* lse, int B, int H,
                             int Hk, int N, int Ntot, int D, int Bk, int out_bf16, float scale,
                             float softclamp, const void* q_seg, const void* kv_seg,
                             void* stream) {
  if (D != q8::kD || Hk <= 0 || H % Hk != 0 || N <= 0 || Ntot % N != 0 || Bk <= 0 ||
      N % Bk != 0 || hops <= 0 || origins == nullptr || his == nullptr || los == nullptr ||
      works == nullptr || out == nullptr || lse == nullptr ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  Q8Params p;
  p.q8 = static_cast<const int8_t*>(q8s);
  p.qs = static_cast<const float*>(qs);
  p.k8 = static_cast<const int8_t*>(k8);
  p.ks = static_cast<const float*>(ks);
  p.vt = static_cast<const int8_t*>(vt);
  p.vs = static_cast<const float*>(vs);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.origins = static_cast<const int*>(origins);
  p.his = static_cast<const int*>(his);
  p.los = static_cast<const int*>(los);
  p.works = static_cast<const int*>(works);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.N = N;
  p.Ntot = Ntot;
  p.hops = hops;
  p.Bk = Bk;
  p.Bp = (Bk + q8::kTileN - 1) / q8::kTileN * q8::kTileN;
  p.out_bf16 = out_bf16;
  p.scale = scale;
  p.softclamp = softclamp;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg)};
  const bool clamp = softclamp > 0.f;
  const auto kernel = q_seg != nullptr ? (clamp ? flash_ring_q8_kernel<true, true>
                                                : flash_ring_q8_kernel<true, false>)
                                       : (clamp ? flash_ring_q8_kernel<false, true>
                                                : flash_ring_q8_kernel<false, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q8::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + q8::kRows - 1) / q8::kRows, B * H), q8::kThreads, q8::kSmem,
           static_cast<cudaStream_t>(stream)>>>(p, sg);
  return (int)cudaGetLastError();
}
