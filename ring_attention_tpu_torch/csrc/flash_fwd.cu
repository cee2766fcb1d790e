// Forward flash-attention sweep for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_flash.py::_flash_fwd_call (the
// pl.pallas_call at :1174; kernel bodies _fwd_kernel :669, _fwd_tile :823,
// _online_update :776, _fwd_write :645, _tile_keep :240, with its runtime
// segment ids qseg_ref/kseg_ref and its doc_starts tile tables) in its three
// modes, one kernel whose pointers say which:
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
// Design:
//   * bf16, redesigned for Hopper: one block of 256 threads per (128-row Q
//     tile, b*h), heaviest causal rows first.  Two warpgroups own 64 rows
//     each and run independently: each streams the 64-key K and V tiles of
//     its own visit set, with their key-mask bytes and (kSeg) key ids, by
//     cp.async through a ring of 4 stages of its own in dynamic shared
//     memory, two tiles ahead of the products (wgmma.cuh's KV stage), and
//     waits on a named barrier of its own 128 threads.  A block-wide
//     barrier a tile held the two in step, their products and their
//     exponentials at the same time; out of step, one's products overlap
//     the other's softmax.  Q stays resident (128-byte swizzled).
//     S = Q K^T runs on wgmma m64n64k16 with both operands in shared memory
//     (K-major); the online softmax runs in the accumulator registers in
//     the log2 domain (scale * log2 e folded into one multiply, m kept in
//     log2 units inside the kernel and in natural units in the carry: the
//     finite mask value maps to its log2 image and back exactly); p is
//     rounded to bf16 as the A fragments of P V (V read down its rows,
//     MN-major), while l sums the f32 p.  Each step issues its tile's S and
//     the previous tile's P V together: the tensor cores run the P V while
//     the tile's softmax runs beside it.  A P V product accumulates into
//     registers of its own, overwritten by its first wgmma, and is folded
//     into the output accumulator (o = alpha o + P V), which no wgmma
//     writes.  A step runs the keep test only where a score may be masked:
//     at the band's edges, the ragged end of the keys, under a key mask
//     and, kSeg, unless the warpgroup's rows and the tile's keys all hold
//     one document; every other tile takes its scores with no test, the
//     same code instantiated without it.  A kSeg tile whose keys all hold
//     another document than every row (with documents, most causal tiles)
//     takes its update with no test and no exponential: p = 0 for a row
//     that has seen a live key, p = 1 for one that has not, what the test
//     and the online update give (the test on each of their scores made
//     the packed sweep 3x the unpacked one).  The soft clamp is a
//     template switch of the launch, not a flag in the loop;
//   * each warpgroup visits exactly the tiles that band_tiles
//     (flash_tile.cuh) gives its 64 rows, the visit set of the 64-row
//     blocks before this design (a row with no live key averages V over the
//     keys of the tiles it visits), as B7 and B8 do;
//   * the warpgroup's sweep (the carry load, the walk over its tiles, the
//     drain of the last P V, the carry store) is flash_sweep.cuh's, which
//     the fused ring's kernels (flash_ring.cu, B7; flash_ring_remote.cu,
//     B8) walk once per hop, so that they compute this kernel's hop chain
//     bit for bit;
//   * f32: 64 threads, one query row each, plain FMA on CUDA cores (exact
//     f32, so the card can be held tightly to the CPU), through
//     flash_tile.cuh's f32 tile body, shared with B7 and B8;
//   * each block computes its own KV-tile range from (lo, hi) and skips
//     tiles outside the band: the counterpart of the TPU compact band grid
//     and its scalar-prefetched tables, which are therefore not needed;
//   * packed sequences (q_seg, kv_seg int32 document ids) run a second
//     instantiation of each kernel (kSeg): the document test sits in the
//     score beside the key mask; in bf16 each thread's two rows' ids sit in
//     registers and each tile's key ids in its stage.  It visits the same
//     tiles as the unsegmented kernel (no tile is skipped on ids, as the TPU
//     kernel skips none on runtime ids), and the unsegmented kernels compile
//     as before;
//   * a declared packing whose documents start on 64-row boundaries
//     (doc_starts, the TPU kernel's compact tile tables of _band_tables
//     :578) runs a third instantiation (kDocs): every 64 rows then lie in
//     one document, and a small int32 table gives each 64-row block (a bf16
//     warpgroup, an f32 block) the key tiles of its document, which clip
//     the band's range (doc_clip, wgmma.cuh).  Every tile of another
//     document is dropped, not masked; the tiles kept hold keys of the
//     rows' own document only, so the kernel takes no ids and runs the
//     unsegmented tile body.
// Not yet: TMA and warp specialisation (a producer warp, ping-pong of the
// two warpgroups' softmax and products).

#include "flash_sweep.cuh"

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
// kSeg instantiations only; a declared packing's doc-tile table, (ceil(Nq /
// 64), 2) int32, read by the kDocs instantiations only.
struct Segs {
  const int* q;
  const int* kv;
  const int* tiles;
};

// The launch's band in flash_tile.cuh's form: a side that causal or windowed
// leaves open takes a bound no (row, col) pair crosses.
__device__ __forceinline__ Band launch_band(const Params& p, const uint8_t* kvm) {
  return Band{p.causal ? p.hi : p.Nk, p.causal && p.windowed ? p.lo : -p.Nq, p.Nk, kvm,
              p.scale, p.softclamp};
}

// ---------------------------------------------------------------------------
// bf16: 128 query rows a block, each warpgroup's K/V tiles through a cp.async
// ring of its own (flash_sweep.cuh)
// ---------------------------------------------------------------------------

template <bool kSeg, bool kClamp, bool kDocs>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_bf16_kernel(const Params p, const RingIO io, const Segs sg) {
  extern __shared__ unsigned char fwd_smem[];
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(fwd_smem) + 1023u) & ~1023u;
  unsigned char* base_ptr = fwd_smem + (base - (uint32_t)__cvta_generic_to_shared(fwd_smem));

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.Nq * 64;
  const size_t kv_off = (size_t)(b * p.Hk + kh) * p.Nk * 64;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;
  const int* kseg = kSeg ? sg.kv + (size_t)b * p.Nk : nullptr;

  // each warpgroup walks its own tiles through its own ring, synchronized
  // by a barrier of its own 128 threads: the two run out of step, so that
  // one's products overlap the other's softmax (a block-wide barrier a tile
  // held them in step, products and exponentials at the same time)
  const SweepWg w = sweep_wg(base, base_ptr, r0);
  const float mask2 = __fmul_rn(kMaskValue, kLog2e);  // the carry's mask value maps here

  // the online-softmax state in fragment layout, from the carry when
  // resuming; m in log2 units
  float o[8][4], m2[2], l[2];
  int qs_r[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w.row_a + 8 * r;
    sweep_load_row(io.c_acc, io.c_m, io.c_l, (size_t)bh * p.Nq + row,
                   io.c_acc != nullptr && row < p.Nq, r, mask2, o, m2, l);
    if constexpr (kSeg) qs_r[r] = row < p.Nq ? sg.q[(size_t)b * p.Nq + row] : 0;
  }

  // this warpgroup's 64 rows of Q, resident behind the rings, then the
  // first tiles of its visit set
  sweep_load_q(w, q, p.Nq);
  const Band bd = launch_band(p, kvm);
  int t_begin, t_end;
  wg_band_tiles(bd, p.Nq, w.rw, &t_begin, &t_end);
  if constexpr (kDocs) {
    if (w.rw < p.Nq) doc_clip(sg.tiles, w.rw / 64, &t_begin, &t_end);
  }
  const SweepRange rg{bd, k, v, kseg, t_begin, t_end - t_begin};
  sweep_issue_ahead(rg, w);

  // a tile runs the keep test only where a score may be masked: at the
  // band's edges, the ragged end, under a key mask, and (kSeg) unless the
  // warpgroup's rows and the tile's keys all hold one document
  int q_doc = 0;
  bool q_one_doc = false;  // every row of the warpgroup before Nq in one document
  if constexpr (kSeg) {
    const int* qseg = sg.q + (size_t)b * p.Nq;
    q_doc = w.rw < p.Nq ? qseg[w.rw] : 0;
    const int lane = threadIdx.x % 32;
    q_one_doc = __all_sync(0xffffffffu,
                           (w.rw + lane >= p.Nq || qseg[w.rw + lane] == q_doc) &&
                               (w.rw + lane + 32 >= p.Nq || qseg[w.rw + lane + 32] == q_doc));
  }
  const bool open = kvm == nullptr && (!kSeg || q_one_doc);
  __syncthreads();  // every carry read before any write below (out= the carry)

  SWEEP_WALK(kSeg, kClamp, rg, w, open, q_one_doc, q_doc, qs_r, mask2, o, m2, l);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sweep_sum_row(l[r]);
    const int row = w.row_a + 8 * r;
    if (row >= p.Nq) continue;
    const size_t idx = (size_t)bh * p.Nq + row;
    const float m = sweep_m_nat(m2[r], mask2);  // natural units
    if (io.p_acc != nullptr)  // the raw state, l reduced above
      sweep_store_row(io.p_acc, io.p_m, io.p_l, idx, r, o, m, l[r]);
    else
      store_out_bf16<64>(static_cast<__nv_bfloat16*>(p.out), p.lse, idx, o, r, m, l[r]);
  }
}

template <int D, bool kSeg, bool kDocs>
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
  if constexpr (kDocs) doc_clip(sg.tiles, r0 / kBlockM, &t_begin, &t_end);
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
// unsegmented one.  doc_tiles, a declared packing's doc-tile table on the
// device, runs the kDocs kernel; it goes with no ids.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* out, void* lse,
                         const void* c_acc, const void* c_m, const void* c_l,
                         void* p_acc, void* p_m, void* p_l, int B, int H,
                         int Hk, int Nq, int Nk, int D, int is_bf16, float scale,
                         int causal, int hi, int windowed, int lo,
                         float softclamp, const void* q_seg, const void* kv_seg,
                         const void* doc_tiles, void* stream) {
  if (D != 64 || H % Hk != 0 || Nq <= 0 || Nk <= 0 || (q_seg == nullptr) != (kv_seg == nullptr) ||
      (q_seg != nullptr && doc_tiles != nullptr))
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
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                static_cast<const int*>(doc_tiles)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool clamp = softclamp > 0.f;
    const auto kernel = q_seg != nullptr
                            ? (clamp ? flash_fwd_bf16_kernel<true, true, false>
                                     : flash_fwd_bf16_kernel<true, false, false>)
                        : doc_tiles != nullptr
                            ? (clamp ? flash_fwd_bf16_kernel<false, true, true>
                                     : flash_fwd_bf16_kernel<false, false, true>)
                            : (clamp ? flash_fwd_bf16_kernel<false, true, false>
                                     : flash_fwd_bf16_kernel<false, false, false>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((Nq + kFwdRows - 1) / kFwdRows, B * H), kFwdThreads, kFwdSmem, s>>>(p, io, sg);
    return (int)cudaGetLastError();
  }
  const dim3 grid((Nq + kBlockM - 1) / kBlockM, B * H);
  if (q_seg != nullptr)
    flash_fwd_f32_kernel<64, true, false><<<grid, kBlockM, 0, s>>>(p, io, sg);
  else if (doc_tiles != nullptr)
    flash_fwd_f32_kernel<64, false, true><<<grid, kBlockM, 0, s>>>(p, io, sg);
  else
    flash_fwd_f32_kernel<64, false, false><<<grid, kBlockM, 0, s>>>(p, io, sg);
  return (int)cudaGetLastError();
}
