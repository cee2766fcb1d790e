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
//   * f32: 64 threads, one query row each, plain FMA on CUDA cores (exact
//     f32, so the card can be held tightly to the CPU), through
//     flash_tile.cuh's f32 tile body, shared with flash_ring.cu (B7) and
//     flash_ring_remote.cu (B8).  Those two keep flash_tile.cuh's bf16
//     mma.sync body, which this kernel no longer uses;
//   * each block computes its own KV-tile range from (lo, hi) and skips
//     tiles outside the band: the counterpart of the TPU compact band grid
//     and its scalar-prefetched tables, which are therefore not needed;
//   * packed sequences (q_seg, kv_seg int32 document ids) run a second
//     instantiation of each kernel (kSeg): the document test sits in the
//     score beside the key mask; in bf16 each thread's two rows' ids sit in
//     registers and each tile's key ids in its stage.  It visits the same
//     tiles as the unsegmented kernel (no tile is skipped on ids, as the TPU
//     kernel skips none on runtime ids), and the unsegmented kernels compile
//     as before.
// Not yet: TMA and warp specialisation (a producer warp, ping-pong of the
// two warpgroups' softmax and products).

#include "flash_tile.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: 128 query rows a block, the K/V tiles through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kFwdThreads = 256;
constexpr int kFwdAhead = 2;  // tiles whose K/V load ahead of the products
// stages in a warpgroup's ring: the step's, those ahead and the previous
// step's, which its P V product may still read
constexpr int kFwdStages = kFwdAhead + 2;
constexpr int kFwdRingBytes = kFwdStages * kKvStageBytes;
// The two warpgroups' rings, then the block's Q tile (128 rows, swizzled),
// resident.
constexpr int kFwdSmem = 2 * kFwdRingBytes + kFwdRows * 128 + 1024;  // + slack
constexpr float kLn2 = 0.6931471805599453f;

// One tile's scores in the log2 domain, in place of the raw dot products in
// s, for this thread's rows row_a and row_a + 8 (fragment halves e >> 1) and
// the tile's keys j * 8 + 2t + (e & 1).  kEdge: the keep test (the band, the
// key mask bytes mb and, kSeg, the key ids kid against the rows' qs): a
// masked score takes mask2, the finite mask value in log2 units, and a key
// at or past nk -inf; without it every score is kept.
template <bool kEdge, bool kSeg, bool kClamp>
__device__ __forceinline__ void fwd_scores(const Band& bd, float (&s)[8][4], const uint8_t* mb,
                                           const int* kid, int c0, int row_a,
                                           const int (&qs)[2], float mask2) {
  const int t = threadIdx.x % 4;
  const float scale2 = bd.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);  // key in the tile
      float x;
      if constexpr (kClamp)
        x = bd.softclamp * tanhf(s[j][e] * bd.scale / bd.softclamp) * kLog2e;
      else
        x = s[j][e] * scale2;
      if constexpr (kEdge) {
        const int off = c0 + key - (row_a + 8 * (e >> 1));
        bool keep = off <= bd.hi && off >= bd.lo && (mb == nullptr || mb[key] != 0);
        if constexpr (kSeg) keep = keep && kid[key] == qs[e >> 1];
        x = c0 + key >= bd.nk ? -INFINITY : (keep ? x : mask2);
      }
      s[j][e] = x;
    }
  }
}

// The online-softmax update of a tile whose keys all hold another document
// than every row of the warpgroup (kSeg), with no exponential: every score
// is the mask value, so a row that has seen a live key (m2 above mask2)
// takes p = 0 and keeps its state, and one that has not takes p = 1 on
// every key (the masked average, l + 64 over its 4 threads), exactly as
// fwd_softmax gives; alpha = 1 either way.
__device__ __forceinline__ void fwd_softmax_masked(float (&s)[8][4], const float (&m2)[2],
                                                   float (&l)[2], float (&alpha)[2],
                                                   float mask2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float pr = m2[r] == mask2 ? 1.f : 0.f;
    alpha[r] = 1.f;
    l[r] += 16.f * pr;  // this thread's 16 of the row's 64 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][2 * r] = s[j][2 * r + 1] = pr;
  }
}

// The online-softmax update of one tile: the rows' running max m2 (log2
// units, the same on a row's 4 threads) and this thread's share of the row
// sums l take the scores in s, which become p = 2^(s - m2); alpha is the
// factor the output accumulator takes for the new max.
__device__ __forceinline__ void fwd_softmax(float (&s)[8][4], float (&m2)[2], float (&l)[2],
                                            float (&alpha)[2]) {
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit on 4 threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_ftz(m2[r] - mx[r]);
    m2[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_ftz(s[j][e] - m2[e >> 1]);
      l[e >> 1] += s[j][e];
    }
}

// o = alpha o + pv: the output accumulator takes a finished P V product.
__device__ __forceinline__ void fold_pv(float (&o)[8][4], const float (&pv)[8][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = fmaf(o[nd][e], alpha[e >> 1], pv[nd][e]);
}

// The key tiles a warpgroup's 64 rows from rw on visit: band_tiles of a
// 64-row block; none when the rows all lie past Nq.
__device__ __forceinline__ void wg_band_tiles(const Band& bd, int nq, int rw, int* t_begin,
                                              int* t_end) {
  *t_begin = *t_end = 0;
  if (rw < nq) band_tiles(bd, nq, rw, t_begin, t_end);
}

template <bool kSeg, bool kClamp>
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = r0 + (warp / 4) * 64;         // this warpgroup's first row
  const int row_a = rw + (warp % 4) * 16 + g;  // row of fragment halves 0, 1
  const float mask2 = __fmul_rn(kMaskValue, kLog2e);  // the carry's mask value maps here

  // the online-softmax state in fragment layout (wgmma.cuh), from the carry
  // when resuming; m in log2 units
  float o[8][4], m2[2], l[2];
  int qs_r[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool resume = io.c_acc != nullptr && row < p.Nq;
    const size_t idx = (size_t)bh * p.Nq + row;
    m2[r] = resume ? __fmul_rn(io.c_m[idx], kLog2e) : mask2;  // the same on all 4 threads
    // a row's sum is split over its 4 threads: the carry seeds one of them
    l[r] = resume && t == 0 ? io.c_l[idx] : 0.f;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      float2 a = make_float2(0.f, 0.f);
      if (resume) a = *reinterpret_cast<const float2*>(io.c_acc + idx * 64 + nd * 8 + t * 2);
      o[nd][2 * r] = a.x;
      o[nd][2 * r + 1] = a.y;
    }
    if constexpr (kSeg) qs_r[r] = row < p.Nq ? sg.q[(size_t)b * p.Nq + row] : 0;
  }

  // each warpgroup walks its own tiles through its own ring, synchronized
  // by a barrier of its own 128 threads: the two run out of step, so that
  // one's products overlap the other's softmax (a block-wide barrier a tile
  // held them in step, products and exponentials at the same time)
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const uint32_t ring = base + wg * kFwdRingBytes;
  const unsigned char* ring_ptr = base_ptr + wg * kFwdRingBytes;
  // this warpgroup's 64 rows of Q, resident behind the rings: the A operand
  // of S = Q K^T
  const uint32_t q_wg = base + 2 * kFwdRingBytes + wg * 64 * 128;
  load_swizzled<128>(q_wg, q, rw, 64, p.Nq, tid);
  cp_async_commit();

  // the tiles of this warpgroup's visit set
  const Band bd = launch_band(p, kvm);
  int t_begin, t_end;
  wg_band_tiles(bd, p.Nq, rw, &t_begin, &t_end);
  const int n_steps = t_end - t_begin;
  auto issue = [&](int step) {
    if (step < n_steps)
      load_kv_stage<128>(ring + (step % kFwdStages) * kKvStageBytes, k, v, kvm, kseg,
                         (t_begin + step) * kBlockN, p.Nk, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kFwdAhead; ++s) issue(s);

  // a tile runs the keep test only where a score may be masked: at the
  // band's edges, the ragged end, under a key mask, and (kSeg) unless the
  // warpgroup's rows and the tile's keys all hold one document
  int q_doc = 0;
  bool q_one_doc = false;  // every row of the warpgroup before Nq in one document
  if constexpr (kSeg) {
    const int* qseg = sg.q + (size_t)b * p.Nq;
    q_doc = rw < p.Nq ? qseg[rw] : 0;
    q_one_doc = __all_sync(0xffffffffu,
                           (rw + lane >= p.Nq || qseg[rw + lane] == q_doc) &&
                               (rw + lane + 32 >= p.Nq || qseg[rw + lane + 32] == q_doc));
  }
  const bool open = kvm == nullptr && (!kSeg || q_one_doc);
  __syncthreads();  // every carry read before any write below (out= the carry)

  // pv: a tile's P V product, written only by the tensor cores (its first
  // wgmma overwrites) and folded into o once done; alpha is the factor o
  // takes for the new max of the tile whose P V is in pv
  float pv[8][4], alpha[2] = {1.f, 1.f};
  // the A fragments of a tile's P V product, read by the tensor cores until
  // the next tile's last wait
  uint32_t pa[4][4];
  // a tile's steps: its K and V landed (and the loads two tiles on issued),
  // S = Q K^T issued, its scores and online-softmax update
  auto land = [&](int step) {
    cp_async_wait<kFwdAhead - 1>();
    fence_proxy_async();  // the landed tile, to the tensor cores' reads
    // the step's tile has landed for the whole warpgroup (named barrier
    // 1 + wg of 128 threads)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    issue(step + kFwdAhead);  // into the slot of step - 2, whose products are done
  };
  auto stage = [&](int step) { return ring + (step % kFwdStages) * kKvStageBytes; };
  auto issue_s = [&](float (&s)[8][4], int step) {  // each warpgroup's 64 rows x 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, gmma_desc(q_wg + kk * 32), gmma_desc(stage(step) + kk * 32), kk);
    wgmma_commit();
  };
  // how a tile's scores are taken: 0 with the keep test, 1 with none
  // (interior), 2 all masked (kSeg: every key of another document than
  // every row); decided while the tile's S runs
  auto classify = [&](int step) {
    const unsigned char* stp = ring_ptr + (step % kFwdStages) * kKvStageBytes;
    const int c0 = (t_begin + step) * kBlockN;
    bool interior = open && c0 + kBlockN <= p.Nk && c0 + kBlockN - 1 - rw <= bd.hi &&
                    c0 - (rw + 63) >= bd.lo;
    if constexpr (kSeg) {
      const int* kid = reinterpret_cast<const int*>(stp + kKvIdsOff);
      const int k_doc = kid[0];
      const bool k_one_doc =
          c0 + kBlockN <= p.Nk &&
          __all_sync(0xffffffffu, kid[lane] == k_doc && kid[lane + 32] == k_doc);
      if (q_one_doc && k_one_doc && k_doc != q_doc) return 2;
      interior = interior && k_one_doc && k_doc == q_doc;
    }
    return interior ? 1 : 0;
  };
  auto softmax_tile = [&](float (&s)[8][4], int step, int mode, float (&alpha_t)[2]) {
    const unsigned char* stp = ring_ptr + (step % kFwdStages) * kKvStageBytes;
    const int c0 = (t_begin + step) * kBlockN;
    const int* kid = reinterpret_cast<const int*>(stp + kKvIdsOff);
    const uint8_t* mb = kvm ? kv_mask_bytes(stp, kvm, c0) : nullptr;
    if (kSeg && mode == 2) {
      fwd_softmax_masked(s, m2, l, alpha_t, mask2);
      return;
    }
    if (mode == 1)
      fwd_scores<false, false, kClamp>(bd, s, mb, kid, c0, row_a, qs_r, mask2);
    else
      fwd_scores<true, kSeg, kClamp>(bd, s, mb, kid, c0, row_a, qs_r, mask2);
    fwd_softmax(s, m2, l, alpha_t);
  };
  // P V of a tile into pv, B read down its V tile's rows
  auto issue_pv = [&](int step) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(pv, pa[kk], gmma_desc(stage(step) + kKvTileBytes + kk * 2048), kk);
    wgmma_commit();
  };
  // the first tile alone; then each step issues its tile's S and the
  // previous tile's P V together, so that the tensor cores run the P V while
  // the tile's softmax runs beside it, and folds the P V into o
  if (n_steps > 0) {
    land(0);
    float s[8][4];
    wgmma_fence();
    issue_s(s, 0);
    const int mode = classify(0);
    wgmma_wait();
    reg_fence(s);
    softmax_tile(s, 0, mode, alpha);
    pack_a_frags(pa, s);
  }
  for (int step = 1; step < n_steps; ++step) {
    land(step);
    float s[8][4];
    wgmma_fence();
    issue_s(s, step);
    issue_pv(step - 1);
    const int mode = classify(step);
    wgmma_wait_group<1>();  // this tile's S; the previous tile's P V runs on
    reg_fence(s);
    float alpha_next[2];
    softmax_tile(s, step, mode, alpha_next);
    wgmma_wait();  // the previous tile's P V
    reg_fence(pv);
    reg_fence(pa);
    fold_pv(o, pv, alpha);
    alpha[0] = alpha_next[0];
    alpha[1] = alpha_next[1];
    pack_a_frags(pa, s);
  }
  if (n_steps > 0) {  // the last tile's P V
    wgmma_fence();
    issue_pv(n_steps - 1);
    wgmma_wait();
    reg_fence(pv);
    reg_fence(pa);
    fold_pv(o, pv, alpha);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= p.Nq) continue;
    const size_t idx = (size_t)bh * p.Nq + row;
    const float m = m2[r] == mask2 ? kMaskValue : m2[r] * kLn2;  // natural units
    if (io.p_acc != nullptr) {  // the raw state, l reduced above
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
        *reinterpret_cast<float2*>(io.p_acc + idx * 64 + nd * 8 + t * 2) =
            make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
      if (t == 0) {
        io.p_m[idx] = m;
        io.p_l[idx] = l[r];
      }
    } else {
      store_out_bf16<64>(static_cast<__nv_bfloat16*>(p.out), p.lse, idx, o, r, m, l[r]);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool clamp = softclamp > 0.f;
    const auto kernel = q_seg != nullptr
                            ? (clamp ? flash_fwd_bf16_kernel<true, true>
                                     : flash_fwd_bf16_kernel<true, false>)
                            : (clamp ? flash_fwd_bf16_kernel<false, true>
                                     : flash_fwd_bf16_kernel<false, false>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((Nq + kFwdRows - 1) / kFwdRows, B * H), kFwdThreads, kFwdSmem, s>>>(p, io, sg);
    return (int)cudaGetLastError();
  }
  const dim3 grid((Nq + kBlockM - 1) / kBlockM, B * H);
  if (q_seg != nullptr)
    flash_fwd_f32_kernel<64, true><<<grid, kBlockM, 0, s>>>(p, io, sg);
  else
    flash_fwd_f32_kernel<64, false><<<grid, kBlockM, 0, s>>>(p, io, sg);
  return (int)cudaGetLastError();
}
