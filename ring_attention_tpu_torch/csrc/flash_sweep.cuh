// B1's bf16 forward sweep for one warpgroup, shared by the forward kernel
// (flash_fwd.cu, B1) and the fused ring's kernels (flash_ring.cu, B7, and
// flash_ring_remote.cu, B8), which walk it once per ring hop.
//
// A block of kFwdThreads threads holds kFwdRows query rows: two warpgroups of
// 64 rows each, which run independently.  For its 64 rows a warpgroup has:
//   * the online-softmax state (o, m2, l) in wgmma's fragment layout
//     (wgmma.cuh): o[nd][2r + c] is row row_a + 8r, column 8 nd + 2t + c (g =
//     lane / 4, t = lane % 4); m2 is the row's running max in log2 units,
//     the same on the row's 4 threads; l is this thread's share of the row
//     sum;
//   * its 64 rows of Q, resident and 128-byte swizzled, the A operand of S =
//     Q K^T;
//   * a ring of kFwdStages K/V stages in dynamic shared memory (wgmma.cuh's
//     KV stage), filled by cp.async kFwdAhead tiles ahead of the products and
//     synchronized by a named barrier of its own 128 threads.
// A walk over one KV range (sweep_issue_ahead, then SWEEP_WALK) visits
// exactly the tiles band_tiles (flash_tile.cuh) gives the warpgroup's 64
// rows, and leaves its P V drained and its copies landed.
//
// A carry crosses launches and ring hops in natural units, as on the TPU: m
// in natural units (the finite mask value kept exact), l summed over the
// row's 4 threads, acc in f32.  sweep_load_row reads one, sweep_m_nat and
// sweep_store_row write one, and sweep_hop_boundary does in registers what
// a store followed by a load does, with the same instructions: so a kernel
// that walks several hops in one launch (B7, or B8 through its f32 spill)
// computes the B1 hop chain bit for bit.
//
// Every function is __forceinline__ and the walk itself a macro that
// expands in the kernel's body (SWEEP_WALK), so each kernel keeps its own
// __global__ and register budget.  The soft clamp and (B1) the segment ids
// are template switches; the kernels without them compile no trace of them.

#pragma once

#include "flash_tile.cuh"
#include "wgmma.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// The carry, in natural units
// ---------------------------------------------------------------------------

// Row half r of the state (row row_a + 8r, spill or carry index idx) from a
// carry (c_acc, c_m, c_l) when `resume`, else the empty state: m to log2
// units by a multiply that sweep_m_nat inverts exactly on the mask value,
// and the row's sum onto thread 0 of its 4.
__device__ __forceinline__ void sweep_load_row(const float* c_acc, const float* c_m,
                                               const float* c_l, size_t idx, bool resume,
                                               int r, float mask2, float (&o)[8][4],
                                               float (&m2)[2], float (&l)[2]) {
  const int t = threadIdx.x % 4;
  m2[r] = resume ? __fmul_rn(c_m[idx], kLog2e) : mask2;  // the same on all 4 threads
  // a row's sum is split over its 4 threads: the carry seeds one of them
  l[r] = resume && t == 0 ? c_l[idx] : 0.f;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    float2 a = make_float2(0.f, 0.f);
    if (resume) a = *reinterpret_cast<const float2*>(c_acc + idx * 64 + nd * 8 + t * 2);
    o[nd][2 * r] = a.x;
    o[nd][2 * r + 1] = a.y;
  }
}

// Each row's whole sum on each of its 4 threads (the two halves of the
// butterfly add the same pairs, so the 4 agree bit for bit).
__device__ __forceinline__ void sweep_sum_row(float& l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
}

// A row's max in natural units; a row that has seen no live key keeps the
// finite mask value exactly.
__device__ __forceinline__ float sweep_m_nat(float m2, float mask2) {
  return m2 == mask2 ? kMaskValue : m2 * kLn2;
}

// Row half r of the state as partials (p_acc, p_m, p_l) at index idx: m
// natural, l the row's whole sum (sweep_sum_row).
__device__ __forceinline__ void sweep_store_row(float* p_acc, float* p_m, float* p_l,
                                                size_t idx, int r, const float (&o)[8][4],
                                                float m, float l) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
    *reinterpret_cast<float2*>(p_acc + idx * 64 + nd * 8 + t * 2) =
        make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
  if (t == 0) {
    p_m[idx] = m;
    p_l[idx] = l;
  }
}

// Between two ring hops, in registers: what a launch of the B1 hop chain
// does at its end (l summed over the row's threads, m to natural units) and
// the next one at its start (thread 0 seeded with the sum, m back to log2
// units), with the same instructions.
__device__ __forceinline__ void sweep_hop_boundary(float (&m2)[2], float (&l)[2], float mask2) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sweep_sum_row(l[r]);
    if (t != 0) l[r] = 0.f;
    m2[r] = m2[r] == mask2 ? mask2 : __fmul_rn(__fmul_rn(m2[r], kLn2), kLog2e);
  }
}

// ---------------------------------------------------------------------------
// One warpgroup's walk over one KV range
// ---------------------------------------------------------------------------

// A warpgroup's place in its block: its ring (shared address and generic
// pointer), its Q rows (shared address), its number wg in the block, its
// first row rw and the row row_a of this thread's fragment halves 0 and 1.
// A thread's number among the warpgroup's 128 (sweep_tid) and its lane are
// taken from threadIdx where used, so that the compiler knows their range
// there.
struct SweepWg {
  uint32_t ring;
  const unsigned char* ring_ptr;
  uint32_t q;
  int wg, rw, row_a;
};

// The remainder is taken unsigned, as B1's kernel took it: the compiler then
// knows tid < 128 and the copy loops' trip counts (a signed remainder left
// them rolled, 1.23x B1's time on an H100).
__device__ __forceinline__ int sweep_tid() { return threadIdx.x % 128; }

// The warpgroup of this thread in a block of kFwdRows rows from r0, its
// stages at shared address `base` (1,024-byte aligned) and generic pointer
// base_ptr: the two rings, then the Q tile.
__device__ __forceinline__ SweepWg sweep_wg(uint32_t base, const unsigned char* base_ptr,
                                            int r0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int rw = r0 + wg * 64;
  return SweepWg{base + wg * kFwdRingBytes, base_ptr + wg * kFwdRingBytes,
                 base + 2 * kFwdRingBytes + wg * 64 * 128, wg, rw, rw + (warp % 4) * 16 + lane / 4};
}

// The warpgroup's 64 rows of q (nq rows from row 0, bf16, 64 wide) into its
// Q tile, one cp.async group of its own (the walk's first landing waits for
// it).
__device__ __forceinline__ void sweep_load_q(const SweepWg& w, const __nv_bfloat16* q, int nq) {
  load_swizzled<128>(w.q, q, w.rw, 64, nq, sweep_tid());
  cp_async_commit();
}

// One KV range of a walk: the band (its nk keys and key mask), K and V
// (nk rows of 64 bf16), the keys' document ids (kSeg) and the warpgroup's
// tiles [t_begin, t_begin + n_steps).
struct SweepRange {
  Band bd;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kseg;
  int t_begin, n_steps;
};

// Issues the copies of step `step` of the range into its stage, or an
// empty group past the last step: one commit group a step.
__device__ __forceinline__ void sweep_issue(const SweepRange& rg, const SweepWg& w, int step) {
  if (step < rg.n_steps)
    load_kv_stage<128>(w.ring + (step % kFwdStages) * kKvStageBytes, rg.k, rg.v, rg.bd.kvm,
                       rg.kseg, (rg.t_begin + step) * kBlockN, rg.bd.nk, sweep_tid());
  cp_async_commit();
}

// The range's first kFwdAhead tiles, issued before the walk: the ring must
// hold no step of an earlier range that the warpgroup still reads.
__device__ __forceinline__ void sweep_issue_ahead(const SweepRange& rg, const SweepWg& w) {
#pragma unroll
  for (int s = 0; s < kFwdAhead; ++s) sweep_issue(rg, w, s);
}

// SWEEP_WALK(kSeg, kClamp, rg, w, open, q_one_doc, q_doc, qs_r, mask2, o, m2, l):
// the walk over the range rg (a SweepRange) of the warpgroup w (a SweepWg),
// after sweep_issue_ahead: each tile's scores and online-softmax update
// into the state (o, m2, l: float[8][4], float[2], float[2]), its P V folded
// in; after it the last P V is folded and every copy of this thread has
// landed.  open: the range has no key mask (and, kSeg, the rows are of one
// document q_doc, q_one_doc), so a tile inside the band takes no keep test;
// qs_r (int[2]): the ids of this thread's rows (kSeg).  kSeg and kClamp are
// the kernel's template flags.
//
// A macro that expands in the kernel's body, not a function: compiled as a
// function or a lambda of its own, the walk is simplified apart from the
// kernel before it is inlined, which cost B1's sweep 4 registers and 2-3% of
// its time on an H100; expanded in place it compiles as the kernel's own
// code.
#define SWEEP_WALK(kSeg, kClamp, rg, w, open, q_one_doc, q_doc, qs_r, mask2, o, m2, l)          \
  {                                                                                            \
    const Band& sw_bd = (rg).bd;                                                               \
    const int sw_steps = (rg).n_steps;                                                         \
    /* pv: a tile's P V product, written only by the tensor cores (its first                   \
       wgmma overwrites) and folded into o once done; alpha is the factor o                    \
       takes for the new max of the tile whose P V is in pv */                                 \
    float sw_pv[8][4], sw_alpha[2] = {1.f, 1.f};                                               \
    /* the A fragments of a tile's P V product, read by the tensor cores                       \
       until the next tile's last wait */                                                      \
    uint32_t sw_pa[4][4];                                                                      \
    /* a tile's steps: its K and V landed (and the loads two tiles on                          \
       issued), S = Q K^T issued, its scores and online-softmax update */                      \
    auto sw_land = [&](int step) {                                                             \
      cp_async_wait<kFwdAhead - 1>();                                                          \
      fence_proxy_async(); /* the landed tile, to the tensor cores' reads */                   \
      /* the step's tile has landed for the whole warpgroup (named barrier                     \
         1 + wg of 128 threads) */                                                             \
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (w).wg) : "memory");                        \
      sweep_issue(rg, w, step + kFwdAhead); /* into the slot of step - 2, done */              \
    };                                                                                         \
    auto sw_stage = [&](int step) { return (w).ring + (step % kFwdStages) * kKvStageBytes; };  \
    auto sw_issue_s = [&](float(&s)[8][4], int step) { /* 64 rows x 64 keys */                 \
      _Pragma("unroll") for (int kk = 0; kk < 4; ++kk)                                         \
        wgmma_ss(s, gmma_desc((w).q + kk * 32), gmma_desc(sw_stage(step) + kk * 32), kk);      \
      wgmma_commit();                                                                          \
    };                                                                                         \
    /* how a tile's scores are taken: 0 with the keep test, 1 with none                        \
       (interior), 2 all masked (kSeg: every key of another document than                      \
       every row); decided while the tile's S runs */                                          \
    auto sw_classify = [&](int step) {                                                         \
      const unsigned char* stp = (w).ring_ptr + (step % kFwdStages) * kKvStageBytes;           \
      const int c0 = ((rg).t_begin + step) * kBlockN;                                          \
      bool interior = (open) && c0 + kBlockN <= sw_bd.nk &&                                    \
                      c0 + kBlockN - 1 - (w).rw <= sw_bd.hi && c0 - ((w).rw + 63) >= sw_bd.lo; \
      if constexpr (kSeg) {                                                                    \
        const int* kid = reinterpret_cast<const int*>(stp + kKvIdsOff);                        \
        const int k_doc = kid[0];                                                              \
        const int lane = threadIdx.x % 32;                                                     \
        const bool k_one_doc =                                                                 \
            c0 + kBlockN <= sw_bd.nk &&                                                        \
            __all_sync(0xffffffffu, kid[lane] == k_doc && kid[lane + 32] == k_doc);            \
        if ((q_one_doc) && k_one_doc && k_doc != (q_doc)) return 2;                            \
        interior = interior && k_one_doc && k_doc == (q_doc);                                  \
      }                                                                                        \
      return interior ? 1 : 0;                                                                 \
    };                                                                                         \
    auto sw_softmax_tile = [&](float(&s)[8][4], int step, int mode, float(&alpha_t)[2]) {      \
      const unsigned char* stp = (w).ring_ptr + (step % kFwdStages) * kKvStageBytes;           \
      const int c0 = ((rg).t_begin + step) * kBlockN;                                          \
      const int* kid = reinterpret_cast<const int*>(stp + kKvIdsOff);                          \
      const uint8_t* mb = sw_bd.kvm ? kv_mask_bytes(stp, sw_bd.kvm, c0) : nullptr;             \
      if (kSeg && mode == 2) {                                                                 \
        fwd_softmax_masked(s, m2, l, alpha_t, mask2);                                          \
        return;                                                                                \
      }                                                                                        \
      if (mode == 1)                                                                           \
        fwd_scores<false, false, kClamp>(sw_bd, s, mb, kid, c0, (w).row_a, qs_r, mask2);       \
      else                                                                                     \
        fwd_scores<true, kSeg, kClamp>(sw_bd, s, mb, kid, c0, (w).row_a, qs_r, mask2);         \
      fwd_softmax(s, m2, l, alpha_t);                                                          \
    };                                                                                         \
    /* P V of a tile into pv, B read down its V tile's rows */                                 \
    auto sw_issue_pv = [&](int step) {                                                         \
      _Pragma("unroll") for (int kk = 0; kk < 4; ++kk)                                         \
        wgmma_rs(sw_pv, sw_pa[kk], gmma_desc(sw_stage(step) + kKvTileBytes + kk * 2048), kk);  \
      wgmma_commit();                                                                          \
    };                                                                                         \
    /* the first tile alone; then each step issues its tile's S and the                        \
       previous tile's P V together, so that the tensor cores run the P V                      \
       while the tile's softmax runs beside it, and folds the P V into o */                    \
    if (sw_steps > 0) {                                                                        \
      sw_land(0);                                                                              \
      float s[8][4];                                                                           \
      wgmma_fence();                                                                           \
      sw_issue_s(s, 0);                                                                        \
      const int mode = sw_classify(0);                                                         \
      wgmma_wait();                                                                            \
      reg_fence(s);                                                                            \
      sw_softmax_tile(s, 0, mode, sw_alpha);                                                   \
      pack_a_frags(sw_pa, s);                                                                  \
    }                                                                                          \
    for (int step = 1; step < sw_steps; ++step) {                                              \
      sw_land(step);                                                                           \
      float s[8][4];                                                                           \
      wgmma_fence();                                                                           \
      sw_issue_s(s, step);                                                                     \
      sw_issue_pv(step - 1);                                                                   \
      const int mode = sw_classify(step);                                                      \
      wgmma_wait_group<1>(); /* this tile's S; the previous tile's P V runs on */              \
      reg_fence(s);                                                                            \
      float alpha_next[2];                                                                     \
      sw_softmax_tile(s, step, mode, alpha_next);                                              \
      wgmma_wait(); /* the previous tile's P V */                                              \
      reg_fence(sw_pv);                                                                        \
      reg_fence(sw_pa);                                                                        \
      fold_pv(o, sw_pv, sw_alpha);                                                             \
      sw_alpha[0] = alpha_next[0];                                                             \
      sw_alpha[1] = alpha_next[1];                                                             \
      pack_a_frags(sw_pa, s);                                                                  \
    }                                                                                          \
    if (sw_steps > 0) { /* the last tile's P V */                                              \
      wgmma_fence();                                                                           \
      sw_issue_pv(sw_steps - 1);                                                               \
      wgmma_wait();                                                                            \
      reg_fence(sw_pv);                                                                        \
      reg_fence(sw_pa);                                                                        \
      fold_pv(o, sw_pv, sw_alpha);                                                             \
    }                                                                                          \
    cp_async_wait<0>();                                                                        \
  }

// The warpgroup's 128 threads are done with its ring and its Q tile (every
// read of the walk behind them): the next range's or query tile's copies
// may overwrite them.
__device__ __forceinline__ void sweep_wg_sync(const SweepWg& w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w.wg) : "memory");
}

}  // namespace
