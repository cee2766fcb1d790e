// Backward flash-attention passes for NVIDIA Hopper (built for sm_90a).
//
// Replaces the two launches of ring_attention_tpu/ops/pallas_flash.py::
// pallas_flash_backward (:1848):
//   * flash_bwd_dkv: the dk/dv pass, pl.pallas_call at :2108 (kernel bodies
//     _bwd_dkv_kernel :1691, _dkv_tile :1727);
//   * flash_bwd_dq: the dq pass, pl.pallas_call at :2186 (_bwd_dq_kernel
//     :1774, _dq_tile :1808);
// both with the runtime segment ids of _bwd_parse_refs (:1649) and
// _tile_keep (:240), and the doc_starts tile tables of each pass (:1966-2009,
// _band_tables :578).
//
// What they compute, for q, do (B, H, Nq, D) and k, v (B, Hk, Nk, D),
// contiguous, lse and delta (B, H, Nq) float32 (delta = rowsum(do * out)):
//   s    = scale * q . k, then c * tanh(s / c) when c > 0;
//   keep = (!causal || (j - i <= hi && (!windowed || j - i >= lo)))
//          && (kv_mask == null || kv_mask[b, j])
//          && (q_seg == null || q_seg[b, i] == kv_seg[b, j]);
//   p    = keep ? exp(s - lse) : 0            (a select, never a multiply:
//          a row with no key has lse ~ mask value, so exp(s - lse) = inf);
//   dp   = do . v;  ds = p * (dp - delta) * (1 - (s / c)^2 when c > 0) * scale;
//   dv   = sum over queries p^T do,  dk = sum over queries ds^T q,
//   dq   = ds k.
// dk and dv are summed over the H / Hk query heads of each kv head inside
// the kernel and written once at Hk width; all three outputs are float32.
// A row with no key in its band (causal Nq > Nk, or an all-False kv_mask
// row) therefore contributes nothing, as in the TPU kernels.
// In bf16, p is rounded to bf16 before the dv product and ds before the dk
// and dq products, at the places the TPU kernels round them.
//
// What bounds them on an H100: per in-band (query, key) pair and query head
// the dk/dv pass does 4 products of length D (8 D operations) and the dq
// pass 3 (6 D operations), against O(Nq + Nk) bytes moved; at long causal
// sequences that is thousands of operations per byte, far above the card's
// ~295 bf16 operations per byte, so both are bound by tensor-core operations.
//
// Design:
//   * dk/dv in bf16, redesigned for Hopper: one block of 256 threads per
//     (128-key block, b*hk), heaviest causal key blocks first.  Two
//     warpgroups own 64 keys each; the block's K and V stay resident in
//     shared memory (128-byte swizzled).  The block loops over the g =
//     H / Hk query heads of its group and the 64-row query tiles that meet
//     the band, as one sequence of steps, so dk and dv accumulate in f32
//     registers across the whole group and are written once: no per-head
//     buffer, no atomics.  Each step's Q and dO tiles (128-byte swizzled),
//     lse, delta and (kSeg) query ids arrive by cp.async through a ring of
//     4 stages in dynamic shared memory, two steps ahead of the products;
//     a step's dv/dk products run on while the next step's tile is waited
//     for and its first products issue.
//     sT = K q^T and dpT = V do^T run on wgmma m64n64k16 (A the K or V
//     tile, B the Q or dO tile, both K-major); p and ds are formed in the
//     accumulator registers, rounded to bf16 and fed as the A fragments of
//     dv += p^T do and dk += ds^T q (B the same tiles read down their
//     rows, MN-major).  A step runs
//     the keep test only where a pair may be dropped: at the band's edges,
//     the ragged ends, under a key mask (each thread's two keys' bits in
//     registers) and, kSeg, unless the block's keys and the tile's rows all
//     hold one document; every other step takes p = exp(s - lse) with no
//     test, the same code instantiated without it (the Band form of
//     flash_tile.cuh).  A kSeg step whose rows all hold one document and
//     the block's keys another keeps no pair: p = ds = 0 with no test.
//   * dq in bf16, redesigned for Hopper on the same plan: one block of 256
//     threads per (128-row query block, b*h), heaviest causal rows first.
//     Two warpgroups own 64 rows each; the block's Q and dO stay resident
//     in shared memory (128-byte swizzled) and each thread's rows' lse and
//     delta in registers.  The 64-key K and V tiles, with their key-mask
//     bytes and (kSeg) key ids, arrive by cp.async through a ring of 4
//     stages per warpgroup, two tiles ahead of the products (wgmma.cuh's KV
//     stage).
//     s = q K^T and dp = do V^T run on wgmma m64n64k16 with both operands
//     in shared memory; p = exp2(s scale log2 e - lse log2 e) and ds = p (dp
//     - delta) are formed in the accumulator registers, ds rounded to bf16
//     as the A fragments of dq += ds K (K read down its rows, MN-major),
//     which runs on into the next tile's products.  dq accumulates in f32
//     registers that only the tensor cores write, and is written once; a
//     row with no key gets zero.  Each warpgroup walks the tiles its own
//     rows meet through a ring of its own, on a named barrier of its own
//     128 threads, so that the two run out of step (B1's plan).
//     The keep test runs only as in dk/dv: at the band's edges, the ragged
//     ends, under a key mask and, kSeg, unless the warpgroup's rows and the
//     tile's keys all hold one document; a kSeg tile whose keys all hold
//     another document than the warpgroup's rows takes ds = 0 with no test.
//   * f32: one thread block per (64-key tile, b*hk) for dk/dv and per
//     (64-row query tile, b*h) for dq, looping over the tiles that meet the
//     band, heaviest causal rows first; 64 threads, one key (dk/dv) or one
//     query row (dq) per thread, plain FMA on CUDA cores, so the card can
//     be held tightly to the CPU;
//   * each block computes its own tile range from (lo, hi): the counterpart
//     of the TPU compact band grid and its scalar-prefetched tables.  Tiles
//     outside the band hold only p = 0 and are skipped exactly.
//   * packed sequences (q_seg, kv_seg int32 document ids, a kernel argument
//     of their own) run a second instantiation of each kernel (kSeg): each
//     thread's fixed-side ids in registers, the other side's ids in shared
//     memory beside the tile they belong to (the query rows' beside lse and
//     delta for dk/dv, the keys' beside K and V for dq).  The same tiles are
//     visited as without ids, and the unsegmented kernels compile as
//     before;
//   * a declared packing aligned to a pass's own blocks (doc_starts; every
//     start a multiple of the block and of the tile: 128 keys for the bf16
//     dk/dv pass, 64 otherwise) runs a third instantiation of that pass
//     (kDocs): a small int32 table gives each block (a bf16 dk/dv block of
//     128 keys, a bf16 dq warpgroup of 64 rows, an f32 block) the tiles of
//     the other side that its document holds, which clip the band's range
//     (doc_clip, wgmma.cuh), and the unsegmented tile body runs on them.  A
//     pass whose blocks the packing does not align takes runtime ids
//     (kSeg), as the TPU backward does per pass.
// Not yet: TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 64;  // query rows per tile (bf16 and f32 dq)
constexpr int kBlockN = 64;  // keys per tile (bf16 and f32 dk/dv)
constexpr int kRowsF32 = 16;  // query rows per step of the f32 dk/dv pass
constexpr int kKeysF32 = 16;  // keys per step of the f32 dq pass

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const uint8_t* kv_mask;  // (B, Nk) or null
  float* dq;
  float* dk;
  float* dv;
  int B, H, Hk, Nq, Nk;
  float scale;
  int causal, hi, windowed, lo;
  float softclamp;  // 0 = off
};

// Packed sequences: (B, Nq) and (B, Nk) int32 document ids, a kernel
// argument of their own (Params stays as the unsegmented kernels had it),
// read by the kSeg instantiations only; a declared packing's doc-tile table,
// (blocks, 2) int32, read by the kDocs instantiations only.
struct Segs {
  const int* q;
  const int* kv;
  const int* tiles;
};

// [t_begin, t_end) query tiles of `bm` rows holding a row that attends a
// key of [c0, c0 + bn): row i meets key j iff lo <= j - i <= hi.
__device__ __forceinline__ void query_tiles(const Params& p, int c0, int bm,
                                            int bn, int* t_begin, int* t_end) {
  *t_begin = 0;
  *t_end = (p.Nq + bm - 1) / bm;
  if (!p.causal) return;
  const long long c_last = (long long)min(c0 + bn, p.Nk) - 1;
  const long long i_min = max((long long)c0 - p.hi, 0LL);
  long long i_max = (long long)p.Nq - 1;
  if (p.windowed) i_max = min(i_max, c_last - p.lo);
  if (i_min > i_max) {
    *t_end = 0;
    return;
  }
  *t_begin = (int)(i_min / bm);
  *t_end = (int)(i_max / bm) + 1;
}

// [t_begin, t_end) key tiles of `bn` keys that rows [r0, r0 + bm) attend.
__device__ __forceinline__ void key_tiles(const Params& p, int r0, int bm,
                                          int bn, int* t_begin, int* t_end) {
  *t_begin = 0;
  *t_end = (p.Nk + bn - 1) / bn;
  if (!p.causal) return;
  const long long r_last = (long long)min(r0 + bm, p.Nq) - 1;
  const long long j_min = p.windowed ? max((long long)r0 + p.lo, 0LL) : 0LL;
  const long long j_max = min(r_last + p.hi, (long long)p.Nk - 1);
  if (j_min > j_max) {
    *t_end = 0;
    return;
  }
  *t_begin = (int)(j_min / bn);
  *t_end = (int)(j_max / bn) + 1;
}

__device__ __forceinline__ bool kept(const Params& p, const uint8_t* kvm,
                                     int row, int col) {
  if (row >= p.Nq || col >= p.Nk) return false;
  if (p.causal) {
    const int off = col - row;
    if (off > p.hi || (p.windowed && off < p.lo)) return false;
  }
  return kvm == nullptr || kvm[col] != 0;
}

// kept() of a kSeg instantiation: also both in one document (qs and ks are
// their ids; a caller may pass anything for a row or column out of range).
__device__ __forceinline__ bool kept_seg(const Params& p, const uint8_t* kvm,
                                         int row, int col, int qs, int ks) {
  return kept(p, kvm, row, col) && qs == ks;
}

// ids[i] when i < n, else 0 (a row or key past the end, which kept() drops).
__device__ __forceinline__ int seg_at(const int* ids, int i, int n) {
  return i < n ? ids[i] : 0;
}

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * kLog2e); }

// p and ds of one (row, col) pair from the raw dot products q.k and do.v.
__device__ __forceinline__ void grad_pair(const Params& p, bool keep,
                                          float qk, float dov, float lse,
                                          float delta, float* prob,
                                          float* ds) {
  float s = qk * p.scale;
  float factor = p.scale;
  if (p.softclamp > 0.f) {
    const float t = tanhf(s / p.softclamp);
    s = p.softclamp * t;
    factor *= 1.f - t * t;
  }
  const float pr = keep ? exp_nat(s - lse) : 0.f;
  *prob = pr;
  *ds = pr * (dov - delta) * factor;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through wgmma (wgmma.cuh)
// ---------------------------------------------------------------------------

// Writes a 16 x D f32 accumulator (rows row_a and row_a + 8) to out rows.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, const float (*acc)[4],
                                               int row_a, int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(out + (size_t)row * D + nd * 8 + t * 2) =
          make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: 128 keys a block, the Q/dO tiles through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kDkvKeys = 128;   // keys per block: 8 warps of 16
constexpr int kDkvThreads = 256;
constexpr int kDkvAhead = 2;    // steps whose Q/dO tiles load ahead of the products
// stages in the ring: the step's, those ahead and the previous step's, which
// its dv/dk products may still read
constexpr int kDkvStages = kDkvAhead + 2;
// One stage: the Q and dO tiles (64 rows of 128 bytes each, 128-byte
// swizzled: 16-byte chunk c of row r sits at chunk c ^ (r % 8)), then the
// rows' lse, delta and (kSeg) document ids; a whole number of 1,024-byte
// swizzle atoms.
constexpr int kTileBytes = kBlockM * 128;
constexpr int kStageBytes = 2 * kTileBytes + 3 * kBlockM * 4 + 256;  // 17,408
// Then the block's K and V tiles (128 rows each, swizzled), resident.
constexpr int kKVBytes = 2 * kDkvKeys * 128;
constexpr int kDkvSmem = kDkvStages * kStageBytes + kKVBytes + 1024;  // + alignment slack
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle atoms aligned");

// One query tile's p (into s) and ds (into dp) for this thread's keys
// key_a and key_a + 8 (fragment halves e >> 1) and the tile's rows
// j * 8 + 2t + (e & 1).  kEdge: the keep test of every pair (the band, the
// rows and keys past the end, the key mask bits km and, kSeg, the ids);
// without it every pair is kept, p = exp(s - lse) with no select.

template <bool kEdge, bool kSeg, bool kClamp>
__device__ __forceinline__ void dkv_grads(const Params& p, int hi, int lo, float (&s)[8][4],
                                          float (&dp)[8][4], const float* Ls, const float* Es,
                                          const int* Ss, int r0, int key_a,
                                          const bool (&km)[2], const int (&ks)[2]) {
  const int t = threadIdx.x % 4;
  const float scale2 = p.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = j * 8 + 2 * t + c;  // row in the tile
      const float lse2 = Ls[i] * kLog2e, delta = Es[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + c;
        float pr, factor = p.scale;
        if constexpr (kClamp) {
          const float th = tanhf(s[j][e] * p.scale / p.softclamp);
          pr = exp2_ftz(p.softclamp * th * kLog2e - lse2);
          factor *= 1.f - th * th;
        } else {
          pr = exp2_ftz(fmaf(s[j][e], scale2, -lse2));
        }
        if constexpr (kEdge) {
          const int off = key_a + 8 * r - (r0 + i);
          bool keep = off <= hi && off >= lo && r0 + i < p.Nq && km[r];
          if constexpr (kSeg) keep = keep && Ss[i] == ks[r];
          pr = keep ? pr : 0.f;
        }
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - delta) * factor;
      }
    }
  }
}

// dkv_grads with the soft clamp chosen once per step, not per score.
template <bool kEdge, bool kSeg>
__device__ __forceinline__ void dkv_grads_step(const Params& p, int hi, int lo,
                                               float (&s)[8][4], float (&dp)[8][4],
                                               const float* Ls, const int* Ss, int r0,
                                               int key_a, const bool (&km)[2],
                                               const int (&ks)[2]) {
  if (p.softclamp > 0.f)
    dkv_grads<kEdge, kSeg, true>(p, hi, lo, s, dp, Ls, Ls + kBlockM, Ss, r0, key_a, km, ks);
  else
    dkv_grads<kEdge, kSeg, false>(p, hi, lo, s, dp, Ls, Ls + kBlockM, Ss, r0, key_a, km, ks);
}

template <bool kSeg, bool kDocs>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_bf16_kernel(const Params p, const Segs sg) {
  extern __shared__ unsigned char dkv_smem[];
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(dkv_smem) + 1023u) & ~1023u;
  unsigned char* base_ptr = dkv_smem + (base - (uint32_t)__cvta_generic_to_shared(dkv_smem));

  const int c0 = blockIdx.x * kDkvKeys;  // causal: heaviest key blocks first
  const int bkh = blockIdx.y;
  const int b = bkh / p.Hk, kh = bkh % p.Hk;
  const int group = p.H / p.Hk;
  const size_t kv_off = (size_t)bkh * p.Nk * 64;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = c0 + warp * 16 + g;  // key of fragment halves 0, 1
  bool km[2];
  int ks[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    km[r] = key < p.Nk && (kvm == nullptr || kvm[key] != 0);
    if constexpr (kSeg) ks[r] = seg_at(sg.kv + (size_t)b * p.Nk, key, p.Nk);
  }

  // the block's K and V, resident behind the ring; this warpgroup's 64 rows
  // of each are the A operands of the first two products (A fragments held
  // in registers across steps gave wrong dk and dv past the first step)
  const uint32_t kv = base + kDkvStages * kStageBytes;
  load_swizzled<kDkvThreads>(kv, static_cast<const __nv_bfloat16*>(p.k) + kv_off, c0,
                             kDkvKeys, p.Nk, threadIdx.x);
  load_swizzled<kDkvThreads>(kv + kDkvKeys * 128,
                             static_cast<const __nv_bfloat16*>(p.v) + kv_off, c0, kDkvKeys,
                             p.Nk, threadIdx.x);
  cp_async_commit();
  const uint32_t k_wg = kv + (warp / 4) * 64 * 128, v_wg = k_wg + kDkvKeys * 128;

  // the query tiles of every head of the group, in one sequence
  int t_begin, t_end;
  query_tiles(p, c0, kBlockM, kDkvKeys, &t_begin, &t_end);
  if constexpr (kDocs) doc_clip(sg.tiles, c0 / kDkvKeys, &t_begin, &t_end);
  const int n_tiles = t_end - t_begin, n_steps = group * n_tiles;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const uint32_t st = base + (step % kDkvStages) * kStageBytes;
      const size_t bh = (size_t)b * p.H + kh * group + step / n_tiles;
      const int r0 = (t_begin + step % n_tiles) * kBlockM;
      load_swizzled<kDkvThreads>(st, static_cast<const __nv_bfloat16*>(p.q) + bh * p.Nq * 64,
                                 r0, kBlockM, p.Nq, threadIdx.x);
      load_swizzled<kDkvThreads>(st + kTileBytes,
                                 static_cast<const __nv_bfloat16*>(p.dout) + bh * p.Nq * 64, r0,
                                 kBlockM, p.Nq, threadIdx.x);
      const int i = threadIdx.x % kBlockM, which = threadIdx.x / kBlockM;
      const bool valid = r0 + i < p.Nq;
      const size_t at = valid ? bh * p.Nq + r0 + i : 0;
      const uint32_t dst = st + 2 * kTileBytes + (which * kBlockM + i) * 4;
      if (which == 0) cp_async(dst, p.lse + at, 4, valid);
      if (which == 1) cp_async(dst, p.delta + at, 4, valid);
      if (kSeg && which == 2)
        cp_async(dst, sg.q + (valid ? (size_t)b * p.Nq + r0 + i : 0), 4, valid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kDkvAhead; ++s) issue(s);

  // dk and dv: only the tensor cores write them until the store (the first
  // product overwrites; zeros written by other instructions made ptxas
  // serialize every wgmma of the loop: 27.2 against 23.3 ms at causal
  // (1,8,65536,64) on an H100)
  float dk[8][4], dv[8][4];
  // a tile runs the keep test only where a pair of it may be dropped: at
  // the band's edges, the ragged ends, under a key mask, and (kSeg) unless
  // the block's keys and the tile's rows all hold one document
  int one_doc = 0;
  bool keys_one_doc = false;
  if constexpr (kSeg) {
    one_doc = seg_at(sg.kv + (size_t)b * p.Nk, c0, p.Nk);
    keys_one_doc = __syncthreads_and(ks[0] == one_doc && ks[1] == one_doc);
  }
  const bool open = kvm == nullptr && c0 + kDkvKeys <= p.Nk && (!kSeg || keys_one_doc);
  const int hi = p.causal ? p.hi : p.Nk;
  const int lo = p.causal && p.windowed ? p.lo : -p.Nq;

  // the A fragments of a step's dv/dk products, read by the tensor cores
  // until the next step's wait
  uint32_t pa[4][4], da[4][4];
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kDkvAhead - 1>();
    fence_proxy_async();  // the landed tile, to the tensor cores' reads
    __syncthreads();  // the step's tile has landed everywhere
    issue(step + kDkvAhead);  // into the slot of step - 2, whose products are done
    const uint32_t st = base + (step % kDkvStages) * kStageBytes;
    const unsigned char* stp = base_ptr + (step % kDkvStages) * kStageBytes;
    const float* Ls = reinterpret_cast<const float*>(stp + 2 * kTileBytes);
    const int r0 = (t_begin + step % n_tiles) * kBlockM;

    // sT = k q^T and dpT = v do^T: each warpgroup's 64 keys x 64 query rows
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, gmma_desc(k_wg + kk * 32), gmma_desc(st + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, gmma_desc(v_wg + kk * 32), gmma_desc(st + kTileBytes + kk * 32), kk);
    wgmma_commit();
    // meanwhile: does the tile need the keep test?
    const int* Ss = reinterpret_cast<const int*>(Ls + 2 * kBlockM);
    bool interior = open && r0 + kBlockM <= p.Nq && c0 + kDkvKeys - 1 - r0 <= hi &&
                    c0 - (r0 + kBlockM - 1) >= lo;
    bool dropped = false;  // no pair kept: every row of another document
    if constexpr (kSeg) {
      const int q_doc = Ss[0];
      const bool q_one_doc =
          __all_sync(0xffffffffu, Ss[lane] == q_doc && Ss[lane + 32] == q_doc);
      interior = interior && q_one_doc && q_doc == one_doc;
      dropped = keys_one_doc && q_one_doc && q_doc != one_doc;
    }
    wgmma_wait();  // this step's sT and dpT, the previous step's dv and dk
    reg_fence(s);
    reg_fence(dp);
    reg_fence(pa);
    reg_fence(da);
    if (dropped) {  // p = ds = 0 exactly, as the keep test would give
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = da[kk][e] = 0u;
    } else {
      if (interior)
        dkv_grads_step<false, false>(p, hi, lo, s, dp, Ls, nullptr, r0, key_a, km, ks);
      else
        dkv_grads_step<true, kSeg>(p, hi, lo, s, dp, Ls, Ss, r0, key_a, km, ks);
      pack_a_frags(pa, s);
      pack_a_frags(da, dp);
    }

    // dv += bf16(p^T) do and dk += bf16(ds^T) q, B read down the tile's
    // rows; they run on into the next step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, pa[kk], gmma_desc(st + kTileBytes + kk * 2048), step > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk, da[kk], gmma_desc(st + kk * 2048), step > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait();
  reg_fence(dv);
  reg_fence(dk);
  reg_fence(pa);
  reg_fence(da);
  cp_async_wait<0>();
  if (n_steps == 0) {  // no row meets these keys
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
      dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
    }
  }
  store_rows_f32<64>(p.dv + kv_off, dv, key_a, p.Nk, t);
  store_rows_f32<64>(p.dk + kv_off, dk, key_a, p.Nk, t);
}

// ---------------------------------------------------------------------------
// bf16 dq: 128 query rows a block, the K/V tiles through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kDqThreads = 256;
constexpr int kDqAhead = 2;  // steps whose K/V tiles load ahead of the products
// stages in a warpgroup's ring: the step's, those ahead and the previous
// step's, which its dq product may still read
constexpr int kDqStages = kDqAhead + 2;
constexpr int kDqRingBytes = kDqStages * kKvStageBytes;
// The two warpgroups' rings (wgmma.cuh's KV stage), then the block's Q and
// dO tiles (128 rows each, swizzled), resident.
constexpr int kDqSmem = 2 * kDqRingBytes + 2 * kDqRows * 128 + 1024;  // + slack

// One key tile's ds (into dp, from s = q.k and dp = do.v) for this thread's
// rows row_a and row_a + 8 (fragment halves e >> 1) and the tile's keys
// j * 8 + 2t + (e & 1).  kEdge: the keep test of every pair (the band, the
// rows and keys past the end, the key mask bytes mb and, kSeg, the key ids
// kid against the rows' qs); without it every pair is kept, p = exp(s -
// lse) with no select.  lse2 is lse * log2(e).
template <bool kEdge, bool kSeg, bool kClamp>
__device__ __forceinline__ void dq_grads(const Params& p, int hi, int lo, const float (&s)[8][4],
                                         float (&dp)[8][4], const float (&lse2)[2],
                                         const float (&delta)[2], const uint8_t* mb,
                                         const int* kid, int c0, int row_a, const int (&qs)[2]) {
  const int t = threadIdx.x % 4;
  const float scale2 = p.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, key = j * 8 + 2 * t + (e & 1);  // key in the tile
      float pr, factor = p.scale;
      if constexpr (kClamp) {
        const float th = tanhf(s[j][e] * p.scale / p.softclamp);
        pr = exp2_ftz(p.softclamp * th * kLog2e - lse2[r]);
        factor *= 1.f - th * th;
      } else {
        pr = exp2_ftz(fmaf(s[j][e], scale2, -lse2[r]));
      }
      if constexpr (kEdge) {
        const int row = row_a + 8 * r, off = c0 + key - row;
        bool keep = off <= hi && off >= lo && row < p.Nq && c0 + key < p.Nk &&
                    (mb == nullptr || mb[key] != 0);
        if constexpr (kSeg) keep = keep && kid[key] == qs[r];
        pr = keep ? pr : 0.f;
      }
      dp[j][e] = pr * (dp[j][e] - delta[r]) * factor;
    }
  }
}

// dq_grads with the soft clamp chosen once per step, not per score.
template <bool kEdge, bool kSeg>
__device__ __forceinline__ void dq_grads_step(const Params& p, int hi, int lo,
                                              const float (&s)[8][4], float (&dp)[8][4],
                                              const float (&lse2)[2], const float (&delta)[2],
                                              const uint8_t* mb, const int* kid, int c0,
                                              int row_a, const int (&qs)[2]) {
  if (p.softclamp > 0.f)
    dq_grads<kEdge, kSeg, true>(p, hi, lo, s, dp, lse2, delta, mb, kid, c0, row_a, qs);
  else
    dq_grads<kEdge, kSeg, false>(p, hi, lo, s, dp, lse2, delta, mb, kid, c0, row_a, qs);
}

// The key tiles that a warpgroup's 64 rows from rw on meet; none when they
// all lie past Nq.
__device__ __forceinline__ void wg_key_tiles(const Params& p, int rw, int* t_begin,
                                             int* t_end) {
  *t_begin = *t_end = 0;
  if (rw < p.Nq) key_tiles(p, rw, kBlockM, kBlockN, t_begin, t_end);
}

template <bool kSeg, bool kDocs>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_bf16_kernel(const Params p, const Segs sg) {
  extern __shared__ unsigned char dq_smem[];
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(dq_smem) + 1023u) & ~1023u;
  unsigned char* base_ptr = dq_smem + (base - (uint32_t)__cvta_generic_to_shared(dq_smem));

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // heaviest first
  const size_t bh = blockIdx.y;
  const int b = (int)(bh / p.H), h = (int)(bh % p.H);
  const int kh = h / (p.H / p.Hk);
  const size_t kv_off = ((size_t)b * p.Hk + kh) * p.Nk * 64;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;
  const int* kseg = kSeg ? sg.kv + (size_t)b * p.Nk : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = r0 + (warp / 4) * 64;         // this warpgroup's first row
  const int row_a = rw + (warp % 4) * 16 + g;  // row of fragment halves 0, 1

  // the rows' lse (in log2 units), delta and (kSeg) ids, in registers
  float lse2[2], delta_r[2];
  int qs_r[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < p.Nq ? p.lse[bh * p.Nq + row] * kLog2e : 0.f;
    delta_r[r] = row < p.Nq ? p.delta[bh * p.Nq + row] : 0.f;
    if constexpr (kSeg) qs_r[r] = seg_at(sg.q + (size_t)b * p.Nq, row, p.Nq);
  }

  // each warpgroup walks its own key tiles through its own ring, synchronized
  // by a barrier of its own 128 threads, so that the two run out of step
  // (as B1's warpgroups do)
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const uint32_t ring = base + wg * kDqRingBytes;
  const unsigned char* ring_ptr = base_ptr + wg * kDqRingBytes;
  // this warpgroup's 64 rows of Q and dO, resident behind the rings: the A
  // operands of the first two products
  const uint32_t q_wg = base + 2 * kDqRingBytes + wg * 64 * 128, do_wg = q_wg + kDqRows * 128;
  load_swizzled<128>(q_wg, static_cast<const __nv_bfloat16*>(p.q) + bh * p.Nq * 64, rw, 64,
                     p.Nq, tid);
  load_swizzled<128>(do_wg, static_cast<const __nv_bfloat16*>(p.dout) + bh * p.Nq * 64, rw, 64,
                     p.Nq, tid);
  cp_async_commit();

  // the key tiles this warpgroup's rows meet
  int t_begin, t_end;
  wg_key_tiles(p, rw, &t_begin, &t_end);
  if constexpr (kDocs) {
    if (rw < p.Nq) doc_clip(sg.tiles, rw / 64, &t_begin, &t_end);
  }
  const int n_steps = t_end - t_begin;
  auto issue = [&](int step) {
    if (step < n_steps)
      load_kv_stage<128>(ring + (step % kDqStages) * kKvStageBytes, k, v, kvm, kseg,
                         (t_begin + step) * kBlockN, p.Nk, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kDqAhead; ++s) issue(s);

  // a tile runs the keep test only where a pair of it may be dropped: at
  // the band's edges, the ragged ends, under a key mask, and (kSeg) unless
  // the warpgroup's rows and the tile's keys all hold one document
  const int hi = p.causal ? p.hi : p.Nk;
  const int lo = p.causal && p.windowed ? p.lo : -p.Nq;
  int q_doc = 0;
  bool q_one_doc = false;  // every row of the warpgroup before Nq in one document
  if constexpr (kSeg) {
    const int* qseg = sg.q + (size_t)b * p.Nq;
    q_doc = seg_at(qseg, rw, p.Nq);
    q_one_doc = __all_sync(0xffffffffu,
                           (rw + lane >= p.Nq || qseg[rw + lane] == q_doc) &&
                               (rw + lane + 32 >= p.Nq || qseg[rw + lane + 32] == q_doc));
  }
  const bool open = kvm == nullptr && rw + 64 <= p.Nq && (!kSeg || q_one_doc);

  // dq: only the tensor cores write it until the store (the first product
  // overwrites), as dk and dv in the dk/dv pass
  float dq[8][4];
  // the A fragments of a step's dq product, read by the tensor cores until
  // the next step's wait
  uint32_t da[4][4];
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kDqAhead - 1>();
    fence_proxy_async();  // the landed tile, to the tensor cores' reads
    // the step's tile has landed for the whole warpgroup (named barrier
    // 1 + wg of 128 threads)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    issue(step + kDqAhead);  // into the slot of step - 2, whose products are done
    const uint32_t st = ring + (step % kDqStages) * kKvStageBytes;
    const unsigned char* stp = ring_ptr + (step % kDqStages) * kKvStageBytes;
    const int c0 = (t_begin + step) * kBlockN;

    // s = q k^T and dp = do v^T: each warpgroup's 64 rows x 64 keys
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, gmma_desc(q_wg + kk * 32), gmma_desc(st + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, gmma_desc(do_wg + kk * 32), gmma_desc(st + kKvTileBytes + kk * 32), kk);
    wgmma_commit();
    // meanwhile: does the tile need the keep test?
    const int* kid = reinterpret_cast<const int*>(stp + kKvIdsOff);
    bool interior = open && c0 + kBlockN <= p.Nk && c0 + kBlockN - 1 - rw <= hi &&
                    c0 - (rw + 63) >= lo;
    bool dropped = false;  // no pair kept: every key of another document
    if constexpr (kSeg) {
      const int k_doc = kid[0];
      const bool k_one_doc =
          __all_sync(0xffffffffu, (c0 + lane >= p.Nk || kid[lane] == k_doc) &&
                                      (c0 + lane + 32 >= p.Nk || kid[lane + 32] == k_doc));
      interior = interior && k_one_doc && k_doc == q_doc;
      dropped = q_one_doc && k_one_doc && k_doc != q_doc;
    }
    wgmma_wait();  // this step's s and dp, the previous step's dq
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dq);
    reg_fence(da);
    if (dropped) {
      // ds = 0 exactly, as the keep test would give (dp is finite): computed,
      // not written as a constant, which made ptxas serialize every wgmma
      // of the loop (C7513)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] *= 0.f;
    } else {
      const uint8_t* mb = kvm ? kv_mask_bytes(stp, kvm, c0) : nullptr;
      if (interior)
        dq_grads_step<false, false>(p, hi, lo, s, dp, lse2, delta_r, mb, kid, c0, row_a, qs_r);
      else
        dq_grads_step<true, kSeg>(p, hi, lo, s, dp, lse2, delta_r, mb, kid, c0, row_a, qs_r);
    }
    pack_a_frags(da, dp);

    // dq += bf16(ds) k, B read down the K tile's rows; it runs on into the
    // next step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dq, da[kk], gmma_desc(st + kk * 2048), step > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait();
  reg_fence(dq);
  reg_fence(da);
  cp_async_wait<0>();
  if (n_steps == 0) {  // no key meets these rows
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
  }
  store_rows_f32<64>(p.dq + bh * p.Nq * 64, dq, row_a, p.Nq, t);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

// One key per thread: its K and V rows sit in shared memory with a padded
// stride (conflict-free), query rows are read by every thread (broadcast).
template <int D, bool kSeg, bool kDocs>
__global__ void __launch_bounds__(kBlockN)
    flash_bwd_dkv_f32_kernel(const Params p, const Segs sg) {
  constexpr int kKV = D + 1;
  __shared__ float Ks[kBlockN * kKV];
  __shared__ float Vs[kBlockN * kKV];
  __shared__ __align__(16) float Qs[kRowsF32 * D];
  __shared__ __align__(16) float Ds[kRowsF32 * D];
  __shared__ float Ls[kRowsF32];
  __shared__ float Es[kRowsF32];
  __shared__ int Ss[kSeg ? kRowsF32 : 1];  // document ids of the step's rows

  const int c0 = blockIdx.x * kBlockN;
  const int bkh = blockIdx.y;
  const int b = bkh / p.Hk, kh = bkh % p.Hk;
  const int group = p.H / p.Hk;
  const size_t kv_off = (size_t)bkh * p.Nk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;
  const int key = c0 + threadIdx.x;
  const int ks = kSeg ? seg_at(sg.kv + (size_t)b * p.Nk, key, p.Nk) : 0;

  for (int i = threadIdx.x; i < kBlockN * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = c0 + r < p.Nk;
    Ks[r * kKV + c] = in ? k[(size_t)(c0 + r) * D + c] : 0.f;
    Vs[r * kKV + c] = in ? v[(size_t)(c0 + r) * D + c] : 0.f;
  }
  const float* kr = Ks + threadIdx.x * kKV;
  const float* vr = Vs + threadIdx.x * kKV;

  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  int t_begin, t_end;
  query_tiles(p, c0, kRowsF32, kBlockN, &t_begin, &t_end);
  if constexpr (kDocs) doc_clip(sg.tiles, c0 / kBlockN, &t_begin, &t_end);
  for (int hq = 0; hq < group; ++hq) {
    const size_t bh = (size_t)b * p.H + kh * group + hq;
    const float* q = static_cast<const float*>(p.q) + bh * p.Nq * D;
    const float* dout = static_cast<const float*>(p.dout) + bh * p.Nq * D;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int r0 = tile * kRowsF32;
      __syncthreads();
      for (int i = threadIdx.x; i < kRowsF32 * D; i += blockDim.x) {
        const bool in = r0 + i / D < p.Nq;
        Qs[i] = in ? q[(size_t)r0 * D + i] : 0.f;
        Ds[i] = in ? dout[(size_t)r0 * D + i] : 0.f;
      }
      for (int i = threadIdx.x; i < kRowsF32; i += blockDim.x) {
        const bool in = r0 + i < p.Nq;
        Ls[i] = in ? p.lse[bh * p.Nq + r0 + i] : 0.f;
        Es[i] = in ? p.delta[bh * p.Nq + r0 + i] : 0.f;
        if constexpr (kSeg) Ss[i] = seg_at(sg.q + (size_t)b * p.Nq, r0 + i, p.Nq);
      }
      __syncthreads();
      for (int i = 0; i < kRowsF32; ++i) {
        const float* qi = Qs + i * D;
        const float* di = Ds + i * D;
        float qk = 0.f, dov = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qk = fmaf(qi[d], kr[d], qk);
          dov = fmaf(di[d], vr[d], dov);
        }
        float pr, ds;
        grad_pair(p, kSeg ? kept_seg(p, kvm, r0 + i, key, Ss[i], ks) : kept(p, kvm, r0 + i, key),
                  qk, dov, Ls[i], Es[i], &pr, &ds);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] = fmaf(pr, di[d], dv[d]);
          dk[d] = fmaf(ds, qi[d], dk[d]);
        }
      }
    }
  }
  if (key >= p.Nk) return;
  float* dk_out = p.dk + kv_off + (size_t)key * D;
  float* dv_out = p.dv + kv_off + (size_t)key * D;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(dk_out + d) =
        make_float4(dk[d], dk[d + 1], dk[d + 2], dk[d + 3]);
    *reinterpret_cast<float4*>(dv_out + d) =
        make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]);
  }
}

// One query row per thread: its q and do rows sit in shared memory with a
// padded stride, key rows are read by every thread (broadcast).
template <int D, bool kSeg, bool kDocs>
__global__ void __launch_bounds__(kBlockM)
    flash_bwd_dq_f32_kernel(const Params p, const Segs sg) {
  constexpr int kRow = D + 1;
  __shared__ float Qs[kBlockM * kRow];
  __shared__ float Ds[kBlockM * kRow];
  __shared__ __align__(16) float Ks[kKeysF32 * D];
  __shared__ __align__(16) float Vs[kKeysF32 * D];
  __shared__ int Kid[kSeg ? kKeysF32 : 1];  // document ids of the step's keys

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t bh = blockIdx.y;
  const int b = (int)(bh / p.H), h = (int)(bh % p.H);
  const int kh = h / (p.H / p.Hk);
  const size_t kv_off = ((size_t)b * p.Hk + kh) * p.Nk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;
  const float* q = static_cast<const float*>(p.q) + bh * p.Nq * D;
  const float* dout = static_cast<const float*>(p.dout) + bh * p.Nq * D;
  const int row = r0 + threadIdx.x;

  for (int i = threadIdx.x; i < kBlockM * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < p.Nq;
    Qs[r * kRow + c] = in ? q[(size_t)(r0 + r) * D + c] : 0.f;
    Ds[r * kRow + c] = in ? dout[(size_t)(r0 + r) * D + c] : 0.f;
  }
  const float* qr = Qs + threadIdx.x * kRow;
  const float* dr = Ds + threadIdx.x * kRow;
  const float lse = row < p.Nq ? p.lse[bh * p.Nq + row] : 0.f;
  const float delta = row < p.Nq ? p.delta[bh * p.Nq + row] : 0.f;
  const int qs = kSeg ? seg_at(sg.q + (size_t)b * p.Nq, row, p.Nq) : 0;
  const int* kseg = kSeg ? sg.kv + (size_t)b * p.Nk : nullptr;

  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  int t_begin, t_end;
  key_tiles(p, r0, kBlockM, kKeysF32, &t_begin, &t_end);
  if constexpr (kDocs) doc_clip(sg.tiles, r0 / kBlockM, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * kKeysF32;
    __syncthreads();
    for (int i = threadIdx.x; i < kKeysF32 * D; i += blockDim.x) {
      const bool in = c0 + i / D < p.Nk;
      Ks[i] = in ? k[(size_t)c0 * D + i] : 0.f;
      Vs[i] = in ? v[(size_t)c0 * D + i] : 0.f;
    }
    if constexpr (kSeg) {
      for (int i = threadIdx.x; i < kKeysF32; i += blockDim.x) Kid[i] = seg_at(kseg, c0 + i, p.Nk);
    }
    __syncthreads();
    for (int jj = 0; jj < kKeysF32; ++jj) {
      const float* kj = Ks + jj * D;
      const float* vj = Vs + jj * D;
      float qk = 0.f, dov = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qk = fmaf(qr[d], kj[d], qk);
        dov = fmaf(dr[d], vj[d], dov);
      }
      float pr, ds;
      grad_pair(p,
                kSeg ? kept_seg(p, kvm, row, c0 + jj, qs, Kid[jj]) : kept(p, kvm, row, c0 + jj),
                qk, dov, lse, delta, &pr, &ds);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
    }
  }
  if (row >= p.Nq) return;
  float* out = p.dq + (bh * p.Nq + row) * D;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(out + d) =
        make_float4(dq[d], dq[d + 1], dq[d + 2], dq[d + 3]);
}

int fill_params(Params* p, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* kv_mask, int B, int H, int Hk, int Nq, int Nk,
                int D, float scale, int causal, int hi, int windowed, int lo,
                float softclamp) {
  if (D != 64 || Hk <= 0 || H % Hk != 0 || Nq <= 0 || Nk <= 0) return 0;
  p->q = q;
  p->k = k;
  p->v = v;
  p->dout = dout;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->kv_mask = static_cast<const uint8_t*>(kv_mask);
  p->dq = nullptr;
  p->dk = nullptr;
  p->dv = nullptr;
  p->B = B;
  p->H = H;
  p->Hk = Hk;
  p->Nq = Nq;
  p->Nk = Nk;
  p->scale = scale;
  p->causal = causal;
  p->hi = hi;
  p->windowed = windowed;
  p->lo = lo;
  p->softclamp = softclamp;
  return 1;
}

}  // namespace

// C entry points, bound with ctypes.  Each enqueues one launch on `stream`
// and returns cudaGetLastError() (0 = launched).  They allocate nothing: the
// caller passes contiguous tensors and preallocated float32 outputs.
// (q_seg, kv_seg), both set, runs the segmented kernels; both null, the
// unsegmented ones.  doc_tiles, a declared packing's doc-tile table for the
// pass's own blocks, runs the kDocs kernels; it goes with no ids.

// dk, dv: (B, Hk, Nk, D) float32, fully written (zero where no row attends).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kv_mask, void* dk,
                             void* dv, int B, int H, int Hk, int Nq, int Nk,
                             int D, int is_bf16, float scale, int causal,
                             int hi, int windowed, int lo, float softclamp,
                             const void* q_seg, const void* kv_seg,
                             const void* doc_tiles, void* stream) {
  Params p;
  if (!fill_params(&p, q, k, v, dout, lse, delta, kv_mask, B, H, Hk, Nq, Nk,
                   D, scale, causal, hi, windowed, lo, softclamp) ||
      (q_seg == nullptr) != (kv_seg == nullptr) || (q_seg != nullptr && doc_tiles != nullptr))
    return (int)cudaErrorInvalidValue;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                static_cast<const int*>(doc_tiles)};
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto kernel = q_seg != nullptr       ? flash_bwd_dkv_bf16_kernel<true, false>
                        : doc_tiles != nullptr ? flash_bwd_dkv_bf16_kernel<false, true>
                                               : flash_bwd_dkv_bf16_kernel<false, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((Nk + kDkvKeys - 1) / kDkvKeys, B * Hk), kDkvThreads, kDkvSmem, s>>>(p, sg);
    return (int)cudaGetLastError();
  }
  const dim3 grid((Nk + kBlockN - 1) / kBlockN, B * Hk);
  if (q_seg != nullptr)
    flash_bwd_dkv_f32_kernel<64, true, false><<<grid, kBlockN, 0, s>>>(p, sg);
  else if (doc_tiles != nullptr)
    flash_bwd_dkv_f32_kernel<64, false, true><<<grid, kBlockN, 0, s>>>(p, sg);
  else
    flash_bwd_dkv_f32_kernel<64, false, false><<<grid, kBlockN, 0, s>>>(p, sg);
  return (int)cudaGetLastError();
}

// dq: (B, H, Nq, D) float32, fully written (zero for a row with no key).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_mask, void* dq,
                            int B, int H, int Hk, int Nq, int Nk, int D,
                            int is_bf16, float scale, int causal, int hi,
                            int windowed, int lo, float softclamp,
                            const void* q_seg, const void* kv_seg,
                            const void* doc_tiles, void* stream) {
  Params p;
  if (!fill_params(&p, q, k, v, dout, lse, delta, kv_mask, B, H, Hk, Nq, Nk,
                   D, scale, causal, hi, windowed, lo, softclamp) ||
      (q_seg == nullptr) != (kv_seg == nullptr) || (q_seg != nullptr && doc_tiles != nullptr))
    return (int)cudaErrorInvalidValue;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                static_cast<const int*>(doc_tiles)};
  p.dq = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto kernel = q_seg != nullptr       ? flash_bwd_dq_bf16_kernel<true, false>
                        : doc_tiles != nullptr ? flash_bwd_dq_bf16_kernel<false, true>
                                               : flash_bwd_dq_bf16_kernel<false, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((Nq + kDqRows - 1) / kDqRows, B * H), kDqThreads, kDqSmem, s>>>(p, sg);
    return (int)cudaGetLastError();
  }
  const dim3 grid((Nq + kBlockM - 1) / kBlockM, B * H);
  if (q_seg != nullptr)
    flash_bwd_dq_f32_kernel<64, true, false><<<grid, kBlockM, 0, s>>>(p, sg);
  else if (doc_tiles != nullptr)
    flash_bwd_dq_f32_kernel<64, false, true><<<grid, kBlockM, 0, s>>>(p, sg);
  else
    flash_bwd_dq_f32_kernel<64, false, false><<<grid, kBlockM, 0, s>>>(p, sg);
  return (int)cudaGetLastError();
}
