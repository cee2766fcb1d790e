// Backward flash-attention passes for NVIDIA Hopper (built for sm_90a).
//
// Replaces the two launches of ring_attention_tpu/ops/pallas_flash.py::
// pallas_flash_backward (:1848):
//   * flash_bwd_dkv: the dk/dv pass, pl.pallas_call at :2108 (kernel bodies
//     _bwd_dkv_kernel :1691, _dkv_tile :1727);
//   * flash_bwd_dq: the dq pass, pl.pallas_call at :2186 (_bwd_dq_kernel
//     :1774, _dq_tile :1808);
// both with the runtime segment ids of _bwd_parse_refs (:1649) and
// _tile_keep (:240).
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
// Design (right and simple first):
//   * dk/dv: one thread block per (64-key tile, b*hk).  It loops over the
//     g = H / Hk query heads of its group and over the 64-row query tiles
//     that meet the band, so dk and dv accumulate in f32 registers across
//     the whole group and are written once: no per-head buffer, no atomics.
//   * dq: one thread block per (64-row query tile, b*h), looping over the
//     key tiles that meet the band; heaviest causal rows first.
//   * each block computes its own tile range from (lo, hi): the counterpart
//     of the TPU compact band grid and its scalar-prefetched tables.  Tiles
//     outside the band hold only p = 0 and are skipped exactly.
//   * bf16: 4 warps, each owns 16 keys (dk/dv) or 16 query rows (dq).  All
//     products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate); scores,
//     p and ds stay in registers, and an accumulator fragment becomes the A
//     fragment of the next product without touching shared memory.
//   * f32: 64 threads, one key (dk/dv) or one query row (dq) per thread,
//     plain FMA on CUDA cores, so the card can be held tightly to the CPU;
//   * packed sequences (q_seg, kv_seg int32 document ids, a kernel argument
//     of their own) run a second instantiation of each kernel (kSeg): the
//     document test sits in kept_seg() beside the key mask, each thread's
//     fixed-side ids in registers, the other side's ids in shared memory
//     beside the tile they belong to (the query rows' beside lse and delta
//     for dk/dv, the keys' beside K and V for dq).  The same tiles are
//     visited as without ids, and the unsegmented kernels compile as
//     before.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// read by the kSeg instantiations only.
struct Segs {
  const int* q;
  const int* kv;
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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as bf16x2; the first lands in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into shared memory with a
// row stride of D + 8 elements; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

// A fragments (16 rows x D) of this warp's rows of a tile in shared memory.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (*frag)[4],
                                             const __nv_bfloat16* tile,
                                             int warp, int g, int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = tile + (warp * 16 + g) * kStride + kk * 16 + t * 2;
    frag[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    frag[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    frag[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    frag[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
}

// c[j] += A . X^T over D, for the 8 groups of 8 rows of X (a 64 x D tile in
// shared memory): the B operand reads X row-major, i.e. X^T column-major.
template <int D>
__device__ __forceinline__ void mma_abt(float (*c)[4], const uint32_t (*a)[4],
                                        const __nv_bfloat16* x, int g, int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* xb = x + (j * 8 + g) * kStride + kk * 16 + t * 2;
      const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(xb),
                              *reinterpret_cast<const uint32_t*>(xb + 8)};
      mma_16816(c[j], a[kk], bf);
    }
  }
}

// acc[nd] += P . X over 64 rows of X (a 64 x D tile in shared memory), where
// P is 16 x 64 held as the accumulator fragments `pc` of an earlier product,
// rounded to bf16 here.
template <int D>
__device__ __forceinline__ void mma_px(float (*acc)[4], const float (*pc)[4],
                                       const __nv_bfloat16* x, int g, int t) {
  constexpr int kStride = D + 8;
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(pc[2 * kk][0], pc[2 * kk][1]),
                           pack_bf16(pc[2 * kk][2], pc[2 * kk][3]),
                           pack_bf16(pc[2 * kk + 1][0], pc[2 * kk + 1][1]),
                           pack_bf16(pc[2 * kk + 1][2], pc[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const uint16_t* xb = raw + (kk * 16 + t * 2) * kStride + nd * 8 + g;
      const uint32_t bf[2] = {pack_raw(xb[0], xb[kStride]),
                              pack_raw(xb[8 * kStride], xb[9 * kStride])};
      mma_16816(acc[nd], a, bf);
    }
  }
}

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

template <int D, bool kSeg>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_bf16_kernel(const Params p, const Segs sg) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 Ds[kBlockM * kStride];  // dO
  __shared__ float Ls[kBlockM];  // lse of the tile's rows
  __shared__ float Es[kBlockM];  // delta of the tile's rows
  __shared__ int Ss[kSeg ? kBlockM : 1];  // document ids of the tile's rows

  const int c0 = blockIdx.x * kBlockN;  // causal: heaviest key tiles first
  const int bkh = blockIdx.y;
  const int b = bkh / p.Hk, kh = bkh % p.Hk;
  const int group = p.H / p.Hk;
  const size_t kv_off = (size_t)bkh * p.Nk * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = c0 + warp * 16 + g;  // key of fragment halves 0, 1
  int ks_r[2] = {0, 0};  // document ids of keys key_a and key_a + 8
  if constexpr (kSeg) {
    ks_r[0] = seg_at(sg.kv + (size_t)b * p.Nk, key_a, p.Nk);
    ks_r[1] = seg_at(sg.kv + (size_t)b * p.Nk, key_a + 8, p.Nk);
  }

  // this warp's 16 keys of K and V as A fragments, staged through Qs / Ds
  load_tile_bf16<D>(Qs, k, c0, p.Nk);
  load_tile_bf16<D>(Ds, v, c0, p.Nk);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, Qs, warp, g, t);
  load_a_frags<D>(vf, Ds, warp, g, t);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  int t_begin, t_end;
  query_tiles(p, c0, kBlockM, kBlockN, &t_begin, &t_end);
  for (int hq = 0; hq < group; ++hq) {
    const size_t bh = (size_t)b * p.H + kh * group + hq;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + bh * p.Nq * D;
    const __nv_bfloat16* dout =
        static_cast<const __nv_bfloat16*>(p.dout) + bh * p.Nq * D;
    const float* lse = p.lse + bh * p.Nq;
    const float* delta = p.delta + bh * p.Nq;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int r0 = tile * kBlockM;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile_bf16<D>(Qs, q, r0, p.Nq);
      load_tile_bf16<D>(Ds, dout, r0, p.Nq);
      for (int i = threadIdx.x; i < kBlockM; i += blockDim.x) {
        const bool in = r0 + i < p.Nq;
        Ls[i] = in ? lse[r0 + i] : 0.f;
        Es[i] = in ? delta[r0 + i] : 0.f;
        if constexpr (kSeg) Ss[i] = seg_at(sg.q + (size_t)b * p.Nq, r0 + i, p.Nq);
      }
      __syncthreads();

      // sT = k q^T and dpT = v do^T: 16 keys x 64 query rows per warp
      float s[8][4], dp[8][4];
      mma_abt<D>(s, kf, Qs, g, t);
      mma_abt<D>(dp, vf, Ds, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_a + (e >> 1) * 8;
          const int i = j * 8 + t * 2 + (e & 1);  // query row in the tile
          float pr, ds;
          grad_pair(p,
                    kSeg ? kept_seg(p, kvm, r0 + i, key, Ss[i], ks_r[e >> 1])
                         : kept(p, kvm, r0 + i, key),
                    s[j][e], dp[j][e], Ls[i], Es[i], &pr, &ds);
          s[j][e] = pr;
          dp[j][e] = ds;
        }
      }
      mma_px<D>(dv, s, Ds, g, t);   // dv += bf16(p^T) do
      mma_px<D>(dk, dp, Qs, g, t);  // dk += bf16(ds^T) q
    }
  }
  store_rows_f32<D>(p.dv + kv_off, dv, key_a, p.Nk, t);
  store_rows_f32<D>(p.dk + kv_off, dk, key_a, p.Nk, t);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const Params p, const Segs sg) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * kStride];
  __shared__ int Kid[kSeg ? kBlockN : 1];  // document ids of the tile's keys

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest first
  const size_t bh = blockIdx.y;
  const int b = (int)(bh / p.H), h = (int)(bh % p.H);
  const int kh = h / (p.H / p.Hk);
  const size_t kv_off = ((size_t)b * p.Hk + kh) * p.Nk * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (size_t)b * p.Nk : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = r0 + warp * 16 + g;  // row of fragment halves 0, 1

  float lse_r[2], delta_r[2];
  int qs_r[2] = {0, 0};  // document ids of rows row_a and row_a + 8
  const int* kseg = kSeg ? sg.kv + (size_t)b * p.Nk : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse_r[r] = row < p.Nq ? p.lse[bh * p.Nq + row] : 0.f;
    delta_r[r] = row < p.Nq ? p.delta[bh * p.Nq + row] : 0.f;
    if constexpr (kSeg) qs_r[r] = seg_at(sg.q + (size_t)b * p.Nq, row, p.Nq);
  }

  // this warp's 16 rows of q and do as A fragments, staged through Ks / Vs
  load_tile_bf16<D>(Ks, static_cast<const __nv_bfloat16*>(p.q) + bh * p.Nq * D,
                    r0, p.Nq);
  load_tile_bf16<D>(Vs, static_cast<const __nv_bfloat16*>(p.dout) + bh * p.Nq * D,
                    r0, p.Nq);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(qf, Ks, warp, g, t);
  load_a_frags<D>(df, Vs, warp, g, t);

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  int t_begin, t_end;
  key_tiles(p, r0, kBlockM, kBlockN, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(Ks, k, c0, p.Nk);
    load_tile_bf16<D>(Vs, v, c0, p.Nk);
    if constexpr (kSeg) {
      for (int i = threadIdx.x; i < kBlockN; i += blockDim.x) Kid[i] = seg_at(kseg, c0 + i, p.Nk);
    }
    __syncthreads();

    // s = q k^T and dp = do v^T: 16 query rows x 64 keys per warp
    float s[8][4], dp[8][4];
    mma_abt<D>(s, qf, Ks, g, t);
    mma_abt<D>(dp, df, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = c0 + j * 8 + t * 2 + (e & 1);
        float pr, ds;
        grad_pair(p,
                  kSeg ? kept_seg(p, kvm, row_a + 8 * r, col, qs_r[r],
                                  Kid[j * 8 + t * 2 + (e & 1)])
                       : kept(p, kvm, row_a + 8 * r, col),
                  s[j][e], dp[j][e], lse_r[r], delta_r[r], &pr, &ds);
        s[j][e] = ds;
      }
    }
    mma_px<D>(dq, s, Ks, g, t);  // dq += bf16(ds) k
  }
  store_rows_f32<D>(p.dq + bh * p.Nq * D, dq, row_a, p.Nq, t);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

// One key per thread: its K and V rows sit in shared memory with a padded
// stride (conflict-free), query rows are read by every thread (broadcast).
template <int D, bool kSeg>
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
template <int D, bool kSeg>
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
// unsegmented ones.

// dk, dv: (B, Hk, Nk, D) float32, fully written (zero where no row attends).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kv_mask, void* dk,
                             void* dv, int B, int H, int Hk, int Nq, int Nk,
                             int D, int is_bf16, float scale, int causal,
                             int hi, int windowed, int lo, float softclamp,
                             const void* q_seg, const void* kv_seg, void* stream) {
  Params p;
  if (!fill_params(&p, q, k, v, dout, lse, delta, kv_mask, B, H, Hk, Nq, Nk,
                   D, scale, causal, hi, windowed, lo, softclamp) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg)};
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  const dim3 grid((Nk + kBlockN - 1) / kBlockN, B * Hk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && q_seg != nullptr)
    flash_bwd_dkv_bf16_kernel<64, true><<<grid, 128, 0, s>>>(p, sg);
  else if (is_bf16)
    flash_bwd_dkv_bf16_kernel<64, false><<<grid, 128, 0, s>>>(p, sg);
  else if (q_seg != nullptr)
    flash_bwd_dkv_f32_kernel<64, true><<<grid, kBlockN, 0, s>>>(p, sg);
  else
    flash_bwd_dkv_f32_kernel<64, false><<<grid, kBlockN, 0, s>>>(p, sg);
  return (int)cudaGetLastError();
}

// dq: (B, H, Nq, D) float32, fully written (zero for a row with no key).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_mask, void* dq,
                            int B, int H, int Hk, int Nq, int Nk, int D,
                            int is_bf16, float scale, int causal, int hi,
                            int windowed, int lo, float softclamp,
                            const void* q_seg, const void* kv_seg, void* stream) {
  Params p;
  if (!fill_params(&p, q, k, v, dout, lse, delta, kv_mask, B, H, Hk, Nq, Nk,
                   D, scale, causal, hi, windowed, lo, softclamp) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg)};
  p.dq = static_cast<float*>(dq);
  const dim3 grid((Nq + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && q_seg != nullptr)
    flash_bwd_dq_bf16_kernel<64, true><<<grid, 128, 0, s>>>(p, sg);
  else if (is_bf16)
    flash_bwd_dq_bf16_kernel<64, false><<<grid, 128, 0, s>>>(p, sg);
  else if (q_seg != nullptr)
    flash_bwd_dq_f32_kernel<64, true><<<grid, kBlockM, 0, s>>>(p, sg);
  else
    flash_bwd_dq_f32_kernel<64, false><<<grid, kBlockM, 0, s>>>(p, sg);
  return (int)cudaGetLastError();
}
