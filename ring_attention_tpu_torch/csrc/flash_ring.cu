// Fused ring forward, local tier, for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_ring.py::fused_ring_local (the
// pl.pallas_call at :341; kernel body _fused_local_kernel :116) for float
// operands.  Its int8 feed (kv_quantized) and segment ids are not ported
// here.
//
// What it computes, for q (B, H, N, D) of one ring rank and the gathered
// k_all, v_all (B, Hk, Ntot, D), rank-major (rank o's block is rows
// [o * N, (o + 1) * N)), contiguous:
//   for hop = 0 .. hops - 1 with works[hop] != 0, the keys of rank
//   origins[hop] in local coordinates j in [0, N):
//     s    = scale * q . k, then softclamp c * tanh(s / c) when c > 0;
//     keep = los[hop] <= j - i <= his[hop] && (kv_mask == null ||
//            kv_mask[b, origins[hop] * N + j]);
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
// whose works flag is 0 is skipped, and within a hop a block takes the
// forward kernel's tile range (band_tiles in flash_tile.cuh) from
// the hop's band.  A block holding a row with an empty band visits every
// tile of that hop, so a row that sees no live key in the whole walk (an
// all-False key-mask row, a band edge) averages V over the same keys as
// the chain.  At each hop's end the bf16 kernel sums l over a row's 4
// threads and seeds one of them with it, as a resumed launch of the chain
// does, so the sums run in the chain's order.
//
// What bounds it on an H100: rank 3 of a causal ring of 4 at 262,144
// tokens (N 65,536, h 8, d 64) does 3.08e13 operations on 0.27 GB of
// inputs: far above the card's ~295 bf16 operations per byte, so it is
// bound by tensor-core operations (31.1 ms at 989 TFLOP/s).  The hop chain
// it replaces also reads and writes the f32 carry (D + 2 floats a row) at
// every hop boundary, 0.1 ms of its 379 ms at 3.35 TB/s; keeping the carry
// in registers saves that and the per-hop launches, not more.
//
// Design (right and simple first; the tile body is flash_tile.cuh's, shared
// with flash_ring_remote.cu):
//   * one thread block per (64-row Q tile, b*h) of the rank; blocks run
//     heaviest causal rows first.  The block loops over hops and, in each
//     live hop, over the 64-key tiles of the origin's block in the gathered
//     span;
//   * bf16: 4 warps, mma.sync.m16n8k16 (bf16 in, f32 accumulate), score
//     tile, p and the output accumulator in registers; p is rounded to
//     bf16 for the PV product;
//   * f32: 64 threads, one query row each, plain FMA (exact f32);
//   * the hop tables are four int32 device arrays read by every thread;
//   * offsets into the gathered span are 64-bit: at 262,144 tokens, hk 8
//     and d 64 one batch row of k_all holds 1.3e8 elements.
// The bf16 kernel keeps flash_fwd.cu's __launch_bounds__(128, 4): four
// blocks an SM fit only at 128 registers or fewer.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation.

#include "flash_tile.cuh"

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

// Hop `hop`'s band in flash_tile.cuh's form, in the hop's local coordinates;
// kvm points at the hop's block of the key mask.
__device__ __forceinline__ Band hop_band(const Params& p, int hop, const uint8_t* kvm) {
  return Band{p.his[hop], p.los[hop], p.N, kvm, p.scale, p.softclamp};
}

template <int D>
__global__ void __launch_bounds__(128, 4)
    flash_ring_bf16_kernel(const Params p) {
  constexpr int kStride = D + 8;  // staggers shared-memory banks
  __shared__ __align__(16) __nv_bfloat16 Qs[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * kStride];

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.N * D;
  const size_t kv_off = ((size_t)b * p.Hk + kh) * (size_t)p.Ntot * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group id and thread in group
  const int row_a = r0 + warp * 16 + g;  // local row of fragment halves 0, 1
  const int row_b = row_a + 8;           // and of halves 2, 3

  // the online-softmax state in fragment layout (flash_tile.cuh)
  float o[D / 8][4];
  float m_r[2] = {kMaskValue, kMaskValue};
  float l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  load_tile_bf16<D>(Qs, q, r0, p.N);
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_q_frags<D>(Qs, qf);

  for (int hop = 0; hop < p.hops; ++hop) {
    if (p.works[hop] == 0) continue;  // the chain launches nothing here
    const size_t span = (size_t)p.origins[hop] * p.N;  // the origin's first key
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off + span * D;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off + span * D;
    const uint8_t* kvm =
        p.kv_mask ? p.kv_mask + (size_t)b * p.Ntot + span : nullptr;
    const Band bd = hop_band(p, hop, kvm);
    int t_begin, t_end;
    band_tiles(bd, p.N, r0, &t_begin, &t_end);
    for (int tile = t_begin; tile < t_end; ++tile)
      bf16_tile<D>(Ks, Vs, k, v, bd, tile * kBlockN, qf, o, m_r, l_r, row_a);

    // the hop's end: a launch of the chain sums l over the row's 4 threads
    // and the next one seeds thread 0 with it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      if (t != 0) l_r[r] = 0.f;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // only thread 0 of the row holds its sum now: adding the zeros is exact
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = r == 0 ? row_a : row_b;
    if (row >= p.N) continue;
    store_out_bf16<D>(static_cast<__nv_bfloat16*>(p.out), p.lse,
                      (size_t)bh * p.N + row, o, r, m_r[r], l_r[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockM)
    flash_ring_f32_kernel(const Params p) {
  __shared__ __align__(16) float Ks[kBlockN * D];
  __shared__ __align__(16) float Vs[kBlockN * D];

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.Hk);
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.N * D;
  const size_t kv_off = ((size_t)b * p.Hk + kh) * (size_t)p.Ntot * D;
  const int row = r0 + threadIdx.x;

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
    int t_begin, t_end;
    band_tiles(bd, p.N, r0, &t_begin, &t_end);
    for (int tile = t_begin; tile < t_end; ++tile)
      f32_tile<D>(Ks, Vs, k, v, bd, tile * kBlockN, qv, acc, m, l, row);
  }

  if (row >= p.N) return;
  store_out_f32<D>(static_cast<float*>(p.out), p.lse, (size_t)bh * p.N + row, acc, m, l);
}

}  // namespace

// C entry point, bound with ctypes.  Enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).  Allocates nothing: the caller
// passes contiguous tensors, the four int32 hop tables on the device and
// the preallocated out and lse.  Every origin must lie in [0, Ntot / N).
extern "C" int flash_ring(const void* q, const void* k_all, const void* v_all,
                          const void* kv_mask, const void* origins,
                          const void* his, const void* los, const void* works,
                          int hops, void* out, void* lse, int B, int H, int Hk,
                          int N, int Ntot, int D, int is_bf16, float scale,
                          float softclamp, void* stream) {
  if (D != 64 || Hk <= 0 || H % Hk != 0 || N <= 0 || Ntot % N != 0 ||
      hops <= 0 || origins == nullptr || his == nullptr || los == nullptr ||
      works == nullptr || out == nullptr || lse == nullptr)
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
  const dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_ring_bf16_kernel<64><<<grid, 128, 0, s>>>(p);
  else
    flash_ring_f32_kernel<64><<<grid, kBlockM, 0, s>>>(p);
  return (int)cudaGetLastError();
}
