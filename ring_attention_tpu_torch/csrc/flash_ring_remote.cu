// Fused ring forward, remote tier, for NVIDIA Hopper (built for sm_90a).
//
// Replaces: ring_attention_tpu/ops/pallas_ring.py::fused_ring_remote (the
// pl.pallas_call at :866; kernel body _fused_remote_kernel :523) for float
// operands, and its int8 wire (payload=, :789-815) in a kernel of its own
// (flash_ring_remote_q8, at the end of this file).
//
// What it computes, for every rank r of a ring of W, from q_r (B, H, N, D)
// and the rank's own k_r, v_r (B, Hk, N, D) alone: for hop = 0 .. hops - 1
// with works[r][hop] != 0, the keys of origin (r - hop) mod W in local
// coordinates j in [0, N):
//   s    = scale * q . k, then softclamp c * tanh(s / c) when c > 0;
//   keep = los[r][hop] <= j - i <= his[r][hop]  (sentinels +-N: unbanded);
//   masked scores take the FINITE mask value -0.5 * f32 max;
// the online-softmax state (acc, m, l) in f32 carries across the hops, and
// out_r = acc / max(l, 1e-10) in q's dtype, lse_r = m + log(max(l, 1e-10))
// in f32.  That is flash_ring.cu's function (B7) over a gathered span, and
// the port's hop chain (parallel/ring.py, impl="cuda"); no gathered copy is
// made here: each rank's KV travels around the ring inside the launch.
//
// One cooperative launch holds every rank.  The blocks of the grid are
// split into W groups, one per rank (cta_start), all resident on the card
// at once, so that blocks of different ranks can wait on each other.  The
// wrapper sizes the groups from each rank's work per hop (the grant couples
// neighbours hop by hop, so a split that evens total work is not the
// fastest: ops/cuda_ring_remote.py::balanced_split); a grid the card
// cannot hold at once is refused, never shrunk.  Per rank, in global
// memory: a double-buffered slot pair (2 slots x {k, v} x (B, Hk, N, D)),
// an f32 carry spill (acc (B*H, N, D), m and l (B*H, N)), and one counter
// word per hop for each of three flags (landed, grant, done), zeroed by
// the wrapper before the launch.  Per hop, each block of rank r
// (ops/cuda_ring_remote.py::PROTOCOL lists these steps as rows):
//   * before hop 0, seed_slot: its share of k_r, v_r into slot 0 (a copy:
//     hop 1's incoming push overwrites slot 0, and the caller's k and v
//     stay untouched for the backward), then one landed signal, and
//     wait_landed until every block of the rank has seeded;
//   * hop < hops - 1: push_slot, its share of slot hop % 2 into the right
//     neighbour's slot (hop + 1) % 2, then one landed signal there; from
//     hop 1 on only after wait_grant: the right neighbour finished its hop
//     hop - 1, the last reader of that slot;
//   * if the hop has work: its query tiles, each with load_carry (not on
//     the rank's first hop with work), walk_hop over slot hop % 2 and
//     store_carry (the write of out and lse after the last hop with work);
//   * hop < hops - 1: wait_landed, until every block of the left neighbour
//     has pushed the next hop's slot (the TPU kernel's hop-drain);
//   * send_grant (hop < hops - 2): the block counts itself done with slot
//     hop % 2 (its tiles and its push), and the rank's last block grants
//     the left neighbour its push of hop + 1.
// This is the order of the JAX PROTOCOL table, which the port's PROTOCOL
// repeats and the JAX verifier model-checks: the landing of hop + 1 is
// awaited before the grant that lets the left neighbour's hop + 1 push
// begin, so no count can be met by a later hop's signal.
// Every rank pushes and grants on every hop, also where it has no work,
// as the TPU kernel's _push and _grant do.  Flags are release/acquire
// operations at gpu scope: one thread spins, the block meets at a barrier
// (the pattern of cooperative groups' grid sync).  Each spin is bounded
// by clock64() and ends in __trap(): a protocol fault fails the launch
// instead of hanging it.  Slot memory is rewritten by other SMs between
// hops, so it is read after the acquire only through L2 (the bf16 stages
// by cp.async.cg) or with plain loads (f32, after the acquire has dropped
// the SM's L1 lines), never through the read-only path: no slot pointer is
// const __restrict__ and none goes through __ldg.
//
// Within a hop the bf16 kernel runs B1's sweep (flash_sweep.cuh) on each of
// its query items, and its f32 spill holds the carry in B1's format (m in
// natural units, l summed over a row's 4 threads): a store and the next
// hop's load are the B1 chain's partials write and resume, so the result
// is bit-identical to B7 (which does the same in registers) and to the hop
// chain.  The f32 kernel folds its tiles as B7's f32 kernel does.
//
// What bounds it on an H100: the causal ring of 4 at n_local 16,384 (h 8,
// d 64) does 4.4e12 operations over all ranks on 0.13 GB of inputs, far
// above the card's ~295 bf16 operations per byte: tensor-core operations
// bound it (4.4 ms at 989 TFLOP/s).  The pushes move 3 x 33.5 MB per rank
// and the spill 2 x 33.5 MB per rank and hop, ~0.2 ms at 3.35 TB/s beside
// tens of ms of compute; a push overlaps the receiver's previous hop.
//
// Design:
//   * persistent blocks: block c of a rank's nc walks a fixed list of the
//     rank's query items (bf16: (b*h, 128-row) items, one per warpgroup
//     pair; f32: (b*h, 64-row) tiles), hop by hop: rounds of nc items,
//     heaviest causal rows first, taken forward and backward in turn (a
//     snake, which evens the blocks' sums on a causal hop); the carry of an
//     item lives in the spill between hops, written and read back by the
//     same threads;
//   * bf16: B1's block, 256 threads in two warpgroups that walk their 64
//     rows of an item independently, each through its own cp.async ring of
//     B1's dynamic shared memory (kFwdSmem), S = Q K^T and P V on wgmma;
//     __launch_bounds__(256, 1), so one block holds an SM (the occupancy
//     query and the cooperative launch pass that shared memory), and a
//     block that waits on a grant idles its SM;
//   * registers: the block's place in the walk (rank, block index, first
//     and last hop with work) sits in shared memory and is read where
//     used, and the protocol's steps (seed, push, waits, grant) are
//     __noinline__ calls on a __grid_constant__ Params: held in registers
//     and inlined, they spilled the tile body's state;
//   * the soft clamp is a template flag (hop_band);
//   * f32: 64 threads, one query row each, plain FMA;
//   * copies: each block moves a contiguous 1/nc of a slot, 16 bytes a
//     thread, four loads in flight;
//   * every offset into slots, spills and outputs is 64-bit.
//   * int8 (the JAX payload=): each rank's K/V arrive as the int8 sweep's
//     operands with one v block of N keys (pack_kv(v_block=N) read as the
//     feed), packed by the wrapper into one blob (k8, then the k scales,
//     V^T and the v scale, each at a 16-byte offset: cuda_flash_q8.
//     feed_blob); a slot holds one blob, seeded and pushed as the float
//     slots are, with the same protocol steps.  Each item's hop runs B4's
//     sweep (flash_sweep_q8.cuh) over the slot's blob, B4's block of 256
//     threads and its dynamic shared memory, and the spill holds B4's
//     partials (l summed over a row's 4 threads): the launch is the int8
//     hop chain fed the same payload, bit for bit.  q arrives quantized per
//     row, once per rank.
// Not yet: TMA, peer-mapped slots across GPUs, a hop coupling other than
// the grant (a third slot, pushes by blocks of their own).

#include "flash_sweep.cuh"
#include "flash_sweep_q8.cuh"

namespace {

constexpr int kMaxRanks = 16;
constexpr long long kSpinCycles = 1LL << 34;  // ~8.7 s at 1.98 GHz

struct Params {
  const void* q[kMaxRanks];  // per rank (B, H, N, D)
  const void* k[kMaxRanks];  // per rank (B, Hk, N, D), its own shard
  const void* v[kMaxRanks];
  void* out[kMaxRanks];      // per rank (B, H, N, D) in q's dtype
  float* lse[kMaxRanks];     // per rank (B, H, N)
  void* slots;               // (W, 2 slots, 2 parts, B, Hk, N, D) in q's dtype
  float* acc;                // (W, B * H, N, D) carry spill
  float* m;                  // (W, B * H, N)
  float* l;                  // (W, B * H, N)
  const int* his;            // (W, hops) band upper offset, N: unbanded
  const int* los;            // (W, hops) band lower offset, -N: unbounded
  const int* works;          // (W, hops) 0: skip the hop
  unsigned* landed;          // (W, hops) blocks whose share of the slot landed
  unsigned* grant;           // (W, hops) 1: the push of this hop may start
  unsigned* done;            // (W, hops) blocks done with the hop's slot
  int cta_start[kMaxRanks + 1];  // rank r's blocks: [cta_start[r], cta_start[r + 1])
  size_t part;  // elements of one part (k or v) of a shard, B * Hk * N * D
  int W, B, H, Hk, N, hops;
  float scale;
  float softclamp;  // 0 = off
  // The int8 kernel only: q holds q8, qs its row scales, k each rank's feed
  // blob; a slot is one blob of slot_bytes, the k scales, V^T and the v
  // scale at these offsets in it (k8 at 0); out in bf16 or f32.
  const float* qs[kMaxRanks];
  size_t slot_bytes, off_ks, off_vt, off_vs;
  int out_bf16;
};

// This block's place in the ring.
struct Rank {
  int r;        // ring rank
  int c, nc;    // index among the rank's blocks, and their count
  int senders;  // blocks of the left neighbour: one landed signal each
};

__device__ __forceinline__ Rank rank_of(const Params& p) {
  int r = 0;
  while ((int)blockIdx.x >= p.cta_start[r + 1]) ++r;
  const int left = (r + p.W - 1) % p.W;
  return Rank{r, (int)blockIdx.x - p.cta_start[r], p.cta_start[r + 1] - p.cta_start[r],
              p.cta_start[left + 1] - p.cta_start[left]};
}

// ---------------------------------------------------------------------------
// Flags: release/acquire at gpu scope
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* flag, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_acq_rel_add(unsigned* flag, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(flag), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void st_release(unsigned* flag, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

// The whole block waits until *flag >= target: thread 0 spins on acquire
// loads (bounded: a fault traps), then the block meets at the barrier.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(flag) < target) {
      if (clock64() - start > kSpinCycles) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Once every thread of the block has issued its stores: one release add.
__device__ __forceinline__ void signal_flag(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    red_release_add(flag, 1u);
  }
}

// ---------------------------------------------------------------------------
// The circulated KV: seed, landed wait, grant wait, push, grant
// ---------------------------------------------------------------------------

// Elements of one part (k or v) of a rank's shard, precomputed: the
// compiler rematerializes it inside the tile loads, where a product of
// three params put a multiply chain before every V load.
template <int D>
__device__ __forceinline__ size_t part_elems(const Params& p) {
  return p.part;
}

// Slot `s` of rank `r`: its k part, the v part follows it.
template <typename T, int D>
__device__ __forceinline__ T* slot_ptr(const Params& p, int r, int s) {
  return static_cast<T*>(p.slots) + ((size_t)r * 2 + s) * 2 * part_elems<D>(p);
}

// Block c of nc copies the c-th of nc contiguous chunks of `bytes` (a
// multiple of 16): 16 bytes a thread, kUnroll loads in flight.
__device__ __forceinline__ void copy_share(void* dst, const void* src, size_t bytes,
                                           int c, int nc) {
  constexpr int kUnroll = 4;
  const size_t n16 = bytes / 16;
  const size_t begin = n16 * c / nc, end = n16 * (c + 1) / nc;
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t i = begin + threadIdx.x; i < end; i += (size_t)blockDim.x * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t j = i + (size_t)u * blockDim.x;
      if (j < end) x[u] = s[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t j = i + (size_t)u * blockDim.x;
      if (j < end) d[j] = x[u];
    }
  }
}

// Hop 0: this block's share of the rank's own k and v into slot 0, then
// its landed signal for hop 0 (the rank's own blocks wait for all of them).
template <typename T, int D>
__device__ __noinline__ void seed_slot(const Params& p, const Rank& rk) {
  const size_t elems = part_elems<D>(p);
  T* slot = slot_ptr<T, D>(p, rk.r, 0);
  copy_share(slot, p.k[rk.r], elems * sizeof(T), rk.c, rk.nc);
  copy_share(slot + elems, p.v[rk.r], elems * sizeof(T), rk.c, rk.nc);
  signal_flag(&p.landed[rk.r * p.hops]);
}

// Slot hop % 2 is complete: every block of its writer (the rank itself at
// hop 0, the left neighbour after) has signalled.  Called before hop 0 and
// at the end of hop - 1.
__device__ __noinline__ void wait_landed(const Params& p, const Rank& rk, int hop) {
  wait_flag(&p.landed[rk.r * p.hops + hop], hop == 0 ? rk.nc : rk.senders);
}

// The right neighbour has finished its hop hop - 1, the last reader of the
// slot that this hop's push overwrites.
__device__ __noinline__ void wait_grant(const Params& p, const Rank& rk, int hop) {
  wait_flag(&p.grant[rk.r * p.hops + hop], 1u);
}

// This block's share of slot hop % 2 into the right neighbour's slot
// (hop + 1) % 2, then its landed signal there.  The stores are the block's
// own: the send is complete when this returns.
template <typename T, int D>
__device__ __noinline__ void push_slot(const Params& p, const Rank& rk, int hop) {
  const int right = (rk.r + 1) % p.W;
  copy_share(slot_ptr<T, D>(p, right, (hop + 1) & 1), slot_ptr<T, D>(p, rk.r, hop & 1),
             2 * part_elems<D>(p) * sizeof(T), rk.c, rk.nc);
  signal_flag(&p.landed[right * p.hops + hop + 1]);
}

// The block is done with slot hop % 2 (its tiles and its push); the rank's
// last block to say so grants the left neighbour its push of hop + 1,
// which overwrites this slot.  Hops hops - 2 and after grant nothing.
__device__ __noinline__ void send_grant(const Params& p, const Rank& rk, int hop) {
  if (hop >= p.hops - 2) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned before = atom_acq_rel_add(&p.done[rk.r * p.hops + hop], 1u);
    if (before + 1 == (unsigned)rk.nc) {
      const int left = (rk.r + p.W - 1) % p.W;
      st_release(&p.grant[left * p.hops + hop + 1], 1u);
    }
  }
}

// ---------------------------------------------------------------------------
// Compute: the tiles of one hop, and the f32 carry spill between hops
// ---------------------------------------------------------------------------

// The hop's band in flash_tile.cuh's form, in the hop's local coordinates.
// Without kClamp the soft clamp is the constant 0, so the compiler drops
// its path from the tile body: left to the runtime value, it if-converted
// the per-score branch and ran the clamp's division and tanh for every
// score (on one unbanded span the kernel took 1.5x B7's time, 1.2x without).
template <bool kClamp>
__device__ __forceinline__ Band hop_band(const Params& p, int r, int hop) {
  const int at = r * p.hops + hop;
  return Band{p.his[at], p.los[at], p.N, nullptr, p.scale, kClamp ? p.softclamp : 0.f};
}

// bf16: one warpgroup's 64 rows folded over the band's KV tiles of the
// slot (rg.k, rg.v): B1's sweep (flash_sweep.cuh), the first tiles issued,
// then the walk; the slot's tiles reach the stages by cp.async.cg, through
// L2 only, after the landed wait's acquire.
template <int D, bool kClamp>
__device__ __forceinline__ void walk_hop(const SweepRange& rg, const SweepWg& w, float mask2,
                                         float (&o)[8][4], float (&m2)[2], float (&l)[2]) {
  const int no_ids[2] = {0, 0};
  sweep_issue_ahead(rg, w);
  SWEEP_WALK(false, kClamp, rg, w, true, false, 0, no_ids, mask2, o, m2, l);
}

// f32: this thread's row folded over the band's KV tiles of slot k / v.
template <int D>
__device__ __forceinline__ void walk_hop(float* Ks, float* Vs, const float* k,
                                         const float* v, const Band& bd, int n, int r0,
                                         const float (&qv)[D], float (&acc)[D], float& m,
                                         float& l, int row) {
  int t_begin, t_end;
  band_tiles(bd, n, r0, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile)
    f32_tile<D>(Ks, Vs, k, v, bd, tile * kBlockN, qv, acc, m, l, row);
}

// bf16: this thread's fragments of rows row_a and row_a + 8 in B1's carry
// format (flash_sweep.cuh), at spill row base + row (base: the spill row of
// row 0 of batch-head bh, (r * B * H + bh) * N): acc in f32, m in natural
// units, l the row's whole sum, written by thread 0 of the row.  So a store
// and the next hop's load are the B1 chain's partials write and resume.
// Rows past N are never stored.
__device__ __forceinline__ void store_carry(const Params& p, size_t base, int row_a,
                                            float mask2, const float (&o)[8][4],
                                            const float (&m2)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sweep_sum_row(l[r]);
    const int row = row_a + 8 * r;
    if (row >= p.N) continue;
    sweep_store_row(p.acc, p.m, p.l, base + row, r, o, sweep_m_nat(m2[r], mask2), l[r]);
  }
}

// bf16: the carry that store_carry wrote (`resume`), or the empty state.
__device__ __forceinline__ void load_carry(const Params& p, size_t base, int row_a, bool resume,
                                           float mask2, float (&o)[8][4], float (&m2)[2],
                                           float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    sweep_load_row(p.acc, p.m, p.l, base + row, resume && row < p.N, r, mask2, o, m2, l);
  }
}

// f32: one row (idx = (r * B * H + bh) * N + row), acc, m and l.
template <int D>
__device__ __forceinline__ void store_carry(const Params& p, size_t idx,
                                            const float (&acc)[D], float m, float l) {
  float* dst = p.acc + idx * D;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
  p.m[idx] = m;
  p.l[idx] = l;
}

template <int D>
__device__ __forceinline__ void load_carry(const Params& p, size_t idx, float (&acc)[D],
                                           float& m, float& l) {
  const float* src = p.acc + idx * D;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + d);
    acc[d] = x.x; acc[d + 1] = x.y; acc[d + 2] = x.z; acc[d + 3] = x.w;
  }
  m = p.m[idx];
  l = p.l[idx];
}

// The rank's first and last hop with work (the wrapper checks that every
// rank has one).
__device__ __forceinline__ void work_span(const Params& p, const Rank& rk, int* first,
                                          int* last) {
  *first = *last = -1;
  for (int hop = 0; hop < p.hops; ++hop) {
    if (p.works[rk.r * p.hops + hop] == 0) continue;
    if (*first < 0) *first = hop;
    *last = hop;
  }
}

// Tile `tile` of a rank's B * H * ceil(N / 64) query tiles: its batch-head
// and first row, heaviest causal rows first.  Head-minor: the weights of
// a causal hop's tiles then fall evenly down the list, which the snake
// order needs (head-major, each head's run of falling weights left blocks
// up to 1.4x the mean, and was slower on the card).
__device__ __forceinline__ void tile_coords(const Params& p, int tile, int* bh, int* r0) {
  const int bh_count = p.B * p.H, q_tiles = (p.N + kBlockM - 1) / kBlockM;
  *bh = tile % bh_count;
  *r0 = (q_tiles - 1 - tile / bh_count) * kBlockM;
}

// The j-th tile of block c of nc: rounds of nc tiles, taken forward on even
// rounds and backward on odd ones, so that on a causal hop, whose tiles get
// lighter down the list, the blocks' sums come out even.
__device__ __forceinline__ int snake_tile(int j, int c, int nc) {
  return j * nc + ((j & 1) ? nc - 1 - c : c);
}

// The block's place in the walk, in shared memory: written once before the
// walk, then read where it is used, so that none of it holds a register
// across the tile body (held in registers, it spilled the tile body's
// state, 268 bytes of stack, and the kernel ran 1.5x slower than B7).
struct WalkState {
  int r, c, nc, senders;  // as in Rank
  int first, last;        // the rank's first and last hop with work
};

__device__ __forceinline__ Rank rank_of(const volatile WalkState& ws) {
  return Rank{ws.r, ws.c, ws.nc, ws.senders};
}

// Item `item` of a rank's B * H * ceil(N / 128) bf16 query items (128 rows,
// one block's two warpgroups): its batch-head and first row, heaviest
// causal rows first, head-minor as tile_coords.
__device__ __forceinline__ void item_coords(const Params& p, int item, int* bh, int* r0) {
  const int bh_count = p.B * p.H, q_items = (p.N + kFwdRows - 1) / kFwdRows;
  *bh = item % bh_count;
  *r0 = (q_items - 1 - item / bh_count) * kFwdRows;
}

// One query item of one hop, bf16, for this thread's warpgroup (its 64 rows
// of the item): the carry from the spill (the empty state on the rank's
// first hop with work), the hop's KV tiles of the slot folded in, then the
// carry back, or out and lse on the rank's last hop with work.  The two
// warpgroups of the block run their halves independently.
template <bool kClamp>
__device__ __forceinline__ void fold_item_bf16(const Params& p, const volatile WalkState& ws,
                                               int hop, int item) {
  extern __shared__ unsigned char remote_smem[];  // kFwdSmem bytes
  // stages start on a 1,024-byte boundary: the swizzle reads address bits
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(remote_smem) + 1023u) & ~1023u;
  int bh, r0;
  item_coords(p, item, &bh, &r0);
  const SweepWg w = sweep_wg(
      base, remote_smem + (base - (uint32_t)__cvta_generic_to_shared(remote_smem)), r0);
  const float mask2 = __fmul_rn(kMaskValue, kLog2e);
  const int r = ws.r;
  sweep_load_q(w, static_cast<const __nv_bfloat16*>(p.q[r]) + (size_t)bh * p.N * 64, p.N);
  const size_t spill = ((size_t)r * p.B * p.H + bh) * p.N;
  float o[8][4], m2[2], l[2];
  load_carry(p, spill, w.row_a, hop != ws.first, mask2, o, m2, l);
  {
    const int kh = (bh % p.H) / (p.H / p.Hk);
    const __nv_bfloat16* k = slot_ptr<__nv_bfloat16, 64>(p, r, hop & 1) +
                             ((size_t)(bh / p.H) * p.Hk + kh) * (size_t)p.N * 64;
    const Band bd = hop_band<kClamp>(p, r, hop);
    int t_begin, t_end;
    wg_band_tiles(bd, p.N, w.rw, &t_begin, &t_end);
    walk_hop<64, kClamp>(
        SweepRange{bd, k, k + part_elems<64>(p), nullptr, t_begin, t_end - t_begin}, w, mask2, o,
        m2, l);
  }
  sweep_wg_sync(w);  // the ring and the Q tile are free for the next item
  if (hop != ws.last) {
    store_carry(p, spill, w.row_a, mask2, o, m2, l);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sweep_sum_row(l[h]);
    const int row = w.row_a + 8 * h;
    if (row < p.N)
      store_out_bf16<64>(static_cast<__nv_bfloat16*>(p.out[r]), p.lse[r], (size_t)bh * p.N + row,
                         o, h, sweep_m_nat(m2[h], mask2), l[h]);
  }
}

// One query tile of one hop, f32: as fold_item_bf16, one row per thread.
template <int D, bool kClamp>
__device__ __forceinline__ void fold_tile_f32(const Params& p, const volatile WalkState& ws,
                                              int hop, int tile, float* Ks, float* Vs) {
  int bh, r0;
  tile_coords(p, tile, &bh, &r0);
  const int row = r0 + threadIdx.x;

  float qv[D], acc[D];
  load_q_row_f32<D>(static_cast<const float*>(p.q[ws.r]) + (size_t)bh * p.N * D, row, p.N,
                    qv, acc);
  float m = kMaskValue, l = 0.f;
  if (hop != ws.first && row < p.N)
    load_carry<D>(p, ((size_t)ws.r * p.B * p.H + bh) * p.N + row, acc, m, l);

  {
    const int kh = (bh % p.H) / (p.H / p.Hk);
    const float* k = slot_ptr<float, D>(p, ws.r, hop & 1) +
                     ((size_t)(bh / p.H) * p.Hk + kh) * (size_t)p.N * D;
    walk_hop<D>(Ks, Vs, k, k + part_elems<D>(p), hop_band<kClamp>(p, ws.r, hop), p.N, r0, qv,
                acc, m, l, row);
  }

  if (row >= p.N) return;
  if (hop == ws.last)
    store_out_f32<D>(static_cast<float*>(p.out[ws.r]), p.lse[ws.r], (size_t)bh * p.N + row,
                     acc, m, l);
  else
    store_carry<D>(p, ((size_t)ws.r * p.B * p.H + bh) * p.N + row, acc, m, l);
}

// The block's part of its rank's ring walk: seed, then per hop the push,
// its tiles, the landing of the next hop and the grant.
template <typename T, int D, bool kClamp>
__device__ __forceinline__ void ring_walk(const Params& p) {
  constexpr bool is_bf16 = sizeof(T) == 2;
  // f32: the tile body's K and V tiles; bf16: the two warpgroups' rings and
  // Q tiles in dynamic shared memory (kFwdSmem, flash_sweep.cuh)
  __shared__ __align__(16) T Ks[is_bf16 ? 1 : kBlockN * D];
  __shared__ __align__(16) T Vs[is_bf16 ? 1 : kBlockN * D];
  __shared__ WalkState state;
  volatile WalkState& ws = state;
  if (threadIdx.x == 0) {
    const Rank rk = rank_of(p);
    int first, last;
    work_span(p, rk, &first, &last);
    ws.r = rk.r;
    ws.c = rk.c;
    ws.nc = rk.nc;
    ws.senders = rk.senders;
    ws.first = first;
    ws.last = last;
  }
  __syncthreads();
  constexpr int kRows = is_bf16 ? kFwdRows : kBlockM;  // bf16: 128-row items
  const int tiles = p.B * p.H * ((p.N + kRows - 1) / kRows);

  seed_slot<T, D>(p, rank_of(ws));
  wait_landed(p, rank_of(ws), 0);
  for (int hop = 0; hop < p.hops; ++hop) {
    if (hop < p.hops - 1) {
      if (hop > 0) wait_grant(p, rank_of(ws), hop);
      push_slot<T, D>(p, rank_of(ws), hop);
    }
    if (p.works[ws.r * p.hops + hop]) {
      for (int j = 0, tile; (tile = snake_tile(j, ws.c, ws.nc)) < tiles; ++j) {
        if constexpr (is_bf16)
          fold_item_bf16<kClamp>(p, ws, hop, tile);
        else
          fold_tile_f32<D, kClamp>(p, ws, hop, tile, Ks, Vs);
      }
    }
    if (hop < p.hops - 1) wait_landed(p, rank_of(ws), hop + 1);
    send_grant(p, rank_of(ws), hop);
  }
}

// The bf16 kernel runs B1's block (flash_sweep.cuh): 256 threads, one
// block an SM (B1's dynamic shared memory, kFwdSmem).  kClamp: the launch
// has a soft clamp.
template <int D, bool kClamp>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_ring_remote_bf16_kernel(const __grid_constant__ Params p) {
  ring_walk<__nv_bfloat16, D, kClamp>(p);
}

template <int D, bool kClamp>
__global__ void __launch_bounds__(kBlockM)
    flash_ring_remote_f32_kernel(const __grid_constant__ Params p) {
  ring_walk<float, D, kClamp>(p);
}

// ---------------------------------------------------------------------------
// The int8 wire: slots of one feed blob, B4's sweep per hop
// ---------------------------------------------------------------------------

// Slot `s` of rank `r`: one blob.
__device__ __forceinline__ int8_t* slot_q8(const Params& p, int r, int s) {
  return static_cast<int8_t*>(p.slots) + ((size_t)r * 2 + s) * p.slot_bytes;
}

// Hop 0: this block's share of the rank's own blob into slot 0, then its
// landed signal for hop 0.
__device__ __noinline__ void seed_slot_q8(const Params& p, const Rank& rk) {
  copy_share(slot_q8(p, rk.r, 0), p.k[rk.r], p.slot_bytes, rk.c, rk.nc);
  signal_flag(&p.landed[rk.r * p.hops]);
}

// This block's share of slot hop % 2 into the right neighbour's slot
// (hop + 1) % 2, then its landed signal there.
__device__ __noinline__ void push_slot_q8(const Params& p, const Rank& rk, int hop) {
  const int right = (rk.r + 1) % p.W;
  copy_share(slot_q8(p, right, (hop + 1) & 1), slot_q8(p, rk.r, hop & 1), p.slot_bytes, rk.c,
             rk.nc);
  signal_flag(&p.landed[right * p.hops + hop + 1]);
}

// One query item of one hop, int8, for this thread's warpgroup (its 64 rows
// of the item): the carry from the spill in B4's partials format (the empty
// state on the rank's first hop with work), the hop's keys of the slot's
// blob folded in by B4's sweep, then the carry back, or out and lse on the
// rank's last hop with work.
template <bool kClamp>
__device__ __forceinline__ void fold_item_q8(const Params& p, const volatile WalkState& ws,
                                             int hop, int item) {
  extern __shared__ unsigned char remote_q8_smem[];  // q8::kSmem bytes
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(remote_q8_smem);
  const uint32_t base = (smem0 + 1023u) & ~1023u;
  int bh, r0;
  item_coords(p, item, &bh, &r0);  // 128-row items: q8::kRows == kFwdRows
  const q8::Wg w = q8::wg_of(base, remote_q8_smem + (base - smem0), r0);
  const int r = ws.r;
  const size_t spill = ((size_t)r * p.B * p.H + bh) * p.N;
  float o[8][4], m_r[2], l_r[2], rs[2];
  const int no_ids[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w.row_a + 8 * h;
    q8::load_row(p.acc, p.m, p.l, spill + row, hop != ws.first && row < p.N, h, o, m_r, l_r);
    rs[h] = row < p.N ? p.qs[r][(size_t)bh * p.N + row] * p.scale : 0.f;
  }
  q8::load_q(w, static_cast<const int8_t*>(p.q[r]) + (size_t)bh * p.N * q8::kD, p.N);
  {
    const int kh = (bh % p.H) / (p.H / p.Hk);
    const size_t kv_head = (size_t)(bh / p.H) * p.Hk + kh;
    const int8_t* slot = slot_q8(p, r, hop & 1);
    const int bp = (p.N + q8::kTileN - 1) / q8::kTileN * q8::kTileN;
    const int at = r * p.hops + hop;
    const q8::Span sp{slot + kv_head * p.N * q8::kD,
                      slot + p.off_vt + kv_head * q8::kD * bp,
                      reinterpret_cast<const float*>(slot + p.off_ks) + kv_head * p.N,
                      reinterpret_cast<const float*>(slot + p.off_vs) + kv_head,
                      nullptr, nullptr, p.N, p.N, p.N, bp, 1, p.his[at], 1, p.los[at],
                      kClamp ? p.softclamp : 0.f};
    int key_begin = 0, key_end = 0;
    if (w.rw < p.N) q8::key_range(sp, w.rw, &key_begin, &key_end);
    q8::sweep<kClamp, false>(sp, w, key_begin, key_end, rs, no_ids, o, m_r, l_r);
  }
  q8::wg_sync(w);  // the ring and the Q tile are free for the next item
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q8::sum_row(l_r[h]);
    const int row = w.row_a + 8 * h;
    if (row >= p.N) continue;
    if (hop != ws.last)
      q8::store_row(p.acc, p.m, p.l, spill + row, h, o, m_r[h], l_r[h]);
    else
      q8::store_out(p.out[r], p.lse[r], p.out_bf16, (size_t)bh * p.N + row, h, o, m_r[h],
                    l_r[h]);
  }
}

// The int8 kernel: ring_walk's protocol over blob slots, B4's block (256
// threads, one block an SM with B4's dynamic shared memory).
template <bool kClamp>
__global__ void __launch_bounds__(q8::kThreads, 1)
    flash_ring_remote_q8_kernel(const __grid_constant__ Params p) {
  __shared__ WalkState state;
  volatile WalkState& ws = state;
  if (threadIdx.x == 0) {
    const Rank rk = rank_of(p);
    int first, last;
    work_span(p, rk, &first, &last);
    ws.r = rk.r;
    ws.c = rk.c;
    ws.nc = rk.nc;
    ws.senders = rk.senders;
    ws.first = first;
    ws.last = last;
  }
  __syncthreads();
  const int items = p.B * p.H * ((p.N + q8::kRows - 1) / q8::kRows);

  seed_slot_q8(p, rank_of(ws));
  wait_landed(p, rank_of(ws), 0);
  for (int hop = 0; hop < p.hops; ++hop) {
    if (hop < p.hops - 1) {
      if (hop > 0) wait_grant(p, rank_of(ws), hop);
      push_slot_q8(p, rank_of(ws), hop);
    }
    if (p.works[ws.r * p.hops + hop]) {
      for (int j = 0, item; (item = snake_tile(j, ws.c, ws.nc)) < items; ++j)
        fold_item_q8<kClamp>(p, ws, hop, item);
    }
    if (hop < p.hops - 1) wait_landed(p, rank_of(ws), hop + 1);
    send_grant(p, rank_of(ws), hop);
  }
}

// The int8 kernel of a launch (with or without a soft clamp), allowed its
// dynamic shared memory.
cudaError_t kernel_q8_of(int clamp, const void** kernel) {
  *kernel = clamp ? (const void*)flash_ring_remote_q8_kernel<true>
                  : (const void*)flash_ring_remote_q8_kernel<false>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q8::kSmem);
}

// The kernel of a launch, its block size and its dynamic shared memory,
// which the kernel is allowed (cudaFuncSetAttribute) before it returns.
cudaError_t kernel_of(int is_bf16, int clamp, const void** kernel, int* threads, int* smem) {
  *threads = is_bf16 ? kFwdThreads : kBlockM;
  *smem = is_bf16 ? kFwdSmem : 0;
  if (!is_bf16) {
    *kernel = clamp ? (const void*)flash_ring_remote_f32_kernel<64, true>
                    : (const void*)flash_ring_remote_f32_kernel<64, false>;
    return cudaSuccess;
  }
  *kernel = clamp ? (const void*)flash_ring_remote_bf16_kernel<64, true>
                  : (const void*)flash_ring_remote_bf16_kernel<64, false>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

// Blocks of the cooperative launch (bf16 or f32, with or without a soft
// clamp) that fit on the current device at once (0 when it cannot launch
// cooperatively); returns a cudaError_t.
extern "C" int flash_ring_remote_capacity(int is_bf16, int clamp, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0, threads = 0, smem = 0;
  const void* kernel = nullptr;
  cudaError_t e = kernel_of(is_bf16, clamp, &kernel, &threads, &smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

// C entry point, bound with ctypes.  Enqueues one cooperative launch for the
// whole ring on `stream` and returns its cudaError_t (0 = launched).
// Allocates nothing: q, k, v, out and lse are arrays of W device pointers
// (contiguous tensors), slots and the spills are preallocated, his / los /
// works are (W, hops) int32 on the device, flags is (3, W, hops) uint32
// zeroed on the stream (landed, grant, done), and cta_split gives each
// rank's block count.  A grid the device cannot hold at once is refused
// with cudaErrorCooperativeLaunchTooLarge before anything is launched.
extern "C" int flash_ring_remote(const void* const* q, const void* const* k,
                                 const void* const* v, void* const* out, void* const* lse,
                                 void* slots, void* acc, void* m, void* l, const void* his,
                                 const void* los, const void* works, void* flags,
                                 const int* cta_split, int W, int hops, int B, int H, int Hk,
                                 int N, int D, int is_bf16, float scale, float softclamp,
                                 void* stream) {
  if (D != 64 || W < 1 || W > kMaxRanks || hops < 1 || hops > W || B <= 0 || Hk <= 0 ||
      H % Hk != 0 || N <= 0 || q == nullptr || k == nullptr || v == nullptr ||
      out == nullptr || lse == nullptr || slots == nullptr || acc == nullptr ||
      m == nullptr || l == nullptr || his == nullptr || los == nullptr ||
      works == nullptr || flags == nullptr || cta_split == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.cta_start[0] = 0;
  for (int r = 0; r < W; ++r) {
    if (cta_split[r] < 1 || q[r] == nullptr || k[r] == nullptr || v[r] == nullptr ||
        out[r] == nullptr || lse[r] == nullptr)
      return (int)cudaErrorInvalidValue;
    p.q[r] = q[r];
    p.k[r] = k[r];
    p.v[r] = v[r];
    p.out[r] = out[r];
    p.lse[r] = static_cast<float*>(lse[r]);
    p.cta_start[r + 1] = p.cta_start[r] + cta_split[r];
  }
  const int clamp = softclamp > 0.f;
  int capacity = 0;
  const int rc = flash_ring_remote_capacity(is_bf16, clamp, &capacity);
  if (rc != 0) return rc;
  if (p.cta_start[W] > capacity) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned* f = static_cast<unsigned*>(flags);
  p.slots = slots;
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.his = static_cast<const int*>(his);
  p.los = static_cast<const int*>(los);
  p.works = static_cast<const int*>(works);
  p.landed = f;
  p.grant = f + W * hops;
  p.done = f + 2 * W * hops;
  p.W = W;
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.N = N;
  p.part = (size_t)B * Hk * N * D;
  p.hops = hops;
  p.scale = scale;
  p.softclamp = softclamp;
  void* args[] = {&p};
  int threads = 0, smem = 0;
  const void* kernel = nullptr;
  const cudaError_t set = kernel_of(is_bf16, clamp, &kernel, &threads, &smem);
  if (set != cudaSuccess) return (int)set;
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(p.cta_start[W]), dim3(threads),
                                                    args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// Blocks of the int8 cooperative launch (with or without a soft clamp)
// that fit on the current device at once (0 when it cannot launch
// cooperatively); returns a cudaError_t.
extern "C" int flash_ring_remote_q8_capacity(int clamp, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  const void* kernel = nullptr;
  cudaError_t e = kernel_q8_of(clamp, &kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, q8::kThreads, q8::kSmem);
  if (e != cudaSuccess) return (int)e;
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

// The int8 entry point (the JAX payload=), bound with ctypes.  As
// flash_ring_remote, with per-rank q8 and its row scales qs, and per rank
// one feed blob of slot_bytes (k8 (B, Hk, N, D) at 0, the k scales (B, Hk,
// N) f32 at off_ks, V^T (B, Hk, 1, D, Bp) at off_vt, the v scales (B, Hk,
// 1) f32 at off_vs; one v block of N keys); slots is (W, 2, slot_bytes).
extern "C" int flash_ring_remote_q8(const void* const* q8s, const void* const* qs,
                                    const void* const* blobs, void* const* out,
                                    void* const* lse, void* slots, void* acc, void* m, void* l,
                                    const void* his, const void* los, const void* works,
                                    void* flags, const int* cta_split, int W, int hops, int B,
                                    int H, int Hk, int N, int D, long long slot_bytes,
                                    long long off_ks, long long off_vt, long long off_vs,
                                    int out_bf16, float scale, float softclamp, void* stream) {
  if (D != q8::kD || W < 1 || W > kMaxRanks || hops < 1 || hops > W || B <= 0 || Hk <= 0 ||
      H % Hk != 0 || N <= 0 || q8s == nullptr || qs == nullptr || blobs == nullptr ||
      out == nullptr || lse == nullptr || slots == nullptr || acc == nullptr || m == nullptr ||
      l == nullptr || his == nullptr || los == nullptr || works == nullptr ||
      flags == nullptr || cta_split == nullptr || slot_bytes <= 0 || slot_bytes % 16 != 0 ||
      off_ks % 16 != 0 || off_vt % 16 != 0 || off_vs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.cta_start[0] = 0;
  for (int r = 0; r < W; ++r) {
    if (cta_split[r] < 1 || q8s[r] == nullptr || qs[r] == nullptr || blobs[r] == nullptr ||
        out[r] == nullptr || lse[r] == nullptr)
      return (int)cudaErrorInvalidValue;
    p.q[r] = q8s[r];
    p.qs[r] = static_cast<const float*>(qs[r]);
    p.k[r] = blobs[r];
    p.v[r] = nullptr;
    p.out[r] = out[r];
    p.lse[r] = static_cast<float*>(lse[r]);
    p.cta_start[r + 1] = p.cta_start[r] + cta_split[r];
  }
  const int clamp = softclamp > 0.f;
  int capacity = 0;
  const int rc = flash_ring_remote_q8_capacity(clamp, &capacity);
  if (rc != 0) return rc;
  if (p.cta_start[W] > capacity) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned* f = static_cast<unsigned*>(flags);
  p.slots = slots;
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.his = static_cast<const int*>(his);
  p.los = static_cast<const int*>(los);
  p.works = static_cast<const int*>(works);
  p.landed = f;
  p.grant = f + W * hops;
  p.done = f + 2 * W * hops;
  p.W = W;
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.N = N;
  p.part = 0;
  p.hops = hops;
  p.scale = scale;
  p.softclamp = softclamp;
  p.slot_bytes = (size_t)slot_bytes;
  p.off_ks = (size_t)off_ks;
  p.off_vt = (size_t)off_vt;
  p.off_vs = (size_t)off_vs;
  p.out_bf16 = out_bf16;
  void* args[] = {&p};
  const void* kernel = nullptr;
  const cudaError_t set = kernel_q8_of(clamp, &kernel);
  if (set != cudaSuccess) return (int)set;
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(p.cta_start[W]),
                                                    dim3(q8::kThreads), args, q8::kSmem,
                                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
