"""The fused ring forward, remote tier, on the hand-written CUDA kernel
``csrc/flash_ring_remote.cu``.

Host side of the port of ``ring_attention_tpu/ops/pallas_ring.py``'s remote
tier (``fused_ring_remote`` :744, launch :866): every rank keeps only its
own KV shard, and the shards travel around the ring inside the kernel, one
hop at a time, through a double-buffered slot pair per rank.  A push into
the right neighbour's other slot waits for that neighbour's grant (it has
finished reading the slot), and the online-softmax state ``(acc, m, l)``
of every query item carries across the hops in an f32 spill, in the
format of the forward kernel's partials (B1's hop chain, bit for bit).

On one card the ranks of a :class:`~..parallel.collectives.VirtualRing`
are the block groups of ONE cooperative launch, all resident at once:
puts are plain global stores and flags are release/acquire operations.
The function is the local tier's (``ops/cuda_ring.py``, B7, over the
gathered span) and the ``impl="cuda"`` hop chain's, bit for bit.

- ``fused_ring_remote`` is the kernel wrapper, for the whole ring at once
  (per-rank lists): a CUDA tensor launches the kernel (or raises), a CPU
  tensor runs ``fused_ring_remote_plain``.  Nothing else selects between
  the two.
- ``fused_ring_remote_plain`` is its plain version: the port's hop chain
  on the plain versions of ``ops/cuda_flash.py`` (``cuda_ring.fold_hop``),
  fed by circulation: a two-slot list per rank, each rank's current slot
  handed to its right neighbour's other slot after every hop.
- ``PROTOCOL`` is the kernel's copy and flag schedule as data, one row per
  site group, in the schema of the JAX ``pallas_ring.PROTOCOL`` (:418-441)
  and its verifier's op kinds (``copy``, ``remote_copy``, ``sem_signal``,
  ``sem_wait``).  ``fn`` names the ``__device__`` function of
  ``csrc/flash_ring_remote.cu`` that holds each site.

The int8 wire (the JAX ``payload=``, :789-815): ``compute_dtype="int8"``
with ``kv_quantized``, each rank's K/V as the int8 sweep's operands
(``cuda_flash_q8.Int8KV``) read off its ``pack_kv(v_block=n_local)``
payload: one v scale per rank span.  The slots then hold each rank's feed
as one int8 blob (``cuda_flash_q8.feed_blob``), moved from slot to slot
as the float KV is, and each hop runs B4's int8 sweep
(``csrc/flash_sweep_q8.cuh``) on it, the carry spilled in B4's partials
format: the launch is the int8 hop chain fed the same payload, bit for
bit.  Only q is quantized, once per rank and launch.  Key masks and
segment ids go to the local tier, as in JAX.  ``launch_count`` counts the
kernel's launches (one per ring and call) and ``q8_launch_count`` again
those of the int8 kernel; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_flash import _check_kernel_args, _check_launch
from .cuda_flash_q8 import Int8KV, feed_blob, kernel_kv
from .cuda_ring import fold_hop
from .quant import quantize_rows

# Kernel launches since the last reset; the caller may set them to 0.
launch_count = 0
q8_launch_count = 0  # those of the int8 kernel

# Ranks one launch holds (csrc/flash_ring_remote.cu kMaxRanks).
MAX_RANKS = 16
_TILE = 64  # keys per KV tile, and query rows per warpgroup (flash_tile.cuh)
# Query rows of one block's item: bf16, B1's block of two 64-row warpgroups
# (csrc/flash_sweep.cuh kFwdRows); f32, one 64-row tile (kBlockM).
_ITEM_ROWS = {True: 128, False: 64}

# One row per copy / flag site group of flash_ring_remote.cu, in the
# kernel's program order within a hop.  The model check
# (ring_attention_tpu.analysis.schedverify.verify_protocol(protocol=...))
# treats each rank as one sequential program: the ordering among a rank's
# own blocks (every block's seed before any hop-0 read, and the "done"
# count that precedes a grant) is the kernel's duty, not the table's.  It
# also models each flag as one counting semaphore where the kernel keeps a
# word per hop: the table's order (a hop's landing awaited before the
# grant that lets the next push start, as in the JAX table) is what keeps
# a count from being met by a later hop's signal in the model.  Unlike the
# JAX table there is no seed barrier (the one launch allocates every slot
# before any block runs) and no "sites" field (there is no jaxpr to count).
#   push-kv      the block's plain stores into the right neighbour's other
#                slot, then a release add on the receiver's landed word for
#                hop + 1 (its recv_sem);
#   push-sent    the stores are the block's own, so the send is complete
#                when push_slot returns: before the carry, the slot reads
#                and the grant;
#   landed-wait  the acquire spin on the rank's landed word of hop + 1 (the
#                left neighbour's pushes all landed), the TPU's hop-drain;
#   push-grant / grant   the receiver-to-sender flow control: the grant of
#                hop + 1 goes to the left neighbour once every block of the
#                rank is done with slot hop % 2 (its tiles and its push).
PROTOCOL = (
    {"row": "seed-k", "fn": "seed_slot", "op": "copy",
     "src": "k_src", "src_slot": None, "dst": "kvbuf", "dst_slot": "0",
     "guard": "hop == 0", "tile": "all", "to": None},
    {"row": "seed-v", "fn": "seed_slot", "op": "copy",
     "src": "v_src", "src_slot": None, "dst": "kvbuf", "dst_slot": "0",
     "guard": "hop == 0", "tile": "all", "to": None},
    {"row": "push-grant", "fn": "wait_grant", "op": "sem_wait",
     "sem": "grant_sem", "value": 1, "guard": "0 < hop < hops - 1",
     "tile": "all"},
    {"row": "push-kv", "fn": "push_slot", "op": "remote_copy",
     "src": "kvbuf", "src_slot": "hop % 2",
     "dst": "kvbuf", "dst_slot": "(hop + 1) % 2",
     "send_sem": "send_sem", "recv_sem": "recv_sem",
     "to": "right", "addressing": "mesh", "guard": "hop < hops - 1",
     "tile": "all"},
    {"row": "push-sent", "fn": "push_slot", "op": "sem_wait",
     "sem": "send_sem", "value": 1, "guard": "hop < hops - 1", "tile": "all"},
    {"row": "carry-load-acc", "fn": "load_carry", "op": "copy",
     "src": "accb", "src_slot": None, "dst": "acc", "dst_slot": None,
     "guard": "hop > 0", "tile": "all", "to": None},
    {"row": "carry-load-m", "fn": "load_carry", "op": "copy",
     "src": "mb", "src_slot": None, "dst": "m", "dst_slot": None,
     "guard": "hop > 0", "tile": "all", "to": None},
    {"row": "carry-load-l", "fn": "load_carry", "op": "copy",
     "src": "lb", "src_slot": None, "dst": "l", "dst_slot": None,
     "guard": "hop > 0", "tile": "all", "to": None},
    {"row": "slot-reads", "fn": "walk_hop", "op": "copy",
     "src": "kvbuf", "src_slot": "hop % 2", "dst": "smem", "dst_slot": None,
     "guard": "True", "tile": "all", "to": None},
    {"row": "carry-store-acc", "fn": "store_carry", "op": "copy",
     "src": "acc", "src_slot": None, "dst": "accb", "dst_slot": None,
     "guard": "hop < hops - 1", "tile": "all", "to": None},
    {"row": "carry-store-m", "fn": "store_carry", "op": "copy",
     "src": "m", "src_slot": None, "dst": "mb", "dst_slot": None,
     "guard": "hop < hops - 1", "tile": "all", "to": None},
    {"row": "carry-store-l", "fn": "store_carry", "op": "copy",
     "src": "l", "src_slot": None, "dst": "lb", "dst_slot": None,
     "guard": "hop < hops - 1", "tile": "all", "to": None},
    {"row": "landed-wait", "fn": "wait_landed", "op": "sem_wait",
     "sem": "recv_sem", "value": 1, "guard": "hop < hops - 1", "tile": "all"},
    {"row": "grant", "fn": "send_grant", "op": "sem_signal",
     "sem": "grant_sem", "inc": 1, "to": "left", "addressing": "mesh",
     "guard": "hop < hops - 2", "tile": "last"},
)


def _schedules(tables, world: int) -> list[tuple[list, list, list]]:
    """Each rank's ``(his, los, works)`` as lists, after checking that the
    tables circulate one rank to the right (hop ``i`` of rank ``r`` holds
    origin ``(r - i) % world``) and share one hop count."""
    if len(tables) != world:
        raise ValueError(f"fused_ring_remote: {len(tables)} hop tables for {world} ranks")
    schedules, hops = [], None
    for rank, table in enumerate(tables):
        if len(table) != 4:
            raise ValueError("fused_ring_remote: each rank's tables are "
                             "(origins, his, los, works)")
        for t in table:
            if t.dim() != 1 or t.dtype != torch.int32:
                raise ValueError(f"fused_ring_remote: the hop tables must be 1-d int32, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        origins, his, los, works = (t.tolist() for t in table)
        hops = len(origins) if hops is None else hops
        if not 1 <= hops <= world or any(len(x) != hops for x in (origins, his, los, works)):
            raise ValueError(f"fused_ring_remote: every rank needs the same 1..{world} "
                             "hops in each table")
        if origins != [(rank - i) % world for i in range(hops)]:
            raise ValueError(
                f"fused_ring_remote: rank {rank}'s origins {origins} are not the "
                f"circulation order (rank - hop) % {world}: KV moves one rank right "
                "per hop")
        if not any(works):
            raise ValueError(f"fused_ring_remote: rank {rank} has no hop with work (a "
                             "ring's own hop always has)")
        schedules.append((his, los, works))
    return schedules


def _check_feeds(qs, feeds, n_local) -> list[Int8KV]:
    """Per-rank int8 feeds of one shape, one v block of ``n_local`` keys
    (the JAX wire's ``pack_kv(v_block=n_local)``), on q's device."""
    if feeds is None or len(feeds) != len(qs):
        raise ValueError('fused_ring_remote: compute_dtype="int8" takes one kv_quantized '
                         "feed per rank")
    feeds = [kernel_kv(f) for f in feeds]
    b, h, n, d = qs[0].shape
    for f in feeds:
        hk = f.k8.shape[1]
        if (f.block != n_local or tuple(f.k8.shape) != (b, hk, n_local, d) or h % hk
                or f.k8.shape != feeds[0].k8.shape or f.k8.device != qs[0].device):
            raise ValueError(
                f"fused_ring_remote: each rank's int8 feed must be (b, hk, {n_local}, d) "
                f"with one v block of {n_local} keys (pack_kv(v_block=n_local)), on "
                f"q's device; got {tuple(f.k8.shape)}, block {f.block}")
    return feeds


def _check_ring(qs, ks, vs, n_local) -> None:
    """Per-rank lists of one shape each: q ``(b, h, n_local, d)``, k and v
    ``(b, hk, n_local, d)``, one float dtype, one device."""
    world = len(qs)
    if world < 1 or len(ks) != world or len(vs) != world:
        raise ValueError(f"fused_ring_remote: {len(qs)} q, {len(ks)} k and {len(vs)} v "
                         "shards; one of each per rank")
    if world > MAX_RANKS:
        raise ValueError(f"fused_ring_remote: {world} ranks; one launch holds at most "
                         f"{MAX_RANKS}")
    q0, k0 = qs[0], ks[0]
    if q0.dim() != 4 or k0.dim() != 4:
        raise ValueError("fused_ring_remote: q, k, v shards must be (b, heads, n, d)")
    b, h, n, d = q0.shape
    hk = k0.shape[1]
    if n != n_local or tuple(k0.shape) != (b, hk, n_local, d) or h % hk:
        raise ValueError(
            f"fused_ring_remote: q {tuple(q0.shape)} and k {tuple(k0.shape)} do not "
            f"make (b, h, {n_local}, d) queries over (b, hk, {n_local}, d) keys with "
            "h a multiple of hk")
    if not q0.dtype.is_floating_point:
        raise ValueError(f"fused_ring_remote: dtype {q0.dtype}; the remote tier takes "
                         'float operands (the int8 wire: compute_dtype="int8" with '
                         "kv_quantized)")
    for x, like in [(x, q0) for x in qs] + [(x, k0) for x in (*ks, *vs)]:
        if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
            raise ValueError(
                f"fused_ring_remote: mismatched shards: {tuple(x.shape)} {x.dtype} on "
                f"{x.device} beside {tuple(like.shape)} {like.dtype} on {like.device}")


def fused_ring_remote_plain(
    qs: list[torch.Tensor],
    ks: list[torch.Tensor],
    vs: list[torch.Tensor],
    *,
    tables: list[tuple[torch.Tensor, ...]],
    n_local: int,
    scale: float,
    softclamp_value: float | None = None,
    kv_quantized: list | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Plain PyTorch version of :func:`fused_ring_remote`: the hop chain of
    every rank, fed by circulation.

    Slot 0 of each rank holds its own ``(k, v)`` (or int8 feed); after hop
    ``i`` every rank's slot ``i % 2`` goes to its right neighbour's slot
    ``(i + 1) % 2`` (the tensors are never written, so a reference stands
    for the kernel's copy).  A hop with work folds the current slot into
    the rank's carry as ``cuda_ring.fold_hop`` does, with dense f32 scores
    or, fed int8, the int8 sweep's plain version.  Returns per-rank lists
    ``(outs, lses)``."""
    world = len(qs)
    if kv_quantized is not None:
        feeds = _check_feeds(qs, kv_quantized, n_local)
        slots = [[(None, None, f), None] for f in feeds]
    else:
        _check_ring(qs, ks, vs, n_local)
        slots = [[(k, v, None), None] for k, v in zip(ks, vs)]
    schedules = _schedules(tables, world)
    hops = len(schedules[0][0])
    lasts = [max(i for i, w in enumerate(works) if w) for _, _, works in schedules]
    carries = [None] * world
    for hop in range(hops):
        for r, (his, los, works) in enumerate(schedules):
            if works[hop]:
                k, v, feed = slots[r][hop % 2]
                carries[r] = fold_hop(qs[r], k, v, None, his[hop], los[hop], carries[r],
                                      hop == lasts[r], scale, softclamp_value, feed=feed)
        if hop < hops - 1:
            for r in range(world):
                slots[(r + 1) % world][(hop + 1) % 2] = slots[r][hop % 2]
    return [out for out, _ in carries], [lse for _, lse in carries]


def _tile_visits(hi: int, lo: int, n: int, rows: int = 128) -> torch.Tensor:
    """KV tiles each query item of ``rows`` rows (by first row) of a shard
    of ``n`` takes the kernel: the larger count of its 64-row warpgroups,
    which walk their tiles side by side (``band_tiles`` in
    ``csrc/flash_tile.cuh``: a warpgroup whose band is empty takes every
    tile, one whose rows all lie past ``n`` none).  ``rows`` 64: the f32
    kernel's one-warpgroup tiles."""
    r0 = torch.arange(0, n, _TILE, dtype=torch.int64)
    r_last = torch.clamp(r0 + _TILE, max=n) - 1
    every = -(-n // _TILE)
    empty = (r0 + hi < 0) | (r_last + lo > n - 1) | (lo > hi)
    j_min = torch.clamp(r0 + lo, min=0)
    j_max = torch.clamp(r_last + hi, max=n - 1)
    per_wg = torch.where(empty, every, j_max // _TILE - j_min // _TILE + 1)
    per_item = rows // _TILE
    per_wg = torch.nn.functional.pad(per_wg, (0, -len(per_wg) % per_item))
    return per_wg.view(-1, per_item).amax(1)


def _block_time(visits: torch.Tensor, bh: int, blocks: int) -> int:
    """The largest KV-tile count any of ``blocks`` blocks walks for one hop:
    the kernel's item list (heaviest rows first, head-minor: each query
    item's count ``bh`` times) dealt in rounds of ``blocks``, forward and
    backward in turn (``snake_tile``)."""
    weights = visits.flip(0).repeat_interleave(bh)
    rounds = -(-len(weights) // blocks)
    dealt = torch.nn.functional.pad(weights, (0, rounds * blocks - len(weights)))
    dealt = dealt.view(rounds, blocks)
    dealt[1::2] = dealt[1::2].flip(1)
    return int(dealt.sum(0).max())


def _makespan(hop_time) -> float:
    """Modelled time of one launch from ``hop_time[r][i]``, rank ``r``'s
    time for hop ``i``: a rank pushes at the start of a hop and only after
    its right neighbour has finished the hop before (the grant), and a hop
    ends once the next hop's slot has landed from the left neighbour's
    push.  The copies themselves are taken as free beside the tiles."""
    world, hops = len(hop_time), len(hop_time[0])
    done = [0.0] * world  # each rank's end of the previous hop
    for i in range(hops):
        start = [max(done[r], done[(r + 1) % world]) if 0 < i < hops - 1 else done[r]
                 for r in range(world)]
        end = [start[r] + hop_time[r][i] for r in range(world)]
        if i < hops - 1:  # the left neighbour's push of this hop has landed
            end = [max(end[r], start[(r - 1) % world]) for r in range(world)]
        done = end
    return max(done)


class _SplitModel:
    """Per rank, hop and block count, the hop's time (:func:`_block_time`
    over items of ``rows`` query rows), memoized; and the modelled launch
    of a split."""

    def __init__(self, schedules, n_local: int, bh: int, rows: int = 128):
        self.bh, self.memo = bh, {}
        self.visits = [[_tile_visits(hi, lo, n_local, rows) if w else None
                        for hi, lo, w in zip(*schedule)] for schedule in schedules]

    def hop_time(self, r: int, i: int, blocks: int) -> int:
        key = (r, i, blocks)
        if key not in self.memo:
            visits = self.visits[r][i]
            self.memo[key] = 0 if visits is None else _block_time(visits, self.bh, blocks)
        return self.memo[key]

    def makespan(self, split) -> float:
        return _makespan([[self.hop_time(r, i, nc) for i in range(len(self.visits[r]))]
                          for r, nc in enumerate(split)])


def _descend(model: _SplitModel, split: list[int]) -> tuple[float, list[int]]:
    """Local search from ``split``: move blocks between ranks while the
    modelled launch shortens, in steps halving down to one block."""
    world, best = len(split), model.makespan(split)
    step = max(1, sum(split) // 8)
    while step:
        improved = True
        while improved:
            improved = False
            for a in range(world):
                for b in range(world):
                    if a == b or split[a] - step < 1:
                        continue
                    trial = list(split)
                    trial[a] -= step
                    trial[b] += step
                    span = model.makespan(trial)
                    if span < best * (1 - 1e-9):
                        split, best, improved = trial, span, True
        step //= 2
    return best, split


@functools.lru_cache(maxsize=64)
def _balanced_split(schedules: tuple, n_local: int, bh: int, blocks: int,
                    rows: int) -> tuple[int, ...]:
    model = _SplitModel(schedules, n_local, bh, rows)
    world = len(schedules)
    totals = [sum(int(v.sum()) for v in hops if v is not None) for hops in model.visits]
    starts = []
    for weights in (totals if sum(totals) else [1] * world, [1] * world):
        split = [max(1, blocks * w // sum(weights)) for w in weights]
        while sum(split) > blocks:
            split[split.index(max(split))] -= 1
        while sum(split) < blocks:
            split[max(range(world), key=lambda r: weights[r] / split[r])] += 1
        starts.append(split)
    # from the split in proportion to each rank's work and from the even one
    return tuple(min((_descend(model, split) for split in starts), key=lambda x: x[0])[1])


def _schedule_key(tables) -> tuple:
    return tuple(tuple(map(tuple, schedule)) for schedule in _schedules(tables, len(tables)))


def modelled_time(tables, n_local: int, bh: int, split, rows: int = 128) -> float:
    """The launch's modelled time (KV tiles a block walks, along the
    protocol's critical path) for blocks ``split`` per rank, each block
    walking items of ``rows`` query rows (bf16 128, f32 64)."""
    return _SplitModel(_schedule_key(tables), n_local, bh, rows).makespan(split)


def balanced_split(tables, n_local: int, bh: int, blocks: int,
                   rows: int = 128) -> list[int]:
    """Blocks per rank for a grid of ``blocks`` (at most the card holds at
    once), at least one each, for ``bh`` batch-heads and items of ``rows``
    query rows (bf16 128, f32 64).  The grant couples
    neighbours hop by hop (a rank's push of hop ``i`` waits until its right
    neighbour has finished hop ``i - 1``), so a split in proportion to each
    rank's total work is not the fastest: on a contiguous causal ring of 4
    (work 0.5 : 1.5 : 2.5 : 3.5) rank 0's lone diagonal on a sixteenth of
    the card holds up everyone's second hop.  From that proportional
    split and from the even one, blocks move between ranks while they
    shorten the modelled launch (:func:`modelled_time`); the shorter
    result is taken."""
    return list(_balanced_split(_schedule_key(tables), n_local, bh,
                                max(blocks, len(tables)), rows))


def _grid_blocks(capacity: int, world: int, bh: int, n_local: int, is_bf16: bool) -> int:
    """Blocks of the default grid: every block the card holds at once
    (bf16: one an SM, B1's shared memory), but no more than the ring's
    query items (``world * bh`` times the items of a shard); a block left
    without an item would still push and grant."""
    return min(capacity, world * bh * -(-n_local // _ITEM_ROWS[is_bf16]))


@functools.cache
def _capacity(device_index: int, is_bf16: bool, clamp: bool, int8: bool = False) -> int:
    """Blocks of the cooperative launch (one kernel per dtype, with or
    without a soft clamp; ``int8`` the int8 kernel) that fit on the card at
    once: the kernel's occupancy at its block size and dynamic shared
    memory, times the SMs (bf16 and int8: one block an SM)."""
    from ._build import flash_ring_remote_library, flash_ring_remote_q8_library

    lib = flash_ring_remote_q8_library() if int8 else flash_ring_remote_library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        if int8:
            rc = lib.flash_ring_remote_q8_capacity(int(clamp), ctypes.byref(blocks))
        else:
            rc = lib.flash_ring_remote_capacity(int(is_bf16), int(clamp), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"fused_ring_remote: occupancy query failed: CUDA error {rc}")
    if blocks.value < 1:
        raise RuntimeError("fused_ring_remote: the device cannot launch cooperatively")
    return blocks.value


def _launch(qs, ks, vs, tables, scale, softclamp_value, split):
    q0, k0 = qs[0], ks[0]
    if q0.device.type != "cuda":
        raise ValueError(f"fused_ring_remote: no kernel for device {q0.device}")
    for q, k, v in zip(qs, ks, vs):
        _check_kernel_args("fused_ring_remote", q, k, v, None)
    from ._build import flash_ring_remote_library

    lib = flash_ring_remote_library()
    world = len(qs)
    b, h, n, d = q0.shape
    hk = k0.shape[1]
    is_bf16 = q0.dtype == torch.bfloat16
    capacity = _capacity(q0.device.index, is_bf16, bool(softclamp_value))
    if split is None:
        split = balanced_split(tables, n, b * h, _grid_blocks(capacity, world, b * h, n, is_bf16),
                               _ITEM_ROWS[is_bf16])
    split = [int(x) for x in split]
    if len(split) != world or min(split) < 1:
        raise ValueError(f"fused_ring_remote: cta_split {split} needs one count >= 1 "
                         f"per rank of {world}")
    if sum(split) > capacity:
        raise ValueError(
            f"fused_ring_remote: a grid of {sum(split)} blocks does not fit on the card "
            f"at once ({capacity} do); every rank's blocks must be resident together")
    schedules = _schedules(tables, world)
    hops = len(schedules[0][0])
    rows = torch.tensor([list(s) for s in schedules], dtype=torch.int32)  # (W, 3, hops)
    bands = rows.permute(1, 0, 2).contiguous().to(q0.device)  # his, los, works
    outs = [torch.empty_like(q) for q in qs]
    lses = [torch.empty((b, h, n), dtype=torch.float32, device=q0.device) for _ in qs]
    slots = torch.empty((world, 2, 2, b, hk, n, d), dtype=q0.dtype, device=q0.device)
    acc = torch.empty((world, b * h, n, d), dtype=torch.float32, device=q0.device)
    m, l = (torch.empty((world, b * h, n), dtype=torch.float32, device=q0.device)
            for _ in range(2))
    flags = torch.zeros((3, world, hops), dtype=torch.int32, device=q0.device)

    def ptrs(xs):
        return (ctypes.c_void_p * world)(*(x.data_ptr() for x in xs))

    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_ring_remote(
            ptrs(qs), ptrs(ks), ptrs(vs), ptrs(outs), ptrs(lses),
            slots.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            bands[0].data_ptr(), bands[1].data_ptr(), bands[2].data_ptr(),
            flags.data_ptr(), (ctypes.c_int * world)(*split),
            world, hops, b, h, hk, n, d, int(is_bf16), float(scale),
            float(softclamp_value or 0.0), ctypes.c_void_p(stream),
        )
    _check_launch(rc, "fused_ring_remote", q0, k0)
    global launch_count
    launch_count += 1
    return outs, lses


def _launch_q8(qs, feeds: list[Int8KV], tables, scale, softclamp_value, split):
    """The int8 kernel's launch: each rank's q quantized per row, its feed
    packed into one blob (the slots' unit), the carry spilled as f32."""
    q0, k0 = qs[0], feeds[0].k8
    if q0.device.type != "cuda":
        raise ValueError(f"fused_ring_remote: no kernel for device {q0.device}")
    world = len(qs)
    b, h, n, d = q0.shape
    hk = k0.shape[1]
    if q0.dtype not in (torch.bfloat16, torch.float32) or d != 64:
        raise ValueError(f"fused_ring_remote: q must be bf16 or f32 of head dim 64, got "
                         f"{q0.dtype} {tuple(q0.shape)}")
    for q in qs:
        if q.shape != q0.shape or q.dtype != q0.dtype or q.device != q0.device:
            raise ValueError("fused_ring_remote: mismatched query shards")
    from ._build import flash_ring_remote_q8_library
    from .cuda_flash_q8 import _feed_parts

    lib = flash_ring_remote_q8_library()
    capacity = _capacity(q0.device.index, True, bool(softclamp_value), True)
    if split is None:
        split = balanced_split(tables, n, b * h, _grid_blocks(capacity, world, b * h, n, True),
                               _ITEM_ROWS[True])
    split = [int(x) for x in split]
    if len(split) != world or min(split) < 1:
        raise ValueError(f"fused_ring_remote: cta_split {split} needs one count >= 1 "
                         f"per rank of {world}")
    if sum(split) > capacity:
        raise ValueError(
            f"fused_ring_remote: a grid of {sum(split)} blocks does not fit on the card "
            f"at once ({capacity} do); every rank's blocks must be resident together")
    schedules = _schedules(tables, world)
    hops = len(schedules[0][0])
    rows = torch.tensor([list(s) for s in schedules], dtype=torch.int32)  # (W, 3, hops)
    bands = rows.permute(1, 0, 2).contiguous().to(q0.device)  # his, los, works
    quantized = [quantize_rows(q) for q in qs]
    blobs = [feed_blob(f) for f in feeds]
    *parts, total = _feed_parts(b, hk, n, d, n)  # k8 first, at offset 0
    off_ks, off_vt, off_vs = (offset for offset, _, _ in parts[1:])
    outs = [torch.empty_like(q) for q in qs]
    lses = [torch.empty((b, h, n), dtype=torch.float32, device=q0.device) for _ in qs]
    slots = torch.empty((world, 2, total), dtype=torch.int8, device=q0.device)
    acc = torch.empty((world, b * h, n, d), dtype=torch.float32, device=q0.device)
    m, l = (torch.empty((world, b * h, n), dtype=torch.float32, device=q0.device)
            for _ in range(2))
    flags = torch.zeros((3, world, hops), dtype=torch.int32, device=q0.device)

    def ptrs(xs):
        return (ctypes.c_void_p * world)(*(x.data_ptr() for x in xs))

    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_ring_remote_q8(
            ptrs([x for x, _ in quantized]), ptrs([s for _, s in quantized]), ptrs(blobs),
            ptrs(outs), ptrs(lses), slots.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(), bands[2].data_ptr(),
            flags.data_ptr(), (ctypes.c_int * world)(*split), world, hops, b, h, hk, n, d,
            total, off_ks, off_vt, off_vs, int(q0.dtype == torch.bfloat16), float(scale),
            float(softclamp_value or 0.0), ctypes.c_void_p(stream),
        )
    _check_launch(rc, "fused_ring_remote", q0, k0)
    global launch_count, q8_launch_count
    launch_count += 1
    q8_launch_count += 1
    return outs, lses


def fused_ring_remote(
    qs: list[torch.Tensor],
    ks: list[torch.Tensor] | None,
    vs: list[torch.Tensor] | None,
    kv_masks: list | None = None,
    *,
    tables: list[tuple[torch.Tensor, ...]],
    n_local: int,
    scale: float,
    softclamp_value: float | None = None,
    compute_dtype: str | None = None,
    kv_quantized: list | None = None,
    cta_split: list[int] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The fused ring forward of every rank of a ring, each rank holding
    only its own KV shard.

    Args:
      qs: per rank ``(b, h, n_local, d)`` queries, in ring order.
      ks, vs: per rank ``(b, hk, n_local, d)`` keys and values (GQA: query
        head ``j`` reads kv head ``j // (h // hk)``).
      kv_masks: must be None: a masked ring runs the local tier
        (``cuda_ring.fused_ring_local``), as in the JAX package.
      tables: per rank the ``(origins, his, los, works)`` int32 ``(hops,)``
        tables of ``parallel/ring.py::_fused_tables`` (origins in the
        circulation order ``(rank - hop) % W``), on the host.
      n_local, scale, softclamp_value: the shard length, the score scale
        and the optional soft clamp.
      compute_dtype, kv_quantized: ``"int8"`` runs the int8 wire (the JAX
        ``payload=``): ``kv_quantized`` holds per rank its K/V as the int8
        sweep's operands with one v block of ``n_local`` keys (an
        ``Int8KV``, or a ``QuantizedBlockKV`` laid out here), and ``ks``,
        ``vs`` are ignored (they may be None).
      cta_split: blocks per rank of the one launch (testing: starve a rank
        to force skew); by default :func:`balanced_split` over
        :func:`_grid_blocks` (every block the card holds at once, at most
        one per query item).  Ignored on the CPU.

    Returns per-rank lists ``(outs (b, h, n_local, d) in q's dtype, lses
    (b, h, n_local) f32)``.  CPU tensors run
    :func:`fused_ring_remote_plain`; CUDA tensors launch the kernel once for
    the whole ring, or raise, also when the grid does not fit on the card
    at once."""
    if kv_masks is not None and any(mk is not None for mk in kv_masks):
        raise ValueError(
            "fused_ring_remote: the remote tier takes no key mask; a masked ring "
            "runs the local tier (fused_ring_local over the gathered span)")
    if compute_dtype not in (None, "int8"):
        raise ValueError(f"fused_ring_remote: compute_dtype={compute_dtype!r}; None or "
                         '"int8"')
    if compute_dtype == "int8":
        feeds = _check_feeds(qs, kv_quantized, n_local)
        if len(qs) > MAX_RANKS:
            raise ValueError(f"fused_ring_remote: {len(qs)} ranks; one launch holds at "
                             f"most {MAX_RANKS}")
        if qs[0].device.type == "cpu":
            return fused_ring_remote_plain(qs, None, None, tables=tables, n_local=n_local,
                                           scale=scale, softclamp_value=softclamp_value,
                                           kv_quantized=feeds)
        return _launch_q8(qs, feeds, tables, scale, softclamp_value, cta_split)
    if kv_quantized is not None:
        raise ValueError('fused_ring_remote: kv_quantized goes with compute_dtype="int8"')
    _check_ring(qs, ks, vs, n_local)
    if qs[0].device.type == "cpu":
        return fused_ring_remote_plain(qs, ks, vs, tables=tables, n_local=n_local,
                                       scale=scale, softclamp_value=softclamp_value)
    return _launch(qs, ks, vs, tables, scale, softclamp_value, cta_split)
