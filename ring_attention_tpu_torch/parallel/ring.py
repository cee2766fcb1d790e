"""Ring attention: each rank's queries stay put while the KV shards rotate
around the ring, one hop per rank, under an online softmax.

Port of the unidirectional scan path of ``ring_attention_tpu/parallel/
ring.py``.  Where the JAX ring runs under ``shard_map`` with
``lax.ppermute``, this one loops over the ranks its process holds
(``ring.ranks``) and rotates through a :class:`~.collectives.Ring`: a
:class:`~.collectives.VirtualRing` holds every rank in one process (one
GPU, or a CPU test) and a :class:`~.collectives.DistributedRing` one rank
per process.  The arithmetic of a rank is the same either way.

Masking is one band of index offsets per hop (``_hop_offsets``): attend iff
``lo <= j - i <= hi`` in local indices, from ``(rank, origin)``:

- contiguous causal: ``hi = (rank - origin) * n_local`` covers "skip the
  hop" (origin ahead), "triangle" (own shard) and "all visible" (origin
  behind) in one expression;
- striped causal: ``hi = 0`` if ``origin <= rank`` else ``-1``;
- a lookback window adds the lower bound ``lo``.

Packed sequences (``segment_ids``, one ``(b, n)`` id tensor in the layout of
``q``): the queries keep their shard's ids and the kv ids ride the ring with
k and v; a hop whose kv ids share no document id range with the queries'
is skipped (JAX ``_hop_has_work``'s ``segments_overlap`` term), in the
forward and the backward alike.  Each rank's id range is read to the host
once per call (``_seg_ranges``), so the skip needs no sync per hop.
``doc_skip_count`` and ``doc_skip_bwd_count`` count the (rank, hop) pairs
skipped that way, whose band had work.

Three compute paths:

- ``impl="torch"`` follows the JAX scanned XLA path (``_ring_fwd_impl``
  :1342-1396): the blockwise PyTorch flash (``ops/flash.py``) folds each
  hop into a ``(b, hk, g, n, d)`` carry;
- ``impl="cuda"`` follows ``_ring_fwd_pallas`` (:503-620) on the CUDA
  forward kernel: seed partials on hop 0, in-kernel resume (in place) on
  the middle hops, normalization fused into the last hop's write.  A rank
  whose last hop has no work finalizes its carry on the host; hops whose
  band covers the whole span for every rank with work run unmasked.  With
  ``compute_dtype="int8"`` the same launches run the int8 sweep
  (``ops/cuda_flash_q8.py``) on K/V quantized once per stream at ring
  entry, per block of the bucket fitted to the shard (``_q8_block``, as
  ``_ring_fwd_pallas`` packs its feed), and circulated in the kernel's
  operand form: only q is quantized per launch;
- ``impl="fused"`` follows ``_ring_fwd_fused`` (:661-762), which has two
  tiers, chosen statically from the configuration as JAX chooses them:
  - the remote tier (TPU kernel B8, ``ops/cuda_ring_remote.py``) when no
    key mask and no segment ids are given, the ring has more than one rank
    and its ranks can be addressed inside one launch (``Ring.colocated``:
    a ``VirtualRing``): ONE launch for the whole ring, in which every rank
    keeps only its own KV and passes it to its right neighbour hop by hop
    under the grant protocol;
  - otherwise the local tier (a masked or packed ring, a
    ``DistributedRing``): one all-gather of k, v, the key mask and the kv
    ids through the ring (``Ring.all_gather``), then ONE launch of the
    fused ring kernel (``ops/cuda_ring.py``, TPU kernel B7) per held rank
    over the gathered span; a hop whose ids share no document with the
    rank's is cleared from its tables, as the scan ring skips it.
  Both walk each rank's hop tables (``_fused_tables``) with the
  online-softmax state on chip.  Its backward is the ``impl="cuda"``
  ring's, as the JAX ``_ring_vjp_bwd`` maps ``"fused"`` to ``"pallas"``.
  Under int8 the composition rules of ``_ring_fwd_fused`` (:661-762) hold:
  the remote tier only when ``hop_compression`` and ``compute_dtype`` are
  both int8 or both off (``q8 == wire8``), its int8 wire packed with one v
  scale per rank span (``pack_kv(v_block=n_local)``); the local tier's
  int8 feed is quantized at the fitted block, from the gathered payloads
  when the wire is on; compression alone round-trips K/V through the codec
  and runs the float kernels.

The int8 wire (``hop_compression="int8"``, JAX ``_kv_handle`` and
``_stream_state``): each rank's K/V is quantized ONCE per stream at ring
entry (``collectives.quantize_ring_payload``) and the int8 bytes circulate
unchanged, one tensor a hop; every hop dequantizes them for a float sweep
(``_handle_kv``) or, under ``compute_dtype="int8"``, feeds them to the int8
sweep with no dequantize/requantize round trip (``_handle_feed``): the
payload is packed at the bucket's block and laid out as the kernel's
operands at entry.  Segment ids and the key mask rotate uncompressed beside
it.  The backward recomputes from the exact K/V, as in JAX (:1417-1440):
neither knob enters it.  The JAX bidirectional half-streams (and their
``_handle_slice``) are not ported.

The gradient is one ``torch.autograd.Function`` over the whole ring (the
counterpart of the JAX ``custom_vjp``): its backward rotates ``(k, v, dk,
dv)`` together, accumulates dk and dv in f32, and ends with one composed
catch-up rotation when ``max_ring_passes`` cut the loop.  On CUDA tensors
the per-hop backward is the dk/dv and dq kernels.
"""

from __future__ import annotations

import warnings

import torch

from ..ops import quant
from ..ops.attention import normalize_segment_ids
from ..ops.cuda_flash import (
    cuda_flash_attention,
    flash_bwd,
    flash_fwd,
    flash_partials,
    int8_compute,
)
from ..ops.cuda_flash_q8 import blob_kv, feed_blob, kernel_kv, q8_block
from ..ops.cuda_ring import fused_ring_local
from ..ops.cuda_ring_remote import fused_ring_remote
from ..ops.flash import (
    _group_q,
    _ungroup,
    attend_blocks,
    finalize,
    flash_attention,
    flash_backward_blocks,
    init_carry,
)
from ..ops.partials import finalize_partials
from ..ops.residuals import attention_pair
from ..utils.validate import check_attention_args
from .collectives import Ring, dequantize_ring_payload, quantize_ring_payload

IMPLS = ("torch", "cuda", "fused")
# Where each ring option that is not ported yet will come from (ROADMAP.md).
UNPORTED = {
    "bidirectional": "the ring variants, ROADMAP.md Port queue item 7e",
    "counter_rotate": "the ring variants, ROADMAP.md Port queue item 7e",
    "dkv_dtype": "the ring variants, ROADMAP.md Port queue item 7e",
}
HOP_COMPRESSIONS = (None, "int8")

# (rank, hop) pairs whose band had work but whose kv ids shared no document
# with the queries, skipped since the last reset (the caller may set them
# to 0): forward, all impls, and backward.
doc_skip_count = 0
doc_skip_bwd_count = 0


def _rotate(ring: Ring, payloads: list, shift: int = 1) -> list:
    """Rotate the held ranks' payloads; a ring of one, or a shift that is a
    whole turn, moves nothing."""
    if ring.world == 1 or shift % ring.world == 0:
        return payloads
    return ring.rotate(payloads, shift)


def _payloads(handles, kv_mask, segs) -> list:
    """Each held rank's circulating payload ``(*handle[, kv_mask][,
    kv_seg])``: the rank's KV handle (:func:`_kv_handle`) and beside it,
    uncompressed, the key mask and the kv ids; a mask or ids that are None
    never enter the rotation.  The ring has one unidirectional stream
    (shift 1, the whole shard): the JAX package's bidirectional
    half-streams are not ported."""
    none = [None] * len(handles)
    return [tuple(handle) + tuple(x for x in (mask, seg) if x is not None)
            for handle, mask, seg in zip(handles, kv_mask or none, segs or none)]


def _unpack(payload, masked: bool) -> tuple:
    """``(handle, kv_mask, kv_seg)`` of a payload, None where absent: the
    handle is ``(k, v)``, or one int8 tensor under compression or int8
    compute."""
    n = 1 if payload[0].dtype == torch.int8 else 2
    handle, rest = payload[:n], list(payload[n:])
    mask = rest.pop(0) if masked else None
    return handle, mask, (rest[0] if rest else None)


def _q8_block(bucket_size: int | None, n_local: int) -> int:
    """The block an int8 sweep over a shard of ``n_local`` keys fits
    (``cuda_flash_q8.q8_block``, the JAX ``_q8_block``): the granularity of
    the v scales in the feed that every hop's sweep reads."""
    return q8_block(n_local, bucket_size)


def _kv_handle(k, v, hop_compression, block: int | None = None) -> tuple:
    """A rank's circulating KV, quantized once here at ring entry (JAX
    ``_kv_handle``): ``(k, v)`` as they are; with ``hop_compression`` ONE
    int8 payload (``quantize_ring_payload``); under int8 compute
    (``block`` set) ONE int8 blob of the int8 sweep's operands at that
    block (``cuda_flash_q8.feed_blob``), read from a ``pack_kv(v_block=
    block)`` payload's bytes when compressed (the dequant-free feed), else
    quantized from the exact k and v."""
    if block is not None:
        if hop_compression is None:
            feed = quant.quantize_kv_blocks(k, v, block)
        else:
            feed = quant.payload_kernel_feed(quant.pack_kv(k, v, v_block=block), block)
        return (feed_blob(kernel_kv(feed)),)
    if hop_compression is None:
        return (k, v)
    return (quantize_ring_payload(k, v),)


def _handle_kv(handle, dtype) -> tuple:
    """The ``(k, v)`` a float handle represents, in ``dtype``."""
    if len(handle) == 1:
        return dequantize_ring_payload(handle[0], dtype)
    return handle


def _handle_feed(handle, dtype, geometry) -> tuple:
    """``(k, v, kv_quantized)`` of a handle for one hop's sweep (JAX
    ``_handle_feed``): under int8 compute (``geometry`` ``(b, hk, n, d,
    block)``) the feed's views, with no dequantize and no requantize;
    otherwise the float ``(k, v)``."""
    if geometry is not None:
        return None, None, blob_kv(handle[0], *geometry)
    return (*_handle_kv(handle, dtype), None)


def _stream_state(ks, vs, cfg, n_local) -> tuple[list, tuple | None]:
    """Every held rank's KV handle, quantized once per stream (JAX
    ``_stream_state``), and the int8 feed's geometry (None unless int8
    compute)."""
    block = geometry = None
    if cfg["compute_dtype"] == "int8":
        block = _q8_block(cfg["bucket_size"], n_local)
        b, hk, _, d = ks[0].shape
        geometry = (b, hk, n_local, d, block)
    return ([_kv_handle(k, v, cfg["hop_compression"], block) for k, v in zip(ks, vs)],
            geometry)


def _seg_ranges(ring: Ring, segs: list | None) -> list | None:
    """``(min, max)`` of every ring rank's document ids, in rank order (one
    gather of two ints per rank and one host read per call), or None
    without ids."""
    if segs is None:
        return None
    local = [(torch.stack([s.min(), s.max()])[None],) for s in segs]
    (gathered,) = _gather(ring, local, dim=0)[0]
    return [tuple(r) for r in gathered.tolist()]


def _docs_meet(ranges, rank: int, i: int) -> bool:
    """Whether rank's queries and the kv ids of hop ``i`` (origin ``rank -
    i``) may share a document: their id ranges overlap (JAX
    ``segments_overlap``).  True without ids."""
    if ranges is None:
        return True
    (lo_q, hi_q), (lo_k, hi_k) = ranges[rank], ranges[(rank - i) % len(ranges)]
    return lo_q <= hi_k and lo_k <= hi_q


def _hop_works(ranges, rank, i, hi, lo, n_local, backward=False) -> bool:
    """The hop's work test: the band's (:func:`_hop_has_work`) and the
    documents' (:func:`_docs_meet`); a hop the ids alone skip is counted."""
    if not _hop_has_work(hi, lo, n_local, n_local):
        return False
    if _docs_meet(ranges, rank, i):
        return True
    global doc_skip_count, doc_skip_bwd_count
    if backward:
        doc_skip_bwd_count += 1
    else:
        doc_skip_count += 1
    return False


def _offsets_at_hop(rank, i, n_local, causal, striped, window, ring_size):
    """Band offsets ``(hi, lo)`` of hop ``i``, whose keys come from rank
    ``rank - i``."""
    return _hop_offsets(rank, (rank - i) % ring_size, n_local, causal,
                        striped, window, ring_size)


def _hop_offsets(rank: int, origin: int, n_local: int, causal: bool,
                 striped: bool, window: int | None,
                 ring_size: int) -> tuple[int | None, int | None]:
    """Band offsets ``(hi, lo)`` for the tile (my queries) x (origin's keys):
    attend iff ``lo <= j - i <= hi`` in local indices.  Striped, the window
    bound ``j*W + o >= i*W + r - w + 1`` is exactly ``j >= i + ceil((r - o -
    w + 1) / W)``."""
    if not causal:
        return None, None
    if striped:
        hi = 0 if origin <= rank else -1
        if window is None:
            return hi, None
        return hi, -((origin + window - 1 - rank) // ring_size)
    hi = (rank - origin) * n_local
    return hi, (hi - (window - 1) if window is not None else None)


def _hop_is_full(i: int, n_local, causal, striped, window, ring_size) -> bool:
    """Whether every rank with work at hop ``i`` sees the whole span
    unmasked, so that the hop may run with ``hi = lo = None`` (the ``full``
    of the JAX ``_static_hop_band``).  Only contiguous causal hops past the
    diagonal can be; a striped hop always has a band."""
    if not causal or striped:
        return False
    hi = i * n_local
    lo = hi - (window - 1) if window is not None else None
    return hi >= n_local - 1 and (lo is None or lo <= -(n_local - 1))


def _hop_has_work(hi: int | None, lo: int | None, n_q: int, n_k: int) -> bool:
    """Whether the band ``lo <= j - i <= hi`` touches the ``(n_q, n_k)``
    span; ``lo > hi`` (striped hops with a window under the ring size) is
    empty."""
    if hi is None:
        return True
    ok = hi >= -(n_q - 1)
    if lo is not None:
        ok = ok and lo <= n_k - 1 and lo <= hi
    return ok


def _fused_tables(rank, passes, n_local, causal, striped, window, ring_size,
                  device=None, ranges=None) -> tuple[torch.Tensor, ...]:
    """Per-hop ``(origins, his, los, works)`` int32 tables of the fused ring
    kernel for ``rank`` (JAX ``_fused_tables``, :623): hop ``i`` reads
    origin ``(rank - i) % ring_size``, its band from :func:`_hop_offsets`
    and its work flag from :func:`_hop_has_work`, the scan path's own
    helpers; an unbanded ``None`` becomes the sentinel ``hi = n_local`` /
    ``lo = -n_local``.  With the ranks' id ``ranges`` the work flag is the
    scan ring's :func:`_hop_works`, which also clears (and counts) a hop
    whose ids share no document with the rank's, so that the kernel visits
    the segmented hop chain's hops.  One host-to-device copy, on
    ``device``."""
    rows = []
    for i in range(passes):
        origin = (rank - i) % ring_size
        hi, lo = _hop_offsets(rank, origin, n_local, causal, striped, window,
                              ring_size)
        rows.append((origin, n_local if hi is None else hi,
                     -n_local if lo is None else lo,
                     int(_hop_works(ranges, rank, i, hi, lo, n_local))))
    return tuple(torch.tensor(list(zip(*rows)), dtype=torch.int32, device=device))


def _fit_divisor(bucket_size: int | None, nk: int) -> int | None:
    """Largest divisor of ``nk`` that is <= ``bucket_size`` (None stays
    None): the one copy of the bucket fit."""
    if bucket_size is None or nk == 0:
        return bucket_size
    b = min(bucket_size, nk)
    while nk % b:
        b -= 1
    return b


def _fit_bucket(bucket_size: int | None, nk: int) -> int | None:
    """:func:`_fit_divisor`, warning when the fit falls to half or less:
    the ring fits once per call, the attention layer once per shard
    length.  Zig-zag and the ring prefill fit silently, as JAX does."""
    b = _fit_divisor(bucket_size, nk)
    if b is not None and b * 2 <= bucket_size:
        warnings.warn(
            f"ring flash bucket refitted from {bucket_size} to {b} to divide "
            f"the {nk}-token KV stream; tiny buckets mean many small steps — "
            f"pick a bucket_size dividing the shard length",
            stacklevel=2,
        )
    return b


def _span_ops(q, hk, scale, bucket_size, softclamp_value, q_seg=None):
    """Per-hop ``(init, attend, final)`` of the ``impl="torch"`` path for
    one rank's queries ``q`` (and their ids ``q_seg``); the carry is a
    grouped ``FlashCarry``."""
    b, h, n_local, d = q.shape

    def init():
        return init_carry(b, hk, h // hk, n_local, d, device=q.device)

    def attend(carry, k, v, kv_mask, hi, lo, kv_seg=None):
        return attend_blocks(
            q, k, v, carry, scale=scale, bucket_size=bucket_size,
            causal_offset=hi, window_lo=lo, kv_mask=kv_mask,
            softclamp_value=softclamp_value, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg,
        )

    def final(carry):
        out_g, lse = finalize(carry)  # lse: (b, hk, g, n)
        return _ungroup(out_g).to(q.dtype), lse

    return init, attend, final


def _span_bwd(impl, do, q, k, v, lse, delta, kv_mask, hi, lo, scale,
              bucket_size, softclamp_value, q_seg=None, kv_seg=None):
    """Per-hop backward: float32 ``(dq (b, h, ..), dk (b, hk, ..), dv)``."""
    if impl == "cuda":
        return flash_bwd(do, q, k, v, lse, delta, kv_mask, scale=scale,
                         causal_offset=hi, window_lo=lo,
                         softclamp_value=softclamp_value, q_seg=q_seg,
                         kv_seg=kv_seg)
    return flash_backward_blocks(
        do, q, k, v, lse, delta, scale=scale, bucket_size=bucket_size,
        causal_offset=hi, window_lo=lo, kv_mask=kv_mask,
        softclamp_value=softclamp_value, q_segment_ids=q_seg,
        kv_segment_ids=kv_seg,
    )


def _ring_fwd_cuda(qs, ks, vs, masks, segs, ranges, ring, cfg):
    """Forward of every held rank on the CUDA kernel's ring modes.  Hop 0
    holds the own shard, whose band and ids always meet: it seeds, and a
    hop skipped later leaves the carry for the next hop with work."""
    n_local = qs[0].shape[2]
    handles, feed_geometry = _stream_state(ks, vs, cfg, n_local)
    payloads = _payloads(handles, masks, segs)
    passes, geo = cfg["passes"], _geometry(cfg, n_local, ring.world)
    carries = [None] * len(qs)
    results = [None] * len(qs)
    for i in range(passes):
        full = _hop_is_full(i, **geo)
        for j, rank in enumerate(ring.ranks):
            q = qs[j]
            handle, mask, kv_seg = _unpack(payloads[j], masks is not None)
            kx, vx, feed = _handle_feed(handle, q.dtype, feed_geometry)
            hi, lo = _offsets_at_hop(rank, i, **geo)
            has_work = i == 0 or _hop_works(ranges, rank, i, hi, lo, n_local)
            if full:  # every rank with work sees the whole span
                hi, lo = None, None
            band = dict(scale=cfg["scale"], causal_offset=hi, window_lo=lo,
                        softclamp_value=cfg["softclamp_value"],
                        compute_dtype=cfg["compute_dtype"],
                        block_k=cfg["bucket_size"], kv_quantized=feed,
                        q_seg=None if segs is None else segs[j], kv_seg=kv_seg)
            if i == passes - 1:
                if carries[j] is None:  # one pass: a plain fused sweep
                    results[j] = flash_fwd(q, kx, vx, mask, **band)
                elif has_work:
                    results[j] = flash_fwd(q, kx, vx, mask, carry=carries[j], **band)
                else:
                    out, lse = finalize_partials(carries[j])
                    results[j] = (out.to(q.dtype), lse)
            elif carries[j] is None:  # hop 0 holds the own shard: always work
                carries[j] = flash_partials(q, kx, vx, mask, **band)
            elif has_work:  # resumed in place
                flash_partials(q, kx, vx, mask, carry=carries[j], out=carries[j],
                               **band)
        if i < passes - 1:
            payloads = _rotate(ring, payloads)
    return [r[0] for r in results], [r[1] for r in results]


def _gather(ring: Ring, payloads: list, dim: int) -> list:
    """Every held rank's view of the whole ring's payloads, concatenated in
    rank order along ``dim``; a ring of one gathers nothing."""
    if ring.world == 1:
        return payloads
    return ring.all_gather(payloads, dim)


def _ring_fwd_fused(qs, ks, vs, masks, segs, ranges, ring, cfg):
    """Forward of every held rank on a fused ring kernel; ``(out, lse)`` in
    the flat layout of ``impl="cuda"``.  The remote tier when there is no
    key mask, no ids, one launch can hold the whole ring (as JAX takes it
    where ``neighbor_mesh_coords`` resolves and ``segment_ids is None``,
    :706-711) and the wire and the compute are both int8 or both not
    (``q8 == wire8``, :711); else the local tier: one all-gather of k, v
    (or, under int8 compute, of the int8 feed), the key mask and the kv
    ids, then one launch per held rank over the gathered span.
    Compression alone round-trips K/V through the codec first (:728-732),
    so that the fused ring sees the scan ring's wire precision."""
    q8 = cfg["compute_dtype"] == "int8"
    wire8 = cfg["hop_compression"] is not None
    if (masks is None and segs is None and ring.world > 1 and ring.colocated
            and q8 == wire8):
        return _ring_fwd_remote(qs, ks, vs, ring, cfg)
    n_local = qs[0].shape[2]
    geo = _geometry(cfg, n_local, ring.world)
    if wire8 and not q8:
        ks, vs = zip(*(_handle_kv(_kv_handle(k, v, "int8"), k.dtype) for k, v in zip(ks, vs)))
    feeds = kvs = [(None, None)] * len(qs)
    if q8:
        feeds = _gathered_feeds(ring, ks, vs, cfg, n_local)
    else:
        kvs = _gather(ring, list(zip(ks, vs)), dim=2)
    none = [None] * len(qs)
    mask_all = (none if masks is None
                else [m for (m,) in _gather(ring, [(m,) for m in masks], dim=1)])
    seg_all = none if segs is None else [s for (s,) in _gather(ring, [(s,) for s in segs], dim=1)]
    outs, lses = [], []
    for j, rank in enumerate(ring.ranks):
        origins, his, los, works = _fused_tables(rank, cfg["passes"], **geo,
                                                 device=qs[j].device, ranges=ranges)
        out, lse = fused_ring_local(
            qs[j], *kvs[j], mask_all[j], origins=origins, his=his, los=los,
            works=works, n_local=n_local, scale=cfg["scale"],
            softclamp_value=cfg["softclamp_value"],
            q_seg=None if segs is None else segs[j], kv_seg=seg_all[j],
            kv_quantized=feeds[j] if q8 else None, block_k=cfg["bucket_size"],
        )
        outs.append(out)
        lses.append(lse)
    return outs, lses


def _gathered_feeds(ring, ks, vs, cfg, n_local) -> list:
    """Each held rank's int8 feed over the gathered span (JAX
    ``ring.py:741-755``), at the fitted block, which divides ``n_local``:
    with the wire on, one all-gather of the ranks' ``pack_kv(v_block=)``
    payloads read as the feed; otherwise the exact k and v gathered and
    quantized once.  Ranks that share one gathered tensor (a
    ``VirtualRing``) share its feed."""
    block = _q8_block(cfg["bucket_size"], n_local)
    if cfg["hop_compression"] is not None:
        gathered = _gather(ring, [(quant.pack_kv(k, v, v_block=block),)
                                  for k, v in zip(ks, vs)], dim=3)
        make = lambda parts: quant.payload_kernel_feed(parts[0], block)  # noqa: E731
    else:
        gathered = _gather(ring, list(zip(ks, vs)), dim=2)
        make = lambda parts: quant.quantize_kv_blocks(*parts, block)  # noqa: E731
    feeds = {}
    for parts in gathered:
        if id(parts) not in feeds:
            feeds[id(parts)] = kernel_kv(make(parts))
    return [feeds[id(parts)] for parts in gathered]


def _ring_fwd_remote(qs, ks, vs, ring, cfg):
    """Forward of the whole ring in one launch of the remote-tier kernel:
    each rank's own KV circulates inside it; the hop tables stay on the
    host, where the launch sizes each rank's share of the card.  Under
    int8 (wire and compute) each rank's KV is its ``pack_kv(v_block=
    n_local)`` payload read as the int8 sweep's feed, one v scale per rank
    span (JAX ``ring.py:719``)."""
    n_local = qs[0].shape[2]
    geo = _geometry(cfg, n_local, ring.world)
    tables = [_fused_tables(rank, cfg["passes"], **geo) for rank in ring.ranks]
    kw = dict(tables=tables, n_local=n_local, scale=cfg["scale"],
              softclamp_value=cfg["softclamp_value"])
    if cfg["compute_dtype"] == "int8":
        feeds = [kernel_kv(quant.payload_kernel_feed(quant.pack_kv(k, v, v_block=n_local),
                                                     n_local))
                 for k, v in zip(ks, vs)]
        return fused_ring_remote(qs, None, None, compute_dtype="int8", kv_quantized=feeds,
                                 **kw)
    return fused_ring_remote(qs, ks, vs, **kw)


def _ring_fwd_torch(qs, ks, vs, masks, segs, ranges, ring, cfg):
    """Forward of every held rank on the blockwise PyTorch flash."""
    n_local = qs[0].shape[2]
    hk = ks[0].shape[1]
    handles, _ = _stream_state(ks, vs, cfg, n_local)
    payloads = _payloads(handles, masks, segs)
    geo = _geometry(cfg, n_local, ring.world)
    ops = [_span_ops(q, hk, cfg["scale"], cfg["bucket_size"],
                     cfg["softclamp_value"], None if segs is None else segs[j])
           for j, q in enumerate(qs)]
    carries = [init() for init, _, _ in ops]
    for i in range(cfg["passes"]):
        for j, rank in enumerate(ring.ranks):
            handle, mask, kv_seg = _unpack(payloads[j], masks is not None)
            hi, lo = _offsets_at_hop(rank, i, **geo)
            if _hop_works(ranges, rank, i, hi, lo, n_local):
                kx, vx = _handle_kv(handle, qs[j].dtype)
                carries[j] = ops[j][1](carries[j], kx, vx, mask, hi, lo, kv_seg)
        if i < cfg["passes"] - 1:
            payloads = _rotate(ring, payloads)
    results = [final(c) for (_, _, final), c in zip(ops, carries)]
    return [r[0] for r in results], [r[1] for r in results]


def _ring_bwd(dos, qs, ks, vs, masks, segs, ranges, outs, lses, ring, cfg):
    """Backward of every held rank: ``(dqs, dks, dvs)`` in float32."""
    # the fused forward keeps the scan-path backward of the kernels, as the
    # JAX _ring_vjp_bwd maps "fused" to "pallas"
    impl = "cuda" if cfg["impl"] == "fused" else cfg["impl"]
    n_local = qs[0].shape[2]
    hk = ks[0].shape[1]
    ring_size, passes = ring.world, cfg["passes"]
    geo = _geometry(cfg, n_local, ring_size)
    if impl == "cuda":  # lse and delta in the flat (b, h, n) layout
        deltas = [(do.float() * o.float()).sum(-1) for do, o in zip(dos, outs)]
    else:
        deltas = [(_group_q(do, hk).float() * _group_q(o, hk).float()).sum(-1)
                  for do, o in zip(dos, outs)]
    payloads = _payloads(list(zip(ks, vs)), masks, segs)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dkvs = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
             torch.zeros(k.shape, dtype=torch.float32, device=k.device))
            for k in ks]
    for i in range(passes):
        full = impl == "cuda" and _hop_is_full(i, **geo)
        for j, rank in enumerate(ring.ranks):
            (kx, vx), mask, kv_seg = _unpack(payloads[j], masks is not None)
            hi, lo = _offsets_at_hop(rank, i, **geo)
            if not _hop_works(ranges, rank, i, hi, lo, n_local, backward=True):
                continue
            if full:
                hi, lo = None, None
            dq_i, dk_i, dv_i = _span_bwd(
                impl, dos[j], qs[j], kx, vx, lses[j], deltas[j], mask, hi, lo,
                cfg["scale"], cfg["bucket_size"], cfg["softclamp_value"],
                None if segs is None else segs[j], kv_seg,
            )
            dqs[j] += dq_i
            dkvs[j][0].add_(dk_i)
            dkvs[j][1].add_(dv_i)
        # dk/dv travel with their k/v; after the last hop only they move on
        if i < passes - 1:
            moved = _rotate(ring, [p + d for p, d in zip(payloads, dkvs)])
            payloads = [m[:-2] for m in moved]
            dkvs = [m[-2:] for m in moved]
        else:
            dkvs = _rotate(ring, dkvs)
    # after `passes` rotations the dk/dv on a rank belong to origin
    # (rank - passes): one composed rotation returns each to its owner
    dkvs = _rotate(ring, dkvs, (ring_size - passes) % ring_size)
    return dqs, [d[0] for d in dkvs], [d[1] for d in dkvs]


def _geometry(cfg, n_local, ring_size) -> dict:
    return dict(n_local=n_local, causal=cfg["causal"], striped=cfg["striped"],
                window=cfg["window"], ring_size=ring_size)


def _shards(x: torch.Tensor | None, count: int, dim: int) -> list | None:
    """Contiguous per-rank shards along ``dim`` (copied once, at ring
    entry: the kernels take no strided view)."""
    if x is None:
        return None
    return [s.contiguous() for s in x.chunk(count, dim=dim)]


class _RingFlashAttention(torch.autograd.Function):
    """The whole ring's forward and backward; the counterpart of the JAX
    ``_ring_flash_attention_core`` custom_vjp.  Every rank's ``(out, lse)``
    are the residuals ``flash_out`` / ``flash_lse`` that a ``save_attn``
    region keeps (``ops/residuals.py``; JAX tags them in its scan ring):
    its recompute takes them back and runs no hop.  The fused ring tags
    none, as in JAX, and reruns.  The shards are saved tensors, so that a
    checkpointed region frees them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seg, ring, cfg):
        count = len(ring.ranks)
        qs, ks, vs = (_shards(x, count, 2) for x in (q, k, v))
        masks, segs = _shards(kv_mask, count, 1), _shards(seg, count, 1)
        ranges = _seg_ranges(ring, segs)
        fwd = {"torch": _ring_fwd_torch, "cuda": _ring_fwd_cuda,
               "fused": _ring_fwd_fused}[cfg["impl"]]

        def run():
            return fwd(qs, ks, vs, masks, segs, ranges, ring, cfg)

        outs, lses = run() if cfg["impl"] == "fused" else attention_pair(run)
        none = [None] * count
        ctx.save_for_backward(*qs, *ks, *vs, *(masks or none), *(segs or none),
                              *outs, *lses)
        ctx.masked, ctx.packed = masks is not None, segs is not None
        ctx.ranges, ctx.ring, ctx.cfg = ranges, ring, cfg
        return torch.cat(outs, dim=2)

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        count = len(saved) // 7
        qs, ks, vs, masks, segs, outs, lses = (list(saved[i * count:(i + 1) * count])
                                               for i in range(7))
        masks = masks if ctx.masked else None
        segs = segs if ctx.packed else None
        dos = _shards(do.to(qs[0].dtype), len(qs), 2)
        dqs, dks, dvs = _ring_bwd(dos, qs, ks, vs, masks, segs, ctx.ranges, outs,
                                  lses, ctx.ring, ctx.cfg)
        return (torch.cat(dqs, dim=2).to(qs[0].dtype),
                torch.cat(dks, dim=2).to(ks[0].dtype),
                torch.cat(dvs, dim=2).to(vs[0].dtype), None, None, None, None)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    ring: Ring,
    causal: bool = False,
    striped: bool = False,
    bucket_size: int | None = None,
    max_ring_passes: int | None = None,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    impl: str = "torch",
    bidirectional: bool = False,
    dkv_dtype: str | None = None,
    segment_ids: torch.Tensor | None = None,
    counter_rotate: bool = False,
    hop_compression: str | None = None,
    compute_dtype: str | None = None,
) -> torch.Tensor:
    """Sequence-parallel exact attention over ``ring``, differentiable.

    Args:
      q: ``(b, h, n, d)`` queries of the ranks this process holds
        (``ring.ranks``), their shards concatenated in rank order along the
        sequence: the whole sequence on a ``VirtualRing``, the local shard
        on a ``DistributedRing``.
      k, v: ``(b, hk, n, d)`` keys and values in the same layout (GQA when
        ``hk < h``: the ring then moves ``hk``-wide shards).
      kv_mask: optional ``(b, n)`` key-padding mask in the same layout; it
        rotates with ``k`` and ``v``.
      ring: the :class:`~.collectives.Ring` the shards belong to.
      causal, striped: causal masking, in the striped (load-balanced)
        layout when the sequence was stripe-permuted before sharding.
      bucket_size: the blockwise flash tile of ``impl="torch"`` within a hop
        (the CUDA kernel's tiles are fixed).
      max_ring_passes: limit the hops (a lookback window's reach).
      window: exact sliding-window lookback in tokens (causal only).
      impl: ``"torch"`` (the blockwise PyTorch flash, JAX ``"xla"``),
        ``"cuda"`` (the CUDA kernels hop by hop, JAX ``"pallas"``) or
        ``"fused"`` (JAX ``"fused"``: without a key mask on a
        ``VirtualRing``, one launch of the remote-tier kernel for the whole
        ring, the KV passed between the ranks inside it; otherwise one
        fused ring launch per rank over the all-gathered KV, the local
        tier; the backward is ``"cuda"``'s).  On CPU tensors the kernel
        wrappers run their plain versions.

      segment_ids: packed sequences, a ``(b, n)`` integer tensor of document
        ids in the layout of ``q`` (``PAD_SEGMENT_ID`` marks padding): a
        query attends only keys of its document.  The kv ids rotate with k
        and v (``impl="fused"``: are gathered with them, and B7 takes them);
        a hop whose ids share no document with the queries' is skipped.
      hop_compression: ``"int8"`` quantizes each rank's K/V once at ring
        entry (per row, ``collectives.quantize_ring_payload``) and
        circulates the int8 bytes; every hop's float sweep reads them
        dequantized.  The backward recomputes from the exact K/V.
      compute_dtype: ``"int8"`` runs each hop's forward on int8 operands
        (``impl="cuda"`` or ``"fused"``, as the JAX ring needs the Pallas
        kernels): q and k quantized per row and v per block of
        ``bucket_size`` keys fitted to the shard, K/V once per stream at
        ring entry (from the int8 payload's bytes with ``hop_compression``:
        the dequant-free ring); the backward stays on the float kernels.

    ``bidirectional``, ``dkv_dtype`` and ``counter_rotate`` are not ported
    yet and raise ``NotImplementedError`` naming their ROADMAP item;
    ``counter_rotate`` with ``impl="fused"`` is a ``ValueError``, as in the
    JAX package (the alternating schedule has no fused form), as is a
    ``hop_compression`` other than None and ``"int8"``.

    Cross-attention (unequal q and kv shard lengths) bypasses the ring: each
    rank attends its local KV shard only, as in the JAX package (and takes
    no segment ids).

    Returns ``(b, h, n, d)`` in ``q.dtype``, in the layout of ``q``.
    """
    if impl == "fused" and counter_rotate:
        raise ValueError(
            'ring_flash_attention: impl="fused" carries the whole hop schedule '
            "in one kernel launch; the counter-rotation schedule has no fused "
            'form (pass impl="cuda" with counter_rotate)'
        )
    for name, value in (("bidirectional", bidirectional),
                        ("dkv_dtype", dkv_dtype),
                        ("counter_rotate", counter_rotate)):
        if value is not None and value is not False:
            raise NotImplementedError(
                f"ring_flash_attention: {name}= is not ported yet; it arrives "
                f"with {UNPORTED[name]}"
            )
    if impl not in IMPLS:
        raise ValueError(f"ring_flash_attention: impl must be one of {IMPLS}, got {impl!r}")
    if hop_compression not in HOP_COMPRESSIONS:
        raise ValueError(
            f"ring_flash_attention: hop_compression={hop_compression!r}; supported "
            'values are None (model-dtype hops) and "int8" (per-token absmax '
            "quantized hops)"
        )
    int8 = int8_compute(compute_dtype, "ring_flash_attention")
    if int8 and impl == "torch":
        raise ValueError(
            'ring_flash_attention: compute_dtype="int8" runs on the CUDA kernels '
            'only; pass impl="cuda" or impl="fused" (the blockwise PyTorch flash '
            "has no int8 matmul form)"
        )
    count = len(ring.ranks)
    check_attention_args("ring_flash_attention", q, k, v, kv_mask, shards=count)
    seg, _ = normalize_segment_ids(
        None if segment_ids is None else (segment_ids, segment_ids), q, q,
        "ring_flash_attention",
    )
    if window is not None and not causal:
        raise ValueError("ring_flash_attention: lookback windows require causal attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[2] != k.shape[2]:
        # cross-attention: each rank attends its local KV shard only
        if seg is not None:
            raise ValueError(
                "ring_flash_attention: segment_ids need equal q/kv shard lengths "
                "(packed self-attention); the cross-attention fallback does not "
                "define a kv-side packing"
            )
        local = flash_attention if impl == "torch" else cuda_flash_attention
        kw = dict(causal=causal, window=window, softclamp_value=softclamp_value,
                  scale=scale)
        if impl == "torch":
            kw["bucket_size"] = bucket_size
        else:
            kw["compute_dtype"] = compute_dtype
        masks = kv_mask.chunk(count, dim=1) if kv_mask is not None else [None] * count
        return torch.cat([
            local(qx, kx, vx, mx, **kw)
            for qx, kx, vx, mx in zip(q.chunk(count, dim=2), k.chunk(count, dim=2),
                                      v.chunk(count, dim=2), masks)
        ], dim=2)
    if impl == "torch":  # fitted once to the shard every hop attends
        bucket_size = _fit_bucket(bucket_size, q.shape[2] // count)
    cfg = dict(
        impl=impl, causal=causal, striped=striped, bucket_size=bucket_size,
        passes=min(max_ring_passes or ring.world, ring.world), window=window,
        softclamp_value=softclamp_value, scale=scale, compute_dtype=compute_dtype,
        hop_compression=hop_compression,
    )
    return _RingFlashAttention.apply(q, k, v, kv_mask, seg, ring, cfg)
