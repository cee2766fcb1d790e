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
neither knob enters it.

KV circulates as one or more *streams* ``(shift, key_offset, key_len)``
(JAX ``_streams``): one whole-shard stream, or with ``bidirectional`` the
two halves of each shard rotating in opposite directions (TokenRing's
bidirectional schedule): hop ``i`` of rank ``r`` attends the first half of
origin ``r - i`` and the second half of origin ``r + i``, its band shifted
by ``-key_offset`` (``_stream_offsets``).  The float wire's halves slice
one quantization of the shard (``_handle_slice``); under int8 compute each
stream packs its own span at that span's fitted block.  Limited passes run
one stream, as in JAX.

``counter_rotate`` (JAX ``_counter_fwd`` / ``_counter_bwd``, TokenRing's
counter-rotation): the queries travel instead, packed with their f32
``(acc, m, l)`` into one ``[q | acc | m | l]`` tensor that rotates by -1
after even hops while KV rotates by +1 after odd hops; hop ``i`` pairs the
same blocks as the unidirectional ring's hop ``i`` (``_counter_origins``),
so each hop runs the same kernel launch on the same data, and one composed
catch-up returns the finished ``[out | lse]``.  Its backward rotates one
``[q | do | dq | lse | delta]`` pack by -1 a hop while ``(k, v, dk, dv)``
stay on their rank; only dq is caught up.

The gradient is one ``torch.autograd.Function`` over the whole ring (the
counterpart of the JAX ``custom_vjp``): its backward rotates ``(k, v)`` and
the ``(dk, dv)`` accumulators of each stream, accumulates dk and dv in f32
(or ``dkv_dtype``), and ends with one composed catch-up rotation per
stream when ``max_ring_passes`` cut the loop.  On CUDA tensors the per-hop
backward is the dk/dv and dq kernels.
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
    FlashCarry,
    _group_q,
    _ungroup,
    attend_blocks,
    finalize,
    flash_attention,
    flash_backward_blocks,
    init_carry,
)
from ..ops.partials import FlashPartials, finalize_partials
from ..ops.residuals import attention_pair
from ..utils.validate import check_attention_args
from .collectives import Ring, dequantize_ring_payload, quantize_ring_payload

IMPLS = ("torch", "cuda", "fused")
HOP_COMPRESSIONS = (None, "int8")
# The names dkv_dtype takes (JAX passes them to jnp.dtype); a torch dtype
# is taken as it is.
DKV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}

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


def _streams(bidirectional: bool, n_local: int) -> list[tuple[int, int, int]]:
    """The KV circulation streams ``(shift, key_offset, key_len)`` (JAX
    ``_streams``): the whole shard rotating by +1, or with
    ``bidirectional`` its first half by +1 and its second half by -1, so
    that hop ``i`` of rank ``r`` attends the first half of origin ``r - i``
    and the second half of origin ``r + i``; over the ring's hops that
    covers both halves of every origin once.  The caller checks that
    ``n_local`` is even."""
    if not bidirectional:
        return [(1, 0, n_local)]
    half = n_local // 2
    return [(1, 0, half), (-1, half, half)]


def _cut(x: torch.Tensor | None, ofs: int, nk: int, dim: int) -> torch.Tensor | None:
    """Tokens ``[ofs, ofs + nk)`` of ``x`` along ``dim``, copied (the
    kernels take no strided view); the whole of ``x`` is ``x`` itself."""
    if x is None or (ofs == 0 and nk == x.shape[dim]):
        return x
    return x.narrow(dim, ofs, nk).contiguous()


def _payloads(handles, kv_mask, segs) -> list:
    """Each held rank's circulating payload of one stream ``(*handle[,
    kv_mask][, kv_seg])``: the rank's KV handle (:func:`_kv_handle`) and
    beside it, uncompressed, the key mask and the kv ids; a mask or ids
    that are None never enter the rotation."""
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


def _q8_block(bucket_size: int | None, n_keys: int) -> int:
    """The block an int8 sweep over a stream of ``n_keys`` keys fits
    (``cuda_flash_q8.q8_block``, the JAX ``_q8_block``): the granularity of
    the v scales in the feed that every hop's sweep reads."""
    return q8_block(n_keys, bucket_size)


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


def _handle_slice(handle, ofs: int, nk: int) -> tuple:
    """Tokens ``[ofs, ofs + nk)`` of a float handle (JAX
    ``_handle_slice``): ``(k, v)`` sliced, or the int8 wire payload ``(2,
    b, hk, n, d + 4)`` sliced along its token axis, whose per-row scale
    bytes ride the same axis: half-streams slice ONE quantization pass."""
    if len(handle) == 1:
        return (_cut(handle[0], ofs, nk, 3),)
    return tuple(_cut(x, ofs, nk, 2) for x in handle)


def _handle_kv(handle, dtype) -> tuple:
    """The ``(k, v)`` a float handle represents, in ``dtype``."""
    if len(handle) == 1:
        return dequantize_ring_payload(handle[0], dtype)
    return handle


def _handle_feed(handle, dtype, geometry) -> tuple:
    """``(k, v, kv_quantized)`` of a handle for one hop's sweep (JAX
    ``_handle_feed``): under int8 compute (``geometry`` ``(b, hk, nk, d,
    block)``) the feed's views, with no dequantize and no requantize;
    otherwise the float ``(k, v)``."""
    if geometry is not None:
        return None, None, blob_kv(handle[0], *geometry)
    return (*_handle_kv(handle, dtype), None)


def _stream_state(ks, vs, masks, segs, cfg, streams) -> list[tuple[list, tuple | None]]:
    """For each stream, every held rank's payload and the int8 feed's
    geometry (None unless int8 compute), the KV quantized once per stream
    (JAX ``_stream_state``): the float handles (the wire's too) slice one
    handle of the whole shard; under int8 compute each stream packs its
    own span at that span's fitted block, as a feed blob cannot be sliced
    by token range.  The key mask and the kv ids are sliced with them."""
    b, hk, _, d = ks[0].shape
    if cfg["compute_dtype"] == "int8":
        handles, geometries = [], []
        for _, ofs, nk in streams:
            block = _q8_block(cfg["bucket_size"], nk)
            handles.append([_kv_handle(_cut(k, ofs, nk, 2), _cut(v, ofs, nk, 2),
                                       cfg["hop_compression"], block)
                            for k, v in zip(ks, vs)])
            geometries.append((b, hk, nk, d, block))
    else:
        whole = [_kv_handle(k, v, cfg["hop_compression"]) for k, v in zip(ks, vs)]
        handles = [[_handle_slice(h, ofs, nk) for h in whole] for _, ofs, nk in streams]
        geometries = [None] * len(streams)
    return [(_payloads(hs, None if masks is None else [_cut(m, ofs, nk, 1) for m in masks],
                       None if segs is None else [_cut(s, ofs, nk, 1) for s in segs]), geo)
            for hs, geo, (_, ofs, nk) in zip(handles, geometries, streams)]


def _seg_ranges(ring: Ring, segs: list | None, streams) -> tuple | None:
    """The document id ranges of every ring rank, in rank order, or None
    without ids: ``(q, kv)``, ``q[rank]`` the ``(min, max)`` of the rank's
    ids and ``kv[stream][rank]`` that of the ids of the stream's span.  One
    gather of ``2 + 2 * streams`` ints per rank (two with one stream) and
    one host read per call."""
    if segs is None:
        return None
    split = len(streams) > 1
    local = []
    for s in segs:
        parts = [s.min(), s.max()]
        if split:
            for _, ofs, nk in streams:
                parts += [s[:, ofs:ofs + nk].min(), s[:, ofs:ofs + nk].max()]
        local.append((torch.stack(parts)[None],))
    (gathered,) = _gather(ring, local, dim=0)[0]
    rows = gathered.tolist()
    q = [tuple(r[:2]) for r in rows]
    if not split:
        return q, [q]
    return q, [[tuple(r[2 + 2 * si:4 + 2 * si]) for r in rows] for si in range(len(streams))]


def _docs_meet(ranges, q_origin: int, kv_origin: int, si: int = 0) -> bool:
    """Whether the queries of rank ``q_origin`` and the kv ids of stream
    ``si``'s span of rank ``kv_origin`` may share a document: their id
    ranges overlap (JAX ``segments_overlap``).  True without ids.  The
    origins travel: on the counter-rotated ring the queries' too."""
    if ranges is None:
        return True
    q_ranges, kv_ranges = ranges
    (lo_q, hi_q), (lo_k, hi_k) = q_ranges[q_origin], kv_ranges[si][kv_origin]
    return lo_q <= hi_k and lo_k <= hi_q


def _hop_works(ranges, q_origin, kv_origin, hi, lo, n_q, n_k, si=0,
               backward=False) -> bool:
    """The hop's work test: the band's (:func:`_hop_has_work`) and the
    documents' (:func:`_docs_meet`); a hop the ids alone skip is counted."""
    if not _hop_has_work(hi, lo, n_q, n_k):
        return False
    if _docs_meet(ranges, q_origin, kv_origin, si):
        return True
    global doc_skip_count, doc_skip_bwd_count
    if backward:
        doc_skip_bwd_count += 1
    else:
        doc_skip_count += 1
    return False


def _stream_origin(stream, rank: int, i: int, ring_size: int) -> int:
    """The rank whose span of ``stream`` ``rank`` holds at hop ``i``."""
    return (rank - stream[0] * i) % ring_size


def _stream_offsets(stream, rank, i, n_local, causal, striped, window, ring_size):
    """Band offsets ``(hi, lo)`` of one stream at hop ``i`` (JAX
    ``_stream_offsets``): a key at index ``j`` of a span that starts at
    ``key_offset`` sits at shard index ``j + key_offset``, which shifts
    both bounds by ``-key_offset`` in the contiguous and the striped
    layouts alike."""
    _, ofs, _ = stream
    hi, lo = _hop_offsets(rank, _stream_origin(stream, rank, i, ring_size), n_local,
                          causal, striped, window, ring_size)
    if ofs and hi is not None:
        hi -= ofs
        lo = None if lo is None else lo - ofs
    return hi, lo


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


def _hop_is_full(stream, i: int, n_local, causal, striped, window, ring_size) -> bool:
    """Whether every rank with work at hop ``i`` of ``stream`` sees its
    whole span unmasked, so that the hop may run with ``hi = lo = None``
    (the ``full`` of the JAX ``_static_hop_band``).  Only contiguous causal
    hops can be: the forward stream's workers all sit ``i`` shards behind,
    the reverse stream's ``ring_size - i``; a striped hop always has a
    band."""
    if not causal or striped:
        return False
    shift, ofs, nk = stream
    hi = (i if shift == 1 else (ring_size - i) % ring_size) * n_local - ofs
    lo = hi - (window - 1) if window is not None else None
    return hi >= nk - 1 and (lo is None or lo <= -(n_local - 1))


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
                     int(_hop_works(ranges, rank, origin, hi, lo, n_local, n_local))))
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
    the ring fits once per call to the span each hop attends (half the
    shard on the bidirectional ring), the attention layer once per shard
    length.  Zig-zag and the ring prefill fit silently, as JAX does."""
    b = _fit_divisor(bucket_size, nk)
    if b is not None and b * 2 <= bucket_size:
        warnings.warn(
            f"ring flash bucket refitted from {bucket_size} to {b} to divide "
            f"the {nk}-token KV stream; tiny buckets mean many small steps — "
            f"pick a bucket_size dividing the (half-)shard length",
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


def _cuda_hop(q, kx, vx, mask, feed, hi, lo, q_seg, kv_seg, carry, has_work,
              last: bool, cfg) -> tuple:
    """One span of a rank's CUDA forward: ``(carry, (out, lse) or None)``.
    The first span seeds partials (it holds the own shard, whose band and
    ids always meet: a span skipped later leaves the carry for the next
    one with work), the middle ones resume in place, the last fuses the
    normalization into its write, or finalizes the carry on the host when
    it has no work; a single span is one plain fused sweep."""
    band = dict(scale=cfg["scale"], causal_offset=hi, window_lo=lo,
                softclamp_value=cfg["softclamp_value"],
                compute_dtype=cfg["compute_dtype"], block_k=cfg["bucket_size"],
                kv_quantized=feed, q_seg=q_seg, kv_seg=kv_seg)
    if last:
        if carry is None:
            return None, flash_fwd(q, kx, vx, mask, **band)
        if has_work:
            return carry, flash_fwd(q, kx, vx, mask, carry=carry, **band)
        out, lse = finalize_partials(carry)
        return carry, (out.to(q.dtype), lse)
    if carry is None:
        return flash_partials(q, kx, vx, mask, **band), None
    if has_work:
        flash_partials(q, kx, vx, mask, carry=carry, out=carry, **band)
    return carry, None


def _rotate_streams(ring, payloads: list, streams) -> list:
    """Each stream's payloads rotated by its shift (one rotation a
    stream)."""
    return [_rotate(ring, p, stream[0]) for p, stream in zip(payloads, streams)]


def _ring_fwd_cuda(qs, ks, vs, masks, segs, ranges, ring, cfg):
    """Forward of every held rank on the CUDA kernel's ring modes, span by
    span: hop by hop, and within a hop stream by stream (JAX
    ``_ring_fwd_pallas``)."""
    n_local = qs[0].shape[2]
    streams = cfg["streams"]
    state = _stream_state(ks, vs, masks, segs, cfg, streams)
    payloads = [p for p, _ in state]
    passes, geo = cfg["passes"], _geometry(cfg, n_local, ring.world)
    n_spans = passes * len(streams)
    carries = [None] * len(qs)
    results = [None] * len(qs)
    span = 0
    for i in range(passes):
        for si, stream in enumerate(streams):
            full = _hop_is_full(stream, i, **geo)
            for j, rank in enumerate(ring.ranks):
                handle, mask, kv_seg = _unpack(payloads[si][j], masks is not None)
                kx, vx, feed = _handle_feed(handle, qs[j].dtype, state[si][1])
                hi, lo = _stream_offsets(stream, rank, i, **geo)
                has_work = span == 0 or _hop_works(
                    ranges, rank, _stream_origin(stream, rank, i, ring.world), hi, lo,
                    n_local, stream[2], si)
                if full:  # every rank with work sees the whole span
                    hi, lo = None, None
                carries[j], result = _cuda_hop(
                    qs[j], kx, vx, mask, feed, hi, lo, None if segs is None else segs[j],
                    kv_seg, carries[j], has_work, span == n_spans - 1, cfg)
                if result is not None:
                    results[j] = result
            span += 1
        if i < passes - 1:
            payloads = _rotate_streams(ring, payloads, streams)
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
    """Forward of every held rank on the blockwise PyTorch flash, span by
    span (JAX ``_ring_fwd_impl``'s scan)."""
    n_local = qs[0].shape[2]
    hk = ks[0].shape[1]
    streams = cfg["streams"]
    payloads = [p for p, _ in _stream_state(ks, vs, masks, segs, cfg, streams)]
    geo = _geometry(cfg, n_local, ring.world)
    ops = [_span_ops(q, hk, cfg["scale"], cfg["bucket_size"],
                     cfg["softclamp_value"], None if segs is None else segs[j])
           for j, q in enumerate(qs)]
    carries = [init() for init, _, _ in ops]
    for i in range(cfg["passes"]):
        for si, stream in enumerate(streams):
            for j, rank in enumerate(ring.ranks):
                handle, mask, kv_seg = _unpack(payloads[si][j], masks is not None)
                hi, lo = _stream_offsets(stream, rank, i, **geo)
                if _hop_works(ranges, rank, _stream_origin(stream, rank, i, ring.world),
                              hi, lo, n_local, stream[2], si):
                    kx, vx = _handle_kv(handle, qs[j].dtype)
                    carries[j] = ops[j][1](carries[j], kx, vx, mask, hi, lo, kv_seg)
        if i < cfg["passes"] - 1:
            payloads = _rotate_streams(ring, payloads, streams)
    results = [final(c) for (_, _, final), c in zip(ops, carries)]
    return [r[0] for r in results], [r[1] for r in results]


def _counter_origins(rank: int, i: int, ring_size: int) -> tuple[int, int]:
    """``(q_origin, kv_origin)`` held by ``rank`` at counter-rotation hop
    ``i`` (JAX ``_counter_origins``): the queries have moved ``ceil(i /
    2)`` times by -1 and KV ``floor(i / 2)`` times by +1, so ``q_origin -
    kv_origin = i``: hop ``i`` pairs the blocks of the unidirectional
    ring's hop ``i``."""
    return (rank + (i + 1) // 2) % ring_size, (rank - i // 2) % ring_size


def _pack_counter(q, acc, m, l) -> torch.Tensor:
    """The travelling queries with their online-softmax state as ONE f32
    tensor ``(b, h, n, 2d + 2)``, channels ``[q | acc | m | l]`` (JAX
    ``_pack_counter``): a sub-f32 ``q`` round-trips through f32 exactly."""
    return torch.cat([q.float(), acc, m[..., None], l[..., None]], dim=-1)


def _unpack_counter(pack, d: int, dtype) -> tuple:
    """Inverse of :func:`_pack_counter`: ``(q, acc, m, l)``, each copied
    out of the pack (the kernels take no strided view)."""
    return (pack[..., :d].to(dtype).contiguous(), pack[..., d:2 * d].contiguous(),
            pack[..., 2 * d].contiguous(), pack[..., 2 * d + 1].contiguous())


def _counter_fwd(qs, ks, vs, masks, segs, ranges, ring, cfg):
    """TokenRing counter-rotation forward (JAX ``_counter_fwd``): the
    queries, packed with their f32 ``(acc, m, l)``, rotate by -1 after
    even hops and KV by +1 after odd hops; each hop runs the span of the
    unidirectional ring's hop with the same pairing (the CUDA ring's seed,
    resume or fused mode on the carry that travelled with q, or the
    blockwise flash), and one composed rotation of ``passes // 2`` returns
    each rank's finished ``[out | lse]``.  ``lse`` is flat ``(b, h, n)``
    on both impls."""
    b, h, n_local, d = qs[0].shape
    hk = ks[0].shape[1]
    dtype, world, passes = qs[0].dtype, ring.world, cfg["passes"]
    cuda = cfg["impl"] == "cuda"
    stream = (1, 0, n_local)
    ((kv_payloads, geometry),) = _stream_state(ks, vs, masks, segs, cfg, [stream])
    geo = _geometry(cfg, n_local, world)
    travel = list(qs)
    q_segs = None if segs is None else list(segs)
    carries = ([None] * len(qs) if cuda
               else [init_carry(b, hk, h // hk, n_local, d, device=q.device) for q in qs])
    results = [None] * len(qs)
    for i in range(passes):
        full = cuda and _hop_is_full(stream, i, **geo)
        for j, rank in enumerate(ring.ranks):
            q_origin, kv_origin = _counter_origins(rank, i, world)
            handle, mask, kv_seg = _unpack(kv_payloads[j], masks is not None)
            q_seg = None if q_segs is None else q_segs[j]
            hi, lo = _hop_offsets(q_origin, kv_origin, **geo)
            has_work = i == 0 or _hop_works(ranges, q_origin, kv_origin, hi, lo,
                                            n_local, n_local)
            if cuda:
                if full:
                    hi, lo = None, None
                kx, vx, feed = _handle_feed(handle, dtype, geometry)
                carries[j], result = _cuda_hop(travel[j], kx, vx, mask, feed, hi, lo, q_seg,
                                               kv_seg, carries[j], has_work,
                                               i == passes - 1, cfg)
                if result is not None:
                    results[j] = result
            elif has_work:
                kx, vx = _handle_kv(handle, dtype)
                carries[j] = attend_blocks(
                    travel[j], kx, vx, carries[j], scale=cfg["scale"],
                    bucket_size=cfg["bucket_size"], causal_offset=hi, window_lo=lo,
                    kv_mask=mask, softclamp_value=cfg["softclamp_value"],
                    q_segment_ids=q_seg, kv_segment_ids=kv_seg)
        if i == passes - 1:
            break
        if i % 2 == 0:  # the queries and their carry hop one way...
            packs = [(_pack_counter(q, *_flat_carry(c, b, h, n_local, d)),)
                     + (() if q_segs is None else (q_segs[j],))
                     for j, (q, c) in enumerate(zip(travel, carries))]
            for j, moved in enumerate(_rotate(ring, packs, -1)):
                q, acc, m, l = _unpack_counter(moved[0], d, dtype)
                travel[j] = q
                carries[j] = (FlashPartials(acc, m, l) if cuda else FlashCarry(
                    acc.view(b, hk, h // hk, n_local, d), m.view(b, hk, h // hk, n_local),
                    l.view(b, hk, h // hk, n_local)))
                if q_segs is not None:
                    q_segs[j] = moved[1]
        else:  # ...and KV the other
            kv_payloads = _rotate(ring, kv_payloads, 1)
    if not cuda:
        results = []
        for c in carries:
            out_g, lse = finalize(c)
            results.append((_ungroup(out_g).to(dtype), lse.reshape(b, h, n_local)))
    # the finished rows belong to q_origin = rank + passes // 2: one
    # composed rotation returns the packed [out | lse] home
    shift = (passes // 2) % world
    if shift:
        back = _rotate(ring, [(torch.cat([o.float(), s[..., None]], dim=-1),)
                              for o, s in results], shift)
        results = [(r[..., :d].to(dtype), r[..., d].contiguous()) for (r,) in back]
    return [r[0] for r in results], [r[1] for r in results]


def _flat_carry(carry, b, h, n, d) -> tuple:
    """A carry's ``(acc, m, l)`` in the flat ``(b, h, n, ..)`` layout."""
    acc, m, l = carry
    return acc.reshape(b, h, n, d), m.reshape(b, h, n), l.reshape(b, h, n)


def _counter_bwd(dos, qs, ks, vs, masks, segs, ranges, outs, lses, ring, cfg):
    """Counter-rotation backward (JAX ``_counter_bwd``): ONE f32 pack
    ``[q | do | dq | lse | delta]`` rotates by -1 a hop while ``(k, v)``
    and the f32 dk/dv accumulators stay on their rank, each visiting query
    block adding its share to them in place; after the last hop only the
    dq channel is caught up, by ``(passes - 1) % ring`` ranks.  ``dkv_dtype``
    does not enter (no dk/dv circulates)."""
    impl = cfg["impl"]
    b, h, n_local, d = qs[0].shape
    hk = ks[0].shape[1]
    dtype, world, passes = qs[0].dtype, ring.world, cfg["passes"]
    stream = (1, 0, n_local)
    geo = _geometry(cfg, n_local, world)
    packs = []
    for do, q, o, lse in zip(dos, qs, outs, lses):
        delta = (do.float() * o.float()).sum(-1)
        packs.append(torch.cat([q.float(), do.float(), torch.zeros_like(q, dtype=torch.float32),
                                lse[..., None], delta[..., None]], dim=-1))
    q_segs = None if segs is None else list(segs)
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    for i in range(passes):
        full = impl == "cuda" and _hop_is_full(stream, i, **geo)
        for j, rank in enumerate(ring.ranks):
            q_origin = (rank + i) % world  # the queries alone move: pairing i
            hi, lo = _hop_offsets(q_origin, rank, **geo)
            if not _hop_works(ranges, q_origin, rank, hi, lo, n_local, n_local,
                              backward=True):
                continue
            if full:
                hi, lo = None, None
            pack = packs[j]
            lse_x, delta_x = pack[..., 3 * d].contiguous(), pack[..., 3 * d + 1].contiguous()
            if impl == "torch":  # the blockwise backward's grouped layout
                lse_x, delta_x = (x.view(b, hk, h // hk, n_local) for x in (lse_x, delta_x))
            dq_i, dk_i, dv_i = _span_bwd(
                impl, pack[..., d:2 * d].to(dtype).contiguous(),
                pack[..., :d].to(dtype).contiguous(), ks[j], vs[j], lse_x, delta_x,
                None if masks is None else masks[j], hi, lo, cfg["scale"],
                cfg["bucket_size"], cfg["softclamp_value"],
                None if q_segs is None else q_segs[j], None if segs is None else segs[j])
            pack[..., 2 * d:3 * d] += dq_i
            dks[j].add_(dk_i)
            dvs[j].add_(dv_i)
        if i < passes - 1:
            moved = _rotate(ring, [(p,) + (() if q_segs is None else (q_segs[j],))
                                   for j, p in enumerate(packs)], -1)
            packs = [m[0] for m in moved]
            if q_segs is not None:
                q_segs = [m[1] for m in moved]
    dqs = [(p[..., 2 * d:3 * d].contiguous(),) for p in packs]
    dqs = _rotate(ring, dqs, (passes - 1) % world)
    return [dq for (dq,) in dqs], dks, dvs


def _ring_bwd(dos, qs, ks, vs, masks, segs, ranges, outs, lses, ring, cfg):
    """Backward of every held rank: ``(dqs, dks, dvs)``, dq in float32 and
    dk/dv in ``cfg["dkv_dtype"]``.  Dispatched on ``counter_rotate``
    before ``lse`` is read: the counter forward's is flat on both impls."""
    if cfg["counter_rotate"]:
        return _counter_bwd(dos, qs, ks, vs, masks, segs, ranges, outs, lses, ring, cfg)
    # the fused forward keeps the scan-path backward of the kernels, as the
    # JAX _ring_vjp_bwd maps "fused" to "pallas"
    impl = "cuda" if cfg["impl"] == "fused" else cfg["impl"]
    n_local = qs[0].shape[2]
    hk = ks[0].shape[1]
    ring_size, passes, streams = ring.world, cfg["passes"], cfg["streams"]
    geo = _geometry(cfg, n_local, ring_size)
    if impl == "cuda":  # lse and delta in the flat (b, h, n) layout
        deltas = [(do.float() * o.float()).sum(-1) for do, o in zip(dos, outs)]
    else:
        deltas = [(_group_q(do, hk).float() * _group_q(o, hk).float()).sum(-1)
                  for do, o in zip(dos, outs)]
    exact = dict(cfg, compute_dtype=None, hop_compression=None)
    payloads = [p for p, _ in _stream_state(ks, vs, masks, segs, exact, streams)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    # the circulating dk/dv accumulators: float32, or dkv_dtype (each hop's
    # float32 share cast before it is added)
    acc = cfg["dkv_dtype"]
    dkvs = [[(torch.zeros((*k.shape[:2], nk, k.shape[3]), dtype=acc, device=k.device),
              torch.zeros((*k.shape[:2], nk, k.shape[3]), dtype=acc, device=k.device))
             for k in ks] for _, _, nk in streams]
    for i in range(passes):
        for si, stream in enumerate(streams):
            full = impl == "cuda" and _hop_is_full(stream, i, **geo)
            for j, rank in enumerate(ring.ranks):
                (kx, vx), mask, kv_seg = _unpack(payloads[si][j], masks is not None)
                hi, lo = _stream_offsets(stream, rank, i, **geo)
                if not _hop_works(ranges, rank, _stream_origin(stream, rank, i, ring_size),
                                  hi, lo, n_local, stream[2], si, backward=True):
                    continue
                if full:
                    hi, lo = None, None
                dq_i, dk_i, dv_i = _span_bwd(
                    impl, dos[j], qs[j], kx, vx, lses[j], deltas[j], mask, hi, lo,
                    cfg["scale"], cfg["bucket_size"], cfg["softclamp_value"],
                    None if segs is None else segs[j], kv_seg,
                )
                dqs[j] += dq_i
                dkvs[si][j][0].add_(dk_i.to(acc))
                dkvs[si][j][1].add_(dv_i.to(acc))
            # dk/dv travel with their k/v; after the last hop only they move on
            if i < passes - 1:
                payloads[si] = _rotate(ring, payloads[si], stream[0])
            dkvs[si] = _rotate(ring, dkvs[si], stream[0])
    # after `passes` rotations by `shift` the dk/dv on a rank belong to origin
    # (rank - shift * passes): one composed rotation a stream returns each to
    # its owner, and the streams' spans join along the sequence
    for si, stream in enumerate(streams):
        dkvs[si] = _rotate(ring, dkvs[si], (stream[0] * (ring_size - passes)) % ring_size)
    return (dqs, [torch.cat([dkvs[si][j][0] for si in range(len(streams))], dim=2)
                  for j in range(len(ks))],
            [torch.cat([dkvs[si][j][1] for si in range(len(streams))], dim=2)
             for j in range(len(ks))])


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
    region keeps (``ops/residuals.py``; JAX tags them in its scan ring and
    its counter-rotated one): its recompute takes them back and runs no
    hop.  The fused ring tags none, as in JAX, and reruns.  The shards are
    saved tensors, so that a checkpointed region frees them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seg, ring, cfg):
        count = len(ring.ranks)
        qs, ks, vs = (_shards(x, count, 2) for x in (q, k, v))
        masks, segs = _shards(kv_mask, count, 1), _shards(seg, count, 1)
        ranges = _seg_ranges(ring, segs, cfg["streams"])
        if cfg["counter_rotate"]:
            fwd = _counter_fwd
        else:
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


def _dkv_dtype(dkv_dtype) -> torch.dtype:
    """The dk/dv accumulators' dtype: float32 for None, a name of
    ``DKV_DTYPES`` or a floating torch dtype."""
    if dkv_dtype is None:
        return torch.float32
    dtype = dkv_dtype if isinstance(dkv_dtype, torch.dtype) else DKV_DTYPES.get(dkv_dtype)
    if dtype is None or not dtype.is_floating_point:
        raise ValueError(
            f"ring_flash_attention: dkv_dtype={dkv_dtype!r}; supported values are None "
            f"(float32 accumulators) and the floating dtypes {tuple(DKV_DTYPES)}"
        )
    return dtype


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
    dkv_dtype: str | torch.dtype | None = None,
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
      bidirectional: the two halves of each shard circulate in opposite
        directions, one rotation each a hop (the same bytes, both link
        directions).  Needs an even shard; limited passes run
        unidirectional, as in JAX (the reverse stream brings the far
        origins first).
      dkv_dtype: the dtype of the circulating dk/dv accumulators of the
        backward (None: float32; ``"bfloat16"`` halves the backward's ring
        bytes at the cost of a rounding per hop).
      segment_ids: packed sequences, a ``(b, n)`` integer tensor of document
        ids in the layout of ``q`` (``PAD_SEGMENT_ID`` marks padding): a
        query attends only keys of its document.  The kv ids rotate with k
        and v (``impl="fused"``: are gathered with them, and B7 takes them);
        a hop whose ids share no document with the queries' is skipped.
      counter_rotate: TokenRing's counter-rotation: the queries with their
        f32 ``(acc, m, l)`` rotate one way after even hops, KV the other
        after odd hops; its backward moves only the q side (see the
        module docstring).  It supersedes ``bidirectional``.
      hop_compression: ``"int8"`` quantizes each rank's K/V once at ring
        entry (per row, ``collectives.quantize_ring_payload``) and
        circulates the int8 bytes; every hop's float sweep reads them
        dequantized.  The backward recomputes from the exact K/V.
      compute_dtype: ``"int8"`` runs each hop's forward on int8 operands
        (``impl="cuda"`` or ``"fused"``, as the JAX ring needs the Pallas
        kernels): q and k quantized per row and v per block of
        ``bucket_size`` keys fitted to the stream's span, K/V once per
        stream at ring entry (from the int8 payload's bytes with
        ``hop_compression``: the dequant-free ring); the backward stays on
        the float kernels.

    JAX's rules: ``counter_rotate`` with ``impl="fused"`` is a
    ``ValueError`` (the alternating schedule has no fused form), as are a
    ``hop_compression`` other than None and ``"int8"``, an unknown
    ``dkv_dtype`` and ``bidirectional`` on an odd shard (JAX asserts);
    ``bidirectional`` with ``impl="fused"`` or with ``counter_rotate``
    warns and is dropped.

    Cross-attention (unequal q and kv shard lengths) bypasses the ring: each
    rank attends its local KV shard only, as in the JAX package (and takes
    no segment ids).

    Returns ``(b, h, n, d)`` in ``q.dtype``, in the layout of ``q``.
    """
    if impl not in IMPLS:
        raise ValueError(f"ring_flash_attention: impl must be one of {IMPLS}, got {impl!r}")
    if hop_compression not in HOP_COMPRESSIONS:
        raise ValueError(
            f"ring_flash_attention: hop_compression={hop_compression!r}; supported "
            'values are None (model-dtype hops) and "int8" (per-token absmax '
            "quantized hops)"
        )
    dkv = _dkv_dtype(dkv_dtype)
    int8 = int8_compute(compute_dtype, "ring_flash_attention")
    if int8 and impl == "torch":
        raise ValueError(
            'ring_flash_attention: compute_dtype="int8" runs on the CUDA kernels '
            'only; pass impl="cuda" or impl="fused" (the blockwise PyTorch flash '
            "has no int8 matmul form)"
        )
    if impl == "fused":
        if counter_rotate:
            raise ValueError(
                'ring_flash_attention: impl="fused" carries the whole hop schedule '
                "in one kernel launch; the counter-rotation schedule has no fused "
                'form (pass impl="cuda" with counter_rotate)'
            )
        if bidirectional:
            warnings.warn(
                'ring_flash_attention: impl="fused" circulates whole KV blocks inside '
                "the kernel; ignoring bidirectional half-streams",
                stacklevel=2,
            )
            bidirectional = False
    if counter_rotate and bidirectional:
        # a KV half co-moving with the queries never advances its pairing:
        # the two schedules do not compose
        warnings.warn(
            "ring_flash_attention: counter_rotate already loads both ring "
            "directions; ignoring bidirectional half-streams",
            stacklevel=2,
        )
        bidirectional = False
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
    passes = min(max_ring_passes or ring.world, ring.world)
    n_local = q.shape[2] // count
    # limited passes never see the reverse stream's useful origins in time:
    # they run unidirectional, as in JAX
    bidirectional = bool(bidirectional) and passes == ring.world
    if bidirectional and n_local % 2:
        raise ValueError(
            f"ring_flash_attention: the bidirectional ring needs an even local "
            f"sequence, got {n_local}"
        )
    streams = _streams(bidirectional, n_local)
    if impl == "torch":  # fitted once to the span every hop attends
        bucket_size = _fit_bucket(bucket_size, streams[0][2])
    cfg = dict(
        impl=impl, causal=causal, striped=striped, bucket_size=bucket_size,
        passes=passes, window=window, softclamp_value=softclamp_value, scale=scale,
        compute_dtype=compute_dtype, hop_compression=hop_compression,
        streams=streams, counter_rotate=bool(counter_rotate), dkv_dtype=dkv,
    )
    return _RingFlashAttention.apply(q, k, v, kv_mask, seg, ring, cfg)
