"""The fused ring forward, local tier, on the hand-written CUDA kernel
``csrc/flash_ring.cu``.

Host side of the port of ``ring_attention_tpu/ops/pallas_ring.py``'s local
tier (``fused_ring_local`` :208, launch :341): one launch per ring rank
walks that rank's whole hop schedule over an all-gathered KV span, keeping
the online-softmax state ``(acc, m, l)`` on chip across the hops, and
writes ``(out, lse)`` once.  The schedule is four int32 ``(hops,)`` tables
(``parallel/ring.py::_fused_tables``): the origin rank each hop reads, its
band offsets in per-hop local coordinates (attend iff ``lo <= j - i <=
hi``; the sentinels ``hi = n_local``, ``lo = -n_local`` mean unbanded) and
its work flag.

- ``fused_ring_local`` is the kernel wrapper: a CUDA tensor launches the
  kernel (or raises), a CPU tensor runs ``fused_ring_local_plain``.
  Nothing else selects between the two.  The C entry point shapes the
  launch: bf16 runs the forward kernel's sweep (``csrc/flash_sweep.cuh``),
  a block of 256 threads per 128 query rows and batch-head with B1's
  dynamic shared memory, so that its output is the ``impl="cuda"`` hop
  chain's bit for bit; f32 a block of 64 threads per 64 rows.
- ``fused_ring_local_plain`` is its plain version: the port's hop chain
  over slices of the gathered span, on the plain versions of
  ``ops/cuda_flash.py`` (seed partials, resumes, the fused write from the
  carry; hops whose work flag is 0 are skipped).
- ``q_seg``/``kv_seg`` (packed sequences, the JAX launch's
  ``q_segment_ids``/``kv_segment_ids``): int32 ``(b, n_local)`` ids of the
  rank's rows and ``(b, n_total)`` of the gathered keys, in the span's
  order; a pair attends only within one document.  They run the kernel's
  segmented instantiation, B1's segmented sweep hop by hop.
- ``kv_quantized`` (the JAX launch's int8 feed, ``:214, :257-269``): the
  gathered span's K/V already quantized, k per row and v per block of the
  launch's fitted block (``fitted_blocks``, the JAX ``pallas_ring.py:105``
  fit), as a ``cuda_flash_q8.Int8KV`` (or a ``QuantizedBlockKV``, laid out
  here); only q is quantized, once per launch.  It runs the kernel's int8
  instantiation (with ids: its segmented one), B4's sweep
  (``csrc/flash_sweep_q8.cuh``) walked hop by hop, so that its output is
  the int8 hop chain's (``impl="cuda"``, ``compute_dtype="int8"``, fed the
  same feed) bit for bit.  The plain version is that chain on
  ``cuda_flash_q8``'s plain versions, each hop fed its origin's slice of
  the feed.  The float kernels' 64- and 128-row blocks do not depend on
  the fit.

``launch_count`` counts the kernel's launches, ``seg_launch_count`` again
those that took ids and ``q8_launch_count`` those of the int8
instantiations; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_flash import (
    _check_kernel_args,
    _check_launch,
    flash_fwd_reference,
    flash_partials_reference,
)
from .cuda_flash_q8 import (
    Int8KV,
    flash_fwd_q8_reference,
    flash_partials_q8_reference,
    kernel_kv,
    q8_block,
)
from .partials import finalize_partials, init_partials
from .quant import quantize_rows

# Kernel launches since the last reset; the caller may set them to 0.
launch_count = 0
seg_launch_count = 0  # those of the segmented instantiations
q8_launch_count = 0  # those of the int8 instantiations


def fitted_blocks(n_local: int, block_q: int | None = None,
                  block_k: int | None = None) -> tuple[int, int]:
    """``(bq, bk)`` the JAX fused launch runs for ``n_local`` (each
    ``min(block or 1024, n_local)`` halved until it divides ``n_local``):
    an int8 feed must be quantized per block of ``bk`` keys."""
    return q8_block(n_local, block_q), q8_block(n_local, block_k)


def _check_tables(origins, his, los, works, device) -> int:
    """The four hop tables: int32, one dimension, one length, on
    ``device``; returns the hop count."""
    hops = origins.shape[0] if origins.dim() == 1 else -1
    for name, t in (("origins", origins), ("his", his), ("los", los), ("works", works)):
        if t.dim() != 1 or t.shape[0] != hops or t.dtype != torch.int32:
            raise ValueError(
                f"fused_ring_local: {name} must be int32 of shape ({hops},), got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != device:
            raise ValueError(f"fused_ring_local: {name} on {t.device}, q on {device}")
    if hops < 1:
        raise ValueError("fused_ring_local: the hop tables are empty")
    return hops


def _check_ids(q, k_all, q_seg, kv_seg) -> None:
    """The ids go together: int32 ``(b, n_local)`` and ``(b, n_total)``."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("fused_ring_local: q_seg and kv_seg go together")
    if q_seg is None:
        return
    for name, ids, n in (("q_seg", q_seg, q.shape[2]), ("kv_seg", kv_seg, k_all.shape[2])):
        if tuple(ids.shape) != (q.shape[0], n) or ids.dtype != torch.int32:
            raise ValueError(
                f"fused_ring_local: {name} must be int32 of shape ({q.shape[0]}, {n}), "
                f"got {ids.dtype} {tuple(ids.shape)}"
            )


def _check_feed(q, kv_quantized, n_local, block_k) -> Int8KV:
    """The int8 feed in the kernel's form, at the launch's fitted block."""
    feed = kernel_kv(kv_quantized)
    bk = fitted_blocks(n_local, None, block_k)[1]
    if feed.block != bk:
        raise ValueError(
            f"fused_ring_local: kv feed block {feed.block} != fitted bk {bk}; "
            "quantize the feed at fitted_blocks()"
        )
    if feed.k8.dim() != 4 or feed.k8.shape[0] != q.shape[0] or feed.k8.shape[3] != q.shape[3]:
        raise ValueError(f"fused_ring_local: feed k8 {tuple(feed.k8.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    return feed


def _feed_rows(feed: Int8KV, origin: int, n_local: int) -> Int8KV:
    """The slice of a gathered feed that holds rank ``origin``'s keys."""
    rows = slice(origin * n_local, (origin + 1) * n_local)
    blocks = slice(origin * n_local // feed.block, (origin + 1) * n_local // feed.block)
    return Int8KV(feed.k8[:, :, rows], feed.k_scale[:, :, rows], feed.v8t[:, :, blocks],
                  feed.v_scale[:, :, blocks], feed.block)


def _check_span(q, k_all, v_all, kv_mask, n_local) -> None:
    b, h, n_q, d = q.shape
    if k_all.dim() != 4 or v_all.shape != k_all.shape:
        raise ValueError(
            f"fused_ring_local: k_all and v_all must be (b, hk, n_total, d), got "
            f"{tuple(k_all.shape)} and {tuple(v_all.shape)}"
        )
    bk, hk, n_total, dk = k_all.shape
    if bk != b or dk != d:
        raise ValueError(
            f"fused_ring_local: q {tuple(q.shape)} and k_all {tuple(k_all.shape)} "
            "disagree on batch or head dim"
        )
    if h % hk:
        raise ValueError(f"fused_ring_local: query heads {h} not a multiple of kv heads {hk}")
    if n_q != n_local:
        raise ValueError(f"fused_ring_local: q length {n_q} != n_local {n_local}")
    if n_total % n_local:
        raise ValueError(
            f"fused_ring_local: gathered span {n_total} not a multiple of {n_local}"
        )
    if kv_mask is not None and tuple(kv_mask.shape) != (b, n_total):
        raise ValueError(
            f"fused_ring_local: kv_mask must be ({b}, {n_total}), got "
            f"{tuple(kv_mask.shape)}"
        )


def fused_ring_local_plain(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    origins: torch.Tensor,
    his: torch.Tensor,
    los: torch.Tensor,
    works: torch.Tensor,
    n_local: int,
    scale: float,
    softclamp_value: float | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    kv_quantized=None,
    block_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_ring_local`: the hop chain of
    ``parallel/ring.py`` over the origins' blocks of the gathered span.

    Each hop with work folds ``k_all[:, :, o * n_local:(o + 1) * n_local]``
    (``o = origins[hop]``) into the carry under its band, the last one
    writing ``(out, lse)`` from it; with dense f32 scores, as
    ``flash_partials_reference`` computes them, or, with ``kv_quantized``,
    the int8 sweep's plain version on the origin's slice of the feed.
    Returns ``(out (b, h, n_local, d) in q.dtype, lse (b, h, n_local)
    f32)``."""
    feed = None
    if kv_quantized is not None:
        feed = _check_feed(q, kv_quantized, n_local, block_k)
        k_all = v_all = feed.k8
    _check_span(q, k_all, v_all, kv_mask, n_local)
    _check_ids(q, k_all, q_seg, kv_seg)
    schedule = [(o, hi, lo) for o, hi, lo, w in
                zip(origins.tolist(), his.tolist(), los.tolist(), works.tolist()) if w]
    carry = None
    for i, (o, hi, lo) in enumerate(schedule):
        rows = slice(o * n_local, (o + 1) * n_local)
        k, v = k_all[:, :, rows], v_all[:, :, rows]
        if feed is not None:
            k = v = None
        carry = fold_hop(q, k, v,
                         None if kv_mask is None else kv_mask[:, rows], hi, lo, carry,
                         i == len(schedule) - 1, scale, softclamp_value,
                         q_seg, None if kv_seg is None else kv_seg[:, rows],
                         None if feed is None else _feed_rows(feed, o, n_local))
    if carry is None:  # no hop with work: the empty state, normalized, as the
        # kernel writes it (never on a ring's schedule, whose own hop has work)
        out, lse = finalize_partials(init_partials(*q.shape, device=q.device))
        return out.to(q.dtype), lse
    return carry


def fold_hop(q, k, v, kv_mask, hi, lo, carry, last, scale, softclamp_value,
             q_seg=None, kv_seg=None, feed=None):
    """One hop of the plain hop chain: ``(k, v)`` folded into ``carry``
    (None on the first hop with work) under the band ``lo <= j - i <= hi``
    (and the ids, when given); the new f32 partials, or on the ``last`` hop
    ``(out, lse)``.  With ``feed`` (the hop's int8 K/V, an ``Int8KV``), the
    int8 sweep's plain version at the feed's block instead."""
    kw = dict(scale=scale, causal_offset=hi, window_lo=lo,
              softclamp_value=softclamp_value, carry=carry, q_seg=q_seg, kv_seg=kv_seg)
    if feed is not None:
        kw.update(kv_quantized=feed, block_k=feed.block)
        fn = flash_fwd_q8_reference if last else flash_partials_q8_reference
        return fn(q, None, None, kv_mask, **kw)
    if last:
        return flash_fwd_reference(q, k, v, kv_mask, **kw)
    return flash_partials_reference(q, k, v, kv_mask, **kw)


def _launch(q, k_all, v_all, kv_mask, tables, scale, softclamp_value, q_seg=None,
            kv_seg=None):
    if q.device.type != "cuda":
        raise ValueError(f"fused_ring_local: no kernel for device {q.device}")
    hops = _check_tables(*tables, q.device)
    _check_kernel_args("fused_ring_local", q, k_all, v_all, kv_mask)
    for ids in (q_seg, kv_seg):
        if ids is not None and (ids.device != q.device or not ids.is_contiguous()):
            raise ValueError("fused_ring_local: the ids must be contiguous, on q's device")
    if any(not t.is_contiguous() for t in tables):
        raise ValueError("fused_ring_local: the hop tables must be contiguous")
    from ._build import flash_ring_library

    lib = flash_ring_library()
    b, h, n, d = q.shape
    _, hk, n_total, _ = k_all.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_ring(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            *(t.data_ptr() for t in tables), hops,
            out.data_ptr(), lse.data_ptr(),
            b, h, hk, n, n_total, d, int(q.dtype == torch.bfloat16),
            float(scale), float(softclamp_value or 0.0),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr(), ctypes.c_void_p(stream),
        )
    _check_launch(rc, "fused_ring_local", q, k_all)
    global launch_count, seg_launch_count
    launch_count += 1
    seg_launch_count += q_seg is not None
    return out, lse


def _launch_q8(q, feed: Int8KV, kv_mask, tables, scale, softclamp_value, q_seg=None,
               kv_seg=None):
    """One launch of the int8 instantiation: q quantized per row here, the
    gathered span's K/V from the feed."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_ring_local: no kernel for device {q.device}")
    hops = _check_tables(*tables, q.device)
    b, h, n, d = q.shape
    _, hk, n_total, _ = feed.k8.shape
    q8, qs = quantize_rows(q)
    padded = feed.v8t.shape[-1]
    rows = ((qs, (b, h, n), torch.float32), (feed.k_scale, (b, hk, n_total), torch.float32),
            (feed.v8t, (b, hk, n_total // feed.block, d, padded), torch.int8),
            (feed.v_scale, (b, hk, n_total // feed.block), torch.float32))
    _check_kernel_args("fused_ring_local", q8, feed.k8, feed.v8t, kv_mask, *rows,
                       dtypes=(torch.int8,), segs=(q_seg, kv_seg))
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_ring_local: output dtype {q.dtype} unsupported")
    if any(not t.is_contiguous() for t in tables):
        raise ValueError("fused_ring_local: the hop tables must be contiguous")
    from ._build import flash_ring_q8_library

    lib = flash_ring_q8_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_ring_q8(
            q8.data_ptr(), qs.data_ptr(), feed.k8.data_ptr(), feed.k_scale.data_ptr(),
            feed.v8t.data_ptr(), feed.v_scale.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            *(t.data_ptr() for t in tables), hops, out.data_ptr(), lse.data_ptr(),
            b, h, hk, n, n_total, d, feed.block, int(q.dtype == torch.bfloat16),
            float(scale), float(softclamp_value or 0.0),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr(), ctypes.c_void_p(stream),
        )
    _check_launch(rc, "fused_ring_local", q, feed.k8)
    global launch_count, seg_launch_count, q8_launch_count
    launch_count += 1
    seg_launch_count += q_seg is not None
    q8_launch_count += 1
    return out, lse


def fused_ring_local(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    origins: torch.Tensor,
    his: torch.Tensor,
    los: torch.Tensor,
    works: torch.Tensor,
    n_local: int,
    scale: float,
    softclamp_value: float | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    kv_quantized=None,
    block_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused ring forward of one rank over a gathered KV span.

    Args:
      q: ``(b, h, n_local, d)``, this rank's queries.
      k_all, v_all: ``(b, hk, n_total, d)``, every rank's keys and values
        in ring order (rank-major).
      kv_mask: optional ``(b, n_total)`` bool key mask in the same order.
      origins, his, los, works: the ``(hops,)`` int32 hop schedule
        (``parallel/ring.py::_fused_tables``), on q's device.
      n_local, scale, softclamp_value: the rank's shard length, the score
        scale and the optional soft clamp.
      q_seg, kv_seg: optional int32 document ids, ``(b, n_local)`` of the
        rank's rows and ``(b, n_total)`` of the gathered keys (packed
        sequences; the segmented instantiation).
      kv_quantized, block_k: the int8 feed of the gathered span (k_all and
        v_all are then ignored and may be None), quantized at
        ``fitted_blocks(n_local, None, block_k)[1]``, or the call raises;
        the int8 instantiation.

    Returns ``(out (b, h, n_local, d) in q.dtype, lse (b, h, n_local)
    f32)``, lse = m + log l.  A CPU tensor runs
    :func:`fused_ring_local_plain`; a CUDA tensor launches the kernel,
    which trusts every origin to lie in ``[0, n_total / n_local)``."""
    if q.device.type == "cpu":
        return fused_ring_local_plain(
            q, k_all, v_all, kv_mask, origins=origins, his=his, los=los,
            works=works, n_local=n_local, scale=scale,
            softclamp_value=softclamp_value, q_seg=q_seg, kv_seg=kv_seg,
            kv_quantized=kv_quantized, block_k=block_k,
        )
    if kv_quantized is not None:
        feed = _check_feed(q, kv_quantized, n_local, block_k)
        _check_span(q, feed.k8, feed.k8, kv_mask, n_local)
        _check_ids(q, feed.k8, q_seg, kv_seg)
        return _launch_q8(q, feed, kv_mask, (origins, his, los, works), scale,
                          softclamp_value, q_seg, kv_seg)
    _check_span(q, k_all, v_all, kv_mask, n_local)
    _check_ids(q, k_all, q_seg, kv_seg)
    return _launch(q, k_all, v_all, kv_mask, (origins, his, los, works), scale,
                   softclamp_value, q_seg, kv_seg)
