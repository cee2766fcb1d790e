"""Parity: the port's mask algebra (``ring_attention_tpu_torch/masks.py``)
against ``ring_attention_tpu/masks.py``, and the port's own certificate.

The same expressions are built in both modules and held to each other:

- ``oracle`` over numpy positions (global coordinates, with offsets and per
  head), ``tile_status`` on random tiles, ``key``, ``band_form``,
  ``kernel_form``'s fields and its ``MaskLoweringError`` text,
  ``parse_mask`` over every ``MASK_REGISTRY`` form and its errors,
  ``dense_mask``;
- the declared-packing helpers of ``ops/cuda_flash.py`` against
  ``ops/pallas_flash.py``'s (``_check_doc_starts``, ``_docs_block_aligned``,
  ``_doc_block_span``, ``_doc_runtime_ids``) and the port's closed-form
  tile count against ``_band_tile_count`` at the same blocks;
- the certificate (``masks.certify``) on aligned, misaligned and windowed
  packings, the tile count of the tables against the closed form, and
  hand-broken tables (a live tile dropped, a dead tile added, a count off)
  that it must reject.

Everything is exact: booleans, integers and strings.
"""

import numpy as np
import pytest
import torch

from ring_attention_tpu import masks as J
from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu_torch import masks as M
from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.ops.attention import check_doc_starts, doc_runtime_ids


def _both(build):
    """The same expression in both modules: ``build(module)``."""
    return build(J), build(M)


# name: the expression, built from a module's classes; ids are plain strings
EXPRESSIONS = {
    "full": lambda m: m.Full(),
    "causal": lambda m: m.Causal(),
    "window": lambda m: m.SlidingWindow(5),
    "causal_window": lambda m: m.Causal() & m.SlidingWindow(7),
    "causal_docs": lambda m: m.Causal() & m.DocumentMask((0, 9, 30)),
    "causal_docs_window": lambda m: m.Causal() & m.DocumentMask((0, 16, 32)) & m.SlidingWindow(6),
    "full_docs": lambda m: m.Full() & m.DocumentMask((0, 20)),
    "prefix": lambda m: m.PrefixLM(6),
    "dilated": lambda m: m.Dilated(3, 1),
    "or": lambda m: m.Causal() | m.PrefixLM(4),
    "not": lambda m: ~m.SlidingWindow(3),
    "perhead": lambda m: m.PerHead((m.Causal(), m.Causal() & m.SlidingWindow(4))),
    "nested": lambda m: (m.Causal() & m.SlidingWindow(9)) | (m.Dilated(4) & ~m.PrefixLM(2)),
    "segments": lambda m: m.Causal() & m.Segments(),
    "two_docs": lambda m: m.DocumentMask((0, 4)) & m.DocumentMask((0, 8)),
}


@pytest.mark.parametrize("name", list(EXPRESSIONS))
def test_oracle_key_and_tile_status_match_jax(name):
    jm, pm = _both(EXPRESSIONS[name])
    assert pm.key == jm.key
    assert pm.per_head == jm.per_head and pm.head_period == jm.head_period
    rng = np.random.default_rng(0)
    qpos, kpos = np.arange(40) + 3, np.arange(45)
    doc_ids = rng.integers(0, 3, 60)
    for head in range(pm.head_period):
        np.testing.assert_array_equal(pm.oracle(qpos, kpos, head, doc_ids),
                                      jm.oracle(qpos, kpos, head, doc_ids))
    if name == "segments":
        return  # runtime ids: no tile classification on either side
    for _ in range(50):
        qlo, klo = rng.integers(0, 40, 2)
        qhi, khi = qlo + rng.integers(0, 12), klo + rng.integers(0, 12)
        for head in range(pm.head_period):
            assert (pm.tile_status(qlo, qhi, klo, khi, head)
                    == jm.tile_status(qlo, qhi, klo, khi, head))


@pytest.mark.parametrize("name", list(EXPRESSIONS))
def test_band_and_kernel_form_match_jax(name):
    jm, pm = _both(EXPRESSIONS[name])
    assert M.band_form(pm) == J.band_form(jm)
    try:
        ref = J.kernel_form(jm)
    except J.MaskLoweringError as err:
        with pytest.raises(M.MaskLoweringError) as got:
            M.kernel_form(pm)
        assert str(got.value) == str(err)
        return
    got = M.kernel_form(pm)
    assert (got.causal, got.window, got.doc_starts, got.needs_segment_ids) == (
        ref.causal, ref.window, ref.doc_starts, ref.needs_segment_ids)


def test_constructor_errors_match_jax():
    for build in (lambda m: m.SlidingWindow(0), lambda m: m.Dilated(0),
                  lambda m: m.Dilated(3, 3), lambda m: m.PrefixLM(-1),
                  lambda m: m.DocumentMask((1, 5)), lambda m: m.DocumentMask((0, 5, 5)),
                  lambda m: m.PerHead(()),
                  lambda m: m.PerHead((m.PerHead((m.Causal(),)),))):
        with pytest.raises(ValueError) as ref:
            build(J)
        with pytest.raises(ValueError) as got:
            build(M)
        assert str(got.value) == str(ref.value)
    with pytest.raises(M.MaskLoweringError, match="declare the layout with DocumentMask"):
        M.Segments().oracle(np.arange(3), np.arange(3))


# every registry form, alone and composed
PARSED = ["full", "causal", "window:5", "prefix:3", "dilated:4+1", "dilated:2",
          "docs:0,16,32", "segments", "perhead(causal;causal&window:4)",
          "causal&window:512", "prefix:128|docs:0,64", "~window:3",
          "(causal|prefix:2)&docs:0,10", "causal&docs:0,64&segments"]


@pytest.mark.parametrize("expr", PARSED)
def test_parse_mask_matches_jax(expr):
    pm, jm = M.parse_mask(expr), J.parse_mask(expr)
    assert pm.key == jm.key
    assert M.parse_mask(pm.key).key == pm.key  # round trip
    pos = np.arange(70)
    ids = pos // 9
    for head in range(pm.head_period):
        np.testing.assert_array_equal(pm.oracle(pos, pos, head, ids),
                                      jm.oracle(pos, pos, head, ids))


def test_parse_mask_covers_the_registry_and_its_errors():
    assert M.MASK_REGISTRY == J.MASK_REGISTRY
    assert {e.split(":")[0].split("(")[0] for e in PARSED} >= set(M.MASK_REGISTRY)
    for bad in ("causal&", "window", "nope:3", "causal)", "(causal", "causal@"):
        with pytest.raises(J.MaskParseError) as ref:
            J.parse_mask(bad)
        with pytest.raises(M.MaskParseError) as got:
            M.parse_mask(bad)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", ["causal_docs_window", "perhead", "nested", "full_docs"])
def test_dense_mask_matches_jax(name):
    jm, pm = _both(EXPRESSIONS[name])
    for kw in (dict(nq=33, nk=40), dict(nq=16, nk=16, heads=3, q_offset=5, k_offset=2)):
        np.testing.assert_array_equal(M.dense_mask(pm, **kw), J.dense_mask(jm, **kw))


# ---------------------------------------------------------------------------
# the declared-packing helpers and the closed-form tile count
# ---------------------------------------------------------------------------


def test_doc_helpers_match_jax():
    starts = (0, 64, 192, 320)
    assert check_doc_starts(starts, 400, 400) == jpf._check_doc_starts(starts, 400, 400)
    for bad, n in (((0, 64), 64), ((5, 64), 100), ((0, 9, 9), 100), ((0, 5), (50, 60))):
        nq, nk = (n, n) if isinstance(n, int) else n
        with pytest.raises(ValueError) as ref:
            jpf._check_doc_starts(bad, nq, nk)
        with pytest.raises(ValueError) as got:
            check_doc_starts(bad, nq, nk)
        assert str(got.value) == str(ref.value)
    for blocks in ((64,), (64, 128), (32, 16), (128,)):
        assert cf.docs_block_aligned(starts, *blocks) == jpf._docs_block_aligned(starts, *blocks)
    for pos in (0, 63, 64, 200, 399):
        assert (cf.doc_block_span(starts, pos, 64, 7, 400)
                == jpf._doc_block_span(starts, pos, 64, 7, 400))
    np.testing.assert_array_equal(doc_runtime_ids(starts, 400, 2).numpy(),
                                  np.asarray(jpf._doc_runtime_ids(starts, 400, 2)))
    assert doc_runtime_ids(starts, 400, 2).dtype == torch.int32


# (n, block, tile, outer_is_q, hi, lo, doc_starts): q-major fwd/dq and
# k-major dk/dv geometries, aligned packings, windows, offsets
COUNTS = [
    (1024, 64, 64, True, 0, None, None),
    (1024, 64, 16, True, 0, -99, (0, 128, 384, 512)),
    (1024, 128, 64, False, 0, None, (0, 256, 768)),
    (1024, 64, 16, False, 0, -300, (0, 64, 640)),
    (512, 64, 64, True, 100, -37, None),
    (512, 64, 64, False, 0, -64, (0, 64, 128, 256)),
    (512, 64, 64, True, None, None, None),
]


@pytest.mark.parametrize("case", range(len(COUNTS)))
def test_closed_form_count_matches_jax_and_the_tables(case):
    n, block, tile, outer_is_q, hi, lo, starts = COUNTS[case]
    got = cf.band_tile_count(n, block, tile, outer_is_q, hi, lo, starts)
    table = cf.doc_tile_ranges(n, block, tile, outer_is_q, hi, lo, starts)
    assert int((table[:, 1] - table[:, 0]).sum()) == got
    assert table.shape == (-(-n // block), 2) and table.dtype == np.int32
    if hi is not None:  # the TPU grid needs a static band; its count at the same blocks
        bq, bk = (block, tile) if outer_is_q else (tile, block)
        ref = jpf._band_tile_count(n // bq, n // bk, bq, bk,
                                   (hi, hi, lo or 0, lo or 0), lo is not None,
                                   outer_is_q, doc_starts=starts)
        assert got == ref  # no block is empty here: the TPU's dummy entries add none


# ---------------------------------------------------------------------------
# the certificate of the CUDA kernels' tables
# ---------------------------------------------------------------------------

PACKINGS = {
    "aligned": (M.Causal() & M.DocumentMask((0, 128, 384, 512, 896)), 1024),
    "misaligned": (M.Causal() & M.DocumentMask((0, 100, 333, 700)), 1000),
    "windowed": (M.Causal() & M.DocumentMask((0, 256, 640)) & M.SlidingWindow(77), 1024),
    "half_aligned": (M.Causal() & M.DocumentMask((0, 64, 320)), 640),  # not for dk/dv bf16
    "causal": (M.Causal(), 3000),
    "segments": (M.Causal() & M.SlidingWindow(50) & M.Segments(), 700),
}


@pytest.mark.parametrize("name", list(PACKINGS))
def test_certificate_proves_the_tables(name):
    mask, n = PACKINGS[name]
    cert = M.certify(mask, n, use_cache=False)
    assert cert.ok, cert.violations
    assert cert.proof_n == min(n, M.CERT_ELEMENTWISE_MAX)
    form = M.kernel_form(M.static_mask(mask))
    for label, tiles in cert.tiles:
        pass_, dtype = label.split()
        block, tile, outer_is_q = cf.DOC_BLOCKS[(pass_, dtype == "bf16")]
        starts = form.doc_starts
        if starts is not None and not cf.docs_block_aligned(starts, block, tile):
            starts = None  # that pass runs on runtime ids
        assert tiles == cf.band_tile_count(n, block, tile, outer_is_q, 0,
                                           None if form.window is None else 1 - form.window,
                                           starts)
    assert M.require_certified(mask, n) is M.require_certified(mask, n)  # cached


def test_aligned_tables_drop_the_other_documents_tiles():
    mask, n = PACKINGS["aligned"]
    cert = dict(M.certify(mask, n, use_cache=False).tiles)
    plain = dict(M.certify(M.Causal(), n, use_cache=False).tiles)
    for label in cert:
        assert cert[label] < plain[label], label
    # half_aligned: the bf16 dk/dv pass (128-key blocks) keeps every causal tile
    half = dict(M.certify(*PACKINGS["half_aligned"], use_cache=False).tiles)
    causal = dict(M.certify(M.Causal(), 640, use_cache=False).tiles)
    assert half["dkv bf16"] == causal["dkv bf16"] and half["fwd bf16"] < causal["fwd bf16"]


def _broken(fn):
    orig = cf.doc_tile_ranges

    def build(*args, **kw):
        return fn(orig(*args, **kw).copy())

    return build


@pytest.mark.parametrize("rule,breakage", [
    ("sound", lambda t: (t.__setitem__((5, 1), t[5, 1] - 1), t)[1]),
    ("tight", lambda t: (t.__setitem__((5, 0), 0), t)[1]),
])
def test_certificate_rejects_broken_tables(monkeypatch, rule, breakage):
    mask, n = PACKINGS["windowed"]
    monkeypatch.setattr(cf, "doc_tile_ranges", _broken(breakage))
    cert = M.certify(mask, n, use_cache=False)
    assert not cert.ok and any(f"[rule: {rule}]" in v for v in cert.violations)
    assert any("[rule: tile-count]" in v for v in cert.violations)
    with pytest.raises(M.MaskCertificationError, match=r"block 5 .*\[rule: "):
        M.require_certified(mask, n, use_cache=False)


def test_certificate_rejects_a_count_off(monkeypatch):
    mask, n = PACKINGS["aligned"]
    count = cf.band_tile_count
    monkeypatch.setattr(cf, "band_tile_count", lambda *a, **k: count(*a, **k) + 1)
    cert = M.certify(mask, n, use_cache=False)
    assert not cert.ok and all("[rule: tile-count]" in v for v in cert.violations)


def test_certificate_refuses_masks_beyond_the_kernels():
    with pytest.raises(M.MaskLoweringError, match="has no kernel lowering yet"):
        M.certify(M.PrefixLM(8), 64)
