"""The mask algebra: composable attention masks and their kernel forms.

Port of the execution half of ``ring_attention_tpu/masks.py`` (numpy only,
no torch at module level): the :class:`Mask` classes with their exact
``oracle`` over global ``(q_pos, k_pos, head)`` coordinates, their
``tile_status`` closed forms, ``key`` text and the ``&``, ``|``, ``~``
combinators (:85-556); :func:`band_form` and :func:`kernel_form` (:564-657),
which resolve a mask onto the knobs the kernels speak (``causal``,
``window``, a declared ``doc_starts`` packing, runtime ``segment_ids``);
:func:`dense_mask` (:1011); :func:`parse_mask` and :data:`MASK_REGISTRY`
(:1256-1374); and the three error classes, with the JAX module's messages.

The certificate is the port's own (:func:`certify`,
:func:`require_certified`): the JAX certifier reads the TPU grids
(``band_plan`` and its flag tables), while the CUDA kernels visit the tile
ranges that ``ops/cuda_flash.py::doc_tile_ranges`` hands each pass.  A
certificate enumerates those ranges for the single sweep (B1, B2 and B3 at
each of their block geometries) and proves them against ``mask.oracle``:
**sound** (no live pair skipped), **tight** (no tile without a live pair
visited, where the tables carry the whole mask) and **complete** (the
tile count equals the closed form, :func:`~ring_attention_tpu_torch.ops.
cuda_flash.band_tile_count`).  The ring strategies' hop-schedule
certificates are not ported (ROADMAP.md Port queue item 7g).
"""

from __future__ import annotations

import re
from bisect import bisect_right
from dataclasses import dataclass

import numpy as np

__all__ = [
    "Mask", "Full", "Causal", "SlidingWindow", "Dilated", "Striped",
    "PrefixLM", "DocumentMask", "Segments", "PerHead",
    "And", "Or", "Not",
    "KernelForm", "Certificate",
    "MaskLoweringError", "MaskCertificationError", "MaskParseError",
    "band_form", "kernel_form", "certify", "require_certified",
    "parse_mask", "MASK_REGISTRY", "dense_mask",
]

# Above this many positions, certify() proves the elementwise half on the
# leading CERT_ELEMENTWISE_MAX positions and the tile count at the full
# shape, as the JAX certifier does (an O(n^2) oracle at 65,536 is 4.3e9
# elements).
CERT_ELEMENTWISE_MAX = 2048


class MaskLoweringError(ValueError):
    """The mask has no lowering for the requested target (named in the
    message, along with the forms the target supports)."""


class MaskCertificationError(ValueError):
    """A lowering failed its soundness/tightness/completeness proof.
    The message is the first violation line: mask, hop, tile."""


class MaskParseError(ValueError):
    """A textual mask expression did not parse; lists the registry."""


# ---------------------------------------------------------------------------
# The algebra
# ---------------------------------------------------------------------------


class Mask:
    """Base class: combinators plus the oracle/lowering contract.

    Subclasses are frozen dataclasses (hashable: their ``key`` keys the
    certificate cache).
    """

    def __and__(self, other: "Mask") -> "Mask":
        return And((self, other))

    def __or__(self, other: "Mask") -> "Mask":
        return Or((self, other))

    def __invert__(self) -> "Mask":
        return Not(self)

    # -- oracle ---------------------------------------------------------
    def oracle(self, qpos, kpos, head: int = 0, doc_ids=None) -> np.ndarray:
        """Exact ``(len(qpos), len(kpos))`` bool truth over GLOBAL token
        positions — the independent ground truth every lowering is
        certified against."""
        raise NotImplementedError

    # -- exact tile classification (the generic lowering's closed forms) -
    def tile_status(self, qlo: int, qhi: int, klo: int, khi: int,
                    head: int = 0) -> tuple[bool, bool]:
        """Exact ``(any_live, all_live)`` of the tile spanning global
        rows ``[qlo, qhi]`` x cols ``[klo, khi]`` (inclusive,
        contiguous).  Leaves use closed forms; combinators combine them
        and refine the genuinely ambiguous cases elementwise."""
        raise NotImplementedError

    @property
    def key(self) -> str:
        """Canonical textual form — the certificate-cache key half and
        the diagnostic name; round-trips through :func:`parse_mask` for
        every parseable form."""
        raise NotImplementedError

    @property
    def per_head(self) -> bool:
        return False

    @property
    def head_period(self) -> int:
        """Number of distinct head variants (1 for head-independent
        masks; combinators take the lcm of their children) — what a
        certificate must enumerate."""
        return 1

    def head_mask(self, head: int) -> "Mask":
        """The mask head ``head`` actually attends under (identity for
        head-independent masks)."""
        return self

    def __repr__(self) -> str:
        return f"{type(self).__name__}<{self.key}>"


def _lcm_all(values) -> int:
    import math

    out = 1
    for v in values:
        out = out * v // math.gcd(out, v)
    return out


def static_mask(mask: "Mask") -> "Mask":
    """The trace-time part of a mask: :class:`Segments` leaves (runtime
    per-token ids, masked in-kernel) drop out of conjunctions — the
    grids a lowering emits are those of the remaining static terms,
    exactly like the misaligned-document fallback.  A ``Segments``
    under ``Or``/``Not`` has no sound static grid and stays (its oracle
    raises with the DocumentMask pointer)."""
    if isinstance(mask, Segments):
        return Full()
    if isinstance(mask, And):
        kept = tuple(static_mask(m) for m in mask.operands
                     if not isinstance(m, Segments))
        if not kept:
            return Full()
        return kept[0] if len(kept) == 1 else And(kept)
    if isinstance(mask, PerHead):
        return PerHead(tuple(static_mask(m) for m in mask.masks))
    return mask


def _tile_eval(mask: Mask, qlo, qhi, klo, khi, head) -> tuple[bool, bool]:
    """Elementwise refinement for combinator tiles the tri-state rules
    cannot decide (exact, O(tile))."""
    m = mask.oracle(np.arange(qlo, qhi + 1), np.arange(klo, khi + 1), head)
    return bool(m.any()), bool(m.all())


@dataclass(frozen=True)
class Full(Mask):
    """Every query attends every key."""

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        return np.ones((len(qpos), len(kpos)), bool)

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        return True, True

    @property
    def key(self):
        return "full"


@dataclass(frozen=True)
class Causal(Mask):
    """Attend iff ``k_pos <= q_pos``."""

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        return np.asarray(kpos)[None, :] <= np.asarray(qpos)[:, None]

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        return klo <= qhi, khi <= qlo

    @property
    def key(self):
        return "causal"


@dataclass(frozen=True)
class SlidingWindow(Mask):
    """Attend iff ``|q_pos - k_pos| < window`` (two-sided local band).

    Compose with :class:`Causal` for the usual causal sliding window —
    ``Causal() & SlidingWindow(w)`` keeps exactly the last ``w`` keys,
    matching the kernels' ``window=`` contract — or use standalone for
    bidirectional local attention."""

    window: int

    def __post_init__(self):
        if int(self.window) < 1:
            raise ValueError(f"SlidingWindow needs window >= 1, "
                             f"got {self.window}")

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        d = np.asarray(kpos)[None, :] - np.asarray(qpos)[:, None]
        return np.abs(d) < int(self.window)

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        w = int(self.window)
        # diff d = k - q ranges over [klo - qhi, khi - qlo]
        any_live = klo - qhi < w and khi - qlo > -w
        all_live = klo - qhi > -w and khi - qlo < w
        return any_live, all_live

    @property
    def key(self):
        return f"window:{int(self.window)}"


@dataclass(frozen=True)
class Dilated(Mask):
    """Attend iff ``(q_pos - k_pos) % stride == offset`` — the dilated /
    strided sparse pattern (LongNet-style; the stripe/zigzag schedules of
    Striped Attention, arXiv 2311.09431, are the ``stride = ring``
    member of this family)."""

    stride: int
    offset: int = 0

    def __post_init__(self):
        if int(self.stride) < 1:
            raise ValueError(f"Dilated needs stride >= 1, got {self.stride}")
        if not 0 <= int(self.offset) < int(self.stride):
            raise ValueError(
                f"Dilated offset must be in [0, stride), got {self.offset}"
            )

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        d = np.asarray(qpos)[:, None] - np.asarray(kpos)[None, :]
        return d % int(self.stride) == int(self.offset)

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        s, o = int(self.stride), int(self.offset)
        d_lo, d_hi = qlo - khi, qhi - klo  # d = q - k range
        # any: an integer d in [d_lo, d_hi] with d ≡ o (mod s)
        any_live = (d_hi - o) // s >= -((o - d_lo) // s)
        all_live = s == 1 or (d_lo == d_hi and (d_lo - o) % s == 0)
        return any_live, all_live

    @property
    def key(self):
        o = int(self.offset)
        return f"dilated:{int(self.stride)}" + (f"+{o}" if o else "")


# the issue's Dilated/Striped(stride) are one pattern; keep both names
Striped = Dilated


@dataclass(frozen=True)
class PrefixLM(Mask):
    """Attend iff ``k_pos < prefix_len`` or ``k_pos <= q_pos`` —
    bidirectional over the prompt prefix, causal after (T5/PaLM-style
    prefix language modeling)."""

    prefix_len: int

    def __post_init__(self):
        if int(self.prefix_len) < 0:
            raise ValueError(
                f"PrefixLM needs prefix_len >= 0, got {self.prefix_len}"
            )

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        k = np.asarray(kpos)[None, :]
        return (k < int(self.prefix_len)) | (k <= np.asarray(qpos)[:, None])

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        p = int(self.prefix_len)
        return (klo < p or klo <= qhi), (khi < p or khi <= qlo)

    @property
    def key(self):
        return f"prefix:{int(self.prefix_len)}"


@dataclass(frozen=True)
class DocumentMask(Mask):
    """Attend iff ``q_pos`` and ``k_pos`` lie in the same document of a
    DECLARED packing layout: ``doc_starts`` are sorted unique global
    start offsets beginning at 0 (the trace-time twin of runtime
    :class:`Segments`; block-aligned layouts compile the document mask
    into the tile tables, misaligned ones fall back to in-kernel
    runtime ids — see docs/masks.md)."""

    doc_starts: tuple[int, ...]

    def __post_init__(self):
        ds = tuple(int(s) for s in self.doc_starts)
        if not ds or ds[0] != 0 or list(ds) != sorted(set(ds)):
            raise ValueError(
                f"DocumentMask doc_starts must be sorted unique offsets "
                f"starting at 0, got {self.doc_starts!r}"
            )
        object.__setattr__(self, "doc_starts", ds)

    def _doc_of_scalar(self, pos: int) -> int:
        return bisect_right(self.doc_starts, pos) - 1

    def _doc_of(self, pos) -> np.ndarray:
        return np.searchsorted(
            np.asarray(self.doc_starts), np.asarray(pos), side="right"
        ) - 1

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        return self._doc_of(qpos)[:, None] == self._doc_of(kpos)[None, :]

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        dq_lo, dq_hi = self._doc_of_scalar(qlo), self._doc_of_scalar(qhi)
        dk_lo, dk_hi = self._doc_of_scalar(klo), self._doc_of_scalar(khi)
        any_live = dq_lo <= dk_hi and dk_lo <= dq_hi
        all_live = dq_lo == dq_hi == dk_lo == dk_hi
        return any_live, all_live

    @property
    def key(self):
        return "docs:" + ",".join(str(s) for s in self.doc_starts)


@dataclass(frozen=True)
class Segments(Mask):
    """Runtime packed-sequence masking: attend iff the per-token segment
    ids (a RUNTIME array, supplied at call time) match.  Has no static
    oracle — certification rows use :class:`DocumentMask`, the declared
    trace-time layout; :func:`kernel_form` maps this leaf onto the
    ``segment_ids`` execution path."""

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        if doc_ids is None:
            raise MaskLoweringError(
                "Segments is a runtime mask (per-token ids supplied at "
                "call time); a static oracle needs doc_ids — declare the "
                "layout with DocumentMask to certify it"
            )
        ids = np.asarray(doc_ids)
        return ids[np.asarray(qpos)][:, None] == ids[np.asarray(kpos)][None, :]

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        raise MaskLoweringError(
            "Segments has no trace-time tile classification (runtime "
            "ids); use DocumentMask for a declared layout"
        )

    @property
    def key(self):
        return "segments"


@dataclass(frozen=True)
class PerHead(Mask):
    """Per-head mask selection: head ``h`` attends under
    ``masks[h % len(masks)]`` (splash-attention's ``MultiHeadMask``)."""

    masks: tuple[Mask, ...]

    def __post_init__(self):
        ms = tuple(self.masks)
        if not ms or not all(isinstance(m, Mask) for m in ms):
            raise ValueError("PerHead needs a non-empty tuple of masks")
        if any(m.per_head for m in ms):
            raise ValueError("PerHead masks cannot nest PerHead")
        object.__setattr__(self, "masks", ms)

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        return self.head_mask(head).oracle(qpos, kpos, head, doc_ids)

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        return self.head_mask(head).tile_status(qlo, qhi, klo, khi, head)

    @property
    def per_head(self):
        return True

    @property
    def head_period(self):
        return len(self.masks)

    def head_mask(self, head: int) -> Mask:
        return self.masks[head % len(self.masks)]

    @property
    def key(self):
        return "perhead(" + ";".join(m.key for m in self.masks) + ")"


@dataclass(frozen=True)
class And(Mask):
    """Intersection of the operand masks."""

    operands: tuple[Mask, ...]

    def __post_init__(self):
        flat: list[Mask] = []
        for m in self.operands:
            flat.extend(m.operands if isinstance(m, And) else (m,))
        object.__setattr__(self, "operands", tuple(flat))

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        out = self.operands[0].oracle(qpos, kpos, head, doc_ids)
        for m in self.operands[1:]:
            out = out & m.oracle(qpos, kpos, head, doc_ids)
        return out

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        stats = [m.tile_status(qlo, qhi, klo, khi, head)
                 for m in self.operands]
        if not all(any_live for any_live, _ in stats):
            return False, False
        if all(all_live for _, all_live in stats):
            return True, True
        # children each touch the tile but none fills it alone — the
        # intersection may still be empty; decide exactly
        return _tile_eval(self, qlo, qhi, klo, khi, head)

    @property
    def per_head(self):
        return any(m.per_head for m in self.operands)

    @property
    def head_period(self):
        return _lcm_all(m.head_period for m in self.operands)

    def head_mask(self, head):
        return And(tuple(m.head_mask(head) for m in self.operands))

    @property
    def key(self):
        return "(" + "&".join(m.key for m in self.operands) + ")"


@dataclass(frozen=True)
class Or(Mask):
    """Union of the operand masks."""

    operands: tuple[Mask, ...]

    def __post_init__(self):
        flat: list[Mask] = []
        for m in self.operands:
            flat.extend(m.operands if isinstance(m, Or) else (m,))
        object.__setattr__(self, "operands", tuple(flat))

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        out = self.operands[0].oracle(qpos, kpos, head, doc_ids)
        for m in self.operands[1:]:
            out = out | m.oracle(qpos, kpos, head, doc_ids)
        return out

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        stats = [m.tile_status(qlo, qhi, klo, khi, head)
                 for m in self.operands]
        if any(all_live for _, all_live in stats):
            return True, True
        if not any(any_live for any_live, _ in stats):
            return False, False
        any_live = True  # some child touches the tile
        # full only if the union covers it — decide exactly
        _, all_live = _tile_eval(self, qlo, qhi, klo, khi, head)
        return any_live, all_live

    @property
    def per_head(self):
        return any(m.per_head for m in self.operands)

    @property
    def head_period(self):
        return _lcm_all(m.head_period for m in self.operands)

    def head_mask(self, head):
        return Or(tuple(m.head_mask(head) for m in self.operands))

    @property
    def key(self):
        return "(" + "|".join(m.key for m in self.operands) + ")"


@dataclass(frozen=True)
class Not(Mask):
    """Complement of the operand mask."""

    operand: Mask

    def oracle(self, qpos, kpos, head=0, doc_ids=None):
        return ~self.operand.oracle(qpos, kpos, head, doc_ids)

    def tile_status(self, qlo, qhi, klo, khi, head=0):
        any_live, all_live = self.operand.tile_status(
            qlo, qhi, klo, khi, head
        )
        return not all_live, not any_live

    @property
    def per_head(self):
        return self.operand.per_head

    @property
    def head_period(self):
        return self.operand.head_period

    def head_mask(self, head):
        return Not(self.operand.head_mask(head))

    @property
    def key(self):
        return "~" + self.operand.key


# ---------------------------------------------------------------------------
# Canonical band / kernel forms (the execution mapping)
# ---------------------------------------------------------------------------


def band_form(mask: Mask) -> tuple[int | None, int | None] | None:
    """``(hi, lo)`` of a pure band mask — attend iff
    ``lo <= k_pos - q_pos <= hi`` with ``None`` meaning unbounded — or
    ``None`` when the mask is not a band.  This is the repo's unified
    banded-offset contract (``ops/flash.py``), in global coordinates."""
    if isinstance(mask, Full):
        return (None, None)
    if isinstance(mask, Causal):
        return (0, None)
    if isinstance(mask, SlidingWindow):
        w = int(mask.window)
        return (w - 1, -(w - 1))
    if isinstance(mask, And):
        hi: int | None = None
        lo: int | None = None
        for m in mask.operands:
            b = band_form(m)
            if b is None:
                return None
            mhi, mlo = b
            hi = mhi if hi is None else (hi if mhi is None else min(hi, mhi))
            lo = mlo if lo is None else (lo if mlo is None else max(lo, mlo))
        return (hi, lo)
    return None


@dataclass(frozen=True)
class KernelForm:
    """A mask resolved onto the knobs the shipping kernels speak:
    ``causal``/``window`` (the banded-offset contract), a declared
    ``doc_starts`` packing, and/or runtime ``segment_ids``."""

    causal: bool = False
    window: int | None = None
    doc_starts: tuple[int, ...] | None = None
    needs_segment_ids: bool = False


_KERNEL_FORMS = (
    "Full() / None", "Causal()", "Causal() & SlidingWindow(w)",
    "... & DocumentMask(starts)", "... & Segments()",
)


def kernel_form(mask: Mask) -> KernelForm:
    """Map a mask onto the existing kernel knobs, or raise
    :class:`MaskLoweringError` naming the supported forms.

    The messages are the JAX module's, whose certifier also lowers the
    masks that fail here to grids; the port has no path for them."""
    terms = mask.operands if isinstance(mask, And) else (mask,)
    docs: list[DocumentMask] = []
    segments = False
    band_terms: list[Mask] = []
    for t in terms:
        if isinstance(t, DocumentMask):
            docs.append(t)
        elif isinstance(t, Segments):
            segments = True
        else:
            band_terms.append(t)
    if len(docs) > 1:
        raise MaskLoweringError(
            f"mask {mask.key!r}: at most one DocumentMask per "
            f"conjunction (merge the layouts first)"
        )
    band = band_form(And(tuple(band_terms)) if len(band_terms) > 1
                     else (band_terms[0] if band_terms else Full()))
    if band is None:
        raise MaskLoweringError(
            f"mask {mask.key!r} has no kernel lowering yet — the kernels "
            f"speak {', '.join(_KERNEL_FORMS)}; it still certifies and "
            f"lowers to grids (analysis/coverage.py)"
        )
    hi, lo = band
    if hi is None and lo is None:
        causal, window = False, None
    elif hi == 0 and lo is None:
        causal, window = True, None
    elif hi == 0 and lo is not None and lo <= 0:
        causal, window = True, 1 - lo
    else:
        raise MaskLoweringError(
            f"mask {mask.key!r} lowers to the band [{lo}, {hi}] which the "
            f"kernel entry points do not expose (they speak "
            f"{', '.join(_KERNEL_FORMS)}); it still certifies and lowers "
            f"to grids"
        )
    return KernelForm(
        causal=causal, window=window,
        doc_starts=docs[0].doc_starts if docs else None,
        needs_segment_ids=segments,
    )



def dense_mask(mask: Mask, nq: int, nk: int, heads: int = 1,
               q_offset: int = 0, k_offset: int = 0) -> np.ndarray:
    """Materialized oracle over a contiguous span — ``(nq, nk)`` bool,
    or ``(heads, nq, nk)`` for per-head masks.  The O(n^2) reference a
    fallback execution path or a parity test compares against."""
    qpos = q_offset + np.arange(nq)
    kpos = k_offset + np.arange(nk)
    if mask.per_head:
        return np.stack([
            mask.oracle(qpos, kpos, h) for h in range(heads)
        ])
    return mask.oracle(qpos, kpos, 0)


# ---------------------------------------------------------------------------
# The certificate of the CUDA kernels' single sweep
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Certificate:
    """One proven ``(mask, n)`` row: the verdict, its violations (one line
    each: mask, pass, block, tile, rule) and the tiles each pass visits at
    the full shape."""

    key: str
    ok: bool
    violations: tuple[str, ...]
    tiles: tuple[tuple[str, int], ...]  # (pass, tiles at the full shape)
    proof_n: int  # positions the elementwise half enumerated


_CERT_MEMO: dict[str, Certificate] = {}


def _pass_tiles(form: KernelForm, n: int, pass_: str, bf16: bool):
    """``(table, block, tile, outer_is_q, docs)`` of one pass of the single
    sweep over ``n`` positions: the ranges the kernel wrapper launches with
    (``doc_tile_ranges``), and whether they carry the documents (a causal
    band and a layout aligned to the pass's blocks; otherwise the layout
    runs as runtime ids over the band's tiles)."""
    from .ops import cuda_flash as cf

    block, tile, outer_is_q = cf.DOC_BLOCKS[(pass_, bf16)]
    hi = 0 if form.causal else None
    lo = 1 - form.window if form.window is not None else None
    starts = None
    if form.doc_starts is not None:
        starts = tuple(s for s in form.doc_starts if s < n)
        if hi is None or not cf.docs_block_aligned(starts, block, tile):
            starts = None
    table = cf.doc_tile_ranges(n, block, tile, outer_is_q, hi, lo, starts)
    count = cf.band_tile_count(n, block, tile, outer_is_q, hi, lo, starts)
    return table, block, tile, outer_is_q, starts is not None, count


def certify(mask: Mask, n: int, *, use_cache: bool = True) -> Certificate:
    """Prove the tiles that B1, B2, B3 and B4 visit for ``mask`` on one ``(n,
    n)`` self-attention sweep sound, tight and complete.

    For each pass and block geometry (``ops/cuda_flash.py::DOC_BLOCKS``)
    the tables of ``doc_tile_ranges`` are enumerated as (block, tile) pairs
    on the leading ``min(n, CERT_ELEMENTWISE_MAX)`` positions and held to
    ``mask.oracle`` there: every live pair lies in a visited pair
    (**sound**); where the tables carry the whole mask, every visited pair
    holds a live one (**tight**); the pairs number the closed form, also at
    the full ``n`` (**complete**).  Runtime ``Segments`` terms drop out
    first (they mask in the kernel).  Cached in memory by ``(mask, n)``."""
    mask = static_mask(mask)
    key = f"{mask.key}|single|n{n}"
    if use_cache and key in _CERT_MEMO:
        return _CERT_MEMO[key]
    form = kernel_form(mask)
    pn = min(n, CERT_ELEMENTWISE_MAX)
    live = np.asarray(mask.oracle(np.arange(pn), np.arange(pn)), bool)
    violations: list[str] = []
    tiles = []
    for pass_, bf16 in ((p, b) for p in ("fwd", "dq", "dkv", "fwd_q8")
                       for b in (True, False)):
        name = f"{pass_} {'bf16' if bf16 else 'f32'}"
        table, block, tile, outer_is_q, docs, count = _pass_tiles(form, pn, pass_, bf16)
        # the live pairs of each (block, tile), the queries' side first
        grid = live if outer_is_q else live.T
        nb, nt = -(-pn // block), -(-pn // tile)
        padded = np.zeros((nb * block, nt * tile), bool)
        padded[:pn, :pn] = grid
        has_live = padded.reshape(nb, block, nt, tile).any(axis=(1, 3))
        visited = np.zeros((nb, nt), bool)
        for o, (begin, end) in enumerate(table):
            visited[o, begin:end] = True
        rules = [("sound", has_live & ~visited)]
        if docs or form.doc_starts is None:
            rules.append(("tight", visited & ~has_live))
        for rule, bad in rules:
            for o, t in zip(*np.nonzero(bad)):
                violations.append(
                    f"{mask.key}/single/{name}: block {o} ({block} positions) tile {t} "
                    f"({tile} positions) [rule: {rule}]")
                break
        if int(visited.sum()) != count:
            violations.append(f"{mask.key}/single/{name}: {int(visited.sum())} tiles "
                              f"visited, closed form {count} [rule: tile-count]")
        full, *_, full_count = _pass_tiles(form, n, pass_, bf16)
        full_tiles = int((full[:, 1] - full[:, 0]).sum())
        if full_tiles != full_count:
            violations.append(f"{mask.key}/single/{name}: closed-form count {full_count} "
                              f"!= enumerated {full_tiles} at full shape [rule: tile-count]")
        tiles.append((name, full_tiles))
    cert = Certificate(key=key, ok=not violations, violations=tuple(violations),
                       tiles=tuple(tiles), proof_n=pn)
    if use_cache:
        _CERT_MEMO[key] = cert
    return cert


def require_certified(mask: Mask, n: int, **kw) -> Certificate:
    """:func:`certify`, raising :class:`MaskCertificationError` with the
    first violation (one line: mask, pass, block, tile) on failure."""
    cert = certify(mask, n, **kw)
    if not cert.ok:
        raise MaskCertificationError(cert.violations[0])
    return cert


# ---------------------------------------------------------------------------
# The textual mini-language
# ---------------------------------------------------------------------------

MASK_REGISTRY: dict[str, str] = {
    "full": "Full() — every pair attends",
    "causal": "Causal() — k <= q",
    "window": "window:W — SlidingWindow(W), |q - k| < W",
    "prefix": "prefix:P — PrefixLM(P), bidirectional prefix + causal",
    "dilated": "dilated:S[+O] — Dilated(S, O), (q - k) % S == O",
    "docs": "docs:0,16,32 — DocumentMask(starts)",
    "segments": "Segments() — runtime per-token ids",
    "perhead": "perhead(a;b;...) — per-head mask selection",
}

_TOKEN_RE = re.compile(
    r"\s*(perhead\(|[()&|~;]|[a-z]+(?::[0-9,+]+)?)\s*"
)


def _leaf(tok: str) -> Mask:
    name, _, arg = tok.partition(":")
    if name == "full":
        return Full()
    if name == "causal":
        return Causal()
    if name == "segments":
        return Segments()
    if name == "window":
        if not arg:
            raise MaskParseError("window needs an argument: window:W")
        return SlidingWindow(int(arg))
    if name == "prefix":
        if not arg:
            raise MaskParseError("prefix needs an argument: prefix:P")
        return PrefixLM(int(arg))
    if name == "dilated":
        if not arg:
            raise MaskParseError("dilated needs an argument: dilated:S[+O]")
        stride, _, off = arg.partition("+")
        return Dilated(int(stride), int(off) if off else 0)
    if name == "docs":
        if not arg:
            raise MaskParseError("docs needs arguments: docs:0,16,32")
        return DocumentMask(tuple(int(s) for s in arg.split(",")))
    raise MaskParseError(
        f"unknown mask {name!r}; the registry knows: "
        + "; ".join(f"{k} ({v})" for k, v in sorted(MASK_REGISTRY.items()))
    )


def parse_mask(expr: str) -> Mask:
    """Parse the tiny textual form: leaves from :data:`MASK_REGISTRY`,
    combinators ``&`` (and), ``|`` (or), ``~`` (not), parentheses, and
    ``perhead(a;b)``.  Examples: ``causal&window:512``,
    ``prefix:128|docs:0,64``, ``perhead(causal;causal&window:64)``.
    """
    tokens: list[str] = []
    pos = 0
    s = expr.strip()
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or not m.group(1):
            raise MaskParseError(
                f"cannot tokenize mask expression at {s[pos:]!r}; the "
                f"registry knows: " + ", ".join(sorted(MASK_REGISTRY))
            )
        tokens.append(m.group(1))
        pos = m.end()
    tokens.append("$")
    idx = [0]

    def peek() -> str:
        return tokens[idx[0]]

    def eat(tok: str | None = None) -> str:
        t = tokens[idx[0]]
        if tok is not None and t != tok:
            raise MaskParseError(f"expected {tok!r}, got {t!r} in {expr!r}")
        idx[0] += 1
        return t

    def atom() -> Mask:
        t = peek()
        if t == "~":
            eat()
            return Not(atom())
        if t == "(":
            eat()
            m = or_expr()
            eat(")")
            return m
        if t == "perhead(":
            eat()
            parts = [or_expr()]
            while peek() == ";":
                eat()
                parts.append(or_expr())
            eat(")")
            return PerHead(tuple(parts))
        if t in ("&", "|", ")", ";", "$"):
            raise MaskParseError(f"expected a mask at {t!r} in {expr!r}")
        eat()
        return _leaf(t)

    def and_expr() -> Mask:
        m = atom()
        while peek() == "&":
            eat()
            m = m & atom()
        return m

    def or_expr() -> Mask:
        m = and_expr()
        while peek() == "|":
            eat()
            m = m | and_expr()
        return m

    out = or_expr()
    if peek() != "$":
        raise MaskParseError(f"trailing input {peek()!r} in {expr!r}")
    return out
