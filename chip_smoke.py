#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ring_attention_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit's nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. The card's name and power limit; every CUDA kernel of the package is
   built from ``csrc/`` (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   f32, at the shapes of its path and of the cases its port must cover
   (causal, offset, band-empty rows, window, softclamp, key mask with an
   all-False row, GQA):
   2. the forward (and folded-row decode) kernel;
   2b. the dk/dv and dq backward kernels, also on the 65,536-token causal
       backward in 1,024-row and 1,024-key slices;
   2c. the forward kernel's ring modes (seed partials, resumed partials
       into new tensors and in place, the fused write from a carry) on
       every forward case, a 3-hop striped chain with a band-empty row, the
       4-hop chains that phase 3c launches (n_local 16,384: contiguous
       rank 3, striped ranks 0-2) and the 4-hop chain of ring rank 3 at
       262,144 tokens (n_local 65,536), the long chains in 1,024-row
       slices; outputs are held elementwise and by their norm-relative
       error (RING_REL_TOL).
3. The serving path through the entry points a user calls: RingTransformer
   at the full width of the repository's benchmark model (vocab 256,
   dim 512, 8 heads of 64, depth 2, ff_mult 4, rotary, causal, bf16) with
   weights from a seeded generator: logits for one 65,536-token request,
   then ``generate`` for 4 requests of 2,048-token prompts (128 new tokens,
   max_len 4096, greedy).  A float32 copy of the model (seq 256) on the
   card is held to the same weights on the CPU, forward and decode.
3b. The training path: the same model takes 4 ``make_train_step`` steps
   with ``torch.optim.Adam(lr=1e-3)`` on one batch of 65,536 tokens (65,537
   ids); every loss must be finite, the last below the first, and each
   step must launch each of the three kernels exactly twice (once per
   layer).  A float32 copy (seq 256) computes one step's gradients on the
   card and on the CPU, which must agree.
3c. The ring path: the same model with ``mesh=create_mesh(ring_size=4)``, a
   virtual ring of 4 ranks on the card, in the contiguous and the striped
   layout: logits for the 65,536-token request held to the local model's,
   then 4 Adam steps (loss finite and falling).  Each forward and step must
   launch the forward kernel's ring modes and the backward kernels exactly
   as the hop schedule says (RING_SCHEDULE).  A float32 copy (seq 256)
   on the card is held to the CPU, logits and gradients, in both layouts.
   In phases 3, 3b and 3c every launch counter is set to 0 just before each
   run and read just after; a kernel that never launched fails the run.
4. Timings with CUDA events (median of 10 runs after warm-up): each kernel
   beside its bound (the larger of its bytes over 3.35 TB/s and its
   operations over the peak rate of their type), its plain version and
   one PyTorch library call computing the same function (a yardstick the
   package never calls); the model's forward tokens/s and decode ms/step.
4b. The same for the backward kernels (the library call is the backward
   of ``scaled_dot_product_attention``), and the train step: ms per step
   (host clock around a synchronized step, median after warm-up), tokens/s,
   peak device memory, and the step split into forward, backward and
   optimizer.
4c. The ring: each ring mode of the forward kernel beside its bound, its
   plain version and SDPA with its lse (a yardstick: no PyTorch call
   returns un-normalized partials); the hop chain of ring rank 3 at
   262,144 tokens (ms, TFLOP/s, bound, ratio to the single causal sweep)
   beside SDPA per span merged in PyTorch; the ring models' forward and
   train step (ms, tokens/s, peak memory) beside the local model's.
5. The kernels line, one JSON object; the forward kernel's entry lists its
   ring modes.
6. The last line: ``{"ok": true, "device": {...}}``.

It exits non-zero when ``torch.cuda.is_available()`` is false and when the
package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# Phase-2 tolerances, |kernel - plain| <= atol + rtol * |plain|:
# bf16 output is rounded to bf16 (one ulp is 7.8e-3 at 1.0) and the kernel
# rounds p to bf16 for the PV product; f32 differs by summation order only.
OUT_TOL = {"torch.bfloat16": (2e-2, 1e-2), "torch.float32": (1e-4, 0.0)}
LSE_TOL = {"torch.bfloat16": (1e-3, 0.0), "torch.float32": (1e-4, 0.0)}
# Phase-2c tolerance beside OUT_TOL, ||out - plain|| / ||plain||: a row that
# averages standard-normal V over n keys has |out| near n^-1/2, below OUT_TOL's
# atol at the ring's spans, so the output is also held at its own scale (bf16:
# p rounded for the PV product and out rounded, a relative 2^-9 each; f32:
# summation order only).
RING_REL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
# Phase-2b tolerances, ||kernel - plain|| / ||plain|| per gradient: the plain
# version stays in f32 where the bf16 kernels round p and ds to bf16 (a
# relative 2^-9 each) before their products, and dk/dv sum up to 65,536
# such terms; f32 differs by summation order and exp2 rounding only.
BWD_REL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
# Phase-3 f32 card-vs-CPU logits: two layers of f32 matmuls (k up to 2048)
# and attention summed in another order on each side.
MODEL_ATOL = 1e-3
# Phase-3b f32 card-vs-CPU gradients, ||card - cpu|| / ||cpu|| per parameter:
# the same f32 sums in another order through two layers and back.
GRAD_REL_TOL = 1e-4
TRAIN_STEPS = 4
# Phase-3c bf16 ring-vs-local logits, ||ring - local|| / ||local||: the same
# bf16 model whose attention sums its keys in 4 hop spans instead of one
# sweep (each output rounds to bf16 once either way), through two layers.
RING_LOGITS_REL_TOL = 1e-2
RING_SIZE = 4
# Launches per layer and forward on a ring of 4 (parallel/ring.py): seed
# partials, resumed partials, fused from a carry; then dk/dv and dq per hop
# with work.  Contiguous causal: rank r has work on hops 0..r, ranks 0-2
# finalize on the host.  Striped causal: every hop has work on every rank.
RING_SCHEDULE = {False: (4, 5, 1, 10, 10), True: (4, 8, 4, 16, 16)}

BENCH_MODEL = dict(num_tokens=256, dim=512, depth=2, causal=True, heads=8,
                   dim_head=64, bucket_size=2048, rotary=True, ff_mult=4)
SEED = 0
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")

# The kernels' cases on the card, forward and backward alike:
# name: (b, h, hk, nq, nk, causal_offset, window_lo, softclamp, masked)
KERNEL_CASES = {
    "causal (1,8,4096,64)": (1, 8, 8, 4096, 4096, 0, None, None, False),
    "causal offset nq1024 nk4096": (1, 8, 8, 1024, 4096, 3072, None, None, False),
    # rows 0..1023 have no key in their band: the forward averages all of V
    # there, the backward gives them no gradient (as the TPU kernels do)
    "causal nq2048 > nk1024": (1, 8, 8, 2048, 1024, -1024, None, None, False),
    "window 1024": (1, 8, 8, 4096, 4096, 0, -1023, None, False),
    "softclamp 50": (1, 8, 8, 4096, 4096, 0, None, 50.0, False),
    "kv_mask, one all-False row": (2, 8, 8, 2048, 2048, None, None, None, True),
    "GQA h32 hk4 (1,32,2048,64)": (1, 32, 4, 2048, 2048, 0, None, None, False),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def band_pairs(nq: int, nk: int, hi: int | None, lo: int | None) -> int:
    """(query, key) pairs inside the band lo <= j - i <= hi, clipped to nk."""
    if hi is None:
        return nq * nk
    upper = [min(nk - 1, i + hi) for i in range(nq)]
    lower = [max(0, i + lo) if lo is not None else 0 for i in range(nq)]
    return sum(max(0, u - lo_ + 1) for u, lo_ in zip(upper, lower))


def bound_ms(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------


def phase_build(port_dir: Path) -> None:
    from ring_attention_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    for name, res in results.items():
        check(res.path.is_file(), f"{name} did not build")
        check(port_dir in res.path.resolve().parents,
              f"{name} built outside the checkout: {res.path}")
        usage = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
        log(f"build {name}: {res.seconds:.1f} s nvcc; " + " | ".join(usage))
    log(f"phase 1 build: {time.perf_counter() - start:.1f} s wall")


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _case_inputs(gen, case, dtype):
    """q, k, v, the key mask (its last row all False) and the band of a case."""
    import torch

    b, h, hk, nq, nk, hi, lo, clamp, masked = case
    q = _rand(gen, (b, h, nq, 64), dtype)
    k = _rand(gen, (b, hk, nk, 64), dtype)
    v = _rand(gen, (b, hk, nk, 64), dtype)
    mask = None
    if masked:
        mask = torch.rand((b, nk), generator=gen, device="cuda") > 0.3
        mask[-1] = False
    kw = dict(scale=0.125, causal_offset=hi, window_lo=lo, softclamp_value=clamp)
    return q, k, v, mask, kw


def _compare(name, dtype, out, ref_out, lse, ref_lse, errors, rel_tol=None):
    """Elementwise out (OUT_TOL) and lse (LSE_TOL) against the plain
    version, and with ``rel_tol`` also ||out - plain|| / ||plain||."""
    import torch

    atol, rtol = OUT_TOL[str(dtype)]
    diff = out.float() - ref_out.float()
    err = diff.abs()
    out_ok = bool((err <= atol + rtol * ref_out.float().abs()).all())
    rel_note = ""
    if rel_tol is not None:
        rel = (diff.norm() / ref_out.float().norm().clamp_min(1e-30)).item()
        out_ok = out_ok and rel <= rel_tol
        rel_note = f"  ||out-plain||/||plain|| {rel:.3e} (tol {rel_tol})"
    latol, _ = LSE_TOL[str(dtype)]
    lse_err = (lse - ref_lse).abs().max().item()
    errors.append(err.max().item())
    log(f"  {name:<28} {str(dtype):<15} max|out-plain| {err.max().item():.3e} "
        f"(tol {atol}+{rtol}*|plain|){rel_note}  max|lse-plain| {lse_err:.3e} "
        f"(tol {latol})  {'ok' if out_ok and lse_err <= latol else 'FAIL'}")
    check(out_ok and lse_err <= latol, f"{name} {dtype}: kernel disagrees with plain")
    check(bool(torch.isfinite(out.float()).all()), f"{name} {dtype}: non-finite output")


def phase_kernel_vs_plain() -> float:
    """Every case of the forward kernel against its plain version; returns
    the largest |out - plain| seen."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors: list[float] = []
    log("phase 2: flash_fwd kernel vs flash_fwd_reference on the card")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in KERNEL_CASES.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, **kw)
            _compare(name, dtype, out, ref_out, lse, ref_lse, errors)
            torch.cuda.synchronize()

        # folded-row decode with a ragged valid prefix per request: the
        # case named for the port (h 8, hk 2, nk 32768) and the serving
        # path's own (h = hk = 8 against a 4096-slot cache)
        for h, hk, nk in ((8, 2, 32768), (8, 8, 4096)):
            b = 4
            q = _rand(gen, (b, h, 1, 64), dtype)
            k = _rand(gen, (b, hk, nk, 64), dtype)
            v = _rand(gen, (b, hk, nk, 64), dtype)
            lengths = torch.randint(1, nk + 1, (b,), generator=gen, device="cuda")
            mask = torch.arange(nk, device="cuda")[None, :] < lengths[:, None]
            out, lse = cf.cuda_flash_decode(q, k, v, mask)
            torch.cuda.synchronize()
            folded = q.reshape(b, hk, h // hk, 64)
            ref_out, ref_lse = cf.flash_fwd_reference(folded, k, v, mask, scale=0.125)
            _compare(f"decode b4 h{h} hk{hk} nk{nk}", dtype, out,
                     ref_out.reshape(b, h, 1, 64), lse, ref_lse.reshape(b, h, 1), errors)
            torch.cuda.synchronize()

    # the serving forward's own shape: one 65,536-token causal sweep, held
    # row-block by row-block (the dense plain version of the whole sweep
    # would need 137 GB of scores)
    n = 65536
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    out, lse = cf.flash_fwd(q, k, v, scale=0.125, causal_offset=0)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - 1024):
        ref_out, ref_lse = cf.flash_fwd_reference(
            q[:, :, r0:r0 + 1024].contiguous(), k, v, scale=0.125, causal_offset=r0
        )
        _compare(f"causal (1,8,65536,64) rows {r0}+", torch.bfloat16,
                 out[:, :, r0:r0 + 1024], ref_out, lse[:, :, r0:r0 + 1024],
                 ref_lse, errors)
    torch.cuda.synchronize()
    return max(errors)


def _clone(parts):
    from ring_attention_tpu_torch.ops.partials import FlashPartials

    return FlashPartials(*(x.clone() for x in parts))


def _compare_partials(name, dtype, got, ref, errors) -> None:
    """Partials are held through what they stand for: finalized, their
    output and lse against the plain version's (an l off by the 4 threads
    of a row, or an m in other units, shows in both)."""
    from ring_attention_tpu_torch.ops.partials import finalize_partials

    check(all(x.dtype == ref_x.dtype and x.shape == ref_x.shape
              for x, ref_x in zip(got, ref)), f"{name}: partials layout")
    out, lse = finalize_partials(got)
    ref_out, ref_lse = finalize_partials(ref)
    _compare(name, dtype, out.to(dtype), ref_out.to(dtype), lse, ref_lse, errors,
             rel_tol=RING_REL_TOL[str(dtype)])


def _hop_chain(q, spans, bands):
    """A rank's ring forward on the kernels, as parallel/ring.py runs it:
    seed, resumes in place, fused last span; ``spans`` are (k, v) and
    ``bands`` the causal offset of each hop (None: unmasked)."""
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    carry = None
    for (k, v), hi in zip(spans[:-1], bands[:-1]):
        carry = cf.flash_partials(q, k, v, scale=0.125, causal_offset=hi,
                                  carry=carry, out=carry)
    (k, v), hi = spans[-1], bands[-1]
    return cf.flash_fwd(q, k, v, scale=0.125, causal_offset=hi, carry=carry)


def _hop_chain_reference(q, spans, bands):
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    carry = None
    for (k, v), hi in zip(spans[:-1], bands[:-1]):
        carry = cf.flash_partials_reference(q, k, v, scale=0.125,
                                            causal_offset=hi, carry=carry)
    (k, v), hi = spans[-1], bands[-1]
    return cf.flash_fwd_reference(q, k, v, scale=0.125, causal_offset=hi, carry=carry)


def _hold_chain_in_slices(name, q, spans, bands, errors, w=1024) -> None:
    """A bf16 hop chain against its plain version in ``w``-row slices at
    the start, middle and end (the dense plain version of the whole chain
    would not fit): each slice's bands shift by its first row."""
    import torch

    out, lse = _hop_chain(q, spans, bands)
    torch.cuda.synchronize()
    n = q.shape[2]
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        ref_out, ref_lse = _hop_chain_reference(
            q[:, :, rows].contiguous(), spans,
            tuple(None if hi is None else hi + r0 for hi in bands))
        _compare(f"{name} rows {r0}+", torch.bfloat16, out[:, :, rows], ref_out,
                 lse[:, :, rows], ref_lse, errors,
                 rel_tol=RING_REL_TOL["torch.bfloat16"])
        del ref_out, ref_lse
    torch.cuda.synchronize()


def phase_ring_modes_vs_plain() -> dict:
    """The forward kernel's ring modes against their plain versions:
    seed partials, resumed partials (into new tensors and in place) and
    the fused write from a carry, on every forward case, a 3-hop chain,
    the 4-hop chains phase 3c launches (n_local 16,384) and the 65,536-row
    hop chain of ring rank 3 at 262,144 tokens; returns the largest
    |out - plain| of each mode."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errors: dict[str, list[float]] = {"seed": [], "resume": [], "fused_carry": []}
    log("phase 2c: flash_fwd ring modes (seed partials, resume, fused from a "
        "carry) vs their plain versions")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in KERNEL_CASES.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            # the carry of a first span with real content: unmasked, in full
            carry = cf.flash_partials_reference(
                q, _rand(gen, k.shape, dtype), _rand(gen, v.shape, dtype),
                scale=0.125,
            )
            got = cf.flash_partials(q, k, v, mask, **kw)
            torch.cuda.synchronize()
            ref = cf.flash_partials_reference(q, k, v, mask, **kw)
            _compare_partials(f"{name} seed", dtype, got, ref, errors["seed"])
            kept = _clone(carry)
            got = cf.flash_partials(q, k, v, mask, carry=carry, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(carry, kept)),
                  f"{name} {dtype}: a resume without out= changed its carry")
            ref = cf.flash_partials_reference(q, k, v, mask, carry=carry, **kw)
            _compare_partials(f"{name} resume", dtype, got, ref, errors["resume"])
            cf.flash_partials(q, k, v, mask, carry=kept, out=kept, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kept, got)),
                  f"{name} {dtype}: the in-place resume differs from the resume")
            out, lse = cf.flash_fwd(q, k, v, mask, carry=carry, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, carry=carry, **kw)
            _compare(f"{name} fused+carry", dtype, out, ref_out, lse, ref_lse,
                     errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])
            del got, ref, carry, kept
        # a striped rank's 3 hops: its own shard (diagonal), a shard from a
        # rank ahead (hi = -1: row 0 has no key there, and its carry from
        # hop 0 must absorb the masked scores) and one from a rank behind
        n = 4096
        q = _rand(gen, (1, 8, n, 64), dtype)
        spans = [(_rand(gen, q.shape, dtype), _rand(gen, q.shape, dtype))
                 for _ in range(3)]
        out, lse = _hop_chain(q, spans, (0, -1, 0))
        torch.cuda.synchronize()
        ref_out, ref_lse = _hop_chain_reference(q, spans, (0, -1, 0))
        _compare("3-hop striped chain", dtype, out, ref_out, lse, ref_lse,
                 errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])

    # the spans phase 3c launches (65,536 tokens on a ring of 4, n_local
    # 16,384), per parallel/ring.py's hop bands.  Contiguous rank 3: its
    # diagonal, then three shards fully behind it, run unmasked.  Striped
    # rank r at hop i: band 0 when the keys' origin r - i is at or behind r,
    # -1 (row 0 sees no key) when it is ahead.
    n = 16384
    for layout, bands in (("contiguous rank 3", (0, None, None, None)),
                          ("striped rank 0", (0, -1, -1, -1)),
                          ("striped rank 1", (0, 0, -1, -1)),
                          ("striped rank 2", (0, 0, 0, -1))):
        q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
        spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
                 for _ in range(4)]
        _hold_chain_in_slices(f"{layout} 4 x {n}", q, spans, bands,
                              errors["fused_carry"])

    # ring rank 3 of a contiguous causal ring of 4 at 262,144 tokens
    n = 65536
    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
             for _ in range(4)]
    _hold_chain_in_slices(f"hop chain 4 x {n}", q, spans, (0, None, None, None),
                          errors["fused_carry"])
    return {mode: max(errs) for mode, errs in errors.items()}


def _compare_bwd(name, dtype, got, ref, errors) -> None:
    """Norm-relative and max-abs error of each of (dq, dk, dv)."""
    import torch

    tol = BWD_REL_TOL[str(dtype)]
    parts = []
    ok = True
    for label, x, r in zip(("dq", "dk", "dv"), got, ref):
        if x is None:
            continue
        check(bool(torch.isfinite(x).all()), f"{name} {dtype}: non-finite {label}")
        diff = x.float() - r.float()
        rel = (diff.norm() / r.float().norm().clamp_min(1e-30)).item()
        abs_err = diff.abs().max().item()
        errors.setdefault(label, []).append(abs_err)
        ok = ok and rel <= tol
        parts.append(f"{label} rel {rel:.2e} max|d| {abs_err:.2e}")
    log(f"  {name:<32} {str(dtype):<15} " + ", ".join(parts)
        + f" (tol rel {tol})  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {dtype}: backward kernels disagree with plain")


def phase_bwd_kernel_vs_plain() -> dict:
    """Both backward kernels against ``flash_bwd_reference`` on the
    forward's cases and on the 65,536-token causal backward; returns the
    largest |kernel - plain| of each gradient."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errors: dict[str, list[float]] = {}
    log("phase 2b: flash_bwd_dkv and flash_bwd_dq kernels vs flash_bwd_reference")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in KERNEL_CASES.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            do = _rand(gen, q.shape, dtype)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * out.float()).sum(-1)
            dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, mask, **kw)
            dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, mask, **kw)
            torch.cuda.synchronize()
            ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, mask, **kw)
            _compare_bwd(name, dtype, (dq, dk, dv), ref, errors)
            del ref
            torch.cuda.synchronize()

    # the training path's own shape, held in slices: the plain version takes
    # lse and delta as inputs, so a block of query rows (dq) or of keys
    # (dk, dv) is checked with the band shifted to the slice
    n, w = 65536, 1024
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, **kw)
    dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, **kw)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        ref = cf.flash_bwd_reference(
            do[:, :, rows].contiguous(), q[:, :, rows].contiguous(), k, v,
            lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous(),
            scale=0.125, causal_offset=r0,
        )
        _compare_bwd(f"causal 65536 dq rows {r0}+", torch.bfloat16,
                     (dq[:, :, rows], None, None), ref, errors)
        del ref
    for c0 in (0, n // 2, n - w):
        keys = slice(c0, c0 + w)
        ref = cf.flash_bwd_reference(
            do, q, k[:, :, keys].contiguous(), v[:, :, keys].contiguous(), lse,
            delta, scale=0.125, causal_offset=-c0,
        )
        _compare_bwd(f"causal 65536 dk/dv keys {c0}+", torch.bfloat16,
                     (None, dk[:, :, keys], dv[:, :, keys]), ref, errors)
        del ref
    torch.cuda.synchronize()
    return {label: max(errs) for label, errs in errors.items()}


def _model(dtype, device, **ring):
    """The benchmark model with the seeded weights (the same with and
    without a ring mesh in ``ring``)."""
    import torch

    from ring_attention_tpu_torch import RingTransformer, init_random_params

    model = RingTransformer(**BENCH_MODEL, dtype=dtype, device=device, **ring)
    init_random_params(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def phase_serving_path() -> dict:
    """The serving path at full width; returns launch counts and timings."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log("phase 3: RingTransformer serving path, bench model at full width, bf16")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = _model(torch.bfloat16, "cuda")
    vocab = BENCH_MODEL["num_tokens"]
    tokens = torch.randint(0, vocab, (1, 65536), generator=gen, device="cuda")
    prompts = torch.randint(0, vocab, (4, 2048), generator=gen, device="cuda")
    with torch.inference_mode():
        cf.launch_count = 0
        start = time.perf_counter()
        logits = model(tokens)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - start
        fwd_launches = cf.launch_count
        check(fwd_launches > 0, "forward never launched flash_fwd")
        check(tuple(logits.shape) == (1, 65536, vocab), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits.float()).all()), "non-finite forward logits")
        log(f"  forward 1 x 65536 tokens: {fwd_s:.3f} s (first call), "
            f"flash_fwd launches {fwd_launches}")

        cf.launch_count = 0
        start = time.perf_counter()
        new = model.generate(prompts, max_len=4096, num_steps=128)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - start
        gen_launches = cf.launch_count
        check(gen_launches > 0, "generate never launched flash_fwd")
        check(tuple(new.shape) == (4, 128), f"generate shape {tuple(new.shape)}")
        check(bool(((new >= 0) & (new < vocab)).all()), "generated ids out of range")
        log(f"  generate 4 x (2048 prompt + 128 new): {gen_s:.3f} s (first call), "
            f"flash_fwd launches {gen_launches}")

    launches = fwd_launches + gen_launches
    _hold_f32_model_to_cpu()
    return {"launches": launches, "model": model, "tokens": tokens, "prompts": prompts}


def _hold_f32_model_to_cpu() -> None:
    """A float32 copy of the model at seq 256 on the card against the same
    weights on the CPU (plain versions): forward logits and decode steps."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _model(None, "cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 256), generator=gen)
    with torch.inference_mode():
        errs = [(gpu(tokens.cuda()).cpu() - cpu(tokens)).abs().max().item()]
        caches = [m.init_cache(2, 256) for m in (gpu, cpu)]
        logits = [m.prefill(tokens[:, :200], c)[0].cpu() for m, c in zip((gpu, cpu), caches)]
        errs.append((logits[0] - logits[1]).abs().max().item())
        for pos in range(200, 208):
            step = [m.decode_step(tokens[:, pos], c, pos)[0].cpu()
                    for m, c in zip((gpu, cpu), caches)]
            errs.append((step[0] - step[1]).abs().max().item())
    log(f"  f32 model seq 256, card vs CPU: forward max|diff| {errs[0]:.3e}, "
        f"prefill {errs[1]:.3e}, 8 decode steps {max(errs[2:]):.3e} (tol {MODEL_ATOL})")
    check(max(errs) <= MODEL_ATOL, "f32 model on the card disagrees with the CPU")


def phase_training_path() -> dict:
    """The training path at full width; returns launch counts, losses and
    what phase 4b times."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log(f"phase 3b: training path, bench model at full width, bf16, "
        f"Adam(lr=1e-3), {TRAIN_STEPS} steps of 1 x 65536 tokens")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    model = _model(torch.bfloat16, "cuda").train()
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, 65537),
                           generator=gen, device="cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(lambda t: model(t, return_loss=True), opt)
    losses, launches = [], {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    for i in range(TRAIN_STEPS):
        cf.launch_count = cf.dkv_launch_count = cf.dq_launch_count = 0
        start = time.perf_counter()
        loss = float(step(tokens))
        seconds = time.perf_counter() - start
        counts = {"flash_fwd": cf.launch_count, "flash_bwd_dkv": cf.dkv_launch_count,
                  "flash_bwd_dq": cf.dq_launch_count}
        log(f"  step {i}: loss {loss:.6f}, {seconds:.3f} s, launches {counts}")
        check(counts == {name: 2 for name in counts},
              f"step {i} launched {counts}, expected 2 of each kernel")
        check(math.isfinite(loss), f"step {i}: loss {loss}")
        losses.append(loss)
        for name, n in counts.items():
            launches[name] += n
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    _hold_f32_grads_to_cpu()
    return {"launches": launches, "losses": losses, "model": model, "opt": opt,
            "step": step, "tokens": tokens}


def _hold_f32_grads_to_cpu() -> None:
    """One step's gradients of a float32 copy of the model at seq 256, on
    the card (the f32 kernels) and on the CPU (the plain versions)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _model(None, "cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 6)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 257), generator=gen)
    losses = []
    for m, t in ((gpu, tokens.cuda()), (cpu, tokens)):
        loss = m(t, return_loss=True)
        loss.backward()
        losses.append(loss.item())
    worst, worst_name = 0.0, ""
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"  f32 model seq 256, card vs CPU: loss {losses[0]:.7f} vs {losses[1]:.7f}, "
        f"worst gradient ||card - cpu|| / ||cpu|| {worst:.3e} ({worst_name}) "
        f"(tol {GRAD_REL_TOL})")
    check(worst <= GRAD_REL_TOL, "f32 gradients on the card disagree with the CPU")


def _causal_timing(name, n, with_plain):
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    ops = 4 * 64 * 8 * band_pairs(n, n, 0, None)
    b_ms, b_by = bound_ms(ops, nbytes(q, k, v, out, lse), torch.bfloat16)
    row = {
        "shape": f"causal (1,8,{n},64) bf16",
        "ms": time_ms(lambda: cf.flash_fwd(q, k, v, **kw)),
        "plain_ms": (time_ms(lambda: cf.flash_fwd_reference(q, k, v, **kw))
                     if with_plain else None),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        ),
    }
    log(f"  {name}: kernel {row['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"plain {row['plain_ms']} ms, sdpa {row['library_ms']:.4f} ms, "
        f"{ops / row['ms'] / 1e9:.1f} TFLOP/s")
    return row


def _decode_timing(name, h, hk, nk):
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b = 4
    q = _rand(gen, (b, h, 1, 64), torch.bfloat16)
    k = _rand(gen, (b, hk, nk, 64), torch.bfloat16)
    v = _rand(gen, (b, hk, nk, 64), torch.bfloat16)
    mask = torch.ones((b, nk), dtype=torch.bool, device="cuda")
    out, lse = cf.cuda_flash_decode(q, k, v, mask)
    folded = q.reshape(b, hk, h // hk, 64)
    ops = 4 * 64 * b * h * nk
    b_ms, b_by = bound_ms(ops, nbytes(q, k, v, mask, out, lse), torch.bfloat16)
    row = {
        "shape": f"decode b{b} h{h} hk{hk} nk{nk} bf16",
        "ms": time_ms(lambda: cf.cuda_flash_decode(q, k, v, mask)),
        "plain_ms": time_ms(
            lambda: cf.flash_fwd_reference(folded, k, v, mask, scale=0.125)
        ),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None, None, :], enable_gqa=h != hk
        )),
    }
    log(f"  {name}: kernel {row['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
        f"{nbytes(k, v) / row['ms'] / 1e6:.1f} GB/s of cache")
    return row


def _bwd_timings(n, iters, with_plain) -> dict[str, dict]:
    """Both backward kernels on the causal (1, 8, n, 64) bf16 backward."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (do, q, k, v, lse, delta)
    pairs = 8 * band_pairs(n, n, 0, None)  # in-band (query, key) pairs, 8 heads
    # the plain version and the library call compute all three gradients
    plain_ms = (time_ms(lambda: cf.flash_bwd_reference(*args, **kw), iters=iters)
                if with_plain else None)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    library_ms = time_ms(lambda: torch.autograd.grad(
        ref_out, (qg, kg, vg), do, retain_graph=True), iters=iters)
    f32_grad = 4 * n * 64 * 8  # one (1, 8, n, 64) float32 gradient, bytes
    rows = {}
    for name, fn, products, out_bytes in (
        ("flash_bwd_dkv", cf.flash_bwd_dkv, 4, 2 * f32_grad),
        ("flash_bwd_dq", cf.flash_bwd_dq, 3, f32_grad),
    ):
        ops = 2 * products * 64 * pairs
        b_ms, b_by = bound_ms(ops, nbytes(*args) + out_bytes, torch.bfloat16)
        ms = time_ms(lambda: fn(*args, **kw), iters=iters)
        rows[name] = {"shape": f"causal (1,8,{n},64) bf16", "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms}
        log(f"  {name} causal {n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"plain (all three gradients) {plain_ms} ms, sdpa backward "
            f"{library_ms:.4f} ms, {ops / ms / 1e9:.1f} TFLOP/s")
    return rows


def _train_step_timing(step, tokens) -> tuple[float, list[float], int, int]:
    """Median ms of 5 synchronized steps after 2 warm-up steps, every step's
    seconds, the peak device memory over the 5 and the memory live before
    them (other models of this script included)."""
    import torch

    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(5):
        start = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    return (statistics.median(step_s) * 1e3, step_s, torch.cuda.max_memory_allocated(),
            base)


def phase_train_timings(training: dict) -> dict[str, list[dict]]:
    """Phase 4b; returns each backward kernel's rows by shape."""
    import torch

    log("phase 4b: backward kernels and the train step")
    rows: dict[str, list[dict]] = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for n, iters, with_plain in ((4096, 10, True), (65536, 10, False),
                                 (262144, 3, False)):
        for name, row in _bwd_timings(n, iters, with_plain).items():
            rows[name].append(row)

    model, opt, step, tokens = (training[k] for k in ("model", "opt", "step", "tokens"))
    n = tokens.shape[1] - 1
    ms, step_s, peak, base = _train_step_timing(step, tokens)
    fwd_s, bwd_s, opt_s = [], [], []
    for _ in range(3):  # the same work, split at its three stages
        opt.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = model(tokens, return_loss=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        fwd_s.append(t1 - t0)
        bwd_s.append(t2 - t1)
        opt_s.append(time.perf_counter() - t2)
    training["step_ms"], training["peak"], training["above"] = ms, peak, peak - base
    log(f"  train step 1 x {n} tokens: {ms:.3f} ms (median of 5 after 2 warm-up; "
        f"all {[round(x * 1e3, 3) for x in step_s]}), {n / ms * 1e3:.0f} tokens/s, "
        f"peak device memory {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB "
        f"above what was live before the step")
    log(f"  step split: forward + loss {statistics.median(fwd_s) * 1e3:.3f} ms, "
        f"backward {statistics.median(bwd_s) * 1e3:.3f} ms, "
        f"optimizer {statistics.median(opt_s) * 1e3:.3f} ms (medians of 3)")
    return rows


def phase_timings(serving: dict) -> list[dict]:
    import torch

    log("phase 4: timings (CUDA events, median of 10 after warm-up)")
    rows = [
        _causal_timing("flash_fwd causal 4096", 4096, with_plain=True),
        _causal_timing("flash_fwd causal 65536 (serving forward)", 65536, with_plain=False),
        _causal_timing("flash_fwd causal 262144", 262144, with_plain=False),
        _decode_timing("flash_fwd decode hk2 nk32768", 8, 2, 32768),
        _decode_timing("flash_fwd decode hk8 nk4096 (serving decode)", 8, 8, 4096),
    ]
    model, tokens, prompts = serving["model"], serving["tokens"], serving["prompts"]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(tokens))
        cache = model.init_cache(4, 4096)
        logits, cache = model.prefill(prompts, cache)
        tok = logits.argmax(-1)
        pos = [prompts.shape[1]]

        def step():
            model.decode_step(tok, cache, pos[0])
            pos[0] += 1

        step_ms = time_ms(step)
    serving["fwd_ms"] = fwd_ms
    log(f"  model forward 1 x 65536: {fwd_ms:.3f} ms, "
        f"{65536 / fwd_ms * 1e3:.0f} tokens/s")
    log(f"  model decode step, 4 requests at ~2048-2060 cached tokens: "
        f"{step_ms:.3f} ms/step ({4 / step_ms * 1e3:.0f} tokens/s)")
    return rows

COUNTERS = {"flash_fwd": "launch_count", "seed": "seed_launch_count",
            "resume": "resume_launch_count", "fused_carry": "fused_carry_launch_count",
            "flash_bwd_dkv": "dkv_launch_count", "flash_bwd_dq": "dq_launch_count"}


def _reset_counts() -> None:
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    for attr in COUNTERS.values():
        setattr(cf, attr, 0)


def _read_counts() -> dict[str, int]:
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    return {name: getattr(cf, attr) for name, attr in COUNTERS.items()}


def _ring_counts(striped: bool, backward: bool) -> dict[str, int]:
    """Launches of one forward (and backward) of the model on the ring:
    RING_SCHEDULE per layer, times the depth."""
    seed, resume, fused, dkv, dq = (x * BENCH_MODEL["depth"] for x in RING_SCHEDULE[striped])
    return {"flash_fwd": seed + resume + fused, "seed": seed, "resume": resume,
            "fused_carry": fused, "flash_bwd_dkv": dkv if backward else 0,
            "flash_bwd_dq": dq if backward else 0}


def phase_ring_path(serving: dict, training: dict) -> dict:
    """The ring path at full width on a virtual ring of 4: logits against
    the local model, launch counts against the hop schedule, Adam steps;
    then the float32 ring on the card against the CPU."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import create_mesh

    log(f"phase 3c: RingTransformer(mesh=create_mesh(ring_size={RING_SIZE})) on a "
        f"virtual ring, bench model at full width, bf16")
    tokens, local = serving["tokens"], serving["model"]
    with torch.inference_mode():
        ref = local(tokens).float()
    launches = {name: 0 for name in COUNTERS}
    models = {}
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                       striped=striped)
        with torch.inference_mode():
            _reset_counts()
            start = time.perf_counter()
            logits = model(tokens)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = _read_counts()
        check(counts == _ring_counts(striped, backward=False),
              f"{layout} forward launched {counts}, expected {_ring_counts(striped, False)}")
        for name, n in counts.items():
            launches[name] += n
        check(bool(torch.isfinite(logits.float()).all()), f"{layout}: non-finite logits")
        diff = logits.float() - ref
        rel = (diff.norm() / ref.norm()).item()
        log(f"  {layout} forward 1 x 65536: {seconds:.3f} s (first call), launches "
            f"{counts}; logits vs the local model ||diff|| / ||local|| {rel:.3e}, "
            f"max|diff| {diff.abs().max().item():.3e} (tol rel {RING_LOGITS_REL_TOL})")
        check(rel <= RING_LOGITS_REL_TOL, f"{layout} ring logits disagree with the local model")
        del logits, diff

        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
        losses = []
        for i in range(TRAIN_STEPS):
            _reset_counts()
            start = time.perf_counter()
            loss = float(step(training["tokens"]))
            seconds = time.perf_counter() - start
            counts = _read_counts()
            log(f"  {layout} step {i}: loss {loss:.6f}, {seconds:.3f} s, launches {counts}")
            check(counts == _ring_counts(striped, backward=True),
                  f"{layout} step {i} launched {counts}")
            check(math.isfinite(loss), f"{layout} step {i}: loss {loss}")
            losses.append(loss)
            for name, n in counts.items():
                launches[name] += n
        check(losses[-1] < losses[0], f"{layout}: loss did not fall: {losses}")
        models[layout] = (model, step)
    _hold_f32_ring_to_cpu()
    return {"launches": launches, "models": models}


def _hold_f32_ring_to_cpu() -> None:
    """A float32 copy of the ring model (seq 256, ring 4) on the card against
    the same model on the CPU: logits and one step's gradients."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 9)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 257), generator=gen)
    for striped in (False, True):
        gpu = _model(None, "cuda", mesh=create_mesh(ring_size=RING_SIZE), striped=striped)
        cpu = copy.deepcopy(gpu).to("cpu")
        with torch.no_grad():
            logits_err = (gpu(tokens[:, :256].cuda()).cpu() - cpu(tokens[:, :256])).abs().max().item()
        losses = []
        for m, t in ((gpu, tokens.cuda()), (cpu, tokens)):
            loss = m(t, return_loss=True)
            loss.backward()
            losses.append(loss.item())
        worst, worst_name = 0.0, ""
        for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
            rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
            if rel >= worst:
                worst, worst_name = rel, name
        log(f"  f32 ring model ({'striped' if striped else 'contiguous'}) seq 256, card "
            f"vs CPU: logits max|diff| {logits_err:.3e} (tol {MODEL_ATOL}), loss "
            f"{losses[0]:.7f} vs {losses[1]:.7f}, worst gradient ||card - cpu|| / "
            f"||cpu|| {worst:.3e} ({worst_name}) (tol {GRAD_REL_TOL})")
        check(logits_err <= MODEL_ATOL, "f32 ring logits on the card disagree with the CPU")
        check(worst <= GRAD_REL_TOL, "f32 ring gradients on the card disagree with the CPU")


def _sdpa_partial(q, k, v, causal):
    """One library call returning an attention span's normalized output and
    its lse, which is what a merge of partial spans needs."""
    import torch

    out, lse = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=0.125)[:2]
    return out, lse


def _sdpa_chain(q, spans, bands):
    """The library yardstick of the hop chain: each span through SDPA (flash)
    with its lse, merged in PyTorch (no PyTorch call returns un-normalized
    partials or resumes a carry)."""
    import torch

    parts = [_sdpa_partial(q, k, v, hi == 0) for (k, v), hi in zip(spans, bands)]
    lses = torch.stack([lse for _, lse in parts])
    total = torch.logsumexp(lses, dim=0)
    out = sum(o.float() * torch.exp(lse - total)[..., None] for o, lse in parts)
    return out.to(q.dtype), total


def _mode_rows(n, with_plain) -> dict[str, dict]:
    """Each ring mode of the forward kernel on a (1, 8, n, 64) bf16 span of
    the hop chain: seed (the diagonal), resume and fused (spans fully in
    view) from a carry."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    carry = cf.flash_partials(q, k, v, scale=0.125, causal_offset=0)
    f32_state = 4 * 8 * n * (64 + 2)  # (acc, m, l) bytes
    qkv = nbytes(q, k, v)
    cases = {
        # name: (kernel, plain, library, pairs, bytes moved)
        "seed": (lambda: cf.flash_partials(q, k, v, scale=0.125, causal_offset=0),
                 lambda: cf.flash_partials_reference(q, k, v, scale=0.125, causal_offset=0),
                 lambda: _sdpa_partial(q, k, v, True),
                 band_pairs(n, n, 0, None), qkv + f32_state),
        # resumes in place: each timed launch folds the span in once more
        "resume": (lambda: cf.flash_partials(q, k, v, scale=0.125, carry=carry,
                                             out=carry),
                   lambda: cf.flash_partials_reference(q, k, v, scale=0.125, carry=carry),
                   lambda: _sdpa_partial(q, k, v, False),
                   n * n, qkv + 2 * f32_state),
        "fused_carry": (lambda: cf.flash_fwd(q, k, v, scale=0.125, carry=carry),
                        lambda: cf.flash_fwd_reference(q, k, v, scale=0.125, carry=carry),
                        lambda: _sdpa_partial(q, k, v, False),
                        n * n, qkv + f32_state + nbytes(q) + 4 * 8 * n),
    }
    rows = {}
    for mode, (kernel, plain, library, pairs, moved) in cases.items():
        ops = 4 * 64 * 8 * pairs
        b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)
        ms = time_ms(kernel)
        rows[mode] = {"shape": f"{mode} (1,8,{n},64) bf16", "ms": ms,
                      "plain_ms": time_ms(plain) if with_plain else None,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": time_ms(library)}
        log(f"  flash_fwd {mode} {n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"plain {rows[mode]['plain_ms']} ms, sdpa with lse (library yardstick, "
            f"normalized) {rows[mode]['library_ms']:.4f} ms, "
            f"{ops / ms / 1e9:.1f} TFLOP/s")
    return rows


def phase_ring_timings(ring: dict, serving: dict, training: dict,
                       fwd_rows: list[dict]) -> dict[str, list[dict]]:
    """Phase 4c; returns the forward kernel's ring-mode rows by mode."""
    import torch

    log("phase 4c: the ring (CUDA events, median after warm-up)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    rows: dict[str, list[dict]] = {"seed": [], "resume": [], "fused_carry": []}
    for n, with_plain in ((4096, True), (65536, False)):
        for mode, row in _mode_rows(n, with_plain).items():
            rows[mode].append(row)

    # ring rank 3's hops at 262,144 tokens, ring 4 (bench.py::_hop_sequence)
    n = 65536
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
             for _ in range(RING_SIZE)]
    bands = (0,) + (None,) * (RING_SIZE - 1)
    ops = 4 * 64 * 8 * (band_pairs(n, n, 0, None) + (RING_SIZE - 1) * n * n)
    b_ms, b_by = bound_ms(ops, nbytes(q, *(x for kv in spans for x in kv), q)
                          + 4 * 8 * n, torch.bfloat16)
    chain_ms = time_ms(lambda: _hop_chain(q, spans, bands), iters=5)
    library_ms = time_ms(lambda: _sdpa_chain(q, spans, bands), iters=5)
    out, _ = _hop_chain(q, spans, bands)
    ref, _ = _sdpa_chain(q, spans, bands)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    check(rel <= 1e-2, f"hop chain vs the SDPA yardstick: rel {rel}")
    sweep = next(r for r in fwd_rows if r["shape"] == "causal (1,8,262144,64) bf16")
    sweep_tflops = 4 * 64 * 8 * band_pairs(262144, 262144, 0, None) / sweep["ms"] / 1e9
    chain_tflops = ops / chain_ms / 1e9
    log(f"  hop chain, rank 3 of a causal ring of 4 at 262144 (seed + 2 resume + "
        f"fused, 1 x 8 x 65536 x 64 each): {chain_ms:.3f} ms, {chain_tflops:.1f} TFLOP/s, "
        f"bound {b_ms:.3f} ms ({b_by}); single causal sweep at 262144 {sweep['ms']:.3f} ms, "
        f"{sweep_tflops:.1f} TFLOP/s; ratio {chain_tflops / sweep_tflops:.4f}")
    log(f"  library yardstick for the chain (SDPA flash per span with its lse, "
        f"merged in PyTorch): {library_ms:.3f} ms; ||chain - yardstick|| / "
        f"||yardstick|| {rel:.2e}")

    tokens = serving["tokens"]
    log(f"  local model: forward 1 x 65536 {serving['fwd_ms']:.3f} ms "
        f"({65536 / serving['fwd_ms'] * 1e3:.0f} tokens/s), train step "
        f"{training['step_ms']:.3f} ms ({65536 / training['step_ms'] * 1e3:.0f} "
        f"tokens/s), peak {training['peak'] / 2**30:.3f} GiB, "
        f"{training['above'] / 2**30:.3f} GiB above the live memory (phases 4, 4b)")
    for layout, (model, step) in ring["models"].items():
        model.eval()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(tokens))
        model.train()
        ms, step_s, peak, base = _train_step_timing(step, training["tokens"])
        log(f"  ring {layout} model: forward 1 x 65536 {fwd_ms:.3f} ms "
            f"({65536 / fwd_ms * 1e3:.0f} tokens/s, {fwd_ms / serving['fwd_ms']:.3f} x "
            f"local), train step {ms:.3f} ms (all {[round(x * 1e3, 3) for x in step_s]}; "
            f"{65536 / ms * 1e3:.0f} tokens/s, {ms / training['step_ms']:.3f} x local), "
            f"peak {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
            f"live memory")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    port_dir = here / "ring_attention_tpu_torch"
    if not (port_dir / "__init__.py").is_file():
        print(f"chip_smoke: {port_dir} is missing; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    import ring_attention_tpu_torch

    check(Path(ring_attention_tpu_torch.__file__).resolve().parent == port_dir,
          f"imported the package from {ring_attention_tpu_torch.__file__}")

    start = time.perf_counter()
    phase_build(port_dir)
    max_err = phase_kernel_vs_plain()
    mode_err = phase_ring_modes_vs_plain()
    bwd_err = phase_bwd_kernel_vs_plain()
    serving = phase_serving_path()
    training = phase_training_path()
    ring = phase_ring_path(serving, training)
    rows = phase_timings(serving)
    bwd_rows = phase_train_timings(training)
    mode_rows = phase_ring_timings(ring, serving, training, rows)
    ring_launches = ring["launches"]
    entries = [
        ("flash_fwd", "flash_fwd.cu", 1174,
         serving["launches"] + training["launches"]["flash_fwd"]
         + ring_launches["flash_fwd"], max(max_err, *mode_err.values()), rows),
        ("flash_bwd_dkv", "flash_bwd.cu", 2108,
         training["launches"]["flash_bwd_dkv"] + ring_launches["flash_bwd_dkv"],
         max(bwd_err["dk"], bwd_err["dv"]), bwd_rows["flash_bwd_dkv"]),
        ("flash_bwd_dq", "flash_bwd.cu", 2186,
         training["launches"]["flash_bwd_dq"] + ring_launches["flash_bwd_dq"],
         bwd_err["dq"], bwd_rows["flash_bwd_dq"]),
    ]
    kernels = []
    for name, source, line, launches, err, per_shape in entries:
        headline = per_shape[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ring_attention_tpu_torch/csrc/{source}",
            "replaces": f"ring_attention_tpu/ops/pallas_flash.py:{line}",
            "launches": launches,
            "max_abs_err": err,
            "shape": headline["shape"],
            "ms": headline["ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"],
            "pass": True,
            "per_shape": per_shape,
        })
    # the forward kernel's ring modes, each with its own launches and numbers
    kernels[0]["modes"] = [
        {"mode": mode, "launches": ring_launches[mode], "max_abs_err": mode_err[mode],
         **{key: mode_rows[mode][0][key] for key in
            ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "per_shape": mode_rows[mode]}
        for mode in ("seed", "resume", "fused_carry")
    ]
    log(f"total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
