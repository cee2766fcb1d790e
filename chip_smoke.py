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
       backward in 1,024-row and 1,024-key slices.
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
   In phases 3 and 3b every launch counter is set to 0 just before each
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
5. The kernels line, one JSON object.
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


def _compare(name, dtype, out, ref_out, lse, ref_lse, errors):
    import torch

    atol, rtol = OUT_TOL[str(dtype)]
    err = (out.float() - ref_out.float()).abs()
    out_ok = bool((err <= atol + rtol * ref_out.float().abs()).all())
    latol, _ = LSE_TOL[str(dtype)]
    lse_err = (lse - ref_lse).abs().max().item()
    errors.append(err.max().item())
    log(f"  {name:<28} {str(dtype):<15} max|out-plain| {err.max().item():.3e} "
        f"(tol {atol}+{rtol}*|plain|)  max|lse-plain| {lse_err:.3e} (tol {latol})"
        f"  {'ok' if out_ok and lse_err <= latol else 'FAIL'}")
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


def _model(dtype, device):
    import torch

    from ring_attention_tpu_torch import RingTransformer, init_random_params

    model = RingTransformer(**BENCH_MODEL, dtype=dtype, device=device)
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
    for _ in range(2):  # warm-up
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, fwd_s, bwd_s, opt_s = [], [], [], []
    for _ in range(5):
        start = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated()
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
    ms = statistics.median(step_s) * 1e3
    log(f"  train step 1 x {n} tokens: {ms:.3f} ms (median of 5 after 2 warm-up; "
        f"all {[round(x * 1e3, 3) for x in step_s]}), {n / ms * 1e3:.0f} tokens/s, "
        f"peak device memory {peak / 2**30:.3f} GiB")
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
    log(f"  model forward 1 x 65536: {fwd_ms:.3f} ms, "
        f"{65536 / fwd_ms * 1e3:.0f} tokens/s")
    log(f"  model decode step, 4 requests at ~2048-2060 cached tokens: "
        f"{step_ms:.3f} ms/step ({4 / step_ms * 1e3:.0f} tokens/s)")
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
    bwd_err = phase_bwd_kernel_vs_plain()
    serving = phase_serving_path()
    training = phase_training_path()
    rows = phase_timings(serving)
    bwd_rows = phase_train_timings(training)
    entries = [
        ("flash_fwd", "flash_fwd.cu", 1174,
         serving["launches"] + training["launches"]["flash_fwd"], max_err, rows),
        ("flash_bwd_dkv", "flash_bwd.cu", 2108, training["launches"]["flash_bwd_dkv"],
         max(bwd_err["dk"], bwd_err["dv"]), bwd_rows["flash_bwd_dkv"]),
        ("flash_bwd_dq", "flash_bwd.cu", 2186, training["launches"]["flash_bwd_dq"],
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
