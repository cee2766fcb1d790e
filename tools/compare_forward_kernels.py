#!/usr/bin/env python3
"""Compare the port's flash kernels between two source trees on one GPU.

Builds ``csrc/flash_fwd.cu`` (B1), ``csrc/flash_bwd.cu`` (B2 and B3),
``csrc/flash_decode.cu`` (the split-KV decode), ``csrc/flash_ring.cu`` (B7)
and ``csrc/flash_ring_remote.cu`` (B8) of this checkout and of a base
checkout (for example the parent commit, unpacked with ``git archive``),
checks both trees' kernels against each other on a set of cases, and times
them in turns (base, head, head, base) with CUDA events:

    python3 tools/compare_forward_kernels.py BASE_DIR

B7 and B8 and the float32 instantiations of B1 and B3 must give
bit-identical outputs.  The bf16 B1, B2 (dk/dv) and B3 (dq) are held by
their norm-relative distance from the base tree's, within the bounds that
``chip_smoke.py`` holds them to their plain versions (RING_REL_TOL for
B1's output, with LSE_TOL on its lse; BWD_REL_TOL for the gradients): a
redesign of their products sums in another order.  B1 is timed in each
mode (fused, seed partials, resume, fused from a carry) and packed (also
as one document), B2 and B3 unpacked and packed.  Only the kernels both trees have
in common are compared: each tree's B1, B2 and B3 are called with that
tree's own C signature (a tree whose entry points take document ids gets
null ids, its unsegmented instantiation, except in the packed timing), and
B8 through this checkout's wrapper (``ops/cuda_ring_remote.py``) on each
tree's library, whose C signature must be the same.  The decode is timed
as the base tree's folded-row B1 launch (where its ``cuda_flash_decode``
went) against this checkout's decode kernel, per call in a stream of 20.
A kernel whose source the base tree lacks is built and timed for this
checkout alone.  Libraries land in ``build/compare/`` (ignored by git).
Prints the card's name and power limit, each build's ptxas registers and
spills per kernel, each case's check, each timing and, as its last line,
one JSON object with the timings.  Exits non-zero when a build fails or an
output differs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT_DIR = HERE / "build" / "compare"
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "flash_ring", "flash_ring_remote")


def takes_ids(csrc: Path, name: str) -> bool:
    """Whether a tree's C entry points of ``name`` take document ids."""
    return "q_seg" in (csrc / f"{name}.cu").read_text()


def build(tree: str, csrc: Path, name: str) -> tuple[Path, list[str]]:
    from ring_attention_tpu_torch.ops import _build

    lib = OUT_DIR / tree / f"{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo", "-o", str(lib),
           str(csrc / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tree}/{name}.cu:\n{proc.stdout}{proc.stderr}")
    usage, kernel, frame = [], "?", ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Function properties for" in line:
            frame = ""
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            usage.append(f"{_short(kernel)}: {line.split(':', 1)[1].strip()}"
                         + (f"; {frame}" if frame else ""))
    return lib, usage


def _short(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name (chip_smoke's reading)."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import _kernel_name

    return _kernel_name(mangled, with_args=True)


def time_ms(fn, iters: int = 5) -> float:
    import torch

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


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_launcher(lib_path: Path, ids: bool):
    """``run(q, k, v, mask, causal, hi, windowed, lo, softclamp, carry,
    partials, segs)``: one B1 launch, ``(out, lse)`` (partials False) or f32
    partials ``(acc, m, l)``, from no carry or from ``carry``; ``ids``: the
    entry point takes document ids (``segs``, null by default) before the
    stream."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = ([ptr] * 12 + [i32] * 7 + [f32] + [i32] * 4 + [f32]
                              + [ptr] * (2 if ids else 0) + [ptr])

    def run(q, k, v, mask, causal, hi, windowed, lo, softclamp, carry=None, partials=None,
            segs=(None, None)):
        b, h, nq, d = q.shape
        hk, nk = k.shape[1], k.shape[2]
        partials = carry is not None if partials is None else partials
        out = lse = None
        parts = (None, None, None)
        if partials:
            parts = (torch.empty((b, h, nq, d), device=q.device),
                     torch.empty((b, h, nq), device=q.device),
                     torch.empty((b, h, nq), device=q.device))
        else:
            out = torch.empty_like(q)
            lse = torch.empty((b, h, nq), device=q.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
            *(_ptr(x) for x in (carry or (None, None, None))), *(_ptr(x) for x in parts),
            b, h, hk, nq, nk, d, int(q.dtype == torch.bfloat16), 0.125,
            int(causal), hi, int(windowed), lo, softclamp,
            *(tuple(_ptr(x) for x in segs) if ids else ()), stream)
        if rc:
            raise RuntimeError(f"flash_fwd launch failed: {rc}")
        return parts if partials else (out, lse)

    return run


def bwd_launcher(lib_path: Path, ids: bool):
    """``run(do, q, k, v, lse, delta, mask, causal, hi, windowed, lo,
    softclamp)``: one B2 launch then one B3 launch, ``(dq, dk, dv)``;
    ``ids`` as in :func:`fwd_launcher`."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ids_arg = ids
    tail = [i32] * 6 + [i32, f32] + [i32] * 4 + [f32] + [ptr] * (2 if ids else 0) + [ptr]
    lib.flash_bwd_dkv.argtypes = [ptr] * 9 + tail
    lib.flash_bwd_dq.argtypes = [ptr] * 8 + tail

    def run(do, q, k, v, lse, delta, mask, causal, hi, windowed, lo, softclamp,
            passes=("dkv", "dq"), segs=(None, None)):
        b, h, nq, d = q.shape
        hk, nk = k.shape[1], k.shape[2]
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk, dv = (torch.empty(k.shape, dtype=torch.float32, device=k.device)
                  for _ in range(2))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        inputs = [_ptr(x) for x in (q, k, v, do, lse, delta, mask)]
        ids = tuple(_ptr(x) for x in segs) if ids_arg else ()
        shape = (b, h, hk, nq, nk, d, int(q.dtype == torch.bfloat16), 0.125,
                 int(causal), hi, int(windowed), lo, softclamp, *ids, stream)
        if "dkv" in passes and lib.flash_bwd_dkv(*inputs, _ptr(dk), _ptr(dv), *shape):
            raise RuntimeError("flash_bwd_dkv launch failed")
        if "dq" in passes and lib.flash_bwd_dq(*inputs, _ptr(dq), *shape):
            raise RuntimeError("flash_bwd_dq launch failed")
        return dq, dk, dv

    return run


def remote_runner(lib_path: Path):
    """``run(qs, ks, vs, tables, softclamp)``: one B8 launch through this
    checkout's wrapper on the library at ``lib_path`` (the C signature this
    checkout declares)."""
    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    def run(qs, ks, vs, tables, softclamp):
        return _with_library("flash_ring_remote", lib_path, lambda: crr.fused_ring_remote(
            qs, ks, vs, tables=tables, n_local=qs[0].shape[2], scale=0.125,
            softclamp_value=softclamp or None))

    return run


_LIBS: dict = {}  # (loader name, library path) -> the loaded library


def _with_library(name: str, lib_path: Path, call):
    """``call()`` with ``_build``'s ``<name>_library`` loader bound to the
    library at ``lib_path``."""
    from ring_attention_tpu_torch.ops import _build

    attr = f"{name}_library"
    key = (attr, lib_path)
    if key not in _LIBS:
        real_build = _build.build
        _build.build = lambda n: _build.BuildResult(lib_path, 0.0, "")
        try:
            _LIBS[key] = getattr(_build, attr).__wrapped__()
        finally:
            _build.build = real_build
    loader = getattr(_build, attr)
    setattr(_build, attr, lambda: _LIBS[key])
    try:
        return call()
    finally:
        setattr(_build, attr, loader)



def ring_launcher(lib_path: Path):
    """``run(q, k_all, v_all, mask, tables, softclamp)``: one B7 launch."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_ring.argtypes = [ptr] * 8 + [i32, ptr, ptr] + [i32] * 7 + [f32, f32, ptr]

    def run(q, k_all, v_all, mask, tables, softclamp):
        b, h, n, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, n), device=q.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_ring(
            _ptr(q), _ptr(k_all), _ptr(v_all), _ptr(mask), *(_ptr(t) for t in tables),
            tables[0].shape[0], _ptr(out), _ptr(lse), b, h, k_all.shape[1], n,
            k_all.shape[2], d, int(q.dtype == torch.bfloat16), 0.125, softclamp, stream)
        if rc:
            raise RuntimeError(f"flash_ring launch failed: {rc}")
        return out, lse

    return run


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base", type=Path, help="root of the base checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_forward_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import BWD_REL_TOL, packed_ids
    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.parallel import ring as pring

    trees = {"base": args.base.resolve() / "ring_attention_tpu_torch" / "csrc",
             "head": HERE / "ring_attention_tpu_torch" / "csrc"}
    jobs = [(tree, csrc, name) for tree, csrc in trees.items() for name in SOURCES
            if (csrc / f"{name}.cu").is_file()]
    same_remote = all(
        (csrc / "flash_ring_remote.cu").is_file()
        and "int flash_ring_remote(" + (csrc / "flash_ring_remote.cu").read_text()
        .split("int flash_ring_remote(", 1)[1].split(")", 1)[0]
        == "int flash_ring_remote(" + (trees["head"] / "flash_ring_remote.cu").read_text()
        .split("int flash_ring_remote(", 1)[1].split(")", 1)[0]
        for csrc in trees.values())
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([(t, n) for t, _, n in jobs], pool.map(lambda j: build(*j), jobs)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    for (tree, name), (_, regs) in built.items():
        print(f"{tree} {name}:")
        for line in regs:
            print(f"  {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def mask(b, n):
        m = torch.rand((b, n), generator=gen, device="cuda") > 0.3
        m[-1] = False  # a batch row whose keys are all masked
        return m.to(torch.uint8)

    ok = True
    fwd = {tree: fwd_launcher(built[(tree, "flash_fwd")][0], takes_ids(csrc, "flash_fwd"))
           for tree, csrc in trees.items() if (tree, "flash_fwd") in built}
    bwd = {tree: bwd_launcher(built[(tree, "flash_bwd")][0], takes_ids(csrc, "flash_bwd"))
           for tree, csrc in trees.items() if (tree, "flash_bwd") in built}
    ring = {tree: ring_launcher(built[(tree, "flash_ring")][0])
            for tree in trees if (tree, "flash_ring") in built}
    remote = {tree: remote_runner(built[(tree, "flash_ring_remote")][0])
              for tree in trees if (tree, "flash_ring_remote") in built
              and (tree == "head" or same_remote)}

    def held(label, dtype, got, ref):
        """float32: bit-identical; bf16: within the plain-version bounds."""
        if dtype == torch.float32:
            same = all(bool((x == y).all()) for x, y in zip(got, ref))
            print(f"{label}: trees bit-identical {same}")
            return same
        rels = [((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()
                for x, y in zip(got, ref)]
        return rels

    # B1 cases: (b, h, hk, nq, nk, causal, hi, windowed, lo, softclamp, masked, carry)
    fwd_cases = {
        "causal 4096": (1, 8, 8, 4096, 4096, 1, 0, 0, 0, 0.0, False, False),
        "unbanded 4096": (1, 8, 8, 4096, 4096, 0, 0, 0, 0, 0.0, False, False),
        "causal offset nq 4096 nk 8192": (1, 8, 2, 4096, 8192, 1, 4096, 0, 0, 0.0, False, False),
        "window -700..-100 ragged 3000, mask, softclamp": (
            2, 8, 8, 3000, 3000, 1, -100, 1, -700, 30.0, True, False),
        "band-empty rows (hi -5000)": (1, 8, 8, 4096, 4096, 1, -5000, 0, 0, 0.0, False, False),
        "decode 32 folded rows, nk 5000, mask": (4, 2, 2, 32, 5000, 0, 0, 0, 0, 0.0, True, False),
        "nq 1025 (128k+1), causal offset 96": (1, 8, 2, 1025, 1121, 1, 96, 0, 0, 0.0, False, False),
        "nq 1151 (128k+127), window -200, resume": (
            1, 8, 8, 1151, 1151, 1, 0, 1, -200, 0.0, False, True),
        "resume causal hi -1, mask": (2, 8, 8, 2048, 2048, 1, -1, 0, 0, 0.0, True, True),
        "window -700..-100 ragged 3000, mask, softclamp, f32": (
            2, 8, 8, 3000, 3000, 1, -100, 1, -700, 30.0, True, False),
        "resume causal hi -1, f32": (1, 8, 8, 2048, 2048, 1, -1, 0, 0, 0.0, False, True),
    }
    from chip_smoke import LSE_TOL, RING_REL_TOL
    from ring_attention_tpu_torch.ops.partials import FlashPartials, finalize_partials

    for name, (b, h, hk, nq, nk, causal, hi, windowed, lo, clamp, masked, carry) in fwd_cases.items():
        dtype = torch.float32 if "f32" in name else torch.bfloat16
        q = rand(b, h, nq, 64, dtype=dtype)
        k, v = rand(b, hk, nk, 64, dtype=dtype), rand(b, hk, nk, 64, dtype=dtype)
        m = mask(b, nk) if masked else None
        c = None
        if carry:
            c = (rand(b, h, nq, 64, dtype=torch.float32), rand(b, h, nq, dtype=torch.float32),
                 rand(b, h, nq, dtype=torch.float32).abs() + 1.0)
        # fused (from the carry when there is one), then partials
        for mode, partials in (("fused+carry" if carry else "fused", False),
                               ("resume" if carry else "seed", True)):
            outs = [fn(q, k, v, m, causal, hi, windowed, lo, clamp, c, partials)
                    for fn in fwd.values()]
            if partials:  # held through what they stand for: out and lse
                outs = [tuple(finalize_partials(FlashPartials(*x))) if dtype != torch.float32
                        else x for x in outs]
            got = held(f"B1 {name} {mode}", dtype, outs[-1], outs[0])
            if dtype == torch.float32:
                ok = ok and got
                continue
            lse_err = (outs[-1][1] - outs[0][1]).abs().max().item()
            close = got[0] <= RING_REL_TOL[str(dtype)] and lse_err <= LSE_TOL[str(dtype)][0]
            ok = ok and close
            print(f"B1 {name} {mode}: ||head - base|| / ||base|| {got[0]:.2e} (tol "
                  f"{RING_REL_TOL[str(dtype)]}), max|lse diff| {lse_err:.2e} (tol "
                  f"{LSE_TOL[str(dtype)][0]}) {close}")
        if carry or nq < 64:
            continue
        do = rand(b, h, nq, 64, dtype=dtype)
        out, lse = fwd["head"](q, k, v, m, causal, hi, windowed, lo, clamp)
        delta = (do.float() * out.float()).sum(-1)
        grads = [fn(do, q, k, v, lse, delta, m, causal, hi, windowed, lo, clamp)
                 for fn in bwd.values()]
        rels = held(f"B3 {name}", dtype, grads[-1][:1], grads[0][:1])
        if dtype == torch.float32:
            rels = [0.0 if rels else float("inf")]
        rels += [((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                 for x, y in zip(grads[-1][1:], grads[0][1:])]
        close = all(r <= BWD_REL_TOL[str(dtype)] for r in rels)
        ok = ok and close
        print(f"B3/B2 {name}: ||head - base|| / ||base|| dq {rels[0]:.2e}, dk {rels[1]:.2e}, "
              f"dv {rels[2]:.2e} (tol {BWD_REL_TOL[str(dtype)]}) {close}")

    n = 4096
    for layout, rank, dtype in (("contiguous", 3, torch.bfloat16),
                                ("striped", 1, torch.bfloat16), ("striped", 2, torch.float32)):
        q = rand(2, 8, n, 64, dtype=dtype)
        k_all, v_all = rand(2, 2, 4 * n, 64, dtype=dtype), rand(2, 2, 4 * n, 64, dtype=dtype)
        tables = pring._fused_tables(rank, 4, n, True, layout == "striped", None, 4,
                                     device="cuda")
        m = mask(2, 4 * n)
        outs = [fn(q, k_all, v_all, m, tables, 0.0) for fn in ring.values()]
        same = all(bool((x == y).all()) for x, y in zip(outs[0], outs[-1]))
        ok = ok and same
        print(f"B7 {layout} rank {rank}, h8 hk2, mask, {dtype}: trees bit-identical {same}")

    for layout, n_local, dtype, clamp in (("contiguous", 4096, torch.bfloat16, 0.0),
                                          ("striped", 4096, torch.bfloat16, 50.0),
                                          ("contiguous", 1000, torch.float32, 0.0)):
        qs = [rand(1, 8, n_local, 64, dtype=dtype) for _ in range(4)]
        ks, vs = ([rand(1, 2, n_local, 64, dtype=dtype) for _ in range(4)] for _ in range(2))
        tables = [pring._fused_tables(r, 4, n_local, True, layout == "striped", None, 4)
                  for r in range(4)]
        outs = [fn(qs, ks, vs, tables, clamp) for fn in remote.values()]
        same = all(bool((x == y).all()) for part in range(2)
                   for x, y in zip(outs[0][part], outs[-1][part]))
        ok = ok and same
        print(f"B8 causal ring of 4, {layout}, n_local {n_local}, h8 hk2, softclamp {clamp}, "
              f"{dtype}: trees bit-identical {same}")

    # timings, in turns: base, head, head, base
    n = 65536
    q, k, v = rand(1, 8, n, 64), rand(1, 8, n, 64), rand(1, 8, n, 64)
    carry = (rand(1, 8, n, 64, dtype=torch.float32), rand(1, 8, n, dtype=torch.float32),
             rand(1, 8, n, dtype=torch.float32).abs() + 1.0)
    nl = 16384
    k_all, v_all = rand(1, 8, 4 * nl, 64), rand(1, 8, 4 * nl, 64)
    q_r = rand(1, 8, nl, 64)
    rank3 = pring._fused_tables(3, 4, nl, True, False, None, 4, device="cuda")
    do = rand(1, 8, n, 64)
    out, lse = fwd["head"](q, k, v, None, 1, 0, 0, 0, 0.0)
    delta = (do.float() * out.float()).sum(-1)
    ring_qs = [rand(1, 8, nl, 64) for _ in range(4)]
    ring_ks, ring_vs = ([rand(1, 8, nl, 64) for _ in range(4)] for _ in range(2))
    ring_tables = {striped: [pring._fused_tables(r, 4, nl, True, striped, None, 4)
                             for r in range(4)] for striped in (False, True)}
    ids = packed_ids(n)
    one_doc = torch.zeros_like(ids)  # the segmented instantiation's own cost
    # the decode: b 4, one query row a head, every cache slot valid
    dec = {}
    for h_, hk_, nk_ in ((8, 2, 32768), (8, 8, 4096)):
        dq_ = rand(4, h_, 1, 64)
        dk_, dv_ = rand(4, hk_, nk_, 64), rand(4, hk_, nk_, 64)
        dec[(h_, hk_, nk_)] = (dq_, dk_, dv_, torch.ones((4, nk_), dtype=torch.bool,
                                                        device="cuda"))
    decode = {}
    if "base" in fwd:
        def folded(fn):
            def run(q_, k_, v_, m_):
                b_, h_, _, _ = q_.shape
                hk_ = k_.shape[1]
                return fn(q_.reshape(b_, hk_, h_ // hk_, 64), k_, v_, m_.to(torch.uint8),
                          0, 0, 0, 0, 0.0)
            return run
        decode["base"] = folded(fwd["base"])
    decode_lib = built[("head", "flash_decode")][0]
    decode["head"] = lambda q_, k_, v_, m_: _with_library(
        "flash_decode", decode_lib, lambda: cf.cuda_flash_decode(q_, k_, v_, m_))

    def streamed(fn, calls=20):  # timed per call
        return lambda f: [fn(f) for _ in range(calls)], calls

    one_hop = {causal: [torch.tensor([x], dtype=torch.int32, device="cuda")
                        for x in (0, 0 if causal else n, -n, 1)] for causal in (True, False)}
    runs = {
        "B1 fused causal (1,8,65536,64)": (fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0)),
        "B1 fused unbanded (1,8,65536,64)": (fwd, lambda fn: fn(q, k, v, None, 0, 0, 0, 0, 0.0)),
        "B1 seed causal (1,8,65536,64)": (
            fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0, None, True)),
        "B1 resume causal (1,8,65536,64)": (
            fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0, carry)),
        "B1 fused+carry causal (1,8,65536,64)": (
            fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0, carry, False)),
        "B1 fused packed causal (1,8,65536,64)": (
            fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0, segs=(ids, ids))),
        "B1 fused packed causal (1,8,65536,64), one document": (
            fwd, lambda fn: fn(q, k, v, None, 1, 0, 0, 0, 0.0, segs=(one_doc, one_doc))),
        "B7 one causal hop (1,8,65536,64)": (
            ring, lambda fn: fn(q, k, v, None, one_hop[True], 0.0)),
        "B7 one unbanded hop (1,8,65536,64)": (
            ring, lambda fn: fn(q, k, v, None, one_hop[False], 0.0)),
        "B7 rank 3 of a contiguous causal ring of 4, n_local 16384": (
            ring, lambda fn: fn(q_r, k_all, v_all, None, rank3, 0.0)),
        "B2 dk/dv causal (1,8,65536,64)": (
            bwd, lambda fn: fn(do, q, k, v, lse, delta, None, 1, 0, 0, 0, 0.0,
                               passes=("dkv",))),
        "B2 dk/dv packed causal (1,8,65536,64)": (
            bwd, lambda fn: fn(do, q, k, v, lse, delta, None, 1, 0, 0, 0, 0.0,
                               passes=("dkv",), segs=(ids, ids))),
        **{f"decode b4 h{h_} hk{hk_} nk{nk_}, per call in a stream of 20": (
            decode, *streamed(lambda fn, a=args: fn(*a)))
           for (h_, hk_, nk_), args in dec.items()},
        "B3 dq causal (1,8,65536,64)": (
            bwd, lambda fn: fn(do, q, k, v, lse, delta, None, 1, 0, 0, 0, 0.0,
                               passes=("dq",))),
        "B3 dq packed causal (1,8,65536,64)": (
            bwd, lambda fn: fn(do, q, k, v, lse, delta, None, 1, 0, 0, 0, 0.0,
                               passes=("dq",), segs=(ids, ids))),
        "B8 whole causal ring of 4, contiguous, n_local 16384": (
            remote, lambda fn: fn(ring_qs, ring_ks, ring_vs, ring_tables[False], 0.0)),
        "B8 whole causal ring of 4, striped, n_local 16384": (
            remote, lambda fn: fn(ring_qs, ring_ks, ring_vs, ring_tables[True], 0.0)),
    }
    result = {"card": smi.stdout.strip(), "ms": {}}
    for label, (fns, call, *calls) in runs.items():
        per = calls[0] if calls else 1
        order = [t for t in ("base", "head", "head", "base") if t in fns]
        times: dict[str, list[float]] = {t: [] for t in fns}
        for tree in order:
            times[tree].append(time_ms(lambda: call(fns[tree])) / per)
        means = {t: statistics.mean(ts) for t, ts in times.items()}
        ratio = means["head"] / means["base"] if "base" in means else None
        result["ms"][label] = {**means, "head_over_base": ratio}
        print(f"{label}: " + ", ".join(
            f"{t} {means[t]:.3f} ms (runs {[round(x, 3) for x in times[t]]})" for t in means)
            + ("" if ratio is None else f", head / base {ratio:.4f}"))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
