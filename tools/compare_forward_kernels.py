#!/usr/bin/env python3
"""Compare the port's flash kernels between two source trees on one GPU.

Builds ``csrc/flash_fwd.cu`` (B1), ``csrc/flash_bwd.cu`` (B2 and B3),
``csrc/flash_decode.cu`` (the split-KV decode), ``csrc/flash_ring.cu`` (B7)
and ``csrc/flash_ring_remote.cu`` (B8) of this checkout and of a base
checkout (for example the parent commit, unpacked with ``git archive``),
checks both trees' kernels against each other on a set of cases, and times
them in turns (base, head, head, base) with CUDA events:

    python3 tools/compare_forward_kernels.py BASE_DIR

B1 in every mode (fused, seed partials, resume, fused from a carry; also
packed, its segmented instantiation) and the float32 instantiations of
B3, B7 and B8 must give bit-identical outputs in the two trees, and every
instantiation of B1 and the float32 ones of B7 and B8 must keep their
ptxas registers and spills.  The bf16 B7 and B8 of this checkout must
equal this checkout's B1 hop chain bit for bit (seed partials, resumes,
the fused write from the carry over the same hops and bands): they walk
B1's sweep hop by hop.  B2 (dk/dv) and the bf16 B3 (dq) are held by their
norm-relative distance from the base tree's, within the bounds that
``chip_smoke.py`` holds them to their plain versions (BWD_REL_TOL).  B1
is timed in each mode and packed (also as one document), B2 and B3
unpacked and packed, B7 on ring rank 3's schedules and B8 on whole rings.
Only the kernels both trees have in common are compared: each tree's B1,
B2 and B3 are called with that tree's own C signature (a tree whose entry
points take document ids gets null ids, its unsegmented instantiation,
except in the packed runs), and B8 through this checkout's wrapper
(``ops/cuda_ring_remote.py``) on each tree's library, whose C signature
must be the same, with each tree's own block split (its items of 128 or
64 query rows, over the blocks its kernel fits on the card).  The decode is timed
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


def remote_runner(lib_path: Path, rows: int):
    """``run(qs, ks, vs, tables, softclamp)``: one B8 launch through this
    checkout's wrapper on the library at ``lib_path`` (the C signature this
    checkout declares), with the block split of that library's kernel:
    balanced over items of ``rows`` query rows and the blocks it fits on
    the card at once."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    splits: dict = {}

    def run(qs, ks, vs, tables, softclamp):
        b, h, n, _ = qs[0].shape
        is_bf16 = qs[0].dtype == torch.bfloat16

        def launch():
            key = (id(tables), is_bf16, bool(softclamp))
            if key not in splits:
                capacity = crr._capacity(qs[0].device.index, is_bf16, bool(softclamp))
                items = len(qs) * b * h * -(-n // (rows if is_bf16 else 64))
                splits[key] = crr.balanced_split(tables, n, b * h, min(capacity, items),
                                                 rows if is_bf16 else 64)
            return crr.fused_ring_remote(qs, ks, vs, tables=tables, n_local=n, scale=0.125,
                                         softclamp_value=softclamp or None,
                                         cta_split=splits[key])

        return _with_library("flash_ring_remote", lib_path, launch)

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
    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    crr._capacity.cache_clear()  # the occupancy of this library's kernel
    try:
        return call()
    finally:
        setattr(_build, attr, loader)
        crr._capacity.cache_clear()



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


def b1_chain(run, q, k_all, v_all, mask, tables, softclamp):
    """The hop chain of B1 launches that one fused-ring launch over the
    gathered span stands for: seed partials, resumes and the fused write
    from the carry over the hops with work, each with its table band and
    its origin's block of k, v and the key mask; ``(out, lse)``."""
    n = q.shape[2]
    origins, his, los, works = (t.tolist() for t in tables)
    live = [(o, hi, lo) for o, hi, lo, w in zip(origins, his, los, works) if w]
    carry = None
    for i, (o, hi, lo) in enumerate(live):
        rows = slice(o * n, (o + 1) * n)
        hop_mask = None if mask is None else mask[:, rows].contiguous()
        carry = run(q, k_all[:, :, rows].contiguous(), v_all[:, :, rows].contiguous(), hop_mask,
                    1, hi, 1, lo, softclamp, carry, i < len(live) - 1)
    return carry


def same_registers(built, trees) -> bool:
    """Every instantiation of B1 and the float32 ones of B7 and B8: the same
    ptxas registers, stack frame and spills in both trees (not the static
    shared memory, which a module with dynamic shared memory rounds up)."""
    import re

    def kept(line):
        return (re.search(r"Used \d+ registers", line).group(),
                re.search(r"\d+ bytes stack frame.*", line).group())

    ok = True
    for name, prefix in (("flash_fwd", "flash_fwd_"), ("flash_ring", "flash_ring_f32"),
                         ("flash_ring_remote", "flash_ring_remote_f32")):
        if not all((tree, name) in built for tree in trees):
            continue
        usage = [{line.split(":")[0]: kept(line) for line in built[(tree, name)][1]
                  if line.startswith(prefix)} for tree in trees]
        same = usage[0] == usage[-1] and bool(usage[0])
        ok = ok and same
        print(f"{name} {prefix}*: ptxas the same in both trees {same}"
              + ("" if same else f": base {usage[0]}, head {usage[-1]}"))
    return ok


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

    fwd = {tree: fwd_launcher(built[(tree, "flash_fwd")][0], takes_ids(csrc, "flash_fwd"))
           for tree, csrc in trees.items() if (tree, "flash_fwd") in built}
    bwd = {tree: bwd_launcher(built[(tree, "flash_bwd")][0], takes_ids(csrc, "flash_bwd"))
           for tree, csrc in trees.items() if (tree, "flash_bwd") in built}
    ring = {tree: ring_launcher(built[(tree, "flash_ring")][0])
            for tree in trees if (tree, "flash_ring") in built}
    remote = {tree: remote_runner(built[(tree, "flash_ring_remote")][0],
                                  128 if "flash_sweep.cuh" in
                                  (csrc / "flash_ring_remote.cu").read_text() else 64)
              for tree, csrc in trees.items() if (tree, "flash_ring_remote") in built
              and (tree == "head" or same_remote)}
    ok = same_registers(built, tuple(trees))

    def held(label, dtype, got, ref):
        """float32: bit-identical; bf16: the norm-relative distances."""
        if dtype == torch.float32:
            same = all(bool((x == y).all()) for x, y in zip(got, ref))
            print(f"{label}: trees bit-identical {same}")
            return same
        rels = [((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()
                for x, y in zip(got, ref)]
        return rels

    def identical(label, got, ref) -> bool:
        same = all(bool((x == y).all()) for x, y in zip(got, ref))
        print(f"{label}: bit-identical {same}")
        return same

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
    both_take_ids = all(takes_ids(csrc, "flash_fwd") for csrc in trees.values())
    for name, (b, h, hk, nq, nk, causal, hi, windowed, lo, clamp, masked, carry) in fwd_cases.items():
        dtype = torch.float32 if "f32" in name else torch.bfloat16
        q = rand(b, h, nq, 64, dtype=dtype)
        k, v = rand(b, hk, nk, 64, dtype=dtype), rand(b, hk, nk, 64, dtype=dtype)
        m = mask(b, nk) if masked else None
        c = None
        if carry:
            c = (rand(b, h, nq, 64, dtype=torch.float32), rand(b, h, nq, dtype=torch.float32),
                 rand(b, h, nq, dtype=torch.float32).abs() + 1.0)
        # packed as documents whose boundaries fall inside tiles, where both
        # trees take ids: the segmented instantiation
        segs = [(None, None)]
        if nq == nk and both_take_ids:
            ids = (torch.arange(nq, device="cuda") // 700).to(torch.int32).expand(b, nq)
            segs.append((ids.contiguous(), ids.contiguous()))
        # fused (from the carry when there is one), then partials
        for seg in segs:
            for mode, partials in (("fused+carry" if carry else "fused", False),
                                   ("resume" if carry else "seed", True)):
                outs = [fn(q, k, v, m, causal, hi, windowed, lo, clamp, c, partials, segs=seg)
                        for fn in fwd.values()]
                ok = identical(f"B1 {name} {mode}" + (", packed" if seg[0] is not None else ""),
                               outs[-1], outs[0]) and ok
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

    # B7: bf16 against this checkout's B1 chain, f32 against the base tree
    for layout, rank, n, window, dtype, clamp in (
            ("contiguous", 3, 4096, None, torch.bfloat16, 0.0),
            ("striped", 1, 4096, None, torch.bfloat16, 30.0),
            ("contiguous", 2, 1000, 1500, torch.bfloat16, 0.0),
            ("striped", 2, 4096, None, torch.float32, 0.0)):
        q = rand(2, 8, n, 64, dtype=dtype)
        k_all, v_all = rand(2, 2, 4 * n, 64, dtype=dtype), rand(2, 2, 4 * n, 64, dtype=dtype)
        tables = pring._fused_tables(rank, 4, n, True, layout == "striped", window, 4,
                                     device="cuda")
        m = mask(2, 4 * n)
        label = (f"B7 {layout} rank {rank}, n_local {n}, window {window}, h8 hk2, mask, "
                 f"softclamp {clamp}, {dtype}")
        if dtype == torch.float32:
            outs = [fn(q, k_all, v_all, m, tables, clamp) for fn in ring.values()]
            ok = identical(f"{label}, the two trees", outs[-1], outs[0]) and ok
        else:
            ok = identical(f"{label}, vs the B1 hop chain",
                           ring["head"](q, k_all, v_all, m, tables, clamp),
                           b1_chain(fwd["head"], q, k_all, v_all, m, tables, clamp)) and ok

    # B8: bf16 against this checkout's B1 chain, rank by rank, f32 against
    # the base tree
    for layout, n_local, dtype, clamp in (("contiguous", 4096, torch.bfloat16, 0.0),
                                          ("striped", 4096, torch.bfloat16, 50.0),
                                          ("contiguous", 1000, torch.bfloat16, 0.0),
                                          ("contiguous", 1000, torch.float32, 0.0)):
        qs = [rand(1, 8, n_local, 64, dtype=dtype) for _ in range(4)]
        ks, vs = ([rand(1, 2, n_local, 64, dtype=dtype) for _ in range(4)] for _ in range(2))
        tables = [pring._fused_tables(r, 4, n_local, True, layout == "striped", None, 4)
                  for r in range(4)]
        label = (f"B8 causal ring of 4, {layout}, n_local {n_local}, h8 hk2, softclamp "
                 f"{clamp}, {dtype}")
        if dtype == torch.float32:
            outs = [fn(qs, ks, vs, tables, clamp) for fn in remote.values()]
            ok = identical(f"{label}, the two trees", outs[-1][0] + outs[-1][1],
                           outs[0][0] + outs[0][1]) and ok
            continue
        outs, lses = remote["head"](qs, ks, vs, tables, clamp)
        k_all, v_all = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
        chains = [b1_chain(fwd["head"], q, k_all, v_all, None,
                           [t.cuda() for t in table], clamp)
                  for q, table in zip(qs, tables)]
        ok = identical(f"{label}, vs the B1 hop chain", outs + lses,
                       [c[0] for c in chains] + [c[1] for c in chains]) and ok

    # timings, in turns: base, head, head, base
    n = 65536
    q, k, v = rand(1, 8, n, 64), rand(1, 8, n, 64), rand(1, 8, n, 64)
    carry = (rand(1, 8, n, 64, dtype=torch.float32), rand(1, 8, n, dtype=torch.float32),
             rand(1, 8, n, dtype=torch.float32).abs() + 1.0)
    nl = 16384
    k_all, v_all = rand(1, 8, 4 * nl, 64), rand(1, 8, 4 * nl, 64)
    q_r = rand(1, 8, nl, 64)
    rank3 = {striped: pring._fused_tables(3, 4, nl, True, striped, None, 4, device="cuda")
             for striped in (False, True)}
    # ring rank 3 at 262,144 tokens: 4 x 65,536 (q and the spans of the
    # causal sweep above, gathered)
    k_262k, v_262k = torch.cat([k] * 4, dim=2), torch.cat([v] * 4, dim=2)
    rank3_262k = pring._fused_tables(3, 4, n, True, False, None, 4, device="cuda")
    ring_262k = ([q] * 4, [k] * 4, [v] * 4,
                 [pring._fused_tables(r, 4, n, True, False, None, 4) for r in range(4)])
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
            ring, lambda fn: fn(q_r, k_all, v_all, None, rank3[False], 0.0)),
        "B7 rank 3 of a striped causal ring of 4, n_local 16384": (
            ring, lambda fn: fn(q_r, k_all, v_all, None, rank3[True], 0.0)),
        "B7 rank 3 of a contiguous causal ring of 4, n_local 65536": (
            ring, lambda fn: fn(q, k_262k, v_262k, None, rank3_262k, 0.0), 1, 3),
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
        "B8 whole causal ring of 4, contiguous, n_local 65536": (
            remote, lambda fn: fn(*ring_262k, 0.0), 1, 3),
    }
    result = {"card": smi.stdout.strip(), "ms": {}}
    for label, (fns, call, *calls) in runs.items():
        per = calls[0] if calls else 1
        iters = calls[1] if len(calls) > 1 else 5
        order = [t for t in ("base", "head", "head", "base") if t in fns]
        times: dict[str, list[float]] = {t: [] for t in fns}
        for tree in order:
            times[tree].append(time_ms(lambda: call(fns[tree]), iters) / per)
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
