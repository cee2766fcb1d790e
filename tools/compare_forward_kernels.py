#!/usr/bin/env python3
"""Compare the port's flash kernels between two source trees on one GPU.

Builds ``csrc/flash_fwd.cu`` (B1), ``csrc/flash_bwd.cu`` (B2 and B3),
``csrc/flash_decode.cu`` (B5, the split-KV decode), ``csrc/flash_fwd_q8.cu``
(B4, the int8 forward), ``csrc/flash_decode_q8.cu`` (B6, the int8 decode),
``csrc/flash_ring.cu`` (B7) and ``csrc/flash_ring_remote.cu`` (B8) of this
checkout and of a base checkout (for example the parent commit, unpacked
with ``git archive``), checks both trees' kernels against each other on a
set of cases, and times them in turns (base, head, head, base) with CUDA
events:

    python3 tools/compare_forward_kernels.py BASE_DIR

B1 in every mode (fused, seed partials, resume, fused from a carry; also
packed, its segmented instantiation) and the float32 instantiations of
B3, B7 and B8 must give bit-identical outputs in the two trees, and every
instantiation of B1 and the float32 ones of B7 and B8 must keep their
ptxas registers and spills.  A kernel whose source file and the shared
headers (``csrc/*.cuh``) are byte for byte the same in both trees must
give bit-identical outputs and keep every instantiation's registers: B2,
B3 and B5 then, besides B1, B7 and B8.  The bf16 B7 and B8 of this
checkout must equal this checkout's B1 hop chain bit for bit (seed
partials, resumes, the fused write from the carry over the same hops and
bands): they walk B1's sweep hop by hop.  Otherwise B2 (dk/dv) and the
bf16 B3 (dq) are held by their norm-relative distance from the base
tree's, within the bounds that ``chip_smoke.py`` holds them to their
plain versions (BWD_REL_TOL), B4 within Q8_REL_TOL and Q8_LSE_TOL in every
mode, and B6 within DECODE_Q8_REL_TOL and DECODE_Q8_LSE_TOL, fused and as
partials.  B1 is timed in each mode and packed (also as one document),
B2 and B3 unpacked and packed, B4 in each mode at 65,536, B5 and B6 on the
device alone (replayed from a CUDA graph of 20 calls), B7 on ring rank
3's schedules and B8 on whole rings.  Only the kernels both trees have in
common are compared: each tree's B1, B2 and B3 are called with that
tree's own C signature (a tree whose entry points take document ids gets
null ids, its unsegmented instantiation, except in the packed runs); each
tree's B4 with its own layout of v (V^T per block, ``cuda_flash_q8.
v_block_layout``, where its source reads it so; else v8 as quantized);
each tree's B6 with its own C signature (the split-KV one with counters
through this checkout's wrapper, the one with parts and a merge kernel
with its own scratch); B5 and B8 through this checkout's wrappers
(``ops/cuda_flash.py``, ``ops/cuda_ring_remote.py``) on each tree's
library, whose C signature must be the same, B8 with each tree's own
block split (its items of 128 or 64 query rows, over the blocks its
kernel fits on the card).  A kernel whose source the base tree lacks is
built and timed for this checkout alone.  Libraries land in
``build/compare/`` (ignored by git).  Prints the card's name and power
limit, each build's ptxas registers and spills per kernel, each case's
check, each timing and, as its last line, one JSON object with the
timings.  Exits non-zero when a build fails or an output differs.
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
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "flash_fwd_q8", "flash_decode_q8",
           "flash_ring", "flash_ring_remote")


def takes_ids(csrc: Path, name: str) -> bool:
    """Whether a tree's C entry points of ``name`` take document ids."""
    return "q_seg" in (csrc / f"{name}.cu").read_text()


def takes_docs(csrc: Path, name: str) -> bool:
    """Whether a tree's C entry points of ``name`` take a doc-tile table
    (null here: every launch compared runs without one) after the ids."""
    return "doc_tiles" in (csrc / f"{name}.cu").read_text()


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


def fwd_launcher(lib_path: Path, ids: bool, docs: bool = False):
    """``run(q, k, v, mask, causal, hi, windowed, lo, softclamp, carry,
    partials, segs)``: one B1 launch, ``(out, lse)`` (partials False) or f32
    partials ``(acc, m, l)``, from no carry or from ``carry``; ``ids``: the
    entry point takes document ids (``segs``, null by default) before the
    stream; ``docs``: and a doc-tile table after them (always null here)."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = ([ptr] * 12 + [i32] * 7 + [f32] + [i32] * 4 + [f32]
                              + [ptr] * (2 if ids else 0) + [ptr] * docs + [ptr])

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
            *(tuple(_ptr(x) for x in segs) if ids else ()), *(None,) * docs, stream)
        if rc:
            raise RuntimeError(f"flash_fwd launch failed: {rc}")
        return parts if partials else (out, lse)

    return run


def bwd_launcher(lib_path: Path, ids: bool, docs: bool = False):
    """``run(do, q, k, v, lse, delta, mask, causal, hi, windowed, lo,
    softclamp)``: one B2 launch then one B3 launch, ``(dq, dk, dv)``;
    ``ids`` and ``docs`` as in :func:`fwd_launcher`."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ids_arg = ids
    tail = ([i32] * 6 + [i32, f32] + [i32] * 4 + [f32] + [ptr] * (2 if ids else 0)
            + [ptr] * docs + [ptr])
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
                 int(causal), hi, int(windowed), lo, softclamp, *ids, *(None,) * docs,
                 stream)
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



def ring_launcher(lib_path: Path, ids: bool = False):
    """``run(q, k_all, v_all, mask, tables, softclamp)``: one B7 launch;
    ``ids``: the entry point takes document ids (null here) before the
    stream."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_ring.argtypes = ([ptr] * 8 + [i32, ptr, ptr] + [i32] * 7 + [f32, f32]
                               + [ptr] * (2 if ids else 0) + [ptr])

    def run(q, k_all, v_all, mask, tables, softclamp):
        b, h, n, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, n), device=q.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_ring(
            _ptr(q), _ptr(k_all), _ptr(v_all), _ptr(mask), *(_ptr(t) for t in tables),
            tables[0].shape[0], _ptr(out), _ptr(lse), b, h, k_all.shape[1], n,
            k_all.shape[2], d, int(q.dtype == torch.bfloat16), 0.125, softclamp,
            *(None,) * (2 if ids else 0), stream)
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


def unchanged(trees: dict, name: str) -> bool:
    """Whether ``csrc/<name>.cu`` and every shared header are byte for byte
    the same in both trees (so its outputs and registers must be)."""
    base, head = trees["base"], trees["head"]

    def files(csrc: Path) -> dict[str, bytes]:
        return {f.name: f.read_bytes() for f in sorted(csrc.glob("*.cuh"))
                } | {name: (csrc / f"{name}.cu").read_bytes()}

    return (base / f"{name}.cu").is_file() and files(base) == files(head)


def q8_fwd_launcher(lib_path: Path, blocked_v: bool, ids: bool = False):
    """``run(ops, mask, causal, hi, windowed, lo, softclamp, carry, partials,
    out_dtype)``: one B4 launch on quantized operands (``ops``: a dict of
    q8, qs, k8, ks, v8, v8t, vs, block), ``(out, lse)`` or f32 partials;
    ``blocked_v``: the tree's kernel reads V^T per block (v8t), else v8;
    ``ids``: its entry point takes ids and a doc-tile table (null here)."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    packing = [ptr] * 3 if ids else []
    lib.flash_fwd_q8.argtypes = ([ptr] * 15 + [i32] * 7 + [i32, f32] + [i32] * 4 + [f32]
                                 + packing + [ptr])

    def run(ops, mask, causal, hi, windowed, lo, softclamp, carry=None, partials=False,
            out_dtype=torch.bfloat16):
        b, h, nq, d = ops["q8"].shape
        hk, nk = ops["k8"].shape[1], ops["k8"].shape[2]
        dev = ops["q8"].device
        out = lse = None
        parts = (None, None, None)
        if partials:
            parts = (torch.empty((b, h, nq, d), device=dev), torch.empty((b, h, nq), device=dev),
                     torch.empty((b, h, nq), device=dev))
        else:
            out = torch.empty((b, h, nq, d), dtype=out_dtype, device=dev)
            lse = torch.empty((b, h, nq), device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_fwd_q8(
            _ptr(ops["q8"]), _ptr(ops["k8"]), _ptr(ops["v8t" if blocked_v else "v8"]),
            _ptr(ops["qs"]), _ptr(ops["ks"]), _ptr(ops["vs"]), _ptr(mask), _ptr(out), _ptr(lse),
            *(_ptr(x) for x in (carry or (None, None, None))), *(_ptr(x) for x in parts),
            b, h, hk, nq, nk, d, ops["block"], int(out_dtype == torch.bfloat16), 0.125,
            int(causal), hi, int(windowed), lo, softclamp, *[None] * len(packing), stream)
        if rc:
            raise RuntimeError(f"flash_fwd_q8 launch failed: {rc}")
        return parts if partials else (out, lse)

    return run


def q8_operands(q, k, v, block_k=None) -> dict:
    """q, k, v quantized as the int8 forward's wrapper does, with v both as
    quantized (v8) and as V^T per block (v8t)."""
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops.quant import quantize_blocks, quantize_rows

    bk = q8.q8_block(k.shape[2], block_k)
    (q8_, qs), (k8, ks) = quantize_rows(q), quantize_rows(k)
    v8, vs = quantize_blocks(v, bk)
    return {"q8": q8_, "qs": qs, "k8": k8, "ks": ks, "v8": v8,
            "v8t": q8.v_block_layout(v8, bk), "vs": vs, "block": bk}


def q8_decode_runner(lib_path: Path, split_kv: bool):
    """``run(q, kv, mask, fused)``: one B6 call, ``(out, lse)`` or the
    partials ``(acc, m, l)``.  ``split_kv``: the tree's entry point is the
    split-KV one (counters, rows a block), called through this checkout's
    wrapper; else the one with parts and a merge kernel, called here as its
    own wrapper called it (a new scratch each call)."""
    import torch

    if split_kv:
        from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

        def run(q, kv, mask, fused=True):
            return _with_library("flash_decode_q8", lib_path,
                                 lambda: q8.flash_decode_q8(q, kv, mask, fused=fused))

        return run
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_q8.argtypes = [ptr] * 12 + [i32] * 7 + [f32, f32, ptr]

    def run(q, kv, mask, fused=True):
        b, h, nq, d = q.shape
        hk, nk = kv.k_q.shape[1], kv.k_q.shape[2]
        rows = h // hk * nq
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        parts = max(1, min(-(-2 * sms // (b * hk)), -(-nk // 128))) * 4
        scratch = torch.empty((b * hk * parts * rows * (d + 2),), device=q.device)
        if fused:
            res = (torch.empty_like(q), torch.empty((b, h, nq), device=q.device))
            ptrs = (_ptr(res[0]), _ptr(res[1]), None, None, None)
        else:
            res = (torch.empty((b, hk, h // hk, nq, d), device=q.device),
                   torch.empty((b, hk, h // hk, nq), device=q.device),
                   torch.empty((b, hk, h // hk, nq), device=q.device))
            ptrs = (None, None, *(_ptr(x) for x in res))
        rc = lib.flash_decode_q8(
            _ptr(q), _ptr(kv.k_q), _ptr(kv.k_scale), _ptr(kv.v_q), _ptr(kv.v_scale),
            _ptr(None if mask is None else mask.to(torch.uint8)), *ptrs, _ptr(scratch),
            b, hk, rows, nk, d, parts, int(q.dtype == torch.bfloat16), d ** -0.5, 0.0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"flash_decode_q8 launch failed: {rc}")
        return res

    return run


def same_registers(built, trees) -> bool:
    """Every instantiation of B1, the float32 ones of B7 and B8, and every
    one of a kernel whose source and headers are unchanged (:func:
    `unchanged`): the same ptxas registers, stack frame and spills in both
    trees (not the static shared memory, which a module with dynamic shared
    memory rounds up)."""
    import re

    def kept(line):
        return (re.search(r"Used \d+ registers", line).group(),
                re.search(r"\d+ bytes stack frame.*", line).group())

    ok = True
    pinned = [("flash_fwd", "flash_fwd_"), ("flash_ring", "flash_ring_f32"),
              ("flash_ring_remote", "flash_ring_remote_f32")]
    pinned += [(name, "") for name in SOURCES if name != "flash_fwd" and unchanged(trees, name)]
    for name, prefix in pinned:
        if not all((tree, name) in built for tree in trees):
            continue
        usage = [{line.split(":")[0]: kept(line) for line in built[(tree, name)][1]
                  if line.startswith(prefix) and re.search(r"Used \d+ registers", line)}
                 for tree in trees]
        same = usage[0] == usage[-1] and bool(usage[0])
        ok = ok and same
        print(f"{name} {prefix or 'every kernel'}*: ptxas the same in both trees {same}"
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
    from chip_smoke import (
        BWD_REL_TOL,
        DECODE_Q8_LSE_TOL,
        DECODE_Q8_REL_TOL,
        Q8_LSE_TOL,
        Q8_REL_TOL,
        _graph_ms,
        packed_ids,
    )
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops.partials import FlashPartials, finalize_partials
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

    fwd = {tree: fwd_launcher(built[(tree, "flash_fwd")][0], takes_ids(csrc, "flash_fwd"),
                              takes_docs(csrc, "flash_fwd"))
           for tree, csrc in trees.items() if (tree, "flash_fwd") in built}
    bwd = {tree: bwd_launcher(built[(tree, "flash_bwd")][0], takes_ids(csrc, "flash_bwd"),
                              takes_docs(csrc, "flash_bwd"))
           for tree, csrc in trees.items() if (tree, "flash_bwd") in built}
    ring = {tree: ring_launcher(built[(tree, "flash_ring")][0], takes_ids(csrc, "flash_ring"))
            for tree, csrc in trees.items() if (tree, "flash_ring") in built}
    remote = {tree: remote_runner(built[(tree, "flash_ring_remote")][0],
                                  128 if "flash_sweep.cuh" in
                                  (csrc / "flash_ring_remote.cu").read_text() else 64)
              for tree, csrc in trees.items() if (tree, "flash_ring_remote") in built
              and (tree == "head" or same_remote)}
    ok = same_registers(built, trees)

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
    bwd_unchanged = len(bwd) == 2 and unchanged(trees, "flash_bwd")
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
        if bwd_unchanged:  # the same source: the same bits
            ok = identical(f"B3/B2 {name} dq, dk, dv", grads[-1], grads[0]) and ok
            continue
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

    # B4: each tree on its own layout of v, every mode, held to the base
    # tree's within chip_smoke's int8 bounds (bit for bit when unchanged)
    q8_fwd = {tree: q8_fwd_launcher(built[(tree, "flash_fwd_q8")][0],
                                    "v_block_layout" in (csrc / "flash_fwd_q8.cu").read_text(),
                                    takes_docs(csrc, "flash_fwd_q8"))
              for tree, csrc in trees.items() if (tree, "flash_fwd_q8") in built}

    def near(label, got, ref, rel_tol, lse_tol, same):
        """Bit identity when the source is unchanged (same), else the
        norm-relative distance of out and max|lse diff| (partials
        finalized)."""
        if same:
            return identical(label, got, ref)
        if len(got) == 3:
            got, ref = (finalize_partials(FlashPartials(*x)) for x in (got, ref))
        rel = ((got[0].float() - ref[0].float()).norm()
               / ref[0].float().norm().clamp_min(1e-30)).item()
        lse = (got[1] - ref[1]).abs().max().item()
        close = rel <= rel_tol and lse <= lse_tol
        print(f"{label}: ||head - base|| / ||base|| {rel:.2e} (tol {rel_tol}), max|lse diff| "
              f"{lse:.2e} (tol {lse_tol}) {close}")
        return close

    # (b, h, hk, nq, nk, causal, hi, windowed, lo, softclamp, masked, block_k, f32 out)
    q8_cases = {
        "causal 4096": (1, 8, 8, 4096, 4096, 1, 0, 0, 0, 0.0, False, None, False),
        "causal offset nq 2048 nk 4096, GQA h8 hk2": (1, 8, 2, 2048, 4096, 1, 2048, 0, 0, 0.0,
                                                      False, None, False),
        "window -700..-100 ragged 3000, mask, softclamp": (2, 8, 8, 3000, 3000, 1, -100, 1, -700,
                                                           30.0, True, 1000, False),
        "hop span bk2048 (1,8,2048,4096), f32 out": (1, 8, 8, 2048, 4096, 0, 0, 0, 0, 0.0,
                                                     False, 2048, True),
        "bk96 ragged (1,4,80,96) causal": (1, 4, 4, 80, 96, 1, 16, 0, 0, 0.0, False, None, False),
        "bk32 (1,4,80,96) causal": (1, 4, 4, 80, 96, 1, 16, 0, 0, 0.0, False, 32, False),
    }
    for name, (b, h, hk, nq, nk, causal, hi, windowed, lo, clamp, masked, bk, f32_out) in (
            q8_cases.items() if len(q8_fwd) == 2 else ()):
        out_dtype = torch.float32 if f32_out else torch.bfloat16
        q = rand(b, h, nq, 64, dtype=out_dtype)
        ops = q8_operands(q, rand(b, hk, nk, 64, dtype=out_dtype),
                          rand(b, hk, nk, 64, dtype=out_dtype), bk)
        m = mask(b, nk) if masked else None
        carry = (rand(b, h, nq, 64, dtype=torch.float32), rand(b, h, nq, dtype=torch.float32),
                 rand(b, h, nq, dtype=torch.float32).abs() + 1.0)
        for mode, c, partials in (("fused", None, False), ("seed", None, True),
                                  ("resume", carry, True), ("fused+carry", carry, False)):
            outs = [fn(ops, m, causal, hi, windowed, lo, clamp, c, partials, out_dtype)
                    for fn in q8_fwd.values()]
            ok = near(f"B4 {name} {mode}", outs[-1], outs[0], Q8_REL_TOL[str(out_dtype)],
                      Q8_LSE_TOL, unchanged(trees, "flash_fwd_q8")) and ok

    # B6: each tree's entry point, fused and partials, held to the base
    # tree's within chip_smoke's decode bounds
    q8_dec = {tree: q8_decode_runner(built[(tree, "flash_decode_q8")][0],
                                     "counters" in (csrc / "flash_decode_q8.cu").read_text())
              for tree, csrc in trees.items() if (tree, "flash_decode_q8") in built}
    for b, h, hk, nq, nk, dtype in ((4, 8, 2, 1, 32768, torch.bfloat16),
                                    (4, 8, 8, 1, 4096, torch.bfloat16),
                                    (2, 8, 1, 2, 5000, torch.float32)):
        if len(q8_dec) < 2:
            break
        q = rand(b, h, nq, 64, dtype=dtype)
        kv = q8.quantize_kv_cache(rand(b, hk, nk, 64, dtype=dtype), rand(b, hk, nk, 64, dtype=dtype))
        m = mask(b, nk).bool()
        m[-1] = True  # every request attends to some key
        for fused in (True, False):
            outs = [fn(q, kv, m, fused) for fn in q8_dec.values()]
            if not fused:  # (b, hk, g, nq) partials as (b, h, nq) rows
                outs = [tuple(x.flatten(1, 2) for x in o) for o in outs]
            label = f"B6 b{b} h{h} hk{hk} nq{nq} nk{nk} {dtype} {'fused' if fused else 'partials'}"
            ok = near(label, outs[-1], outs[0], DECODE_Q8_REL_TOL[str(dtype)], DECODE_Q8_LSE_TOL,
                      unchanged(trees, "flash_decode_q8")) and ok

    # B5: its source is this PR's or not; each tree's library through this
    # checkout's wrapper (one C signature)
    dec_lib = {tree: built[(tree, "flash_decode")][0] for tree in trees
               if (tree, "flash_decode") in built}
    if len(dec_lib) == 2:
        q = rand(4, 8, 1, 64)
        k_, v_ = rand(4, 2, 32768, 64), rand(4, 2, 32768, 64)
        m = mask(4, 32768).bool()
        m[-1] = True
        outs = [_with_library("flash_decode", lib, lambda: cf.cuda_flash_decode(q, k_, v_, m))
                for lib in dec_lib.values()]
        if unchanged(trees, "flash_decode"):
            ok = identical("B5 b4 h8 hk2 nk32768, mask", outs[-1], outs[0]) and ok
        else:
            rel = ((outs[-1][0].float() - outs[0][0].float()).norm() / outs[0][0].float().norm()).item()
            print(f"B5 b4 h8 hk2 nk32768, mask: ||head - base|| / ||base|| {rel:.2e}")

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
    # B5 through this checkout's wrapper on each tree's library, B6 through
    # each tree's entry point
    decode = {tree: (lambda q_, k_, v_, m_, lib=lib: _with_library(
        "flash_decode", lib, lambda: cf.cuda_flash_decode(q_, k_, v_, m_)))
        for tree, lib in dec_lib.items()}
    dec_q8 = {key: q8.quantize_kv_cache(args[1], args[2]) for key, args in dec.items()}
    # B4 on the causal sweep (block 1,024) and its modes (block 2,048)
    q8_ops = {bk: q8_operands(q, k, v, bk) for bk in (None, 2048)}

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
        **{f"B5 decode b4 h{h_} hk{hk_} nk{nk_}, on the device (CUDA graph of 20)": (
            decode, lambda fn, a=args: fn(*a), "graph")
           for (h_, hk_, nk_), args in dec.items()},
        **{f"B6 decode b4 h{h_} hk{hk_} nk{nk_}, on the device (CUDA graph of 20)": (
            q8_dec, lambda fn, a=args, kv_=dec_q8[key]: fn(a[0], kv_, a[3]), "graph")
           for key, args in dec.items() for h_, hk_, nk_ in (key,)},
        "B4 fused causal (1,8,65536,64), block 1024": (
            q8_fwd, lambda fn: fn(q8_ops[None], None, 1, 0, 0, 0, 0.0)),
        "B4 seed causal (1,8,65536,64), block 2048": (
            q8_fwd, lambda fn: fn(q8_ops[2048], None, 1, 0, 0, 0, 0.0, None, True)),
        "B4 resume (1,8,65536,64) x 65536 keys, block 2048": (
            q8_fwd, lambda fn: fn(q8_ops[2048], None, 0, 0, 0, 0, 0.0, carry, True)),
        "B4 fused+carry (1,8,65536,64) x 65536 keys, block 2048": (
            q8_fwd, lambda fn: fn(q8_ops[2048], None, 0, 0, 0, 0, 0.0, carry, False)),
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
    for label, (fns, call, *opts) in runs.items():
        graph = opts == ["graph"]  # replayed from a CUDA graph of 20 calls
        per = opts[0] if opts and not graph else 1
        iters = opts[1] if len(opts) > 1 else 5
        order = [t for t in ("base", "head", "head", "base") if t in fns]
        times: dict[str, list[float]] = {t: [] for t in fns}
        for tree in order:
            times[tree].append(_graph_ms(lambda: call(fns[tree])) if graph
                               else time_ms(lambda: call(fns[tree]), iters) / per)
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
