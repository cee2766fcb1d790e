"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each source under ``csrc/`` compiles, at first use, into a shared library
with a plain C interface for ``sm_90a`` (Hopper).  The library lands in the
package's ``build/`` directory (ignored by git) under a name that carries a
hash of the source and of the shared headers (``csrc/*.cuh``), so an edited
source or header never reuses a stale library.
Nothing here runs at import time: this module imports on machines without
``nvcc`` or a GPU, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the CUDA toolkit's, off PATH


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build with the CUDA toolkit's nvcc "
        "(on PATH or under /usr/local/cuda/bin)"
    )


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` into ``build/<name>-<hash>.so``.

    Raises ``RuntimeError`` with nvcc's output when the compile fails."""
    src = CSRC_DIR / f"{name}.cu"
    hasher = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        hasher.update(header.read_bytes())
    lib = BUILD_DIR / f"{name}-{hasher.hexdigest()[:16]}.so"
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
        "-o", str(tmp), str(src),
    ]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent reader never sees half a file
    return BuildResult(lib, seconds, log)


@functools.cache
def flash_fwd_library() -> ctypes.CDLL:
    """The built ``flash_fwd`` library with its C signature declared."""
    lib = ctypes.CDLL(str(build("flash_fwd").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, kv_mask, out, lse
        ptr, ptr, ptr,  # carry acc, m, l (all null: no carry)
        ptr, ptr, ptr,  # partials acc, m, l (all null: out + lse)
        i32, i32, i32, i32, i32, i32,  # B, H, Hk, Nq, Nk, D
        i32, f32,  # is_bf16, scale
        i32, i32, i32, i32,  # causal, hi, windowed, lo
        f32, ptr, ptr,  # softclamp, q_seg, kv_seg (both null: none)
        ptr, ptr,  # doc_tiles (null: none), stream
    ]
    lib.flash_fwd.restype = i32
    return lib


@functools.cache
def flash_bwd_library() -> ctypes.CDLL:
    """The built ``flash_bwd`` library with its two C signatures declared."""
    lib = ctypes.CDLL(str(build("flash_bwd").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    inputs = [ptr] * 7  # q, k, v, do, lse, delta, kv_mask
    shape = [
        i32, i32, i32, i32, i32, i32,  # B, H, Hk, Nq, Nk, D
        i32, f32,  # is_bf16, scale
        i32, i32, i32, i32,  # causal, hi, windowed, lo
        f32, ptr, ptr,  # softclamp, q_seg, kv_seg (both null: none)
        ptr, ptr,  # doc_tiles (null: none), stream
    ]
    lib.flash_bwd_dkv.argtypes = inputs + [ptr, ptr] + shape  # dk, dv
    lib.flash_bwd_dkv.restype = i32
    lib.flash_bwd_dq.argtypes = inputs + [ptr] + shape  # dq
    lib.flash_bwd_dq.restype = i32
    return lib


@functools.cache
def flash_decode_library() -> ctypes.CDLL:
    """The built ``flash_decode`` library with its C signature declared."""
    lib = ctypes.CDLL(str(build("flash_decode").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode.argtypes = [
        ptr, ptr, ptr, ptr,  # q, k, v, kv_mask
        ptr, ptr,  # out, lse (both null: partials)
        ptr, ptr, ptr,  # partials acc, m, l (all null: out + lse)
        ptr, ptr,  # scratch, counters
        i32, i32, i32, i32, i32, i32,  # B, Hk, R, Nk, D, S
        i32, f32, f32, ptr,  # is_bf16, scale, softclamp, stream
    ]
    lib.flash_decode.restype = i32
    return lib


@functools.cache
def flash_fwd_q8_library() -> ctypes.CDLL:
    """The built ``flash_fwd_q8`` library with its C signature declared."""
    lib = ctypes.CDLL(str(build("flash_fwd_q8").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_q8.argtypes = [
        ptr, ptr, ptr,  # q8, k8, v8 as V^T per block (cuda_flash_q8.v_block_layout)
        ptr, ptr, ptr,  # q, k (per row) and v (per block) scales
        ptr, ptr, ptr,  # kv_mask, out, lse
        ptr, ptr, ptr,  # carry acc, m, l (all null: no carry)
        ptr, ptr, ptr,  # partials acc, m, l (all null: out + lse)
        i32, i32, i32, i32, i32, i32, i32,  # B, H, Hk, Nq, Nk, D, Bk
        i32, f32,  # out_bf16, scale
        i32, i32, i32, i32,  # causal, hi, windowed, lo
        f32, ptr, ptr,  # softclamp, q_seg, kv_seg (both null: none)
        ptr, ptr,  # doc_tiles (null: none), stream
    ]
    lib.flash_fwd_q8.restype = i32
    lib.flash_q8_probe.argtypes = [ptr, ptr, ptr, ptr, ptr]  # a, b, c_ss, c_rs, stream
    lib.flash_q8_probe.restype = i32
    return lib


@functools.cache
def flash_decode_q8_library() -> ctypes.CDLL:
    """The built ``flash_decode_q8`` library with its C signature declared."""
    lib = ctypes.CDLL(str(build("flash_decode_q8").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_q8.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k8, k scales, v8, v scales, kv_mask
        ptr, ptr,  # out, lse (both null: partials)
        ptr, ptr, ptr,  # partials acc, m, l (all null: out + lse)
        ptr, ptr,  # scratch, counters
        i32, i32, i32, i32, i32, i32, i32,  # B, Hk, R, Nk, D, S, rows per block
        i32, f32, f32, ptr,  # q_bf16, scale, softclamp, stream
    ]
    lib.flash_decode_q8.restype = i32
    return lib


@functools.cache
def flash_ring_library() -> ctypes.CDLL:
    """The built ``flash_ring`` library with its C signature declared."""
    lib = ctypes.CDLL(str(build("flash_ring").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_ring.argtypes = [
        ptr, ptr, ptr, ptr,  # q, k_all, v_all, kv_mask
        ptr, ptr, ptr, ptr, i32,  # origins, his, los, works (int32), hops
        ptr, ptr,  # out, lse
        i32, i32, i32, i32, i32, i32,  # B, H, Hk, N, Ntot, D
        i32, f32, f32,  # is_bf16, scale, softclamp
        ptr, ptr, ptr,  # q_seg, kv_seg (both null: none), stream
    ]
    lib.flash_ring.restype = i32
    return lib


@functools.cache
def flash_ring_q8_library() -> ctypes.CDLL:
    """The built ``flash_ring`` library with its int8 C signature declared
    (a loader of its own: an older build of the source has no int8 entry)."""
    lib = ctypes.CDLL(str(build("flash_ring").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_ring_q8.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q8, q scales, k8, k scales, V^T per block, v scales
        ptr,  # kv_mask
        ptr, ptr, ptr, ptr, i32,  # origins, his, los, works (int32), hops
        ptr, ptr,  # out, lse
        i32, i32, i32, i32, i32, i32, i32,  # B, H, Hk, N, Ntot, D, Bk
        i32, f32, f32,  # out_bf16, scale, softclamp
        ptr, ptr, ptr,  # q_seg, kv_seg (both null: none), stream
    ]
    lib.flash_ring_q8.restype = i32
    return lib


@functools.cache
def flash_ring_remote_library() -> ctypes.CDLL:
    """The built ``flash_ring_remote`` library with its C signatures
    declared."""
    lib = ctypes.CDLL(str(build("flash_ring_remote").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.flash_ring_remote.argtypes = [
        ptrs, ptrs, ptrs, ptrs, ptrs,  # per-rank q, k, v, out, lse
        ptr, ptr, ptr, ptr,  # slots, spill acc, m, l
        ptr, ptr, ptr, ptr,  # his, los, works (W, hops) int32; flags
        ctypes.POINTER(i32), i32, i32,  # cta_split, W, hops
        i32, i32, i32, i32, i32,  # B, H, Hk, N, D
        i32, f32, f32, ptr,  # is_bf16, scale, softclamp, stream
    ]
    lib.flash_ring_remote.restype = i32
    lib.flash_ring_remote_capacity.argtypes = [i32, i32, ctypes.POINTER(i32)]  # bf16, clamp
    lib.flash_ring_remote_capacity.restype = i32
    return lib


@functools.cache
def flash_ring_remote_q8_library() -> ctypes.CDLL:
    """The built ``flash_ring_remote`` library with its int8 C signatures
    declared (a loader of its own: an older build has no int8 entries)."""
    lib = ctypes.CDLL(str(build("flash_ring_remote").path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    size = ctypes.c_longlong
    lib.flash_ring_remote_q8.argtypes = [
        ptrs, ptrs, ptrs, ptrs, ptrs,  # per-rank q8, q scales, feed blobs, out, lse
        ptr, ptr, ptr, ptr,  # slots (W, 2, blob bytes), spill acc, m, l
        ptr, ptr, ptr, ptr,  # his, los, works (W, hops) int32; flags
        ctypes.POINTER(i32), i32, i32,  # cta_split, W, hops
        i32, i32, i32, i32, i32,  # B, H, Hk, N, D
        size, size, size, size,  # blob bytes; offsets of k scales, V^T, v scales
        i32, f32, f32, ptr,  # out_bf16, scale, softclamp, stream
    ]
    lib.flash_ring_remote_q8.restype = i32
    lib.flash_ring_remote_q8_capacity.argtypes = [i32, ctypes.POINTER(i32)]  # clamp
    lib.flash_ring_remote_q8_capacity.restype = i32
    return lib
