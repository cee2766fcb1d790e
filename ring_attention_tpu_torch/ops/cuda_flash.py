"""Forward flash attention on the hand-written CUDA kernel ``csrc/flash_fwd.cu``.

Host side of the port of the TPU forward sweep
``ring_attention_tpu/ops/pallas_flash.py::_flash_fwd_call`` in its fused mode
(normalized output + lse):

- ``flash_fwd`` is the kernel wrapper.  A CUDA tensor launches the kernel
  (or raises); a CPU tensor runs ``flash_fwd_reference``, the plain version
  of the same function.  Nothing else selects between the two.
- ``cuda_flash_attention`` mirrors ``pallas_flash_attention`` (:2281).
- ``cuda_flash_decode`` mirrors ``pallas_flash_decode`` (:1340): the GQA
  group folds onto query rows so each cache byte is read once per kv head.

``launch_count`` counts kernel launches (plain-version calls do not count),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import EPSILON, MASK_VALUE, softclamp
from ..utils.validate import check_attention_args

SUPPORTED_HEAD_DIMS = (64,)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; the caller may set it to 0.
launch_count = 0


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: dense scores in float32.

    Local element ``(i, j)`` attends iff ``window_lo <= j - i <=
    causal_offset`` (each bound only when given) and ``kv_mask[b, j]``.
    Returns ``(out (b, h, nq, d) in q.dtype, lse (b, h, nq) f32)``."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    qg = q.reshape(b, hk, h // hk, nq, d).float()
    s = torch.einsum("bhgid,bhjd->bhgij", qg, k.float()) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    keep = torch.ones((nq, nk), dtype=torch.bool, device=q.device)
    if causal_offset is not None:
        off = (torch.arange(nk, device=q.device)[None, :]
               - torch.arange(nq, device=q.device)[:, None])
        keep = off <= causal_offset
        if window_lo is not None:
            keep = keep & (off >= window_lo)
    keep = keep[None, None, None]
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, None, :]
    s = torch.where(keep, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = torch.clamp(p.sum(dim=-1), min=EPSILON)
    out = torch.einsum("bhgij,bhjd->bhgid", p, v.float()) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.reshape(b, h, nq, d).to(q.dtype), lse.reshape(b, h, nq)


def _check_kernel_args(q, k, v, kv_mask) -> None:
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash_fwd: dtype {q.dtype} unsupported; use bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd: q, k, v must share a dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_fwd: head dim {q.shape[-1]} unsupported; the kernel is "
            f"built for {SUPPORTED_HEAD_DIMS}"
        )
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_fwd: empty query or key sequence")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("flash_fwd: batch * heads exceeds the grid's 65535 rows")
    tensors = [q, k, v] + ([kv_mask] if kv_mask is not None else [])
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"flash_fwd: tensors on {x.device} and {q.device}")
    for x in (q, k, v):
        if not x.is_contiguous():
            raise ValueError("flash_fwd: q, k and v must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("flash_fwd: q, k and v must be 16-byte aligned")


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward flash sweep: ``(out in q.dtype, lse f32)``.

    Same arguments and result as :func:`flash_fwd_reference`.  CPU tensors
    take that plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_reference(
            q, k, v, kv_mask, scale=scale, causal_offset=causal_offset,
            window_lo=window_lo, softclamp_value=softclamp_value,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    _check_kernel_args(q, k, v, kv_mask)
    from ._build import flash_fwd_library

    lib = flash_fwd_library()
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    causal = causal_offset is not None
    windowed = causal and window_lo is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, h, hk, nq, nk, d, int(q.dtype == torch.bfloat16), float(scale),
            int(causal), int(causal_offset) if causal else 0,
            int(windowed), int(window_lo) if windowed else 0,
            float(softclamp_value or 0.0), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: CUDA error {rc} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    global launch_count
    launch_count += 1
    return out, lse


class _CudaFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal_offset, window_lo,
                softclamp_value):
        out, _ = flash_fwd(
            q, k, v, kv_mask, scale=scale, causal_offset=causal_offset,
            window_lo=window_lo, softclamp_value=softclamp_value,
        )
        return out

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "cuda_flash_attention has no backward yet: the dk/dv and dq "
            "kernels (TPU kernels B2/B3) come with the training slice, "
            "ROADMAP.md Port queue item 1"
        )


def cuda_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact flash attention on the CUDA kernel (GQA-aware), forward only.

    Same contract as ``ops.flash.flash_attention``: ``causal`` is
    end-aligned (``causal_offset = nk - nq``) and drops ``mask``;
    ``window`` keeps the last ``window`` keys of each query."""
    check_attention_args("cuda_flash_attention", q, k, v, mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError(
            "cuda_flash_attention: lookback windows require causal attention"
        )
    if causal:
        mask = None
    causal_offset = k.shape[2] - q.shape[2] if causal else None
    window_lo = causal_offset - (window - 1) if window is not None else None
    return _CudaFlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), mask, scale,
        causal_offset, window_lo, softclamp_value,
    )


def cuda_flash_decode(
    q: torch.Tensor,  # (b, h, nq, d), nq tiny (typically 1)
    k: torch.Tensor,  # (b, hk, nk, d)
    v: torch.Tensor,  # (b, hk, nk, d)
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    *,
    scale: float | None = None,
    softclamp_value: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode attention with the cache read once per kv head.

    The head group folds onto query rows, ``(b, h, nq, d) -> (b, hk,
    g*nq, d)``, and one non-causal sweep runs over the masked cache.
    Returns ``(out (b, h, nq, d) in q.dtype, lse (b, h, nq) f32)``."""
    check_attention_args("cuda_flash_decode", q, k, v, kv_mask)
    b, h, nq, d = q.shape
    hk = k.shape[1]
    if scale is None:
        scale = d**-0.5
    folded = q.reshape(b, hk, (h // hk) * nq, d)
    out, lse = flash_fwd(
        folded.contiguous(), k.contiguous(), v.contiguous(), kv_mask, scale=scale,
        softclamp_value=softclamp_value,
    )
    return out.reshape(b, h, nq, d), lse.reshape(b, h, nq)
