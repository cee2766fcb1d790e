"""The residuals a checkpointed region keeps by name, JAX ``checkpoint_name``.

JAX tags three residuals for its remat policies (``models/remat.py``):
each attention core's output and log-sum-exp, ``flash_out`` and
``flash_lse`` (the local kernel's core, the blockwise path and the scan
ring), and the FeedForward's post-norm input, ``ffn_in``.  A policy that
saves ``flash_out`` / ``flash_lse`` lets the backward skip the attention's
forward: it recomputes the rest of the block and reads the saved pair.

The port's attention cores are ``torch.autograd.Function``s whose kernels
are ctypes launches, which a selective checkpoint's dispatch mode cannot
see (and the ring's core holds a ring object, which no custom op can
take).  So a checkpointed region carries its own record of them, a
:class:`Region`, entered around its first forward (:meth:`Region.recording`)
and around its recompute (:meth:`Region.replaying`):

- :func:`attention_pair` is what each tagged core calls for its forward.
  In the first forward it runs the forward and, where the region keeps
  the attention residuals, keeps the pair, in call order; in the
  recompute it returns the kept pair instead of running, and the core
  saves the recomputed q, k, v beside it for its backward.  With
  ``offload`` the kept pairs of CUDA tensors wait in pinned host memory,
  copied on a side stream, and the recompute makes its stream wait for that
  copy before it brings them back; CPU tensors stay where they are (JAX
  degrades ``offload_attn`` to ``save_attn`` where there is no host memory
  space).
- :func:`checkpoint_name` marks ``ffn_in``: the identity, unless the region
  saves the name, where its value is cloned inside :func:`named_clone`, the
  one op a selective checkpoint's policy (``models/remat.py``) saves.

A core that runs under no region, or a region that keeps nothing, runs as
it would without a checkpoint.
"""

from __future__ import annotations

import threading

import torch

ATTENTION_NAMES = ("flash_out", "flash_lse")
FFN_NAMES = ("ffn_in",)

_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def active() -> Region | None:
    """The region whose forward or recompute this thread is running."""
    stack = _stack()
    return stack[-1] if stack else None


class _Entered:
    """A context manager that pushes ``region`` in one mode; it can be
    entered again (a second backward recomputes again)."""

    def __init__(self, region: Region, recompute: bool):
        self.region, self.recompute = region, recompute

    def __enter__(self):
        self.region.in_recompute = self.recompute
        self.region.next = 0
        _stack().append(self.region)
        return self.region

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Region:
    """What one checkpointed region keeps by name: ``names`` (JAX's residual
    names it saves) and, with ``offload``, the attention pairs in pinned host
    memory."""

    def __init__(self, names: tuple[str, ...] = (), offload: bool = False):
        self.names = frozenset(names)
        self.offload = offload
        self.keeps_attention = bool(self.names & set(ATTENTION_NAMES))
        self.kept: list = []
        self.in_recompute = False
        self.next = 0
        self.streams: dict = {}  # device -> the side stream of its copies

    def recording(self) -> _Entered:
        return _Entered(self, recompute=False)

    def replaying(self) -> _Entered:
        return _Entered(self, recompute=True)

    def keep(self, pair):
        self.kept.append(self._park(pair) if self.offload else _detached(pair))

    def _park(self, tree):
        """``tree``'s CUDA tensors copied to pinned host memory on a side
        stream (the device tensors stay alive until the copy has read them),
        each with the event that marks its copy; CPU tensors as they are."""
        if not isinstance(tree, torch.Tensor):
            return type(tree)(self._park(x) for x in tree)
        if tree.device.type != "cuda":
            return tree.detach()
        if tree.device not in self.streams:
            self.streams[tree.device] = torch.cuda.Stream(tree.device)
        stream = self.streams[tree.device]
        stream.wait_stream(torch.cuda.current_stream(tree.device))
        with torch.cuda.stream(stream):
            host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            host.copy_(tree.detach(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        tree.record_stream(stream)
        return _Parked(host, done, tree.device)

    def take(self):
        if self.next >= len(self.kept) or self.kept[self.next] is None:
            raise RuntimeError(
                "remat: the attention residuals this recompute reads were freed by an "
                "earlier backward; a second backward through a save_attn region is not "
                "supported (use retain_graph=False, or remat_policy=None)"
            )
        entry, self.kept[self.next] = self.kept[self.next], None
        self.next += 1
        return _unpark(entry) if self.offload else entry


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return type(tree)(_detached(x) for x in tree)


class _Parked:
    def __init__(self, host, done, device):
        self.host, self.done, self.device = host, done, device


def _unpark(tree):
    if isinstance(tree, _Parked):
        torch.cuda.current_stream(tree.device).wait_event(tree.done)
        return tree.host.to(tree.device, non_blocking=True)
    if isinstance(tree, torch.Tensor):
        return tree
    return type(tree)(_unpark(x) for x in tree)


def attention_pair(forward):
    """An attention core's ``(out, lse)`` (or any tuple of tensors and lists
    of tensors): ``forward()`` run, and kept where the active region keeps
    the attention residuals; in that region's recompute, the kept pair."""
    region = active()
    if region is None or not region.keeps_attention:
        return forward()
    if region.in_recompute:
        return region.take()
    pair = forward()
    region.keep(pair)
    return pair


def named_clone() -> str | None:
    """The name whose value is being cloned by :func:`checkpoint_name` right
    now, else None: a selective checkpoint's policy saves that clone."""
    return getattr(_state, "naming", None)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """JAX ``checkpoint_name``: ``x`` itself, or where the active region
    saves ``name``, a clone that the region's selective checkpoint keeps
    (so its recompute reads the saved value)."""
    region = active()
    if region is None or name not in region.names:
        return x
    _state.naming = name
    try:
        return x.clone()
    finally:
        _state.naming = None
