"""Named rematerialization policies for RingTransformer layers.

Port of ``ring_attention_tpu/models/remat.py``: the same eight names, each
saying what a rematerialized block may keep instead of recomputing, and
``resolve_remat_policy`` with its ``ValueError`` naming every valid policy.
``remat=True`` runs each layer's attention and each layer's FeedForward as
a checkpointed region of its own (:func:`remat_call`,
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``), with that
layer's policy:

=============================  ===========================================
``nothing_saveable`` / None    nothing: the backward reruns the block from
                               its input, the attention's forward included
``everything_saveable``        everything: the block is not checkpointed
``checkpoint_dots``            the outputs of ``aten.mm``, ``addmm`` and
                               ``bmm`` (a selective checkpoint)
``checkpoint_dots_no_batch``   the same without ``bmm``
``save_attn``                  each attention core's ``(out, lse)``
                               (``flash_out`` / ``flash_lse``): the
                               backward recomputes the projections and not
                               the attention
``save_ffn_inputs``            the FeedForward's post-norm input
                               (``ffn_in``, a selective checkpoint)
``save_attn_and_ffn_inputs``   both
``offload_attn``               as ``save_attn``, the pairs in pinned host
                               memory between the forward and the backward
=============================  ===========================================

The attention pairs are kept by ``ops/residuals.py`` (the kernels are
ctypes launches that a selective checkpoint cannot see); the fused ring
(``impl="fused"``) tags nothing, as the JAX fused ring does, and reruns.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.residuals import ATTENTION_NAMES, FFN_NAMES, Region, named_clone


@dataclass(frozen=True)
class RematPolicy:
    """What a checkpointed region keeps: the residuals it saves by name
    (``names``), the dispatcher ops whose outputs it saves (``ops``), all of
    it (``everything``: no checkpoint), and whether the attention pairs wait
    in host memory (``offload``)."""

    names: tuple[str, ...] = ()
    ops: tuple[str, ...] = ()
    everything: bool = False
    offload: bool = False


REMAT_POLICIES = {
    "nothing_saveable": RematPolicy(),
    "everything_saveable": RematPolicy(everything=True),
    "checkpoint_dots": RematPolicy(ops=("mm", "addmm", "bmm")),
    "checkpoint_dots_no_batch": RematPolicy(ops=("mm", "addmm")),
    "save_attn": RematPolicy(names=ATTENTION_NAMES),
    "save_ffn_inputs": RematPolicy(names=FFN_NAMES),
    "save_attn_and_ffn_inputs": RematPolicy(names=ATTENTION_NAMES + FFN_NAMES),
    "offload_attn": RematPolicy(names=ATTENTION_NAMES, offload=True),
}


def _unknown(prefix: str, name) -> ValueError:
    return ValueError(
        f"{prefix}unknown remat_policy {name!r}; valid policies: "
        f"{', '.join(sorted(REMAT_POLICIES))} (or None for plain full-block remat)"
    )


def resolve_remat_policy(name: str | None) -> RematPolicy | None:
    """The policy of a registry name (None: plain full-block remat).  An
    unknown name raises ``ValueError`` listing every valid policy."""
    if name is None:
        return None
    if name not in REMAT_POLICIES:
        raise _unknown("", name)
    return REMAT_POLICIES[name]


def layer_policies(remat_policy, depth: int) -> tuple[RematPolicy | None, ...]:
    """Per-layer policies, validated as the JAX model's ``_remat_policies``
    validates their names: one name for every layer or a tuple with one per
    layer, each a registry name or None."""
    names = remat_policy if isinstance(remat_policy, tuple) else (remat_policy,) * depth
    if len(names) != depth:
        raise ValueError(
            f"RingTransformer: remat_policy tuple has {len(names)} entries for depth "
            f"{depth} (one policy name per layer, or a single name for all layers)"
        )
    for name in names:
        if name is not None and name not in REMAT_POLICIES:
            raise _unknown("RingTransformer: ", name)
    return tuple(resolve_remat_policy(name) for name in names)


def _selective(policy: RematPolicy, region: Region, ctx, op, *args, **kwargs):
    """A selective checkpoint's verdict on one dispatcher op: saved when it is
    one of the policy's ops, or the clone that names a residual the region
    saves (``ops/residuals.py::checkpoint_name``)."""
    name = op.overloadpacket.__name__
    if name in policy.ops or (name == "clone" and named_clone() in region.names):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Both:
    """Two context managers entered as one, again at every entry."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def __enter__(self):
        self.first.__enter__()
        try:
            self.second.__enter__()
        except BaseException:
            self.first.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            self.second.__exit__(*exc)
        finally:
            self.first.__exit__(*exc)
        return False


def _contexts(policy: RematPolicy | None):
    """The forward and recompute contexts of one checkpointed call: its
    :class:`Region`, inside a selective checkpoint where the policy saves a
    dispatcher op or ``ffn_in``."""
    policy = policy or RematPolicy()
    region = Region(policy.names, policy.offload)
    if not policy.ops and not set(policy.names) & set(FFN_NAMES):
        return region.recording(), region.replaying()
    forward, recompute = create_selective_checkpoint_contexts(
        functools.partial(_selective, policy, region))
    return _Both(region.recording(), forward), _Both(region.replaying(), recompute)


def remat_call(policy: RematPolicy | None, fn, *args):
    """``fn(*args)`` as one checkpointed region under ``policy``: saved are
    the region's inputs and what the policy keeps, and the backward
    recomputes the rest.  ``everything_saveable`` and a call without
    gradients run ``fn`` as it is."""
    if (policy is not None and policy.everything) or not torch.is_grad_enabled():
        return fn(*args)
    # the model draws no random numbers: no RNG state to restore
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, policy))
