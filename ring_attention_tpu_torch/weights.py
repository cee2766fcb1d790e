"""Parameters: carry a flax ``RingTransformer`` param tree over and back,
or make seeded random ones.

``load_jax_params`` takes the tree as nested dicts of numpy arrays (the
``params`` collection of ``RingTransformer.init``; a dict holding it under
``"params"`` is accepted too), so this module needs neither JAX nor flax.
A flax ``Dense`` kernel is ``(in, out)`` and becomes the transposed
``nn.Linear`` weight; embeddings and norm gains copy as they are.
``export_jax_params`` is the inverse.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .models.transformer import RingTransformer


def _flax_paths(model: RingTransformer) -> dict[str, tuple[tuple[str, ...], bool]]:
    """torch parameter name -> (flax path, transpose)."""
    paths = {
        "embed.weight": (("embed", "embedding"), False),
        "final_norm.gamma": (("final_norm", "gamma"), False),
        "to_logits.weight": (("to_logits", "kernel"), True),
    }
    for i in range(len(model.attn_layers)):
        attn, ff = f"attn_layers_{i}", f"ff_layers_{i}"
        paths[f"attn_layers.{i}.prenorm.gamma"] = ((attn, "prenorm", "gamma"), False)
        paths[f"attn_layers.{i}.to_qkv.weight"] = ((attn, "to_qkv", "kernel"), True)
        paths[f"attn_layers.{i}.to_out.weight"] = ((attn, "to_out", "kernel"), True)
        paths[f"ff_layers.{i}.norm.gamma"] = ((ff, "RMSNorm_0", "gamma"), False)
        paths[f"ff_layers.{i}.proj_in.weight"] = ((ff, "Dense_0", "kernel"), True)
        paths[f"ff_layers.{i}.proj_out.weight"] = ((ff, "Dense_1", "kernel"), True)
    return paths


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@torch.no_grad()
def load_jax_params(model: RingTransformer, params) -> RingTransformer:
    """Fill ``model`` from a flax param tree; every leaf must be used and
    every shape must match.  Returns ``model``."""
    if "params" in params:
        params = params["params"]
    leaves = dict(_leaves(params))
    paths = _flax_paths(model)
    torch_params = dict(model.named_parameters())
    if set(paths) != set(torch_params):
        raise ValueError(
            f"load_jax_params: model parameters {sorted(torch_params)} do not "
            f"match the expected layout {sorted(paths)}"
        )
    for name, (path, transpose) in paths.items():
        if path not in leaves:
            raise ValueError(f"load_jax_params: missing flax param {'/'.join(path)}")
        value = np.asarray(leaves.pop(path), dtype=np.float32)
        if transpose:
            value = value.T
        target = torch_params[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"load_jax_params: {'/'.join(path)} has shape {value.shape}, "
                f"{name} expects {tuple(target.shape)}"
            )
        target.copy_(torch.tensor(value))
    if leaves:
        unused = sorted("/".join(p) for p in leaves)
        raise ValueError(f"load_jax_params: unused flax params {unused}")
    return model


@torch.no_grad()
def export_jax_params(model: RingTransformer) -> dict:
    """The model's parameters as a flax param tree: ``{"params": nested
    dicts of float32 numpy arrays}``, the layout ``load_jax_params`` reads
    and ``RingTransformer.init`` returns.  The arrays are copies: later
    updates of the model leave them as they were."""
    torch_params = dict(model.named_parameters())
    tree: dict = {}
    for name, (path, transpose) in _flax_paths(model).items():
        value = torch_params[name].detach().to("cpu", torch.float32).numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(value.T if transpose else value, order="C")
    return {"params": tree}


@torch.no_grad()
def init_random_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random parameters at flax's default scales: normal with std
    ``1/sqrt(fan_in)`` for every Linear weight and ``1/sqrt(features)`` for
    embeddings, norm gains of one.  Drawn on the CPU from ``generator`` (a
    CPU generator) and copied, so a seed gives the same weights on every
    device.  Returns ``model``."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            w = module.weight
            std = 1.0 / math.sqrt(w.shape[1])
        elif isinstance(module, nn.Embedding):
            w = module.weight
            std = 1.0 / math.sqrt(w.shape[1])
        else:
            continue
        draw = torch.randn(tuple(w.shape), generator=generator, dtype=torch.float32)
        w.copy_(draw * std)
    for name, p in model.named_parameters():
        if name.endswith("gamma"):
            p.fill_(1.0)
    return model
