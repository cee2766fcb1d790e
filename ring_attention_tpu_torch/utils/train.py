"""Training-step composition: gradient accumulation, clipping, a guarded step.

Port of ``ring_attention_tpu/utils/train.py::make_train_step`` (with
``StepStats`` and ``init_step_stats``) over a ``torch.optim.Optimizer``.
PyTorch holds parameters and optimizer state in place, so the JAX step's
``(params, opt_state)`` arguments and results fall away: ``loss_fn`` closes
over the model, and the optimizer's parameter groups are what the step
updates.

- ``step(*batch) -> loss``: one optimizer step over ``accum_steps``
  microbatches (each batch tensor split along its leading axis), gradients
  accumulated in float32 and averaged, then one update.
- ``clip_grad_norm`` clips the full-batch gradient to that global L2 norm
  with JAX's factor ``min(1, c / max(norm, 1e-12))``.
- ``skip_nonfinite=True`` is the guarded step ``step(stats, *batch) ->
  (stats, loss)``: when the loss or any gradient is non-finite the
  optimizer is not stepped, so parameters and optimizer state stay
  bit-identical.  The check reads one scalar on the host.
- ``on_step_end(outputs)`` is called after each step with its return value.
- ``mesh``: the mesh the model runs on.  On a mesh whose ranks are
  processes each process's ``loss_fn`` gives its share of the loss (as
  ``RingTransformer``'s loss does there), and the step sums every
  parameter's gradient over every process of the mesh, the seq ring and
  the data ring alike (``parallel/mesh.py::mesh_all_reduce``, the sum
  that SPMD partitioning inserts in JAX), before it averages the
  microbatches, clips and checks for non-finite values: every process
  then takes the same decisions and the same update.  Without a mesh, or
  on one that this process holds whole, nothing is summed.

- ``offload_opt_state=True`` (JAX ``utils/train.py:102-128``): between
  steps the optimizer's state tensors on the CUDA device (Adam's moments)
  wait in pinned host memory; each step brings them to the device for
  ``optimizer.step()`` and parks them again, then waits for the copy, so
  that the state read on the host between steps is the step's.  The
  parameters are bit-identical to the step without it.  State on the CPU
  (a CPU model, Adam's step count) stays where it is: on the CPU the
  option changes nothing, as JAX's does without a host memory space.

- ``shard_opt_state=True`` (ZeRO-1, JAX ``utils/train.py:129-140,
  170-174, 240-248``): over the data ring of ``mesh=`` (JAX's
  ``shard_mesh=``: here the one mesh the gradients are summed over and the
  state sharded over; without it the step raises JAX's ``ValueError``,
  naming ``mesh=``), of ``D`` processes, each process keeps the
  optimizer's state for its contiguous ``1/D`` of every parameter (the
  flattened parameter cut in ``D`` equal slices, the last padded with
  zeros).  The optimizer is rebuilt in place on those slices: its param
  groups hold them and its state is theirs (a state tensor it already
  holds shaped like its parameter is cut the same way).  Each step gives
  every slice its part of the summed, clipped gradient, steps the
  optimizer on the slices, and all-gathers the updated slices over the
  data ring into the replicated parameters, one flat buffer per dtype.
  An elementwise optimizer (Adam, AdamW, SGD with momentum) then updates
  every element as the plain step does: the same implementation (the
  group's ``foreach`` and ``fused`` flags, the same devices) on the same
  numbers.  With one data replica it changes nothing.  With
  ``offload_opt_state`` the slices' state is what is parked.

The JAX step's ``collect_metrics`` and ``jit_donate`` are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..parallel.collectives import Ring
from ..parallel.mesh import Mesh, mesh_all_reduce

# Where each option that is not ported yet will come from (ROADMAP.md).
UNPORTED = {
    "collect_metrics": "the runtime's telemetry, ROADMAP.md Port queue item 7f",
    "jit_donate": "a captured (CUDA-graph) step with the runtime, ROADMAP.md Port queue item 7f",
}


class StepStats(NamedTuple):
    """What the guarded step reports.

    ``step_ok``: whether this step's update was applied (False: a
    non-finite loss or gradient was found and the update skipped).
    ``skipped``: skipped steps since :func:`init_step_stats`."""

    step_ok: bool
    skipped: int


def init_step_stats() -> StepStats:
    return StepStats(step_ok=True, skipped=0)


class _ParkedState:
    """An optimizer's CUDA state tensors in pinned host memory between its
    steps (``make_train_step(offload_opt_state=True)``): one pinned buffer
    per state tensor, reused every step."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer
        self.parked: dict = {}  # (param, key) -> (pinned buffer, its device)

    def fetch(self) -> None:
        """The parked tensors back on their devices (in the current stream,
        after the copy that parked them)."""
        for p, state in self.optimizer.state.items():
            for key in state:
                host, device = self.parked.get((p, key), (None, None))
                if state[key] is host:
                    state[key] = host.to(device, non_blocking=True)

    def park(self) -> None:
        """Every CUDA state tensor copied into its pinned buffer, which then
        stands in the state; waits for the copies."""
        streams = set()
        for p, state in self.optimizer.state.items():
            for key, value in state.items():
                if not (torch.is_tensor(value) and value.device.type == "cuda"):
                    continue
                host, _ = self.parked.get((p, key), (None, None))
                if host is None or host.shape != value.shape or host.dtype != value.dtype:
                    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                self.parked[p, key] = host, value.device
                host.copy_(value, non_blocking=True)
                streams.add(torch.cuda.current_stream(value.device))
                state[key] = host
        for stream in streams:
            stream.synchronize()


class _ShardedState:
    """ZeRO-1 (``make_train_step(shard_opt_state=True)``): ``optimizer``
    rebuilt on this process's slices of its parameters, one slice of
    ``ceil(numel / D)`` elements per parameter (rank ``j`` of the data ring
    of ``D`` holds flat elements ``[j * size, (j + 1) * size)``, zero-padded
    past the end)."""

    def __init__(self, optimizer: torch.optim.Optimizer, ring: Ring):
        self.optimizer, self.ring = optimizer, ring
        world, rank = ring.world, ring.ranks[0]
        self.slots = []  # (parameter, its slice, the slice's size)
        for group in optimizer.param_groups:
            shards = []
            for p in group["params"]:
                size = -(-p.numel() // world)
                shard = self._cut(p.detach(), rank, size).requires_grad_()
                state = optimizer.state.pop(p, None)
                if state:
                    optimizer.state[shard] = {
                        key: self._cut(value, rank, size)
                        if torch.is_tensor(value) and value.dim() and value.shape == p.shape
                        else value
                        for key, value in state.items()}
                self.slots.append((p, shard, size))
                shards.append(shard)
            group["params"] = shards
        self.rank = rank

    @staticmethod
    def _cut(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """Elements ``[rank * size, (rank + 1) * size)`` of ``x`` flattened,
        zero-padded to ``size``, in a tensor of their own."""
        flat = x.reshape(-1)[rank * size:(rank + 1) * size]
        out = torch.zeros(size, dtype=x.dtype, device=x.device)
        out[:flat.numel()] = flat
        return out

    def step(self, grads: list[torch.Tensor]) -> None:
        """Step the optimizer on the slices with their part of ``grads``
        (one per parameter, in the optimizer's order), then gather the
        updated slices into the parameters."""
        for (_, shard, size), g in zip(self.slots, grads):
            shard.grad = self._cut(g.detach(), self.rank, size)
        self.optimizer.step()
        by_dtype: dict[torch.dtype, list] = {}
        for slot in self.slots:
            by_dtype.setdefault(slot[1].dtype, []).append(slot)
        with torch.no_grad():
            for slots in by_dtype.values():
                flat = torch.cat([shard.detach() for _, shard, _ in slots])
                (every,) = self.ring.all_gather([(flat,)], 0)[0]
                every = every.view(self.ring.world, flat.numel())
                offset = 0
                for p, _, size in slots:
                    whole = every[:, offset:offset + size].reshape(-1)[:p.numel()]
                    p.copy_(whole.view(p.shape))
                    offset += size


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: torch.optim.Optimizer,
    *,
    accum_steps: int = 1,
    skip_nonfinite: bool = False,
    clip_grad_norm: float | None = None,
    on_step_end: Callable[[Any], None] | None = None,
    mesh: Mesh | None = None,
    collect_metrics: bool = False,
    offload_opt_state: bool = False,
    shard_opt_state: bool = False,
    jit_donate: bool = False,
) -> Callable:
    """Build ``step(*batch) -> loss`` (or ``step(stats, *batch) -> (stats,
    loss)`` with ``skip_nonfinite``).

    ``loss_fn(*microbatch)`` returns a scalar computed from the parameters
    ``optimizer`` holds.  With ``accum_steps > 1`` each batch tensor's
    leading dimension must divide by it; the returned loss is then the mean
    of the microbatch losses (float32).  A parameter that gets no gradient
    is updated with a zero one, as the JAX step's dense gradient tree is."""
    for name, value in (("collect_metrics", collect_metrics), ("jit_donate", jit_donate)):
        if value:
            raise NotImplementedError(
                f"make_train_step: {name}= is not ported yet; it arrives with "
                f"{UNPORTED[name]}"
            )
    if accum_steps < 1:
        raise ValueError(f"make_train_step: accum_steps must be >= 1, got {accum_steps}")
    if clip_grad_norm is not None and clip_grad_norm <= 0:
        raise ValueError(
            f"make_train_step: clip_grad_norm must be > 0, got {clip_grad_norm}"
        )
    if shard_opt_state and mesh is None:
        raise ValueError(
            "make_train_step: shard_opt_state=True needs mesh= "
            "(the mesh whose data axis the optimizer state shards over)"
        )
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sharded = None
    if shard_opt_state and mesh.data > 1:
        sharded = _ShardedState(optimizer, mesh.data_ring)

    def zero_grad() -> None:
        # the model's parameters (the optimizer may hold ZeRO-1 slices)
        for p in params:
            p.grad = None

    def gradients(batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
        if accum_steps == 1:
            zero_grad()
            loss = loss_fn(*batch)
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            return loss.detach(), mesh_all_reduce(mesh, grads)

        def split(x):
            n = x.shape[0]
            if n % accum_steps:
                raise ValueError(
                    f"make_train_step: leading batch dim {n} not divisible "
                    f"by accum_steps={accum_steps}"
                )
            return x.split(n // accum_steps)

        micro = list(zip(*(split(x) for x in batch)))
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for mb in micro:
            zero_grad()
            loss = loss_fn(*mb)
            loss.backward()
            for a, p in zip(acc, params):
                if p.grad is not None:
                    a += p.grad.float()
            loss_sum += loss.detach().float()
        inv = 1.0 / accum_steps
        grads = [(a * inv).to(p.dtype) for a, p in zip(mesh_all_reduce(mesh, acc), params)]
        return loss_sum * inv, grads

    def compute_update(batch) -> tuple[torch.Tensor, list[torch.Tensor], torch.Tensor | None]:
        loss, grads = gradients(batch)
        # one global norm serves clipping and the non-finite guard: any
        # NaN/inf in any gradient propagates into it
        gnorm = None
        if clip_grad_norm is not None or skip_nonfinite:
            gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if clip_grad_norm is not None:
            clip = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            grads = [(g * clip).to(g.dtype) for g in grads]
        return loss, grads, gnorm

    parked = _ParkedState(optimizer) if offload_opt_state else None

    def apply(grads) -> None:
        for p, g in zip(params, grads):
            p.grad = g
        update = optimizer.step if sharded is None else (lambda: sharded.step(grads))
        if parked is None:
            update()
            return
        parked.fetch()
        update()
        parked.park()

    def finish(step):
        if on_step_end is None:
            return step

        def stepped(*args):
            out = step(*args)
            on_step_end(out)
            return out

        return stepped

    if not skip_nonfinite:

        def plain_step(*batch) -> torch.Tensor:
            loss, grads, _ = compute_update(batch)
            apply(grads)
            return loss

        return finish(plain_step)

    def guarded_step(stats: StepStats, *batch) -> tuple[StepStats, torch.Tensor]:
        loss, grads, gnorm = compute_update(batch)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if ok:
            apply(grads)
        # the skip leaves parameters and optimizer state untouched; the
        # returned loss is not masked, so logs show the offending value
        return StepStats(step_ok=ok, skipped=stats.skipped + (0 if ok else 1)), loss

    return finish(guarded_step)
