"""RingTransformer: causal LM, local or over a ring, serving and training.

Port of ``ring_attention_tpu/models/transformer.py``: token embedding,
``depth`` x (RingAttention + FeedForward) residual blocks, final RMSNorm
and logits, the dense cross-entropy loss with label shift and
``ignore_index`` (differentiable into the float32 parameters; train with
``utils/train.py::make_train_step``), and incremental decoding
(``init_cache`` / ``prefill`` / ``decode_step`` / ``generate``), the
memory knobs (``remat`` with the ``remat_policy`` registry of
``models/remat.py``, ``ff_chunk_size``, ``loss_chunk_size``,
``windowed_cache``), the int8 knobs ``quantize_cache``,
``compute_dtype="int8"`` and the ring's int8 wire
``ring_hop_compression="int8"`` of ``models/attention.py``, and the ring
variants ``ring_bidirectional``, ``ring_counter_rotate`` and
``ring_dkv_dtype``, passed to every layer.  On a
``mesh`` the model shards once at its top (pad, stripe when ``striped``)
and every layer runs the ring on that layout, hop by hop under
``impl="cuda"`` or fused under ``"fused"`` (one launch for the whole
ring, or one per rank when padding added a key mask), or with
``sequence_parallel="zigzag"`` pads to ``2 * W`` and runs zig-zag
attention (``parallel/zigzag.py``), with ``"ulysses"`` Ulysses
(``parallel/ulysses.py``, never striped), with ``"hybrid"`` on a factored
mesh (``create_mesh(ulysses_size=U, ring_size=R)``) Ulysses x Ring
(``parallel/hybrid.py``, striped at the outer degree ``R``); the
parameters are the same as without a mesh.  ``forward(segment_ids=)`` trains and scores packed
documents (the ids are padded with ``PAD_SEGMENT_ID`` and permuted with
the tokens on a mesh); ``mask=`` takes a mask expression (``masks.py``),
one for every layer or a tuple with one per layer, in place of ``causal``
and ``max_lookback_seq_len`` (``Causal() & DocumentMask(starts)`` declares
a packing: its loss, as the JAX model's, keeps every label).  Decoding on
a mesh keeps the cache sharded
contiguously over the ring: ``prefill`` runs the ring over the prompt and
``decode_step`` merges the ranks' partials by tree attention
(``parallel/tree_decode.py``).

On a mesh whose ranks are processes (``create_mesh`` over an initialized
process group: a ``DistributedRing`` per row and a data ring per column,
and on a factored mesh a ulysses group per ring chunk)
every process passes the same global tokens, ids and masks, as the JAX
model takes global arrays: the model pads and permutes them, keeps this
process's data rows and seq block (``parallel/sharding.py::shard_cut``,
the ``NamedSharding(P(data, seq))`` of the JAX model top; its combined
rank's block on a factored mesh) and runs the layers on that shard.  With
``auto_shard=False`` each process passes only its part instead
(process-local batches, ``parallel/mesh.py::shard_batch``): its rows and
its block, padded and in the ring's layout (with ``return_loss`` one token
more, the label of the block's last position), and gets that block's
logits; its loss is the mesh's, as with ``auto_shard``.  ``forward`` returns the global logits on every
process (``shard_gather``); ``return_loss`` the global mean loss, the same
value on every process, whose gradient is this process's share: the nll
of its own positions over the mesh's valid count.  The train step sums
the shares over the mesh (``make_train_step(mesh=)``).  Decoding keeps
this process's rows and its rank's cache shard; ``prefill`` runs the
prompt's blocks through the ring and takes the last logits from the rank
that holds them, and ``generate`` takes each token from the ring's rank 0
and gathers the rows' tokens over the data ring.  Decoding on a factored
mesh raises ``NotImplementedError``, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import PAD_SEGMENT_ID
from ..utils.validate import check_tokens_input
from ..parallel.mesh import mesh_all_reduce, seq_world
from ..parallel.sharding import (
    cut_rows,
    gather_rows,
    layout_for,
    layout_permute,
    pad_to_multiple,
    shard_cut,
    shard_gather,
)
from .attention import (
    RingAttention,
    check_compute_dtype,
    check_constructor,
    check_factored_decode,
    check_hop_compression,
    check_impl,
    check_mesh,
    check_zigzag,
    mask_form,
    resolve_impl,
)
from .layers import Dense, Embed, FeedForward, RMSNorm, resolve_device
from .remat import layer_policies, remat_call


def _position_nll(
    logits: torch.Tensor,  # (..., vocab), any float dtype
    labels: torch.Tensor,  # (...)
    valid: torch.Tensor,  # (...) bool
) -> torch.Tensor:
    """Per-position negative log likelihood in f32, zero where invalid."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    chosen = lf.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return torch.where(valid, lse - chosen, 0.0)


def _sample(logits, temperature, top_k, top_p, generator):
    """Next tokens ``(b,)`` from logits ``(b, vocab)``: greedy argmax at
    ``temperature <= 0``, else temperature, then top-k, then the top-p
    nucleus, then a categorical draw from ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    if top_k is not None:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None:
        # keep the smallest prefix of descending-probability tokens whose
        # mass reaches top_p (at least one token: each token's test uses
        # the mass before it)
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        mass_before = probs.cumsum(dim=-1) - probs
        cut = (mass_before < top_p).sum(dim=-1, keepdim=True)
        thresh = sorted_logits.gather(-1, cut - 1)
        logits = torch.where(logits < thresh, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class _MeshLoss(torch.autograd.Function):
    """The loss a process reports on a mesh of processes: the value is the
    mesh's (``total``, the same on every process), the gradient flows into
    this process's share (``local``) alone."""

    @staticmethod
    def forward(ctx, local, total):
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class RingTransformer(nn.Module):
    """Causal LM ``tokens (b, n) -> logits (b, n, num_tokens)`` (or loss).

    Arguments mirror the JAX ``RingTransformer`` fields;
    ``max_lookback_seq_len`` takes an int or a per-layer tuple, ``mask``
    one ``masks.Mask`` or a per-layer tuple (None entries follow ``causal``
    and ``max_lookback_seq_len``); ``mesh``
    (``parallel/mesh.py::create_mesh``) runs every layer's attention on the
    ring, in the ``striped`` layout when set, in this process or over the
    mesh's processes.  ``auto_shard=False`` takes tokens already padded and
    in the ring's layout and returns logits in it (on a mesh of processes,
    this process's rows and block: ``shard_batch``);
    ``use_ring=False`` or ``force_regular_attn`` run every layer locally
    (see ``RingAttention``), ``use_pallas`` selects ``impl`` when that is
    None; ``pallas_head_chunks`` has no CUDA counterpart.  The memory
    knobs: ``remat`` checkpoints each layer's attention and FeedForward,
    each a region of its own, under ``remat_policy`` (a name of
    ``models/remat.py``'s registry, or a per-layer tuple; None saves
    nothing); ``ff_chunk_size`` runs the blockwise FeedForward
    (``layers.FeedForward``), chunked within each sequence shard;
    ``loss_chunk_size`` computes the loss a chunk of positions at a time
    (:meth:`_chunked_nll`); ``windowed_cache`` sizes a lookback layer's
    decode cache to its window (local decoding only).  Built on CUDA unless
    ``device`` names another device."""

    def __init__(
        self,
        num_tokens: int,
        dim: int,
        depth: int,
        causal: bool = False,
        heads: int = 8,
        dim_head: int = 64,
        kv_heads: int | None = None,
        bucket_size: int = 512,
        rotary: bool = True,
        softclamp_value: float | None = None,
        max_lookback_seq_len: int | tuple[int | None, ...] | None = None,
        ff_mult: int = 4,
        ignore_index: int = -1,
        impl: str | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        *,
        mesh=None,
        striped: bool = False,
        sequence_parallel: str = "ring",
        mask=None,
        quantize_cache: bool = False,
        compute_dtype: str | None = None,
        auto_shard: bool = True,
        use_ring: bool = True,
        force_regular_attn: bool = False,
        use_pallas: bool | None = None,
        pallas_head_chunks: int | None = None,
        windowed_cache: bool = False,
        ff_chunk_size: int | None = None,
        loss_chunk_size: int | None = None,
        remat: bool = False,
        remat_policy: str | tuple[str | None, ...] | None = None,
        ring_bidirectional: bool = False,
        ring_counter_rotate: bool = False,
        ring_hop_compression: str | None = None,
        ring_dkv_dtype: str | None = None,
    ):
        super().__init__()
        # validated up front, as the JAX setup does: 0 would quietly disable
        # chunking and a negative size would break the padding
        if loss_chunk_size is not None and loss_chunk_size <= 0:
            raise ValueError(
                f"RingTransformer: loss_chunk_size must be None or a positive int, got "
                f"{loss_chunk_size!r} (None disables chunking; 0 would silently disable "
                f"it, a negative value breaks padding)"
            )
        if ff_chunk_size is not None and ff_chunk_size <= 0:
            raise ValueError(
                f"RingTransformer: ff_chunk_size must be None or a positive int, got "
                f"{ff_chunk_size!r} (None disables the blockwise feedforward; any "
                f"positive size works — shard lengths that don't divide are padded)"
            )
        remat_policies = layer_policies(remat_policy, depth)
        check_hop_compression("RingTransformer", ring_hop_compression)
        impl = resolve_impl(impl, use_pallas)
        check_impl("RingTransformer", impl)
        check_mesh("RingTransformer", mesh, sequence_parallel,
                   use_ring and not force_regular_attn, compute_dtype)
        check_constructor("RingTransformer", pallas_head_chunks, mesh,
                          use_ring and not force_regular_attn)
        check_compute_dtype("RingTransformer", compute_dtype, impl, force_regular_attn)
        lookbacks = max_lookback_seq_len
        if not isinstance(lookbacks, tuple):
            lookbacks = (lookbacks,) * depth
        if len(lookbacks) != depth:
            raise ValueError(
                f"RingTransformer: max_lookback_seq_len tuple has "
                f"{len(lookbacks)} entries for depth {depth}"
            )
        masks = mask if isinstance(mask, tuple) else (mask,) * depth
        if len(masks) != depth:
            raise ValueError(
                f"RingTransformer: mask tuple has {len(masks)} entries for depth "
                f"{depth} (one mask per layer, or a single mask for all layers)"
            )
        forms = [mask_form("RingTransformer", m, causal, lb)
                 for m, lb in zip(masks, lookbacks)]
        check_zigzag("RingTransformer", sequence_parallel,
                     all(causal if f is None else f.causal for f in forms),
                     tuple(lb if f is None else f.window for f, lb in zip(forms, lookbacks)))
        device = resolve_device(device)
        self.kv_heads = kv_heads or heads
        self.dim_head = dim_head
        self.ignore_index = ignore_index
        self.dtype = dtype
        self.mesh = mesh
        self.quantize_cache = quantize_cache
        self.windowed_cache = windowed_cache
        self.lookbacks = lookbacks
        self.loss_chunk_size = loss_chunk_size
        self.remat = remat
        self.remat_policies = remat_policies
        self.auto_shard = auto_shard
        self.ring_world = seq_world(mesh) if use_ring and not force_regular_attn else 1
        self.striped = striped and self.ring_world > 1
        self.sequence_parallel = sequence_parallel
        self.embed = Embed(num_tokens, dim, dtype=dtype, device=device)
        self.attn_layers = nn.ModuleList(
            RingAttention(
                dim, heads=heads, dim_head=dim_head, kv_heads=kv_heads,
                causal=causal, bucket_size=bucket_size, rotary=rotary,
                softclamp_value=softclamp_value, max_lookback_seq_len=lookback,
                impl=impl, dtype=dtype, device=device, mesh=mesh,
                striped=self.striped, sequence_parallel=sequence_parallel,
                auto_shard=False,  # sharded once at the top
                mask=layer_mask, quantize_cache=quantize_cache,
                compute_dtype=compute_dtype, use_ring=use_ring,
                force_regular_attn=force_regular_attn,
                ring_hop_compression=ring_hop_compression,
                ring_bidirectional=ring_bidirectional,
                ring_counter_rotate=ring_counter_rotate, ring_dkv_dtype=ring_dkv_dtype,
            )
            for lookback, layer_mask in zip(lookbacks, masks)
        )
        # the shards this process's sequence holds: every rank's on a
        # virtual ring, its own on a process
        shards = len(mesh.seq_ranks) if self.ring_world > 1 else 1
        self.ff_layers = nn.ModuleList(
            FeedForward(dim, ff_mult, dtype=dtype, device=device,
                        chunk_size=ff_chunk_size, seq_shards=shards)
            for _ in range(depth)
        )
        self.final_norm = RMSNorm(dim, device=device)
        self.to_logits = Dense(dim, num_tokens, dtype=dtype, device=device)

    def _device(self) -> torch.device:
        return self.embed.weight.device

    def _eff_causal(self) -> bool:
        """Whether every layer's attention is causal (``causal=True`` or a
        mask whose kernel form is causal): the property the pad-mask
        synthesis relies on (JAX ``RingTransformer._eff_causal``)."""
        return all(layer.causal for layer in self.attn_layers)

    @property
    def _sharded(self) -> bool:
        """Whether this process holds a shard of the batch: a mesh whose
        ranks are processes."""
        return self.mesh is not None and self.mesh.spans_processes

    def _ring_splits(self) -> bool:
        """Whether the ring's ranks are processes (a process holds one
        block of the sequence)."""
        return self.ring_world > 1 and self.mesh.seq_splits

    @property
    def _ulysses_size(self) -> int:
        return self.mesh.ulysses if self.ring_world > 1 and self.mesh.factored else 1

    def forward(
        self,
        tokens: torch.Tensor,
        mask: torch.Tensor | None = None,
        return_loss: bool = False,
        example_mask: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``tokens: (b, n)`` integer ids -> logits ``(b, n, num_tokens)``,
        or with ``return_loss`` the mean next-token cross-entropy over labels
        that are not ``ignore_index`` (rows with ``example_mask`` False drop
        out).

        ``segment_ids: (b, n)`` integer document ids pack several documents
        into one row: every attention layer masks cross-document attention,
        and the loss drops each label that starts a new document (it would
        be predicted from the previous one).

        On a mesh whose ranks are processes every argument is the global
        one, the same on every process, and so are the logits and the loss
        value returned (see the module docstring)."""
        check_tokens_input("RingTransformer", tokens)
        tokens = tokens.to(self._device())
        if mask is not None:
            mask = mask.to(self._device())
        if segment_ids is not None:
            segment_ids = torch.as_tensor(segment_ids, device=self._device())
        segment_same = None
        if return_loss:
            labels = tokens[:, 1:]
            tokens = tokens[:, :-1]
            if segment_ids is not None:
                # label i is token i + 1: valid only within one document
                segment_same = segment_ids[:, 1:] == segment_ids[:, :-1]
                segment_ids = segment_ids[:, :-1]
        world = self.ring_world
        n_orig = tokens.shape[1]
        scheme, factor = layout_for(self.sequence_parallel, self.striped, world,
                                    self._ulysses_size)
        pad_mult = 2 * world if scheme == "zigzag" else world
        shard = world > 1 and self.auto_shard
        if shard:
            tokens, _ = pad_to_multiple(tokens, pad_mult)
            if tokens.shape[1] != n_orig and mask is None and not self._eff_causal():
                # real tokens must not attend to the pad slots; causal needs
                # no mask (the pad sits after every real query)
                mask = torch.arange(tokens.shape[1], device=tokens.device) < n_orig
                mask = mask[None, :].expand(tokens.shape[0], -1)
            tokens = layout_permute(tokens, scheme, factor)
            if mask is not None:
                mask, _ = pad_to_multiple(mask, pad_mult, value=False)
                mask = layout_permute(mask, scheme, factor)
            if segment_ids is not None:
                # pad slots are a document of their own, attending nothing real
                segment_ids, _ = pad_to_multiple(segment_ids, pad_mult,
                                                 value=PAD_SEGMENT_ID)
                segment_ids = layout_permute(segment_ids, scheme, factor)
        if self._sharded and self.auto_shard:
            tokens, mask, segment_ids = (None if t is None else shard_cut(t, self.mesh)
                                         for t in (tokens, mask, segment_ids))
        x = self.embed(tokens)
        for i, (attn, ff) in enumerate(zip(self.attn_layers, self.ff_layers)):
            x = self._remat(i, attn, x, mask, segment_ids) + x
            # a blockwise FeedForward checkpoints each chunk itself
            x = (ff(x) if ff.chunk_for(x.shape[1]) else self._remat(i, ff, x)) + x
        x = self.final_norm(x)
        if not (return_loss and self.loss_chunk_size):
            logits = self.to_logits(x)
        if not return_loss:
            if shard or (self._sharded and self.auto_shard):
                logits = shard_gather(logits, self.mesh, scheme, factor)[:, :n_orig]
            return logits
        valid = labels != self.ignore_index
        if example_mask is not None:
            valid = valid & example_mask.to(valid.device)[:, None]
        if segment_same is not None:
            valid = valid & segment_same
        # the nll of the positions this process holds, the labels laid out
        # and cut as the tokens were: the logits are never un-permuted
        if shard:
            labels, valid = (layout_permute(pad_to_multiple(t, pad_mult)[0], scheme, factor)
                             for t in (labels, valid))
        if self.auto_shard:
            labels, valid = shard_cut(labels, self.mesh), shard_cut(valid, self.mesh)
        if self.loss_chunk_size:
            nll = self._chunked_nll(x, labels, valid)
        else:
            nll = _position_nll(logits, labels, valid).sum()
        if not self._sharded:
            return nll / valid.sum().clamp(min=1)
        count, total = mesh_all_reduce(self.mesh, [valid.sum(), nll.detach()])
        count = count.clamp(min=1)
        return _MeshLoss.apply(nll / count, total / count)

    def _remat(self, i: int, layer, *args):
        """Layer ``i``'s ``layer(*args)``, a checkpointed region of its own
        under the layer's policy with ``remat`` (JAX ``nn.remat(RingAttention,
        policy=)`` and ``nn.remat(FeedForward, policy=)``)."""
        if not self.remat:
            return layer(*args)
        return remat_call(self.remat_policies[i], layer, *args)

    def _chunk_nll(self, x, labels, valid) -> torch.Tensor:
        return _position_nll(self.to_logits(x), labels, valid).sum()

    def _chunked_nll(self, x, labels, valid) -> torch.Tensor:
        """The f32 sum of the nll over ``x``'s positions (the final-norm
        features ``(b, n, dim)`` this process holds, in the layout the labels
        were cut to), projected and scored one chunk of ``loss_chunk_size``
        positions at a time under a checkpoint of its own (JAX
        ``_chunked_ce``): no more than one chunk's ``(b, chunk, vocab)``
        logits exist, in the forward or the backward.  The chunk is clamped
        to ``n``; padded positions are invalid."""
        n = x.shape[1]
        c = min(self.loss_chunk_size, n)
        x, _ = pad_to_multiple(x, c)
        labels, _ = pad_to_multiple(labels, c)
        valid, _ = pad_to_multiple(valid, c, value=False)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[1], c):
            total = total + remat_call(None, self._chunk_nll, x[:, i:i + c],
                                       labels[:, i:i + c], valid[:, i:i + c])
        return total

    # ------------------------------------------------------------------
    # Incremental decoding
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict[str, list]:
        """Zeroed KV cache ``{"k": [...], "v": [...]}``, one
        ``(batch, kv_heads, max_len, dim_head)`` entry per layer, in the
        model dtype (float32 when it is None); with ``quantize_cache`` each
        entry is an ``(int8 values, f32 scales (batch, kv_heads, max_len))``
        tuple.  On a mesh the cache is sharded contiguously over the ring
        and ``max_len`` must divide over it: each layer's entry is a list of
        one such entry per rank this process holds (every rank on a virtual
        ring, one on a process), rank ``r``'s of ``max_len / W`` slots
        holding positions ``[r * max_len / W, (r + 1) * max_len / W)``, and
        ``batch`` is the global batch, of which a process holds its data
        rows."""
        world = self.ring_world
        if world > 1:
            check_factored_decode("init_cache", self.mesh)
        if max_len % world:
            raise ValueError(
                f"init_cache: max_len {max_len} must divide over the ring of "
                f"{world} (the cache is sharded contiguously)"
            )
        if self.windowed_cache and world > 1:
            raise ValueError(
                "init_cache: windowed_cache is a local-decode optimization; the "
                "ring-sharded cache uses absolute positions"
            )
        if self._sharded:
            if batch % self.mesh.data:
                raise ValueError(
                    f"init_cache: batch {batch} does not divide over {self.mesh.data} data rows"
                )
            batch //= self.mesh.data
        dtype = self.dtype or torch.float32
        device = self._device()

        def entry(size):
            shape = (batch, self.kv_heads, size, self.dim_head)
            if self.quantize_cache:
                return (torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape[:3], dtype=torch.float32, device=device))
            return torch.zeros(shape, dtype=dtype, device=device)

        def layer(lookback):
            if world > 1:
                return [entry(max_len // world) for _ in self.mesh.ring.ranks]
            if self.windowed_cache and lookback is not None:
                return entry(min(max_len, lookback))
            return entry(max_len)

        return {"k": [layer(lb) for lb in self.lookbacks],
                "v": [layer(lb) for lb in self.lookbacks]}

    def decode_step(
        self,
        token: torch.Tensor,  # (b,) token at position `pos`
        cache: dict[str, list],
        pos: int,
    ) -> tuple[torch.Tensor, dict[str, list]]:
        """Next-token logits ``(b, vocab)`` given the token at ``pos`` and a
        cache holding positions ``[0, pos)``; the cache is updated in place
        and returned.  On a mesh of processes ``token`` and the logits are
        global, the cache this process's."""
        token = cut_rows(token.to(self._device()), self.mesh)
        return gather_rows(self._decode(token, cache, pos), self.mesh), cache

    def _decode(self, token, cache, pos: int) -> torch.Tensor:
        """:meth:`decode_step` on this process's rows."""
        x = self.embed(token[:, None])
        for i, (attn, ff) in enumerate(zip(self.attn_layers, self.ff_layers)):
            a, _, _ = attn.decode_step(x, cache["k"][i], cache["v"][i], pos)
            x = a + x
            x = ff(x) + x
        return self.to_logits(self.final_norm(x))[:, 0]

    def prefill(
        self,
        tokens: torch.Tensor,  # (b, n)
        cache: dict[str, list],
    ) -> tuple[torch.Tensor, dict[str, list]]:
        """One causal pass over the prompt, filling cache positions
        ``[0, n)`` in place.  Returns ``(last_logits (b, vocab), cache)``;
        on a mesh of processes ``tokens`` and the logits are global."""
        tokens = cut_rows(tokens.to(self._device()), self.mesh)
        return gather_rows(self._prefill(tokens, cache), self.mesh), cache

    def _prefill(self, tokens, cache) -> torch.Tensor:
        """:meth:`prefill` on this process's rows.  Where the ring's ranks
        are processes, this rank's block of the prompt (padded to the ring)
        goes through the layers, and the last logits come from the rank
        whose block holds position ``n - 1``."""
        n = tokens.shape[1]
        if self.ring_world > 1:
            check_factored_decode("prefill", self.mesh)
        split = self._ring_splits()
        if split:
            ring = self.mesh.ring
            p = -(-n // ring.world)
            tokens = pad_to_multiple(tokens, ring.world)[0][:, ring.rank * p:(ring.rank + 1) * p]
        x = self.embed(tokens)
        for i, (attn, ff) in enumerate(zip(self.attn_layers, self.ff_layers)):
            if split:
                a = attn._mesh_prefill(x, cache["k"][i], cache["v"][i], n)
            else:
                a, _, _ = attn.prefill(x, cache["k"][i], cache["v"][i])
            x = a + x
            x = ff(x) + x
        if not split:
            return self.to_logits(self.final_norm(x))[:, -1]
        owner, row = divmod(n - 1, p)
        last = self.to_logits(self.final_norm(x[:, row]))
        (every,) = ring.all_gather([(last[None],)], dim=0)[0]
        return every[owner]

    def _from_rank0(self, tok: torch.Tensor) -> torch.Tensor:
        """Rank 0's tokens on every rank of a ring of processes (greedy or
        sampled, every rank then decodes the same token)."""
        if not self._ring_splits():
            return tok
        (every,) = self.mesh.ring.all_gather([(tok[None],)], dim=0)[0]
        return every[0]

    @torch.inference_mode()
    def generate(
        self,
        prompt: torch.Tensor,  # (b, n)
        max_len: int,
        num_steps: int,
        *,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """One prefill pass over the prompt, then ``num_steps - 1`` decode
        steps.  Returns the ``(b, num_steps)`` new tokens.

        ``temperature == 0.0`` (default) is greedy argmax; otherwise
        categorical sampling at that temperature, truncated to the ``top_k``
        most probable tokens and/or the ``top_p`` nucleus, drawn from
        ``generator`` (which must then be given, on the model's device).
        On a mesh of processes each data row decodes its own requests, every
        rank of its ring the token of the ring's rank 0, and the rows'
        tokens are gathered over the data ring."""
        b, n = prompt.shape
        if n < 1 or num_steps < 1:
            raise ValueError("generate: needs a non-empty prompt and num_steps >= 1")
        if n + num_steps - 1 > max_len:
            raise ValueError(
                f"generate: cache of {max_len} too small for a prompt of {n} "
                f"and {num_steps} steps"
            )
        if temperature > 0.0 and generator is None:
            raise ValueError("generate: temperature > 0 needs a torch.Generator")
        if temperature <= 0.0 and (top_k is not None or top_p is not None):
            raise ValueError(
                "generate: top_k/top_p need temperature > 0 (greedy mode "
                "would silently ignore them)"
            )
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"generate: top_p must be in (0, 1], got {top_p}")

        cache = self.init_cache(b, max_len)
        logits = self._prefill(cut_rows(prompt.to(self._device()), self.mesh), cache)
        tok = self._from_rank0(_sample(logits, temperature, top_k, top_p, generator))
        out = [tok]
        for pos in range(n, n + num_steps - 1):
            logits = self._decode(tok, cache, pos)
            tok = self._from_rank0(_sample(logits, temperature, top_k, top_p, generator))
            out.append(tok)
        return gather_rows(torch.stack(out, dim=1), self.mesh)
