"""Hygiene of the torch port: it stands alone and never quietly falls back.

- An AST scan of every module of ``ring_attention_tpu_torch`` (the mask
  algebra, ``masks.py``, among them: numpy and the standard library only
  at module level) and of ``chip_smoke.py`` finds no import of ``jax``,
  ``flax`` or ``ring_attention_tpu``.  (A ``sys.modules`` check could not tell: the
  test process imports JAX for the parity tests.)
- Building a model with the default device raises when there is no CUDA
  device, instead of carrying on on the CPU.
- Every feature the port leaves out (model settings and
  ``make_train_step`` options) raises ``NotImplementedError`` naming the
  ROADMAP item that brings it; decoding on a mesh raises a one-line
  ``ValueError`` for an input it cannot take, and ``shard_opt_state``
  without a mesh JAX's ``ValueError``.
"""

import ast
from pathlib import Path

import pytest
import torch

import ring_attention_tpu_torch
from ring_attention_tpu_torch import RingAttention, RingTransformer, make_train_step
from ring_attention_tpu_torch.masks import Causal, DocumentMask
from ring_attention_tpu_torch.parallel import VirtualRing, create_mesh, ring_flash_attention

REPO = Path(__file__).resolve().parents[1]
PORT = Path(ring_attention_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ring_attention_tpu")
SMALL = dict(num_tokens=16, dim=32, depth=1, heads=2, dim_head=16, causal=True)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_masks_module_is_numpy_only():
    """The mask algebra imports numpy and the standard library only, at
    module level as anywhere (its certificate reaches the kernel wrappers'
    tables (``doc_tile_ranges``) inside a function)."""
    path = PORT / "masks.py"
    assert path in _port_sources()
    tree = ast.parse(path.read_text())
    top = {alias.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for alias in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert top <= {"__future__", "bisect", "dataclasses", "re", "numpy"}, top


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RingTransformer(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RingAttention(32, heads=2, dim_head=16)
    assert RingTransformer(**SMALL, device="cpu").embed.weight.device.type == "cpu"


# test ids must be the same in every pytest-xdist worker: plain strings,
# never an object's repr (which carries its address)
# The ring variants (item 7e) are ported: each case now pins what its
# settings still cannot take, a JAX ValueError or impl="auto" (item 7f).
# name: (settings, the error they raise, its message)
UNPORTED_SETTINGS = {
    "ring_bidirectional": (dict(ring_bidirectional=True, impl="auto"), NotImplementedError,
                           "ROADMAP.md Port queue item 7f"),
    "ring_counter_rotate": (dict(ring_counter_rotate=True, impl="auto"), NotImplementedError,
                            "ROADMAP.md Port queue item 7f"),
    # the int8 wire on the counter-rotated ring is ported; a wire other than
    # None and "int8" is JAX's ValueError
    "ring_hop_compression": (dict(ring_hop_compression="fp8", ring_counter_rotate=True),
                             ValueError, "ring_hop_compression='fp8'"),
    "ring_dkv_dtype": (dict(ring_dkv_dtype="bfloat16", impl="auto"), NotImplementedError,
                       "ROADMAP.md Port queue item 7f"),
    # the ring variants pass to the hybrid strategy's outer ring; each
    # strategy still refuses the other kind of mesh, with JAX's words
    "sequence_parallel_zigzag": (dict(sequence_parallel="zigzag", ring_bidirectional=True,
                                      mesh=create_mesh(ring_size=2, ulysses_size=2)),
                                 ValueError, r"runs on a plain \(data, seq\) mesh"),
    "sequence_parallel_hybrid": (dict(sequence_parallel="hybrid", ring_dkv_dtype="bfloat16",
                                      mesh=create_mesh(ring_size=2)),
                                 ValueError, "needs a factored mesh"),
    # the mask algebra and declared packings are ported, also on the int8
    # sweep and the hybrid strategy; impl="auto" is not (item 7f)
    "mask": (dict(causal=False, mask=Causal() & DocumentMask((0, 8)), compute_dtype="int8",
                  sequence_parallel="hybrid", mesh=create_mesh(ring_size=2, ulysses_size=2),
                  impl="auto"), NotImplementedError, "ROADMAP.md Port queue item 7f"),
    # the fused int8 ring takes bidirectional (it warns and drops it, as
    # JAX does); int8 compute off the kernels is JAX's ValueError
    "impl_fused": (dict(impl="fused", compute_dtype="int8", ring_hop_compression="int8",
                        mesh=create_mesh(ring_size=2), ring_bidirectional=True,
                        force_regular_attn=True), ValueError, "compute_dtype"),
    "impl_auto": (dict(impl="auto"), NotImplementedError, "ROADMAP.md Port queue item 7f"),
}


@pytest.mark.parametrize("name", list(UNPORTED_SETTINGS))
def test_unported_features_raise(name):
    settings, error, message = UNPORTED_SETTINGS[name]
    with pytest.raises(error, match=message):
        RingTransformer(**{**SMALL, "device": "cpu", **settings})


# the int8 knobs are ported; the settings they cannot take raise as the JAX
# layer's _compute_dtype does
INVALID_INT8_SETTINGS = {
    "compute_dtype_int8_on_impl_torch": dict(compute_dtype="int8", impl="torch"),
    "compute_dtype_fp8": dict(compute_dtype="fp8"),
}


@pytest.mark.parametrize("name", list(INVALID_INT8_SETTINGS))
def test_invalid_int8_settings_raise(name):
    with pytest.raises(ValueError, match="compute_dtype"):
        RingTransformer(**SMALL, device="cpu", **INVALID_INT8_SETTINGS[name])
    with pytest.raises(ValueError, match="compute_dtype"):
        RingAttention(32, heads=2, dim_head=16, device="cpu", **INVALID_INT8_SETTINGS[name])


# decoding on a mesh is ported (a ring-sharded cache, tree-attention merge);
# each entry raises a one-line error for an input it cannot take; the
# windowed cache is a local-decode optimization, refused on a ring as the
# JAX model refuses it
DECODE_ON_A_MESH_ERRORS = {
    "init_cache": (ValueError, "init_cache: max_len 9 must divide over the ring"),
    "prefill": (ValueError, r"prefill: prompt \(8\) longer than the ring-sharded cache"),
    "decode_step": (ValueError, "decode_step: position 8 is past the ring-sharded cache"),
    "generate": (ValueError, "generate: cache of 8 too small"),
    "windowed_cache": (ValueError, "windowed_cache is a local-decode optimization; the "
                       "ring-sharded cache uses absolute positions"),
}


@pytest.mark.parametrize("entry", list(DECODE_ON_A_MESH_ERRORS))
def test_decode_on_a_mesh_raises(entry):
    mesh = create_mesh(ring_size=2)
    model = RingTransformer(**SMALL, device="cpu", mesh=mesh)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    calls = {
        "init_cache": lambda: model.init_cache(1, 9),
        "prefill": lambda: model.prefill(tokens, model.init_cache(1, 4)),
        "decode_step": lambda: model.decode_step(tokens[:, 0], model.init_cache(1, 8), 8),
        "generate": lambda: model.generate(tokens, max_len=8, num_steps=2),
        "windowed_cache": lambda: RingTransformer(**SMALL, device="cpu", mesh=mesh,
                                                  windowed_cache=True).init_cache(1, 8),
    }
    error, message = DECODE_ON_A_MESH_ERRORS[entry]
    with pytest.raises(error, match=message):
        calls[entry]()


def test_segment_ids_raise():
    """Packed sequences are ported on the local path, the scan-path ring
    and the fused ring (its ids, K3b: the same logits as the scan ring),
    on the int8 sweep (K3c) and the int8 ring (the fused int8 ring's
    logits are the scan int8 ring's), and on the counter-rotated int8 ring
    (item 7e: the same logits again); what still raises with them is the
    counter-rotated schedule on the fused kernels, which has no fused form
    (JAX's ValueError)."""
    tokens = torch.zeros((1, 8), dtype=torch.long)
    fused = RingTransformer(**SMALL, device="cpu", impl="fused",
                            mesh=create_mesh(ring_size=2))
    scan = RingTransformer(**SMALL, device="cpu", impl="cuda", mesh=create_mesh(ring_size=2))
    scan.load_state_dict(fused.state_dict())
    with torch.no_grad():
        assert torch.equal(fused(tokens, segment_ids=tokens), scan(tokens, segment_ids=tokens))
    int8 = {impl: RingTransformer(**SMALL, device="cpu", impl=impl, compute_dtype="int8",
                                  ring_hop_compression="int8", mesh=create_mesh(ring_size=2))
            for impl in ("cuda", "fused")}
    int8["cuda"].load_state_dict(fused.state_dict())
    int8["fused"].load_state_dict(fused.state_dict())
    with torch.no_grad():
        assert torch.equal(int8["fused"](tokens, segment_ids=tokens),
                           int8["cuda"](tokens, segment_ids=tokens))
    counter = RingTransformer(**SMALL, device="cpu", compute_dtype="int8",
                              mesh=create_mesh(ring_size=2), ring_hop_compression="int8",
                              ring_counter_rotate=True)
    counter.load_state_dict(fused.state_dict())
    with torch.no_grad():
        assert torch.equal(counter(tokens, segment_ids=tokens),
                           int8["cuda"](tokens, segment_ids=tokens))
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="counter-rotation schedule has no fused form"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), impl="fused", counter_rotate=True,
                             segment_ids=torch.zeros((1, 8), dtype=torch.int32))


def test_unknown_impl_is_a_value_error():
    with pytest.raises(ValueError, match="impl must be one of"):
        RingTransformer(**SMALL, device="cpu", impl="pallas")


UNPORTED_STEP_OPTIONS = ("collect_metrics", "shard_opt_state", "jit_donate")


@pytest.mark.parametrize("name", UNPORTED_STEP_OPTIONS)
def test_unported_train_step_options_raise(name):
    """``collect_metrics`` and ``jit_donate`` are not ported (item 7f);
    ``shard_opt_state`` (ZeRO-1) is, and without a mesh raises JAX's
    ``ValueError``."""
    model = RingTransformer(**SMALL, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if name == "shard_opt_state":
        with pytest.raises(ValueError, match=r"shard_opt_state=True needs mesh= \(the "
                                             "mesh whose data axis the optimizer state shards"):
            make_train_step(lambda t: model(t, return_loss=True), opt, shard_opt_state=True)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Port queue item 7f"):
        make_train_step(lambda t: model(t, return_loss=True), opt, **{name: True})


def test_shard_opt_state_takes_only_the_step_mesh():
    """ZeRO-1 shards over the data ring of ``mesh=``, the mesh the step sums
    the gradients over.  JAX's separate ``shard_mesh=`` is refused: alone,
    it would shard the state over a data ring whose gradients were never
    summed."""
    model = RingTransformer(**SMALL, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(TypeError, match="shard_mesh"):
        make_train_step(lambda t: model(t, return_loss=True), opt, shard_opt_state=True,
                        shard_mesh=create_mesh(ring_size=2))
