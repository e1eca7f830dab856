"""Port ADM UNet vs the JAX package's ``AdmUnet2d`` (f32 on both sides).

- The port's state-dict names are the reference's: ``torch_state_dict_to_flax``
  (the JAX package's converter of reference checkpoints) maps
  ``port.state_dict()`` onto the flax tree, and the port's ``convert`` maps it
  back bit for bit.
- A forward with every parameter drawn from a numpy seed (a fresh init
  outputs exactly zero) matches ``build_adm_unet(..., dtype=float32)`` within
  1e-4 relative L2 and 1e-4 of the output scale per element (f32 accumulation
  order across a few dozen layers), including the 10-channel conditional input
  and class labels with the null class -1.
"""

import collections
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.models.convert import flax_to_state_dict
from ivid_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

SMALL = dict(
    image_size=16, in_channels=10, out_channels=4, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=5,
    has_null_class=True, dropout=0.0, use_fp16=False,
)
# 32² with attention at 32 (T=1024, 64-wide heads) takes the packed-kernel
# branch of the attention dispatch; the 16² level takes the plain form.
PACKED = dict(
    image_size=32, in_channels=4, out_channels=4, model_channels=64,
    num_res_blocks=1, channel_mult=[1, 1], attention_resolutions=[32, 16],
    num_groups=32, num_heads=None, num_head_channels=64, num_classes=None,
    has_null_class=False, dropout=0.0, use_fp16=True,
)
ARCH_KEYS = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
             "attention_resolutions", "num_classes"]


def _jax_params(cfg, seed):
    """The flax tree of ``cfg`` with every leaf drawn from a numpy seed."""
    model = jax_build(cfg, dtype=jnp.float32)
    s, c = cfg["image_size"], cfg["in_channels"]
    cl = jnp.zeros((1,), jnp.int32) if cfg["num_classes"] else None
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, c)), jnp.zeros((1,), jnp.int32), cl
    )["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return 1.0 + 0.1 * z
        if leaf.ndim >= 2:
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.05 * z

    return model, jax.tree_util.tree_map_with_path(draw, tree)


def test_state_dict_round_trips_through_the_flax_converter():
    cfg = SMALL
    port = adm.build_adm_unet(cfg)
    adm.randomize_parameters(port, seed=3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flax_tree = torch_state_dict_to_flax(sd, **{k: cfg[k] for k in ARCH_KEYS})
    model, want = _jax_params(cfg, seed=0)
    assert (jax.tree_util.tree_structure(flax_tree)
            == jax.tree_util.tree_structure(want))
    shapes = jax.tree.map(lambda a, b: a.shape == b.shape, flax_tree, want)
    assert all(jax.tree.leaves(shapes))
    back = flax_to_state_dict(flax_tree, **{k: cfg[k] for k in ARCH_KEYS})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("cfg", [SMALL, PACKED], ids=["cond-classes", "packed-dispatch"])
def test_forward_matches_jax(cfg, monkeypatch):
    model, params = _jax_params(cfg, seed=1)
    port = adm.build_adm_unet(cfg, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(params, **{k: cfg[k] for k in ARCH_KEYS}))
    port.eval()

    rng = np.random.default_rng(2)
    s, c = cfg["image_size"], cfg["in_channels"]
    x = rng.standard_normal((3, s, s, c)).astype(np.float32)
    t = np.array([0, 37, 999])
    classes = np.array([2, -1, 4]) if cfg["num_classes"] else None

    calls = []
    real = tattn.packed_attention
    monkeypatch.setattr(tattn, "packed_attention",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   None if classes is None else torch.from_numpy(classes)).numpy()
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        None if classes is None else jnp.asarray(classes, jnp.int32),
    ))
    assert got.shape == want.shape == (3, s, s, 4)
    assert np.abs(want).mean() > 0.1  # every layer reaches the output
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # Attention dispatch: the kernel wrapper exactly at T >= 512 with 64-wide heads.
    assert calls == ([1024, 1024, 1024] if cfg is PACKED else [])


def test_fresh_model_dtypes():
    """bf16 torso: every parameter is an f32 master weight; the convolutions
    and attention projections compute in bf16, the embedding MLP and the
    output head in f32. A fresh model predicts exactly zero (the reference's
    zero-initialized output layers)."""
    port = adm.build_adm_unet(PACKED)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    seen = {}

    def hook(name):
        return lambda module, args, out: seen.__setitem__(name, out.dtype)

    port.input_blocks[1][0].in_layers[2].register_forward_hook(hook("conv"))
    port.input_blocks[1][0].skip_connection.register_forward_hook(hook("skip"))
    port.input_blocks[1][1].norm.register_forward_hook(hook("attn_norm"))
    port.time_embed[1].register_forward_hook(hook("embed"))
    port.out[2].register_forward_hook(hook("head"))
    x = torch.randn(1, 32, 32, 4)
    with torch.no_grad():
        y = port(x, torch.tensor([5]))
    assert seen == {"conv": torch.bfloat16, "skip": torch.bfloat16, "attn_norm": torch.bfloat16,
                    "embed": torch.float32, "head": torch.float32}
    assert y.dtype == torch.float32 and torch.equal(y, torch.zeros_like(y))


# The graphed inference path (``AdmUnet2d.graphable``, ``InferenceGraphs``).
# A CUDA graph cannot run here: the rule, the key, the bound, the cache's
# invalidation and the launch counts of a capture are checked on the CPU with
# a stand-in for a CUDA input and for the capture; the replay itself is
# checked on the card (chip_smoke.py ``[unet graph]``).

class _CudaInput:
    """What ``graphable`` reads of a CUDA input."""

    device = torch.device("cuda")


class _FakeGraph:
    def __init__(self, key):
        self.key, self.replays = key, 0

    def replay(self, *args):
        self.replays += 1
        return ("replay", self.key)


def _tp_layer(model):
    """``model`` with one convolution replaced by tensor parallelism's
    column-parallel layer (whose forward, without a group, is the same)."""
    from ivid_tpu_torch.parallel import tensor as tp

    conv = model.input_blocks[1][0].in_layers[2]
    col = tp.ColumnConv2d(conv.in_channels, conv.out_channels, 3, padding=1)
    col.load_state_dict(conv.state_dict())
    model.input_blocks[1][0].in_layers[2] = col
    return model


@pytest.mark.parametrize("tp_sharded", [False, True], ids=["replicated", "tp"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "dropout"])
@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_graphable_rule(device, grad, train_mode, deterministic, tp_sharded):
    model = adm.build_adm_unet(SMALL).train(train_mode)
    if tp_sharded:
        _tp_layer(model)
    x = _CudaInput() if device == "cuda" else torch.zeros(1, 16, 16, 10)
    with torch.set_grad_enabled(grad):
        got = model.graphable(x, deterministic)
    assert got == (device == "cuda" and not grad and not train_mode and deterministic
                   and not tp_sharded)


@pytest.mark.parametrize("observer", ["layer_hook", "layer_pre_hook", "global_hook",
                                      "dispatch_mode"])
def test_graphable_refuses_what_a_replay_would_bypass(observer):
    """Hooks on the layers, global module hooks and dispatch modes see each
    operation of an eager forward and nothing of a replay: such calls run
    eagerly. Once the hook is gone and the graphs are dropped, a call is
    graphable again."""
    from torch.utils.flop_counter import FlopCounterMode

    model = adm.build_adm_unet(SMALL).eval()
    x = _CudaInput()
    with torch.no_grad():
        assert model.graphable(x)
        block = model.input_blocks[1][0]
        if observer == "dispatch_mode":
            with FlopCounterMode(display=False):
                assert not model.graphable(x)
            assert model.graphable(x)
            return
        handle = {
            "layer_hook": lambda: block.register_forward_hook(lambda *a: None),
            "layer_pre_hook": lambda: block.register_forward_pre_hook(lambda *a: None),
            "global_hook": lambda: torch.nn.modules.module.register_module_forward_hook(
                lambda *a: None),
        }[observer]()
        try:
            assert not model.graphable(x)
        finally:
            handle.remove()
        model.graphs.clear()
        assert model.graphable(x)


def test_shard_unet_drops_graphs_and_its_layers_stay_eager():
    import types

    from ivid_tpu_torch.parallel import tensor as tp

    model = adm.build_adm_unet(SMALL).eval()
    with torch.no_grad():
        assert model.graphable(_CudaInput())
        model.graphs.entries["k"] = _FakeGraph("k")
        groups = types.SimpleNamespace(model_size=2, model_rank=0, model=None)
        assert tp.shard_unet(model, groups)
        assert model.graphs.entries == {}
        assert not model.graphable(_CudaInput())


def _key_inputs(change):
    x = torch.zeros(2, 16, 16, 10)
    t = torch.zeros(2, dtype=torch.long)
    classes = torch.zeros(2, dtype=torch.long)
    if change == "batch":
        x, t, classes = x[:1], t[:1], classes[:1]
    elif change == "dtype":
        x = x.double()
    elif change == "t_batch":
        t = t[:1]
    elif change == "no_classes":
        classes = None
    elif change == "values":
        x, t, classes = x + 1, t + 5, classes + 3
    return x, t, classes


@pytest.mark.parametrize("change", ["batch", "dtype", "t_batch", "no_classes", "conv_tf32",
                                    "matmul_tf32", "values"])
def test_graph_key(change, monkeypatch):
    """A graph's key: the input's shape and type, the timesteps' shape,
    labels given or not, and the TF32 settings a capture bakes in; not the
    values."""
    base = adm.InferenceGraphs.key(*_key_inputs(None))
    args = _key_inputs(change)
    if change == "conv_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                            not torch.backends.cudnn.allow_tf32)
    elif change == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    key = adm.InferenceGraphs.key(*args)
    monkeypatch.undo()
    assert (key == base) == (change == "values")
    assert adm.InferenceGraphs.key(*_key_inputs(None)) == base


def test_graph_cache_bound(monkeypatch):
    """Each new key captures once, up to the bound; later calls of a key
    replay; a new key past the bound returns None (the caller runs it
    eagerly) and captures nothing; ``clear`` forgets every graph."""
    cache = adm.InferenceGraphs(limit=2)
    captured = []

    def capture(forward, x, t, classes):
        key = cache.key(x, t, classes)
        captured.append(key)
        return forward(x, t, classes), _FakeGraph(key)

    monkeypatch.setattr(cache, "_capture", capture)
    forward = lambda x, t, classes: ("eager", x.shape[0])  # noqa: E731
    t = lambda b: torch.zeros(b, dtype=torch.long)  # noqa: E731
    assert cache.run(forward, torch.zeros(1, 4), t(1), None) == ("eager", 1)
    assert cache.run(forward, torch.zeros(2, 4), t(2), None) == ("eager", 2)
    assert len(captured) == 2 and len(cache.entries) == 2
    assert cache.run(forward, torch.zeros(3, 4), t(3), None) is None
    assert len(captured) == 2 and len(cache.entries) == 2
    got = cache.run(forward, torch.ones(1, 4), t(1), None)
    assert got == ("replay", captured[0]) and len(captured) == 2
    assert cache.entries[captured[0]].replays == 1
    cache.clear()
    assert cache.entries == {} and cache.pool is None and cache.stream is None
    assert cache.run(forward, torch.zeros(3, 4), t(3), None) == ("eager", 3)
    assert adm.MAX_GRAPHS >= 2 and adm.InferenceGraphs().limit == adm.MAX_GRAPHS


@pytest.mark.parametrize("change,dropped", [
    ("to", True), ("float", True), ("load_assign", True), ("load_in_place", False),
])
def test_graph_cache_invalidation(change, dropped):
    """What gives a parameter new storage drops the graphs; an in-place load
    keeps them (their replays read the new values)."""
    model = adm.build_adm_unet(SMALL).eval()
    model.graphs.entries["k"] = _FakeGraph("k")
    state = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    if change == "to":
        model.to(torch.float64)
    elif change == "float":
        model.float()
    elif change == "load_assign":
        model.load_state_dict(state, assign=True)
        assert all(v.data_ptr() == state[k].data_ptr() for k, v in model.state_dict().items())
    elif change == "load_in_place":
        ptrs = [p.data_ptr() for p in model.parameters()]
        model.load_state_dict(state)
        assert ptrs == [p.data_ptr() for p in model.parameters()]
    assert (model.graphs.entries == {}) == dropped


class _FakeCudaGraph:
    def replay(self):
        pass

    def pool(self):
        return "pool"


def test_capture_takes_back_what_it_counted_and_replays_add_it(monkeypatch):
    """A capture takes back every launch it counted, whatever the key, and
    each replay adds them again; a key whose count falls to 0 leaves the
    counter. The CUDA calls of the capture are stand-ins, and the stand-in
    forward counts only under the capture (K1, one of K1's widths and a new
    one, GN and a key of no kernel yet), so the warm-up adds nothing."""
    capturing = []

    @contextlib.contextmanager
    def graph(*args, **kwargs):
        capturing.append(True)
        yield
        capturing.pop()

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCudaGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    start = collections.Counter({"K1": 7, ("K1", 768): 7, "K1 f32": 2})
    monkeypatch.setattr(cuda_build, "launches", start.copy())

    def forward(x, t, classes):
        if capturing:
            cuda_build.launches.update(["K1", ("K1", 768), ("K1", 1536), ("K1", 1536), "GN",
                                        "K9"])
        return x + 1

    cache = adm.InferenceGraphs()
    x, t = torch.zeros(1, 4), torch.zeros(1, dtype=torch.long)
    assert torch.equal(cache.run(forward, x, t, None), x + 1)
    assert cuda_build.launches == start and set(cuda_build.launches) == set(start)
    for _ in range(2):
        cache.run(forward, x, t, None)
    assert dict(cuda_build.launches) == {"K1": 9, ("K1", 768): 9, "K1 f32": 2,
                                         ("K1", 1536): 4, "GN": 2, "K9": 2}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_cpu_forward_unchanged(grad, train_mode):
    """On the CPU every call is eager in every mode: the same output as the
    JAX package's, bit-equal across modes, and no graph kept."""
    cfg = SMALL
    model, params = _jax_params(cfg, seed=1)
    port = adm.build_adm_unet(cfg, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(params, **{k: cfg[k] for k in ARCH_KEYS}))
    port.train(train_mode)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 10)).astype(np.float32)
    t, classes = np.array([3, 500]), np.array([1, -1])
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(classes))
    with torch.set_grad_enabled(grad):
        got = port(*args).detach()
    with torch.no_grad():
        eager = port._forward(*args)
    assert torch.equal(got, eager)
    assert port.graphs.entries == {}
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                  jnp.asarray(classes, jnp.int32)))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
