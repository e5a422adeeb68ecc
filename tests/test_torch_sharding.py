"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's: the rules are pure functions of shapes and the mesh's
axis names and sizes, so both run on meshes that hold no devices (the JAX
package's ``tests/test_sharding.py`` fake meshes, the port's
``AbstractMesh``), and every spec must be the same, entry for entry: the
reference test's cases and more, the logical axes of every parameter of
the ten archs, and every parameter's spec at full size on the 16x16 and
2x16x16 production meshes (a layer's spec is the JAX stacked leaf's
without its leading ``"layers"`` entry, which no preference names)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.distributed import sharding as jshd  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402


def _fake_mesh(shape, axes):
    n = int(np.prod(shape))
    devs = np.array([jax.devices("cpu")[0]] * n, dtype=object).reshape(shape)
    return Mesh(devs, axes)


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
JMESH = {k: _fake_mesh(*v) for k, v in MESHES.items()}
PMESH = {k: shd.AbstractMesh(*v) for k, v in MESHES.items()}


def _spec(p) -> tuple:
    """A JAX ``PartitionSpec`` as the port's tuple, one entry a dim."""
    return tuple(p)


SPEC_CASES = [
    ((151_936, 4096), ("vocab", "embed")),
    ((4096, 32, 128), ("embed", "heads", "head_dim")),
    ((7168, 56, 128), ("embed", "heads", "head_dim")),
    ((4096, 8, 128), ("embed", "kv_heads", "head_dim")),
    ((160, 5120, 1536), ("expert", "embed", "ff")),
    ((40, 1536, 512), ("expert", "embed", "ff")),
    ((5120, 1536), ("embed", "q_lora")),
    ((2048, 2048), ("embed", "heads_flat")),
    ((4, 4096), (None, "ff")),
    ((4096,), ("embed",)),
    ((33,), ("ff",)),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape,logical", SPEC_CASES)
def test_spec_for_matches_jax(shape, logical, mesh):
    assert shd.spec_for(shape, logical, PMESH[mesh]) \
        == _spec(jshd.spec_for(shape, logical, JMESH[mesh]))


def test_spec_for_reference_cases():
    """``tests/test_sharding.py``'s expectations, on the port."""
    m = PMESH["16x16"]
    assert shd.spec_for((151_936, 4096), ("vocab", "embed"), m) \
        == ("model", "data")
    assert shd.spec_for((4096, 32, 128), ("embed", "heads", "head_dim"),
                        m) == ("data", "model", None)
    assert shd.spec_for((7168, 56, 128), ("embed", "heads", "head_dim"),
                        m) == ("data", None, "model")
    assert shd.spec_for((160, 5120, 1536), ("expert", "embed", "ff"), m) \
        == ("model", "data", None)


BATCH_CASES = [(256, 4096), (1, 524_288), (16, 4096), (32, 32_768),
               (128, 1), (8, 32), (3, 7), (256, 4096, 4096)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", BATCH_CASES)
@pytest.mark.parametrize("seq_axis", [1, None])
def test_batch_spec_matches_jax(shape, mesh, seq_axis):
    assert shd.batch_spec(shape, PMESH[mesh], seq_axis=seq_axis) \
        == _spec(jshd.batch_spec(shape, JMESH[mesh], seq_axis=seq_axis))


def test_batch_spec_reference_cases():
    assert shd.batch_spec((256, 4096), PMESH["16x16"]) == ("data", None)
    assert shd.batch_spec((256, 4096), PMESH["2x16x16"]) \
        == (("pod", "data"), None)
    assert shd.batch_spec((1, 524_288), PMESH["2x16x16"]) \
        == (None, ("pod", "data"))
    spec = shd.batch_spec((16, 4096), PMESH["2x16x16"])
    assert spec[0] == "data" and spec[1] == "pod"


CACHE_CASES = [
    ((128, 32_768, 8, 128), 128, 8),
    ((128, 32_768, 32, 128), 128, 32),
    ((1, 524_288, 16, 256), 1, 16),
    ((128, 32_768, 512), 128, 1),
    ((128, 32, 64, 64), 128, 32),
    ((4, 128, 8, 128), 4, 8),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape,batch,kv", CACHE_CASES)
def test_cache_shardings_match_jax(shape, batch, kv, mesh):
    cache = {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16),
             "s": [jax.ShapeDtypeStruct(shape[:2], jnp.float32)]}
    want = jshd.cache_shardings(cache, JMESH[mesh], n_kv_heads=kv,
                                batch=batch)
    got = shd.cache_shardings({"k": torch.empty(shape, device="meta"),
                               "s": [torch.empty(shape[:2], device="meta")]},
                              PMESH[mesh], n_kv_heads=kv, batch=batch)
    assert got == {"k": _spec(want["k"].spec), "s": [_spec(want["s"][0].spec)]}


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert shd.active_mesh() is None
    assert shd.constrain(x, "data", None) is x
    assert shd.axis_size("model") == 1


def test_use_mesh_sets_and_resets_the_active_mesh():
    m = PMESH["4x2"]
    with shd.use_mesh(m):
        assert shd.active_mesh() is m and shd.axis_size("model") == 2
        assert shd.axis_size("pod") == 1
    assert shd.active_mesh() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = PMESH["2x2x2"]
    assert shd.placements((("pod", "data"), None), m) \
        == (Shard(0), Shard(0), Replicate())
    assert shd.placements(("data", None, "model"), m) \
        == (Replicate(), Shard(0), Shard(2))
    assert shd.placements((), m) == (Replicate(),) * 3
    assert shd.replicated(m) == () == _spec(jshd.replicated(JMESH["4x2"]).spec)


# ------------------------------------------------------------------ #
# every parameter of the ten archs
# ------------------------------------------------------------------ #
def _leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _jax_layout(cfg, tree, name: str):
    """The JAX package's leaf of ``tree`` (params, axes or specs) for the
    port's parameter ``name``, and whether it is stacked (led by the group
    or encoder-layer axis): ``models/convert.py``'s layout, layer ``g * P
    + i`` at pattern position ``i`` of group ``g``."""
    head, _, rest = name.partition(".")
    if head == "blocks":
        i, _, path = rest.partition(".")
        p = len(cfg.pattern)
        g_layers = (cfg.n_layers // p) * p
        i = int(i)
        if i < g_layers:
            return _leaf(tree["blocks"][i % p], path.split(".")), True
        return _leaf(tree["rest"][i - g_layers], path.split(".")), False
    if head == "encoder":
        _, _, path = rest.partition(".")
        return _leaf(tree["encoder"], path.split(".")), True
    return tree[name], False


def _jax_tree(arch: str, full: bool):
    from repro.configs import ARCHS as JARCHS, reduce_config as jreduce
    from repro.models import build_model as jbuild
    cfg = JARCHS[arch] if full else jreduce(JARCHS[arch])
    model = jbuild(cfg)
    abstract = model.abstract_params()
    if model.axes is None:
        jax.eval_shape(model.init, jax.random.key(0))
    return cfg, abstract, model.axes


def _port(arch: str, full: bool):
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    cfg = ARCHS[arch] if full else reduce_config(ARCHS[arch])
    return build_model(cfg)


ARCH_NAMES = sorted(__import__("repro_torch.configs",
                               fromlist=["ARCHS"]).ARCHS)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_axes_are_the_jax_axes(arch):
    cfg, abstract, axes = _jax_tree(arch, full=False)
    model = _port(arch, full=False)
    got = model.param_axes()
    assert sorted(got) == sorted(dict(model.named_parameters()))
    for name, ax in got.items():
        want, stacked = _jax_layout(cfg, axes, name)
        want = tuple(want) if isinstance(want, tuple) else (want,)
        assert ax == (want[1:] if stacked else want), name
        if stacked:
            assert want[0] == "layers"


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_full_size_parameter_gets_the_jax_spec(arch, mesh):
    cfg, abstract, axes = _jax_tree(arch, full=True)
    jspecs = jshd.param_shardings(abstract, axes, JMESH[mesh])
    model = _port(arch, full=True)
    params = dict(model.named_parameters())
    got = shd.param_shardings(params, model.param_axes(), PMESH[mesh])
    assert sorted(got) == sorted(params)
    for name, spec in got.items():
        want, stacked = _jax_layout(cfg, jspecs, name)
        want = _spec(want.spec)
        want = want + (None,) * ((len(params[name].shape) + stacked)
                                 - len(want))
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert spec == want, (name, spec, want)
