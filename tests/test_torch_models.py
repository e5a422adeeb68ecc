"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, per architecture under ``reduce_config``, on the
CPU: the same weights (the JAX ``Model.init`` tree, carried across by
``Model.load_jax``) and the same numpy-seeded inputs through ``forward``,
``prefill``, several ``decode_step``s on one cache, and ``train_loss``.

The JAX functions are compiled with XLA's excess precision off
(``torch_lm.strict_jit``), so both packages round every op's bf16 result
as their code says.  What still differs is the order in which a product
sums its f32 terms, which now and then flips a bf16 rounding by one ulp:
fed the same input, a gemma3 block's 2048 outputs differ in 0 to 2.  With
random weights such a flip grows layer by layer, to a rel-L2 of about
1.1e-2 on the logits of gemma3's 13 reduced layers (the 3-layer archs
agree to the bit).  ``TOL`` (rel-L2 on f32 logits and on caches) and
``LOSS_TOL`` (relative, on the scalar losses) leave room for that; a wrong
formula (a mask, the RoPE layout, a cast) moves them by order one.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch_lm import (as_numpy, jax_model, port_model, rel_l2,  # noqa: E402
                      strict_jit)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.convert import cache_from_jax  # noqa: E402

ARCH_NAMES = list(ARCHS)
#: rel-L2 on f32 logits and on caches (see the module's docstring)
TOL = 2e-2
#: relative error of the scalar losses (nll, z-loss, aux)
LOSS_TOL = 2e-3
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ))
             .astype(np.int32)}
    batch["labels"][0, :3] = -1                     # masked positions
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward(arch: str):
    cfg, model, params = jax_model(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    fwd = strict_jit(model.forward, static_argnames=("make_cache",))
    logits, aux, (caches, enc_out) = fwd(params, batch, make_cache=True)
    return as_numpy((logits, aux, caches, enc_out))


@functools.lru_cache(maxsize=None)
def _port(arch: str):
    return port_model(arch)


def _assert_caches(got: list, want: list) -> None:
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl), layer
        for a, b in zip(gl, wl):
            assert a.shape == b.shape and a.dtype == b.dtype, layer
            assert rel_l2(a.float(), b.float()) <= TOL, layer


def test_configs_are_the_jax_packages():
    """The arch files, shapes and helpers are copies of the JAX package's:
    the same fields, field by field."""
    import repro.configs as ref
    from repro.configs.common import attention_shape as ref_shape

    import repro_torch.configs as port
    from repro_torch.configs.common import attention_shape
    assert list(port.ARCHS) == list(ref.ARCHS)
    for name, cfg in port.ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.ARCHS[name])
        assert dataclasses.asdict(port.reduce_config(cfg)) == \
            dataclasses.asdict(ref.reduce_config(ref.ARCHS[name]))
        assert attention_shape(cfg, 4096) == ref_shape(ref.ARCHS[name], 4096)
        assert cfg.param_count() == ref.ARCHS[name].param_count()
        assert cfg.active_param_count() == \
            ref.ARCHS[name].active_param_count()
    assert port.TUNABLE_KERNELS == ref.TUNABLE_KERNELS
    assert port.SHAPES == ref.SHAPES
    assert port.LONG_CONTEXT_ARCHS == ref.LONG_CONTEXT_ARCHS
    assert list(port.cells_for("gemma3-27b")) == \
        list(ref.cells_for("gemma3-27b"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameters_are_the_jax_trees(arch):
    """One tensor for each leaf of the JAX tree (its group axis unstacked),
    of the same count, shape and dtype, every one loaded."""
    model = _port(arch)
    params = jax_model(arch)[2]
    leaves = jax.tree.leaves(params)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in leaves)
    dtypes = {str(x.dtype) for x in leaves}
    assert {str(p.dtype).removeprefix("torch.")
            for p in model.parameters()} == dtypes
    assert model.device.type == "cpu"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_matches_jax(arch):
    cfg = _port(arch).cfg
    logits, aux, _, _ = _jax_forward(arch)
    with torch.no_grad():
        got, got_aux, (caches, _) = _port(arch).forward(_batch(cfg))
    assert caches is None
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ,
                                                         cfg.vocab)
    assert rel_l2(got, logits) <= TOL
    assert abs(float(got_aux) - float(aux)) <= LOSS_TOL * max(1.0, abs(aux))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_matches_jax(arch):
    """Last-position logits, one cache a layer equal to the JAX caches'
    layers, and whisper's encoder output."""
    cfg, model, params = jax_model(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    logits, caches, enc_out = as_numpy(strict_jit(model.prefill)(params,
                                                                 batch))
    got, got_caches, got_enc = _port(arch).prefill(_batch(cfg))
    assert got.shape == (BATCH, cfg.vocab)
    assert rel_l2(got, logits) <= TOL
    _assert_caches(got_caches, cache_from_jax(cfg, caches))
    if cfg.n_enc_layers:
        assert rel_l2(got_enc.float(), enc_out) <= TOL
    else:
        assert got_enc is None and enc_out is None


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_steps_match_jax(arch):
    """Three decode steps on one zeroed cache of 48 rows, each slot at its
    own position (40 and 38, then on), so that the windowed archs' ring
    buffers of 32 rows have wrapped."""
    cfg, model, params = jax_model(arch)
    port = _port(arch)
    batch = _batch(cfg)
    _, _, _, enc_out = _jax_forward(arch)
    cache = model.init_cache(BATCH, max_len=3 * SEQ)
    got_cache = port.init_cache(BATCH, max_len=3 * SEQ)
    _assert_caches(got_cache, cache_from_jax(cfg, cache))
    step = strict_jit(model.decode_step)
    enc = None if enc_out is None else jnp.asarray(enc_out, jnp.bfloat16)
    got_enc = None if enc_out is None else \
        torch.from_numpy(enc_out).to(torch.bfloat16)
    tok = batch["tokens"][:, :1]
    for i in range(3):
        pos = np.asarray([40 + i, 38 + i], np.int32)
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(pos), enc_out=enc)
        got, got_cache = port.decode_step(got_cache, tok, pos,
                                          enc_out=got_enc)
        assert rel_l2(got, as_numpy(logits)) <= TOL, i
        tok = np.asarray(jnp.argmax(logits, axis=-1))[:, None] \
            .astype(np.int32)
    _assert_caches(got_cache, cache_from_jax(cfg, as_numpy(cache)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_loss_matches_jax(arch):
    cfg, model, params = jax_model(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    total, metrics = as_numpy(strict_jit(model.train_loss)(params, batch))
    with torch.no_grad():
        got, got_metrics = _port(arch).train_loss(_batch(cfg))
    assert abs(float(got) - float(total)) <= LOSS_TOL * abs(float(total))
    for key in ("nll", "z_loss", "aux", "tokens"):
        want = float(metrics[key])
        assert abs(float(got_metrics[key]) - want) <= \
            LOSS_TOL * max(abs(want), 1e-6), key
    assert float(got_metrics["tokens"]) == BATCH * SEQ - 3
