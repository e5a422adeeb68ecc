"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's: ``make_train_step`` with one and two microbatches over three
steps of the synthetic pipeline's batches on the reduced qwen3-8b, from
the same weights (the JAX step compiled with XLA's excess precision off,
``torch_lm.strict_jit``); ``input_specs`` and ``microbatch_count`` on
every arch and shape cell.

Tolerances: the losses and the grad norms differ as one forward and
backward do (``tests/torch_train.py``: a relative loss error of 5e-4 at
most, measured 3e-4 here; the norm 9e-4), hence ``LOSS_TOL`` and
``NORM_TOL``.  The parameters differ more: an Adam step moves each by
about the learning rate whatever its gradient's size, so an element whose
tiny gradient a rounding flips moves the other way.  At lr 1e-2, 0.2 % of
a matrix flipping gives the measured rel-L2 of 1.4e-2 after the first
step, and it does not grow over three; ``PARAM_TOL`` leaves over three
times that.  A step that skipped the clip, a bias correction, the
accumulation's division or a microbatch moves them by order one.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch_lm import as_numpy, jax_model, port_model, rel_l2  # noqa: E402
from torch_lm import strict_jit  # noqa: E402
from torch_train import one_thread  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)

LOSS_TOL = 2e-3
NORM_TOL = 5e-3
PARAM_TOL = 5e-2
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=3)


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    cfg, model, params = jax_model("qwen3-8b")
    pipe = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4))
    jstep = strict_jit(jsteps.make_train_step(
        model, jopt.OptimizerConfig(**OPT), microbatches))
    jstate = jopt.init_opt_state(jopt.OptimizerConfig(**OPT), params)
    port = port_model("qwen3-8b")
    state = init_opt_state(OptimizerConfig(**OPT),
                           dict(port.named_parameters()))
    step = steps.make_train_step(port, OptimizerConfig(**OPT), microbatches)
    moved = []
    for i in range(3):
        batch = pipe.batch_at(i)
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(port, state, batch)
        assert sorted(m) == sorted(jm)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_TOL)
        assert float(m["nll"]) == pytest.approx(float(jm["nll"]),
                                                rel=LOSS_TOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=NORM_TOL)
        assert float(m["lr"]) == float(jm["lr"])
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        want = from_jax_params(cfg, as_numpy(params))
        for name, p in port.named_parameters():
            assert p.grad is None                   # no grads kept
            got = p.detach().float().numpy()
            assert rel_l2(got, want[name].numpy()) <= PARAM_TOL, \
                (i, name)
        moved.append(float(m["loss"]))
    assert moved[-1] < moved[0]


def test_microbatches_accumulate_in_f32_and_average():
    """Two microbatches of the same rows give the one-batch step's
    gradients (to the f32 sum of two bf16 halves) and the mean loss."""
    port = port_model("qwen3-8b")
    batch = make_pipeline(DataConfig(vocab=port.cfg.vocab, seq_len=16,
                                     global_batch=2)).batch_at(0)
    twice = {k: np.concatenate([v, v]) for k, v in batch.items()}
    seen = {}

    def capture(cfg, params, state, grads):
        seen.update({k: g.clone() for k, g in grads.items()})
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

    mp = pytest.MonkeyPatch()
    mp.setattr(steps, "apply_updates", capture)
    try:
        opt = OptimizerConfig()
        state = init_opt_state(opt, dict(port.named_parameters()))
        _, one = steps.make_train_step(port, opt, 1)(port, state, batch)
        ones = dict(seen)
        _, two = steps.make_train_step(port, opt, 2)(port, state, twice)
    finally:
        mp.undo()
    assert float(two["loss"]) == float(one["loss"])
    for name, g in seen.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, ones[name].float()), name
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(port, OptimizerConfig(), 3)(port, state, batch)


def _spec_summary(tree) -> dict:
    """Elements a dtype name over a spec tree's leaves."""
    out: dict = {}
    for shape, dtype in tree:
        name = str(dtype).replace("torch.", "")
        out[name] = out.get(name, 0) + math.prod(shape)
    return out


def _jax_leaves(tree):
    return [(x.shape, x.dtype) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """The ``(shape, dtype)`` leaves of a port spec tree."""
    if isinstance(tree, tuple) and len(tree) == 2 \
            and isinstance(tree[1], torch.dtype):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _port_leaves(v)]


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_jax(arch, shape_name):
    from repro.configs import ARCHS as JAX_ARCHS
    got = steps.input_specs(ARCHS[arch], shape_name)
    want = jsteps.input_specs(JAX_ARCHS[arch], shape_name)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cache":
            assert _spec_summary(_port_leaves(got[k])) \
                == _spec_summary(_jax_leaves(want[k]))
        else:
            shape, dtype = got[k]
            assert shape == want[k].shape
            assert str(dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_microbatch_count_matches_jax(arch):
    from repro.configs import ARCHS as JAX_ARCHS
    mesh = jax.make_mesh((1,), ("data",))
    for shape_name in SHAPES:
        assert steps.microbatch_count(ARCHS[arch], shape_name) \
            == jsteps.microbatch_count(JAX_ARCHS[arch], shape_name, mesh)
    # four cards of data parallelism share the batch
    assert steps.microbatch_count(ARCHS[arch], "train_4k", dp=4) \
        <= steps.microbatch_count(ARCHS[arch], "train_4k")


def test_prefill_and_serve_steps_call_the_model():
    """The prefill step is ``Model.prefill``, the serve step one
    ``decode_step`` on the batch's cache, token and position."""
    port = port_model("qwen3-8b")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, port.cfg.vocab, (2, 8)).astype(np.int32)
    logits, caches, _ = steps.make_prefill_step(port)(port, {"tokens": tokens})
    want, want_caches, _ = port.prefill({"tokens": tokens})
    assert torch.equal(logits, want)
    assert torch.equal(caches[0]["attn"]["k"], want_caches[0]["attn"]["k"])
    cache = port.init_cache(2, 16)
    batch = {"cache": cache, "token": tokens[:, :1], "position": 0}
    got, _ = steps.make_serve_step(port)(port, batch)
    want, _ = port.decode_step(port.init_cache(2, 16), tokens[:, :1], 0)
    assert got.shape == (2, port.cfg.vocab) and torch.equal(got, want)
