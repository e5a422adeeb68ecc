"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's on the CPU, then the counterparts of ``tests/test_optimizer.py``.

The parity tests feed both the same params (a bf16 matrix, an f32 vector
and an f32 scalar-like leaf), the same state and the same grads, drawn
with numpy, over several steps; the JAX step is compiled with XLA's excess
precision off (``torch_lm.strict_jit``).  Both run the same f32 formulas
in the same order, one tensor at a time; what differs is the order in
which the global norm sums its squares (XLA's reduction tree against
torch's), a last-bit difference (measured: 1 ulp of the norm), which the
clip factor carries into every grad.  Hence ``REL`` on the norm and the
learning rate and ``ULPS`` f32 ulps on the state; a wrong formula (a
missing bias correction, decay on the moments, the clip) moves them by
order one.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch_lm import strict_jit  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         apply_updates, global_norm,
                                         init_opt_state, schedule)

#: relative error of the grad norm and of the learning rate
REL = 1e-6
#: f32 ulps (of the larger magnitude) the master, m, v and ef may differ by
ULPS = 64
SHAPES = {"a": (33, 17), "b": (64,), "c": (3, 5, 7)}


def _close(got: torch.Tensor, want, what: str, scale=None) -> None:
    """Within ``ULPS`` f32 ulps of ``scale`` (default the largest
    magnitude of ``want``)."""
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= ULPS * scale * 2.0 ** -23, f"{what}: {err} of {scale}"


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_jax(compress):
    kw = dict(warmup_steps=2, total_steps=6, compress_grads=compress)
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jp["a"] = jp["a"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tp["a"] = tp["a"].to(torch.bfloat16)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    js, ts = jopt.init_opt_state(jcfg, jp), init_opt_state(tcfg, tp)
    assert sorted(js) == sorted(ts)
    step = strict_jit(lambda p, s, g: jopt.apply_updates(jcfg, p, s, g))
    for i in range(6):
        grads = {k: (rng.standard_normal(s) * 10.0 ** (i % 3 - 1))
                 .astype(np.float32) for k, s in SHAPES.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in grads.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype)
              for k, v in grads.items()}
        jp, js, jm = step(jp, js, jg)
        tp, ts, tm = apply_updates(tcfg, tp, ts, tg)
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=REL, abs=1e-12)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for part in ("m", "v", "master"):
            for k in SHAPES:
                _close(ts[part][k], js[part][k], f"step {i} {part}.{k}")
        # the carried error is the small difference of two grad-sized
        # numbers: its last bits are the grads' (an ulp of the int8 scale)
        for k in SHAPES if compress else ():
            _close(ts["ef"][k], js["ef"][k], f"step {i} ef.{k}",
                   scale=float(np.abs(grads[k]).max()))
        for k in SHAPES:
            # the params are the master weights in their own dtype
            assert torch.equal(tp[k], ts["master"][k].to(tp[k].dtype))
        for k in ("b", "c"):
            assert tp[k].dtype == torch.float32
            _close(tp[k], np.asarray(jp[k]), f"step {i} param {k}")
        # a bf16 param may round the other way where the masters differ
        # in their last bits: at most one bf16 ulp, at most a few elements
        a_got = tp["a"].float().numpy()
        a_want = np.asarray(jp["a"], np.float32)
        off = a_got != a_want
        assert off.mean() <= 0.01
        assert np.all(np.abs(a_got - a_want)[off]
                      <= np.abs(a_want[off]) * 2.0 ** -7)


def test_schedule_matches_jax():
    kw = dict(lr=2e-3, warmup_steps=7, total_steps=50, min_lr_ratio=0.05)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    for t in range(0, 60):
        want = float(jopt.schedule(jcfg, jnp.asarray(t, jnp.int32)))
        got = float(schedule(tcfg, torch.tensor(t, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=REL, abs=1e-12), t


def test_global_norm_matches_jax_and_takes_bf16():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) * 3
              for s in SHAPES.values()]
    want = float(jopt.global_norm([jnp.asarray(a, jnp.bfloat16)
                                   for a in arrays]))
    got = global_norm(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=REL)


# ------------------------------------------------------------------ #
# the counterparts of tests/test_optimizer.py
# ------------------------------------------------------------------ #
def _run(cfg, steps=200, dim=8, seed=0):
    """Minimize ||Wx - y||^2 over a fixed batch; returns final loss.  The
    problem is the JAX test's own, drawn by ``jax.random`` and carried
    over as numpy arrays."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)

    def draw(key, shape, scale=1.0):
        return torch.tensor(np.asarray(jax.random.normal(key, shape) * scale))

    w_true = draw(k1, (dim, dim))
    x = draw(k2, (32, dim))
    y = x @ w_true
    params = {"w": draw(k3, (dim, dim), 0.1).requires_grad_()}
    state = init_opt_state(cfg, params)
    loss = None
    for _ in range(steps):
        loss = torch.mean((x @ params["w"] - y) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        params, state, _ = apply_updates(cfg, params, state, {"w": g})
    return float(loss.detach())


def test_adamw_converges_on_quadratic():
    cfg = OptimizerConfig(lr=3e-2, weight_decay=0.0, warmup_steps=10,
                          total_steps=200)
    assert _run(cfg) < 1e-3


def test_weight_decay_shrinks_solution():
    lo = _run(OptimizerConfig(lr=3e-2, weight_decay=0.0, total_steps=200))
    hi = _run(OptimizerConfig(lr=3e-2, weight_decay=0.5, total_steps=200))
    assert hi > lo                      # decay biases away from exact fit


def test_clipping_bounds_update():
    cfg = OptimizerConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0,
                          total_steps=10, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(cfg, params)
    new, _, metrics = apply_updates(cfg, params, state,
                                    {"w": torch.full((4,), 1e6)})
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert torch.isfinite(new["w"]).all()
    assert float(new["w"].abs().max()) <= 1.5 * cfg.lr


def test_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)

    def s(t):
        return float(schedule(cfg, t))

    assert s(0) == pytest.approx(0.0)
    assert s(10) == pytest.approx(1.0)
    assert s(100) == pytest.approx(0.1, rel=1e-5)
    assert s(55) < s(20)


def test_compressed_grads_still_converge():
    base = OptimizerConfig(lr=3e-2, weight_decay=0.0, total_steps=300)
    comp = OptimizerConfig(lr=3e-2, weight_decay=0.0, total_steps=300,
                           compress_grads=True)
    l_base = _run(base, steps=300)
    l_comp = _run(comp, steps=300)
    assert l_comp < 50 * max(l_base, 1e-6) or l_comp < 1e-3


def test_master_weights_carry_precision():
    """bf16 params + f32 master: tiny updates must not be lost to bf16
    rounding."""
    cfg = OptimizerConfig(lr=1e-5, weight_decay=0.0, warmup_steps=0,
                          total_steps=10_000)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = init_opt_state(cfg, params)
    g = {"w": torch.full((4,), 1e-3)}
    for _ in range(50):
        params, state, _ = apply_updates(cfg, params, state, g)
    assert float((state["master"]["w"] - 1.0).abs().max()) > 1e-5
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], torch.ones(4, dtype=torch.bfloat16))


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    assert float(global_norm(t.values())) == pytest.approx(math.sqrt(3 + 16))


def test_missing_grad_counts_as_zero():
    """A parameter autograd did not reach (its grad None) is updated as
    the JAX package updates one whose cotangent is zero: its moments
    decay, weight decay still pulls it."""
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(3), "u": torch.ones(2)}
    state = init_opt_state(cfg, params)
    params, state, _ = apply_updates(cfg, params, state,
                                     {"w": torch.ones(3), "u": None})
    assert torch.equal(state["m"]["u"], torch.zeros(2))
    assert float(params["u"][0]) < 1.0       # decayed, not moved by Adam
