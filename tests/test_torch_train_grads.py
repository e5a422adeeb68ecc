"""Loss and every parameter's gradient of the port's ``Model.train_loss``
against ``jax.value_and_grad`` of the JAX package's, on the seven
attention archs under ``reduce_config`` (GQA, windowed, MLA, MoE and the
vision frontend), on the same weights and a numpy batch; the JAX grads
are carried across by ``models/convert.py``'s ``from_jax_params``.
Tolerances in ``tests/torch_train.py``."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_train import check_grads, one_thread  # noqa: E402

ARCHS = ("qwen3-8b", "qwen3-14b", "gemma3-27b", "deepseek-coder-33b",
         "internvl2-26b", "granite-moe-3b-a800m", "deepseek-v2-236b")


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    errs = check_grads(arch)
    if arch in ("granite-moe-3b-a800m", "deepseek-v2-236b"):
        # the aux loss reaches the router: its gradient is the JAX one's
        assert any(".router" in name for name in errs)


def test_initial_nll_grows_with_width_as_in_jax():
    """At init the nll is not ln(vocab): the tied head over N(0, 1)
    embeddings, scaled by 1/sqrt(d_model), gives each position's own token
    a logit of about sqrt(d_model) times its share of the final residual.
    One qwen3-8b layer at its published width (d 4096, 32 / 8 heads of
    128; d_ff and the vocabulary cut to keep the host's memory small): the
    port's first nll is the JAX package's (``LOSS_TOL``), tens of nats
    above ln(vocab), and it grows with the width in both."""
    import dataclasses
    import math

    import jax.numpy as jnp
    import numpy as np
    from torch_lm import as_numpy, strict_jit
    from torch_train import LOSS_TOL

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import build_model as jax_build
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import build_model

    vocab = 4096
    toks = np.random.default_rng(0).integers(0, vocab, (1, 64)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    nll = {}
    for d, heads, kv in ((256, 2, 1), (4096, 32, 8)):
        kw = dict(n_layers=1, d_model=d, n_heads=heads, n_kv_heads=kv,
                  d_ff=512, vocab=vocab, remat=False)
        model = jax_build(dataclasses.replace(JAX_ARCHS["qwen3-8b"], **kw))
        params = model.init(jax.random.key(0))
        _, metrics = strict_jit(model.train_loss)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        port = build_model(dataclasses.replace(PORT_ARCHS["qwen3-8b"], **kw)) \
            .load_jax(as_numpy(params), "cpu")
        with torch.no_grad():
            _, got = port.train_loss(batch)
        want = float(metrics["nll"])
        assert float(got["nll"]) == pytest.approx(want, rel=LOSS_TOL)
        nll[d] = want
    assert nll[4096] > math.log(vocab) + 30 > nll[256] + 20
