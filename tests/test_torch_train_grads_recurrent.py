"""Loss and every parameter's gradient of the port's ``Model.train_loss``
against ``jax.value_and_grad`` of the JAX package's, on the three archs
that are not pure attention stacks under ``reduce_config`` (RWKV6,
RG-LRU, and whisper's encoder-decoder with its frames), and remat:
``cfg.remat`` on against off gives the same gradients to the bit on the
CPU (the recompute runs the same ops on the same inputs).  Tolerances in
``tests/torch_train.py``."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_lm import port_model  # noqa: E402
from torch_train import check_grads, grad_batch, one_thread  # noqa: E402

from repro_torch.models.attention import ROUTES  # noqa: E402

ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-medium")


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_grads(arch)


def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = model.train_loss(batch)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-medium"])
def test_remat_gives_the_same_gradients_to_the_bit(arch):
    """Each block (and whisper's encoder blocks) checkpointed and recomputed
    in the backward pass: the attention runs twice a layer, the gradients
    do not change by a bit."""
    model = port_model(arch)
    batch = grad_batch(model.cfg)
    assert not model.cfg.remat                     # reduce_config's
    ROUTES.clear()
    loss, plain = _grads(model, batch)
    once = ROUTES["plain"]
    model.cfg = dataclasses.replace(model.cfg, remat=True)
    ROUTES.clear()
    loss_r, remat = _grads(model, batch)
    assert ROUTES["plain"] == 2 * once
    assert torch.equal(loss_r, loss)
    for name, g in plain.items():
        assert torch.equal(remat[name], g), name
    # with no grad recorded, nothing is checkpointed: one pass a layer
    ROUTES.clear()
    with torch.no_grad():
        model.train_loss(batch)
    assert ROUTES["plain"] == once
