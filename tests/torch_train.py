"""Helpers the port's training tests share: the loss and every parameter's
gradient of a reduced arch, by the JAX package's
``jax.value_and_grad(model.train_loss)`` and by the port's
``train_loss().backward()``, on the same weights and batch.

Tolerances: the forward agrees as ``tests/test_torch_models.py`` says (an
occasional one-ulp bf16 flip from a different f32 summation order, grown
layer by layer to a relative loss error of 5.4e-4 on gemma3's 13 reduced
layers).  The backward runs the chain back through every layer, so the
earliest layers' gradients carry the most of it: measured on the CPU, a
parameter's rel-L2 reaches 2.6e-2 (gemma3, block 0's ``ln2``), 1.3e-2
(recurrentgemma) and 1.0e-2 (rwkv6), and stays under 9e-3 on the other
seven archs.  ``GRAD_TOL`` leaves about twice the worst; a wrong formula
(a missing term of the loss, a gradient cut at the attention, the aux
loss not reaching the router) moves a gradient by order one.
"""

from __future__ import annotations

import numpy as np
import torch
import jax
import jax.numpy as jnp

from torch_lm import as_numpy, jax_model, port_model, rel_l2, strict_jit
from repro_torch.models.convert import from_jax_params

#: rel-L2 of each parameter's gradient (see the module's docstring)
GRAD_TOL = 5e-2
#: relative error of the scalar loss
LOSS_TOL = 2e-3
BATCH, SEQ = 2, 16


def grad_batch(cfg, seed: int = 1) -> dict:
    """Tokens and labels (some masked), with the frames or patches the
    frontend needs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ))
             .astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def check_grads(arch: str) -> dict:
    """The loss and every gradient of ``arch`` against the JAX package's;
    returns each parameter's rel-L2."""
    cfg, model, params = jax_model(arch)
    batch = grad_batch(cfg)
    (loss, _), grads = strict_jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = from_jax_params(cfg, as_numpy(grads))
    port = port_model(arch)
    got, _ = port.train_loss(batch)
    got.backward()
    got = float(got.detach())
    assert abs(got - float(loss)) <= LOSS_TOL * abs(float(loss))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want)
    errs = {}
    for name, p in named.items():
        assert p.grad is not None, f"{arch}: no gradient reached {name}"
        assert p.grad.dtype == p.dtype
        errs[name] = rel_l2(p.grad.float().numpy(), want[name].numpy())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, f"{arch}: {worst} rel_l2 {errs[worst]}"
    return errs


def one_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n
