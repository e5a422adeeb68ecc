"""Helpers the port's LM tests share: the JAX package's reduced models, their
weights as numpy f32 trees, and JAX functions compiled with XLA's excess
precision off.

By default XLA on the CPU keeps a fused chain of bf16 ops in f32 and rounds
only its end; the JAX package's code, and the port, round each op's
bf16 result.  Compiled with ``xla_allow_excess_precision`` off, the JAX
functions round as their code says, and the port follows them to within
the order of a sum (on these configs, to the bit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

STRICT = {"xla_allow_excess_precision": False}


def strict_jit(fn, static_argnames=()):
    """``fn`` jitted and compiled with :data:`STRICT`, once per signature
    of its arguments (shapes, dtypes and static values)."""
    jitted = jax.jit(fn, static_argnames=static_argnames)
    compiled: dict = {}

    def call(*args, **kwargs):
        leaves, tree = jax.tree.flatten((args, {
            k: v for k, v in kwargs.items() if k not in static_argnames}))
        key = (tree, tuple((np.shape(x), jnp.result_type(x)) for x in leaves),
               tuple(sorted((k, kwargs[k]) for k in static_argnames
                            if k in kwargs)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args, **kwargs).compile(STRICT)
        dyn = {k: v for k, v in kwargs.items() if k not in static_argnames}
        return compiled[key](*args, **dyn)

    return call


def as_numpy(tree):
    """A JAX tree's leaves as numpy arrays, floats as f32 (bf16 exactly)."""
    def leaf(x):
        a = np.asarray(x)
        return a if a.dtype.kind in "biu" else a.astype(np.float32)
    return jax.tree.map(leaf, tree)


@functools.lru_cache(maxsize=None)
def jax_model(arch: str, seed: int = 0):
    """(config, JAX model, its params) for ``arch`` under ``reduce_config``."""
    from repro.configs import ARCHS, reduce_config
    from repro.models import build_model
    cfg = reduce_config(ARCHS[arch])
    model = build_model(cfg)
    return cfg, model, model.init(jax.random.key(seed))


def port_model(arch: str, seed: int = 0, attention_impl: str = "auto"):
    """The port's model of ``arch`` on the CPU with the JAX model's
    weights."""
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    params = jax_model(arch, seed)[2]
    return build_model(reduce_config(ARCHS[arch]), attention_impl) \
        .load_jax(as_numpy(params), "cpu")


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
