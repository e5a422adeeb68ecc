"""AdamW from scratch (not ``torch.optim``): f32 master weights + moments
over bf16 params, global-norm clipping, warmup-cosine schedule, optional
int8 gradient compression with error feedback (distributed-optimization
trick).

The port of ``repro.train.optimizer``, with its formulas in its order.
Params, grads and the state's ``m``, ``v``, ``master`` (and ``ef``) are
dicts of tensors keyed like the model's ``state_dict``; ``step`` is an
int32 scalar tensor.  :func:`apply_updates` works one tensor at a time,
in place: no f32 copy of all grads is held at once, and every scalar
(the norm, the clip factor, the learning rate) stays a tensor on the
params' device, so a step never waits for the device.  Params may be
DTensors (a sharded model): the state then mirrors their placements
(ZeRO style), each gradient is first redistributed to its parameter's
placements (a pending sum reduced, the FSDP reduce-scatter) and the norm
is all-reduced.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import redistribute


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False     # int8 all-reduce w/ error feedback


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) in f32: linear
    warmup, then cosine decay to ``min_lr_ratio`` of ``lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(cfg: OptimizerConfig, params: dict) -> dict:
    """Zero moments and an f32 master copy of ``params`` (a dict of
    tensors), on the params' devices; ``ef`` (the carried compression
    error) where ``cfg.compress_grads``."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(iter(params.values())).device
    with torch.no_grad():
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "master": {k: p.detach().to(torch.float32, copy=True)
                       for k, p in params.items()},
        }
        if cfg.compress_grads:
            state["ef"] = {k: zeros(p) for k, p in params.items()}
    return state


def _compress_int8(g: torch.Tensor, ef: torch.Tensor):
    """Simulated int8 compression with error feedback: quantize (grad +
    carried error), return dequantized grad + new error.  On a real multi-
    host deployment the int8 tensor is what crosses the network."""
    x = g + ef
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, x - deq


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, in f32, each squared and
    summed on its own (one tensor's f32 copy at a time)."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: dict, opt_state: dict,
                  grads: dict):
    """One AdamW step.  Returns ``(params, opt_state, metrics)``:
    ``params`` (the same tensors) rewritten in place from the new master
    weights in their own dtype, ``opt_state`` with its tensors updated in
    place and the new ``step``, ``metrics`` ``{"grad_norm", "lr"}`` as
    scalar tensors.  ``grads`` may be bf16 or f32; a missing or None grad
    counts as zero, as the JAX package's zero cotangent does."""
    names = list(params)

    def grad(k):
        g = grads.get(k)
        if g is None:
            return torch.zeros_like(opt_state["m"][k])
        m = opt_state["m"][k]
        if isinstance(g, DTensor) and g.placements != m.placements:
            g = redistribute(g, m.placements)
        return g.to(torch.float32)

    if cfg.compress_grads:
        # the dequantized grads are what the norm and the update see; the
        # new carried error goes into ``ef`` in place
        deq = {}
        for k in names:
            deq[k], err = _compress_int8(grad(k), opt_state["ef"][k])
            opt_state["ef"][k].copy_(err)
        grad = deq.__getitem__
    gnorm = global_norm(grad(k) for k in names)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for k in names:
        g = grad(k) * scale
        m, v, master = (opt_state[s][k] for s in ("m", "v", "master"))
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * master
        master.sub_(lr * delta)
        params[k].copy_(master)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
