"""Pipeline parallelism: GPipe schedule over a ``stage`` mesh axis.

The port of ``repro.distributed.pipeline``.  The production mesh for the
assigned scale is TPxFSDP (see DESIGN.md §6) — PP is the optional third
axis for scaling past a node's memory without growing TP.  Each rank of
the ``stage`` axis runs the same schedule (SPMD) on its own stage's
parameters:

* activations flow stage-to-stage by a point-to-point permute (the
  neighbour-only NVLink traffic that ``jax.lax.ppermute`` is on ICI),
* microbatches fill the pipe GPipe-style: ``n_ticks = n_micro +
  n_stages - 1``; bubble fraction = (n_stages-1)/n_ticks, amortized by
  more microbatches,
* stage 0 injects, the last stage writes, and the result goes to every
  stage by a sum over the one-hot mask of the last stage.

The permute is a ``torch.autograd.Function`` whose backward sends the
gradient the other way (what JAX gets from ``ppermute``'s transpose), and
the final sum's backward hands each stage the gradient of the result
unchanged where it is the last stage (zero elsewhere), so ``backward()``
on the replicated result gives every stage's parameters the gradient of
the serial composition.  Every process calls ``apply`` (it is
collective over the ``stage`` axis).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..roofline.trace import note_collective


def stage_permutation(n_stages: int) -> list[tuple[int, int]]:
    """Ring i -> i+1 (the wrap link carries garbage that is masked off)."""
    return [(i, (i + 1) % n_stages) for i in range(n_stages)]


def _exchange(x: torch.Tensor, send_to: int, recv_from: int, group):
    """Send ``x`` to global rank ``send_to`` and return what global rank
    ``recv_from`` sent (a tensor like ``x``)."""
    import torch.distributed as dist
    out = torch.empty_like(x)
    x = x.contiguous()
    reqs = [dist.isend(x, send_to, group=group),
            dist.irecv(out, recv_from, group=group)]
    for r in reqs:
        r.wait()
    return out


class _Permute(torch.autograd.Function):
    """One tick's stage-to-stage permute (stage i -> i+1); its backward
    sends the gradient from i+1 back to i."""

    @staticmethod
    def forward(ctx, y, nxt, prv, group):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        out = _exchange(y, nxt, prv, group)
        note_collective("collective-permute", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.prv, ctx.nxt, ctx.group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``out`` on every stage (a sum over the stage group
    of ``out`` masked to the last stage); the gradient of the replicated
    result, the same on every stage, flows back on the last stage only.
    It also takes every tick's permute result (``links``) and gives them
    a zero gradient, so that every stage's backward runs each permute's
    backward, in the reverse order of the ticks, as its neighbours do
    (stage 0 never reads what reaches it)."""

    @staticmethod
    def forward(ctx, out, is_last, group, *links):
        import torch.distributed as dist
        ctx.is_last = is_last
        ctx.shapes = [(b.shape, b.dtype, b.device) for b in links]
        y = out * float(is_last)
        dist.all_reduce(y, group=group)
        note_collective("all-reduce", y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return (grad * float(ctx.is_last), None, None,
                *(torch.zeros(s, dtype=d, device=v) for s, d, v in
                  ctx.shapes))


def pipeline_apply(stage_fn: Callable, mesh, *, axis: str = "stage"):
    """Wrap ``stage_fn(stage_params, x) -> y`` into a GPipe pipeline.

    Returns ``apply(stacked_params, x)`` where ``stacked_params`` leaves
    (a tensor, or a dict / list of them) have a leading ``n_stages`` axis
    (whole on every rank, or DTensors sharded over ``axis``; a rank uses
    its stage's slice) and ``x`` is ``(n_micro, mb, ...)`` microbatched
    input, the same on every rank.  Output matches ``x``'s shape with
    ``stage_fn`` applied by all stages in sequence, on every rank.
    ``mesh`` is a ``DeviceMesh`` with an ``axis`` dimension.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    names = mesh.mesh_dim_names
    n_stages = mesh.shape[names.index(axis)]
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    is_last = stage == n_stages - 1

    def mine(p):
        if isinstance(p, dict):
            return {k: mine(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(mine(v) for v in p)
        if isinstance(p, DTensor):
            return p.to_local()[0]
        return p[stage]

    def apply(stacked_params, x):
        params = mine(stacked_params)
        n_micro = x.shape[0]
        n_ticks = n_micro + n_stages - 1
        buf = torch.zeros_like(x[0])               # inter-stage register
        slots = [torch.zeros_like(x[0]) for _ in range(n_micro)]
        links = []
        for t in range(n_ticks):
            # stage 0 injects microbatch t while t < n_micro; other stages
            # consume what arrived over the permute link last tick.
            xin = x[min(t, n_micro - 1)] if stage == 0 else buf
            y = stage_fn(params, xin)
            # the last stage has produced microbatch t-(n_stages-1)
            done = t - (n_stages - 1)
            if is_last and done >= 0:
                slots[done] = y
            buf = _Permute.apply(y, nxt, prv, group)
            links.append(buf)
        return _FromLast.apply(torch.stack(slots), is_last, group, *links)

    return apply


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: idle / total stage-ticks."""
    ticks = n_microbatches + n_stages - 1
    return (n_stages - 1) / ticks
