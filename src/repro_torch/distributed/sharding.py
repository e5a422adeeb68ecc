"""Logical-axis sharding: map per-parameter logical names to mesh axes.

The port of ``repro.distributed.sharding`` on
``torch.distributed.device_mesh.DeviceMesh`` and DTensor placements.
Parameters carry logical axis tuples (``Model.param_axes``).  Rules assign
mesh axes greedily with divisibility fallback — e.g. deepseek-coder's 56
heads don't divide model=16, so TP falls through to the 128-wide head_dim.

Scheme ("FSDP × TP"):
  * ``model`` axis — tensor parallel: expert > vocab > ff > heads > kv_heads
    > lora > head_dim (first divisible wins)
  * ``data`` axis — ZeRO-3/FSDP: embed (d_model rows) or the largest
    remaining axis
  * ``pod`` axis — pure data parallel for params (replicated weights,
    gradient all-reduce crosses pods once per step)

A *spec* is what the JAX package's ``PartitionSpec`` holds: one entry a
tensor dim, ``None``, a mesh-axis name or a tuple of them (major first).
:func:`placements` turns it into DTensor placements, one a mesh dim: a
tensor dim named by several mesh axes is ``Shard`` on each, which DTensor
orders by mesh dim, the JAX package's major-first order for the mesh's
own axis order.  The spec functions read only the mesh's axis names and
sizes (``mesh_dim_names`` and ``shape``), so :class:`AbstractMesh` plans
a 512-rank mesh with no process group.

Activation constraints are applied through :func:`constrain` (the
argument itself without an active mesh, so single-device runs are
unaffected).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_MESH: contextvars.ContextVar[Any] = \
    contextvars.ContextVar("repro_torch_mesh", default=None)

MODEL_PREFS = ("expert", "vocab", "ff", "heads", "heads_flat", "kv_heads",
               "q_lora", "kv_lora", "head_dim")
DATA_PREFS = ("embed", "ff", "vocab", "heads_flat", "q_lora", "kv_lora")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's topology without devices or a process group: what the
    spec functions read of a ``DeviceMesh``."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` as the active mesh.  Under a ``DeviceMesh`` a plain tensor
    that meets a DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``), as an unsharded array does under the JAX
    package's ``jit``: positions, masks and scalars need no placement."""
    token = _MESH.set(mesh)
    try:
        if isinstance(mesh, AbstractMesh):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def active_mesh():
    return _MESH.get()


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(name: str = "model") -> int:
    """Extent of one mesh axis in the active mesh (1 without a mesh)."""
    mesh = _MESH.get()
    if mesh is None:
        return 1
    return _mesh_axis_sizes(mesh).get(name, 1)


def _clean(spec, names) -> tuple:
    """``spec`` with the axis names ``names`` lacks dropped."""
    clean = []
    for s in spec:
        if s is None:
            clean.append(None)
        elif isinstance(s, tuple):
            clean.append(tuple(a for a in s if a in names) or None)
        else:
            clean.append(s if s in names else None)
    return tuple(clean)


def placements(spec, mesh) -> tuple:
    """DTensor placements, one a mesh dim, of ``spec`` (one entry a tensor
    dim): ``Shard(d)`` on every mesh dim that tensor dim ``d`` names,
    ``Replicate()`` on the rest."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    index = {n: i for i, n in enumerate(mesh.mesh_dim_names)}
    for dim, s in enumerate(spec):
        for name in (s if isinstance(s, tuple) else (s,)):
            if name is not None:
                out[index[name]] = Shard(dim)
    return tuple(out)


def constrain(x, *spec):
    """Sharding constraint by mesh-axis names: ``x`` itself without an
    active mesh (or where it is not a DTensor: a plain tensor has no
    placement to change); under one, the DTensor redistributed to
    ``spec``'s placements on its mesh, axis names its mesh lacks dropped
    (a ``Partial`` sum is reduced into them).  A dim the named axes do
    not divide stays whole (where XLA would pad it): DTensor cannot view
    an unevenly sharded dim, and the models reshape after constraints."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    m = x.device_mesh
    sizes = _mesh_axis_sizes(m)
    spec = tuple(
        s if s is None or x.shape[d] % math.prod(
            sizes[a] for a in (s if isinstance(s, tuple) else (s,))) == 0
        else None
        for d, s in enumerate(_clean(spec, m.mesh_dim_names)))
    return redistribute(x, placements(spec, m))


def redistribute(x, want):
    """DTensor ``x`` with placements ``want`` on its mesh (``x`` itself
    where it has them), made contiguous first: a redistribution lays its
    local result out contiguously but keeps the input's global strides,
    which later views of a permuted product's result would trust."""
    if tuple(x.placements) == tuple(want):
        return x
    if not x.is_contiguous():
        x = x.contiguous()
    return x.redistribute(x.device_mesh, tuple(want))


def as_dtensor(x, mesh):
    """``x`` itself if a DTensor, else ``x`` replicated on ``mesh`` (the
    same on every rank, as a plain tensor under ``implicit_replication``
    counts)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_local(x, mesh, want, shape):
    """A DTensor of global ``shape`` (contiguous) whose local shard on this
    rank is ``x`` under placements ``want``: the shape is given, not
    inferred, since a dim sharded unevenly (a decode batch of one group
    over 16 ranks) is not its local size times the mesh's."""
    shape = torch.Size(shape)
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(x.contiguous(), mesh, want, run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def shard_span(size: int, mesh, want, dim: int) -> tuple[int, int]:
    """Where this rank's chunk of tensor dim ``dim`` (of ``size``) starts
    under placements ``want``, and its length: each mesh dim that shards
    it cuts the chunk before it into ``torch.chunk``'s pieces, in mesh
    order."""
    coord = mesh.get_coordinate()
    lo, n = 0, size
    for i, p in enumerate(want):
        if p == Shard(dim):
            piece = -(-n // mesh.shape[i])
            start = min(coord[i] * piece, n)
            lo, n = lo + start, max(0, min(piece, n - start))
    return lo, n


def _reduced(placements) -> tuple:
    return tuple(Replicate() if p.is_partial() else p for p in placements)


class _Enter(torch.autograd.Function):
    """DTensor ``x`` redistributed to ``want`` and taken as its local
    tensor; on the way back the local gradient, with placements ``grad``,
    is reduced at once to ``x``'s own placements (a pending sum there
    kept whole)."""

    @staticmethod
    def forward(ctx, x, want, grad):
        ctx.meta = (x.device_mesh, grad, _reduced(x.placements), x.shape)
        return redistribute(x, want).to_local()

    @staticmethod
    def backward(ctx, g):
        mesh, grad, src, shape = ctx.meta
        return redistribute(from_local(g, mesh, grad, shape), src), None, None


class _Exit(torch.autograd.Function):
    """Local ``y`` as a DTensor of global ``shape`` with placements
    ``out``, a pending sum (``Partial``) reduced at once; on the way back
    the gradient, made to the reduced placements, as its local tensor."""

    @staticmethod
    def forward(ctx, y, mesh, out, shape):
        ctx.done = _reduced(out)
        return redistribute(from_local(y, mesh, out, shape), ctx.done)

    @staticmethod
    def backward(ctx, g):
        return (redistribute(g, ctx.done).to_local().contiguous(), None,
                None, None)


def local_region(fn, inputs, out, shape):
    """``fn`` run on each rank's local shards, the models' one way past
    DTensor's own op strategies (which fail on strided shards and uneven
    views, and gather a whole vocab-sharded logits tensor for the loss's
    backward).

    ``inputs``: ``(x, want)`` pairs, ``x`` a DTensor (a plain tensor is
    taken as replicated, ``None`` passed as it is) and ``want`` the
    placements ``fn`` takes it under; ``fn`` gets their local tensors and
    returns its local result.  ``out`` is the result's placements and
    ``shape`` its global shape (lists of both, an entry a result, for a
    tuple of results).
    Every collective of the region is issued here, where the JAX
    package's SPMD partitioner puts it: on the way in, each input is
    redistributed to ``want``; on the way out, a pending sum in ``out``
    (a sharded contraction, ``Partial``) is reduced; on the way back, an
    input's local gradient is a pending sum on each mesh dim where the
    input is replicated and a result is not (each rank's gradient covers
    only its own part of the result), and it is reduced at once to the
    input's placements: an all-reduce, or for an FSDP-gathered weight a
    reduce-scatter.  No pending sum leaves the region either way, so where
    a reduction happens does not rest on how DTensor propagates one."""
    from torch.distributed.tensor import Partial
    several = isinstance(out[0], (list, tuple))
    outs, shapes = (out, shape) if several else ([out], [shape])
    mesh = next(x.device_mesh for x, _ in inputs if isinstance(x, DTensor))
    spread = [any(not isinstance(o[i], Replicate) for o in outs)
              for i in range(mesh.ndim)]
    local = []
    for x, want in inputs:
        if x is None:
            local.append(None)
            continue
        grad = tuple(Partial() if isinstance(p, Replicate) and s else p
                     for p, s in zip(want, spread))
        local.append(_Enter.apply(as_dtensor(x, mesh), tuple(want), grad))
    ys = fn(*local)
    res = [_Exit.apply(y, mesh, tuple(o), tuple(sh))
           for y, o, sh in zip(ys if several else [ys], outs, shapes)]
    return res if several else res[0]


def spec_for(shape: tuple[int, ...], logical: tuple, mesh) -> tuple:
    """Greedy divisible assignment of mesh axes to logical axes."""
    sizes = _mesh_axis_sizes(mesh)
    assignment: dict[int, str | tuple] = {}

    def assign(mesh_axis: str, prefs) -> None:
        n = sizes.get(mesh_axis, 1)
        if n <= 1:
            return
        for name in prefs:
            for dim, lname in enumerate(logical):
                if lname == name and dim not in assignment \
                        and shape[dim] % n == 0:
                    assignment[dim] = mesh_axis
                    return

    if "model" in sizes:
        assign("model", MODEL_PREFS)
    if "data" in sizes:
        assign("data", DATA_PREFS)
    return tuple(assignment.get(d) for d in range(len(shape)))


def param_shardings(params: dict, axes: dict, mesh) -> dict:
    """The spec of each parameter: ``params`` maps names to anything with
    a ``shape`` (tensors, meta tensors), ``axes`` the same names to their
    logical axes (``Model.param_axes``)."""
    if set(params) != set(axes):
        raise ValueError(f"params/axes mismatch: "
                         f"{sorted(set(params) ^ set(axes))[:4]}")
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        ax = axes[name]
        ax = tuple(ax) + (None,) * (len(shape) - len(ax)) \
            if ax is not None else (None,) * len(shape)
        out[name] = spec_for(shape, ax, mesh)
    return out


# ------------------------------------------------------------------ #
# activations / batches / caches
# ------------------------------------------------------------------ #
def batch_spec(shape: tuple[int, ...], mesh, *,
               seq_axis: int | None = 1) -> tuple:
    """Shard batch dim over (pod, data); fall back to sequence sharding over
    data when the batch is too small (long-context cells)."""
    sizes = _mesh_axis_sizes(mesh)
    pod = sizes.get("pod", 1)
    data = sizes.get("data", 1)
    b = shape[0]
    spec: list = [None] * len(shape)
    if b % (pod * data) == 0 and pod * data > 1:
        spec[0] = ("pod", "data") if pod > 1 else "data"
    elif b % data == 0 and data > 1:
        spec[0] = "data"
        if pod > 1 and seq_axis is not None and len(shape) > seq_axis \
                and shape[seq_axis] % pod == 0 and shape[seq_axis] > 1:
            spec[seq_axis] = "pod"
    elif seq_axis is not None and len(shape) > seq_axis and shape[seq_axis] > 1:
        ax = []
        if data > 1 and shape[seq_axis] % (pod * data) == 0 and pod > 1:
            ax = ["pod", "data"]
        elif data > 1 and shape[seq_axis] % data == 0:
            ax = ["data"]
        if ax:
            spec[seq_axis] = tuple(ax) if len(ax) > 1 else ax[0]
    return tuple(spec)


def cache_shardings(cache: Any, mesh, *, n_kv_heads: int,
                    batch: int) -> Any:
    """Heuristic decode-cache sharding: batch -> (pod,data) when divisible,
    long sequence dims -> data, kv-head-like dims -> model.  ``cache`` is
    a tree (dicts, lists, tuples) of anything with a ``shape``; returns
    the same tree of specs."""
    sizes = _mesh_axis_sizes(mesh)
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)
    pod = sizes.get("pod", 1)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        used_model = False
        used_data = False
        # batch dim is 0 for unstacked, 1 for group-stacked caches
        bdim = 0 if (len(shape) > 0 and shape[0] == batch) else \
            (1 if len(shape) > 1 and shape[1] == batch else None)
        if bdim is not None and batch % (pod * data) == 0 and pod * data > 1:
            spec[bdim] = ("pod", "data") if pod > 1 else "data"
            used_data = True
        # model axis priority must mirror the decode compute policy
        # (attention._constrain_qkv): kv-head dim when divisible, else the
        # long sequence dim — never head_dim (a head_dim-sharded cache
        # forces a full-cache reshard against seq/head-sharded compute).
        if model > 1:
            hd = len(shape) - 2                            # the kv-head dim
            if hd >= 0 and hd != bdim and 1 < shape[hd] < 4096 \
                    and shape[hd] % model == 0:
                spec[hd] = "model"
                used_model = True
            if not used_model:
                for d in range(len(shape)):                # seq-like dims
                    if d != bdim and spec[d] is None and shape[d] >= 4096 \
                            and shape[d] % model == 0:
                        spec[d] = "model"
                        used_model = True
                        break
        for d in range(len(shape)):
            if spec[d] is not None or d == bdim:
                continue
            if not used_data and shape[d] >= 4096 \
                    and shape[d] % (pod * data) == 0:
                spec[d] = ("pod", "data") if pod > 1 else "data"
                used_data = True
        return tuple(spec)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return one(tree)

    return walk(cache)


def replicated(mesh) -> tuple:
    """The spec of a replicated value (the empty spec)."""
    return ()


# ------------------------------------------------------------------ #
# placing tensors and modules
# ------------------------------------------------------------------ #
def place(x, spec, mesh):
    """``x`` (a whole tensor, the same on every rank) as a DTensor on
    ``mesh`` with ``spec``'s placements: each rank keeps its own chunk, and
    nothing is sent (the counterpart of ``jax.device_put`` with a
    ``NamedSharding``).  A DTensor is redistributed (on its own mesh)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(x, DTensor):
        return redistribute(x, placements(spec, x.device_mesh))
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=None)


def place_params(module, specs: dict, mesh) -> None:
    """Replace each parameter of ``module`` named in ``specs`` by a
    DTensor parameter placed by its spec (:func:`place`), in place."""
    with torch.no_grad():
        for name, spec in specs.items():
            p = module.get_parameter(name)
            set_param(module, name, place(p.detach(), spec, mesh),
                      p.requires_grad)


def set_param(module, name: str, value, requires_grad: bool = True) -> None:
    """Register ``value`` as ``module``'s parameter ``name`` (dotted)."""
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    setattr(mod, leaf, torch.nn.Parameter(value, requires_grad=requires_grad))
