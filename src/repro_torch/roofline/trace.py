"""Per-rank account of one eager step: the port's counterpart of the JAX
package's ``compiled.cost_analysis()`` (FLOPs, bytes accessed),
``compiled.as_text()`` (collectives) and ``compiled.memory_analysis()``
(the live-at-peak bytes).

:class:`StepTracer` is a ``TorchDispatchMode`` that sees every aten op the
step dispatches on this rank.  It lets DTensor decompose each distributed
op first, so what it counts is the rank's local work, the JAX package's
per-chip terms.  Its conventions:

* **FLOPs** — ``torch.utils.flop_counter``'s registry (matmuls,
  convolutions, attention) over the local ops; elementwise work counts
  nothing, as in that registry.
* **HBM bytes** — the input plus output bytes of each local op, views,
  allocations (``empty*``) and collectives left out; an in-place op's
  output counts as a write.  The port runs eagerly with no fusion, so
  this is what the eager step moves, not what a fused compilation would
  (the JAX package's ``bytes accessed`` is after XLA's fusion).
* **Collectives** — the **result** bytes of each ``_c10d_functional``
  collective (all-gather, all-reduce, reduce-scatter, all-to-all), the
  JAX package's convention on its HLO text; an all-to-all in which each
  rank sends to one other is a ``collective-permute``, and the
  pipeline's stage permute is counted once by :func:`note_collective`.
  Those that DTensor's own op strategies issue (where the innermost
  frame of the port's code on the Python stack is not in its
  distribution layer, ``repro_torch/distributed/``) are also counted
  apart, in ``dtensor_coll_by_op``: the port issues every collective of
  its sharded steps itself, so there it stays empty.
* **Peak memory** — the high-water mark of live local storage: the
  step's resident arguments (parameters, optimizer state, batch) plus
  every storage an op creates, until it is freed.

* **Recurrences** — a token loop (``models/rwkv6.py``, ``models/rglru.py``)
  is traced one chunk for all (:meth:`StepTracer.scan_once`) where its
  tensors are the step's fake tensors: the first chunk runs, and the
  other ``n - 1`` chunks count as that chunk's terms times ``n - 1``,
  forward, backward and remat's recompute alike; their outputs, and the
  bytes their autograd graph would keep, are allocations that move
  nothing.  The terms are the whole trace's (``once=False``), which runs
  every token.

DTensor's sharding propagation runs each op on global-shape fake tensors
to learn the output's shape: those ops are not the rank's work and are
skipped.  On real tensors they are the fake tensors (and on the meta
device, meta ones); under the step's own fake mode, which the propagation
reuses, they are the ops dispatched from within DTensor's sharding
propagator (found on the Python stack; only ops on tensors this tracer
has not seen made, factories included, are looked up).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ``_c10d_functional`` op names -> the JAX package's collective opcodes
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "all-reduce",
    "broadcast_": "all-reduce",
}
#: ops that move no data: allocations without a fill and metadata
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "_local_scalar_dense", "device", "set_", "resize_",
              "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
              "is_same_size", "_has_compatible_shallow_copy_type"}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_tracer", default=None)


@dataclasses.dataclass
class StepTrace:
    """What one rank's step did: FLOPs, HBM bytes and collective result
    bytes by opcode (and those of DTensor's own op strategies among
    them); the resident and peak bytes; ops counted and skipped; the
    trace's seconds on the host."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    dtensor_coll_by_op: dict = dataclasses.field(default_factory=dict)
    resident_bytes: float = 0.0
    peak_bytes: float = 0.0
    ops: int = 0
    skipped: int = 0
    seconds: float = 0.0

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_by_op.values()))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


_DIST = os.path.join("repro_torch", "distributed") + os.sep
_PORT = "repro_torch" + os.sep


def _issued_by_dtensor() -> bool:
    """Whether the innermost frame of the port's code on the stack is
    outside its distribution layer: a collective DTensor's op strategies
    chose for one of the port's ops (or its backward)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PORT in name and "roofline" not in name:
            return _DIST not in name
        f = f.f_back
    return True


@contextlib.contextmanager
def count_shard_moves():
    """Count the calls of DTensor's own Shard-to-Shard step
    (``shard_dim_alltoall``, which on a CPU mesh gathers the whole group)
    while active, by the shape of the local tensor moved: yields the
    ``collections.Counter``.  The port moves a shard itself
    (``sharding.redistribute``), so under it the count stays 0."""
    import collections
    import importlib
    seen = collections.Counter()
    cu = importlib.import_module("torch.distributed.tensor._collective_utils")
    orig = cu.shard_dim_alltoall

    def counted(input, *args, **kwargs):
        seen[tuple(input.shape)] += 1
        return orig(input, *args, **kwargs)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed.tensor") and
            getattr(m, "shard_dim_alltoall", None) is orig]
    for m in mods:
        m.shard_dim_alltoall = counted
    try:
        yield seen
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


def note_collective(op: str, result: torch.Tensor) -> None:
    """Count a collective the dispatcher does not show (a point-to-point
    transfer) under ``op``, its result's bytes, in the active tracer."""
    tracer = _ACTIVE.get()
    if tracer is not None:
        tracer._coll(op, _nbytes(result))


def once_tracer(*tensors):
    """The active :class:`StepTracer` where it traces a recurrence over
    ``tensors`` one chunk for all (:meth:`StepTracer.scan_once`): its
    ``once`` is set and the tensors are its step's fake tensors.  Else
    None, and the recurrence runs every token.  The tracer is found on the
    dispatch mode stack, which autograd carries into its backward threads
    (remat's recompute runs there)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    tracer = next((m for m in reversed(_get_current_dispatch_mode_stack())
                   if isinstance(m, StepTracer)), None)
    if tracer is None or not tracer.once or tracer.fake_mode is None \
            or not all(isinstance(t, FakeTensor)
                       and t.fake_mode is tracer.fake_mode for t in tensors):
        return None
    return tracer


class StepTracer(TorchDispatchMode):
    """Counts one rank's local work while active (see the module's
    conventions).  ``fake_mode``: the fake mode the step's own tensors
    belong to (None for real tensors); ``resident``: trees of the tensors
    (DTensors: their local shards) alive through the step, the base of
    the peak; ``skip_propagation`` False counts the ops of DTensor's
    sharding propagation as the rank's work too (a check of the skip);
    ``once`` False traces every token of a recurrence (see
    :meth:`scan_once`)."""

    def __init__(self, fake_mode=None, resident=(), skip_propagation=True,
                 once=True):
        super().__init__()
        self.fake_mode = fake_mode
        self.skip_propagation = skip_propagation
        self.once = once
        self.trace = StepTrace()
        self._live = 0
        self._seen: dict[int, int] = {}
        for t in _tensors(list(resident)):
            self._track(_local(t))
        self.trace.resident_bytes = float(self._live)
        self.trace.peak_bytes = float(self._live)

    # -------------------------------------------------------------- #
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self._live += n
        weakref.finalize(st, self._free, key)
        if self._live > self.trace.peak_bytes:
            self.trace.peak_bytes = float(self._live)

    def _free(self, key: int) -> None:
        self._live -= self._seen.pop(key, 0)

    def _coll(self, op: str, nbytes: float, dtensor: bool = False) -> None:
        for by in ((self.trace.coll_by_op, self.trace.dtensor_coll_by_op)
                   if dtensor else (self.trace.coll_by_op,)):
            by[op] = by.get(op, 0.0) + float(nbytes)

    def _foreign(self, t: torch.Tensor) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        if t.device.type == "meta":
            return True
        if isinstance(t, FakeTensor):
            return t.fake_mode is not self.fake_mode
        return False

    def _skip(self, ins, outs) -> bool:
        """Whether an op is not this rank's work (the module's note)."""
        if any(self._foreign(t) for t in ins + outs):
            return True
        if self.fake_mode is None or not self.skip_propagation or (
                ins and all(id(t.untyped_storage()) in self._seen
                            for t in ins)):
            return False
        return _in_sharding_propagation()

    # -------------------------------------------------------------- #
    def __enter__(self):
        self._token = _ACTIVE.set(self)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        self.trace.seconds += time.perf_counter() - self._t0
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors([args, kwargs]))
        outs = list(_tensors(out))
        if self._skip(ins, outs):
            self.trace.skipped += 1
            return out
        self.trace.ops += 1
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            if name in COLLECTIVES:
                op = COLLECTIVES[name]
                if name == "all_to_all_single" and sum(
                        1 for n in args[2] if n) == 1:
                    op = "collective-permute"
                self._coll(op, sum(_nbytes(t) for t in outs),
                           _issued_by_dtensor())
        elif ns != "c10d":        # point-to-point: note_collective counts it
            from torch.utils.flop_counter import flop_registry
            flop = flop_registry.get(func._overloadpacket)
            if flop is not None:
                self.trace.flops += float(flop(*args, **kwargs,
                                               out_val=out))
            if not func.is_view and name not in NO_TRAFFIC:
                self.trace.hbm_bytes += float(
                    sum(_nbytes(t) for t in ins + outs))
        for t in outs:
            self._track(t)
        return out

    def result(self) -> StepTrace:
        return self.trace

    # -------------------------------------------------------------- #
    # recurrences, one chunk for all
    # -------------------------------------------------------------- #
    def _add(self, terms: StepTrace, k: int) -> None:
        """``k`` times ``terms``' FLOPs, bytes, ops and collectives."""
        self.trace.flops += k * terms.flops
        self.trace.hbm_bytes += k * terms.hbm_bytes
        self.trace.ops += k * terms.ops
        for mine, theirs in ((self.trace.coll_by_op, terms.coll_by_op),
                             (self.trace.dtensor_coll_by_op,
                              terms.dtensor_coll_by_op)):
            for op, nbytes in theirs.items():
                mine[op] = mine.get(op, 0.0) + k * nbytes

    @contextlib.contextmanager
    def _apart(self):
        """Count into a fresh :class:`StepTrace` (yielded) while active;
        the live bytes go on being tracked, and the step's peak is left
        alone."""
        saved, self.trace = self.trace, StepTrace()
        try:
            yield self.trace
        finally:
            self.trace = saved

    def _probe(self, fn, state, xs, consts, chunk: int):
        """The backward of one chunk of a recurrence as the chunks after
        the first run it (its state requiring grad), counted apart: with
        the state's gradient (a middle chunk) and without it (the last
        chunk, whose state nothing reads), and the bytes its autograd
        graph keeps beyond its outputs.  Its graph keeps its saved tensors
        whatever hooks the step has pushed (remat's)."""
        ins = [state.detach().requires_grad_()]
        ins += [t[:, :chunk].detach().requires_grad_(t.requires_grad)
                for t in xs]
        ins += [t.detach().requires_grad_(t.requires_grad) for t in consts]
        need = [t for t in ins if t.requires_grad]
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                      lambda t: t), \
                torch.enable_grad():
            live = self._live
            with self._apart():
                s, o = fn(*ins)
            kept = max(0, self._live - live - _nbytes(s) - _nbytes(o))
            gs, go = torch.empty_like(s), torch.empty_like(o)
            with self._apart() as mid:
                torch.autograd.grad([o, s], need, [go, gs], retain_graph=True,
                                    allow_unused=True)
            with self._apart() as last:
                torch.autograd.grad([o], need, [go], allow_unused=True)
        return (mid, last), kept

    def scan_once(self, fn, state, xs, consts, chunk: int):
        """``fn(state, *chunk_xs, *consts) -> (state, out)`` over the
        ``n`` chunks of ``chunk`` tokens of the (B, T, ...) ``xs`` (``n``
        at least 2), as the whole loop (``models.layers.scan_chunks``)
        counts it, with one chunk run: the last state and the outputs
        joined on dim 1.

        The first chunk runs in the step's graph, and its forward's terms
        count ``n - 1`` more times.  Where autograd records, a probe
        (:meth:`_probe`) measures a later chunk's backward apart, counted
        ``n - 1`` times when the skipped chunks' node (:class:`_Skipped`)
        is reached on the way back.  That node takes the skipped chunks'
        slices of ``xs`` and a ``consts`` entry each, as their ``fn`` calls
        would, so what autograd does around the chunks (the slices'
        gradients, the sums of a shared input's) is the whole loop's; it
        gives empty outputs and gradients, and keeps ``n - 1`` times the
        probe's kept bytes as a saved tensor until its backward (remat
        drops it in the first forward, as it drops the chunks' own)."""
        t = xs[0].shape[1]
        n = t // chunk
        bwd, kept = (StepTrace(), StepTrace()), 0
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (state, *xs, *consts)):
            bwd, kept = self._probe(fn, state, xs, consts, chunk)
        before = dataclasses.replace(
            self.trace, coll_by_op=dict(self.trace.coll_by_op),
            dtensor_coll_by_op=dict(self.trace.dtensor_coll_by_op))
        s, o = fn(state, *(x[:, :chunk] for x in xs), *consts)
        self._add(_since(self.trace, before), n - 1)
        rest = [x[:, c:c + chunk] for c in range(chunk, t, chunk)
                for x in xs]
        like = ((s.shape, s.dtype), (o.shape, o.dtype))
        res = _Skipped.apply(self, (n, bwd, kept, like), s, *rest,
                             *(consts * (n - 1)))
        return res[0], torch.cat([o, *res[1:]], dim=1)


def _since(now: StepTrace, before: StepTrace) -> StepTrace:
    """The FLOPs, bytes, ops and collectives counted from ``before`` to
    ``now``."""
    def grown(a: dict, b: dict) -> dict:
        return {k: v - b.get(k, 0.0) for k, v in a.items()
                if v != b.get(k, 0.0)}
    return StepTrace(
        flops=now.flops - before.flops,
        hbm_bytes=now.hbm_bytes - before.hbm_bytes,
        ops=now.ops - before.ops,
        coll_by_op=grown(now.coll_by_op, before.coll_by_op),
        dtensor_coll_by_op=grown(now.dtensor_coll_by_op,
                                 before.dtensor_coll_by_op))


class _Skipped(torch.autograd.Function):
    """The chunks :meth:`StepTracer.scan_once` does not run: empty outputs
    (the last state, then each chunk's output), and on the way back empty
    gradients for its inputs and the probe's backward terms counted once
    a skipped chunk (the last one's without the state's gradient where the
    last state has none)."""

    @staticmethod
    def forward(ctx, tracer, plan, s, *inputs):
        n, bwd, kept, ((s_shape, s_dtype), (o_shape, o_dtype)) = plan
        ctx.tracer, ctx.n, ctx.bwd = tracer, n, bwd
        ctx.like = [(t.shape, t.dtype) for t in (s, *inputs)]
        ctx.set_materialize_grads(False)
        dev = s.device
        ctx.save_for_backward(torch.empty(((n - 1) * kept,),
                                          dtype=torch.uint8, device=dev))
        return (torch.empty(s_shape, dtype=s_dtype, device=dev),
                *(torch.empty(o_shape, dtype=o_dtype, device=dev)
                  for _ in range(n - 1)))

    @staticmethod
    def backward(ctx, g_state, *g_outs):
        ctx.saved_tensors                     # the kept bytes, freed here
        mid, last = ctx.bwd
        ctx.tracer._add(mid, ctx.n - 2)
        ctx.tracer._add(last if g_state is None else mid, 1)
        dev = next(g.device for g in (g_state, *g_outs) if g is not None)
        return (None, None, *(
            torch.empty(shape, dtype=dtype, device=dev) if need else None
            for (shape, dtype), need in zip(ctx.like,
                                            ctx.needs_input_grad[2:])))
