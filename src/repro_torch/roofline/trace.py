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
  JAX package's convention on its HLO text; the pipeline's stage permute
  is counted once by :func:`note_collective`.
* **Peak memory** — the high-water mark of live local storage: the
  step's resident arguments (parameters, optimizer state, batch) plus
  every storage an op creates, until it is freed.

DTensor's sharding propagation runs each op on global-shape fake tensors
to learn the output's shape: those ops are not the rank's work and are
skipped.  On real tensors they are the fake tensors (and on the meta
device, meta ones); under the step's own fake mode, which the propagation
reuses, they are the ops dispatched from within DTensor's sharding
propagator (found on the Python stack; only ops on tensors this tracer
has not seen made, factories included, are looked up).
"""

from __future__ import annotations

import contextvars
import dataclasses
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
    bytes by opcode; the resident and peak bytes; ops counted and
    skipped; the trace's seconds on the host."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
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


def note_collective(op: str, result: torch.Tensor) -> None:
    """Count a collective the dispatcher does not show (a point-to-point
    transfer) under ``op``, its result's bytes, in the active tracer."""
    tracer = _ACTIVE.get()
    if tracer is not None:
        tracer._coll(op, _nbytes(result))


class StepTracer(TorchDispatchMode):
    """Counts one rank's local work while active (see the module's
    conventions).  ``fake_mode``: the fake mode the step's own tensors
    belong to (None for real tensors); ``resident``: trees of the tensors
    (DTensors: their local shards) alive through the step, the base of
    the peak."""

    def __init__(self, fake_mode=None, resident=()):
        super().__init__()
        self.fake_mode = fake_mode
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

    def _coll(self, op: str, nbytes: float) -> None:
        by = self.trace.coll_by_op
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
        if self.fake_mode is None or (ins and all(
                id(t.untyped_storage()) in self._seen for t in ins)):
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
                self._coll(COLLECTIVES[name], sum(_nbytes(t) for t in outs))
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
