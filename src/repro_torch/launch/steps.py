"""The steps: train_step / prefill_step / serve_step per (arch, shape),
with microbatched gradient accumulation, sharding-aware input specs and
the dry run's cell planner.

The port of ``repro.launch.steps``.  A step here runs eagerly on the
model's device: where the JAX step takes and returns a params tree, the
port's updates the model's parameters in place.  A cell's plan
(:func:`plan_cell`) holds the same specs the JAX package's holds as
``NamedSharding``s; :func:`lower_cell` is not a compile but a trace: it
runs the step once on fake tensors (no storage), each rank's local shards
placed by the plan on a fake process group, under
:class:`repro_torch.roofline.trace.StepTracer`, and returns what the
roofline reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from ..configs.common import SHAPES
from ..distributed import sharding as shd
from ..models import Model, ModelConfig, build_model
from ..serve.decode import ENC_OUT_LEN
from ..train.optimizer import OptimizerConfig, apply_updates

ACT_BUDGET_BYTES = 3.5e9      # per-device activation budget for microbatching
WHISPER_DEC_LEN = 448


# ------------------------------------------------------------------ #
# input specs ((shape, dtype) pairs — never allocated)
# ------------------------------------------------------------------ #
def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Model inputs for one shape cell as ``(shape, torch dtype)`` pairs
    (the decode cache as a list, one entry a layer, of such pairs)."""
    cell = SHAPES[shape_name]
    b, s, kind = cell["global_batch"], cell["seq_len"], cell["kind"]
    f32, i32 = torch.float32, torch.int32

    if kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            # seq_len applies to encoder frames; decoder runs its arch length
            t_dec = WHISPER_DEC_LEN
            batch = {"frames": ((b, s, cfg.d_model), f32),
                     "tokens": ((b, t_dec), i32)}
            if kind == "train":
                batch["labels"] = ((b, t_dec), i32)
            return batch
        if cfg.frontend == "vision":
            t_text = s - cfg.n_patches
            batch = {"patches": ((b, cfg.n_patches, cfg.d_model), f32),
                     "tokens": ((b, t_text), i32)}
            if kind == "train":
                batch["labels"] = ((b, t_text), i32)
            return batch
        batch = {"tokens": ((b, s), i32)}
        if kind == "train":
            batch["labels"] = ((b, s), i32)
        return batch

    # decode: one new token against a seq_len cache, built on the meta
    # device (no storage)
    cache = build_model(cfg).init_cache(b, s)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(spec(v) for v in tree)
        return (tuple(tree.shape), tree.dtype)

    batch = {"token": ((b, 1), i32), "position": ((), i32),
             "cache": spec(cache)}
    if cfg.frontend == "audio":
        batch["enc_out"] = ((b, ENC_OUT_LEN, cfg.d_model), torch.bfloat16)
    return batch


def microbatch_count(cfg: ModelConfig, shape_name: str, mesh=None, *,
                     dp: int | None = None) -> int:
    """Pick gradient-accumulation depth so per-device saved activations
    (one residual a layer group) fit the budget; the global batch is
    shared by the mesh's data-parallel extent (pod x data; 1 without a
    mesh, or ``dp`` where given).  It counts the residuals only, not one
    layer's attention scores, which the plain route keeps in the backward
    pass."""
    cell = SHAPES[shape_name]
    if cell["kind"] != "train":
        return 1
    if dp is None:
        dp = _dp_extent(mesh)
    b_loc = max(1, cell["global_batch"] // dp)
    s = cell["seq_len"] if cfg.frontend != "audio" else WHISPER_DEC_LEN
    n_groups = cfg.n_layers // len(cfg.pattern) + cfg.n_layers % len(cfg.pattern)
    n_groups += cfg.n_enc_layers
    resid = 2.5 * b_loc * s * cfg.d_model * 2.0 * n_groups
    k = 1
    while resid / k > ACT_BUDGET_BYTES and k < b_loc:
        k *= 2
    return min(k, b_loc)


def _dp_extent(mesh) -> int:
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _microbatch(x, i: int, k: int):
    """Microbatch ``i`` of ``k`` of ``x`` on its leading axis.  A DTensor
    is cut on each rank's local rows (its ``i``-th ``1/k``), so every
    microbatch spans the data-parallel ranks as the global batch does;
    rows are grouped differently from the single-device cut but the
    summed gradients are the same."""
    if isinstance(x, DTensor):
        loc = x.to_local()
        size = loc.shape[0] // k
        return shd.from_local(loc[i * size:(i + 1) * size], x.device_mesh,
                              x.placements, (x.shape[0] // k, *x.shape[1:]))
    size = x.shape[0] // k
    return x[i * size:(i + 1) * size]


# ------------------------------------------------------------------ #
# step builders
# ------------------------------------------------------------------ #
def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``: the loss
    and its gradients over ``batch`` (tensors or numpy arrays, split on
    the leading axis into ``microbatches``), then one AdamW update of the
    model's parameters in place.  With several microbatches each one's
    grads are summed into f32 buffers and divided by the count, as the JAX
    step's ``acc_body`` does, and the loss is their mean.  ``metrics`` are
    the last microbatch's ``train_loss`` metrics plus ``grad_norm``,
    ``lr`` and ``loss``, scalar tensors on the device."""

    def grads_of(m, mb):
        m.zero_grad(set_to_none=True)
        loss, metrics = m.train_loss(mb)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(m, opt_state, batch):
        params = dict(m.named_parameters())
        if microbatches == 1:
            loss, metrics = grads_of(m, batch)
            grads = {k: p.grad for k, p in params.items()}
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{microbatches} microbatches")
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=m.device)
            for i in range(microbatches):
                mb = {k: _microbatch(v, i, microbatches)
                      for k, v in batch.items()}
                l_mb, metrics = grads_of(m, mb)
                for k, p in params.items():
                    if p.grad is not None:
                        grads[k].add_(_like(p.grad, grads[k]))
                loss = loss + l_mb
            m.zero_grad(set_to_none=True)
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
        _, opt_state, opt_metrics = apply_updates(opt_cfg, params, opt_state,
                                                  grads)
        del grads
        m.zero_grad(set_to_none=True)
        return opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def _like(g, acc):
    """Gradient ``g`` in the placements of its accumulator ``acc`` (a
    pending sum reduced) where both are DTensors; else ``g``."""
    if isinstance(g, DTensor) and g.placements != acc.placements:
        return shd.redistribute(g, acc.placements)
    return g


def make_prefill_step(model: Model):
    def prefill_step(m, batch):
        return m.prefill(batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(m, batch):
        return m.decode_step(batch["cache"], batch["token"],
                             batch["position"], enc_out=batch.get("enc_out"))
    return serve_step


# ------------------------------------------------------------------ #
# sharding assembly for one (arch, shape, mesh) cell
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class CellPlan:
    """Everything needed to trace one dry-run cell: the model (on the meta
    device), the step, its abstract args (meta parameters, and ``(shape,
    dtype)`` pairs for the optimizer state and the batch) and their specs
    (one per leaf, the JAX plan's ``PartitionSpec``s as tuples)."""
    model: Model
    step_fn: Any
    args: tuple                     # abstract args
    in_shardings: tuple
    out_shardings: Any
    kind: str
    microbatches: int = 1
    opt_cfg: OptimizerConfig | None = None


def optimize_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """Beyond-paper SPMD plan (EXPERIMENTS.md §Perf): explicit attention
    sharding, kv-head replication to TP, scatter cache updates."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    tp = sizes.get("model", 1)
    r = 1
    if (tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv_heads < tp
            and tp % cfg.n_kv_heads == 0):
        cand = tp // cfg.n_kv_heads
        if (cfg.n_heads // cfg.n_kv_heads) % cand == 0:
            r = cand
    return dataclasses.replace(cfg, opt_attn=True,
                               opt_scatter_cache=True, kv_repeat=r)


def _abstract(tree):
    """``(shape, dtype)`` leaves of a tree of tensors."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_abstract(v) for v in tree)
    return (tuple(tree.shape), tree.dtype)


def plan_cell(cfg: ModelConfig, shape_name: str, mesh,
              opt_cfg: OptimizerConfig | None = None,
              microbatches: int | None = None,
              optimized: bool = False,
              global_batch: int | None = None) -> CellPlan:
    """The plan of one cell; ``global_batch`` overrides the cell's (a
    train or prefill cell cut in batch)."""
    if optimized:
        cfg = optimize_config(cfg, mesh)
    model = build_model(cfg)                  # meta tensors: no storage
    kind = SHAPES[shape_name]["kind"]
    abstract_params = dict(model.named_parameters())
    p_shard = shd.param_shardings(abstract_params, model.param_axes(), mesh)
    batch = input_specs(cfg, shape_name)
    if global_batch is not None and kind != "decode":
        batch = {k: ((global_batch, *shape[1:]), dtype)
                 for k, (shape, dtype) in batch.items()}

    if kind == "train":
        opt_cfg = opt_cfg or OptimizerConfig()
        mb = microbatches or microbatch_count(cfg, shape_name, mesh)
        opt_abs = {"step": ((), torch.int32),
                   **{part: {k: (tuple(p.shape), torch.float32)
                             for k, p in abstract_params.items()}
                      for part in ("m", "v", "master")}}
        if opt_cfg.compress_grads:
            opt_abs["ef"] = dict(opt_abs["m"])
        o_shard = _opt_shardings(opt_abs, p_shard, mesh)
        b_shard = {k: shd.batch_spec(v[0], mesh) for k, v in batch.items()}
        step = make_train_step(model, opt_cfg, mb)
        out_shardings = (p_shard, o_shard, None)
        return CellPlan(model, step, (abstract_params, opt_abs, batch),
                        (p_shard, o_shard, b_shard), out_shardings, kind, mb,
                        opt_cfg)

    if kind == "prefill":
        b_shard = {k: shd.batch_spec(v[0], mesh) for k, v in batch.items()}
        step = make_prefill_step(model)
        return CellPlan(model, step, (abstract_params, batch),
                        (p_shard, b_shard), None, kind)

    # decode
    cell = SHAPES[shape_name]
    cache = build_model(cfg).init_cache(cell["global_batch"],
                                        cell["seq_len"])
    batch["cache"] = _abstract(cache)
    cache_sh = shd.cache_shardings(cache, mesh, n_kv_heads=cfg.n_kv_heads,
                                   batch=cell["global_batch"])
    b_shard = {
        "token": shd.batch_spec(batch["token"][0], mesh, seq_axis=None),
        "position": shd.replicated(mesh),
        "cache": cache_sh,
    }
    if "enc_out" in batch:
        b_shard["enc_out"] = shd.batch_spec(batch["enc_out"][0], mesh)
    step = make_serve_step(model)
    out_shardings = (None, cache_sh)
    return CellPlan(model, step, (abstract_params, batch),
                    (p_shard, b_shard), out_shardings, kind)


def _opt_shardings(opt_abs, p_shard, mesh):
    """Optimizer-state sharding mirrors the param sharding (ZeRO style)."""
    rep = shd.replicated(mesh)

    def like(subtree):
        return {k: p_shard[k] for k in subtree}

    out = {"step": rep, "m": like(opt_abs["m"]), "v": like(opt_abs["v"]),
           "master": like(opt_abs["master"])}
    if "ef" in opt_abs:
        out["ef"] = like(opt_abs["ef"])
    return out


def _fake_leaves(abstract, specs, mesh, device):
    """A tree of ``(shape, dtype)`` leaves as zero tensors of the ambient
    (fake) mode placed by ``specs``."""
    if isinstance(abstract, dict):
        return {k: _fake_leaves(v, specs[k], mesh, device)
                for k, v in abstract.items()}
    if isinstance(abstract, list) or (isinstance(abstract, tuple) and not (
            len(abstract) == 2 and isinstance(abstract[1], torch.dtype))):
        return type(abstract)(_fake_leaves(v, s, mesh, device)
                              for v, s in zip(abstract, specs))
    shape, dtype = abstract
    x = torch.zeros(shape, dtype=dtype, device=device)
    return x if mesh is None else shd.place(x, specs, mesh)


def lower_cell(plan: CellPlan, mesh, device=None, once: bool = True):
    """Trace one step of the cell under its mesh (a ``DeviceMesh``, on a
    fake process group for the dry run): parameters, optimizer state and
    batch are fake tensors (no storage) placed by the plan, each rank's
    local shard of the plan's shape, and the step runs once under
    :class:`~repro_torch.roofline.trace.StepTracer`, which counts this
    rank's local work.  With ``mesh`` None (one chip) they are whole fake
    tensors on ``device`` (default the CPU), unplaced.  Returns the
    tracer's :class:`~repro_torch.roofline.trace.StepTrace` (nothing is
    compiled or donated: the step updates the parameters in place).
    ``once`` False traces every token of the recurrences, which the tracer
    otherwise traces one chunk for all, to the same terms."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..roofline.trace import StepTracer
    from ..train.optimizer import init_opt_state

    device = torch.device(mesh.device_type if mesh is not None
                          else device or "cpu")
    fake = FakeTensorMode()
    with fake:
        model = plan.model
        for name, p in list(model.named_parameters()):
            shd.set_param(model, name, torch.empty(p.shape, dtype=p.dtype,
                                                   device=device))
        if mesh is not None:
            shd.place_params(model, plan.in_shardings[0], mesh)
        params = dict(model.named_parameters())
        batch = _fake_leaves(plan.args[-1], plan.in_shardings[-1], mesh,
                             device)
        if plan.kind == "train":
            opt_state = init_opt_state(plan.opt_cfg, params)
            args = [opt_state, batch]
        else:
            args = [batch]
        tracer = StepTracer(fake_mode=fake, resident=[params, *args],
                            once=once)
        with (shd.use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()), tracer:
            plan.step_fn(model, *args)
    return tracer.result()
