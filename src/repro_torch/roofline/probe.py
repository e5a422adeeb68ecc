"""Corrected roofline terms: the port of ``repro.roofline.probe``.

The JAX package's ``compiled.cost_analysis()`` counts the body of every
``while`` loop once, whatever its trip count, so it lowers a step and one
layer group's body and assembles ``T_step + (G - 1) * T_group + (E - 1) *
T_enc`` plus an analytic extra for the token-level scans of the RWKV6 and
RG-LRU blocks.  The port's tracer (:mod:`.trace`) sees every iteration of
the Python layer loop (one block a layer) and of the recurrences' token
loops (``models/rwkv6.py``, ``models/rglru.py``): the traced step is
already the whole, so that correction is the identity
(``tests/test_torch_roofline.py`` shows a model of G layers traced whole
equal to G blocks' bodies plus the rest) and has no function here.  What
stays:

* the step is traced with ``microbatches=1`` (the same FLOPs); the deltas
  of the deploy step's gradient accumulation, weights re-read and
  re-gathered per microbatch, are the analytic :func:`mb_extra` column,
  not folded into the headline terms;
* under ``opt_attn``, :func:`attention_substitution` swaps the plain
  attention's traced terms for the flash kernel's (``kernels/attention/
  space.py``'s ``feature_math``, under ``h100sxm``): the plain
  formulation materialises the (tq × tk) scores; on the card a prefill's
  attention is the port's Hopper flash kernel, whose HBM traffic is q, k,
  v and the output.  This is where the TPU kernel's port enters the
  roofline.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.common import SHAPES
from ..distributed import sharding as shd
from .roofline import HW, CellReport, collective_bytes


@dataclasses.dataclass
class Terms:
    """Per-chip (flops, hbm bytes, collective bytes) of one artifact."""
    flops: float = 0.0
    hbm: float = 0.0
    coll: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o: "Terms") -> "Terms":
        ops = dict(self.coll_by_op)
        for k, v in o.coll_by_op.items():
            ops[k] = ops.get(k, 0.0) + v
        return Terms(self.flops + o.flops, self.hbm + o.hbm,
                     self.coll + o.coll, ops)

    def __mul__(self, c: float) -> "Terms":
        return Terms(self.flops * c, self.hbm * c, self.coll * c,
                     {k: v * c for k, v in self.coll_by_op.items()})

    __rmul__ = __mul__


def measure(trace) -> Terms:
    """Per-chip terms of a traced step (a ``StepTrace``)."""
    coll = collective_bytes(trace)
    return Terms(trace.flops, trace.hbm_bytes, coll["total"],
                 {k: v for k, v in coll.items() if k != "total"})


def _sdpa_policy_shardings(b, t, h, hkv, mesh):
    """Input specs matching attention._constrain_qkv's opt policy."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    tp = sizes.get("model", 1)
    batch = shd.batch_spec((b,), mesh)[0]
    if tp > 1 and h % tp == 0 and hkv % tp == 0:
        q = kv = (batch, None, "model", None)
    elif tp > 1 and t % tp == 0 and t > 1:
        q = (batch, "model", None, None)
        kv = (batch, None, None, None)
    else:
        q = kv = (batch, None, None, None)
    return q, kv


def trace_attention(cfg, b: int, t: int, mesh, *, train: bool,
                    window: int | None):
    """One layer's plain attention under the opt policy (the exact
    sub-expression a block runs: ``_constrain_qkv``, the chunked or whole
    softmax, the output constraint), traced on fake q, k and v placed on
    ``mesh``; with ``train``, forward, remat's recompute and backward.
    Returns the ``StepTrace``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint

    from ..models import attention as attn_lib
    from .trace import StepTracer

    h, dh = cfg.n_heads, cfg.d_head
    hkv = cfg.n_kv_heads * cfg.kv_repeat

    def sdpa_fn(q, k, v):
        q2, k2, v2, mode = attn_lib._constrain_qkv(q, k, v, opt=True)
        if t >= 2048:
            out = attn_lib._sdpa_chunked(q2, k2, v2, window=window,
                                         causal=True)
        else:
            bias = attn_lib._mask_bias(t, t, 0, window, True, q.device)
            out = attn_lib._sdpa(q2, k2, v2, bias)
        if mode == "heads":
            out = shd.constrain(out, ("pod", "data"), None, "model", None)
        elif mode == "seq":
            out = shd.constrain(out, ("pod", "data"), "model", None, None)
        return out

    q_sp, kv_sp = _sdpa_policy_shardings(b, t, h, hkv, mesh)
    device = torch.device(mesh.device_type)
    fake = FakeTensorMode()
    with fake:
        def make(shape, spec):
            x = shd.place(torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device), spec, mesh)
            return x.requires_grad_(train)

        q = make((b, t, h, dh), q_sp)
        k, v = (make((b, t, hkv, dh), kv_sp) for _ in range(2))
        ct = shd.place(torch.zeros((b, t, h, dh), dtype=torch.bfloat16,
                                   device=device), q_sp, mesh)
        tracer = StepTracer(fake_mode=fake, resident=[q, k, v, ct])
        with shd.use_mesh(mesh), tracer:
            if train:
                y = checkpoint(sdpa_fn, q, k, v, use_reentrant=False) \
                    if cfg.remat else sdpa_fn(q, k, v)
                torch.autograd.backward(y, ct)
            else:
                with torch.no_grad():
                    sdpa_fn(q, k, v)
    return tracer.result()


def attention_substitution(cfg, b: int, t: int, mesh, *, train: bool,
                           window: int | None, n_layers: int,
                           verbose: bool) -> Terms:
    """Per-layer delta: −(traced plain softmax chain) + (the port's Hopper
    flash kernel's traffic from the suite's own AttentionProblem cost
    features, under ``h100sxm``).

    The plain formulation materializes the (tq × tk) score tensor between
    ops — on the card that layer deploys as the tuned flash kernel
    (``csrc/flash_attention.cu``), whose HBM traffic is q/k/v/o.  The
    kernel's FLOPs are its tensor-core FLOPs (``tc_flops``, the traced
    FLOPs' convention: products only).  Only applied under ``opt_attn``
    (the baseline keeps the faithful plain trace)."""
    from ..kernels.attention.ops import DEFAULT_CONFIG
    from ..kernels.attention.space import AttentionProblem

    h, dh = cfg.n_heads, cfg.d_head
    hkv = cfg.n_kv_heads * cfg.kv_repeat
    chips = mesh.size()

    t_plain = measure(trace_attention(cfg, b, t, mesh, train=train,
                                      window=window))
    prob = AttentionProblem(shape={"hq": b * h, "hkv": b * hkv,
                                   "tq": t, "tk": t, "d": dh}, device="cpu")
    feats = prob.features(dict(DEFAULT_CONFIG), "h100sxm")
    fl = feats.tc_flops
    hb = feats.hbm_bytes
    if window and window < t // 2:      # local layers do ~t*w work
        scale = (2.0 * window) / t
        fl *= scale
        hb *= scale
    if train:                           # fwd + remat refwd + bwd
        fl *= 3.5
        hb *= 3.0
    t_flash = Terms(fl / chips, hb / chips, 0.0)

    delta = n_layers * (t_flash + (-1.0) * t_plain)
    if verbose:
        print(f"  [probe] sdpa swap x{n_layers}: plain "
              f"{t_plain.hbm / 1e9:.1f} GB -> flash {t_flash.hbm / 1e9:.2f} "
              f"GB per layer per chip", flush=True)
    return delta


def mb_extra(cfg, mesh, microbatches: int) -> Terms:
    """Analytic deltas of running the deploy step with gradient accumulation
    (k microbatches) instead of the probed k=1: weights are re-read from HBM
    and re-gathered over the FSDP axis (k-1) extra times."""
    if microbatches <= 1:
        return Terms()
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    chips = mesh.size()
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    n = cfg.param_count()
    param_bytes_chip = 2.0 * n / chips                     # bf16 shard
    # per extra microbatch: fwd + bwd re-read weights (~2x), FSDP re-gather
    gather = param_bytes_chip * (data - 1)                 # bytes received
    k = microbatches - 1
    return Terms(0.0, k * 2.0 * param_bytes_chip, k * gather,
                 {"all-gather": k * gather})


# ------------------------------------------------------------------ #
# assembly
# ------------------------------------------------------------------ #
def corrected_cell_terms(cfg, shape_name: str, mesh,
                         verbose: bool = True) -> dict:
    """Trace the cell's step at ``microbatches=1`` and return its per-chip
    terms with the attention substitution (under ``opt_attn``), and the
    breakdown: ``step``, each ``sdpa_swap_w{window}`` and ``mb_extra``."""
    from ..launch.steps import (WHISPER_DEC_LEN, lower_cell,
                                microbatch_count, plan_cell)

    cell = SHAPES[shape_name]
    kind = cell["kind"]
    b, s = cell["global_batch"], cell["seq_len"]

    plan = plan_cell(cfg, shape_name, mesh, microbatches=1)
    t_step = measure(lower_cell(plan, mesh))
    if verbose:
        print(f"  [probe] step: {t_step.flops/1e12:.3f} TF "
              f"{t_step.hbm/1e9:.2f} GB {t_step.coll/1e9:.3f} GBcoll",
              flush=True)
    breakdown = {"step": t_step}
    total = Terms() + t_step

    # decoder sequence length as seen by the blocks
    if cfg.frontend == "audio":
        t_dec = WHISPER_DEC_LEN if kind in ("train", "prefill") else 1
    else:
        t_dec = s if kind in ("train", "prefill") else 1

    if cfg.opt_attn and kind in ("train", "prefill") and t_dec >= 2048:
        windows: dict = {}
        for i in range(cfg.n_layers):
            spec = cfg.pattern[i % len(cfg.pattern)]
            if spec.kind == "attn":
                windows[spec.window] = windows.get(spec.window, 0) + 1
        for w, n_l in windows.items():
            delta = attention_substitution(
                cfg, b, t_dec, mesh, train=(kind == "train"), window=w,
                n_layers=n_l, verbose=verbose)
            breakdown[f"sdpa_swap_w{w}"] = delta
            total = total + delta

    mb = microbatch_count(cfg, shape_name, mesh)
    breakdown["mb_extra"] = mb_extra(cfg, mesh, mb) if kind == "train" \
        else Terms()
    return {"total": total, "breakdown": breakdown, "microbatches_deploy": mb}


def corrected_report(cfg, shape_name: str, mesh, *, arch: str,
                     mesh_name: str, model_flops_value: float,
                     verbose: bool = True) -> tuple[CellReport, dict]:
    """CellReport built from the corrected terms (+ the breakdown)."""
    res = corrected_cell_terms(cfg, shape_name, mesh, verbose=verbose)
    t: Terms = res["total"]
    report = CellReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        chips=mesh.size(),
        flops_per_chip=t.flops, hbm_bytes_per_chip=t.hbm,
        coll_bytes_per_chip=t.coll, coll_by_op=t.coll_by_op,
        peak_memory_per_chip=0.0,        # the deploy trace owns memory fit
        model_flops=model_flops_value,
        t_compute=t.flops / HW["peak_flops_bf16"],
        t_memory=t.hbm / HW["hbm_bw"],
        t_collective=t.coll / HW["link_bw"],
    )
    return report, res
