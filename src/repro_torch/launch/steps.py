"""Step builders: the train step per (arch, shape), with microbatched
gradient accumulation, and the input specs of each shape cell.

The port of ``repro.launch.steps``'s input specs and step builders.  A
step here runs eagerly on the model's device: where the JAX step takes
and returns a params tree, the port's updates the model's parameters in
place.  The dry run's planning and sharding (``CellPlan``,
``plan_cell``, ``lower_cell``) are not ported.
"""

from __future__ import annotations

import torch

from ..configs.common import SHAPES
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


def microbatch_count(cfg: ModelConfig, shape_name: str, dp: int = 1) -> int:
    """Pick gradient-accumulation depth so per-device saved activations
    (one residual a layer group) fit the budget; ``dp`` devices share the
    global batch (1 on one card).  It counts the residuals only, not one
    layer's attention scores, which the plain route keeps in the backward
    pass."""
    cell = SHAPES[shape_name]
    if cell["kind"] != "train":
        return 1
    b_loc = max(1, cell["global_batch"] // dp)
    s = cell["seq_len"] if cfg.frontend != "audio" else WHISPER_DEC_LEN
    n_groups = cfg.n_layers // len(cfg.pattern) + cfg.n_layers % len(cfg.pattern)
    n_groups += cfg.n_enc_layers
    resid = 2.5 * b_loc * s * cfg.d_model * 2.0 * n_groups
    k = 1
    while resid / k > ACT_BUDGET_BYTES and k < b_loc:
        k *= 2
    return min(k, b_loc)


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
            size = n // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=m.device)
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_mb, metrics = grads_of(m, mb)
                for k, p in params.items():
                    if p.grad is not None:
                        grads[k].add_(p.grad)
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


def make_prefill_step(model: Model):
    def prefill_step(m, batch):
        return m.prefill(batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(m, batch):
        return m.decode_step(batch["cache"], batch["token"],
                             batch["position"], enc_out=batch.get("enc_out"))
    return serve_step
