"""The port's distribution on gloo ranks of the host against the JAX
package: a train step of the reduced qwen3-8b sharded over a 4x2 (data,
model) mesh against the JAX package's single-device step (its sharded
test, ``test_multidevice::test_sharded_train_step_runs_and_matches_
single_device``, fails on jax 0.9.0, so the single-device step is the
anchor, with that test's bounds); a checkpoint saved on 4x2 restored on
2x4 (``test_elastic_checkpoint_across_mesh_shapes``); GPipe on a (4, 2)
(stage, data) mesh against the serial composition and ``jax.grad`` of its
loss; a (pod, data) shard's rows; a sharded ``TrainLoop`` preempted and
resumed against an uninterrupted one.

Each job runs its ranks as subprocesses with a timeout
(``tests/torch_dist.py``): a process group never outlives its test.  The
8-rank job and the 4-rank job each serve several tests (module-scoped
fixtures), so the ranks' start (``import torch``) is paid twice.

Tolerances: the sharded step sums its products in another order than one
device (a contraction split over ranks), so a bf16 rounding flips here
and there, as between the port and the JAX package on one device; the
JAX test's 5e-2 on the loss and on every parameter (max abs) is kept,
and each parameter's Adam ``m`` and f32 master, and the gradient norm,
are held to the training gradients' bound, 5e-2 rel-L2 (``GRAD_TOL``,
``tests/test_torch_train_grads.py``; 2.0e-2 measured), and the gradient
norm to ``tests/test_torch_train_step.py``'s 5e-3 rel (1.6e-4 measured).
The step runs at ``lr`` 1e-2 with
one warmup step, as ``tests/test_torch_train_step.py`` does.
GPipe runs the same f32 ops per stage as the serial composition: 2e-5 on
the outputs (the JAX test's), 1e-4 on each stage's gradient.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch_dist import REPO, run_ranks  # noqa: E402
from torch_lm import as_numpy, jax_model, rel_l2  # noqa: E402

from repro_torch.distributed.pipeline import (bubble_fraction,  # noqa: E402
                                              stage_permutation)
from repro_torch.models.convert import from_jax_params  # noqa: E402

STEP_TOL = 5e-2
GRAD_TOL, NORM_TOL = 5e-2, 5e-3
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=3)
PIPE_TOL, PIPE_GRAD_TOL = 2e-5, 1e-4
REGION_TOL = 1e-5
S, NM, MB, D = 4, 8, 4, 16

EIGHT = """
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

inputs = torch.load(tmp + "/inputs.pt")
OPT = inputs["opt"]
R = inputs["regions"]
FAMILIES = inputs["families"]


def sharded_grads(arch, mesh):
    # the reduced arch's loss and every parameter's gradient (whole) on
    # the test's weights and batch, its parameters placed by their specs
    c = reduce_config(ARCHS[arch])
    m = build_model(c)
    m.to_empty(device="cpu")
    m.load_state_dict(FAMILIES[arch]["state"])
    shd.place_params(m, shd.param_shardings(
        dict(m.named_parameters()), m.param_axes(), mesh), mesh)
    batch = {k: shd.place(v, shd.batch_spec(tuple(v.shape), mesh), mesh)
             for k, v in FAMILIES[arch]["batch"].items()}
    with shd.use_mesh(mesh):
        loss, _ = m.train_loss(batch)
        loss.backward()
    return {"loss": float(loss.detach().full_tensor()),
            "grads": {k: p.grad.full_tensor() for k, p in
                      m.named_parameters() if p.grad is not None}}


def run_regions(mesh):
    # RoPE, the RMS norm and the shared-input products under mesh, on the
    # test's inputs placed by each case's specs: every output and every
    # input's gradient (for the test's cotangents), whole
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.attention import _mla_keys
    from repro_torch.models.layers import apply_rope, einsum_shared, rms_norm
    from repro_torch.models.moe import _route_sharded
    from repro_torch.models.rwkv6 import _projections
    RWKV = ("shift_mix", "w_bias", "rwkv_wr", "rwkv_wk", "rwkv_wv",
            "rwkv_ww", "rwkv_wg")

    def region(fn, args, specs, cots):
        ds = [shd.place(a, sp, mesh).requires_grad_(True)
              for a, sp in zip(args, specs)]
        with shd.use_mesh(mesh):
            ys = fn(*ds)
            ys = list(ys) if isinstance(ys, (list, tuple)) else [ys]
            fs = [y for y in ys if y.is_floating_point()]
            torch.autograd.backward(fs, [distribute_tensor(
                c, mesh, y.placements, src_data_rank=None)
                for y, c in zip(fs, cots)])
        return {"outs": [y.detach().full_tensor() for y in ys],
                "grads": [d.grad.full_tensor() for d in ds]}

    def rope(x):
        return apply_rope(x, R["pos"], R["theta"])

    def spec(name):
        return shd.spec_for(tuple(R[name].shape), R["axes"][name], mesh)

    def rwkv(x, xp, *ws):
        names = ("shift_mix", "w_bias", "wr", "wk", "wv", "ww", "wg")
        return _projections(dict(zip(names, ws)), x, xp)

    proj = "btd,dhk->bthk"
    return {
        "rope_heads": region(rope, [R["x"]], [("data", None, "model", None)],
                             [R["cot_x"]]),
        "rope_head_dim": region(rope, [R["x"]],
                                [("data", None, None, "model")],
                                [R["cot_x"]]),
        "rope_gathered": region(rope, [R["x"]],
                                [(None, None, None, ("data", "model"))],
                                [R["cot_x"]]),
        "norm_residual": region(rms_norm, [R["xr"], R["wr"]],
                                [("data", None, None), ("data",)],
                                [R["cot_xr"]]),
        "norm_head_dim": region(rms_norm, [R["xk"], R["wd"]],
                                [("data", None, None, "model"), ("model",)],
                                [R["cot_xk"]]),
        "norm_heads": region(rms_norm, [R["x"], R["wd"]],
                             [("data", None, "model", None), ("model",)],
                             [R["cot_x"]]),
        "shared": region(
            lambda x, q, k, v, z: einsum_shared(
                x, (proj, q), (proj, k), (proj, v), ("btd,de->bte", z)),
            [R[n] for n in ("xr", "wq", "wk", "wv", "wz")],
            [("data", None, None)] + [spec(n) for n in ("wq", "wk", "wv")]
            + [("model", "data")],
            [R[n] for n in ("cot_q", "cot_k", "cot_v", "cot_z")]),
        "moe_route": region(lambda lg: _route_sharded(lg, 2), [R["lg"]],
                            [("data", None, "model")],
                            [R["cot_gv"], R["cot_aux"]]),
        "mla_keys": region(_mla_keys, [R["kn"], R["kp"]],
                           [("data", None, "model", None),
                            ("data", None, None, "model")], [R["cot_kf"]]),
        "move_shard": region(
            lambda t: shd.redistribute(t, shd.placements(
                (None, None, None, "model"), mesh)), [R["x"]],
            [(None, None, "model", None)], [R["cot_x"]]),
        "rwkv_projections": region(
            rwkv, [R[n] for n in ("xr", "xp", *RWKV)],
            [("data", None, None), ("data", None, None)]
            + [spec(n) for n in RWKV], [R["cot_xr"]] * 5),
    }


# a train step of the reduced qwen3-8b on a 4x2 and a 2x4 mesh (on 2x4
# TP does not divide the 2 kv heads: k and v shard their head dim)
cfg = reduce_config(ARCHS["qwen3-8b"])
for shape in ((4, 2), (2, 4)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = build_model(cfg)
    model.to_empty(device="cpu")
    model.load_state_dict(inputs["qwen3"])
    specs = shd.param_shardings(dict(model.named_parameters()),
                                model.param_axes(), mesh)
    shd.place_params(model, specs, mesh)
    opt_cfg = OptimizerConfig(**OPT)
    opt = init_opt_state(opt_cfg, dict(model.named_parameters()))
    batch = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=8)).batch_at(0)
    batch = {k: shd.place(torch.as_tensor(v), shd.batch_spec(v.shape, mesh),
                          mesh) for k, v in batch.items()}
    with shd.use_mesh(mesh):
        opt, metrics = make_train_step(model, opt_cfg, 1)(model, opt, batch)
    key = "x".join(map(str, shape))
    whole = lambda d: {k: t.detach().full_tensor() for k, t in d.items()}
    regions = run_regions(mesh)
    families = {arch: sharded_grads(arch, mesh) for arch in FAMILIES
                if key in FAMILIES[arch]["meshes"]}
    out[key] = {
        "loss": float(metrics["loss"].full_tensor()),
        "grad_norm": float(getattr(metrics["grad_norm"], "full_tensor",
                                   lambda: metrics["grad_norm"])()),
        # every rank's whole view: replicas that drifted apart differ here
        "params": whole(dict(model.named_parameters())),
        "master": whole(opt["master"]), "m": whole(opt["m"]),
        "placements": {k: str(p.placements)
                       for k, p in model.named_parameters()},
        "local": {k: tuple(p.to_local().shape)
                  for k, p in model.named_parameters()},
        "regions": regions, "families": families}
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))

# a checkpoint of the reduced qwen3-14b saved on 4x2, restored on 2x4
cfg14 = reduce_config(ARCHS["qwen3-14b"])
m14 = build_model(cfg14).init(0, "cpu")
shd.place_params(m14, shd.param_shardings(dict(m14.named_parameters()),
                                          m14.param_axes(), mesh), mesh)
ckpt.save(tmp + "/ck", 3, m14.state_dict())
mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
like = dict(build_model(cfg14).named_parameters())
sh2 = shd.param_shardings(like, m14.param_axes(), mesh2)
p2, _ = ckpt.restore(tmp + "/ck", like, shardings=sh2, mesh=mesh2)
out["elastic_equal"] = all(
    torch.equal(p2[k].full_tensor(), p.full_tensor())
    for k, p in m14.named_parameters())
out["elastic_moved"] = sum(
    str(p2[k].placements) != str(p.placements)
    for k, p in m14.named_parameters())

# GPipe over (stage, data)
pmesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("stage", "data"))
ws = inputs["ws"].clone().requires_grad_(True)
apply = pipeline_apply(lambda w, x: torch.tanh(x @ w), pmesh, axis="stage")
y = apply(ws, inputs["x"])
(y ** 2).sum().backward()
stage = pmesh.get_local_rank("stage")
out["gpipe"] = {"y": y.detach(), "stage": stage,
                "grad": ws.grad[stage].clone(),
                "others": float(ws.grad.abs().sum() - ws.grad[stage].abs().sum())}
"""


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """The 8-rank job's ranks' outputs and its JAX references."""
    tmp = tmp_path_factory.mktemp("eight")
    cfg, model, params = jax_model("qwen3-8b")
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((NM, MB, D)).astype(np.float32)
    regions = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in _region_inputs().items()}
    torch.save({"qwen3": from_jax_params(cfg, as_numpy(params)), "opt": OPT,
                "ws": torch.from_numpy(ws), "x": torch.from_numpy(x),
                "regions": regions,
                "families": {a: _family_inputs(a) for a in FAMILIES}},
               tmp / "inputs.pt")
    outs = run_ranks(EIGHT, 8, tmp)
    return outs, (cfg, model, params), (ws, x)


def _region_inputs() -> dict:
    """The region checks' inputs, f32 from a seed: ``x`` (4, 8, 4, 16) as
    q (4 heads of 16), ``xk`` (4, 8, 2, 16) as k, ``xr`` (4, 8, 64) as the
    residual, the norm weights ``wr`` (64) and ``wd`` (16), the
    projections ``wq``, ``wk``, ``wv`` (placed by ``spec_for`` of their
    logical ``axes``, as the model's) and ``wz`` (64, 32); router logits
    ``lg`` (4 groups of 8 tokens, 8 experts); MLA's ``kn`` (4 heads of 16)
    and ``kp`` (one RoPE key of 8); RWKV-6's ``xp`` (the shifted ``xr``),
    mixes, decay bias and five projections; and a cotangent for each
    float output."""
    rng = np.random.default_rng(1)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r = {"x": n(4, 8, 4, 16), "xk": n(4, 8, 2, 16), "xr": n(4, 8, 64),
         "wr": 1 + 0.1 * n(64), "wd": 1 + 0.1 * n(16),
         "wq": n(64, 4, 16) / 8, "wk": n(64, 2, 16) / 8,
         "wv": n(64, 2, 16) / 8, "wz": n(64, 32) / 8,
         "pos": np.arange(8, dtype=np.int64)[None] + 3, "theta": 1e4,
         "lg": n(4, 8, 8), "kn": n(4, 8, 4, 16), "kp": n(4, 8, 1, 8),
         "xp": n(4, 8, 64), "shift_mix": n(5, 64), "w_bias": n(64),
         **{f"rwkv_{w}": n(64, 64) / 8
            for w in ("wr", "wk", "wv", "ww", "wg")},
         "axes": {"wq": ("embed", "heads", "head_dim"),
                  "wk": ("embed", "kv_heads", "head_dim"),
                  "wv": ("embed", "kv_heads", "head_dim"),
                  "shift_mix": (None, "embed"), "w_bias": ("heads_flat",),
                  **{f"rwkv_{w}": ("embed", "heads_flat")
                     for w in ("wr", "wk", "wv", "ww", "wg")}}}
    r.update({"cot_x": n(4, 8, 4, 16), "cot_xk": n(4, 8, 2, 16),
              "cot_xr": n(4, 8, 64), "cot_q": n(4, 8, 4, 16),
              "cot_k": n(4, 8, 2, 16), "cot_v": n(4, 8, 2, 16),
              "cot_z": n(4, 8, 32), "cot_gv": n(4, 8, 2),
              "cot_aux": n(), "cot_kf": n(4, 8, 4, 24)})
    return r


def _region_reference(case: str, r: dict, lib: str):
    """``case``'s outputs and input gradients (for its cotangents) by the
    unsharded functions: the JAX package's (``lib`` "jax", ``jax.vjp``) or
    the port's on plain tensors (``lib`` "torch")."""
    proj = "btd,dhk->bthk"
    rwkv = ["xr", "xp", "shift_mix", "w_bias"] + [
        f"rwkv_{w}" for w in ("wr", "wk", "wv", "ww", "wg")]
    if case.startswith("rope"):
        names, cots = ["x"], ["cot_x"]
    elif case == "moe_route":
        names, cots = ["lg"], ["cot_gv", "cot_aux"]
    elif case == "mla_keys":
        names, cots = ["kn", "kp"], ["cot_kf"]
    elif case == "move_shard":
        names, cots = ["x"], ["cot_x"]
    elif case == "rwkv_projections":
        names, cots = rwkv, ["cot_xr"] * 5
    elif case == "norm_residual":
        names, cots = ["xr", "wr"], ["cot_xr"]
    elif case == "norm_head_dim":
        names, cots = ["xk", "wd"], ["cot_xk"]
    elif case == "norm_heads":
        names, cots = ["x", "wd"], ["cot_x"]
    else:
        names = ["xr", "wq", "wk", "wv", "wz"]
        cots = ["cot_q", "cot_k", "cot_v", "cot_z"]
    if lib == "jax":
        from repro.models import layers as L
        from repro.models import rwkv6 as W
        ein, xp = jnp.einsum, jnp
        args = [jnp.asarray(r[k]) for k in names]
    else:
        from repro_torch.models import layers as L
        from repro_torch.models import rwkv6 as W
        ein, xp = torch.einsum, None
        args = [torch.from_numpy(r[k]).requires_grad_(True) for k in names]
    if case.startswith("rope"):
        pos = jnp.asarray(r["pos"]) if lib == "jax" else \
            torch.from_numpy(r["pos"])
        fn = lambda x: [L.apply_rope(x, pos, r["theta"])]  # noqa: E731
    elif case.startswith("norm"):
        fn = lambda x, w: [L.rms_norm(x, w)]  # noqa: E731
    elif case == "moe_route":
        if lib == "jax":
            fn = _route_jax
        else:
            from repro_torch.models.moe import _route
            fn = lambda lg: list(_route(lg, 2))  # noqa: E731
    elif case == "move_shard":
        fn = lambda x: [x * 1]  # noqa: E731
    elif case == "mla_keys":
        def fn(kn, kp):
            full = (*kp.shape[:2], kn.shape[2], kp.shape[-1])
            if lib == "jax":
                return [xp.concatenate([kn, xp.broadcast_to(kp, full)], -1)]
            return [torch.cat([kn, kp.expand(*full)], dim=-1)]
    elif case == "rwkv_projections":
        def fn(x, x_prev, *ws):
            names = ("shift_mix", "w_bias", "wr", "wk", "wv", "ww", "wg")
            return list(W._projections(dict(zip(names, ws)), x, x_prev))
    else:
        fn = lambda x, q, k, v, z: [ein(proj, x, q), ein(proj, x, k),  # noqa
                                    ein(proj, x, v),
                                    ein("btd,de->bte", x, z)]
    if lib == "jax":
        if case == "moe_route":
            (gv, aux), vjp, idx = jax.vjp(fn, *args, has_aux=True)
            outs = [gv, idx, aux]
        else:
            outs, vjp = jax.vjp(fn, *args)
        grads = vjp([jnp.asarray(r[c]) for c in cots])
        return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]
    outs = fn(*args)
    torch.autograd.backward([o for o in outs if o.is_floating_point()],
                            [torch.from_numpy(r[c]) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [a.grad.numpy() for a in args])



def _route_jax(lg, k=2):
    """The JAX package's routing (``repro.models.moe.moe_ffn``'s lines)."""
    e = lg.shape[-1]
    probs = jax.nn.softmax(lg, axis=-1)
    gv, idx = jax.lax.top_k(probs, k)
    gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
    me = probs.mean(axis=(0, 1))
    ce = jax.nn.one_hot(idx[..., 0], e).mean(axis=(0, 1))
    return [gv, e * jnp.sum(me * ce)], idx


#: families whose whole sharded step is held to one device here, and the
#: meshes each runs on: RG-LRU's shared products and decay
#: (recurrentgemma) and whisper's shared cross-attention k and v.  The
#: MoE and MLA families (their routing and keys) and RWKV-6 (its
#: token-shift products) are held region by region
#: (``test_the_regions_compute_what_the_unsharded_functions_do``): their
#: whole sharded steps differ from one device by more than bf16 rounding
#: on the parent tree as here (ROADMAP queue 3)
FAMILIES = {"recurrentgemma-9b": ("4x2", "2x4"),
            "whisper-medium": ("4x2", "2x4")}


def _family_inputs(arch: str) -> dict:
    """The reduced ``arch``'s weights from seed 0 and a batch of 8
    sequences of 16 tokens (some labels masked), with its frames, from a
    numpy seed."""
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    cfg = reduce_config(ARCHS[arch])
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int64)
             for k in ("tokens", "labels")}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32)
    return {"state": build_model(cfg).init(0, "cpu").state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "meshes": FAMILIES[arch]}


@pytest.mark.parametrize("mesh,arch", [(m, a) for a, ms in FAMILIES.items()
                                       for m in ms])
def test_each_familys_sharded_loss_and_grads_match_one_device(eight, mesh,
                                                              arch):
    """The reduced ``arch``'s loss and every parameter's gradient under the
    mesh (its regions: RG-LRU's shared gate products and decay, whisper's
    shared cross-attention k and v, and every block's RoPE, norms and
    q/k/v) against the port's unsharded model on the same weights and batch,
    which ``tests/test_torch_train_grads.py`` holds to the JAX package's:
    within that file's bounds (``tests/torch_train.py``: the loss 2e-3
    relative, each gradient 5e-2 rel-L2), since the sharded products sum
    in another order and round their bf16 partial sums apart."""
    from torch_train import GRAD_TOL, LOSS_TOL

    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    outs, _, _ = eight
    got = outs[0][mesh]["families"][arch]
    inputs = _family_inputs(arch)
    ref = build_model(reduce_config(ARCHS[arch]))
    ref.to_empty(device="cpu")
    ref.load_state_dict(inputs["state"])
    loss, _ = ref.train_loss(inputs["batch"])
    loss.backward()
    want = float(loss.detach())
    assert abs(got["loss"] - want) <= LOSS_TOL * abs(want), (got["loss"],
                                                            want)
    named = dict(ref.named_parameters())
    assert sorted(got["grads"]) == sorted(
        k for k, p in named.items() if p.grad is not None)
    for k, g in got["grads"].items():
        err = rel_l2(g.float().numpy(), named[k].grad.float().numpy())
        assert err <= GRAD_TOL, (k, err)


REGION_CASES = ("rope_heads", "rope_head_dim", "rope_gathered",
                "norm_residual", "norm_head_dim", "norm_heads", "shared",
                "moe_route", "mla_keys", "move_shard", "rwkv_projections")


@pytest.mark.parametrize("case", REGION_CASES)
@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_the_regions_compute_what_the_unsharded_functions_do(eight, mesh,
                                                             case):
    """RoPE, the RMS norm, the shared-input products
    (``layers.einsum_shared``) and the families' regions under a mesh, on
    f32 inputs made from a
    seed, forward and every input's gradient for a given cotangent,
    against the JAX package's functions (``jax.vjp``) and the port's own
    on plain tensors.  The cases place their inputs so that every route
    runs: q sharded on heads (RoPE and the norm local, the norm weight
    gathered), k sharded on its head dim over ``model`` (RoPE's permute
    to the rotate-half partner, the norm's all-reduce of the sum of
    squares), the head dim over both mesh axes (RoPE's gather and cut),
    the residual's norm with its FSDP-sharded weight, and q, k, v and a
    fourth product whose weight shards the contracted dim (a second
    region) from one activation; and the other families' regions: the
    MoE routing on expert-sharded logits (gate values, expert ids, the
    aux loss), MLA's keys (head-sharded ``k_nope`` beside the gathered
    RoPE key) and RWKV-6's five token-shift products; and
    ``sharding.redistribute`` moving a head shard to the head dim by its
    own all-to-all (the identity, its gradient sent back the other way).  RoPE's sharded ops
    are the whole's on each element, so it equals the port's unsharded
    RoPE to the bit, and expert ids are equal; the others sum in another
    order (a sum of squares in parts, products on shards, a gradient
    summed over heads in parts), 1e-5 relative to each tensor's largest
    value, as f32 sums over 16 to 64 terms give; the JAX functions
    compile their own sums, and are held to the same bound."""
    outs, _, _ = eight
    got = outs[0][mesh]["regions"][case]
    r = {k: v.numpy() if torch.is_tensor(v) else v
         for k, v in _region_inputs().items()}
    for lib in ("torch", "jax"):
        want_o, want_g = _region_reference(case, r, lib)
        for kind, mine, ref in (("out", got["outs"], want_o),
                                ("grad", got["grads"], want_g)):
            assert len(mine) == len(ref), (lib, kind)
            for i, (a, b) in enumerate(zip(mine, ref)):
                a = a.numpy()
                if not np.issubdtype(b.dtype, np.floating) or (
                        lib == "torch" and case.startswith("rope")):
                    np.testing.assert_array_equal(a, b, err_msg=kind)
                    continue
                err = float(np.abs(a - b).max() / np.abs(b).max())
                assert err <= REGION_TOL, (lib, kind, i, err)
    for o in outs[1:]:
        for a, b in zip(o[mesh]["regions"][case]["outs"] +
                        o[mesh]["regions"][case]["grads"],
                        got["outs"] + got["grads"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_sharded_train_step_matches_the_jax_single_device_step(eight, mesh):
    """The sharded step's loss and gradient norm, and after it each parameter's
    Adam ``m`` (the clipped gradient, times 1 - b1), f32 master and bf16
    value, against the JAX step on one device.  Warmup is one step, so the
    update is ``lr`` itself and moves the bf16 params by several ulps; a
    lost or wrong gradient fails ``m`` (rel-L2 1 for a zero one)."""
    from repro.data import DataConfig, make_pipeline
    from repro.launch.steps import make_train_step
    from repro.train.optimizer import OptimizerConfig, init_opt_state
    outs, (cfg, model, params), _ = eight
    opt_cfg = OptimizerConfig(**OPT)
    batch = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=8)).batch_at(0)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    p1, s1, m1 = jax.jit(make_train_step(model, opt_cfg, 1))(
        params, init_opt_state(opt_cfg, params), batch)
    want = from_jax_params(cfg, as_numpy(p1))
    losses = {o[mesh]["loss"] for o in outs}
    assert len(losses) == 1                       # every rank agrees
    assert abs(losses.pop() - float(m1["loss"])) < STEP_TOL
    norm = outs[0][mesh]["grad_norm"]
    assert abs(norm - float(m1["grad_norm"])) \
        <= NORM_TOL * float(m1["grad_norm"]), norm
    got = outs[0][mesh]["params"]
    assert sorted(got) == sorted(want)
    worst = max(float((got[k].float() - want[k].float()).abs().max())
                for k in want)
    assert worst < STEP_TOL, worst
    for leaf, tol in (("m", GRAD_TOL), ("master", GRAD_TOL)):
        ref = from_jax_params(cfg, as_numpy(s1[leaf]))
        mine = outs[0][mesh][leaf]
        assert sorted(mine) == sorted(ref)
        for k in ref:
            err = rel_l2(mine[k].numpy(), ref[k].numpy())
            assert err <= tol, (leaf, k, err)


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_every_rank_holds_the_same_parameters_after_the_step(eight, mesh):
    """A replicated shard is updated alike on every rank that holds it: a
    gradient left partial on one would let the replicas drift apart, and
    each rank's whole view (``full_tensor``) of the f32 master, of Adam's
    ``m`` and of the bf16 parameter would differ."""
    outs, _, _ = eight
    for leaf in ("master", "m", "params"):
        first = outs[0][mesh][leaf]
        for o in outs[1:]:
            for k, v in o[mesh][leaf].items():
                assert torch.equal(v, first[k]), (leaf, k)


def test_the_step_shards_every_parameter_by_its_spec(eight):
    """FSDP x TP took hold: the embedding is (vocab: model, embed: data)
    and each rank holds an eighth of it."""
    outs, (cfg, _, _), _ = eight
    o = outs[3]["4x2"]
    assert o["placements"]["embedding"] == "(Shard(dim=1), Shard(dim=0))"
    assert o["local"]["embedding"] == (cfg.vocab // 2, cfg.d_model // 4)
    assert o["local"]["blocks.0.attn.wq"] == (cfg.d_model // 4,
                                              cfg.n_heads // 2, cfg.d_head)
    o = outs[3]["2x4"]
    assert o["placements"]["blocks.0.attn.wk"] \
        == "(Shard(dim=0), Shard(dim=2))"          # head_dim on model


def test_a_checkpoint_saved_on_4x2_restores_bit_equal_on_2x4(eight):
    outs, _, _ = eight
    assert all(o["elastic_equal"] for o in outs)
    assert all(o["elastic_moved"] > 0 for o in outs)


def test_gpipe_matches_the_serial_composition_and_its_jax_grad(eight):
    outs, _, (ws, x) = eight
    Ws, X = jnp.asarray(ws), jnp.asarray(x)

    def serial(Ws):
        h = X
        for s in range(S):
            h = jnp.tanh(h @ Ws[s])
        return h

    want = np.asarray(serial(Ws))
    grad = np.asarray(jax.grad(lambda w: jnp.sum(serial(w) ** 2))(Ws))
    assert sorted(o["gpipe"]["stage"] for o in outs) == [0, 0, 1, 1, 2, 2,
                                                         3, 3]
    for o in outs:
        g = o["gpipe"]
        np.testing.assert_allclose(g["y"].numpy(), want, rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(g["grad"].numpy(), grad[g["stage"]],
                                   rtol=PIPE_GRAD_TOL, atol=PIPE_GRAD_TOL)
        assert g["others"] == 0.0             # a stage trains its own slice


def test_bubble_fraction_and_the_ring():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    assert stage_permutation(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    from repro.distributed.pipeline import (bubble_fraction as jb,
                                            stage_permutation as jp)
    for s, m in ((2, 4), (4, 8), (8, 32)):
        assert bubble_fraction(s, m) == jb(s, m)
        assert stage_permutation(s) == jp(s)


FOUR = """
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig
from repro_torch.distributed import sharding as shd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import TrainLoop, TrainLoopConfig

# (pod, data): rows of a pod-major batch shard
pd = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
rows = torch.arange(8 * 3).reshape(8, 3)
spec = shd.batch_spec((8, 3), pd)
out["rows_spec"] = spec
out["rows"] = shd.place(rows, spec, pd).to_local()[:, 0] // 3
out["coord"] = tuple(pd.get_coordinate())

# a sharded TrainLoop preempted at step 3 and resumed, against one run
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = reduce_config(ARCHS["qwen3-8b"])

def loop(d, steps=6):
    return TrainLoop(cfg, "cpu", mesh=mesh,
                     opt_cfg=OptimizerConfig(lr=3e-3, warmup_steps=1,
                                             total_steps=steps),
                     loop_cfg=TrainLoopConfig(total_steps=steps, log_every=1,
                                              ckpt_every=2, ckpt_dir=d),
                     data_cfg=DataConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=4))

full = loop(tmp + "/full")
want = full.run()

class Latch(train_loop._Preemption):
    def install(self):
        latches.append(self)
        return self

latches = []
orig = train_loop._Preemption
train_loop._Preemption = Latch
first = loop(tmp + "/pre")
stopped = first.run(on_metrics=lambda s, m: s == 3 and setattr(
    latches[-1], "flagged", True))
train_loop._Preemption = orig
second = loop(tmp + "/pre")
got = second.run()
out["steps"] = (want.step, stopped.step, got.step)
out["events"] = (first.events, second.events)
a = [t.full_tensor() if hasattr(t, "full_tensor") else t
     for t in ckpt._flatten(full._tree(want))]
b = [t.full_tensor() if hasattr(t, "full_tensor") else t
     for t in ckpt._flatten(second._tree(got))]
out["resumed_equal"] = len(a) == len(b) and all(
    x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
out["sharded"] = str(dict(second.model.named_parameters())[
    "embedding"].placements)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(FOUR, 4, tmp_path_factory.mktemp("four"))


def test_a_pod_data_shard_holds_the_jax_pod_major_rows(four):
    """``P(("pod", "data"))`` on a 2x2 mesh: rank (pod p, data d) holds
    rows 2 (2p + d) and 2 (2p + d) + 1 of 8, JAX's pod-major order."""
    for o in four:
        assert o["rows_spec"] == (("pod", "data"), None)
        p, d = o["coord"]
        first = 2 * (2 * p + d)
        assert o["rows"].tolist() == [first, first + 1]


def test_a_sharded_train_loop_resumes_bit_equal(four):
    for o in four:
        assert o["steps"] == (6, 3, 6)
        assert o["events"] == ([{"event": "preempted", "step": 3}],
                               [{"event": "resumed", "step": 3}])
        assert o["resumed_equal"]
        assert o["sharded"] == "(Shard(dim=1), Shard(dim=0))"


def test_the_launcher_trains_over_torchrun_ranks(tmp_path):
    """``python -m repro_torch.launch.train --mesh host`` under
    ``torchrun`` (4 gloo ranks, a (4, 1) (data, model) mesh, as the JAX
    launcher's host mesh; ``--standalone`` rendezvouses on a free local
    port).  A (data, model) mesh with TP is the 8-rank job's above."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m",
         "repro_torch.launch.train", "--arch", "qwen3-8b", "--reduced",
         "--device", "cpu", "--mesh", "host",
         "--steps", "2", "--log-every", "1", "--global-batch", "4",
         "--seq-len", "32", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    summary = json.loads("\n".join(lines[lines.index("{"):]))
    assert summary["final_step"] == 2
    assert summary["mesh"] == {"data": 4, "model": 1}
    assert (tmp_path / "LATEST").read_text() == "2"
