"""Every family's sharded train step held to the port's unsharded one, on
8 gloo ranks of the host (``tests/torch_dist.py``): the reduced
deepseek-v2-236b (MLA and MoE with a shared expert), granite-moe-3b-a800m
(MoE), rwkv6-1.6b (RWKV-6; on 2x4 its 2 heads of 64 are fewer than the
model axis), recurrentgemma-9b (RG-LRU), whisper-medium (cross-attention)
and qwen3-8b, each on a 4x2 and a 2x4 (data, model) mesh, and qwen3-8b
under the ``--opt`` plan on 2x4, its attention sharded over the heads (the
plan's kv-head repeat) and over the sequence (no repeat: the model axis
divides the 4 heads but not the 2 kv heads).  RWKV-6 also runs on 4x2
with its recurrence forced through the region that gathers whole heads
(``rwkv6._mix_gathered``, the 2x4 route).  The weights are ``init(0)``'s
and the batch is 8 x 16 tokens from numpy seed 2 with three labels
masked (``tests/torch_dist.py::family_inputs``).  Each family's serving
path (a prefill of the batch's tokens and two decode steps) is held the
same way on both meshes, and so is that of every family with an attention
cache under the ``--opt`` plan (``optimize_config``: the decode caches
written by the scatter route, ``opt_scatter_cache``, on each rank's local
shard), against the unsharded plain serving path, in f32.

Two jobs, each its own module-scoped run of 8 ranks that makes every
sharded step and, one arch a rank, the unsharded ones:

(a) *Exact.*  Each rank runs with ``torch.bfloat16`` aliased to
    ``torch.float32`` (``unittest.mock.patch.object``, before
    ``repro_torch`` is imported, since defaults such as the parameters'
    storage dtype are bound at import), so every bf16 of the port is
    computed in f32; the port itself has no dtype setting.  A census of
    the step's dispatched ops (a ``TorchDispatchMode``) shows no bf16
    tensor, so the check cannot fall back to bf16 unseen.  Then the loss
    agrees within 1e-5 relative and each parameter's gradient within
    1e-4 rel-L2 (``EXACT_LOSS``, ``EXACT_GRAD``), and the served logits
    within ``EXACT_LOGITS`` (1e-5) rel-L2.  Measured: the losses within
    6.9e-8; the gradients within 1.6e-6 on every family but RWKV-6, whose
    recurrence magnifies f32 rounding, 4.0e-5 on 4x2 and 6.8e-5 on 2x4
    (``blocks.2.mixer.wr``); the logits within 7.4e-7.  A wrong formula
    moves a gradient by order one.
(b) *Rounding.*  In bf16, a sharded step sums its products in another
    order than one device, and on these families bf16 rounding alone
    moves the unsharded step's gradients far from the f32 step's (rel-L2
    up to 0.22 on the routers, 0.78 on RWKV-6's mixer).  So each
    parameter's bf16 sharded gradient is held to its distance from the
    f32 unsharded gradient: at most ``ROUND_FACTOR`` (5) times the
    unsharded bf16 gradient's distance from it, plus ``GRAD_TOL`` (5e-2,
    ``tests/torch_train.py``), and the loss to ``LOSS_TOL`` (2e-3).
    Measured, the worst ratio of the two distances (over parameters whose
    unsharded distance is at least 1e-2; below that ``GRAD_TOL`` holds
    alone) is 2.57 (deepseek-v2-236b's ``blocks.2.moe.router`` on 2x4),
    so 5 leaves about twice that.  For RWKV-6 the unsharded distance is
    the largest over one-device steps that differ only in the order of
    the bf16 partial sums a tensor-parallel step adds (see below); its
    worst ratio to that is 1.09 (``blocks.0.mixer.u`` on 4x2).  The
    served logits are held the same way, at the same factor.
(c) *Casts.*  The bf16 sharded step converts between f32 and bf16 as many
    times each way as the unsharded step (every dispatched ``_to_copy``
    on a rank's plain tensors, forward and backward; DTensor's fake
    tensors of its sharding propagation left out), so a sharded path
    that rounds a value one device keeps in f32, for example a pending
    f32 sum cast with ``.to(x.dtype)`` before its reduction, fails here
    though it stays within (b) and is a no-op in (a).  Measured: equal
    on every case.

*Why RWKV-6 needs the orders.*  Its bf16 gradients are ill-conditioned
on this batch: the first token of sequence 6 leaves block 2's
recurrence an output of rms 4.1e-3 against a median of 4.31 over the
tokens (the f32 step; its two heads' sums r (u k) nearly cancel; blocks
0 and 1 have no token below 2.7e-2 of their median), bf16
rounding is of that value's own size, and the output norm's backward
scales that token's gradient by the reciprocal of its rms, so the
gradients of r, k, u and the token-shift mixes of every block follow the
rounding's luck.  One device alone shows it: summing the row-parallel
products (each block's ``mixer.wo`` and ``mlp.wo``, the ones a
tensor-parallel step reduces) as 4 bf16 partials, in each of their 12
orders, gives worst distances from the f32 step from 0.195 to 6.86;
the plain step gives 0.78, the 2x4 sharded step 6.57.  So RWKV-6's
unsharded distance in (b) is the largest of the plain step and the
orders of ``ORDERS[mesh]`` partials (the model axis' width).  The sharded
recurrence itself is held locally as well: each RWKV-6 block's
sublayers (the two norms, the mixer and the MLP), run unsharded in bf16
on the input and output gradient the sharded step gave them, give the
sharded step's output, input gradient and parameter gradients within
``LOCAL_TOL`` (1e-2; 6.9e-3 measured, ``blocks.1.mixer``'s input gradient
on 2x4).  And the 4x2 step through the gathering region
equals the split route's to the bit.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_dist import family_inputs, run_ranks  # noqa: E402
from torch_lm import rel_l2  # noqa: E402
from torch_train import GRAD_TOL, LOSS_TOL  # noqa: E402

EXACT_LOSS, EXACT_GRAD, EXACT_LOGITS = 1e-5, 1e-4, 1e-5
ROUND_FACTOR = 5.0
LOCAL_TOL = 1e-2
#: the number of bf16 partial sums of RWKV-6's row-parallel products, by
#: mesh: the model axis' width
ORDERS = {"4x2": 2, "2x4": 4}

FAMILIES = ("deepseek-v2-236b", "granite-moe-3b-a800m", "rwkv6-1.6b",
            "recurrentgemma-9b", "whisper-medium", "qwen3-8b")
#: (case, arch, plan, meshes): ``plan`` "opt" is ``optimize_config``'s
#: (attention over the heads by the kv-head repeat), "opt_seq" the same
#: without the repeat (attention over the sequence), "gathered" RWKV-6's
#: recurrence through the region that gathers whole heads
CASES = [(a, a, None, ("4x2", "2x4")) for a in FAMILIES] + [
    ("qwen3-8b:opt", "qwen3-8b", "opt", ("2x4",)),
    ("qwen3-8b:opt_seq", "qwen3-8b", "opt_seq", ("2x4",)),
    ("rwkv6-1.6b:gathered", "rwkv6-1.6b", "gathered", ("4x2",))]
#: the families with an attention cache, served under the ``--opt`` plan
#: (f32 job only) on both meshes, and qwen3-8b's "opt_seq" plan on 2x4,
#: whose decode shards the cache over the sequence
OPT_SERVED = ("qwen3-8b", "deepseek-v2-236b", "recurrentgemma-9b",
              "whisper-medium", "granite-moe-3b-a800m")
SERVED_OPT = [(m, f"{a}:opt") for a in OPT_SERVED for m in ("4x2", "2x4")] \
    + [("2x4", "qwen3-8b:opt_seq")]

JOB = """
import dataclasses, itertools, unittest.mock, torch
from torch.utils._python_dispatch import TorchDispatchMode

inputs = torch.load(tmp + "/inputs.pt")
if inputs["f32"]:            # every bf16 of the port computed in f32
    unittest.mock.patch.object(torch, "bfloat16", torch.float32).start()
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.steps import optimize_config
from repro_torch.models import attention, build_model, rwkv6, transformer

records = None          # RWKV-6's sublayer calls, while a list
names = {}              # id of a parameter or module -> its name
pre_norm = []           # each RWKV-6 mixer's output before its norm


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def recorder(fn, xi, pi):
    # fn, whose input is positional argument xi and whose parameters (a
    # tensor or a module) argument pi: while ``records`` is a list, each
    # call's input, output, output gradient and the gradient of its own
    # use of the input, whole
    def wrapped(*args, **kw):
        if records is None:
            return fn(*args, **kw)
        args = list(args)
        x = args[xi]
        args[xi] = x.view_as(x)
        res = fn(*args, **kw)
        out = res[0] if isinstance(res, tuple) else res
        io = {"name": names[id(args[pi])], "x": whole(x.detach()),
              "out": whole(out.detach())}
        records.append(io)
        out.register_hook(lambda g: io.update(g=whole(g)))
        args[xi].register_hook(lambda g: io.update(dx=whole(g)))
        return res
    return wrapped


transformer.rms_norm = recorder(transformer.rms_norm, 0, 1)
transformer.mlp = recorder(transformer.mlp, 1, 0)
rwkv6.rwkv6_forward = recorder(rwkv6.rwkv6_forward, 1, 0)
OUTPUT = rwkv6._output


def output(p, out, g, x):
    if records is not None:
        rms = whole(out.detach()).float().pow(2).mean(-1).sqrt()
        pre_norm.append((float(rms.min()), float(rms.median())))
    return OUTPUT(p, out, g, x)


rwkv6._output = output
ROWS = {}               # decode cache writes by route, while serving


def counted(fn, key):
    def wrapped(*args, **kw):
        ROWS[key] = ROWS.get(key, 0) + 1
        return fn(*args, **kw)
    return wrapped


attention._insert_row = counted(attention._insert_row, "blend")
attention._scatter_row = counted(attention._scatter_row, "scatter")
SPLIT = rwkv6._split
EINSUM = torch.einsum


def split_einsum(rows, n, order):
    # torch.einsum, but a product with a weight in ``rows`` summed as n
    # bf16 partials over its contracted (first) dim, added in ``order``
    def ein(eq, *ops):
        if len(ops) != 2 or id(ops[1]) not in rows:
            return EINSUM(eq, *ops)
        a, w = ops
        c = w.shape[0] // n
        out = None
        for i in order:
            part = EINSUM(eq, a[..., i * c:(i + 1) * c], w[i * c:(i + 1) * c])
            out = part if out is None else out + part
        return out
    return ein


class Census(TorchDispatchMode):
    # the dtypes of every plain tensor an op takes or gives (a DTensor's
    # op is seen again as the ops on its local tensors), and the count of
    # conversions between floating dtypes, by (from, to)
    def __init__(self):
        super().__init__()
        self.dtypes = set()
        self.casts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.dtypes.add(str(t.dtype))
        if (func is torch.ops.aten._to_copy.default
                and not isinstance(out, FakeTensor)
                and args[0].dtype.is_floating_point
                and out.dtype.is_floating_point
                and args[0].dtype != out.dtype):
            key = (str(args[0].dtype), str(out.dtype))
            self.casts[key] = self.casts.get(key, 0) + 1
        return out


def model(case, mesh):
    arch, plan = inputs["cases"][case]
    cfg = reduce_config(ARCHS[arch])
    if plan in ("opt", "opt_seq"):
        cfg = optimize_config(cfg, mesh)
        if plan == "opt_seq":
            cfg = dataclasses.replace(cfg, kv_repeat=1)
    m = build_model(cfg)
    m.to_empty(device="cpu")
    m.load_state_dict(inputs["families"][arch]["state"])
    if mesh is not None:
        shd.place_params(m, shd.param_shardings(
            dict(m.named_parameters()), m.param_axes(), mesh), mesh)
    names.clear()
    names.update({id(p): k for k, p in m.named_parameters()})
    names.update({id(p): k for k, p in m.named_modules()})
    rwkv6._split = (lambda r: False) if plan == "gathered" else SPLIT
    return m, inputs["families"][arch]["batch"]


def placed(batch, mesh):
    if mesh is None:
        return batch
    return {k: shd.place(v, shd.batch_spec(tuple(v.shape), mesh), mesh)
            for k, v in batch.items()}


def step(case, mesh, order=None):
    # the loss and every parameter's gradient (whole) of the case's model
    # on the test's weights and batch, under mesh (None: unsharded);
    # ``order``: the row-parallel products' bf16 partials, unsharded
    global records
    m, batch = model(case, mesh)
    census = Census()
    records = [] if inputs["cases"][case][0] == "rwkv6-1.6b" else None
    pre_norm.clear()
    if order is not None:
        rows = {id(b.mixer.wo) for b in m.blocks} | {
            id(b.mlp.wo) for b in m.blocks}
        torch.einsum = split_einsum(rows, len(order), order)
    try:
        with shd.use_mesh(mesh), census:
            loss, _ = m.train_loss(placed(batch, mesh))
            loss.backward()
    finally:
        torch.einsum = EINSUM
    out = {"loss": float(whole(loss.detach())),
           "grads": {k: whole(p.grad) for k, p in m.named_parameters()
                     if p.grad is not None},
           "dtypes": sorted(census.dtypes), "casts": census.casts,
           "sublayers": records or [], "pre_norm": list(pre_norm)}
    records = None
    return out


def serve(case, mesh, start=16, census=None):
    # the last position's logits of a prefill of the batch's tokens (and
    # frames) and of two decode steps after it, at positions start and
    # start + 1, whole (the prefill's cache holds 16 rows: a decode step
    # past them writes no row); ``census`` sees the prefill and the steps
    m, batch = model(case, mesh)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    with shd.use_mesh(mesh), torch.no_grad(), census or Census():
        logits, caches, enc = m.prefill(placed(batch, mesh))
        outs = [logits]
        for i in range(2):
            tok = placed({"t": batch["tokens"][:, i:i + 1]}, mesh)["t"]
            logits, caches = m.decode_step(caches, tok, start + i,
                                           enc_out=enc)
            outs.append(logits)
    return [whole(o).float() for o in outs]


def census_serve(case, mesh, start=16):
    # serve's logits, with the dtypes its ops saw and its cache writes by
    # route (the one-hot blend, the scatter)
    census = Census()
    ROWS.clear()
    logits = serve(case, mesh, start, census)
    return {"logits": logits, "dtypes": sorted(census.dtypes),
            "rows": dict(ROWS)}


for key in ("4x2", "2x4"):
    shape = tuple(int(n) for n in key.split("x"))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out[key] = {case: step(case, mesh) for case, meshes in
                inputs["meshes"].items() if key in meshes}
    out["serve", key] = {case: serve(case, mesh) for case, meshes in
                         inputs["meshes"].items()
                         if key in meshes and ":opt" not in case}
    if inputs["f32"]:
        out["serve_opt", key] = {case: census_serve(case, mesh, 15)
                                 for m, case in inputs["serve_opt"]
                                 if m == key}
# the unsharded steps, one arch a rank (no collective runs in them), and
# in bf16 RWKV-6's with its row-parallel products in every order of n
# partials (the first two commute)
mine = [a for i, a in enumerate(sorted(inputs["families"]))
        if i % world == rank]
out["one"] = {arch: step(arch, None) for arch in mine}
out["serve", "one"] = {arch: census_serve(arch, None) for arch in mine}
out["serve_at_15", "one"] = {
    arch: census_serve(arch, None, 15) for arch in mine
    if inputs["f32"] and any(c.split(":")[0] == arch
                             for _, c in inputs["serve_opt"])}
out["orders"] = {}
if not inputs["f32"] and "rwkv6-1.6b" in mine:
    for n in inputs["orders"]:
        for order in itertools.permutations(range(n)):
            if order[0] < order[1]:
                out["orders"][order] = step("rwkv6-1.6b", None, order)
"""


def _run(tmp, f32: bool) -> dict:
    """The job's outputs: each mesh's sharded steps and served logits
    (rank 0's whole view), every arch's unsharded ones and RWKV-6's
    ordered steps, gathered from the ranks."""
    archs = sorted({a for _, a, _, _ in CASES})
    torch.save({"f32": f32,
                "cases": {**{f"{a}:opt": (a, "opt") for a in OPT_SERVED},
                          **{c: (a, plan) for c, a, plan, _ in CASES}},
                "meshes": {c: ms for c, _, _, ms in CASES},
                "serve_opt": SERVED_OPT,
                "orders": sorted(set(ORDERS.values())),
                "families": {a: family_inputs(a) for a in archs}},
               tmp / "inputs.pt")
    outs = run_ranks(JOB, 8, tmp)
    res = {"one": {}, "serve_one": {}, "serve_at_15": {}, "orders": {},
           "ranks": outs}
    for o in outs:
        res["one"].update(o["one"])
        res["serve_one"].update({arch: run["logits"] for arch, run
                                 in o["serve", "one"].items()})
        res["serve_at_15"].update(o["serve_at_15", "one"])
        res["orders"].update(o["orders"])
    for key in ("4x2", "2x4"):
        res[key] = outs[0][key]
        res["serve_" + key] = outs[0]["serve", key]
        res["serve_opt_" + key] = outs[0].get(("serve_opt", key), {})
    return res


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("f32"), True)


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("bf16"), False)


PARAMS = [(m, c) for c, _, _, ms in CASES for m in ms]
SERVED = [(m, c) for m, c in PARAMS if ":opt" not in c]


def _arch(case: str) -> str:
    return case.split(":")[0]


@pytest.mark.parametrize("mesh,case", PARAMS)
def test_the_sharded_step_equals_the_unsharded_step_in_f32(f32, mesh, case):
    """Check (a) (see the module's docstring): no bf16 op in either step,
    the loss within ``EXACT_LOSS`` relative, every gradient within
    ``EXACT_GRAD`` rel-L2, and every rank's whole view the same."""
    got, want = f32[mesh][case], f32["one"][_arch(case)]
    for run in (got, want):
        assert "torch.bfloat16" not in run["dtypes"], run["dtypes"]
        assert "torch.float32" in run["dtypes"]
    assert abs(got["loss"] - want["loss"]) <= EXACT_LOSS * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in got["grads"].items():
        err = rel_l2(g.numpy(), want["grads"][k].numpy())
        assert err <= EXACT_GRAD, (k, err)
    for o in f32["ranks"][1:]:
        assert o[mesh][case]["loss"] == got["loss"]


@pytest.mark.parametrize("mesh,case", SERVED)
def test_the_sharded_prefill_and_decode_equal_the_unsharded_ones_in_f32(
        f32, mesh, case):
    """Check (a) on the serving path: the prefill's and two decode steps'
    logits within ``EXACT_LOGITS`` rel-L2 (RWKV-6's decode on 2x4 runs its
    one-token recurrence in the region that gathers whole heads)."""
    want = f32["serve_one"][_arch(case)]
    for i, got in enumerate(f32["serve_" + mesh][case]):
        err = rel_l2(got.numpy(), want[i].numpy())
        assert err <= EXACT_LOGITS, (i, err)


@pytest.mark.parametrize("mesh,case", SERVED_OPT)
def test_the_opt_plans_sharded_serving_equals_the_unsharded_plain_one_in_f32(
        f32, mesh, case):
    """Check (a) on the ``--opt`` plan's serving path, its decode steps
    at positions 15 (a row of the prefill's cache, rewritten) and 16 (past
    it: no row written): no bf16 op, the prefill's and both decode steps'
    logits within ``EXACT_LOGITS`` rel-L2 of the unsharded plain route's
    at the same positions, and every decode cache write taken by the
    scatter route on the ranks' local shards (the one-hot blend never
    called), where the plain route blends.  Under ``qwen3-8b:opt_seq`` on
    2x4 the decode cache is sharded over the sequence, so only the rank
    that holds row 15 writes it."""
    got = f32["serve_opt_" + mesh][case]
    assert "torch.bfloat16" not in got["dtypes"], got["dtypes"]
    assert "torch.float32" in got["dtypes"]
    want = f32["serve_at_15"][_arch(case)]["logits"]
    assert len(got["logits"]) == len(want) == 3
    for i, logits in enumerate(got["logits"]):
        err = rel_l2(logits.numpy(), want[i].numpy())
        assert err <= EXACT_LOGITS, (i, err)
    plain = f32["serve_at_15"][_arch(case)]["rows"]
    assert plain.get("blend", 0) > 0 and plain.get("scatter", 0) == 0, plain
    assert got["rows"].get("scatter", 0) == plain["blend"], got["rows"]
    assert got["rows"].get("blend", 0) == 0, got["rows"]


def _unsharded_distances(bf16, f32, mesh: str, case: str) -> dict:
    """Each parameter's unsharded bf16 gradient's rel-L2 from its f32
    unsharded gradient; for RWKV-6 the largest over the plain step and
    the orders of ``ORDERS[mesh]`` partial sums (the module's
    docstring)."""
    exact = f32["one"][_arch(case)]["grads"]
    runs = [bf16["one"][_arch(case)]]
    if _arch(case) == "rwkv6-1.6b":
        runs += [r for o, r in bf16["orders"].items()
                 if len(o) == ORDERS[mesh]]
    return {k: max(rel_l2(r["grads"][k].float().numpy(), e.numpy())
                   for r in runs) for k, e in exact.items()}


def _distances(bf16, f32, mesh: str, case: str) -> dict:
    """Each parameter's (bf16 sharded, bf16 unsharded) gradients' rel-L2
    from its f32 unsharded gradient."""
    exact = f32["one"][_arch(case)]["grads"]
    one = _unsharded_distances(bf16, f32, mesh, case)
    return {k: (rel_l2(g.float().numpy(), exact[k].numpy()), one[k])
            for k, g in bf16[mesh][case]["grads"].items()}


@pytest.mark.parametrize("mesh,case", PARAMS)
def test_the_sharded_step_rounds_as_the_unsharded_step_in_bf16(
        bf16, f32, mesh, case):
    """Check (b) (see the module's docstring): each gradient of the bf16
    sharded step is no farther from the f32 step than ``ROUND_FACTOR``
    times the bf16 unsharded step is, plus ``GRAD_TOL``; the loss within
    ``LOSS_TOL``; and the census sees bf16, so the two jobs differ."""
    got, one = bf16[mesh][case], bf16["one"][_arch(case)]
    assert "torch.bfloat16" in got["dtypes"]
    assert abs(got["loss"] - one["loss"]) <= LOSS_TOL * abs(one["loss"])
    dist = _distances(bf16, f32, mesh, case)
    assert sorted(dist) == sorted(f32["one"][_arch(case)]["grads"])
    for k, (sharded, unsharded) in dist.items():
        assert sharded <= ROUND_FACTOR * unsharded + GRAD_TOL, (
            k, sharded, unsharded)


@pytest.mark.parametrize("mesh,case", SERVED)
def test_the_sharded_prefill_and_decode_round_as_the_unsharded_ones(
        bf16, f32, mesh, case):
    """Check (b) on the serving path: each of the bf16 sharded logits is
    no farther from the f32 unsharded ones than ``ROUND_FACTOR`` times the
    bf16 unsharded ones are, plus ``GRAD_TOL``."""
    exact, one = f32["serve_one"][_arch(case)], bf16["serve_one"][_arch(case)]
    for i, got in enumerate(bf16["serve_" + mesh][case]):
        sharded = rel_l2(got.numpy(), exact[i].numpy())
        unsharded = rel_l2(one[i].numpy(), exact[i].numpy())
        assert sharded <= ROUND_FACTOR * unsharded + GRAD_TOL, (
            i, sharded, unsharded)


@pytest.mark.parametrize("mesh,case", PARAMS)
def test_the_sharded_step_casts_as_the_unsharded_step_in_bf16(
        bf16, mesh, case):
    """Check (c) (see the module's docstring): as many conversions between
    f32 and bf16, each way, in the sharded step as in the unsharded one,
    and some of them."""
    got, want = bf16[mesh][case]["casts"], bf16["one"][_arch(case)]["casts"]
    assert want.get(("torch.float32", "torch.bfloat16"), 0) > 0
    assert got == want


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "granite-moe-3b-a800m",
                                  "rwkv6-1.6b"])
def test_bf16_rounding_alone_moves_these_families_past_grad_tol(
        bf16, f32, arch):
    """Why (b) is not a bf16-to-bf16 comparison at ``GRAD_TOL``: on MoE,
    MLA and RWKV-6 the unsharded bf16 step is itself farther than that
    from the f32 step on some parameter, so no such bound could tell a
    wrong formula from rounding there."""
    exact = f32["one"][arch]["grads"]
    assert max(rel_l2(g.float().numpy(), exact[k].numpy())
               for k, g in bf16["one"][arch]["grads"].items()) > GRAD_TOL


def test_rwkv6s_bf16_gradients_follow_the_order_of_its_partial_sums(
        bf16, f32):
    """The module's docstring's witness: in the f32 step one token leaves
    block 2's recurrence an output below 2e-3 of the median's rms (9.5e-4
    measured), and on one device the orders of 4 bf16 partial sums alone move
    the worst gradient's distance from the f32 step by more than
    ``ROUND_FACTOR`` times, past the plain step's on both sides."""
    lowest, median = f32["one"]["rwkv6-1.6b"]["pre_norm"][2]
    assert lowest < 2e-3 * median, (lowest, median)
    exact = f32["one"]["rwkv6-1.6b"]["grads"]

    def worst(run):
        return max(rel_l2(g.float().numpy(), exact[k].numpy())
                   for k, g in run["grads"].items())

    worsts = [worst(r) for o, r in bf16["orders"].items() if len(o) == 4]
    assert len(worsts) == 12
    plain = worst(bf16["one"]["rwkv6-1.6b"])
    assert min(worsts) < plain < max(worsts)
    assert max(worsts) > ROUND_FACTOR * min(worsts), worsts


def test_rwkv6s_gathered_region_rounds_as_the_split_route(bf16):
    """On 4x2, where the model axis divides the heads, RWKV-6's step with
    the recurrence forced through the region that gathers whole heads
    (the 2x4 route) gives the split route's loss and gradients to the
    bit, in bf16: the region adds no rounding of its own."""
    got, want = bf16["4x2"]["rwkv6-1.6b:gathered"], bf16["4x2"]["rwkv6-1.6b"]
    assert got["loss"] == want["loss"]
    for k, g in got["grads"].items():
        assert torch.equal(g, want["grads"][k]), k


def _local_errors(bf16, mesh: str, case: str) -> dict:
    """RWKV-6's local check: (sublayer, what) -> the rel-L2 between the
    bf16 sharded step's output, input gradient or parameter gradient of
    that sublayer call and the unsharded sublayer's, run in bf16 on the
    call's input and output gradient from the sharded step."""
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model, transformer
    from repro_torch.models.rwkv6 import rwkv6_forward
    run = bf16[mesh][case]
    cfg = reduce_config(ARCHS["rwkv6-1.6b"])
    model = build_model(cfg)
    model.to_empty(device="cpu")
    model.load_state_dict(family_inputs("rwkv6-1.6b")["state"])
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    errs = {}
    for io in run["sublayers"]:
        name = io["name"]
        x = io["x"].clone().requires_grad_(True)
        if name in params:                     # a block's norm
            out = transformer.rms_norm(x, params[name], cfg.norm_eps)
            owned = {name: params[name]}
        else:
            p = modules[name]
            out = (rwkv6_forward(p, x)[0] if name.endswith("mixer")
                   else transformer.mlp(p, x, "relu2"))
            owned = {f"{name}.{k}": q for k, q in p.named_parameters()}
        model.zero_grad()
        out.backward(io["g"])
        errs[name, "out"] = rel_l2(io["out"].float().numpy(),
                                   out.detach().float().numpy())
        errs[name, "dx"] = rel_l2(io["dx"].float().numpy(),
                                  x.grad.float().numpy())
        for k, q in owned.items():
            errs[k, "grad"] = rel_l2(run["grads"][k].float().numpy(),
                                     q.grad.float().numpy())
    return errs


@pytest.mark.parametrize("mesh,case", [("4x2", "rwkv6-1.6b"),
                                       ("2x4", "rwkv6-1.6b"),
                                       ("4x2", "rwkv6-1.6b:gathered")])
def test_rwkv6s_sharded_sublayers_round_as_one_device_on_their_inputs(
        bf16, mesh, case):
    """RWKV-6's local rounding check (see the module's docstring): each
    block's norms, mixer and MLP unsharded, in bf16, on the input and
    output gradient the sharded step gave them, against the sharded
    step's output, input gradient and parameter gradients, within
    ``LOCAL_TOL``.  On 2x4 the model axis is wider than the 2 heads, so
    this holds the recurrence's region on whole heads."""
    errs = _local_errors(bf16, mesh, case)
    n_blocks = len(bf16["one"]["rwkv6-1.6b"]["pre_norm"])
    assert len(bf16[mesh][case]["sublayers"]) == 4 * n_blocks
    for key, err in errs.items():
        assert err <= LOCAL_TOL, (key, err)


def _report(f32, bf16) -> None:
    """Print, per mesh and case, the measured values the module's
    docstring quotes: (a)'s loss and worst gradient error, (b)'s worst
    distances from the f32 step and worst ratio, (c)'s counts, the served
    logits, RWKV-6's orders and its local check."""
    for mesh, case in PARAMS:
        got, want = f32[mesh][case], f32["one"][_arch(case)]
        errs = {k: rel_l2(g.numpy(), want["grads"][k].numpy())
                for k, g in got["grads"].items()}
        dist = _distances(bf16, f32, mesh, case)
        ratio = max(((s / u, k) for k, (s, u) in dist.items()
                     if u >= 1e-2), default=(0.0, None))
        worst = max(errs, key=errs.get)
        print(f"{mesh} {case}: (a) loss "
              f"{abs(got['loss'] - want['loss']) / abs(want['loss']):.2e}, "
              f"grad {errs[worst]:.2e} ({worst}); (b) sharded "
              f"{max(s for s, _ in dist.values()):.3f}, unsharded "
              f"{max(u for _, u in dist.values()):.3f}, ratio "
              f"{ratio[0]:.2f} ({ratio[1]}); (c) "
              f"{bf16[mesh][case]['casts']} vs "
              f"{bf16['one'][_arch(case)]['casts']}")
    for mesh, case in SERVED:
        exact, one = f32["serve_one"][_arch(case)], \
            bf16["serve_one"][_arch(case)]
        f = [rel_l2(g.numpy(), e.numpy())
             for g, e in zip(f32["serve_" + mesh][case], exact)]
        b = [(rel_l2(g.numpy(), e.numpy()), rel_l2(u.numpy(), e.numpy()))
             for g, u, e in zip(bf16["serve_" + mesh][case], one, exact)]
        print(f"{mesh} {case} served: f32 {max(f):.2e}; bf16 sharded / "
              f"unsharded from f32 " +
              ", ".join(f"{s:.4f}/{u:.4f}" for s, u in b))
    for mesh, case in SERVED_OPT:
        got = f32["serve_opt_" + mesh][case]
        f = [rel_l2(g.numpy(), e.numpy()) for g, e in
             zip(got["logits"], f32["serve_at_15"][_arch(case)]["logits"])]
        print(f"{mesh} {case} served: f32 {max(f):.2e}, cache writes "
              f"{got['rows']}")
    exact = f32["one"]["rwkv6-1.6b"]["grads"]
    for order, run in sorted(bf16["orders"].items()):
        print(f"rwkv6-1.6b order {order}: worst " + str(max(
            rel_l2(g.float().numpy(), exact[k].numpy())
            for k, g in run["grads"].items())))
    print("rwkv6-1.6b pre-norm rms (lowest, median) by block, f32:",
          f32["one"]["rwkv6-1.6b"]["pre_norm"])
    exact = f32["one"]["rwkv6-1.6b"]["sublayers"]
    for name, run in [("one", bf16["one"]["rwkv6-1.6b"]),
                      ("4x2", bf16["4x2"]["rwkv6-1.6b"]),
                      ("2x4", bf16["2x4"]["rwkv6-1.6b"])]:
        mixers = [(io, e) for io, e in zip(run["sublayers"], exact)
                  if io["name"].endswith("mixer")]
        print(f"rwkv6-1.6b bf16 {name}: by block, the pre-norm rms's lowest "
              + str([round(lo, 6) for lo, _ in run["pre_norm"]])
              + "; the mixer's output and input gradients from f32 "
              + str([(round(rel_l2(io["g"].float().numpy(),
                                   e["g"].numpy()), 4),
                      round(rel_l2(io["dx"].float().numpy(),
                                   e["dx"].numpy()), 4))
                     for io, e in mixers]))
    for mesh, case in [("4x2", "rwkv6-1.6b"), ("2x4", "rwkv6-1.6b"),
                       ("4x2", "rwkv6-1.6b:gathered")]:
        errs = _local_errors(bf16, mesh, case)
        key = max(errs, key=errs.get)
        print(f"{mesh} {case} sublayers: worst {errs[key]:.2e} {key}")


if __name__ == "__main__":
    # python tests/test_torch_distributed_families.py: both jobs, the
    # numbers the docstring quotes
    import tempfile
    from pathlib import Path
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        for sub_dir in ("f32", "bf16"):
            (Path(d) / sub_dir).mkdir()
        _report(_run(Path(d) / "f32", True), _run(Path(d) / "bf16", False))
