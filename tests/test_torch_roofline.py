"""The port's roofline (``repro_torch.roofline``): the tracer's per-chip
counting, the probe algebra and the reports, against the JAX package's
``tests/test_roofline.py`` where they share a meaning.

The traced checks run on a fake process group (one process, no
storage), in a subprocess with a timeout so no group outlives the test
(``_FAKE``); one subprocess serves them all:

* a (256, 1024) @ (1024, 1024) product on a 4x4 mesh, rows over ``data``
  and columns over ``model``: the trace counts exactly the global FLOPs
  over 16 (DTensor's sharding propagation also runs the global product on
  fake tensors, which is not the rank's work);
* an all-gather of a known tensor counts its result's bytes;
* the reduced qwen3-8b's loss and gradients at G = 3 layers traced whole
  equal the model at 0 layers plus G times one block's forward and
  backward traced alone in FLOPs, and each layer adds the same bytes (the
  JAX package needs a correction because its cost analysis counts a
  loop's body once; the tracer sees every layer, so here it is the
  identity);
* one block of it on a 2x2 mesh, and on a (2, 4) mesh whose model axis
  does not divide its 2 kv heads (k and v then shard their head dim, as
  qwen3-8b's 8 on the dry run's 16): its collectives by opcode and its
  FLOPs against a count by hand, none of them issued by DTensor's own op
  strategies and DTensor's own Shard-to-Shard step never reached (its
  ``shard_dim_alltoall`` wrapped by ``trace.count_shard_moves``, which a
  positive control shows counting); the FLOPs again with the tracer's
  propagation skip off, in a process of their own;
* one MoE block (the reduced granite-moe-3b-a800m) on the 2x2 mesh: its
  collectives against a count by hand, its input's gradient reduced once;
  one RWKV-6 block (2 heads) on the (2, 4) mesh, its recurrence on whole
  heads;
* the port's ``sharding.redistribute`` moving a shard by one all-to-all
  of its own;
* a reduced dense step (qwen3-8b, every sharded axis divisible) on a 2x2
  mesh: the per-chip product FLOPs times 4 equal the one-chip trace's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.roofline import HW as JHW  # noqa: E402
from repro.roofline import CellReport as JCellReport  # noqa: E402
from repro.roofline import model_flops as jmodel_flops  # noqa: E402
from repro.roofline.probe import Terms as JTerms  # noqa: E402
from repro_torch.roofline import (HW, CellReport, StepTrace,  # noqa: E402
                                  StepTracer, collective_bytes, model_flops)
from repro_torch.roofline.probe import Terms, mb_extra  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

_FAKE = """
import json, dataclasses, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Shard, Replicate
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.steps import lower_cell, plan_cell
from repro_torch.models import build_model
from repro_torch.models.model import ENC_SPEC
from repro_torch.roofline.trace import StepTracer, count_shard_moves
torch.set_num_threads(1)
# "skip": every case; "noskip": the blocks alone, the tracer's propagation
# skip off (each block is the first trace on its mesh in its process, so
# DTensor's propagation runs cold in both)
SKIP = sys.argv[1] == "skip"
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
out = {}

# DTensor's own Shard-to-Shard step, wrapped to count its calls (the
# control below shows the wrapper counts one)
counting = count_shard_moves()          # kept: its exit would unwrap
moves = counting.__enter__()

mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
fake = FakeTensorMode()
with fake:
    a = distribute_tensor(torch.empty(256, 1024), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.empty(1024, 1024), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    with StepTracer(fake_mode=fake, resident=[a, b]) as t:
        c = a @ b
    out["mm"] = dataclasses.asdict(t.trace)
    out["mm_local"] = list(c.to_local().shape)
    w = distribute_tensor(torch.empty(1024, 1024), mesh,
                          [Replicate(), Shard(0)], src_data_rank=None)
    with StepTracer(fake_mode=fake, resident=[w]) as t:
        w.redistribute(mesh, [Replicate(), Replicate()])
    out["gather"] = dataclasses.asdict(t.trace)
    s = distribute_tensor(torch.empty(64, 64), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    with StepTracer(fake_mode=fake, resident=[s]) as t:
        moved = shd.redistribute(s, [Replicate(), Shard(1)])
    out["move"] = dataclasses.asdict(t.trace)
    out["move_local"] = list(moved.to_local().shape)
    out["move_calls"] = sum(moves.values())
    s.redistribute(mesh, [Replicate(), Shard(1)])       # DTensor's own
    out["control_calls"] = sum(moves.values())

# G layers traced whole vs 0 layers + G x one block, on a 2x2 mesh
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
base = reduce_config(ARCHS["qwen3-8b"])

def traced(cfg, fn, mesh=m22):
    model = build_model(cfg)
    fake = FakeTensorMode()
    moves.clear()
    with fake:
        for name, p in list(model.named_parameters()):
            shd.set_param(model, name, torch.empty(p.shape, dtype=p.dtype))
        shd.place_params(model, shd.param_shardings(
            dict(model.named_parameters()), model.param_axes(), mesh), mesh)
        tok = shd.place(torch.zeros((4, 32), dtype=torch.int64),
                        ("data", None), mesh)
        x = shd.place(torch.zeros((4, 32, cfg.d_model), dtype=torch.bfloat16),
                      ("data", None, None), mesh).requires_grad_(True)
        t = StepTracer(fake_mode=fake, resident=[dict(model.named_parameters())],
                       skip_propagation=SKIP)
        with shd.use_mesh(mesh), t:
            fn(model, tok, x)
    return dict(dataclasses.asdict(t.trace), moves=sum(moves.values()))

def whole(model, tok, x):
    loss, _ = model.train_loss({"tokens": tok, "labels": tok})
    loss.backward()

def one_block(model, tok, x):
    pos = torch.arange(32)[None]
    h, _, aux = model._block(model.blocks[0], x, model.pattern[0],
                             positions=pos)
    (h.float().sum() + aux).backward()

G = 3
one = dataclasses.replace(base, n_layers=1)
out["block"] = traced(one, one_block)
if SKIP:
    out["moe_block"] = traced(dataclasses.replace(
        reduce_config(ARCHS["granite-moe-3b-a800m"]), n_layers=1), one_block)
    out["whole"] = traced(dataclasses.replace(base, n_layers=G), whole)
    out["none"] = traced(dataclasses.replace(base, n_layers=0), whole)
    out["one"] = traced(one, whole)
    out["two"] = traced(dataclasses.replace(base, n_layers=2), whole)

    # a reduced dense step: sum over chips of per-chip FLOPs vs one chip
    plan = plan_cell(base, "train_4k", m22, microbatches=1, global_batch=8)
    out["step4"] = dataclasses.asdict(lower_cell(plan, m22))
    plan = plan_cell(base, "train_4k",
                     shd.AbstractMesh((1, 1), ("data", "model")),
                     microbatches=1, global_batch=8)
    out["step1"] = dataclasses.asdict(lower_cell(plan, None))

# one block on a (2, 4) mesh: model = 4 does not divide the 2 kv heads
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out["block24"] = traced(one, one_block, m24)
if SKIP:
    out["rwkv24"] = traced(dataclasses.replace(
        reduce_config(ARCHS["rwkv6-1.6b"]), n_layers=1), one_block, m24)
print(json.dumps(out))
"""


def _fake(mode: str) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:"
               f"{os.environ.get('PYTHONPATH', '')}", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_FAKE), mode],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_pg():
    return _fake("skip")


@pytest.fixture(scope="module")
def fake_pg_unskipped():
    return _fake("noskip")


def test_a_sharded_matmul_counts_exactly_global_over_chips(fake_pg):
    assert fake_pg["mm"]["flops"] == 2 * 256 * 1024 * 1024 / 16
    assert fake_pg["mm_local"] == [64, 256]
    assert fake_pg["mm"]["skipped"] > 0           # the propagation's own ops
    assert fake_pg["mm"]["coll_by_op"] == {}


def test_an_all_gather_counts_its_result_bytes(fake_pg):
    g = fake_pg["gather"]
    assert g["coll_by_op"] == {"all-gather": 1024 * 1024 * 4}
    assert g["flops"] == 0 and g["hbm_bytes"] == 0


def test_layers_traced_whole_equal_the_blocks_plus_the_rest(fake_pg):
    """Every layer is counted once and whole, so the port's loop
    correction is the identity: T(G) == T(0) + G * T(block) in FLOPs, one
    block's forward and backward traced alone; and in HBM bytes and each
    collective's bytes each layer after the first adds the same, T(3) ==
    T(1) + 2 * (T(2) - T(1)).  (The first layer's input arrives from the
    embedding with other placements than a layer's from a layer, and the
    standalone block seeds its own backward, so neither is held to bytes
    against the others.)"""
    G = 3
    w, n, one, two, b = (fake_pg[k] for k in ("whole", "none", "one",
                                              "two", "block"))
    assert w["flops"] == pytest.approx(n["flops"] + G * b["flops"],
                                       rel=1e-9)
    assert w["hbm_bytes"] == pytest.approx(
        one["hbm_bytes"] + 2 * (two["hbm_bytes"] - one["hbm_bytes"]),
        rel=1e-9)
    for op in set(w["coll_by_op"]) | set(one["coll_by_op"]):
        got = [t["coll_by_op"].get(op, 0.0) for t in (w, one, two)]
        assert got[0] == pytest.approx(got[1] + 2 * (got[2] - got[1]),
                                       rel=1e-9), op
    assert b["flops"] > 0 and w["coll_by_op"]


def _block_count(model: int, data: int = 2):
    """The reduced qwen3-8b's sizes and one block's per-chip FLOPs on a
    (data, model) mesh: the seven projections on this chip's b = 2
    sequences of T = 32 tokens and its TP shard of each weight, the scores
    and the weighted sum on its heads, once forward and twice back."""
    from repro_torch.configs import ARCHS, reduce_config
    cfg = reduce_config(ARCHS["qwen3-8b"])
    D, H, K, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dh, b, T = D // H, 4 // data, 32
    proj = [D * H * dh, D * K * dh, D * K * dh, H * dh * D, D * F, D * F,
            F * D]
    flops = 3 * (2 * b * T * sum(w // model for w in proj)
                 + 2 * 2 * b * (H // model) * T * T * dh)
    return D, H, K, F, dh, b, T, proj, flops


def test_a_sharded_block_matches_its_hand_count(fake_pg):
    """One block of the reduced qwen3-8b (every sharded axis divisible),
    forward and backward on the 2x2 (data, model) mesh, against a count by
    hand, per chip (b = 2 sequences of T = 32 tokens on it):

    * all-gather: each of the seven projections' TP shard gathered over
      ``data`` for the forward (FSDP: numel / model, bf16); the two layer
      norms' f32 weights over ``data`` and the q/k norms' over ``model``
      (the dims those axes shard), once, for the forward: the backward
      keeps what the forward gathered;
    * all-reduce: the attention's and the MLP's output projections reduce
      their pending sums over ``model`` (2); the backward reduces the
      input gradient of q, k and v together, their local gradients summed
      first, and that of up and gate together (2), each b x T x D in bf16;
      and the q/k norms' gradients over ``data`` after their
      reduce-scatter over ``model`` (dh / model f32 each);
    * reduce-scatter: each projection's gradient to its (data, model)
      shard, numel / 4 in bf16; the layer norms' gradients over ``data``
      (D / data f32 each) and the q/k norms' over ``model`` (dh / model
      f32 each);
    * FLOPs: see ``_block_count``.

    Every collective is one a local region issues
    (``sharding.local_region``), none DTensor's op strategies do, and
    DTensor's own Shard-to-Shard step is never reached, so the count does
    not move with the torch version; and a trace that counted DTensor's
    sharding-propagation ops as the rank's work would miss the FLOPs."""
    D, H, K, F, dh, b, T, proj, flops = _block_count(2)
    data, model, bf16, f32 = 2, 2, 2, 4
    block = fake_pg["block"]
    assert block["coll_by_op"] == {
        "all-gather": sum(w // model for w in proj) * bf16
        + (2 * D + 2 * dh) * f32,
        "all-reduce": (2 + 2) * b * T * D * bf16 + 2 * (dh // model) * f32,
        "reduce-scatter": sum(w // (data * model) for w in proj) * bf16
        + 2 * (D // data) * f32 + 2 * (dh // model) * f32}
    assert block["flops"] == flops
    assert block["skipped"] > 0
    assert block["dtensor_coll_by_op"] == {} and block["moves"] == 0


def test_a_block_whose_model_axis_does_not_divide_the_kv_heads(fake_pg):
    """One block of the reduced qwen3-8b (4 heads, 2 kv heads, d_head 16)
    on a (2, 4) (data, model) mesh: ``wk`` and ``wv`` shard their head dim
    over ``model``, as qwen3-8b's 8 kv heads do on the dry run's 16.  Per
    chip (b = 2 sequences of T = 32 tokens), by hand:

    * all-gather: the seven projections' TP shards over ``data`` (numel /
      model, bf16); the layer norms' weights over ``data`` (D f32 each)
      and q's norm weight over ``model`` (dh f32; k's is sharded as k's
      head dim is, so it enters as it is), once, for the forward; and k
      and v, each gathered whole over ``model`` once for the attention (b
      x T x K x dh bf16 each): its q heads read the kv head their group
      shares.  RoPE and the qk-norm gather nothing;
    * all-reduce: the two output projections' pending sums and the two
      shared input gradients (q/k/v's, up/gate's), b x T x D bf16 each
      (2 + 2); k's qk-norm, its sum of squares over the sharded head dim,
      (b, T, K, 1) f32, forward and back (2); the q/k norms' gradients
      over ``data`` (dh / model f32 each: q's after its reduce-scatter
      over ``model``);
    * reduce-scatter: each projection's gradient to its (data, model)
      shard (numel / 8, bf16); the layer norms' gradients over ``data``
      (D / data f32 each) and q's norm weight's over ``model`` (dh /
      model f32); k's and v's gradients back to their head-dim shards
      over ``model`` (b x T x K x dh / model bf16 each), the way their
      gathers came;
    * collective-permute: RoPE's rotate-half partner shard of k (f32, b x
      T x K x dh / model), exchanged by one permute forward and one back;
    * all-to-all: none (no shard moves from one dim to another);
    * FLOPs: see ``_block_count``.

    None is DTensor's own, and its Shard-to-Shard step is never reached."""
    D, H, K, F, dh, b, T, proj, flops = _block_count(4)
    data, model, bf16, f32 = 2, 4, 2, 4
    kv, kv_shard = b * T * K * dh, b * T * K * (dh // model)
    block = fake_pg["block24"]
    assert block["coll_by_op"] == {
        "all-gather": sum(w // model for w in proj) * bf16
        + (2 * D + dh) * f32 + 2 * kv * bf16,
        "all-reduce": (2 + 2) * b * T * D * bf16 + 2 * b * T * K * f32
        + 2 * (dh // model) * f32,
        "reduce-scatter": sum(w // (data * model) for w in proj) * bf16
        + 2 * (D // data) * f32 + (dh // model) * f32
        + 2 * kv_shard * bf16,
        "collective-permute": 2 * kv_shard * f32}
    assert block["flops"] == flops
    assert block["dtensor_coll_by_op"] == {} and block["moves"] == 0


def test_a_moe_block_reduces_its_inputs_gradient_once(fake_pg):
    """One block of the reduced granite-moe-3b-a800m (GQA with 4 heads and
    2 kv heads of 16, then a MoE of E = 8 experts of ff F = 128, top-2,
    groups of 16 tokens) on the 2x2 (data, model) mesh, forward and
    backward, against a count by hand, per chip (b = 2 sequences of T =
    32 tokens, 4 of the 8 groups; the experts split over ``model``, EP):

    * all-gather: the attention's four projections' TP shards over
      ``data`` (numel / model, bf16) and the two layer norms' weights (D
      f32 each); the router gathered whole, over one mesh dim and then the
      other (D x E / 2, then D x E, f32), as every rank routes its tokens
      over all the experts; the three expert weights' EP shards over
      ``data`` (E x D x F / model bf16 each).  Nothing on the way back:
      the experts' input arrives at the region whole and leaves it cut to
      the rank's experts, so no gradient of the dispatched tokens or the
      combine weights is gathered;
    * all-reduce: the attention's output projection and the MoE's result,
      each a pending sum over ``model`` (b x T x D bf16); the
      load-balance loss's (2, E) f32 sums over ``data`` and over
      ``model``, forward and back, and the loss itself (f32) over each;
      on the way back the q/k/v input gradient and the MoE's input
      gradient, each once (b x T x D bf16): the router's product, the
      dispatch and the experts take the MoE's input in one region, which
      sums their local gradients before it reduces them (before, the
      router's f32 product reduced it alone and the dispatched tokens'
      gradient was gathered);
    * reduce-scatter: the attention projections' and the expert weights'
      gradients to their (data, model) shards (numel / 4 bf16); the
      router's, a pending sum on both mesh dims, over one and then the
      other (D x E / 2, then / 4, f32); the layer norms' over ``data`` (D
      / 2 f32 each).

    None is DTensor's own, and its Shard-to-Shard step is never reached."""
    from repro_torch.configs import ARCHS, reduce_config
    cfg = reduce_config(ARCHS["granite-moe-3b-a800m"])
    D, H, K, E, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.n_experts, cfg.d_ff_expert)
    dh, b, T, data, model, bf16, f32 = D // H, 2, 32, 2, 2, 2, 4
    attn = [D * H * dh, D * K * dh, D * K * dh, H * dh * D]
    experts = 3 * E * D * F
    block = fake_pg["moe_block"]
    assert block["coll_by_op"] == {
        "all-gather": sum(attn) // model * bf16 + 2 * D * f32
        + (D * E // 2 + D * E) * f32 + experts // model * bf16,
        "all-reduce": 2 * b * T * D * bf16 + 2 * 2 * (2 * E * f32)
        + 2 * f32 + 2 * b * T * D * bf16,
        "reduce-scatter": (sum(attn) + experts) // (data * model) * bf16
        + (D * E // 2 + D * E // 4) * f32 + 2 * (D // data) * f32}
    assert block["dtensor_coll_by_op"] == {} and block["moves"] == 0


def test_an_rwkv6_block_with_fewer_heads_than_the_model_axis(fake_pg):
    """One block of the reduced rwkv6-1.6b (D = 128: 2 heads of 64) on the
    (2, 4) (data, model) mesh, whose model axis cuts the channels inside a
    head.  Its recurrence runs in one region on whole heads: r, k, v and
    the decay each gathered over ``model`` in f32 (b x T x D, b = 2
    sequences of T = 32 tokens on a chip), and on the way back their
    gradients reduce-scattered to their channel shards (b x T x D /
    model f32 each).  Every collective is the port's own, and DTensor's
    Shard-to-Shard step is never reached (before, the head split
    raised)."""
    b, T, D, model, f32 = 2, 32, 128, 4, 4
    block = fake_pg["rwkv24"]
    assert block["dtensor_coll_by_op"] == {} and block["moves"] == 0
    assert block["coll_by_op"]["all-gather"] >= 4 * b * T * D * f32
    assert block["coll_by_op"]["reduce-scatter"] >= 4 * b * T * D // model \
        * f32
    assert block["flops"] > 0


@pytest.mark.parametrize("key,model", [("block", 2), ("block24", 4)])
def test_the_propagation_skip_leaves_a_blocks_flops_to_the_hand_count(
        fake_pg, fake_pg_unskipped, key, model):
    """A sharded block's FLOPs equal the hand count with the tracer's
    sharding-propagation skip on and off: every product runs in a local
    region, so no product is left to DTensor's propagation, whose fake
    runs would otherwise count a second time.  The skip stays for the
    DTensor elementwise ops that remain between the regions (residual
    adds, the gating product, casts): their propagation still runs ops,
    which it skips (``skipped > 0``) and which, counted, add bytes and
    ops but no FLOPs."""
    flops = _block_count(model)[-1]
    on, off = fake_pg[key], fake_pg_unskipped[key]
    assert on["flops"] == off["flops"] == flops
    assert on["skipped"] > 0 and off["skipped"] == 0
    assert off["ops"] == on["ops"] + on["skipped"]
    assert off["hbm_bytes"] > on["hbm_bytes"]
    assert off["coll_by_op"] == on["coll_by_op"]


def test_the_ports_redistribute_moves_a_shard_by_one_all_to_all(fake_pg):
    """``sharding.redistribute`` turns a (64, 64) f32 shard on dim 0 over
    the 4-rank model axis into one on dim 1 by one all-to-all of its own
    (result: the 64 x 16 local shard), never by DTensor's Shard-to-Shard
    step (which on a CPU mesh would gather the whole group); DTensor's
    step, called directly, is what the wrapper counts."""
    assert fake_pg["move"]["coll_by_op"] == {"all-to-all": 64 * 16 * 4}
    assert fake_pg["move_local"] == [64, 16]
    assert fake_pg["move_calls"] == 0 and fake_pg["control_calls"] == 1


def test_per_chip_product_flops_sum_to_the_one_chip_trace(fake_pg):
    assert 4 * fake_pg["step4"]["flops"] == pytest.approx(
        fake_pg["step1"]["flops"], rel=1e-12)
    assert fake_pg["step1"]["coll_by_op"] == {}
    assert fake_pg["step4"]["coll_by_op"]["all-reduce"] > 0


def test_the_peak_tracker_is_exact_on_a_scripted_sequence():
    keep = torch.zeros(10)                         # 40 B resident
    with StepTracer(resident=[keep]) as t:
        a = torch.empty(100)                       # +400  -> 440
        b = torch.empty(200)                       # +800  -> 1240
        del a                                      # -400  -> 840
        c = torch.empty(50)                        # +200  -> 1040
        v = b[10:]                                 # a view: no storage
        b.add_(1.0)                                # in place: none
        del b, v                                   # -800  -> 240
        d = torch.empty(300)                       # +1200 -> 1440
    assert t.trace.resident_bytes == 40
    assert t.trace.peak_bytes == 1440
    assert c.numel() + d.numel() == 350


def test_the_tracer_counts_hbm_bytes_and_flops_of_local_ops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with StepTracer() as t:
        c = a @ b
        c.add_(1.0)
        c.view(32)
    assert t.trace.flops == 2 * 8 * 16 * 4
    # mm: 512 + 256 in, 128 out; add_: 128 in, 128 out; the view: none
    assert t.trace.hbm_bytes == (512 + 256 + 128) + (128 + 128)
    assert t.trace.ops == 3


def test_collective_bytes_of_a_trace():
    tr = StepTrace(coll_by_op={"all-gather": 8.0, "all-reduce": 4.0})
    assert collective_bytes(tr) == {"all-gather": 8.0, "all-reduce": 4.0,
                                    "total": 12.0}
    assert tr.coll_bytes == 12.0


def test_hw_is_the_h100_sxm_row():
    from repro_torch.core.costmodel import GPU_GENERATIONS
    assert HW["peak_flops_bf16"] == GPU_GENERATIONS["h100sxm"].peak_tc_bf16 \
        == 989e12
    assert HW["hbm_bw"] == 3.35e12 and HW["link_bw"] == 450e9


def test_terms_algebra_matches_jax():
    a = Terms(1.0, 2.0, 3.0, {"all-reduce": 3.0})
    b = Terms(10.0, 20.0, 30.0, {"all-gather": 30.0})
    s = a + 2 * b
    ja = JTerms(1.0, 2.0, 3.0, {"all-reduce": 3.0})
    jb = JTerms(10.0, 20.0, 30.0, {"all-gather": 30.0})
    js = ja + 2 * jb
    assert (s.flops, s.hbm, s.coll, s.coll_by_op) \
        == (js.flops, js.hbm, js.coll, js.coll_by_op) \
        == (21.0, 42.0, 63.0, {"all-reduce": 3.0, "all-gather": 60.0})


def test_cell_report_matches_jax():
    kw = dict(arch="a", shape="s", mesh="m", chips=2,
              flops_per_chip=HW["peak_flops_bf16"] * 1e-3,
              hbm_bytes_per_chip=HW["hbm_bw"] * 2e-3,
              coll_bytes_per_chip=HW["link_bw"] * 0.5e-3,
              coll_by_op={}, peak_memory_per_chip=0.0,
              model_flops=HW["peak_flops_bf16"] * 1e-3 * 2 * 0.5,
              t_compute=1e-3, t_memory=2e-3, t_collective=0.5e-3)
    r, j = CellReport(**kw), JCellReport(**kw)
    assert r.bound == j.bound == "memory"
    assert r.t_total_overlap == j.t_total_overlap == pytest.approx(2e-3)
    assert r.useful_flops_ratio == j.useful_flops_ratio == pytest.approx(0.5)
    assert r.mfu == pytest.approx(0.25)
    # the same formula under each package's peak
    assert r.mfu * HW["peak_flops_bf16"] == pytest.approx(
        j.mfu * JHW["peak_flops_bf16"])
    assert set(r.to_dict()) == set(j.to_dict())


def _cells():
    from repro_torch.configs import ARCHS, cells_for
    return [(a, s) for a in sorted(ARCHS) for s in cells_for(a)]


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_match_jax(arch, shape):
    from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
    from repro_torch.configs import ARCHS, SHAPES
    assert model_flops(ARCHS[arch], SHAPES[shape]) \
        == jmodel_flops(JARCHS[arch], JSHAPES[shape])


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", [c for c in _cells()
                                        if c[1] == "train_4k"])
def test_mb_extra_and_microbatches_match_jax(arch, shape, multi_pod):
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import ARCHS as JARCHS
    from repro.launch.steps import microbatch_count as jcount
    from repro.roofline.probe import mb_extra as jmb
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.mesh import PRODUCTION
    from repro_torch.launch.steps import microbatch_count
    dims, axes = PRODUCTION[multi_pod]
    devs = np.array([jax.devices("cpu")[0]] * int(np.prod(dims)),
                    dtype=object).reshape(dims)
    jm, pm = Mesh(devs, axes), AbstractMesh(dims, axes)
    k = microbatch_count(ARCHS[arch], shape, pm)
    assert k == jcount(JARCHS[arch], shape, jm)
    got, want = mb_extra(ARCHS[arch], pm, k), jmb(JARCHS[arch], jm, k)
    assert (got.flops, got.hbm, got.coll, got.coll_by_op) \
        == (want.flops, want.hbm, want.coll, want.coll_by_op)
