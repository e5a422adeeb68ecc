"""The port on a Hopper card: the CUDA GEMM, flash attention, N-body, point
in polygon, 2-D convolution, Hotspot, ExpDist and dedispersion against
their plain versions, the measured evaluator, a screened session, the
LM stack's prefill attention on the flash kernel, and its training
attention on the plain route.  Marked ``cuda``; each test
skips on a host without an sm_90 device.  This file imports no JAX, so it
also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.attention import ops as fops  # noqa: E402
from repro_torch.kernels.attention.space import AttentionProblem  # noqa: E402
from repro_torch.kernels.attention.space import build_space  # noqa: E402
from repro_torch.kernels.common import config_at  # noqa: E402
from repro_torch.kernels.attention.space import (  # noqa: E402
    inputs_from_numpy, numpy_inputs)
from repro_torch.kernels.conv2d import kernel as ckernel  # noqa: E402
from repro_torch.kernels.conv2d import ops as cops  # noqa: E402
from repro_torch.kernels.conv2d.space import Conv2dProblem  # noqa: E402
from repro_torch.kernels.conv2d.space import \
    TILE_SHAPES as CONV2D_TILE_SHAPES  # noqa: E402
from repro_torch.kernels.conv2d.space import \
    tile_configs as conv2d_tile_configs  # noqa: E402
from repro_torch.kernels.dedisp import kernel as dkernel  # noqa: E402
from repro_torch.kernels.dedisp import ops as dops  # noqa: E402
from repro_torch.kernels.dedisp.space import (  # noqa: E402
    TILE_SHAPES, DedispProblem, tile_configs)
from repro_torch.kernels.dedisp.space import \
    numpy_inputs as dedisp_inputs  # noqa: E402
from repro_torch.kernels.expdist import kernel as ekernel  # noqa: E402
from repro_torch.kernels.expdist import ops as eops  # noqa: E402
from repro_torch.kernels.expdist.space import ExpdistProblem  # noqa: E402
from repro_torch.kernels.hotspot import kernel as hkernel  # noqa: E402
from repro_torch.kernels.hotspot import ops as hops  # noqa: E402
from repro_torch.kernels.hotspot.space import HotspotProblem  # noqa: E402
from repro_torch.kernels.hotspot.space import \
    numpy_inputs as hotspot_inputs  # noqa: E402
from repro_torch.kernels.matmul import kernel, ops  # noqa: E402
from repro_torch.kernels.nbody import kernel as nkernel  # noqa: E402
from repro_torch.kernels.nbody import ops as nops  # noqa: E402
from repro_torch.kernels.nbody.space import NbodyProblem  # noqa: E402
from repro_torch.kernels.pnpoly import kernel as pkernel  # noqa: E402
from repro_torch.kernels.pnpoly import ops as pops  # noqa: E402
from repro_torch.kernels.pnpoly.space import PnpolyProblem, laid_out  # noqa: E402
from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem  # noqa: E402
from repro_torch.kernels.matmul.space import \
    build_space as gemm_space  # noqa: E402
from repro_torch.quickstart import rel_l2, tolerance  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


#: both layouts at stages 2 and 4, split-k and a bf16 accumulator, on
#: one- and two-warpgroup tiles, beside each seed's sampled configs
GEMM_COVER = [
    {"block_m": bm, "block_n": bn, "block_k": bk, "unroll_k": u, "warps": w,
     "stages": st, "grid_order": order, "split_k": sk, "acc_dtype": acc,
     "rhs_layout": lay}
    for (bm, bn, bk, u, w, st, order, sk, acc, lay) in [
        (128, 256, 64, 1, 8, 4, "mn", 1, "f32", "kn"),
        (128, 256, 64, 2, 8, 2, "nm", 2, "bf16", "nk"),
        (64, 128, 32, 1, 4, 2, "mn", 4, "f32", "kn"),
        (256, 64, 64, 2, 4, 4, "nm", 1, "bf16", "kn"),
        (64, 256, 32, 2, 8, 4, "mn", 2, "f32", "nk"),
        (256, 128, 64, 1, 8, 2, "mn", 4, "bf16", "nk")]]


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_version(hopper, seed):
    prob = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    x = prob.make_inputs(seed=seed, small=True)
    b_nk = x["b"].t().contiguous()
    for cfg in prob.space.sample_distinct(8, seed) + GEMM_COVER:
        assert prob.space.satisfies(cfg), cfg
        b = x["b"] if cfg["rhs_layout"] == "kn" else b_nk
        before = ops.gemm.launches
        got = ops.gemm(x["a"], b, x["c"], x["alpha"], x["beta"], cfg)
        want = kernel.gemm_plain(x["a"], b, x["c"], alpha=x["alpha"],
                                 beta=x["beta"], **cfg)
        torch.cuda.synchronize()
        assert ops.gemm.launches == before + 1
        err = rel_l2(got, want)
        assert err <= tolerance("gemm_h100", cfg), cfg
        assert err <= kernel.PLAIN_TOL, (err, cfg)
        if cfg["acc_dtype"] == "bf16" \
                and SMALL_SHAPE["k"] // cfg["split_k"] > cfg["block_k"]:
            # more than one k block per slice: the bf16 rounding shows, and
            # the kernel is nearer the bf16-accumulator plain version
            f32 = kernel.gemm_plain(x["a"], b, x["c"], alpha=x["alpha"],
                                    beta=x["beta"], **dict(cfg, acc_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


@pytest.mark.parametrize("case", ["misaligned", "not_divisible"])
def test_launcher_refuses_what_the_kernel_cannot_read(hopper, case):
    """The launcher returns an error, which the wrapper raises, for an
    operand TMA cannot read (a base not 16-byte aligned, which
    ``ops.check`` lets through) or a shape the blocks do not divide (which
    ``ops.check`` catches first, so ``kernel.launch`` is called directly):
    nothing is launched."""
    x = GemmProblem(shape=SMALL_SHAPE, device="cuda").make_inputs(
        seed=0, small=True)
    a, b, c = x["a"], x["b"], x["c"]
    cfg = dict(ops.DEFAULT_CONFIG)
    before = ops.gemm.launches
    if case == "misaligned":
        flat = torch.empty(a.numel() + 8, dtype=a.dtype, device=a.device)
        a = flat[1:1 + a.numel()].view(a.shape).copy_(a)   # 2 bytes off
        assert a.is_contiguous() and a.data_ptr() % 16 != 0
        with pytest.raises(RuntimeError, match="GEMM kernel launch failed"):
            ops.gemm(a, b, c, 1.0, 1.0, cfg)
    else:
        out = torch.empty_like(c)
        with pytest.raises(RuntimeError, match="GEMM kernel launch failed"):
            kernel.launch(a[:192], b, c[:192], out[:192],
                          dict(cfg, block_m=128), 1.0, 1.0)
    torch.cuda.synchronize()
    assert ops.gemm.launches == before


def test_measured_evaluator_times_the_kernel(hopper):
    prob = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    before = ops.gemm.launches
    t = prob.evaluate(ops.DEFAULT_CONFIG)
    assert t.ok and t.arch == prob.arch != "cpu"
    assert ops.gemm.launches - before == prob.warmup + prob.repeats
    assert 0 < t.info["min_s"] <= t.objective <= t.info["max_s"]


@pytest.mark.parametrize("shape,causal", [
    ((4, 2, 256, 256, 64), True), ((4, 2, 256, 256, 64), False),
    ((4, 2, 128, 256, 64), True), ((8, 2, 256, 128, 128), True)],
    ids=["small", "full_mask", "tq<tk", "tq>tk_d128"])
def test_attention_kernel_matches_plain_version(hopper, shape, causal):
    prob = AttentionProblem(shape=dict(zip(("hq", "hkv", "tq", "tk", "d"),
                                           shape)), device="cuda")
    x = inputs_from_numpy(numpy_inputs(0, *shape), "cuda")
    q, k, v = x["q"], x["k"], x["v"]
    for cfg in prob.space.sample_distinct(8, 1):
        before = fops.attention.launches
        got = fops.attention(q, k, v, causal=causal, config=cfg)
        want = fkernel.flash_attention_plain(q, k, v, causal=causal, **cfg)
        torch.cuda.synchronize()
        assert fops.attention.launches == before + 1
        assert torch.isfinite(got).all()
        err = rel_l2(got, want)
        assert err <= tolerance(prob.name, cfg), cfg
        assert err <= fkernel.PLAIN_TOL, (err, cfg)
        if cfg["acc_dtype"] == "bf16" and shape[3] > cfg["block_kv"]:
            # more than one kv tile: the bf16 rounding shows, and the kernel
            # is nearer the bf16-accumulator plain version
            f32 = fkernel.flash_attention_plain(
                q, k, v, causal=causal, **dict(cfg, acc_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


@pytest.mark.parametrize("d", [64, 128])
def test_every_compiled_attention_tile_matches_plain_version(hopper, d):
    """Each (block_kv, warpgroups) of the menu, causal and full, at
    a GQA group of 4, so that every (block_q, block_h) can stack."""
    x = inputs_from_numpy(numpy_inputs(2, 8, 2, 256, 256, d), "cuda")
    q, k, v = x["q"], x["k"], x["v"]
    for i, (bkv, wg) in enumerate(fkernel.TILES):
        rows = wg * fkernel.ROWS_PER_WARPGROUP
        bq, bh = [(q_, h) for h in (1, 2, 4) for q_ in fkernel.BLOCK_Q
                  if q_ * h == rows][i % 3]
        cfg = {"block_q": bq, "block_kv": bkv, "block_h": bh,
               "skip_masked": i % 2, "acc_dtype": ("f32", "bf16")[i // 2 % 2]}
        for causal in (True, False):
            got = fops.attention(q, k, v, causal=causal, config=cfg)
            want = fkernel.flash_attention_plain(q, k, v, causal=causal,
                                                 **cfg)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert rel_l2(got, want) <= fkernel.PLAIN_TOL, cfg


def test_ops_with_no_config_launch_the_kernel_once(hopper):
    """At a shape the default does not fit, an op with no config resolves
    one that does and launches its kernel once: attention at 4 q heads and
    2 kv heads, 256 x 256, d 64 (the default's 128 rows need a block_h of
    1, which fits, so this is the default) and GEMM at 128^3 (the
    default's 256-row tile does not fit)."""
    x = inputs_from_numpy(numpy_inputs(0, 4, 2, 256, 256, 64), "cuda")
    q, k, v = x["q"], x["k"], x["v"]
    before = fops.attention.launches
    got = fops.attention(q, k, v)
    torch.cuda.synchronize()
    assert fops.attention.launches == before + 1
    cfg = config_at(build_space, {"hq": 4, "hkv": 2, "tq": 256, "tk": 256,
                                  "d": 64}, fops.DEFAULT_CONFIG, fops.SEMANTIC)
    assert rel_l2(got, fkernel.flash_attention_plain(q, k, v, **cfg)) \
        <= fkernel.PLAIN_TOL
    g = GemmProblem(shape={"m": 128, "n": 128, "k": 128}, device="cuda")
    xg = g.make_inputs(seed=0, small=False)
    before = ops.gemm.launches
    out = ops.gemm(xg["a"], xg["b"], xg["c"], xg["alpha"], xg["beta"])
    torch.cuda.synchronize()
    assert ops.gemm.launches == before + 1
    gcfg = config_at(gemm_space, {"m": 128, "n": 128, "k": 128},
                     ops.DEFAULT_CONFIG, ops.SEMANTIC)
    assert gcfg["block_m"] == 128
    assert rel_l2(out, kernel.gemm_plain(xg["a"], xg["b"], xg["c"],
                                         alpha=xg["alpha"], beta=xg["beta"],
                                         **gcfg)) <= kernel.PLAIN_TOL


def test_attention_launcher_refuses_what_tma_cannot_read(hopper):
    """q two bytes off a 16-byte boundary: ``ops.check`` lets it through,
    the launcher refuses to encode its tensor map, and nothing runs."""
    x = inputs_from_numpy(numpy_inputs(0, 4, 2, 256, 256, 64), "cuda")
    q, k, v = x["q"], x["k"], x["v"]
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=q.device)
    q = flat[1:1 + q.numel()].view(q.shape).copy_(q)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = fops.attention.launches
    with pytest.raises(RuntimeError, match="attention kernel launch failed"):
        fops.attention(q, k, v, config=fops.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    assert fops.attention.launches == before


def test_attention_measured_evaluator_times_the_kernel(hopper):
    prob = AttentionProblem(shape=AttentionProblem.small_shape,
                            device="cuda")
    before = fops.attention.launches
    t = prob.evaluate(fops.DEFAULT_CONFIG)
    assert t.ok and t.arch == prob.arch != "cpu"
    assert fops.attention.launches - before == prob.warmup + prob.repeats
    assert 0 < t.info["min_s"] <= t.objective <= t.info["max_s"]


@pytest.mark.parametrize("seed", [0, 1])
def test_pnpoly_kernel_matches_plain_version(hopper, seed):
    """Exactly: 0 mismatching points, in every sampled variant."""
    prob = PnpolyProblem(shape={"n": 20000, "v": 600}, device="cuda")
    x = prob.make_inputs(seed=seed, small=False)
    for cfg in prob.space.sample_distinct(12, seed):
        pts = laid_out(x["points"], cfg)
        before = pops.pnpoly.launches
        got = pops.pnpoly(pts, x["poly"], cfg)
        want = pkernel.pnpoly_plain(pts, x["poly"], **cfg)
        torch.cuda.synchronize()
        assert pops.pnpoly.launches == before + 1
        assert int((got != want).sum()) == 0, cfg
        assert rel_l2(got, prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_nbody_kernel_matches_plain_version(hopper, seed):
    prob = NbodyProblem(shape={"n": 4096}, device="cuda")
    x = prob.make_inputs(seed=seed, small=False)
    for cfg in prob.space.sample_distinct(8, seed):
        before = nops.nbody.launches
        got = prob.run_kernel(cfg, x)
        pos = x["pos"] if cfg["layout"] == "soa" \
            else nkernel.to_aos(x["pos"], x["mass"])
        mass = x["mass"] if cfg["layout"] == "soa" else None
        want = nkernel.nbody_plain(pos, mass, **cfg)
        torch.cuda.synchronize()
        assert nops.nbody.launches == before + 1
        err = rel_l2(got, want)
        assert err <= nkernel.PLAIN_TOL, (err, cfg)
        assert rel_l2(got, prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)
        if cfg["compute_dtype"] == "bf16":
            f32 = nkernel.nbody_plain(pos, mass,
                                      **dict(cfg, compute_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


@pytest.mark.parametrize("shape", CONV2D_TILE_SHAPES,
                         ids=[f"{h}x{w}_f{f}"
                              for h, w, f, _ in CONV2D_TILE_SHAPES])
def test_conv2d_kernel_matches_plain_version(hopper, shape):
    """Every compiled tile of the filter size's libraries, on an output no
    block divides (rows of a multiple of 4 floats, staged by cp.async, or
    not): within ``PLAIN_TOL`` in f32, exactly in bf16, which the f32
    plain version misses."""
    prob = Conv2dProblem(shape=dict(zip(("h", "w", "fh", "fw"), shape)),
                         device="cuda")
    x = prob.make_inputs(seed=0, small=False)
    for cfg in conv2d_tile_configs(*shape):
        before = cops.conv2d.launches
        got = cops.conv2d(x["image"], x["filt"], cfg)
        want = ckernel.conv2d_plain(x["image"], x["filt"], **cfg)
        torch.cuda.synchronize()
        assert cops.conv2d.launches == before + 1
        assert rel_l2(got, prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)
        if cfg["acc_dtype"] == "bf16":
            assert int((got != want).sum()) == 0, cfg
            f32 = ckernel.conv2d_plain(x["image"], x["filt"],
                                       **dict(cfg, acc_dtype="f32"))
            assert int((got != f32).sum()) > 0, cfg
        else:
            err = rel_l2(got, want)
            assert err <= ckernel.PLAIN_TOL, (err, cfg)


def test_hotspot_kernel_matches_plain_version(hopper):
    """On the whole domain: exactly with a bf16 accumulator, within
    ``PLAIN_TOL`` with f32; 12 sweeps, so that tt up to 10 ends in a
    shorter launch."""
    prob = HotspotProblem(shape={"h": 200, "w": 300, "n_total": 12},
                          device="cuda")
    x = prob.make_inputs(seed=0, small=False)
    temp, power, n = x["temp"], x["power"], x["n_sweeps"]
    for cfg in prob.space.sample_distinct(12, 2):
        before = hops.hotspot.launches
        issued = hops.hotspot.device_launches
        got = hops.hotspot(temp, power, n, cfg)
        want = hkernel.hotspot_plain(temp, power, n, **cfg)
        torch.cuda.synchronize()
        assert hops.hotspot.launches == before + 1
        assert hops.hotspot.device_launches == issued + -(-n // cfg["tt"])
        if cfg["acc_dtype"] == "bf16":
            assert int((got != want).sum()) == 0, cfg
        else:
            assert rel_l2(got, want) <= hkernel.PLAIN_TOL, cfg
        assert rel_l2(prob.run_kernel(cfg, x), prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)


def test_every_compiled_hotspot_tile_matches_plain_version(hopper):
    """Each compiled (columns a lane, unroll_t, acc_dtype, power_smem), 12
    sweeps in launches of 4, over the whole domain: on 224 x 324, where
    tiles are shifted into the domain at its edges, and on 30 x 30, smaller
    than any tile (the EDGE path).  Exactly in bf16 (and off the f32
    plain version), within ``PLAIN_TOL`` in f32."""
    for h, w in ((200, 300), (6, 6)):
        x = inputs_from_numpy(hotspot_inputs(1, h, w, 12), "cuda",
                              dtype=torch.float32)
        temp, power, n = x["temp"], x["power"], x["n_sweeps"]
        for cfg in hkernel.tile_configs():
            issued = hops.hotspot.device_launches
            got = hops.hotspot(temp, power, n, cfg)
            want = hkernel.hotspot_plain(temp, power, n, **cfg)
            torch.cuda.synchronize()
            assert hops.hotspot.device_launches == issued + 3
            if cfg["acc_dtype"] == "bf16":
                assert int((got != want).sum()) == 0, (h, w, cfg)
                f32 = hkernel.hotspot_plain(temp, power, n,
                                            **dict(cfg, acc_dtype="f32"))
                assert int((got != f32).sum()) > 0, (h, w, cfg)
            else:
                assert rel_l2(got, want) <= hkernel.PLAIN_TOL, (h, w, cfg)


def test_every_compiled_dedisp_tile_matches_plain_version(hopper):
    """Each compiled (unroll_d, samples a thread) in both acc_dtypes, at
    the two shapes that reach them all, exactly, on three delay tables: the
    problem's, one where every DM of a channel shares one delay (a read
    serves all of a thread's DMs) and one where all differ (a read each)."""
    seen = set()
    for c, d, t_out, t_in, step in TILE_SHAPES:
        x = inputs_from_numpy(dedisp_inputs(2, c, d, t_out, t_in, step),
                              "cuda", dtype=torch.float32)
        span = t_in - t_out
        tables = {
            "real": x["delays"],
            "equal": torch.full_like(x["delays"], span // 3),
            "distinct": (torch.arange(d, device="cuda", dtype=torch.int32)
                         % (span + 1)).expand(c, d).contiguous()}
        for tile, cfg in tile_configs(c, d, t_out, t_in).items():
            seen.add(tile)
            for acc in ("f32", "bf16"):
                run = dict(cfg, acc_dtype=acc)
                for name, dl in tables.items():
                    got = dops.dedisp(x["x"], dl, t_out, run)
                    want = dkernel.dedisp_plain(x["x"], dl, t_out, **run)
                    torch.cuda.synchronize()
                    assert int((got != want).sum()) == 0, (name, run)
                    if acc == "bf16":
                        f32 = dkernel.dedisp_plain(
                            x["x"], dl, t_out, **dict(run, acc_dtype="f32"))
                        assert int((got != f32).sum()) > 0, (name, run)
    assert seen == set(dkernel.tiles())


def test_expdist_kernel_matches_plain_version(hopper):
    prob = ExpdistProblem(shape={"ka": 5000, "kb": 3000}, device="cuda")
    x = prob.make_inputs(seed=0, small=False)
    args = (x["a"], x["b"], x["sa"], x["sb"])
    for cfg in prob.space.sample_distinct(12, 2):
        before = eops.expdist.launches
        issued = eops.expdist.device_launches
        got = eops.expdist(*args, cfg)
        want = ekernel.expdist_plain(*args, **cfg)
        torch.cuda.synchronize()
        assert eops.expdist.launches == before + 1
        assert eops.expdist.device_launches == issued + 2
        err = rel_l2(got, want)
        assert err <= ekernel.PLAIN_TOL, (err, cfg)
        assert rel_l2(got, prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)
        if cfg["compute_dtype"] == "bf16":
            f32 = ekernel.expdist_plain(*args,
                                        **dict(cfg, compute_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


def test_dedisp_kernel_matches_plain_version(hopper):
    """Exactly: 0 mismatching outputs, in both acc_dtypes."""
    prob = DedispProblem(shape={"c": 96, "d": 160, "t_out": 1024,
                                "t_in": 2048, "dm_step": 0.5}, device="cuda")
    x = prob.make_inputs(seed=0, small=False)
    for cfg in prob.space.sample_distinct(12, 2):
        before = dops.dedisp.launches
        got = dops.dedisp(x["x"], x["delays"], x["t_out"], cfg)
        want = dkernel.dedisp_plain(x["x"], x["delays"], x["t_out"], **cfg)
        torch.cuda.synchronize()
        assert dops.dedisp.launches == before + 1
        assert int((got != want).sum()) == 0, cfg
        assert rel_l2(got, prob.run_reference(cfg, x)) \
            <= tolerance(prob.name, cfg)


# --------------------------------------------------------------------- #
# the session layer on the card
# --------------------------------------------------------------------- #
def test_config_that_breaks_the_context_is_poisoned_alone(hopper):
    """A device-side assert leaves its process's CUDA context unusable:
    the measuring worker exits, the pool is rebuilt, and only that config
    ends poisoned; every later config measures on a fresh process."""
    from torch_toys import DeviceAssert

    from repro_torch.orchestrator import SessionSpec, run_session
    prob = DeviceAssert()
    spec = SessionSpec(problem="device_assert", tuner="grid", budget=4,
                       arch=prob.arch, workers=2)
    res = run_session(spec, problem=prob, max_retries=1)
    assert len(res.trials) == 4
    bad = [t for t in res.trials if not t.valid]
    assert [t.config["a"] for t in bad] == [1]
    assert bad[0].info["poison"] is True and bad[0].info["attempts"] == 2
    good = [t for t in res.trials if t.valid]
    assert sorted(t.config["a"] for t in good) == [0, 2, 3]
    assert all(t.info["device"] == 0 and t.info["repeats"] == 3
               for t in good)


def test_pool_runs_one_measuring_process_per_card(hopper):
    """``workers=4`` on one card: one process measures, pinned to device
    0, and its spans come back to the parent's trace."""
    from repro_torch.orchestrator import WorkerPool
    from repro_torch.telemetry import trace
    prob = GemmProblem(shape=SMALL_SHAPE, device="cuda", repeats=2,
                       warmup=1)
    cfgs = prob.space.sample_distinct(6, 0)
    with trace.tracing(), WorkerPool(prob, prob.arch, workers=4) as pool:
        assert pool.mode == "process"
        trials = pool.evaluate(cfgs)
        spans = [e for e in trace.events() if e["name"] == "kernel.measure"]
    n = torch.cuda.device_count()
    assert all(t.ok and t.info["device"] == 0 for t in trials) or n > 1
    assert len(spans) == len(cfgs)
    assert len({e["args"]["pid"] for e in spans}) == min(4, n)


# --------------------------------------------------------------------- #
# the surrogate screen
# --------------------------------------------------------------------- #
def test_screened_gemm_session_on_the_card(hopper, tmp_path):
    """A screened GEMM session measured on an sm_90 card at a small shape:
    estimated trials launch nothing, each measured one ``warmup +
    repeats`` launches, and harvesting the session takes only the
    measured rows."""
    from repro_torch.core.surrogate import (Harvest, KernelSurrogate,
                                            SurrogateScreen)
    from repro_torch.orchestrator import (SessionSpec, SessionStore,
                                          run_session)
    gemm = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    rows = gemm.space.compiled().valid_rows
    h = Harvest(gemm.name, gemm.space)
    h.add_rows(rows.tolist(), "h100sxm",
               gemm.objectives_for_rows(rows, "h100sxm"))
    model = KernelSurrogate.fit(h.build(),
                                params={"n_trees": 24, "max_depth": 4})
    screen = SurrogateScreen(model, gemm.space, "h100", measure_frac=0.25)
    spec = SessionSpec(problem=gemm.name, tuner="genetic", arch="h100",
                       budget=24, seed=0, workers=1)
    store = SessionStore(tmp_path / "s", clock=lambda: 0.0)
    store.create(spec)
    before = ops.gemm.launches
    res = run_session(spec, problem=gemm, store=store, mode="thread",
                      screen=screen)
    measured = [t for t in res.trials if not t.info.get("estimated")]
    assert len(res.trials) == 24 and 0 < len(measured) < 24
    assert all(t.ok for t in measured)
    assert ops.gemm.launches - before \
        == len(measured) * (gemm.warmup + gemm.repeats)
    h2 = Harvest(gemm.name, gemm.space)
    assert h2.add_store(store) == len(measured)
    assert h2.n_skipped_estimated == 24 - len(measured)


# --------------------------------------------------------------------- #
# a second host thread
# --------------------------------------------------------------------- #
THREAD_PROBLEMS = {
    "gemm": lambda: GemmProblem(shape=SMALL_SHAPE, device="cuda"),
    "flash_attention": lambda: AttentionProblem(
        shape=AttentionProblem.small_shape, device="cuda"),
    "nbody": lambda: NbodyProblem(shape=NbodyProblem.small_shape,
                                  device="cuda"),
    "pnpoly": lambda: PnpolyProblem(shape=PnpolyProblem.small_shape,
                                    device="cuda"),
    "conv2d": lambda: Conv2dProblem(shape=Conv2dProblem.small_shape,
                                    device="cuda"),
    "hotspot": lambda: HotspotProblem(shape=HotspotProblem.small_shape,
                                      device="cuda"),
    "expdist": lambda: ExpdistProblem(shape=ExpdistProblem.small_shape,
                                      device="cuda"),
    "dedisp": lambda: DedispProblem(shape=DedispProblem.small_shape,
                                    device="cuda"),
}


@pytest.mark.parametrize("name", sorted(THREAD_PROBLEMS))
def test_a_config_measured_first_here_launches_from_another_thread(hopper,
                                                                   name):
    """Each kernel's configs, measured first in this thread, measure in
    two other host threads too (a thread-mode worker pool's): the shared
    memory opt-in each launcher keeps is the launching thread's own."""
    from concurrent.futures import ThreadPoolExecutor
    prob = THREAD_PROBLEMS[name]()
    for cfg in prob.space.sample_distinct(3, 0):
        assert prob.evaluate(cfg).ok
        for _ in range(2):
            with ThreadPoolExecutor(1) as ex:
                t = ex.submit(prob.evaluate, cfg).result()
            assert t.ok, (cfg, t.info)


# --------------------------------------------------------------------- #
# the LM stack's prefill attention on the flash kernel
# --------------------------------------------------------------------- #
def _card_lm():
    """A small model whose heads the kernel takes (4 q, 2 kv, d 128), on
    the card with random weights."""
    from repro_torch.models import ModelConfig, build_model
    cfg = ModelConfig(name="card-lm", vocab=1024, d_model=512, n_layers=2,
                      n_heads=4, n_kv_heads=2, d_ff=1024, qk_norm=True,
                      rope_theta=1_000_000.0)
    return build_model(cfg).init(0, "cuda")


#: the rel-L2 the kernel route's last logits may differ from the plain
#: route's: the plain route rounds the softmax weights to bf16 before
#: P V, the kernel keeps P near f32 (bf16 hi + lo), a few 1e-3 apart in
#: one call; two layers grow that far less than the 36 of chip_smoke.py's
#: comparison (``LM_TOL`` 5e-2, 2.1e-2 measured there)
LM_ROUTE_TOL = 2e-2


def test_lm_prefill_routes_by_shape_and_counts_exactly(hopper):
    """An admitted prompt (128 tokens) runs the kernel once a layer, an
    unadmitted one (100) the plain route once a layer; the engine serves
    both."""
    import numpy as np

    from repro_torch.models.attention import ROUTES
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    model = _card_lm()
    engine = ServingEngine(model, ServeConfig(n_slots=2, max_len=256,
                                              max_new_tokens=4))
    rng = np.random.default_rng(0)
    for uid, n in enumerate((128, 100)):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, 1024, n)))
    ROUTES.clear()
    before = fops.attention.launches
    done = engine.run()
    assert sorted(len(c.tokens) for c in done) == [4, 4]
    assert fops.attention.launches - before == 2
    assert ROUTES["plain"] == 2
    assert ROUTES["kernel:plan"] + ROUTES["kernel:resolved"] == 2
    assert [p["route"] for p in engine.prefills] == ["kernel", "plain"]


def test_lm_prefill_kernel_route_matches_the_plain_route(hopper):
    from repro_torch.quickstart import rel_l2
    model = _card_lm()
    plain = model.with_attention_impl("plain")
    tokens = torch.randint(0, 1024, (1, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    before = fops.attention.launches
    got, got_cache, _ = model.prefill({"tokens": tokens})
    assert fops.attention.launches - before == 2
    want, want_cache, _ = plain.prefill({"tokens": tokens})
    assert fops.attention.launches - before == 2
    assert rel_l2(got, want) <= LM_ROUTE_TOL
    # the caches come from the projections, before attention: layer 0's
    # are the same tensors' values
    assert torch.equal(got_cache[0]["attn"]["k"], want_cache[0]["attn"]["k"])


def test_lm_plan_config_that_does_not_fit_is_not_passed(hopper,
                                                        monkeypatch):
    """A plan config whose block_q does not divide the prompt is replaced
    by the op's own resolution (the op gets no config); one that fits is
    passed as it is."""
    from types import SimpleNamespace

    from repro_torch.models import attention as lm_attention
    from repro_torch.models.attention import ROUTES
    seen = []

    def recording(q, k, v, causal=True, scale=None, config=None):
        seen.append(config)
        return fops.attention(q, k, v, causal=causal, scale=scale,
                              config=config)

    monkeypatch.setattr(lm_attention, "flash_ops", SimpleNamespace(
        attention=recording, check=fops.check,
        DEFAULT_CONFIG=fops.DEFAULT_CONFIG, SEMANTIC=fops.SEMANTIC))
    model = _card_lm()
    tokens = torch.randint(0, 1024, (1, 64), device="cuda")
    wide = dict(fops.DEFAULT_CONFIG, block_q=128, block_kv=64)
    fits = dict(fops.DEFAULT_CONFIG, block_q=64, block_kv=64)
    ROUTES.clear()
    model.prefill({"tokens": tokens}, kernel_config=wide)
    assert seen == [None, None]
    assert ROUTES["kernel:resolved"] == 2 and ROUTES["kernel:plan"] == 0
    model.prefill({"tokens": tokens}, kernel_config=fits)
    assert seen[2:] == [fits, fits]
    assert ROUTES["kernel:plan"] == 2


def _lm_batch(n: int = 256) -> dict:
    tokens = torch.randint(0, 1024, (1, n), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def test_lm_training_attention_keeps_its_gradient(hopper):
    """A ``train_loss`` backward at a shape the flash kernel takes (heads of
    128, 256 tokens) runs the plain route under ``attention_impl="auto"``
    (the kernel has no backward): nothing is launched, and the attention
    weights' gradients equal the ``"plain"`` model's to the bit (the same
    kernels on the same inputs), the rest within 1e-6 rel-L2."""
    from repro_torch.models.attention import ROUTES
    from repro_torch.quickstart import rel_l2
    model = _card_lm()
    batch = _lm_batch()
    ROUTES.clear()
    before = fops.attention.launches
    grads = {}
    for name, m in (("auto", model),
                    ("plain", model.with_attention_impl("plain"))):
        model.zero_grad(set_to_none=True)          # the weights are shared
        loss, _ = m.train_loss(batch)
        loss.backward()
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert fops.attention.launches == before
    # two layers, two models, each forward and remat's recompute
    assert model.cfg.remat and dict(ROUTES) == {"plain": 8}
    for layer in (0, 1):
        for w in ("wq", "wk", "wv", "q_norm", "k_norm"):
            name = f"blocks.{layer}.attn.{w}"
            assert grads["auto"][name].abs().sum() > 0, name
            assert torch.equal(grads["auto"][name], grads["plain"][name]), \
                name
    for name, g in grads["plain"].items():
        assert rel_l2(grads["auto"][name].float(), g.float()) <= 1e-6, name


def test_lm_serving_prefill_stays_on_the_kernel_route(hopper):
    """Where autograd records nothing (``prefill``, or a forward under
    ``no_grad``) the kernel still takes the attention, counted under
    ``ROUTES["kernel:*"]``; the same forward with grad runs plain."""
    from repro_torch.models.attention import ROUTES
    model = _card_lm()
    batch = _lm_batch()
    ROUTES.clear()
    before = fops.attention.launches
    model.prefill({"tokens": batch["tokens"]})
    with torch.no_grad():
        model(batch)
    assert fops.attention.launches - before == 4
    assert ROUTES["kernel:plan"] + ROUTES["kernel:resolved"] == 4
    assert ROUTES["plain"] == 0
    logits, _, _ = model(batch)
    assert logits.requires_grad
    assert fops.attention.launches - before == 4 and ROUTES["plain"] == 2
