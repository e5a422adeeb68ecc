"""The port's Hopper cost model (``repro_torch.core.costmodel``) and the
analytical endpoints of its problems, on the host.

Per kernel and per model id the columnar features equal the per-config ones
field by field, and the batched model equals the scalar one bit for bit;
the row endpoints equal ``evaluate_many`` from one row up; a config past a block's shared memory, or with no block
resident, gets ``inf``; the arch id routes each call to the model or the
measurement, and refuses any other; the portability matrix equals the JAX
package's on the same tables; the landscape runs on the model at the full
shape; and the fit, rerun from the committed rows, gives the committed
constants and the rho that PERF.md records."""

import dataclasses
import math
import random
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import results as jresults  # noqa: E402
from repro.core.analysis import portability as jportability  # noqa: E402
from repro_torch import calibrate, landscape  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core import results as tresults  # noqa: E402
from repro_torch.core.analysis import portability_matrix  # noqa: E402
from repro_torch.core.costmodel import (ARCH_NAMES, FeatureBatch,  # noqa: E402
                                        GPU_GENERATIONS, KernelFeatures,
                                        estimate_seconds,
                                        estimate_seconds_batch)
from repro_torch.kernels import BENCHMARKS  # noqa: E402
from repro_torch.kernels.common import SMEM_PER_BLOCK  # noqa: E402
from repro_torch.kernels.conv2d import kernel as ckernel  # noqa: E402
from repro_torch.kernels.dedisp import kernel as dkernel  # noqa: E402
from repro_torch.kernels.dedisp import ref as dref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(BENCHMARKS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    """Every problem at its default shape, on the host: the model needs no
    card."""
    return {name: cls(device="cpu") for name, cls in BENCHMARKS.items()}


def sample_rows(prob, n: int, seed: int) -> np.ndarray:
    comp = prob.space.compiled()
    pick = random.Random(seed).sample(range(len(comp.valid_rows)),
                                      min(n, len(comp.valid_rows)))
    return comp.valid_rows[np.asarray(pick, dtype=np.int64)]


# ------------------------------------------------------------------ #
# the spec rows
# ------------------------------------------------------------------ #
def test_spec_rows():
    """Two ids without dots, apart from the card's measured ``h100``; the
    data sheet's figures; Hopper's per-SM limits shared; the fitted
    constants shared, so h100pcie differs only in its public figures."""
    sxm, pcie = GPU_GENERATIONS["h100sxm"], GPU_GENERATIONS["h100pcie"]
    assert ARCH_NAMES == ("h100sxm", "h100pcie")
    assert all("." not in a and a != "h100" for a in ARCH_NAMES)
    assert (sxm.sms, sxm.peak_tc_bf16, sxm.hbm_bw, sxm.power_w) == \
        (132, 989e12, 3.35e12, 700.0)
    assert (pcie.sms, pcie.peak_tc_bf16, pcie.hbm_bw, pcie.power_w) == \
        (114, 756e12, 2.0e12, 350.0)
    assert sxm.f32_inst == 128 * 132 * 1.98e9
    assert sxm.sfu == 16 * 132 * 1.98e9
    assert pcie.f32_inst == 128 * 114 * 1.755e9
    assert pcie.sfu == 16 * 114 * 1.755e9
    assert sxm.l2_bytes == pcie.l2_bytes == 50 * 2 ** 20
    assert sxm.smem_per_block == SMEM_PER_BLOCK == 232_448
    for g in (sxm, pcie):
        assert (g.smem_per_sm, g.regs_per_sm, g.threads_per_sm,
                g.blocks_per_sm) == (233_472, 65_536, 2048, 32)
    assert sxm.fit == pcie.fit == costmodel.FIT
    assert len(dataclasses.fields(costmodel.Fit)) <= 8


def load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_bounds_use_the_spec_row():
    """``chip_smoke.py``'s bound divides by the h100sxm row and gives the
    bounds it printed before the row existed (GEMM and nbody at their
    default shapes, ms)."""
    smoke = load_smoke()
    m = n = k = 4096
    gemm = smoke.bound(2.0 * m * n * k, 2.0 * m * n,
                       2.0 * (m * k + k * n + m * n + m * n))
    assert (gemm[0] * 1e3, gemm[1]) == (0.1389675970394338, "operations")
    nb = 131072
    nbody = smoke.bound(0.0, 17.0 * nb * nb, 4.0 * (4 * nb + 3 * nb),
                        sfu_ops=float(nb) * nb)
    assert (nbody[0] * 1e3, nbody[1]) == (8.730109335782064, "operations")


@pytest.mark.parametrize("name", ["gemm_h100", "hotspot_h100",
                                  "expdist_h100"])
def test_chip_smoke_holdout_rows(name, problems):
    """The costmodel phase's held-out configs: admitted rows outside what
    the run measured and the fit rows, as many as asked, the same for the
    same seed and another for another seed."""
    smoke = load_smoke()
    prob = problems[name]
    comp = prob.space.compiled()
    seen = set(sample_rows(prob, 1000, 0).tolist()) | {
        r for r, _ in calibrate.load_rows()["problems"][name]}
    held = smoke.holdout_rows(prob.space, seen, smoke.HOLDOUT,
                              smoke.HOLDOUT_SEED)
    assert len(held) == smoke.HOLDOUT == len(set(held.tolist()))
    assert comp.mask[held].all()
    assert not seen & set(held.tolist())
    assert (np.diff(held) > 0).all()
    again = smoke.holdout_rows(prob.space, seen, smoke.HOLDOUT,
                               smoke.HOLDOUT_SEED)
    assert np.array_equal(held, again)
    other = smoke.holdout_rows(prob.space, seen, smoke.HOLDOUT,
                               smoke.HOLDOUT_SEED + 1)
    assert not np.array_equal(held, other)
    rest = comp.n_valid - len(seen)
    assert len(smoke.holdout_rows(prob.space, seen, rest + 5, 0)) == rest


# ------------------------------------------------------------------ #
# scalar == columnar, bit for bit
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("name", NAMES)
def test_feature_columns_bitwise_equal_scalar(name, arch, problems):
    """``feature_columns`` equals ``features`` field by field, and the
    batched model the scalar one, bit for bit (as the reference's
    ``test_kernels.py`` holds its kernels)."""
    prob = problems[name]
    comp = prob.space.compiled()
    rows = sample_rows(prob, 200, 3)
    cfgs = comp.decode_many(rows)
    fb = prob.feature_columns(comp.value_columns(rows), arch)
    feats = [prob.features(c, arch) for c in cfgs]
    ref = FeatureBatch.from_features(feats)
    for field in FeatureBatch.FIELDS:
        got = np.broadcast_to(np.asarray(getattr(fb, field)), (len(rows),))
        assert np.array_equal(got, getattr(ref, field)), (arch, field)
    batched = np.broadcast_to(estimate_seconds_batch(fb, arch), (len(rows),))
    scalar = np.array([estimate_seconds(f, arch) for f in feats])
    assert np.array_equal(batched, scalar)
    assert np.isfinite(scalar).all()        # every admitted config runs


@pytest.mark.parametrize("n", (1, 3, 64))
@pytest.mark.parametrize("name", NAMES)
def test_rows_endpoints_match_evaluate_many(name, n, problems):
    """``trials_for_rows``, ``objectives_for_rows`` and
    ``objectives_for_rows_archs`` agree exactly with ``evaluate_many``,
    from a single row up, all through the columnar path (as the
    reference's ``test_kernels.py`` holds its kernels)."""
    prob = problems[name]
    rows = sample_rows(prob, n, n)
    cfgs = prob.space.compiled().decode_many(rows)
    for arch in ARCH_NAMES:
        want = [t.objective for t in prob.evaluate_many(cfgs, arch)]
        got_t = prob.trials_for_rows(rows, arch)
        assert [t.objective for t in got_t] == want
        assert [t.config for t in got_t] == cfgs
        assert all(t.arch == arch for t in got_t)
        assert prob.objectives_for_rows(rows, arch).tolist() == want
        assert [prob.evaluate(c, arch).objective for c in cfgs] == want
    multi = prob.objectives_for_rows_archs(rows, ARCH_NAMES)
    per_arch = prob.trials_for_rows_archs(rows, ARCH_NAMES)
    for i, arch in enumerate(ARCH_NAMES):
        want = [t.objective for t in prob.evaluate_many(cfgs, arch)]
        assert multi[i].tolist() == want
        assert [t.objective for t in per_arch[i]] == want


def test_sampled_and_exhaustive_take_the_model(problems):
    """The paper's protocols answer a model id through the columnar path:
    the whole space of conv2d at 4096^2 on the host, every config finite."""
    prob = problems["conv2d_h100"]
    trials = prob.exhaustive("h100sxm")
    assert len(trials) == prob.space.compiled().n_valid == 6112
    assert all(t.ok and t.arch == "h100sxm" for t in trials)
    assert prob.archs() == ARCH_NAMES
    assert prob.arch_independent_features


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_estimate_seconds_many_is_the_scalar_model(arch, problems):
    """The list convenience gives ``estimate_seconds`` config by config."""
    prob = problems["hotspot_h100"]
    cfgs = prob.space.compiled().decode_many(sample_rows(prob, 9, 4))
    feats = [prob.features(c, arch) for c in cfgs]
    assert costmodel.estimate_seconds_many(feats, arch) == \
        [estimate_seconds(f, arch) for f in feats]
    assert costmodel.estimate_seconds_many([], arch) == []


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_roofline_terms(arch, problems):
    """The ideal roofline at the peak rates: GEMM's default is bound by
    the tensor cores' 2 m n k FLOPs, a copy by its HBM bytes."""
    gen = GPU_GENERATIONS[arch]
    gemm = problems["gemm_h100"]
    f = gemm.features(gemm.space.valid_configs()[0], arch)
    r = costmodel.roofline_terms(f, arch)
    assert r["compute_s"] == max(2.0 * 4096 ** 3 / gen.peak_tc_bf16,
                                 f.f32_inst / gen.f32_inst,
                                 f.sfu_ops / gen.sfu)
    assert r["memory_s"] == f.hbm_bytes / gen.hbm_bw
    assert r["bound"] == "compute"
    copy = KernelFeatures(f32_inst=1e6, hbm_bytes=1e9)
    assert costmodel.roofline_terms(copy, arch) == {
        "compute_s": 1e6 / gen.f32_inst, "memory_s": 1e9 / gen.hbm_bw,
        "bound": "memory"}


# ------------------------------------------------------------------ #
# configs that cannot run
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inf_past_a_blocks_shared_memory(arch):
    ok = KernelFeatures(f32_inst=1e9, smem_per_block=SMEM_PER_BLOCK,
                        threads=128, blocks=1000)
    assert math.isfinite(estimate_seconds(ok, arch))
    over = dataclasses.replace(ok, smem_per_block=SMEM_PER_BLOCK + 1)
    assert estimate_seconds(over, arch) == math.inf
    batch = estimate_seconds_batch(FeatureBatch.from_features([ok, over]),
                                   arch)
    assert math.isfinite(batch[0]) and batch[1] == math.inf


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inf_at_zero_resident_blocks(arch):
    """A block whose registers (allocated per warp in units of 256) exceed
    the SM's 65 536 leaves no block resident; so do more threads than the
    SM holds."""
    ok = KernelFeatures(f32_inst=1e9, threads=256, regs=255, blocks=1000)
    assert costmodel._resident(GPU_GENERATIONS[arch], 0.0, 256, 255) == 1
    regs = dataclasses.replace(ok, threads=288)     # 9 warps x 8192 regs
    threads = dataclasses.replace(ok, threads=4096, regs=16)
    for f in (regs, threads):
        assert estimate_seconds(f, arch) == math.inf
    batch = estimate_seconds_batch(
        FeatureBatch.from_features([ok, regs, threads]), arch)
    assert math.isfinite(batch[0]) and (batch[1:] == math.inf).all()


# ------------------------------------------------------------------ #
# routing by arch id
# ------------------------------------------------------------------ #
def test_arch_routes_to_the_model_or_the_measurement():
    """On one problem: a model id is host arithmetic, ``None`` or the
    device's id is measured (here the plain version on the host, at the
    small shape), any other id raises."""
    cls = BENCHMARKS["gemm_h100"]
    prob = cls(shape=cls.small_shape, device="cpu", repeats=1, warmup=0)
    cfg = prob.space.valid_configs()[0]
    model = prob.evaluate(cfg, "h100sxm")
    assert model.arch == "h100sxm" and "features" in model.info
    measured = prob.evaluate(cfg)
    assert measured.arch == prob.arch == "cpu"
    assert "median_s" in measured.info
    assert prob.evaluate(cfg, "cpu").arch == "cpu"
    for foreign in ("h100", "v5e", "h100.sxm"):
        with pytest.raises(ValueError):
            prob.evaluate(cfg, foreign)
        with pytest.raises(ValueError):
            prob.objectives_for_rows([prob.space.flat_index(cfg)] * 9,
                                     foreign)


def test_multi_arch_endpoints_refuse_a_measured_arch(problems):
    """A measurement cannot be shared across arches, so the multi-arch
    endpoints take only the model's ids; an unknown id raises too."""
    prob = problems["nbody_h100"]
    rows = sample_rows(prob, 16, 0)
    for archs in (("h100sxm", prob.arch), (prob.arch,), ("h100sxm", "v5e"),
                  ("h100",)):
        with pytest.raises(ValueError):
            prob.objectives_for_rows_archs(rows, archs)
        with pytest.raises(ValueError):
            prob.trials_for_rows_archs(rows, archs)


# ------------------------------------------------------------------ #
# the counts against the kernels' helpers
# ------------------------------------------------------------------ #
def test_conv2d_shared_words_are_the_kernels(problems):
    """conv2d's shared words a tap are ``kernel.loads_per_fma``, with the
    filter's (one word per col_chunk taps with ``filter_smem``) read by a
    whole warp at once."""
    prob = problems["conv2d_h100"]
    f = prob.shape["fh"]
    for cfg in prob.space.compiled().decode_many(sample_rows(prob, 50, 1)):
        feats = prob.features(cfg, "h100sxm")
        oh = prob.shape["h"] - f + 1
        ow = prob.shape["w"] - f + 1
        blocks = -(-oh // cfg["block_h"]) * -(-ow // cfg["block_w"])
        taps = blocks * cfg["block_h"] * cfg["block_w"] * f * f
        filt = cfg["filter_smem"] / cfg["col_chunk"]
        assert feats.smem_words / taps == pytest.approx(
            ckernel.loads_per_fma(cfg, f) - filt + filt / 32, rel=1e-12)
        assert feats.smem_per_block == ckernel.smem_bytes(
            cfg["block_h"], cfg["block_w"], f, cfg["filter_smem"])


def test_dedisp_reads_are_the_kernels(problems):
    """dedisp's window words an add are ``kernel.reads_per_add`` on the
    shape's delay table, and its shared memory the ring ``config_stages``
    builds."""
    prob = problems["dedisp_h100"]
    c, d, t_out = (prob.shape[k] for k in ("c", "d", "t_out"))
    t_in = t_out + 8192
    delays = np.minimum(dref.make_delays(c, d), t_in - t_out)
    for cfg in prob.space.compiled().decode_many(sample_rows(prob, 12, 2)):
        feats = prob.features(cfg, "h100sxm")
        reads = dkernel.reads_per_add(delays, cfg["unroll_d"])
        assert feats.smem_words / (feats.f32_inst / (
            1.0 + reads + (3.0 if cfg["acc_dtype"] == "bf16" else 0.0))) \
            == pytest.approx(reads, rel=1e-12)
        assert feats.stages == dkernel.config_stages(cfg, c, t_out, t_in)


def test_the_counts_match_the_bounds(problems):
    """At the default config the model's work is the bound's
    (``chip_smoke.py``): GEMM's 2 m n k tensor FLOPs, attention's causal
    pairs (with skip_masked, within the tiles of the diagonal), nbody's and
    expdist's pairs as special-function results."""
    gemm = problems["gemm_h100"]
    f = gemm.features(gemm.space.valid_configs()[0], "h100sxm")
    assert f.tc_flops == 2.0 * 4096 ** 3
    nb = problems["nbody_h100"]
    f = nb.features(dict(nb.space.valid_configs()[0],
                         rsqrt_method="approx"), "h100sxm")
    assert f.sfu_ops == 131072.0 ** 2
    ex = problems["expdist_h100"]
    cfg = dict(ex.space.valid_configs()[0], block_i=512, block_j=1024)
    assert ex.features(cfg, "h100sxm").sfu_ops == 2.0 * 65536 ** 2
    att = problems["flash_attention_h100"]
    visible = 32 * 4096 * 4097 / 2
    for cfg in att.space.valid_configs():
        pairs = att.features(cfg, "h100sxm").sfu_ops
        if cfg["skip_masked"]:
            assert visible <= pairs < visible * 1.05
        else:
            assert pairs == 32.0 * 4096 * 4096


# ------------------------------------------------------------------ #
# Fig 5 and the landscape on the model
# ------------------------------------------------------------------ #
def test_portability_matrix_matches_the_reference():
    """The port's copy gives the JAX package's output on tables of the
    same numpy-seeded objectives (some configs invalid on some arches)."""
    rng = np.random.default_rng(7)
    configs = [(i % 5, i // 5) for i in range(40)]
    tables = {}
    for pkg in (jresults, tresults):
        tables[pkg] = {}
    for a in ("h100", "h100sxm", "h100pcie"):
        obj = rng.uniform(1e-4, 1e-2, len(configs)).tolist()
        obj[int(rng.integers(len(configs)))] = math.inf
        for pkg in (jresults, tresults):
            tables[pkg][a] = pkg.ResultTable(
                problem="p", arch=a, param_names=("x", "y"),
                configs=list(configs), objectives=list(obj))
    want = jportability.portability_matrix(tables[jresults])
    got = portability_matrix(tables[tresults])
    assert got == want


def test_landscape_on_the_model_exhaustive(capsys):
    """``landscape.main`` with a model id at nbody's full shape on the
    host: the whole space, the five results and Fig 5 over both ids."""
    out = landscape.main(problem="nbody_h100", device="cpu",
                         arch="h100sxm")
    assert out["table"].protocol == "exhaustive"
    assert out["table"].arch == "h100sxm" and len(out["table"]) == 960
    assert out["invalid"] == 0
    assert out["portability"]["archs"] == ["h100sxm", "h100pcie"]
    text = capsys.readouterr().out
    for fig in ("Fig 2", "Fig 3", "Fig 4", "Fig 5", "Fig 6", "Table VIII"):
        assert fig in text
    assert "measured" not in text and "took" not in text


def test_landscape_on_the_model_sampled(capsys):
    """A sampled problem on the model: ``samples`` configs of the full
    space, seeded as the measured protocol seeds them."""
    out = landscape.main(problem="expdist_h100", device="cpu",
                         arch="h100pcie", samples=300)
    assert out["table"].protocol == "sampled:300:0"
    assert len(out["table"]) == 300 and out["table"].arch == "h100pcie"
    assert out["portability"]["archs"] == ["h100pcie", "h100sxm"]
    assert "Fig 5" in capsys.readouterr().out


def test_landscape_refuses_a_foreign_arch():
    with pytest.raises(ValueError):
        landscape.main(problem="nbody_h100", device="cpu", small=True,
                       arch="v5e")


# ------------------------------------------------------------------ #
# the fit
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def refit():
    return calibrate.fit(calibrate.load_rows())


def test_fit_reproduces_the_committed_constants(refit):
    """Least squares on the committed rows gives ``costmodel.FIT`` to
    1e-9 relative, within the fit's bounds."""
    names = [f.name for f in dataclasses.fields(costmodel.Fit)]
    for name, (lo, hi) in zip(names, calibrate.BOUNDS):
        got, want = getattr(refit, name), getattr(costmodel.FIT, name)
        assert got == pytest.approx(want, rel=1e-9), name
        assert lo * (1 - 1e-9) <= want <= hi * (1 + 1e-9)


def test_rows_file_and_the_rho_perf_records():
    """The committed rows: at most 256 per problem, each a flat index of an
    admitted config, with the run that made them; and Spearman's rho of
    the committed model on them, as PERF.md records it."""
    rows = calibrate.load_rows()
    assert "chip run" in rows["source"] and "H100" in rows["nvidia_smi"]
    assert set(rows["problems"]) == set(BENCHMARKS)
    for name, pairs in rows["problems"].items():
        prob = BENCHMARKS[name](device="cpu")
        assert 0 < len(pairs) <= calibrate.MAX_ROWS
        r = np.array([p[0] for p in pairs])
        assert prob.space.compiled().mask[r].all()
        assert all(p[1] > 0 for p in pairs)
    line = next(l for l in (ROOT / "PERF.md").read_text().splitlines()
                if l.startswith("`calibrate` rho on its rows:"))
    recorded = dict((n, float(v)) for n, v in
                    re.findall(r"(\w+_h100) (\d\.\d{4})", line))
    report = calibrate.report(rows)
    assert set(recorded) == set(report)
    for name, r in report.items():
        assert round(r["rho"], 4) == recorded[name], name


def test_spearman():
    assert calibrate.spearman([1, 2, 3, 4], [10, 20, 30, 40]) == 1.0
    assert calibrate.spearman([1, 2, 3, 4], [4, 3, 2, 1]) == -1.0
    a = np.random.default_rng(0).standard_normal(50)
    from scipy.stats import spearmanr
    b = a + np.random.default_rng(1).standard_normal(50)
    assert calibrate.spearman(a, b) == pytest.approx(spearmanr(a, b)[0],
                                                     rel=1e-12)
