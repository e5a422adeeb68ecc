"""The port's copies of ``SearchSpace``/``CompiledSpace`` against the JAX
package's: the same space built from either package's classes has identical
tables and draws.  And the port's ``gemm_h100`` space audits clean under the
JAX package's space auditor (``flash_attention_h100``'s audit is in
``test_torch_attention.py``)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.matmul.space import GemmProblem as JaxGemm  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.attention.space import \
    build_space as build_attention  # noqa: E402
from repro_torch.kernels.matmul.space import (SMALL_SHAPE,  # noqa: E402
                                              build_space)


def rebuild(space, mod):
    """``space`` rebuilt param for param with module ``mod``'s classes,
    reusing its predicate callables."""
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


def _pairs():
    ref = JaxGemm().space
    port = build_space(4096, 4096, 4096)
    port_attn = build_attention(32, 8, 4096, 4096, 128)
    return {
        "reference_gemm": (ref, rebuild(ref, tspace)),
        "gemm_h100": (rebuild(port, jspace), port),
        "flash_attention_h100": (rebuild(port_attn, jspace), port_attn),
    }


PAIRS = _pairs()


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    j, t = PAIRS[request.param]
    return j, t, j.compiled(), t.compiled()


def test_cardinality_and_valid_mask(pair):
    j, t, jc, tc = pair
    assert j.cardinality == t.cardinality
    assert np.array_equal(jc.mask, tc.mask)
    assert np.array_equal(jc.valid_rows, tc.valid_rows)
    assert 0 < len(tc.valid_rows) < t.cardinality


def test_csr_neighbour_tables(pair):
    j, t, jc, tc = pair
    for a, b in zip(jc.csr_neighbors(), tc.csr_neighbors()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_distinct(pair, seed):
    j, t, _, _ = pair
    assert j.sample_distinct(50, seed) == t.sample_distinct(50, seed)


def test_from_flat_index_and_encode(pair):
    j, t, _, _ = pair
    rng = np.random.default_rng(3)
    for idx in rng.integers(0, t.cardinality, 200).tolist():
        cfg = t.from_flat_index(idx)
        assert cfg == j.from_flat_index(idx)
        assert t.flat_index(cfg) == j.flat_index(cfg) == idx
        assert t.satisfies(cfg) == j.satisfies(cfg)


@pytest.mark.parametrize("port", [
    build_space(4096, 4096, 4096), build_space(256, 256, 512),
    build_attention(32, 8, 4096, 4096, 128),
    build_attention(4, 2, 128, 256, 64)],
    ids=["gemm", "gemm_small", "attention", "attention_small"])
def test_python_and_vector_constraints_agree(port):
    """The port space's scalar predicates and ``vec=`` forms are the same
    function: the mask built from each agrees row for row."""
    scalar_only = tspace.SearchSpace(
        port.params, [tspace.Constraint(c.name, c.fn) for c in port.constraints],
        name=port.name + "_scalar")
    assert np.array_equal(port.compiled().mask, scalar_only.compiled().mask)


@pytest.mark.parametrize("shape", [(4096, 4096, 4096),
                                   tuple(SMALL_SHAPE.values())],
                         ids=["paper", "small"])
def test_gemm_h100_audits_clean(shape):
    rep = audit_space(rebuild(build_space(*shape), jspace))
    checks = {f.check for f in rep.findings}
    assert rep.ok, rep.render()
    assert not checks & {"unsatisfiable", "dead-value", "disconnected"}
    assert rep.n_components == 1


@pytest.mark.parametrize("seed", [0, 5])
def test_neighbour_draws(pair, seed):
    """The row-native neighbour moves the tuners walk with: the legacy
    rejection draw, the alias tables and the alias draw are the JAX
    package's, draw for draw."""
    import random
    _, _, jc, tc = pair
    assert np.array_equal(jc.edge_params(), tc.edge_params())
    for a, b in zip(jc.neighbor_alias(), tc.neighbor_alias()):
        assert np.array_equal(a, b)
    jr, tr = random.Random(seed), random.Random(seed)
    rows = tc.valid_rows[np.random.default_rng(seed).integers(
        0, len(tc.valid_rows), 100)].tolist()
    for r in rows:
        assert tc.random_neighbor_row(r, tr) == jc.random_neighbor_row(r, jr)
        assert tc.sample_neighbor_alias(r, tr) \
            == jc.sample_neighbor_alias(r, jr)
    assert tr.random() == jr.random()
