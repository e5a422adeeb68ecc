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


# ------------------------------------------------------------------ #
# the on-disk space-table cache
# ------------------------------------------------------------------ #
def test_fingerprint_is_the_references(pair):
    from repro.core.spacetable import space_fingerprint as jfp
    from repro_torch.core.spacetable import space_fingerprint as tfp
    j, t, _, _ = pair
    assert tfp(t) == jfp(j)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_are_shared_with_the_jax_package(writer, tmp_path):
    """A table cached by either package loads in the other, its mask and
    its neighbour tables (persisted when first built) from disk."""
    from repro.core.spacetable import CompiledSpace as JC
    from repro_torch.core.spacetable import CompiledSpace as TC
    port = build_space(256, 256, 512)
    ref = rebuild(port, jspace)
    first, second = (JC, TC) if writer == "jax" else (TC, JC)
    fresh = {JC: lambda: rebuild(port, jspace),
             TC: lambda: rebuild(ref, tspace)}
    comp = first.build(fresh[first](), cache_dir=tmp_path)
    indptr, indices = comp.csr_neighbors()
    (path,) = tmp_path.glob("*.npz")
    assert comp.cache_path == path
    loaded = second.build(fresh[second](), cache_dir=tmp_path)
    assert loaded.cache_path == path and loaded._nbr_indptr is not None
    assert np.array_equal(loaded.mask, comp.mask)
    lp, li = loaded.csr_neighbors()
    assert np.array_equal(lp, indptr) and np.array_equal(li, indices)


def test_cache_mismatch_and_corrupt_file_rebuild(tmp_path):
    from repro_torch.core.spacetable import CompiledSpace, space_fingerprint
    s = build_space(256, 256, 512)
    CompiledSpace.build(s, cache_dir=tmp_path)
    other = build_space(128, 128, 128)          # same name, other closures
    assert space_fingerprint(other) != space_fingerprint(s)
    comp = CompiledSpace.build(other, cache_dir=tmp_path)
    assert np.array_equal(comp.mask, other.compiled().mask)
    path = tmp_path / f"{s.name}-{space_fingerprint(s)}.npz"
    path.write_bytes(b"not an npz")
    comp = CompiledSpace.build(rebuild(s, tspace), cache_dir=tmp_path)
    assert np.array_equal(comp.mask, s.compiled().mask)


def test_set_cache_dir_and_the_environment(tmp_path, monkeypatch):
    """``REPRO_SPACE_CACHE`` applies while no directory is set;
    ``set_cache_dir(None)`` turns caching off, the variable too; a
    directory set wins over it.  ``repro_torch.core`` re-exports it."""
    import repro_torch.core as core
    from repro_torch.core import spacetable as st
    assert core.set_cache_dir is st.set_cache_dir
    monkeypatch.setattr(st, "_cache_dir", st._UNSET)
    monkeypatch.setenv("REPRO_SPACE_CACHE", str(tmp_path / "env"))
    assert st.get_cache_dir() == tmp_path / "env"
    st.CompiledSpace.build(build_space(256, 256, 512))
    assert len(list((tmp_path / "env").glob("gemm_h100-*.npz"))) == 1
    st.set_cache_dir(None)
    assert st.get_cache_dir() is None
    assert st.CompiledSpace.build(build_space(256, 256, 512)).cache_path \
        is None
    st.set_cache_dir(tmp_path / "set")
    assert st.get_cache_dir() == tmp_path / "set"
