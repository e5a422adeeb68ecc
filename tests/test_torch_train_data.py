"""The port's synthetic token pipeline (``repro_torch.data``) against the
JAX package's (``repro.data``): both are numpy, so the same seed, step and
host split give the same bytes, and the same Markov source the same
entropy floor, exactly.  Then the counterparts of
``tests/test_data_pipeline.py``'s contract tests on the port."""

from __future__ import annotations

import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import make_pipeline as jax_pipeline
from repro_torch.data import DataConfig, make_pipeline


def _cfg(**kw):
    base = dict(vocab=256, seq_len=64, global_batch=8, seed=13)
    base.update(kw)
    return base


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 13, 2**31 - 1])
def test_batch_at_is_byte_equal_to_the_jax_pipelines(seed, n_hosts):
    kw = _cfg(seed=seed, vocab=1000, seq_len=48)
    for host in range(n_hosts):
        port = make_pipeline(DataConfig(**kw), host, n_hosts)
        ref = jax_pipeline(JaxDataConfig(**kw), host, n_hosts)
        for step in (0, 5, 1000):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].shape == want[k].shape
                assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(vocab=512, branching=4),
                                dict(seed=7, vocab=151_936, seq_len=8,
                                     global_batch=1)])
def test_entropy_floor_equals_the_jax_pipelines(kw):
    kw = _cfg(**kw)
    port = make_pipeline(DataConfig(**kw))
    ref = jax_pipeline(JaxDataConfig(**kw))
    assert port.entropy_floor() == ref.entropy_floor()
    assert port[3]["tokens"].tobytes() == ref[3]["tokens"].tobytes()


def test_deterministic_and_resumable():
    p1 = make_pipeline(DataConfig(**_cfg()))
    p2 = make_pipeline(DataConfig(**_cfg()))     # fresh process, same seed
    for step in (0, 5, 1000):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_host_sharding_consistency():
    full = make_pipeline(DataConfig(**_cfg())).batch_at(7)
    h0 = make_pipeline(DataConfig(**_cfg()), host_id=0, n_hosts=2).batch_at(7)
    h1 = make_pipeline(DataConfig(**_cfg()), host_id=1, n_hosts=2).batch_at(7)
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([h0["tokens"], h1["tokens"]]))
    q0 = make_pipeline(DataConfig(**_cfg()), host_id=0, n_hosts=4).batch_at(7)
    np.testing.assert_array_equal(full["tokens"][:2], q0["tokens"])


def test_labels_are_shifted_tokens():
    b = make_pipeline(DataConfig(**_cfg())).batch_at(3)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


def test_tokens_in_vocab_and_shapes():
    b = make_pipeline(DataConfig(**_cfg(vocab=100, seq_len=32,
                                        global_batch=4))).batch_at(0)
    assert b["tokens"].shape == (4, 32)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 100


def test_markov_structure_is_learnable():
    p = make_pipeline(DataConfig(**_cfg(vocab=512, branching=16)))
    floor = p.entropy_floor()
    assert 0.0 < floor < 0.75 * np.log(512)


def test_bad_host_split_rejected():
    with pytest.raises(ValueError):
        make_pipeline(DataConfig(**_cfg(global_batch=5)), host_id=0,
                      n_hosts=2)
