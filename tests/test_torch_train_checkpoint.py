"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's on the CPU: each restores what the other wrote, bf16 leaves
included, byte for byte (the shards' payloads are equal), and the port's
msgpack codec writes what ``msgpack.packb`` writes and reads what it
reads.  Then the counterparts of ``tests/test_checkpoint.py``'s first
seven tests.  Every comparison is exact: nothing here computes."""

from __future__ import annotations

import zlib
from pathlib import Path

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def _numpy_tree(seed=0) -> dict:
    """A dict of numpy arrays, one of them bf16 (ml_dtypes'), nested."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": np.asarray(rng.standard_normal(16), dtype=jnp.bfloat16),
            "nested": {"m": np.full((4,), 3, np.int32),
                       "z": [np.arange(5, dtype=np.uint8),
                             np.float32(2.5) * np.ones((2, 2), np.float32)]},
            "step": np.asarray(7, np.int32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _equal(got, want) -> None:
    """Leaf for leaf, dtype and values, a torch tree against a numpy one."""
    g, w = ckpt._flatten(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.float().numpy(), b.astype(np.float32))
        else:
            assert a.numpy().dtype == b.dtype
            assert np.array_equal(a.numpy(), b)


def _payload(d: Path) -> bytes:
    return ckpt._decompress((d / ckpt.SHARD).read_bytes())


def test_the_leaves_line_up_with_jax_tree_flatten():
    tree = _numpy_tree()
    assert [np.asarray(x).tobytes() for x in ckpt._flatten(tree)] \
        == [np.asarray(x).tobytes() for x in jax.tree.leaves(tree)]
    assert ckpt._flatten({"a": None, "b": (1, [2, None])}) == [1, 2]


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _numpy_tree()
    jck.save(tmp_path / "jax", 3, tree, extra={"step": 3, "model": "m"})
    got, extra = ckpt.restore(tmp_path / "jax",
                              _zeros_like(_as_torch(tree)))
    assert extra == {"step": 3, "model": "m"}
    _equal(got, tree)


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    tree = _numpy_tree(1)
    ckpt.save(tmp_path / "port", 5, _as_torch(tree), extra={"step": 5})
    got, extra = jck.restore(tmp_path / "port",
                             jax.eval_shape(lambda: tree))
    assert extra == {"step": 5}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_both_packages_write_the_same_payload_and_meta(tmp_path):
    tree = _numpy_tree(2)
    dj = jck.save(tmp_path / "jax", 9, tree, extra={"step": 9})
    dp = ckpt.save(tmp_path / "port", 9, _as_torch(tree), extra={"step": 9})
    assert _payload(dp) == _payload(dj)
    mj = msgpack.unpackb((dj / "meta.msgpack").read_bytes())
    mp = msgpack.unpackb((dp / "meta.msgpack").read_bytes())
    assert mj.pop("treedef") and mp.pop("treedef")      # diagnostic only
    assert mp == mj
    assert [m["dtype"] for m in mp["leaves"]].count("bfloat16") == 1


MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65_535, 65_536,
    2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32_768,
    -32_769, -2**31, -2**31 - 1, -2**63, 0.5, -1.25e300, "", "x" * 31,
    "y" * 32, "z" * 255, "w" * 256, "v" * 65_536, "ünïcode", [], list(range(15)),
    list(range(16)), list(range(70_000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, None] for i in range(16)},
    {"step": 12, "leaves": [{"shape": [4096, 4096], "dtype": "bfloat16",
                             "offset": 2**34, "nbytes": 2**25}],
     "crc32": 4_000_000_000, "extra": {"model": "qwen3-8b"}, "format": 1},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=[f"case{i}" for i in range(len(MSGPACK_CASES))])
def test_msgpack_codec_matches_the_package(obj):
    want = msgpack.packb(obj)
    assert ckpt.packb(obj) == want
    assert ckpt.unpackb(want) == msgpack.unpackb(want) == obj
    assert ckpt.unpackb(ckpt.packb(obj)) == obj


def test_msgpack_codec_refuses_what_the_meta_never_holds():
    """Bytes, single floats and objects are neither written nor read; a
    trailing byte is refused."""
    with pytest.raises(TypeError):
        ckpt.packb({"a": object()})
    with pytest.raises(TypeError):
        ckpt.packb(b"\x00")
    for blob in (msgpack.packb(b"\x00\x01"),
                 msgpack.packb(1.5, use_single_float=True)):
        with pytest.raises(ValueError, match="not read here"):
            ckpt.unpackb(blob)
    with pytest.raises(ValueError, match="after the object"):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")


# ------------------------------------------------------------------ #
# the counterparts of tests/test_checkpoint.py
# ------------------------------------------------------------------ #
def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=gen),
            "b": torch.arange(16, dtype=torch.bfloat16),
            "nested": {"m": torch.full((4,), 3, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 7, t, extra={"step": 7, "note": "x"})
    got, extra = ckpt.restore(tmp_path, _zeros_like(t))
    assert extra["step"] == 7
    for a, b in zip(ckpt._flatten(t), ckpt._flatten(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(kept) == 2 and kept[-1].endswith("000000005")


def test_crash_mid_save_leaves_previous_intact(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    tmp_dir = Path(tmp_path) / "step_000000002.tmp"
    tmp_dir.mkdir()
    (tmp_dir / "junk").write_bytes(b"partial")
    assert ckpt.latest_step(tmp_path) == 1
    got, _ = ckpt.restore(tmp_path, _zeros_like(t))
    assert torch.equal(got["w"], t["w"])
    ckpt.save(tmp_path, 3, t)                    # sweeps the tmp litter
    assert not tmp_dir.exists()


def test_corrupt_shard_fails_loudly(tmp_path):
    t = _tree()
    d = ckpt.save(tmp_path, 1, t)
    shard = d / ckpt.SHARD
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    like = _zeros_like(t)
    with pytest.raises(IOError, match="crc32"):
        ckpt.restore(tmp_path, like)
    assert not like["w"].any()               # nothing half-restored


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, {"only": torch.zeros(3)})
    wrong = _zeros_like(_tree())
    wrong["w"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, wrong)
    assert not wrong["nested"]["m"].any()      # checked before any copy


def test_restore_places_leaves_in_the_targets_dtype(tmp_path):
    """The port's elastic restore: each leaf goes into the target's tensor
    wherever it lives and in its dtype (f32 targets for bf16 leaves and
    the other way round), as the JAX restore casts to ``want.dtype``."""
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    like = {"w": torch.zeros(8, 16, dtype=torch.bfloat16),
            "b": torch.zeros(16), "nested": {"m": torch.zeros(4)}}
    got, _ = ckpt.restore(tmp_path, like)
    assert got is like
    assert torch.equal(like["w"], t["w"].to(torch.bfloat16))
    assert torch.equal(like["b"], t["b"].float())
    assert torch.equal(like["nested"]["m"], torch.full((4,), 3.0))


def test_latest_falls_back_when_pointer_stale(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    ckpt.save(tmp_path, 2, t)
    (Path(tmp_path) / "LATEST").write_text("99")     # stale pointer
    assert ckpt.latest_step(tmp_path) == 2


def test_save_is_idempotent(tmp_path):
    t = _tree()
    d = ckpt.save(tmp_path, 4, t)
    before = (d / ckpt.SHARD).read_bytes()
    t["w"].add_(1.0)
    assert ckpt.save(tmp_path, 4, t) == d
    assert (d / ckpt.SHARD).read_bytes() == before
    assert zlib.crc32(before) == ckpt.unpackb(
        (d / "meta.msgpack").read_bytes())["crc32"]
