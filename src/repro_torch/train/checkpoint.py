"""Elastic checkpointing (msgpack meta + compressed shard, atomic rename
commit): the port of ``repro.train.checkpoint``, in its layout, so that
either package reads what the other wrote.

Layout (one directory per step)::

    <root>/step_000000123/
        meta.msgpack            # step, tree structure, per-leaf shape/dtype
        shard_00000.bin.zst     # concatenated leaf bytes for this process
    <root>/LATEST               # text file: committed step number

The shard keeps the JAX package's name, which its ``restore`` opens.  Its
frame is zstd where the ``zstandard`` package is installed, else zlib
(``core/compression.py``); a reader sniffs the frame, whatever the name
says.  The meta is written and read by a small msgpack codec of this
module's own (:func:`packb`, :func:`unpackb`: maps, arrays, strings,
integers, floats, booleans and nil, encoded as the ``msgpack`` package
encodes them), since the card's host has no ``msgpack``.

Fault-tolerance contract:

* **Atomic commit** — writes go to ``step_N.tmp/``; the directory is renamed
  and only then is ``LATEST`` updated (rename is atomic on POSIX).  A crash
  mid-save leaves the previous checkpoint intact; ``*.tmp`` litter is swept
  on the next save.
* **Integrity** — every shard carries a crc32; a truncated file fails loudly
  instead of silently training from garbage.
* **Retention** — keep the newest ``keep`` checkpoints (always ≥1).

* **Elastic restore** — leaves are stored whole: a DTensor leaf (a
  sharded run's) is gathered on save, and only rank 0 of the world
  writes.  ``restore`` copies into DTensor leaves each rank's own chunk,
  or, given ``shardings`` (a tree of specs) and a ``mesh``, places a new
  tree on that mesh: a run checkpointed on a 4x2 mesh restarts on 2x4 or
  on one device unchanged.

A tree is nested dicts, lists and tuples of tensors (or numpy arrays);
its leaves are taken as ``jax.tree.flatten`` takes them (dict keys sorted,
sequences in order, None holds no leaf), so a tree of the same keys lines
up leaf for leaf across the packages.  A bf16 tensor's bytes are written
as they are (through ``.view(torch.uint16)``: numpy has no bf16), under
the dtype name ``"bfloat16"``, the one the JAX package records.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.compression import compress, decompress

SHARD = "shard_00000.bin.zst"


def _compress(payload: bytes) -> bytes:
    return compress(payload, level=3)


def _decompress(blob: bytes) -> bytes:
    return decompress(blob, what="checkpoint shard")


# ------------------------------------------------------------------ #
# msgpack, the subset the meta uses
# ------------------------------------------------------------------ #
def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out += struct.pack("B", obj)
        elif -32 <= obj < 0:
            out += struct.pack("b", obj)
        elif obj >= 0:
            for tag, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                  (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([tag]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"integer {obj} does not fit msgpack")
        else:
            for tag, fmt, bottom in ((0xd0, ">b", -(1 << 7)),
                                     (0xd1, ">h", -(1 << 15)),
                                     (0xd2, ">i", -(1 << 31)),
                                     (0xd3, ">q", -(1 << 63))):
                if obj >= bottom:
                    out += bytes([tag]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out += bytes([0xa0 | n])
        elif n < 1 << 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 0xdc, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 0xde, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def _header(n: int, fix: int, tag16: int, out: bytearray) -> None:
    if n < 16:
        out += bytes([fix | n])
    elif n < 1 << 16:
        out += bytes([tag16]) + struct.pack(">H", n)
    else:
        out += bytes([tag16 + 1]) + struct.pack(">I", n)


def packb(obj) -> bytes:
    """``obj`` as ``msgpack.packb`` encodes it (its defaults: the smallest
    encoding of each integer, str types for strings, doubles)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xcb: ">d"}
_LENGTH = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
           0xde: ">H", 0xdf: ">I"}


def _unpack(buf: bytes, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xe0:
        return tag - 0x100, i
    if 0xa0 <= tag < 0xc0:
        n = tag & 0x1f
        return buf[i:i + n].decode("utf-8"), i + n
    if 0x90 <= tag < 0xa0:
        return _items(buf, i, tag & 0x0f, list)
    if 0x80 <= tag < 0x90:
        return _items(buf, i, tag & 0x0f, dict)
    if tag in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[tag], i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if tag in _LENGTH:
        fmt = _LENGTH[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if tag in (0xdc, 0xdd):
            return _items(buf, i, n, list)
        if tag in (0xde, 0xdf):
            return _items(buf, i, n, dict)
        return buf[i:i + n].decode("utf-8"), i + n
    raise ValueError(f"msgpack type 0x{tag:02x} is not read here")


def _items(buf: bytes, i: int, n: int, kind):
    if kind is list:
        out = []
        for _ in range(n):
            x, i = _unpack(buf, i)
            out.append(x)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """What ``msgpack.unpackb`` returns for ``data`` (arrays as lists), for
    the types :func:`packb` writes; any other raises ``ValueError``."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes after the object")
    return obj


# ------------------------------------------------------------------ #
# tree <-> flat leaves
# ------------------------------------------------------------------ #
def _flatten(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _structure(tree: Any) -> str:
    """A diagnostic string of the tree's structure, ``*`` a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor's whole value: a DTensor's gathered (collective: every rank
    calls it)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _writer() -> bool:
    """Whether this process writes (rank 0, or no process group)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _leaf_bytes(leaf) -> tuple[dict, bytes]:
    """A leaf's meta (shape, dtype name) and its bytes, C order."""
    if torch.is_tensor(leaf):
        t = _whole(leaf.detach()).to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return ({"shape": list(t.shape), "dtype": "bfloat16"},
                    t.view(torch.uint16).numpy().tobytes())
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return {"shape": list(a.shape), "dtype": str(a.dtype)}, a.tobytes()


def _leaf_tensor(payload: bytes, m: dict) -> torch.Tensor:
    """The tensor a leaf's meta describes, read from the payload."""
    count = int(np.prod(m["shape"], dtype=np.int64))
    bf16 = m["dtype"] == "bfloat16"
    a = np.frombuffer(payload, dtype=np.uint16 if bf16 else np.dtype(
        m["dtype"]), count=count, offset=m["offset"]).reshape(m["shape"])
    t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if bf16 else t


# ------------------------------------------------------------------ #
# save
# ------------------------------------------------------------------ #
def save(root: str | Path, step: int, tree: Any, *, extra: dict | None = None,
         keep: int = 3) -> Path:
    """Write checkpoint ``step``; returns the committed directory.  Under
    a process group of several ranks every rank calls it (DTensor leaves
    are gathered), rank 0 writes, and all return once it has."""
    root = Path(root)
    final = root / f"step_{step:09d}"
    if (final / "meta.msgpack").exists():
        return final                 # idempotent: step already committed

    payload = bytearray()
    metas = []
    for leaf in _flatten(tree):
        meta, raw = _leaf_bytes(leaf)
        metas.append(dict(meta, offset=len(payload), nbytes=len(raw)))
        payload.extend(raw)
    if not _writer():
        _barrier()
        return final
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    blob = _compress(bytes(payload))
    (tmp / SHARD).write_bytes(blob)
    meta = {
        "step": step,
        "treedef": _structure(tree),        # diagnostic only
        "leaves": metas,
        "crc32": zlib.crc32(blob),
        "extra": extra or {},
        "format": 1,
    }
    (tmp / "meta.msgpack").write_bytes(packb(meta))

    os.replace(tmp, final)                   # atomic commit
    latest_tmp = root / "LATEST.tmp"
    latest_tmp.write_text(str(step))
    os.replace(latest_tmp, root / "LATEST")

    _sweep(root, keep)
    _barrier()
    return final


def _sweep(root: Path, keep: int) -> None:
    for t in root.glob("step_*.tmp"):
        shutil.rmtree(t, ignore_errors=True)
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for s in steps[:-max(keep, 1)]:
        shutil.rmtree(root / f"step_{s:09d}", ignore_errors=True)


# ------------------------------------------------------------------ #
# restore
# ------------------------------------------------------------------ #
def latest_step(root: str | Path) -> int | None:
    p = Path(root) / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (Path(root) / f"step_{step:09d}" / "meta.msgpack").exists():
        # LATEST points at a swept/corrupt dir — fall back to newest on disk
        dirs = sorted(Path(root).glob("step_*"))
        dirs = [d for d in dirs if (d / "meta.msgpack").exists()]
        return int(dirs[-1].name.split("_")[1]) if dirs else None
    return step


@torch.no_grad()
def restore(root: str | Path, like: Any, *, step: int | None = None,
            shardings: Any = None, mesh=None) -> tuple[Any, dict]:
    """Load checkpoint ``step`` (default the newest) into ``like``, a tree
    of tensors of the target structure, in place: each leaf is copied
    into ``like``'s tensor, on its device and in its dtype (a DTensor
    leaf: this rank's chunk).  Returns ``(like, extra)``.  With
    ``shardings``, a tree of specs matching ``like``, and a ``mesh``, it
    returns instead a new tree of DTensors placed on ``mesh`` by them, in
    ``like``'s dtypes (the elastic-reload path: restore onto a different
    mesh); ``like`` is then only read for its structure, shapes and
    dtypes."""
    root = Path(root)
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:09d}"
    meta = unpackb((d / "meta.msgpack").read_bytes())
    blob = (d / SHARD).read_bytes()
    if zlib.crc32(blob) != meta["crc32"]:
        raise IOError(f"checkpoint {d} failed crc32 integrity check")
    payload = _decompress(blob)

    leaves = _flatten(like)
    if len(leaves) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves; target structure "
            f"has {len(leaves)} — architecture mismatch")
    for want, m in zip(leaves, meta["leaves"]):
        if tuple(m["shape"]) != tuple(want.shape):
            raise ValueError(f"leaf shape {tuple(m['shape'])} != target "
                             f"{tuple(want.shape)}")
    if shardings is not None:
        from ..distributed.sharding import place
        specs = iter(_flatten_specs(shardings))
        it = iter(meta["leaves"])

        def build(tree):
            if tree is None:
                return None
            if isinstance(tree, dict):
                return {k: build(tree[k]) for k in sorted(tree)}
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v) for v in tree)
            whole = _leaf_tensor(payload, next(it)).to(
                dtype=tree.dtype, device=mesh.device_type)
            return place(whole, next(specs), mesh)

        return build(like), meta.get("extra", {})
    for want, m in zip(leaves, meta["leaves"]):
        _copy_into(want, _leaf_tensor(payload, m))
    return like, meta.get("extra", {})


def _copy_into(want: torch.Tensor, whole: torch.Tensor) -> None:
    """Copy ``whole`` into ``want``: a DTensor takes its own chunk."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    with torch.no_grad():
        if isinstance(want, DTensor):
            chunk = distribute_tensor(
                whole.to(device=want.device, dtype=want.dtype),
                want.device_mesh, want.placements,
                src_data_rank=None).to_local()
            want.to_local().copy_(chunk)
        else:
            want.copy_(whole)


def _flatten_specs(tree: Any) -> list:
    """The specs of a tree of specs (tuples of axis names) in
    :func:`_flatten`'s order: a spec is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_specs(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flatten_specs(v)]
    return [tree]
