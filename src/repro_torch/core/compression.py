"""Shared optional-zstd compression for cachefiles and checkpoints.

zstd when the ``zstandard`` package is installed (the ``[fast]`` extra),
stdlib zlib otherwise.  The codec is identified by the frame header — zstd
frames start with the magic ``28 B5 2F FD``, zlib streams with ``0x78`` —
so blobs written by either path load under the other (reading a zstd blob
does require zstandard).
"""

from __future__ import annotations

import zlib

try:  # optional fast path: pip install .[fast]
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

# zstd contexts carry large internal state; build once per (process, level)
_COMPRESSORS: dict[int, "zstandard.ZstdCompressor"] = {}
_DCTX = zstandard.ZstdDecompressor() if zstandard else None


def compress(payload: bytes, level: int = 6) -> bytes:
    if zstandard is not None:
        ctx = _COMPRESSORS.get(level)
        if ctx is None:
            ctx = _COMPRESSORS[level] = zstandard.ZstdCompressor(level=level)
        return ctx.compress(payload)
    return zlib.compress(payload, min(level, 9))


def decompress(blob: bytes, what: str = "data") -> bytes:
    """Header-sniffing decompress; ``what`` names the blob in errors."""
    if blob[:4] == ZSTD_MAGIC:
        if _DCTX is None:
            raise RuntimeError(
                f"{what} is zstd-compressed but zstandard is not installed; "
                "pip install zstandard (or the [fast] extra) to read it")
        return _DCTX.decompress(blob)
    return zlib.decompress(blob)
