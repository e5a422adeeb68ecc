"""Which device a run is on, and its arch id.

Every entry point of the port runs on the card unless the caller asks for
the CPU.  :func:`resolve` turns a ``device`` argument (default ``"cuda"``)
into a :class:`torch.device` and raises when a CUDA device is asked for on
a host that has none, so a run never falls back to the host silently.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

#: the capability the port's kernels are compiled for (``sm_90a``)
HOPPER = (9, 0)


def resolve(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a :class:`torch.device`; raises
    if it names a CUDA device and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    return dev


def arch_id(device) -> str:
    """The arch id results are recorded under: ``"cpu"`` on the host, else
    the card's model, e.g. ``"h100"`` (no dots: ``ResultsDB`` splits file
    names on them)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    name = torch.cuda.get_device_name(dev)
    m = re.search(r"\b([A-Z]\d{2,4}[A-Z]?)\b", name)
    return (m.group(1) if m else re.sub(r"[^A-Za-z0-9]", "", name)).lower()


@dataclass(frozen=True)
class DeviceInfo:
    name: str
    arch: str
    capability: tuple[int, int]
    sm_count: int
    total_memory: int           # bytes

    @property
    def hopper(self) -> bool:
        return self.capability == HOPPER


def probe(device=None) -> DeviceInfo:
    """Name, arch id, capability, SM count and memory of a CUDA device."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"probe needs a CUDA device, not {dev}")
    props = torch.cuda.get_device_properties(dev)
    return DeviceInfo(name=props.name, arch=arch_id(dev),
                      capability=(props.major, props.minor),
                      sm_count=props.multi_processor_count,
                      total_memory=props.total_memory)
