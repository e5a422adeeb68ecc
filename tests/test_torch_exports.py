"""The port's package exports against the JAX package's: ``__all__`` of
``core``, ``core.tuners``, ``core.surrogate``, ``telemetry``, ``kernels``,
``orchestrator``, ``staticcheck``, ``servedb``, ``kernels.attention``,
``models``, ``configs``, ``serve``, ``train`` and ``data`` name the same
things, apart from the named differences below, and every exported name
resolves."""

from __future__ import annotations

import importlib

import pytest

pytest.importorskip("torch")

#: package -> (names only the JAX package exports, names only the port
#: exports), each with its reason
DIFFERENCES = {
    # the TPU's generation table is the Hopper cards' in the port
    "core": ({"TPU_GENERATIONS"}, {"GPU_GENERATIONS"}),
    "core.tuners": (set(), set()),
    "core.surrogate": (set(), set()),
    "telemetry": (set(), set()),
    # the paper's sampled protocol and the launch counters are the port's
    "kernels": (set(), {"SAMPLED", "SAMPLE_N", "launch_counts"}),
    "orchestrator": (set(), set()),
    "staticcheck": (set(), set()),
    "servedb": (set(), set()),
    # the port's public op keeps its earlier name beside flash_attention
    "kernels.attention": (set(), {"attention"}),
    "models": (set(), set()),
    "configs": (set(), set()),
    "serve": (set(), set()),
    "train": (set(), set()),
    "data": (set(), set()),
}


@pytest.mark.parametrize("name", sorted(DIFFERENCES))
def test_all_differs_only_where_named(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    ref_all, port_all = set(ref.__all__), set(port.__all__)
    only_ref, only_port = DIFFERENCES[name]
    assert ref_all - port_all == only_ref
    assert port_all - ref_all == only_port
    for attr in port_all:
        assert hasattr(port, attr), f"repro_torch.{name}.{attr}"


def test_the_public_ops_are_the_ports_wrappers():
    """Each of the eight public ops is its package's ``ops`` wrapper, the
    one that counts launches; ``flash_attention`` is the attention op."""
    import repro_torch.kernels as k
    from repro_torch.kernels.attention import ops as attention_ops
    for op, home in (("gemm", "matmul"), ("conv2d", "conv2d"),
                     ("nbody", "nbody"), ("hotspot", "hotspot"),
                     ("pnpoly", "pnpoly"), ("expdist", "expdist"),
                     ("dedisp", "dedisp")):
        ops = importlib.import_module(f"repro_torch.kernels.{home}.ops")
        assert getattr(k, op) is getattr(ops, op)
    assert k.flash_attention is k.attention.flash_attention \
        is attention_ops.attention
    from repro_torch.kernels.attention.ref import mha_reference
    assert k.attention.mha_reference is mha_reference


def test_core_reexports_the_cost_model():
    import repro_torch.core as core
    from repro_torch.core import costmodel
    for name in ("KernelFeatures", "FeatureBatch", "estimate_seconds",
                 "estimate_seconds_batch", "estimate_seconds_many",
                 "ARCH_NAMES", "GPU_GENERATIONS"):
        assert getattr(core, name) is getattr(costmodel, name)
    # the package's default arch is the measured card's, not the model's
    assert core.DEFAULT_ARCH == "h100" != costmodel.DEFAULT_ARCH


def test_telemetry_exports_fleet_snapshot():
    import repro_torch.telemetry as tel
    from repro_torch.telemetry import metrics
    assert tel.fleet_snapshot is metrics.fleet_snapshot
    assert "fleet aggregation" in tel.__doc__
