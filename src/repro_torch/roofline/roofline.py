"""Three-term roofline from a traced step.

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = HBM_bytes_per_chip / HBM_bw
    collective term = collective_bytes_per_chip / link_bw

The port of ``repro.roofline.roofline``.  Where the JAX package reads a
compiled executable (``cost_analysis()``, the optimized HLO's
collectives, ``memory_analysis()``), the port reads a
:class:`~repro_torch.roofline.trace.StepTrace`: one rank's local ops of
an eager step, counted by :class:`~repro_torch.roofline.trace.StepTracer`
(its conventions are in that module).  Both are per chip.

Hardware constants (H100 SXM5, per chip): ``core/costmodel.py``'s
``h100sxm`` row, 989 TFLOP/s bf16 on the tensor cores (dense) and 3.35
TB/s HBM; ``link_bw`` 450 GB/s, NVLink 4's 900 GB/s total of the H100
SXM5 700 W data sheet taken per direction (a data-sheet figure, not a
measurement).
"""

from __future__ import annotations

import dataclasses

from ..core.costmodel import GPU_GENERATIONS

#: H100 SXM5 roofline constants (per chip)
HW = {
    "peak_flops_bf16": GPU_GENERATIONS["h100sxm"].peak_tc_bf16,
    "hbm_bw": GPU_GENERATIONS["h100sxm"].hbm_bw,
    "link_bw": 450e9,
}


def collective_bytes(trace) -> dict[str, float]:
    """Result bytes per collective opcode of a traced step (a
    ``StepTrace`` or its ``coll_by_op``), plus ``"total"``."""
    by = getattr(trace, "coll_by_op", trace)
    out = {k: float(v) for k, v in by.items()}
    out["total"] = float(sum(out.values()))
    return out


# ------------------------------------------------------------------ #
@dataclasses.dataclass
class CellReport:
    """Roofline summary of one traced (arch × shape × mesh) cell."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_op: dict
    peak_memory_per_chip: float
    model_flops: float                    # 6·N_active·D (or 2·N·D decode)
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total_overlap(self) -> float:
        """Ideal fully-overlapped step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total traced FLOPs — catches remat/redundancy
        waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the ideal overlapped step time."""
        t = self.t_total_overlap
        if t <= 0:
            return 0.0
        return (self.model_flops / self.chips) / (t * HW["peak_flops_bf16"])

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bound=self.bound, t_total_overlap=self.t_total_overlap,
                 useful_flops_ratio=self.useful_flops_ratio, mfu=self.mfu)
        return d


def model_flops(cfg, shape_cell: dict, *, microbatches: int = 1) -> float:
    """Paper-convention useful FLOPs for one step.

    train: 6·N_active·tokens  (fwd 2ND + bwd 4ND)
    prefill: 2·N_active·tokens (+ attention term omitted, convention)
    decode: 2·N_active·batch   (one token per sequence)
    """
    n = cfg.active_param_count()
    kind = shape_cell["kind"]
    if kind == "train":
        d = shape_cell["global_batch"] * shape_cell["seq_len"]
        return 6.0 * n * d
    if kind == "prefill":
        d = shape_cell["global_batch"] * shape_cell["seq_len"]
        return 2.0 * n * d
    return 2.0 * n * shape_cell["global_batch"]


def analyze_trace(trace, *, chips: int, arch: str, shape: str, mesh: str,
                  model_flops_value: float) -> CellReport:
    """The three roofline terms of a traced step (``StepTrace``)."""
    coll = collective_bytes(trace)
    return CellReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_chip=trace.flops,
        hbm_bytes_per_chip=trace.hbm_bytes,
        coll_bytes_per_chip=coll["total"],
        coll_by_op={k: v for k, v in coll.items() if k != "total"},
        peak_memory_per_chip=trace.peak_bytes,
        model_flops=model_flops_value,
        t_compute=trace.flops / HW["peak_flops_bf16"],
        t_memory=trace.hbm_bytes / HW["hbm_bw"],
        t_collective=coll["total"] / HW["link_bw"],
    )


def roofline_report(report: CellReport) -> str:
    """One human-readable block per cell (EXPERIMENTS.md §Roofline rows)."""
    r = report
    return (
        f"{r.arch} × {r.shape} × {r.mesh} ({r.chips} chips)\n"
        f"  compute    {r.t_compute * 1e3:10.3f} ms"
        f"  ({r.flops_per_chip / 1e12:.2f} TFLOP/chip)\n"
        f"  memory     {r.t_memory * 1e3:10.3f} ms"
        f"  ({r.hbm_bytes_per_chip / 1e9:.2f} GB/chip)\n"
        f"  collective {r.t_collective * 1e3:10.3f} ms"
        f"  ({r.coll_bytes_per_chip / 1e9:.3f} GB/chip)\n"
        f"  bound={r.bound}  useful_flops={r.useful_flops_ratio:.3f}"
        f"  MFU@overlap={r.mfu:.3f}"
        f"  peak_mem={r.peak_memory_per_chip / 1e9:.2f} GB\n")
