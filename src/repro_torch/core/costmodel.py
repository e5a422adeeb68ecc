"""Analytical Hopper timing model: the port's deterministic evaluator.

Port of ``repro.core.costmodel``, rewritten for the H100.  Each tunable
kernel maps a (config, shape) pair to :class:`KernelFeatures` in Hopper's
vocabulary (``kernels/*/space.py``), and this module turns features into
estimated seconds on one of the model's arch ids.  Sessions, exhaustive
tables, audits and CI can then run on a host with no card.  The ids are
distinct from the measured id ``h100`` that ``device.arch_id`` gives a
card: a model's objective is never recorded as a measurement.

The terms:

* the wgmma tile quantised to Hopper's issue shape (m to the 64 rows of a
  warpgroup, n to 8, k to 16);
* resident blocks per SM from shared memory (with the 1 KB the runtime
  reserves a block), registers (allocated per warp in units of 256),
  threads and the 32-block limit; zero resident blocks is ``inf``;
* waves: the busiest SM's blocks, run as many at a time as are resident
  and then the rest, each round's arithmetic stretched where its warps
  cannot hide latency (its warps over :data:`WARPS_TO_HIDE`, fewer where
  a thread has ``ilp`` independent chains of work, at least one warp a
  scheduler);
* the arithmetic's time, the largest of the tensor cores', shared
  memory's and the threads' own (their f32 instructions and special
  functions, one after the other);
* the traffic split between HBM and L2 (L2 at ``l2_mult`` times HBM's rate);
* overlap of the copies with the arithmetic, from the copies in flight an
  SM (pipeline stages x resident blocks);
* a wait at each synchronised step of a block (a barrier or mbarrier
  ahead of a tile, a sweep, a ring step), the busiest SM's blocks waiting
  as many at a time as are resident;
* a cost per CUDA launch.

A config whose shared memory exceeds a block's limit gets ``inf``, as the
reference's VMEM overflow does.

Spec rows: NVIDIA H100 Tensor Core GPU datasheet (SXM5 and PCIe, dense
rates without sparsity) and the NVIDIA H100 Tensor Core GPU Architecture
whitepaper (Hopper's SM: 128 FP32 lanes and 16 special-function results a
clock, 228 KB of shared memory, 64 K registers, 2048 threads and 32 blocks
per SM).  The special-function units are taken at their peak; the eight
constants of :class:`Fit` are fitted by
``python -m repro_torch.calibrate`` to the card's measured rows
(``core/h100_rows.json``).  No PCIe card was measured: ``h100pcie`` takes
``h100sxm``'s fitted constants over its own public figures, unchecked
against a card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

MiB = 1024 * 1024
#: resident warps an SM needs to hide the latency of dependent
#: instructions: four schedulers with four warps each, where a thread has
#: one chain of dependent instructions; with ``ilp`` independent chains a
#: thread, fewer, but at least one warp a scheduler
WARPS_TO_HIDE, SCHEDULERS = 16.0, 4.0
#: the wgmma issue shape each tile dimension is quantised to
WGMMA_M, WGMMA_N, WGMMA_K = 64, 8, 16


@dataclass(frozen=True)
class Fit:
    """Achieved fractions of the peak rates and the other global constants
    the calibration fits (at most eight, shared by every kernel)."""

    tc: float           # of the tensor cores' peak
    f32: float          # of the f32 instruction rate
    smem: float         # of the shared-memory word rate
    hbm: float          # of the HBM rate
    l2_mult: float      # L2's rate as a multiple of HBM's
    launch_s: float     # seconds a CUDA launch costs
    sync_s: float       # seconds a block waits at a synchronised step
    overlap: float      # weight of each extra copy in flight in hiding copies


#: fitted by ``python -m repro_torch.calibrate`` on ``core/h100_rows.json``
#: (NVIDIA H100 80GB HBM3, 700.00 W); ``--write`` rewrites this literal
FIT = Fit(tc=0.8671183976423259, f32=0.6432807445202418,
          smem=0.46729637570542376, hbm=0.6551246524224508,
          l2_mult=4.902445972601375, launch_s=8.713652832515685e-06,
          sync_s=1.8058044027826141e-07, overlap=1.5048032763354908)


@dataclass(frozen=True)
class GpuGeneration:
    """One arch id's public figures, Hopper's per-SM limits and the fitted
    constants."""

    name: str
    sms: int
    clock_hz: float               # boost clock
    peak_tc_bf16: float           # FLOP/s, bf16 on the tensor cores, dense
    f32_inst: float               # f32 instructions/s, an FMA one
    sfu: float                    # special-function results/s
    hbm_bw: float                 # bytes/s
    l2_bytes: int
    power_w: float
    fit: Fit = FIT
    smem_per_sm: int = 233_472
    smem_per_block: int = 232_448  # the port's SMEM_PER_BLOCK
    smem_reserved: int = 1024      # the runtime's share of each block
    regs_per_sm: int = 65_536
    reg_unit: int = 256            # registers are allocated per warp in these
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32
    smem_words_per_clock: int = 32  # per SM: 128 B a clock

    @property
    def smem_words(self) -> float:
        """Shared-memory words/s over all SMs."""
        return self.sms * self.smem_words_per_clock * self.clock_hz


GPU_GENERATIONS: dict[str, GpuGeneration] = {
    # H100 SXM5: 132 SMs at 1.98 GHz, 989 TFLOP/s bf16, 3.35 TB/s, 700 W
    "h100sxm": GpuGeneration(
        name="h100sxm", sms=132, clock_hz=1.98e9, peak_tc_bf16=989e12,
        f32_inst=128 * 132 * 1.98e9, sfu=16 * 132 * 1.98e9, hbm_bw=3.35e12,
        l2_bytes=50 * MiB, power_w=700.0),
    # H100 PCIe: 114 SMs at 1.755 GHz, 756 TFLOP/s bf16, 2.0 TB/s, 350 W
    # (datasheet figures; no PCIe card was measured)
    "h100pcie": GpuGeneration(
        name="h100pcie", sms=114, clock_hz=1.755e9, peak_tc_bf16=756e12,
        f32_inst=128 * 114 * 1.755e9, sfu=16 * 114 * 1.755e9,
        hbm_bw=2.0e12, l2_bytes=50 * MiB, power_w=350.0),
}

DEFAULT_ARCH = "h100sxm"
ARCH_NAMES = tuple(GPU_GENERATIONS)


def generation(arch: "str | GpuGeneration") -> GpuGeneration:
    """The generation of an arch id (a :class:`GpuGeneration` passes
    through, which is how the calibration tries constants)."""
    return arch if isinstance(arch, GpuGeneration) else GPU_GENERATIONS[arch]


@dataclass
class KernelFeatures:
    """Low-level features a tunable kernel derives from (config, shape)."""

    # work
    tc_flops: float = 0.0            # FLOPs on the tensor cores (wgmma)
    wgmma_tile: tuple[int, int, int] = (64, 256, 16)  # (m, n, k) per issue
    f32_inst: float = 0.0            # f32 instructions, an FMA one, with
    #                                  the instructions beside the FMAs
    sfu_ops: float = 0.0             # special-function results
    smem_words: float = 0.0          # shared-memory words read
    steps: float = 0.0               # synchronised steps a block waits at
    ilp: float = 1.0                 # independent chains of work a thread
    # memory
    hbm_bytes: float = 0.0
    l2_bytes: float = 0.0            # bytes that hit in L2
    # launch shape
    smem_per_block: float = 0.0      # bytes of shared memory a block
    threads: float = 128.0           # threads a block
    regs: float = 32.0               # registers a thread
    blocks: float = 1.0              # blocks of the grid (of one launch)
    launches: float = 1.0            # CUDA launches a call
    stages: float = 1.0              # copies in flight a block (1 = none
    #                                  overlaps the arithmetic)
    # penalties
    serialization: float = 0.0       # 0 => copies overlap, 1 => serial


def _resident(gen: GpuGeneration, smem: float, threads: float,
              regs: float) -> float:
    """Blocks an SM holds at once (0 where one does not fit)."""
    warps = math.ceil(threads / 32.0)
    by_smem = math.floor(gen.smem_per_sm / (smem + gen.smem_reserved))
    per_warp = math.ceil(regs * 32.0 / gen.reg_unit) * gen.reg_unit
    by_regs = math.floor(math.floor(gen.regs_per_sm / per_warp) / warps)
    by_threads = math.floor(gen.threads_per_sm / (warps * 32.0))
    return float(min(gen.blocks_per_sm, by_smem, by_regs, by_threads))


def estimate_seconds(features: KernelFeatures,
                     arch: "str | GpuGeneration" = DEFAULT_ARCH) -> float:
    """Estimated kernel seconds of one call on ``arch``; ``inf`` if the
    config cannot run there (shared memory past a block's limit, or no
    block resident)."""
    gen = generation(arch)
    fit = gen.fit
    f = features
    if f.smem_per_block > gen.smem_per_block:
        return math.inf
    resident = _resident(gen, f.smem_per_block, f.threads, f.regs)
    if resident < 1.0:
        return math.inf

    # waves: the busiest SM's blocks, ``conc`` at a time and then the
    # rest, each round slowed where its warps cannot hide latency; over
    # the blocks' even share of the SMs
    warps = math.ceil(f.threads / 32.0)
    per_sm = math.ceil(f.blocks / gen.sms)
    conc = min(resident, per_sm)
    full = math.floor(per_sm / conc)
    rest = per_sm - full * conc
    need = max(SCHEDULERS, WARPS_TO_HIDE / f.ilp)
    units = full * conc / min(1.0, conc * warps / need)
    if rest > 0:
        units += rest / min(1.0, rest * warps / need)
    spread = gen.sms / f.blocks

    m, n, k = (max(1, int(x)) for x in f.wgmma_tile)
    tile = (m / (math.ceil(m / WGMMA_M) * WGMMA_M)
            * (n / (math.ceil(n / WGMMA_N) * WGMMA_N))
            * (k / (math.ceil(k / WGMMA_K) * WGMMA_K)))
    t_tc = f.tc_flops / (gen.peak_tc_bf16 * fit.tc * tile) \
        if f.tc_flops else 0.0
    # the tensor cores and shared memory have rates of their own; the f32
    # instructions and the special functions share the threads' issue
    t_core = max(t_tc, f.f32_inst / (gen.f32_inst * fit.f32)
                 + f.sfu_ops / gen.sfu,
                 f.smem_words / (gen.smem_words * fit.smem)) * units * spread
    t_mem = (f.hbm_bytes / (gen.hbm_bw * fit.hbm)
             + f.l2_bytes / (gen.hbm_bw * fit.hbm * fit.l2_mult)) \
        * per_sm * spread

    inflight = f.stages * conc
    serial = min(1.0, max(f.serialization,
                          1.0 / (1.0 + fit.overlap * (inflight - 1.0))))
    t_body = max(t_core, t_mem) + serial * min(t_core, t_mem)
    # the busiest SM's blocks wait at their steps, ``conc`` at a time
    t_sync = per_sm * f.steps * fit.sync_s / conc
    return t_body + t_sync + f.launches * fit.launch_s


class FeatureBatch:
    """Struct-of-arrays view of a batch of :class:`KernelFeatures`: float64
    columns of equal length (or scalars that broadcast), built in one pass
    (:meth:`from_features`) or by a problem's ``feature_columns``."""

    #: column order of the packed matrix built by :meth:`from_features`
    FIELDS = ("tc_flops", "tile_m", "tile_n", "tile_k", "f32_inst",
              "sfu_ops", "smem_words", "steps", "ilp", "hbm_bytes",
              "l2_bytes",
              "smem_per_block", "threads", "regs", "blocks", "launches",
              "stages", "serialization")

    __slots__ = FIELDS + ("n", "features")

    #: per-column defaults mirroring ``KernelFeatures`` field defaults
    DEFAULTS = {
        "tc_flops": 0.0, "tile_m": 64.0, "tile_n": 256.0, "tile_k": 16.0,
        "f32_inst": 0.0, "sfu_ops": 0.0, "smem_words": 0.0, "steps": 0.0,
        "ilp": 1.0,
        "hbm_bytes": 0.0, "l2_bytes": 0.0, "smem_per_block": 0.0,
        "threads": 128.0, "regs": 32.0, "blocks": 1.0, "launches": 1.0,
        "stages": 1.0, "serialization": 0.0,
    }

    def __len__(self) -> int:
        return self.n

    @staticmethod
    def from_columns(n: int, **columns) -> "FeatureBatch":
        """Columnar constructor for the kernels' ``feature_columns``:
        omitted fields take the :class:`KernelFeatures` defaults, and
        scalar-valued fields stay plain floats (numpy broadcasting handles
        them).  Carries no per-row feature objects."""
        unknown = set(columns) - set(FeatureBatch.FIELDS)
        if unknown:
            raise TypeError(f"unknown feature columns: {sorted(unknown)}")
        batch = FeatureBatch.__new__(FeatureBatch)
        for name in FeatureBatch.FIELDS:
            col = columns.get(name, FeatureBatch.DEFAULTS[name])
            if isinstance(col, (int, float)):
                col = float(col)
            else:
                col = np.asarray(col, dtype=np.float64)
                if col.ndim == 0:
                    col = float(col)
                elif len(col) != n:
                    raise ValueError(
                        f"column {name!r}: length {len(col)} != {n}")
            setattr(batch, name, col)
        batch.n = n
        batch.features = ()
        return batch

    @staticmethod
    def from_features(features: Sequence[KernelFeatures]) -> "FeatureBatch":
        """Pack per-config features into columns in a single pass."""
        rows = [(f.tc_flops, max(1, int(f.wgmma_tile[0])),
                 max(1, int(f.wgmma_tile[1])), max(1, int(f.wgmma_tile[2])),
                 f.f32_inst, f.sfu_ops, f.smem_words, f.steps, f.ilp,
                 f.hbm_bytes,
                 f.l2_bytes, f.smem_per_block, f.threads, f.regs, f.blocks,
                 f.launches, f.stages, f.serialization) for f in features]
        mat = np.array(rows, dtype=np.float64).reshape(
            len(rows), len(FeatureBatch.FIELDS))
        batch = FeatureBatch.from_columns(
            len(rows), **{name: mat[:, i]
                          for i, name in enumerate(FeatureBatch.FIELDS)})
        batch.features = tuple(features)
        return batch


def estimate_seconds_batch(batch: FeatureBatch,
                           arch: "str | GpuGeneration" = DEFAULT_ARCH):
    """Vectorized :func:`estimate_seconds` over a :class:`FeatureBatch`:
    the scalar expressions term for term, in the same float64 operation
    order, so both paths agree bit for bit.  Returns float64 seconds
    (``inf`` where the config cannot run)."""
    gen = generation(arch)
    fit = gen.fit
    f = batch

    warps = np.ceil(f.threads / 32.0)
    by_smem = np.floor(gen.smem_per_sm / (f.smem_per_block
                                          + gen.smem_reserved))
    per_warp = np.ceil(f.regs * 32.0 / gen.reg_unit) * gen.reg_unit
    by_regs = np.floor(np.floor(gen.regs_per_sm / per_warp) / warps)
    by_threads = np.floor(gen.threads_per_sm / (warps * 32.0))
    resident = np.minimum(np.minimum(gen.blocks_per_sm, by_smem),
                          np.minimum(by_regs, by_threads))
    runs = (f.smem_per_block <= gen.smem_per_block) & (resident >= 1.0)
    resident = np.maximum(resident, 1.0)

    per_sm = np.ceil(f.blocks / gen.sms)
    conc = np.minimum(resident, per_sm)
    full = np.floor(per_sm / conc)
    rest = per_sm - full * conc
    need = np.maximum(SCHEDULERS, WARPS_TO_HIDE / f.ilp)
    units = full * conc / np.minimum(1.0, conc * warps / need)
    units = units + np.where(
        rest > 0, rest / np.minimum(1.0, np.maximum(rest, 1.0) * warps
                                    / need), 0.0)
    spread = gen.sms / f.blocks

    m, n, k = f.tile_m, f.tile_n, f.tile_k
    tile = (m / (np.ceil(m / WGMMA_M) * WGMMA_M)
            * (n / (np.ceil(n / WGMMA_N) * WGMMA_N))
            * (k / (np.ceil(k / WGMMA_K) * WGMMA_K)))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_tc = np.where(f.tc_flops != 0.0,
                        f.tc_flops / (gen.peak_tc_bf16 * fit.tc * tile), 0.0)
    t_core = np.maximum(
        np.maximum(t_tc, f.f32_inst / (gen.f32_inst * fit.f32)
                   + f.sfu_ops / gen.sfu),
        f.smem_words / (gen.smem_words * fit.smem)) * units * spread
    t_mem = (f.hbm_bytes / (gen.hbm_bw * fit.hbm)
             + f.l2_bytes / (gen.hbm_bw * fit.hbm * fit.l2_mult)) \
        * per_sm * spread

    inflight = f.stages * conc
    serial = np.minimum(1.0, np.maximum(
        f.serialization, 1.0 / (1.0 + fit.overlap * (inflight - 1.0))))
    t_body = np.maximum(t_core, t_mem) + serial * np.minimum(t_core, t_mem)
    t_sync = per_sm * f.steps * fit.sync_s / conc
    total = t_body + t_sync + f.launches * fit.launch_s
    return np.where(runs, total, np.inf)


def estimate_seconds_many(features: Sequence[KernelFeatures],
                          arch: str = DEFAULT_ARCH) -> list[float]:
    """List-of-features convenience wrapper over
    :func:`estimate_seconds_batch`."""
    if not features:
        return []
    total = estimate_seconds_batch(FeatureBatch.from_features(features), arch)
    return [float(t) for t in np.broadcast_to(total, (len(features),))]


def roofline_terms(features: KernelFeatures, arch: str = DEFAULT_ARCH
                   ) -> dict[str, float]:
    """Ideal-roofline terms of one call at the peak rates (no fitted
    fraction, no quantisation): the operations' time (tensor cores, f32
    instructions and special functions, each at its peak, the largest
    taken) and the HBM bytes' time."""
    gen = generation(arch)
    t_c = max(features.tc_flops / gen.peak_tc_bf16,
              features.f32_inst / gen.f32_inst, features.sfu_ops / gen.sfu)
    t_m = features.hbm_bytes / gen.hbm_bw
    return {"compute_s": t_c, "memory_s": t_m,
            "bound": "compute" if t_c >= t_m else "memory"}
