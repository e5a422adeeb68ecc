"""Static default configs — the floor of the degradation chain.

When the find-DB is absent, stale, corrupt, or simply has never seen a
kernel, the lookup chain bottoms out here: one config per kernel, each the
op's own ``DEFAULT_CONFIG`` (``kernels/<name>/ops.py``), the config every
public op runs when its caller names none and it fits the shape.  This is
the paper's robustness floor: a served default is slower than a tuned
config, but the serving path never answers "no config".

Keys are *table* names (``SearchSpace.name`` / ``ResultTable.problem``),
the same namespace the snapshot's tables use: the port's ``*_h100`` names,
so a port table never resolves to a TPU kernel's default.  The configs are
copied here as data, because the lookup side must not import the kernel
stack (torch); ``tests/test_torch_servedb.py`` holds each copy equal to its
op's ``DEFAULT_CONFIG``.
"""

from __future__ import annotations

__all__ = ["STATIC_DEFAULTS", "default_config"]

STATIC_DEFAULTS: dict[str, dict] = {
    "flash_attention_h100": {"block_q": 128, "block_kv": 128, "block_h": 1,
                             "skip_masked": 1, "acc_dtype": "f32"},
    "gemm_h100": {"block_m": 256, "block_n": 128, "block_k": 64,
                  "unroll_k": 1, "warps": 8, "stages": 4, "grid_order": "mn",
                  "split_k": 1, "acc_dtype": "f32", "rhs_layout": "kn"},
    "conv2d_h100": {"block_h": 32, "block_w": 32, "unroll_fh": 15,
                    "unroll_fw": 15, "row_chunk": 2, "col_chunk": 4,
                    "acc_dtype": "f32", "filter_smem": 0},
    "dedisp_h100": {"block_d": 8, "block_c": 2, "time_chunk": 0,
                    "unroll_d": 4, "acc_dtype": "f32"},
    "expdist_h100": {"block_i": 512, "block_j": 256, "use_column": 0,
                     "n_y_blocks": 64, "unroll_j": 4, "exp_variant": "exp2",
                     "compute_dtype": "f32"},
    "hotspot_h100": {"tt": 10, "block_h": 64, "block_w": 128, "unroll_t": 1,
                     "acc_dtype": "f32", "power_smem": 0, "grid_order": "rm"},
    "nbody_h100": {"block_i": 512, "block_j": 512, "layout": "soa",
                   "unroll_j": 8, "rsqrt_method": "approx",
                   "compute_dtype": "f32"},
    "pnpoly_h100": {"block_points": 4096, "unroll_v": 8, "between_method": 0,
                    "use_method": 2, "precompute_slope": 1,
                    "coord_layout": "soa"},
}


def default_config(kernel: str) -> dict:
    """The static default for ``kernel`` — ``{}`` for kernels we have no
    default for, so even an unknown name gets a (vacuous) answer instead
    of an exception."""
    return dict(STATIC_DEFAULTS.get(kernel, {}))
