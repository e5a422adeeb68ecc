"""Distribution: logical-axis sharding on DTensor placements and the GPipe
schedule, the port of ``repro.distributed``."""

from . import sharding
from .sharding import (AbstractMesh, active_mesh, batch_spec,
                       cache_shardings, constrain, param_shardings,
                       placements, replicated, spec_for, use_mesh)

__all__ = ["sharding", "active_mesh", "batch_spec", "cache_shardings",
           "constrain", "param_shardings", "replicated", "spec_for",
           "use_mesh", "placements", "AbstractMesh"]
