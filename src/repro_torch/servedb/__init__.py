"""servedb — the crash-safe tuned-config serving layer (find-DB).

Campaigns produce ResultsDB traces; production wants *answers*:
"best config for (kernel, shape, arch) right now", at interactive
latency, under every disk state.  This package is that bridge:

* :mod:`.distill` builds golden tables from a session store,
* :mod:`.snapshot` publishes them atomically (checksummed, versioned,
  quarantine-on-corruption),
* :mod:`.lookup` serves them through a never-raise degradation chain
  (``exact → nearest → heuristic → default``), hot-reloading when a new
  snapshot lands,
* :mod:`.defaults` is the static floor the chain can always land on.

The lookup side imports neither torch nor the kernel stack — a serving
process pays for dict lookups, not problem construction (``import torch``
alone takes seconds).
"""

from .defaults import STATIC_DEFAULTS, default_config
from .lookup import TIERS, LookupResult, ServeDB
from .snapshot import (SNAPSHOT_NAME, Snapshot, SnapshotError, load, publish,
                       quarantine, shape_distance, shape_key, verify_dir)

__all__ = [
    "STATIC_DEFAULTS", "default_config",
    "TIERS", "LookupResult", "ServeDB",
    "SNAPSHOT_NAME", "Snapshot", "SnapshotError", "load", "publish",
    "quarantine", "shape_distance", "shape_key", "verify_dir",
    "build_snapshot",
]


def build_snapshot(*args, **kwargs):
    """Lazy re-export of :func:`repro_torch.servedb.distill.build_snapshot`
    — the distiller pulls in the orchestrator (and, via problem
    resolution, torch); serving-side importers of this package must
    not."""
    from .distill import build_snapshot as _build
    return _build(*args, **kwargs)
