"""``python -m repro_torch.orchestrator`` — see :mod:`repro_torch.orchestrator.cli`.

Guarded: importing this module (a package walk, or a spawned worker
re-importing its parent's main module) runs nothing.
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
