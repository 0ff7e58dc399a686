"""``python -m repro_torch.obs dump.json [--json]`` — the report CLI.

(Equivalent to ``python -m repro_torch.obs.report``, but without runpy's
double-import warning: the package ``__init__`` already imports
``report``.)"""
import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main())
