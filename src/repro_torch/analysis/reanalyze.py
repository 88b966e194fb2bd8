"""Re-run the op cost model over saved dry-run op logs (no second trace):
the port of ``repro.analysis.reanalyze``.

    PYTHONPATH=src python -m repro_torch.analysis.reanalyze \\
        [results/dryrun_torch]

Each record ``<name>.json`` of ``launch.dryrun`` with its op log
``<name>.ops.gz`` beside it gets ``weighted``, ``collectives`` and its
``cost`` counts anew from ``analysis.op_cost.analyze``; a record without
a log is skipped.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.analysis.op_cost import analyze, collectives, load_log


def reanalyze(record_dir: str) -> list:
    """Rewrite every record of ``record_dir`` that has an op log; returns
    the paths rewritten."""
    done = []
    for path in sorted(glob.glob(os.path.join(record_dir, "*.json"))):
        log_path = path[:-len(".json")] + ".ops.gz"
        if not os.path.exists(log_path):
            print(f"skip (no op log): {path}")
            continue
        log = load_log(log_path)
        with open(path) as f:
            rec = json.load(f)
        try:
            w = rec["weighted"] = analyze(log)
            rec["collectives"] = collectives(log)
            rec["cost"].update(flops=w["dot_flops"],
                               transcendentals=w["transcendental"])
        except Exception as e:  # noqa: BLE001 - keep the record either way
            rec["weighted"] = {"error": repr(e)}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"reanalyzed {path}")
        done.append(path)
    return done


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    reanalyze(argv[0] if argv else "results/dryrun_torch")


if __name__ == "__main__":
    main()
