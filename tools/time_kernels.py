#!/usr/bin/env python3
"""Time the phase-2 kernel checks of the ``chip_smoke.py`` in a checkout.

    python3 tools/time_kernels.py ROOT [--sweep] [--only CHECK[,CHECK]]

ROOT is the root of a checkout of this repository (``.`` for this one, or
an unpacked ``git archive`` of another commit). The script imports that
checkout's ``chip_smoke.py`` and its ``src/repro_torch``, builds the
kernels there, runs each phase-2 check the checkout has (each kernel
against its plain version, then timed beside its plain version, its
library yardstick and its bound) and, with ``--sweep``, its launch-rule
sweeps; ``--only check_cascade_gate`` runs the named checks alone. It
prints one line ``TIMES {json}``. Run it on two checkouts in turns in one
call (A, B, B, A) to compare them on one card. It needs a CUDA GPU.
"""
import json
import os
import sys

CHECKS = ("check_decode", "check_flash", "check_paged", "check_cascade_gate",
          "check_rglru")


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    timer = cs.Timer(torch)
    out = {"root": sys.argv[1], "card": cs._smi()}
    only = sys.argv[sys.argv.index("--only") + 1].split(",") \
        if "--only" in sys.argv else CHECKS
    for name in only:
        if hasattr(cs, name):
            out[name] = getattr(cs, name)(torch, timer, dev)
    if "--sweep" in sys.argv:
        out["sweep"] = cs.sweep_attention(torch, timer, dev)
    print("TIMES " + json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
