"""Roofline analysis of the port (``repro.analysis.roofline`` on the H100).

For each record of one step, the three roofline terms, in seconds a
device (the H100 SXM data-sheet figures in ``launch.mesh``):

    compute    = FLOPs a device / PEAK_FLOPS_BF16      (989 TFLOP/s bf16)
    memory     = bytes a device / HBM_BW               (3.35 TB/s)
    collective = collective bytes a device / NVLINK_BW (450 GB/s each way)

and MODEL_FLOPS = 2 N D a forward token (6 N D a trained one; N the active
parameters of a MoE), with the usefulness ratio MODEL_FLOPS / (FLOPs a
device x devices), which shows recomputation and padding.

``repro`` reads its records from XLA's compiled dry runs. The port has no
compiler to ask: ``step_record`` runs one eager step and counts it, and
``roofline_from_record`` reads the same record keys either way, so
``roofline_table`` reads a directory of either package's records.
``param_counts`` counts from ``LM.param_spec`` (shapes only; nothing is
allocated, so deepseek-v3-671b counts in a second).
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import FLOPS
from repro_torch.launch.mesh import (COLLECTIVE_BYTES, COLLECTIVES, HBM_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16)
from repro_torch.launch.specs import resolved_config
from repro_torch.models.param import EXPERT


def _leaves(spec, axes):
    """(shape, axes) of every leaf of a ``param_spec`` tree and its
    ``param_axes`` twin."""
    if isinstance(spec, dict):
        for k in spec:
            yield from _leaves(spec[k], axes[k])
    elif isinstance(spec, list):
        for s, a in zip(spec, axes):
            yield from _leaves(s, a)
    else:
        yield spec[0], axes


def _param_counts(arch: str) -> Dict[str, float]:
    """(total, active) parameter counts: a routed expert's leaves count
    k / E of themselves towards the active ones."""
    from repro_torch.models.model import LM

    cfg = resolved_config(arch, "train_4k")
    lm = LM(cfg, device="cpu")
    frac = 1.0
    if cfg.moe is not None:
        frac = cfg.moe.num_experts_per_tok / cfg.moe.num_experts
    total = active = 0.0
    for shape, axes in _leaves(lm.param_spec(), lm.param_axes()):
        n = float(math.prod(shape))
        total += n
        active += n * (frac if EXPERT in axes else 1.0)
    return {"total": total, "active": active}


_COUNT_CACHE: Dict[str, Dict[str, float]] = {}


def param_counts(arch: str) -> Dict[str, float]:
    if arch not in _COUNT_CACHE:
        _COUNT_CACHE[arch] = _param_counts(arch)
    return _COUNT_CACHE[arch]


def _tree_bytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def step_record(step: Callable[[], object], *, arch: str, mode: str,
                seq_len: int, global_batch: int, params, cache_bytes: int = 0,
                devices: int = 1, shape: str = "", mesh: str = "1x1",
                device=None) -> dict:
    """Run ``step()`` once, eagerly (no CUDA graph), and return its record
    in the keys of ``repro``'s dry-run records, for this device:

    - ``cost["flops"]``: the matrix-product FLOPs that
      ``torch.utils.flop_counter.FlopCounterMode`` counts, plus what the
      hand-written kernels' wrappers add where they launch
      (``kernels.FLOPS``: the mode cannot see a ``ctypes`` launch). A
      kernel adds its plain version's count, so the record is the same on
      the card and on the CPU.
    - ``cost["bytes accessed"]``: the bytes of ``params`` (this device's
      tree) plus ``cache_bytes`` (the cache a step reads): a lower bound,
      as activations and a second read of a weight are not counted.
    - ``collectives``: each kind's calls and result bytes
      (``launch.mesh.COLLECTIVE_BYTES``) in the step.
    - ``memory``: on a card, the bytes allocated before the step and the
      peak above them during it; None on the CPU.

    ``mode`` is "train", "prefill" or "decode"; ``seq_len`` and
    ``global_batch`` the step's tokens as ``roofline_from_record`` counts
    them; ``devices`` the ranks that each run such a step."""
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device) if device is not None else None
    on_card = device is not None and device.type == "cuda"
    before_f = dict(FLOPS)
    before_c, before_b = dict(COLLECTIVES), dict(COLLECTIVE_BYTES)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    with FlopCounterMode(display=False) as counter:
        step()
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - held
    flops = counter.get_total_flops() + sum(FLOPS[k] - before_f.get(k, 0)
                                            for k in FLOPS)
    coll: Dict[str, Dict[str, int]] = {}
    for key, n in COLLECTIVES.items():
        calls = n - before_c.get(key, 0)
        if calls:
            kind = coll.setdefault(key.split("/")[0],
                                   {"count": 0, "bytes": 0})
            kind["count"] += calls
            kind["bytes"] += COLLECTIVE_BYTES.get(key, 0) \
                - before_b.get(key, 0)
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "devices": devices,
        "mode": mode, "seq_len": seq_len, "global_batch": global_batch,
        "memory": {"argument_bytes_per_device": held if on_card else None,
                   "temp_bytes_per_device": peak if on_card else None},
        "cost": {"flops": float(flops),
                 "bytes accessed": float(_tree_bytes(params) + cache_bytes)},
        "collectives": coll,
    }


def roofline_from_record(rec: dict, counts: Optional[dict] = None) -> dict:
    w = rec.get("weighted") or {}
    if "dot_flops" in w:
        # a repro record's trip-count-weighted HLO costs
        flops_dev = w["dot_flops"]
        bytes_dev = w["hbm_bytes"]
        coll_dev = w["collective_bytes_total"]
    else:
        flops_dev = rec["cost"].get("flops", 0.0) or 0.0
        bytes_dev = rec["cost"].get("bytes accessed", 0.0) or 0.0
        coll_dev = sum(v["bytes"] for v in rec["collectives"].values())
    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_collective = coll_dev / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)

    counts = counts or param_counts(rec["arch"])
    if rec["mode"] == "train":
        tokens = rec["seq_len"] * rec["global_batch"]
        mult = 3.0          # forward + backward (2x)
    elif rec["mode"] == "prefill":
        tokens = rec["seq_len"] * rec["global_batch"]
        mult = 1.0
    else:
        tokens = rec["global_batch"]          # one token a sequence
        mult = 1.0
    model_flops = 2.0 * counts["active"] * tokens * mult
    total = flops_dev * rec["devices"]
    useful = model_flops / total if total else 0.0

    hbm_gib = None
    mem = rec.get("memory", {})
    if mem.get("temp_bytes_per_device") is not None:
        hbm_gib = (mem["temp_bytes_per_device"]
                   + (mem.get("argument_bytes_per_device") or 0)) / 2 ** 30

    suggestion = {
        "compute": "raise arithmetic efficiency: larger fused matmul tiles /"
                   " fewer remat passes",
        "memory": "cut HBM traffic: smaller f32 transients (attention/moe"
                  " chunks), fuse elementwise chains, bf16 logits",
        "collective": "reshard to cut boundary bytes: bigger per-shard"
                      " blocks, overlap FSDP gathers, all-to-all dispatch",
    }[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "mode": rec["mode"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_collective, "dominant": dominant,
        "model_flops": model_flops, "hlo_flops_total": total,
        "useful_ratio": useful,
        "hbm_gib_per_device": hbm_gib,
        "suggestion": suggestion,
    }


def roofline_table(record_dir: str, mesh: str = "*") -> List[dict]:
    """The rows of every record ``<name>__<mesh>.json`` in ``record_dir``
    (cascade records aside)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(record_dir,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec["arch"].startswith("cascade-"):
            continue
        rows.append(roofline_from_record(rec))
    return rows


def format_table(rows: List[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'dominant':>10s} {'useful':>7s} {'HBM GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} "
            f"{r['t_compute_s']*1e3:9.2f}m {r['t_memory_s']*1e3:9.2f}m "
            f"{r['t_collective_s']*1e3:9.2f}m {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.2f} "
            f"{(r['hbm_gib_per_device'] or 0):8.1f}")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    print(format_table(roofline_table(sys.argv[1], *sys.argv[2:3])))
