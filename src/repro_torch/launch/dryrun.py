"""The production-mesh dry run: the port of ``repro.launch.dryrun``.

``repro`` lowers and compiles each (architecture x input shape) step for
the 16 x 16 mesh (256 chips) and the 2 x 16 x 16 one (512) on fake host
devices, and records its memory, cost and collectives a device. The port
runs one process a rank, so it traces ONE rank of that mesh instead: rank
0 of ``torch.distributed``'s ``fake`` backend over 256 or 512 ranks
(``launch.fake.fake_world``; its collectives return at once),
``launch.mesh.make_production_mesh``'s (data 16 or 32, model 16) mesh,
and the step of ``launch.specs.make_step_fn`` run once on that rank's
inputs under fake tensors (``launch.fake.fake_mode``): no storage, no
kernel, no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch glm4-9b --shape train_4k [--multi-pod] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cascade both \\
        --both-meshes

``--device cuda`` (the default) traces fake CUDA tensors: each
hand-written kernel's wrapper runs its shape rule (``kernels.traced``),
as the step on the card would launch the kernel. ``--device cpu`` runs
the kernels' plain versions on fake CPU tensors: the same matrix-product
FLOPs and collectives, but the attention's plain versions hold (B, H, S,
S) scores, so its temp bytes are not the card's. A build of PyTorch
without CUDA traces a training step on ``cpu`` only
(``launch.fake``'s docstring).

Each record, ``{arch}__{shape}__{mesh}.json`` in ``--out``, has
``repro``'s keys: ``trace_s`` in the place of ``lower_s``/``compile_s``
and ``ops`` (aten ops dispatched) in that of ``hlo_lines``;
``memory.argument_bytes_per_device`` (this rank's inputs),
``temp_bytes_per_device`` (the peak of live tensor bytes above them,
``torch.distributed._tools.mem_tracker.MemTracker``, which tracks fake
tensors) and ``output_bytes_per_device``; ``cost`` (``flops`` and
``bytes accessed`` as ``analysis.roofline.step_record`` counts them,
``transcendentals``), ``collectives`` and ``weighted``
(``analysis.op_cost``), and ``fits``: argument + temp bytes within
``launch.mesh.HBM_PER_CARD``. ``kernels`` counts each kernel's traced
calls; ``notes`` names where the port's placement departs from
``repro``'s rules and where rank 0 is not every rank. The op log
(``.ops.gz``) beside each record lets ``analysis.reanalyze`` re-derive
``weighted`` without a second trace.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import List, Optional

import torch

from repro_torch.analysis.op_cost import OpCost, analyze, collectives, \
    save_log
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.shapes import INPUT_SHAPES, get_shape
from repro_torch.kernels import TRACED
from repro_torch.launch.fake import fake_mode, fake_world, refuse_autograd
from repro_torch.launch.mesh import (HBM_PER_CARD, PRODUCTION_MESHES,
                                     make_production_mesh)
from repro_torch.launch.specs import (PLACEMENT_NOTES, make_step_fn,
                                      resolved_config, tree_bytes)

OUT_DIR = "results/dryrun_torch"
CPU_NOTE = ("traced on cpu: the kernels' plain versions ran, so temp bytes "
            "hold their dense attention scores, which the card's kernels "
            "never make")


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _world(multi_pod: bool) -> int:
    data, model = PRODUCTION_MESHES[mesh_tag(multi_pod)]
    return data * model


def _leaves(lm, mesh, mode: str):
    """Each param leaf under ``mode``'s rules as (whole shape, dtype,
    logical axes, this rank's shape)."""
    from repro_torch.serving.sharding import param_shardings, shard_shape

    out = []

    def walk(leaf, axes, spec):
        if isinstance(leaf, dict):
            for k in leaf:
                walk(leaf[k], axes[k], spec[k])
        elif isinstance(leaf, list):
            for x in zip(leaf, axes, spec):
                walk(*x)
        else:
            shape = tuple(leaf[0])
            out.append((shape, leaf[1], axes,
                        shard_shape(mesh, shape, spec)))

    walk(lm.param_spec(), lm.param_axes(), param_shardings(mesh, lm, mode))
    return out


def param_shares(lm, mesh, mode: str):
    """Each param leaf under ``mode``'s rules as (shape, dtype, ways): the
    ranks it is cut over. A leaf cut fewer than ``mesh.size`` ways is held
    whole, or in the same part, by ``mesh.size / ways`` ranks."""
    return [(shape, dtype, math.prod(shape) // math.prod(local))
            for shape, dtype, _, local in _leaves(lm, mesh, mode)]


def _uneven_notes(lm, mesh, mode: str) -> List[str]:
    """Where rank 0's share is not every rank's: how the routed experts
    cut (a rank holds whole experts, or every rank a slice of each); and
    the param leaves that more than one rank holds (whole, or split on one
    axis only)."""
    from repro_torch.models.param import EXPERT, STACK

    notes = []
    # the experts' weights, whose leading axis (after the layers') is the
    # expert's; the router's columns cut by other rules
    experts = [(shape[dim], shape[dim] // local[dim])
               for shape, _, axes, local in _leaves(lm, mesh, mode)
               for dim in [int(axes[0] == STACK)] if axes[dim] == EXPERT]
    if experts:
        e, n = experts[0]
        notes.append(f"the {mode} rules cut the {e} routed experts {n} "
                     f"ways ({e // n} a rank)" + (
                         "; each expert's d_ff is cut instead" if n == 1
                         else ""))
    held = [(math.prod(s) // w * torch.empty((), dtype=d).element_size(), w)
            for s, d, w in param_shares(lm, mesh, mode)]
    copied = sum(b for b, w in held if w < mesh.size)
    notes.append(f"the {mode} rules cut {sum(w == mesh.size for _, w in held)}"
                 f" of {len(held)} param leaves over every rank; "
                 f"{copied / 2 ** 20:.1f} of this rank's "
                 f"{sum(b for b, _ in held) / 2 ** 20:.1f} MiB of params "
                 f"are parts other ranks hold too")
    return notes


def _tensors(tree):
    from repro_torch.utils.tree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def trace_step(step, inputs, *, params, read, device, **meta):
    """Run ``step(*inputs)`` once under ``analysis.op_cost.OpCost`` and
    ``MemTracker`` (inside ``launch.fake.fake_mode`` for a dry run) and
    return ``(record, op log)``: ``meta`` (arch, shape, mesh, devices,
    mode, seq_len, global_batch) and the counted keys of the module
    docstring; ``params`` is this rank's param tree, ``read`` what a step
    reads at least (the params, and a decode step's caches)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    before = dict(TRACED)
    args = tree_bytes(inputs)
    tracker = MemTracker()
    tracker.track_external(*_tensors(inputs))
    cost = OpCost()
    t0 = time.perf_counter()
    with tracker, cost:
        out = step(*inputs)
    seconds = time.perf_counter() - t0
    peaks = tracker.get_tracker_snapshot("peak")
    dev = next((d for d in peaks if d.type == torch.device(device).type),
               None)
    temp = max((peaks[dev]["Total"] if dev else args) - args, 0)
    held = {t.untyped_storage()._cdata for t in _tensors(inputs)}
    outs = [t for t in _tensors(out)
            if t.untyped_storage()._cdata not in held]
    log = cost.log
    weighted = analyze(log)
    record = dict(meta)
    record.update({
        "device": str(device), "trace_s": seconds,
        "memory": {"argument_bytes_per_device": args,
                   "output_bytes_per_device": tree_bytes(outs),
                   "temp_bytes_per_device": temp,
                   "generated_code_bytes": None,
                   "tracker": "torch.distributed._tools.mem_tracker"
                              ".MemTracker"},
        "fits": args + temp <= HBM_PER_CARD,
        "cost": {"flops": weighted["dot_flops"],
                 "bytes accessed": float(tree_bytes(read)),
                 "transcendentals": weighted["transcendental"]},
        "collectives": collectives(log),
        "weighted": weighted,
        "kernels": {k: v - before[k] for k, v in TRACED.items()
                    if v - before[k]},
        "ops": cost.ops,
        "params_per_device": sum(t.numel() for t in _tensors(params)),
    })
    return record, log


def _write(path: str, record: dict, log) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    save_log(path[:-len(".json")] + ".ops.gz", log)


def _cached(path: str, force: bool) -> Optional[dict]:
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return None


def _summary(rec: dict) -> str:
    w, mem = rec["weighted"], rec["memory"]
    gib = (mem["argument_bytes_per_device"]
           + mem["temp_bytes_per_device"]) / 2 ** 30
    return (f"--- {rec['arch']} x {rec['shape']} x {rec['mesh']} "
            f"({rec['device']}): {rec['trace_s']:.1f} s, {rec['ops']} ops, "
            f"dot_flops {w['dot_flops']:.3e}, collectives "
            f"{w['collective_bytes_total'] / 2 ** 30:.2f} GiB, args "
            f"{mem['argument_bytes_per_device'] / 2 ** 30:.2f} + temp "
            f"{mem['temp_bytes_per_device'] / 2 ** 30:.2f} = {gib:.2f} GiB "
            f"a rank, fits {rec['fits']}")


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = OUT_DIR, force: bool = False,
            verbose: bool = True, device: str = "cuda") -> dict:
    """Trace rank 0 of ``arch``'s ``shape_name`` step on the production
    mesh and write its record (module docstring); a record already in
    ``out_dir`` is returned unless ``force``."""
    from repro_torch.models.model import LM

    tag = mesh_tag(multi_pod)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
    got = _cached(path, force)
    if got is not None:
        return got
    shape = get_shape(shape_name)
    if shape.mode == "train":
        refuse_autograd(device)
    cfg = resolved_config(arch, shape_name)
    with fake_world(_world(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        with fake_mode(device):
            lm = LM(cfg, device=device)
            step, inputs = make_step_fn(lm, shape, mesh, device)
            record, log = trace_step(
                step, inputs, params=inputs[0],
                read=inputs[:2] if shape.mode == "decode" else inputs[0],
                device=device, arch=arch, shape=shape_name, mesh=tag,
                devices=mesh.size, mode=shape.mode, seq_len=shape.seq_len,
                global_batch=shape.global_batch)
            del inputs
            notes = _uneven_notes(lm, mesh, "train" if shape.mode == "train"
                                  else "decode")
    if shape.mode in PLACEMENT_NOTES:
        notes.insert(0, PLACEMENT_NOTES[shape.mode])
    if device == "cpu":
        notes.append(CPU_NOTE)
    record["notes"] = notes
    _write(path, record, log)
    if verbose:
        print(_summary(record), flush=True)
    return record


def run_cascade(variant: str = "compact", *, cloud_arch: str = "glm4-9b",
                batch: int = 128, seq: int = 2048, multi_pod: bool = False,
                capacity_frac: float = 0.25, out_dir: str = OUT_DIR,
                force: bool = False, verbose: bool = True,
                device: str = "cuda") -> dict:
    """Trace rank 0 of the ACE cascade's serving step (``repro``'s
    ``run_cascade``): ``lockstep`` (the cloud sees the whole batch) or
    ``compact`` (it sees the escalated slice), the edge a 4-layer draft of
    ``cloud_arch``; both models under the serving placement, the batch
    whole on every rank."""
    from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import rank_params
    from repro_torch.models.model import LM

    tag = mesh_tag(multi_pod)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"cascade-{variant}__b{batch}s{seq}__{tag}.json")
    got = _cached(path, force)
    if got is not None:
        return got
    cloud_cfg = get_config(cloud_arch)
    with fake_world(_world(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        with fake_mode(device):
            cloud = LM(cloud_cfg, device=device)
            edge = LM(edge_variant(cloud_cfg, layers=4), device=device)
            cascade = CascadeLM(edge, cloud, capacity_frac=capacity_frac)
            step = (cascade.serve_step if variant == "compact"
                    else cascade.lockstep_step)
            inputs = (rank_params(edge, mesh, "decode", device),
                      rank_params(cloud, mesh, "decode", device),
                      {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                             device=device)})
            record, log = trace_step(
                lambda e, c, b: step(e, c, b, mesh=mesh), inputs,
                params=inputs[:2], read=inputs[:2], device=device,
                arch=f"cascade-{variant}({cloud_arch})",
                shape=f"query_b{batch}s{seq}", mesh=tag, devices=mesh.size,
                mode="prefill", seq_len=seq, global_batch=batch)
            del inputs
            record["notes"] = ([PLACEMENT_NOTES["prefill"]]
                               + _uneven_notes(cloud, mesh, "decode")
                               + ([CPU_NOTE] if device == "cpu" else []))
    _write(path, record, log)
    if verbose:
        print(_summary(record), flush=True)
    return record


def table(out_dir: str = OUT_DIR) -> str:
    """The records in ``out_dir`` as a markdown table, a row an arch (or
    cascade) x shape and a column group a mesh: the roofline terms of a
    rank in ms (``analysis.roofline.roofline_from_record``: counted FLOPs,
    bytes and collective bytes over the H100's rates, not timed), its
    argument + temp GiB and whether they fit a card."""
    import glob

    from repro_torch.analysis.roofline import (param_counts,
                                               roofline_from_record)
    tags = sorted({t for t in PRODUCTION_MESHES})
    cells = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        arch = rec["arch"]
        if arch.startswith("cascade-"):
            arch = arch[arch.index("(") + 1:-1]
        r = roofline_from_record(rec, param_counts(arch))
        mem = rec["memory"]
        gib = (mem["argument_bytes_per_device"]
               + mem["temp_bytes_per_device"]) / 2 ** 30
        cells[(rec["arch"], rec["shape"])] = cells.get(
            (rec["arch"], rec["shape"]), {})
        cells[(rec["arch"], rec["shape"])][rec["mesh"]] = (
            f"{r['t_compute_s'] * 1e3:.1f} / {r['t_memory_s'] * 1e3:.1f} / "
            f"{r['t_collective_s'] * 1e3:.1f} | "
            f"{mem['argument_bytes_per_device'] / 2 ** 30:.1f} + "
            f"{mem['temp_bytes_per_device'] / 2 ** 30:.1f} = {gib:.1f} | "
            f"{'yes' if rec['fits'] else '**no**'}")
    head = " | ".join(f"{t}: compute / memory / collective ms | args + temp "
                      f"GiB | fits" for t in tags)
    lines = [f"| arch | shape | {head} |",
             "|---|---|" + "---|---|---|" * len(tags)]
    for (arch, shape), by in sorted(cells.items()):
        row = " | ".join(by.get(t, "- | - | -") for t in tags)
        lines.append(f"| {arch} | {shape} | {row} |")
    return "\n".join(lines)


def _job(name: str, fargs: tuple, multi_pod: bool, kw: dict):
    """One dry run (``run_one`` or ``run_cascade``); returns its failure
    as a string, or None."""
    fn = {"run_one": run_one, "run_cascade": run_cascade}[name]
    try:
        fn(*fargs, multi_pod=multi_pod, **kw)
    except Exception as e:  # noqa: BLE001 - report and continue
        traceback.print_exc()
        return repr(e)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cascade", default=None,
                    choices=["lockstep", "compact", "both"],
                    help="trace the ACE cascade step instead of an arch")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: fake CUDA tensors through the kernels' "
                         "shape rules; cpu: the plain versions")
    ap.add_argument("--jobs", type=int, default=1,
                    help="dry runs traced at once, each in a process of "
                         "its own")
    ap.add_argument("--table", action="store_true",
                    help="print the table of the records in --out and "
                         "trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0

    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    if args.cascade:
        variants = (["lockstep", "compact"] if args.cascade == "both"
                    else [args.cascade])
        jobs = [("run_cascade", (v,), mp) for v in variants for mp in meshes]
    else:
        archs = ASSIGNED_ARCHS if (args.all or args.arch is None) \
            else [args.arch]
        shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
            else [args.shape]
        jobs = [("run_one", (a, s), mp) for a in archs for s in shapes
                for mp in meshes]
    kw = dict(out_dir=args.out, force=args.force, device=args.device)
    t0 = time.perf_counter()
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(args.jobs,
                                    mp_context=mp.get_context("spawn")) as ex:
            errors = list(ex.map(_job, *zip(*jobs), [kw] * len(jobs)))
    else:
        errors = [_job(*job, kw) for job in jobs]
    failures = [job[1] + (mesh_tag(job[2]), e)
                for job, e in zip(jobs, errors) if e is not None]
    print(f"\n{len(jobs)} dry runs in {time.perf_counter() - t0:.1f} s "
          f"(counted, not timed: ms are a rank's roofline terms on the "
          f"H100's rates; GiB a rank)")
    print(table(args.out))
    if failures:
        print(f"FAILURES ({len(failures)}):")
        for f in failures:
            print(" ", f)
        return 1
    print("all dry runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
