"""Training launcher of the port: the same ``Trainer`` step the tests
drive, over the synthetic ``TokenStream``, on one device or on a (D, M)
mesh of D × M ranks: data-parallel over D, tensor-parallel over M.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --no-reduced --steps 30 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 2 \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 4 \
        --no-reduced --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --mesh-model 2 \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --no-reduced --mesh-model 4 --batch 4 --seq 4096 --steps 12 --warm 2
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --production --arch glm4-9b --batch 256 --seq 4096

The port of ``repro.launch.train`` with its flags and defaults. ``repro``
builds a host mesh, ``make_host_mesh()`` over its device count, whose
model axis is 1, and shards params (FSDP) and optimizer state (ZeRO)
over its ``data`` axis by the train rules, the batch by ``batch_pspecs``
(``ShardedLoader``). The port's ``--mesh-data D`` stands for that device
count: D ranks, one process each (``launch.mesh.spawn``), NCCL with one
card a rank or gloo with ``--device cpu``, on a (D, 1) mesh, each
global ``--batch`` drawn by one rank and passed to the others
(``global_batches``), each rank taking its rows of it (``data.loader.
ShardedLoader``) and stepping its shards (``training.train_loop``);
rank 0 prints. ``--mesh-model M`` adds ``repro``'s model axis: D × M
ranks on a (D, M) mesh, the params cut on 'model' by the train rules
and the loss run tensor-parallel on each model group
(``training.train_loop``).
``--production`` and ``--multi-pod`` train on ``repro``'s production
meshes, (data 16, model 16) over 256 ranks and (data 32, model 16) over
512 (``launch.mesh.make_production_mesh``), inside a process group that a
launcher started (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and a rendezvous, read by ``env://``), one process a card; any other
world raises. ``launch.dryrun`` traces one rank of that step on fake
tensors, which is how it is checked without 256 cards. ``--warm W`` times the steps after the
first W with CUDA events and prints ms a step, tokens/s, 6·N·D a step
over the ranks' peak bf16 rate, peak memory, the weight, gradient and
moment bytes a rank and a step's collectives (``--report`` writes them
as JSON). ``--reduced`` trains the
architecture's reduced config, the default off ``--production`` as in
``repro``, ``--no-reduced`` (the default on the production meshes) its
full width and depth;
``--device`` is ``cuda`` (the hand-written kernels) or ``cpu`` (their
plain versions). Weights are random from seed 0, the learning rate warms
up over 10 steps and decays by a cosine to ``--steps``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.mesh import (COLLECTIVES, PEAK_FLOPS_BF16,
                                     make_host_mesh, make_production_mesh,
                                     spawn)
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.training.train_loop import make_train_step
from repro_torch.utils.tree import tree_leaves

def _production(args) -> bool:
    return args.production or args.multi_pod


def _config(args):
    cfg = get_config(args.arch)
    reduced = (not _production(args)) if args.reduced is None \
        else args.reduced
    if reduced:
        cfg = cfg.reduced()
    if cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: the launcher's TokenStream makes text tokens only; "
            f"train a {cfg.frontend.kind} model through Trainer with its "
            f"own batches")
    return cfg


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _spec_numel(spec) -> int:
    if isinstance(spec, dict):
        return sum(_spec_numel(v) for v in spec.values())
    if isinstance(spec, list):
        return sum(_spec_numel(v) for v in spec)
    return math.prod(spec[0])


def global_batches(stream, batch: int, seq: int, mesh=None):
    """``stream.batches(batch, seq)``'s global batches in order. On a mesh
    each is drawn once: rank r draws batch r of each run of world-size
    batches, and the ranks swap them on the host group, a run at a time
    (a full-width vocab's batch takes the host tens of seconds)."""
    if mesh is None or mesh.size == 1:
        yield from stream.batches(batch, seq)
        return
    n = mesh.size
    for first in itertools.count(0, n):
        mine = next(stream.batches(batch, seq, seed=first + mesh.rank))
        run = [None] * n
        torch.distributed.all_gather_object(run, mine, group=mesh._host)
        yield from run


def train(args, mesh=None) -> list:
    """Run ``args.steps`` steps (on ``mesh``: this rank's part of the
    mesh's run); returns the logged (step, loss) pairs."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(args)
    lm = LM(cfg, device=dev)
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"device={dev} arch={cfg.name}"
              + ("" if mesh is None else f" mesh={mesh.shape}"))
    step_fn = make_train_step(lm, linear_warmup_cosine(args.lr, 10,
                                                       args.steps),
                              mesh=mesh)
    params = lm.init(0, on_device=cuda, mesh=mesh, mode="train")
    opt = adamw_init(params)
    stream = TokenStream(cfg.vocab_size, seed=0)
    batches = ShardedLoader(global_batches(stream, args.batch, args.seq,
                                           mesh), mesh=mesh, device=dev)
    logged, marks, counts, losses = [], [], None, []
    for i, batch in zip(range(args.steps), batches):
        timed = args.warm is not None and i >= args.warm
        if timed and cuda:
            marks.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
        before = dict(COLLECTIVES)
        params, opt, metrics = step_fn(params, opt, batch)
        if timed and cuda:
            marks[-1][1].record()
        if timed and counts is None:
            counts = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items()
                      if v != before.get(k, 0)}
        losses.append(metrics["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            logged.append((i, loss))
            if lead:
                print(f"step {i:4d} loss {loss:.4f}")
    if args.warm is not None and marks:
        _report(args, mesh, lm, params, opt, marks, counts,
                [float(x) for x in losses], dev)
    return logged


def _report(args, mesh, lm, params, opt, marks, counts, losses, dev):
    """``--warm``: the timed steps' figures (every rank's peak), printed by
    rank 0 and written to ``--report``."""
    torch.cuda.synchronize(dev)
    ms = sorted(a.elapsed_time(b) for a, b in marks)
    med = ms[len(ms) // 2] if len(ms) % 2 else sum(
        ms[len(ms) // 2 - 1:len(ms) // 2 + 1]) / 2
    ranks = 1 if mesh is None else mesh.size
    n = _spec_numel(lm.param_spec())
    tokens = args.batch * args.seq
    peak = torch.cuda.max_memory_allocated(dev)
    if mesh is not None:
        box = [None] * mesh.size
        torch.distributed.all_gather_object(box, peak, group=mesh._host)
        peak = max(box)
    rec = dict(arch=lm.cfg.name, ranks=ranks,
               mesh=None if mesh is None else dict(mesh.shape),
               batch=args.batch, seq=args.seq, timed_steps=len(ms),
               ms=ms, median_ms=med, tokens_per_s=tokens / (med / 1e3),
               params=n, model_flops_share=6 * n * tokens / (med / 1e3)
               / (ranks * PEAK_FLOPS_BF16),
               peak_gib=peak / 2 ** 30, weight_bytes=_bytes(params),
               # a step's gradient: one leaf a param shard, in its dtype
               # (counted from the params, not read off the step)
               grad_bytes=_bytes(params),
               moment_bytes=_bytes((opt.mu, opt.nu)),
               collectives=counts, losses=losses)
    if mesh is None or mesh.rank == 0:
        print(f"timed {len(ms)} steps after {args.warm}: {med:.2f} ms a "
              f"step (median; CUDA events), {rec['tokens_per_s']:.0f} "
              f"tokens/s, 6·N·D {rec['model_flops_share']:.3f} of "
              f"{ranks} x {PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s (N "
              f"{n / 1e9:.3f} B); peak {rec['peak_gib']:.2f} GiB a rank; "
              f"a rank's weights {rec['weight_bytes'] / 2 ** 30:.2f} GiB, "
              f"gradients {rec['grad_bytes'] / 2 ** 30:.2f} GiB, moments "
              f"{rec['moment_bytes'] / 2 ** 30:.2f} GiB; collectives a "
              f"step {counts}")
        if args.report:
            with open(args.report, "w") as f:
                json.dump(rec, f)


def _train_rank(rank: int, args) -> None:
    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    train(args, make_host_mesh(args.mesh_model, device=device))


def production_mesh(args):
    """``--production`` / ``--multi-pod``: this process's rank of the
    production mesh, over the default process group (one a launcher
    started: ``env://``, NCCL, gloo with ``--device cpu``; a group already
    initialised is taken as it is). A world of other than 256 or 512 ranks
    raises (``make_production_mesh``)."""
    if not torch.distributed.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "--production/--multi-pod run one process a card inside a "
                "launcher's process group (torchrun: RANK, WORLD_SIZE, "
                "LOCAL_RANK and a rendezvous); python -m "
                "repro_torch.launch.dryrun traces one rank without one")
        torch.distributed.init_process_group(
            "gloo" if args.device == "cpu" else "nccl", init_method="env://")
    device = "cpu" if args.device == "cpu" else None
    if device is None and torch.distributed.get_backend() == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", torch.distributed.get_rank()
            % torch.cuda.device_count())))
    return make_production_mesh(multi_pod=args.multi_pod, device=device)


def train_mesh(args) -> None:
    """``--mesh-data D --mesh-model M``: D × M ranks as processes, NCCL on
    D × M cards or gloo on the CPU."""
    _config(args)
    world = args.mesh_data * args.mesh_model
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl":
        resolve_device(args.device)
        if torch.cuda.device_count() < world:
            raise SystemExit(
                f"a ({args.mesh_data}, {args.mesh_model}) mesh needs "
                f"{world} cards, one a rank (found "
                f"{torch.cuda.device_count()}); --device cpu trains the "
                f"mesh on the CPU over gloo")
    t0 = time.perf_counter()
    spawn(_train_rank, world, args=(args,), backend=backend)
    print(f"{world} ranks done in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--production", action="store_true",
                    help="the (16, 16) production mesh: 256 ranks of a "
                         "launcher's process group")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (32, 16) multi-pod mesh: 512 ranks")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="train the reduced config (the default off the "
                         "production meshes; --no-reduced: full width and "
                         "depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel ranks, repro's device count: D "
                         "processes (NCCL with one card a rank, gloo with "
                         "--device cpu), FSDP params and ZeRO moments")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ranks of each data rank's model "
                         "group: D x M processes in all")
    ap.add_argument("--warm", type=int, default=None,
                    help="time every step after the first WARM (CUDA "
                         "events) and print the step's figures")
    ap.add_argument("--report", default=None,
                    help="with --warm, also write the figures here (JSON)")
    args = ap.parse_args(argv)
    if _production(args):
        train(args, production_mesh(args))
    elif args.mesh_data * args.mesh_model > 1:
        train_mesh(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
