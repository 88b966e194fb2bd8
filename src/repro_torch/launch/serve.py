"""Serving launcher of the port: open-loop traffic through the async
gateway (streamed tokens, backpressure, SLO classes) on the dense engine,
or the ACE edge/cloud cascade with --cascade, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --cascade
    PYTHONPATH=src python -m repro_torch.launch.serve --rate 40 --policy shed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --device cpu \
        --arch mixtral-8x22b
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 4 \
        --arch mixtral-8x22b --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --device cpu \
        --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --device cpu \
        --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --world 4 \
        --device cpu

The port of ``repro.launch.serve``, with its flags but one:
``--compile-cache`` is gone (the port's programs are CUDA graphs, which
live and die with their process). ``--mesh N`` serves tensor-parallel on
an N-way model axis, one process a rank (``launch.mesh.spawn``): NCCL
with one card a rank, or gloo with ``--device cpu``. ``repro`` takes the
mesh's data axis from the device count (``make_host_mesh(model=N)`` over
every device); so does the port: under NCCL the world is the visible
cards, on gloo ``--world`` ranks (default N, the stand-in for ``repro``'s
host device count), and N must divide it: the mesh is (world / N, N),
whose data ranks hold the decode rules' d_model shards and equal caches.
As in ``repro``, ``--mesh 1`` serves on one device. Rank 0 runs the
gateway, the journal and the watchdog and prints what the one-process
run prints; the other ranks follow its engine calls
(``serving.gateway.follow``). Every
text-token architecture splits: dense GQA, MoE and MLA (mixtral-8x22b's
experts split by expert, deepseek-v3-671b's too and its MLA heads), the
RG-LRU hybrid (recurrentgemma-9b's width) and xLSTM (xlstm-125m's heads);
each rank draws only its shards (``LM.init(..., mesh=)``). ``--supervise``,
``--hang-demo`` and ``--wedge-demo`` run on a mesh too: the journal, the
snapshots and the watchdog live on rank 0, and a supervised restart
writes off every rank's engine before it builds a fresh one on the same
mesh (``MeshLeader.rebuild``). ``--reduced``
serves the architecture's reduced config, as ``repro``'s default does, and
``--no-reduced`` its full width and depth (``repro``'s flag cannot be
turned off). The engines serve text-token streams: an audio or vision
architecture (``musicgen-medium``, ``internvl2-2b``) exits with the
engine's ``NotImplementedError`` message before any weight is made (serve
those through ``LM`` or ``CascadeEngine.query``, as in ``repro``).
``--device cpu`` runs the plain versions. Weights are random,
from seeds 0 (the model, or the cascade's cloud) and 1 (the edge), drawn
on the card unless ``--device cpu``; the
engine is warmed (``warm_compile``) before the first arrival.

Arrivals are an open-loop Poisson process (``--rate`` req/s); beyond
capacity the gateway's bounded queue and backpressure policy decide who
waits, who is shed and who is refused.

Durability (--supervise): a write-ahead request journal, periodic engine
snapshots and a wall-clock watchdog on every step. Two demo faults drive
the recovery ladder end to end:

    --hang-demo    a step stalls briefly: the watchdog times out, the late
                   step is rolled back through the retry path (note_hang)
                   and service goes on in-process
    --wedge-demo   a step stalls past the grace window: the driver raises
                   EngineWedgedError, and the supervisor restarts a fresh
                   engine from snapshot + journal once the event loop (and
                   the stalled step's thread) has ended; recovered requests
                   finish token-exact, lost ones are replayed

On a mesh every rank's engine stalls in the same step (its own fault
plan's ``hang`` seam; a follower sleeps in its main thread), so every rank
reaches the restart after its stalled step has ended, and no rank
captures a graph while an old step still runs. The restart builds each
rank's fresh engine (weights drawn again from seed 0, no fault plan) only
after its wedged one is released: two engines at full width need not fit
a card. On one device the fresh engine is built beside the wedged one.
"""
from __future__ import annotations

import argparse
import asyncio
import functools
import os
import tempfile
import time
from collections import Counter

import numpy as np

from repro_torch import resolve_device
from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant
from repro_torch.cascade.gate import make_thresholds
from repro_torch.configs import get_config
from repro_torch.core.monitoring import MonitoringService
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh, spawn
from repro_torch.models.model import LM
from repro_torch.serving import (CascadeServingEngine, EngineWedgedError,
                                 FaultPlan, MeshLeader, RequestJournal,
                                 ServingEngine, ServingGateway, follow,
                                 recover_engine)
from repro_torch.serving.engine import check_text_model
from repro_torch.sharding import tensor_parallel


def _build_engine(cfg, args, fault_plan=None, mesh=None):
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    # on a card the weights are drawn there (layer by layer); on a mesh each
    # rank draws only its shards whole, one leaf or layer at a time
    kw = dict(on_device=dev.type != "cpu", mesh=mesh)
    if args.cascade:
        cloud = LM(cfg, device=dev)
        check_text_model(cloud)
        edge = LM(edge_variant(cfg, layers=1), device=dev)
        cascade = CascadeLM(edge, cloud,
                            thresholds=make_thresholds(hi=0.01, lo=0.001))
        return CascadeServingEngine(cascade, edge.init(1, **kw),
                                    cloud.init(0, **kw), batch_slots=4,
                                    max_seq_len=96, fault_plan=fault_plan,
                                    mesh=mesh)
    lm = LM(cfg, device=dev)
    check_text_model(lm)
    return ServingEngine(lm, lm.init(0, **kw), batch_slots=4,
                         max_seq_len=96, fault_plan=fault_plan, mesh=mesh)


async def _client(gw: ServingGateway, prompt, max_new: int,
                  priority: int, deadline_s, quiet: bool) -> dict:
    """One open-loop client: submit, consume the stream, report."""
    h = await gw.submit(prompt, max_new_tokens=max_new, priority=priority,
                        deadline_s=deadline_s)
    toks = [t async for t in h.stream()]
    r = await h.result()
    if not quiet:
        route = getattr(r, "route", "")
        extra = f" route={route}" if route else ""
        print(f"req {r.request_id}: status={r.status}{extra} "
              f"tokens={toks} ttft={r.ttft_s * 1e3:.0f}ms "
              f"latency={r.latency_s * 1e3:.0f}ms")
    return {"status": r.status, "streamed": len(toks)}


def _demo_fault_plan(args):
    """The two watchdog demos differ only in stall length against the
    watchdog's deadline: a hang ends late (in-process rollback through
    note_hang), a wedge outlasts the grace window (supervised restart)."""
    if args.wedge_demo:
        return FaultPlan(hang=[2],
                         hang_s=args.step_timeout * (1.0 + args.hang_grace)
                         + 2.0)
    if args.hang_demo:
        return FaultPlan(hang=[2], hang_s=args.step_timeout * 1.5)
    return None


async def _front(args, cfg, eng, gw, monitor):
    """The open-loop arrivals through the gateway; returns the clients'
    reports and the EngineWedgedError, if the driver raised one."""
    rng = np.random.default_rng(0)
    results, wedged = [], None
    try:
        async with gw:
            clients = []
            for i in range(args.requests):
                prompt = rng.integers(0, min(1000, cfg.vocab_size),
                                      size=4 + i % 5)
                priority = i % 2 if args.classes > 1 else 0
                clients.append(asyncio.create_task(_client(
                    gw, prompt, args.max_new, priority,
                    args.deadline if priority else None, args.quiet)))
                # open loop: exponential inter-arrivals at --rate req/s
                await asyncio.sleep(float(rng.exponential(1.0 / args.rate)))
            results = await asyncio.gather(*clients)
    except EngineWedgedError as e:
        wedged = e
        monitor.record_hang("serve", detail=str(e))
    return results, wedged


def serve(args, mesh=None) -> None:
    """The launcher's run, in this process or as rank 0 of ``mesh``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    monitor = MonitoringService()
    journal = None
    gw_kw = {}
    if args.supervise:
        state_dir = args.state_dir or tempfile.mkdtemp(prefix="serve_")
        journal = RequestJournal(os.path.join(state_dir, "journal.jsonl"))
        gw_kw = dict(journal=journal,
                     snapshot_dir=os.path.join(state_dir, "snapshots"),
                     snapshot_every=args.snapshot_every,
                     step_timeout_s=args.step_timeout,
                     hang_grace=args.hang_grace)
        print(f"supervised: state in {state_dir}")
    build = functools.partial(_build_engine, cfg, args, mesh=mesh)
    try:
        eng = build(fault_plan=_demo_fault_plan(args))
    except NotImplementedError as e:
        raise SystemExit(f"serve --arch {args.arch}: {e}")
    if mesh is not None:
        eng = MeshLeader(eng, mesh)
    try:
        _serve_engine(args, cfg, eng, build, monitor, journal, gw_kw)
    finally:
        if mesh is not None:
            eng.stop()
    if journal is not None:
        journal.close()


def _serve_engine(args, cfg, eng, build, monitor, journal, gw_kw) -> None:
    eng.warm_compile()
    gw = ServingGateway(eng, max_queue=args.max_queue, policy=args.policy,
                        **gw_kw)
    # asyncio.run joins the executor's threads on exit: a wedged step's
    # thread has ended before any fresh engine below touches the card
    results, wedged = asyncio.run(_front(args, cfg, eng, gw, monitor))
    by_status = Counter(res["status"] for res in results)
    print(f"served {len(results)} arrivals at {args.rate:.0f} req/s: "
          f"{dict(by_status)}  gateway={gw.stats()}")
    if wedged is not None:
        if not args.supervise:
            raise wedged
        # supervised restart: the wedged engine is written off; a fresh
        # one is recovered from the last snapshot + the journal and drains
        # the surviving work (token-exact resumes; lost acknowledged
        # submissions start over from their prompts)
        print(f"engine wedged ({wedged}); restarting from snapshot")
        restart = time.perf_counter()
        fresh = functools.partial(build, fault_plan=None)
        if isinstance(eng, MeshLeader):
            eng.rebuild(fresh)          # every rank, old engine freed first
        else:
            eng = fresh()
        first = []
        eng.on_tokens = lambda ev: first or first.append(time.perf_counter())
        warm = time.perf_counter()
        eng.warm_compile()
        warm = time.perf_counter() - warm
        info = recover_engine(eng, snapshot_dir=gw_kw["snapshot_dir"],
                              journal=journal)
        monitor.record_restart("serve", info)
        monitor.record_journal("serve", info["replayed"])
        done = eng.run()
        statuses = Counter(r.status for r in done.values())
        print(f"recovered {info['restored']} + replayed "
              f"{info['replayed']}; post-restart drain: {dict(statuses)}")
        first_ms = (first[0] - restart) * 1e3 if first else float("nan")
        print(f"restart: warm_compile {warm:.2f} s, first "
              f"token {first_ms:.0f} ms after the restart began")
        print(f"durability: {monitor.durability_counters()}")


def _serve_rank(rank: int, args) -> None:
    """One rank of ``--mesh N``: rank 0 serves, the others follow."""
    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    mesh = make_host_mesh(args.mesh, device=device)
    if rank == 0:
        serve(args, mesh)
        return
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    build = functools.partial(_build_engine, cfg, args, mesh=mesh)
    try:
        box = [build(fault_plan=_demo_fault_plan(args))]
    except NotImplementedError:
        return                          # rank 0 reports it and stops
    # follow holds the only reference, so a rebuild frees the old engine;
    # the fresh one has no fault plan
    follow(box.pop(), mesh, rebuild=functools.partial(build, fault_plan=None))


def mesh_world(args) -> int:
    """The ranks of ``--mesh N``'s mesh: the visible cards under NCCL,
    ``--world`` (default N) on gloo; N must divide it."""
    import torch

    if args.device == "cpu":
        world = args.world or args.mesh
    else:
        if args.world is not None:
            raise SystemExit("--world sets the gloo ranks of --device cpu; "
                             "under NCCL the world is the visible cards")
        resolve_device(args.device)
        world = torch.cuda.device_count()
        if world < args.mesh:
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} cards, one a rank "
                f"(found {world}); --device cpu serves the mesh on the CPU "
                f"over gloo")
    if world % args.mesh:
        raise SystemExit(f"--mesh {args.mesh} does not divide a world of "
                         f"{world} ranks")
    return world


def serve_mesh(args) -> None:
    """``--mesh N``: a (world / N, N) mesh of ranks as processes, NCCL on
    the cards or gloo on the CPU."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = mesh_world(args)
    try:
        check_text_model(LM(cfg, device="cpu"))
        tensor_parallel(cfg, AbstractMesh(args.mesh, world // args.mesh))
    except NotImplementedError as e:
        raise SystemExit(f"serve --arch {args.arch} --mesh {args.mesh}: {e}")
    backend = "gloo" if args.device == "cpu" else "nccl"
    spawn(_serve_rank, world, args=(args,), backend=backend)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-reduced: full "
                         "width and depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--cascade", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered load, requests/s (open loop)")
    ap.add_argument("--policy", default="block",
                    choices=["block", "reject", "shed",
                             "reject-overload", "shed-lowest-class"])
    ap.add_argument("--max-queue", type=int, default=16)
    ap.add_argument("--classes", type=int, default=2,
                    help="SLO classes to alternate arrivals over")
    ap.add_argument("--deadline", type=float, default=None,
                    help="relative deadline (s) for class-1 arrivals")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--supervise", action="store_true",
                    help="journal + periodic snapshots + watchdog; on "
                         "EngineWedgedError, restart from snapshot")
    ap.add_argument("--state-dir", default=None,
                    help="journal/snapshot directory (default: tmpdir)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="tensor-parallel ways: N ranks, one process each "
                         "(NCCL with one card a rank, gloo with --device "
                         "cpu); every text-token architecture")
    ap.add_argument("--world", type=int, default=None,
                    help="with --device cpu, the gloo ranks of the --mesh "
                         "N mesh, (world / N, N) over (data, model); "
                         "default N (under NCCL: the visible cards)")
    ap.add_argument("--step-timeout", type=float, default=5.0,
                    help="watchdog wall-clock deadline per step (s)")
    ap.add_argument("--hang-grace", type=float, default=1.0,
                    help="grace window as a multiple of --step-timeout")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="engine steps between periodic snapshots")
    ap.add_argument("--hang-demo", action="store_true",
                    help="inject a recoverable step stall")
    ap.add_argument("--wedge-demo", action="store_true",
                    help="inject a stall past grace (supervised restart)")
    args = ap.parse_args(argv)
    if args.world is not None and args.mesh == 1:
        raise SystemExit("--world sets the ranks of a --mesh N mesh; "
                         "--mesh 1 serves on one device")
    if args.hang_demo or args.wedge_demo:
        args.supervise = True
    if args.mesh > 1:
        serve_mesh(args)
    else:
        serve(args)


if __name__ == "__main__":
    main()
