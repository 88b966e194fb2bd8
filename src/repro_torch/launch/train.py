"""Training launcher of the port: the same ``Trainer`` step the tests
drive, over the synthetic ``TokenStream``, on one device or data-parallel
on D ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --no-reduced --steps 30 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 2 \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 4 \
        --no-reduced --batch 8 --seq 512

The port of ``repro.launch.train`` with its flags and defaults. ``repro``
builds a host mesh, ``make_host_mesh()`` over its device count, whose
model axis is 1, and shards params (FSDP) and optimizer state (ZeRO)
over its ``data`` axis by the train rules, the batch by ``batch_pspecs``
(``ShardedLoader``). The port's ``--mesh-data D`` stands for that device
count: D ranks, one process each (``launch.mesh.spawn``), NCCL with one
card a rank or gloo with ``--device cpu``, on a (D, 1) mesh, each rank
drawing its rows of every global ``--batch`` (``data.loader.
ShardedLoader``) and stepping its shards (``training.train_loop``);
rank 0 prints. ``--production`` and ``--multi-pod`` (256 and 512
devices) raise ``NotImplementedError``. ``--reduced`` trains the
architecture's reduced config, as ``repro``'s default off
``--production`` does, ``--no-reduced`` its full width and depth;
``--device`` is ``cuda`` (the hand-written kernels) or ``cpu`` (their
plain versions). Weights are random from seed 0, the learning rate warms
up over 10 steps and decays by a cosine to ``--steps``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.training.train_loop import (make_train_step,
                                             place_train_params)

MESH_REFUSAL = ("the production meshes (256 and 512 devices, a model "
                "axis above 1) are not ported (ROADMAP Queue 1); the port "
                "trains on one device or data-parallel on --mesh-data D "
                "ranks")


def _config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: the launcher's TokenStream makes text tokens only; "
            f"train a {cfg.frontend.kind} model through Trainer with its "
            f"own batches")
    return cfg


def train(args, mesh=None) -> list:
    """Run ``args.steps`` steps (on ``mesh``: this rank's part of a data-
    parallel run); returns the logged (step, loss) pairs."""
    if args.production or args.multi_pod:
        raise NotImplementedError(f"--production/--multi-pod: "
                                  f"{MESH_REFUSAL}")
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    if dev.type == "cuda":
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
    params = lm.init(0, on_device=dev.type == "cuda")
    if mesh is not None:
        params = place_train_params(mesh, lm, params)
    opt = adamw_init(params)
    stream = TokenStream(cfg.vocab_size, seed=0)
    batches = ShardedLoader(stream.batches(args.batch, args.seq), mesh=mesh,
                            device=dev)
    logged = []
    for i, batch in zip(range(args.steps), batches):
        params, opt, metrics = step_fn(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            logged.append((i, loss))
            if lead:
                print(f"step {i:4d} loss {loss:.4f}")
    return logged


def _train_rank(rank: int, args) -> None:
    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    train(args, make_host_mesh(1, device=device))


def train_mesh(args) -> None:
    """``--mesh-data D``: D ranks as processes, NCCL on D cards or gloo on
    the CPU."""
    if args.production or args.multi_pod:
        raise NotImplementedError(f"--production/--multi-pod: "
                                  f"{MESH_REFUSAL}")
    _config(args)
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl":
        resolve_device(args.device)
        if torch.cuda.device_count() < args.mesh_data:
            raise SystemExit(
                f"--mesh-data {args.mesh_data} needs {args.mesh_data} "
                f"cards, one a rank (found {torch.cuda.device_count()}); "
                f"--device cpu trains the mesh on the CPU over gloo")
    spawn(_train_rank, args.mesh_data, args=(args,), backend=backend)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--production", action="store_true",
                    help="the production mesh (not ported: raises)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a multi-pod mesh (not ported: raises)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the reduced config (--no-reduced: full "
                         "width and depth)")
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
    args = ap.parse_args(argv)
    if args.mesh_data > 1:
        train_mesh(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
