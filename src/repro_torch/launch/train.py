"""Training launcher of the port, on one device: the same ``Trainer``
step the tests drive, over the synthetic ``TokenStream``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --no-reduced --steps 30 --batch 8 --seq 512

The port of ``repro.launch.train`` with its flags and defaults, less the
mesh: ``repro`` builds a host or production mesh and shards params and
optimizer state over it; the port trains on one device, and
``--production`` or ``--multi-pod`` raise ``NotImplementedError``
(meshes: ROADMAP Queue 1's tensor-parallel and federated items).
``--reduced`` trains the architecture's reduced config, as ``repro``'s
default off ``--production`` does, ``--no-reduced`` its full width and
depth; ``--device`` is ``cuda`` (the hand-written kernels) or ``cpu``
(their plain versions). Weights are random from seed 0, the learning rate
warms up over 10 steps and decays by a cosine to ``--steps``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.training.train_loop import make_train_step, to_device

MESH_REFUSAL = ("training meshes are not ported yet (ROADMAP Queue 1: "
                "federated training and the mesh launcher); the port "
                "trains on one device and serves on a mesh")


def train(args) -> list:
    """Run ``args.steps`` steps; returns the logged (step, loss) pairs."""
    if args.production or args.multi_pod:
        raise NotImplementedError(f"--production/--multi-pod: "
                                  f"{MESH_REFUSAL}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: the launcher's TokenStream makes text tokens only; "
            f"train a {cfg.frontend.kind} model through Trainer with its "
            f"own batches")
    lm = LM(cfg, device=dev)
    print(f"device={dev} arch={cfg.name}")
    step_fn = make_train_step(lm, linear_warmup_cosine(args.lr, 10,
                                                       args.steps))
    params = lm.init(0, on_device=dev.type == "cuda")
    opt = adamw_init(params)
    stream = TokenStream(cfg.vocab_size, seed=0)
    logged = []
    for i, batch in zip(range(args.steps),
                        stream.batches(args.batch, args.seq)):
        params, opt, metrics = step_fn(params, opt, to_device(batch, dev))
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            logged.append((i, loss))
            print(f"step {i:4d} loss {loss:.4f}")
    return logged


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
    train(ap.parse_args(argv))


if __name__ == "__main__":
    main()
