"""ECC training pattern on the PyTorch port (paper §2): federated learning
at two levels.

Level 1 — platform components: FedWorker components on each EC train
locally; model updates flow through the file service (data plane) announced
over bridged topics (control plane); a CC FedAvgAggregator merges them.

Level 2 — tensor level: the same FedAvg math over a mesh's data axis with
``FederatedTrainer``, one edge cloud a rank: NCCL with one card a rank
(every visible card), or two gloo ranks with ``--device cpu``.

The port of ``examples/federated_training.py``.

    PYTHONPATH=src python examples/torch/federated_training.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.platform import AcePlatform
from repro_torch.core.topology import Component, Resources, Topology
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.training.federated import FederatedTrainer

GLOO_ECS = 2          # edge clouds with --device cpu, one gloo rank each


def component_level(device):
    print("=== component level (ACE platform) ===")
    ace = AcePlatform()
    ace.register_user("bank")            # the paper's fraud-detection story
    infra = ace.register_infrastructure("bank", num_ecs=3, nodes_per_ec=2)
    ace.deploy_services(infra)

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=4).astype(np.float32)

    def local_train(params, data, lr=0.2, steps=10):
        x, y = data
        w = torch.as_tensor(params["w"], device=device).clone()
        for _ in range(steps):
            w.requires_grad_(True)
            g, = torch.autograd.grad(torch.mean((x @ w - y) ** 2), w)
            w = (w - lr * g).detach()
        loss = float(torch.mean((x @ w - y) ** 2))
        return {"w": w}, loss

    # agg 'connects to' the workers so the controller deploys them first —
    # its initial broadcast must find their subscriptions live
    comps = {"agg": Component(
        name="agg", image="repro/pattern/fed-aggregator", placement="cloud",
        resources=Resources(cpu=1, memory_mb=256),
        connections=["w0", "w1", "w2"],
        params={"init": {"init_params": {"w": torch.zeros(4, device=device)},
                         "num_workers": 3, "rounds": 5}})}
    for i in range(3):
        x = torch.as_tensor(rng.normal(size=(64, 4)).astype(np.float32),
                            device=device)
        comps[f"w{i}"] = Component(
            name=f"w{i}", image="repro/pattern/fed-worker", placement="edge",
            replicas="one", resources=Resources(cpu=0.5, memory_mb=128),
            params={"init": {"local_train": local_train,
                             "data": (x, x @ torch.as_tensor(
                                 w_true, device=device)),
                             "rounds": 5}})
    topo = Topology(app="fed", version=1, components=comps)
    ace.submit_app("bank", infra, topo)
    ace.deploy_app("bank", "fed")
    agg = ace.instances(infra, "agg")[0][1]
    w_learned = agg.global_params["w"].cpu().numpy()
    print(f"  rounds completed: {agg.round_idx}")
    print(f"  |w - w_true| = {np.linalg.norm(w_learned - w_true):.4f}")


def _tensor_rank(rank, n_ec):
    """One edge cloud: its slice of the data, FedAvg with the others."""
    mesh = make_host_mesh(1)
    rng = np.random.default_rng(1)
    w_true = rng.normal(size=8).astype(np.float32)
    xs = rng.normal(size=(n_ec, 128, 8)).astype(np.float32)
    ys = xs @ w_true

    def loss_fn(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] - y) ** 2)

    ft = FederatedTrainer(loss_fn, mesh, lr=0.1, local_steps=8)
    params = ft.replicate({"w": torch.zeros(8)})
    opt = ft.init_opt(params)
    mine = mesh.data_rank
    batch = tuple(torch.as_tensor(a[mine], device=mesh.device)
                  for a in (xs, ys))
    for r in range(10):
        params, opt, loss = ft.round(params, opt, batch)
        if rank == 0 and (r % 3 == 0 or r == 9):
            print(f"  round {r}: loss {float(loss):.5f}", flush=True)
    final = ft.unreplicate(params)["w"].cpu().numpy()
    if rank == 0:
        print(f"  |w - w_true| = {np.linalg.norm(final - w_true):.4f}",
              flush=True)


def tensor_level(device):
    if device.type == "cpu":
        n_ec, backend = GLOO_ECS, "gloo"
    else:
        n_ec, backend = torch.cuda.device_count(), "nccl"
    print(f"=== tensor level (mesh FedAvg, {n_ec} edge clouds on {backend} "
          f"ranks) ===", flush=True)
    spawn(_tensor_rank, n_ec, args=(n_ec,), backend=backend)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (gloo ranks)")
    device = resolve_device(ap.parse_args(argv).device)
    component_level(device)
    tensor_level(device)


if __name__ == "__main__":
    main()
