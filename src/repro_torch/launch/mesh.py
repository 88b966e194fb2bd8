"""Meshes over ``torch.distributed``: one process per rank.

``repro`` builds a ``jax.sharding.Mesh`` of ("data", "model") over the
devices one controller sees. The port runs SPMD instead: each rank is a
process holding its shards, and ``HostMesh`` is its view of the mesh over
an initialised process group, shape ``{"data": 1, "model": N}``, with its
rank, the device its shards live on and the collectives the model and the
engine issue. NCCL on the card (each rank on its own card, or gloo with
several ranks on one card, which is the only way one card sees real
splits); gloo on the CPU. A ``data`` axis above 1 (``repro``'s FSDP over
``data``) is not ported.

Float payloads reduce in float32 and are cast back, so a sum of bf16
partials rounds once. A gather is NCCL's ``all_gather_into_tensor``; on
gloo, which takes only ``all_reduce`` and ``broadcast`` on CUDA tensors,
it is an ``all_reduce`` of a zero-filled full tensor holding each rank's
slice (exact: a sum with zeros). ``COLLECTIVES`` counts the calls, as
``kernels.LAUNCHES`` counts kernel launches, so a CUDA graph can say that
it captured them.

``spawn`` starts N ranks as processes (``torch.multiprocessing``, each
with its own rendezvous), and ``free_port`` finds a port for a TCP
rendezvous on this host.
"""
from __future__ import annotations

import datetime
import gc
import socket
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                               "broadcast": 0}


class AbstractMesh:
    """A mesh's shape alone, ``{"data": data, "model": model}``: what the
    placement rules read, with no process group (``repro``'s
    ``AbstractMesh``)."""

    def __init__(self, model: int = 1, data: int = 1):
        if model < 1 or data < 1:
            raise ValueError(f"mesh axes must be >= 1 (data {data}, model "
                             f"{model})")
        self.shape = {"data": data, "model": model}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


class HostMesh(AbstractMesh):
    """This rank's view of a ("data", "model") mesh over the process group
    ``group`` (the default group if None). ``device`` is where this rank's
    shards live (default: ``cuda:<rank>`` under NCCL, the CPU under
    gloo). Host messages (``broadcast_object``) travel on a gloo group of
    their own, so they never queue behind the card's work nor pair up
    with a model collective that a rank has still to issue."""

    def __init__(self, model: Optional[int] = None, device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("HostMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        world = dist.get_world_size(group)
        model = world if model is None else model
        if world % model:
            raise ValueError(f"a {model}-way model axis does not divide "
                             f"{world} ranks")
        if world // model > 1:
            raise NotImplementedError(
                f"a data axis of {world // model} (repro's FSDP over 'data' "
                f"in decode) is not ported: the mesh is {{'data': 1, "
                f"'model': N}} (ROADMAP Queue 1)")
        super().__init__(model=model, data=1)
        self.group = group
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        if device is None:
            device = (f"cuda:{self.rank}" if self.backend == "nccl"
                      else "cpu")
        self.device = torch.device(device)
        self._host = dist.new_group(
            ranks=None if group is None else dist.get_process_group_ranks(
                group), backend="gloo")

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may capture this mesh's collectives (NCCL;
        gloo's run on the host)."""
        return self.backend == "nccl"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, reduced in float32 (integers as
        they are) and returned in ``x``'s dtype."""
        y = x.float() if x.is_floating_point() else x.clone()
        dist.all_reduce(y, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return y.to(x.dtype)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' equal slices ``x`` joined along ``dim`` in rank order:
        an all-gather on NCCL, on gloo the all-reduce of a zero-filled full
        tensor."""
        dim = dim % x.dim()
        n = self.shape["model"]
        if self.backend == "nccl":
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
            COLLECTIVES["all_gather"] += 1
            shape = list(x.shape)
            shape[dim] *= n
            return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(
                shape)
        w = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = w * n
        full = torch.zeros(shape, dtype=torch.float32
                           if x.is_floating_point() else x.dtype,
                           device=x.device)
        full.narrow(dim, self.rank * w, w).copy_(x)
        dist.all_reduce(full, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return full.to(x.dtype)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.shape["model"]
        return x.narrow(dim, self.rank * n, n)

    def broadcast_object(self, obj=None, src: int = 0):
        """``obj`` from rank ``src`` to every rank (pickled, on the host
        group); the other ranks pass None and get it back."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._host)
        COLLECTIVES["broadcast"] += 1
        return box[0]


def same_device(a, b) -> bool:
    """Whether two devices are one ("cuda" is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def make_host_mesh(model: int = 1, device=None) -> HostMesh:
    """A (data, model) mesh over the initialised default process group,
    with a ``model``-way model axis (``repro``'s ``make_host_mesh``)."""
    return HostMesh(model, device=device)


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_method: str, timeout_s: Optional[float],
               args: Sequence) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=None if timeout_s is None
        else datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        # an engine left unreachable in a cycle still holds CUDA graphs
        # with NCCL kernels inside; free them before their communicator
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *,
          backend: str = "gloo", rendezvous: Optional[str] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes, each in an
    initialised process group of ``backend`` (rendezvous ``rendezvous``, a
    ``file://`` or ``tcp://`` address, else a free local TCP port). Raises
    the first rank's failure. With ``timeout_s`` it is also the process
    group's collective timeout, and ``TimeoutError`` is raised (after
    killing every rank) once it has passed; without, the ranks run until
    they end and a hung collective ends at the process group's default
    timeout. ``fn`` must be importable by name, as ``multiprocessing``'s
    spawn needs."""
    import torch.multiprocessing as mp

    init = rendezvous or f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, backend, init, timeout_s, tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0 if deadline is None else max(
                0.1, min(1.0, deadline - time.monotonic()))):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
