"""Meshes over ``torch.distributed``: one process per rank.

``repro`` builds a ``jax.sharding.Mesh`` of ("data", "model") over the
devices one controller sees, laid out as (n // model, model). The port
runs SPMD instead: each rank is a process holding its shards, and
``HostMesh`` is its view of the mesh over an initialised process group,
shape ``{"data": D, "model": M}``: rank r sits at data index ``r // M``
and model index ``r % M``, as ``repro``'s device grid numbers them, so a
dimension split over ("data", "model") gives rank r chunk r. NCCL on the
card (each rank on its own card, or gloo with several ranks on one card,
which is the only way one card sees real splits); gloo on the CPU; and
``torch.distributed``'s ``fake`` backend for the production-mesh dry run
(``launch.dryrun``: one rank of 256 or 512 traced under fake tensors,
``make_production_mesh``), where every collective returns at once.

Each collective names the axis it runs over: ``"model"`` (the default:
the ranks of this rank's data row, as every call of the tensor-parallel
layers means), ``"data"`` (the ranks of this rank's model column) or
``"world"`` (every rank). Every rank builds the same subgroups in the same
order (each data row's model group, then each model column's data group),
as ``dist.new_group`` requires; an axis of the whole mesh is the group
itself, so a data-1 mesh issues exactly the calls on exactly the group it
always did.

Float payloads reduce in float32 and are cast back, so a sum of bf16
partials rounds once. A gather is NCCL's ``all_gather_into_tensor``; on
gloo, which takes only ``all_reduce`` and ``broadcast`` on CUDA tensors,
it is an ``all_reduce`` of a zero-filled full tensor holding each rank's
slice (exact: a sum with zeros). The fake backend issues NCCL's forms, as
the production mesh it stands for runs NCCL, so the calls and bytes it
counts are the cards'. ``COLLECTIVES`` counts the calls by kind
and axis ("all_reduce/data", ...), as ``kernels.LAUNCHES`` counts kernel
launches, so a CUDA graph can say that it captured them; ``tally`` sums
such counts by kind or by axis. ``COLLECTIVE_BYTES`` keeps, under the same
keys, the bytes of each call's result on this rank (the float32 payload of
a reduction, the joined tensor of a gather), as ``repro``'s roofline counts
an HLO collective's result once; a host message (``broadcast_object``)
moves no device bytes and adds none.

The H100 figures below (the SXM data sheet) are what
``repro_torch.analysis.roofline`` divides by, and ``HBM_PER_CARD`` what
the dry run's ``fits`` compares a rank's bytes against.

``spawn`` starts N ranks as processes (``torch.multiprocessing``, each
with its own rendezvous), and ``free_port`` finds a port for a TCP
rendezvous on this host.
"""
from __future__ import annotations

import datetime
import gc
import os
import socket
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

# every call, by kind and the axis it ran over: "all_reduce/data" and so
# on (a broadcast's axis is "world"); and the bytes of their results
COLLECTIVES: Dict[str, int] = {}
COLLECTIVE_BYTES: Dict[str, int] = {}
KINDS = ("all_reduce", "all_gather", "broadcast", "reduce_scatter")
AXES = ("model", "data", "world")

# the group of an axis of size 1 inside a larger mesh (no collective)
_TRIVIAL = object()


# NVIDIA H100 SXM (data sheet): dense bf16 tensor-core rate, HBM3 rate,
# and NVLink 4 each way (900 GB/s both ways)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per card
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card, one direction
HBM_PER_CARD = 80 * 2 ** 30   # bytes of HBM3 per card

# the production meshes (``repro.launch.mesh.make_production_mesh``):
# (data, model) of one pod and of two; ``repro``'s 'pod' axis always splits
# together with 'data' in its rules, so it folds into the data axis here
PRODUCTION_MESHES = {"pod16x16": (16, 16), "pod2x16x16": (32, 16)}


def _count(kind: str, axis: str, nbytes: int = 0) -> None:
    key = f"{kind}/{axis}"
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1
    COLLECTIVE_BYTES[key] = COLLECTIVE_BYTES.get(key, 0) + nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tally(counts: Dict[str, int], by: str = "kind",
          before: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """``counts`` ("kind/axis" keys: ``COLLECTIVES`` or a captured
    program's record) less ``before`` (an earlier copy), summed by
    ``by``: "kind" ({"all_reduce": n, ...} over ``KINDS``) or "axis"
    ({"model": n, "data": n, "world": n})."""
    part = 0 if by == "kind" else 1
    out = dict.fromkeys(KINDS if by == "kind" else AXES, 0)
    for key, n in counts.items():
        out[key.split("/")[part]] += n - (before or {}).get(key, 0)
    return out


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
    ``group`` (the default group if None), with a ``model``-way model axis
    (default: every rank) and a data axis of the ranks over it. ``rank`` is
    this rank's place in the mesh (``data_rank * M + model_rank``);
    ``device`` is where its shards live (default: ``cuda:<rank>`` under
    NCCL, the CPU under gloo; the fake backend takes it explicitly). Host
    messages (``broadcast_object``) travel on a gloo group of every rank,
    so they never queue behind the card's work nor pair up with a model
    collective that a rank has still to issue; the fake backend has no
    such group (it cannot make a gloo one), and a dry run sends no host
    message. ``tag`` names the mesh in a dry run's record."""

    def __init__(self, model: Optional[int] = None, device=None, group=None,
                 tag: Optional[str] = None):
        if not dist.is_initialized():
            raise RuntimeError("HostMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        world = dist.get_world_size(group)
        model = world if model is None else model
        if model < 1 or world % model:
            raise ValueError(f"a {model}-way model axis does not divide "
                             f"{world} ranks")
        super().__init__(model=model, data=world // model)
        self.group = group
        self.rank = dist.get_rank(group)
        self.model_rank = self.rank % model
        self.data_rank = self.rank // model
        self.backend = dist.get_backend(group)
        self.tag = tag
        if device is None:
            if self.backend == "fake":
                raise ValueError("a mesh over the fake backend needs its "
                                 "device (cuda: the kernels' fake rules, "
                                 "cpu: their plain versions)")
            device = (f"cuda:{self.rank}" if self.backend == "nccl"
                      else "cpu")
        self.device = torch.device(device)
        ranks = (list(range(world)) if group is None
                 else dist.get_process_group_ranks(group))
        data = world // model
        # every rank makes every subgroup, in one order: each data row's
        # model group, then each model column's data group. An axis that
        # spans the mesh is the group itself; one of size 1 inside a larger
        # mesh has no group, and its collectives are the identity
        self._groups = {"world": group}
        rows = [ranks[d * model:(d + 1) * model] for d in range(data)]
        cols = [ranks[m::model] for m in range(model)]
        for axis, size, members, mine in (
                ("model", model, rows, self.data_rank),
                ("data", data, cols, self.model_rank)):
            if size == world:
                self._groups[axis] = group
            elif size == 1:
                self._groups[axis] = _TRIVIAL
            else:
                made = [dist.new_group(ranks=r) for r in members]
                self._groups[axis] = made[mine]
        self._host = None if self.backend == "fake" else dist.new_group(
            ranks=None if group is None else ranks, backend="gloo")
        if data > 1 and self.backend == "nccl":
            # NCCL makes a subgroup's communicator at its first collective,
            # which a CUDA graph's capture cannot be: make them now
            for axis in ("model", "data"):
                if self._groups[axis] not in (group, _TRIVIAL):
                    dist.all_reduce(torch.zeros(1, device=self.device),
                                    group=self._groups[axis])

    @property
    def _nccl_forms(self) -> bool:
        """Whether a gather and a reduce-scatter take NCCL's forms (NCCL,
        and the fake backend that stands for it) or gloo's."""
        return self.backend in ("nccl", "fake")

    def _host_group(self):
        if self._host is None:
            raise RuntimeError("a mesh over the fake backend (the "
                               "production-mesh dry run, launch.dryrun) "
                               "sends no host message")
        return self._host

    def axis_size(self, axis: str) -> int:
        """Ranks along ``axis`` ("model", "data" or "world")."""
        return self.size if axis == "world" else self.shape[axis]

    def axis_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return {"model": self.model_rank, "data": self.data_rank,
                "world": self.rank}[axis]

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may capture this mesh's collectives (NCCL;
        gloo's run on the host)."""
        return self.backend == "nccl"

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """The sum (or with ``op="max"`` the maximum) of ``x`` over the
        ranks of ``axis``, reduced in float32 (integers as they are) and
        returned in ``x``'s dtype (a float32 ``x`` is reduced in place)."""
        if self._groups[axis] is _TRIVIAL:
            return x
        y = x.float() if x.is_floating_point() else x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self._groups[axis])
        _count("all_reduce", axis, _nbytes(y))
        return y.to(x.dtype)

    def gather(self, x: torch.Tensor, dim: int,
               axis: str = "model") -> torch.Tensor:
        """The ranks' equal slices ``x`` joined along ``dim`` in their order
        on ``axis``: an all-gather on NCCL, on gloo the all-reduce of a
        zero-filled full tensor."""
        dim = dim % x.dim()
        n = self.axis_size(axis)
        group = self._groups[axis]
        if group is _TRIVIAL:
            return x
        if self._nccl_forms:
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
            _count("all_gather", axis, _nbytes(out))
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
        full.narrow(dim, self.axis_rank(axis) * w, w).copy_(x)
        dist.all_reduce(full, group=group)
        _count("all_reduce", axis, _nbytes(full))
        return full.to(x.dtype)

    def shard(self, x: torch.Tensor, dim: int,
              axis: str = "model") -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim`` on ``axis`` (a view)."""
        n = x.shape[dim] // self.axis_size(axis)
        return x.narrow(dim, self.axis_rank(axis) * n, n)

    def reduce_scatter(self, x: torch.Tensor,
                       axis: str = "data") -> torch.Tensor:
        """Row ``i`` of the sum over the ranks of ``axis`` of ``x`` (n, ...),
        n the axis' size, for this rank's index ``i`` on it; reduced in
        float32 and returned in ``x``'s dtype. NCCL's reduce-scatter; on
        gloo, which has none, an all-reduce of which each rank keeps its
        row."""
        group = self._groups[axis]
        if group is _TRIVIAL:
            return x[0]
        y = x.float() if x.is_floating_point() else x.clone()
        if self._nccl_forms:
            out = torch.empty(y.shape[1:], dtype=y.dtype, device=y.device)
            dist.reduce_scatter_tensor(out, y.contiguous(), group=group)
            _count("reduce_scatter", axis, _nbytes(out))
        else:
            dist.all_reduce(y, group=group)
            _count("all_reduce", axis, _nbytes(y))
            out = y[self.axis_rank(axis)]
        return out.to(x.dtype)

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here (on the host group)."""
        dist.barrier(group=self._host_group())

    def broadcast_object(self, obj=None, src: int = 0):
        """``obj`` from rank ``src`` to every rank of the mesh (pickled, on
        the host group); the other ranks pass None and get it back."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._host_group())
        _count("broadcast", "world")
        return box[0]


# -- the collectives under autograd ---------------------------------------------
#
# Megatron's conjugate pairs over a mesh's calls, for training on a model
# axis above 1. An activation is either replicated (equal on every rank of
# the axis, and so is its gradient: every rank differentiates the same
# loss) or split (each rank holds its part, or a partial sum). ``reduce``
# ends a region of partial sums (all-reduce; the replicated gradient goes
# to every partial as it is), ``copy`` enters a split region (identity;
# the ranks' partial gradients of the replicated input are summed),
# ``gather`` joins the ranks' slices into a replicated tensor (its
# backward keeps this rank's slice of the gradient) and ``scatter`` cuts
# a replicated tensor into this rank's slice (its backward joins the
# slices' gradients). Each forward is the mesh's own call, so its values
# and its count in ``COLLECTIVES`` are those of the call; without a
# gradient to carry (no grad mode, or an input that needs none) the call
# is made directly and ``copy`` returns its input.


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied when it is float32 (``all_reduce`` reduces a float32
    tensor in place, which must not touch a tensor autograd holds)."""
    return x.clone() if x.dtype == torch.float32 else x


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(_fresh(x), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(_fresh(g), ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shard(g, ctx.dim, ctx.axis), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.shard(x, dim, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g.contiguous(), ctx.dim, ctx.axis), None, \
            None, None


def _carries(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``mesh.all_reduce(x, axis)``; its backward passes the gradient on
    to this rank's partial unchanged."""
    if not _carries(x):
        return mesh.all_reduce(x, axis)
    return _Reduce.apply(x, mesh, axis)


def copy(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` itself, entering a region split over ``axis``; its backward
    all-reduces the ranks' partial gradients of ``x`` (f32)."""
    if not _carries(x):
        return x
    return _Copy.apply(x, mesh, axis)


def gather(mesh, x: torch.Tensor, dim: int,
           axis: str = "model") -> torch.Tensor:
    """``mesh.gather(x, dim, axis)``; its backward keeps this rank's slice
    of the (replicated) gradient."""
    if not _carries(x):
        return mesh.gather(x, dim, axis)
    return _Gather.apply(x, mesh, dim, axis)


def scatter(mesh, x: torch.Tensor, dim: int,
            axis: str = "model") -> torch.Tensor:
    """``mesh.shard(x, dim, axis)`` of a replicated ``x``; its backward
    gathers the ranks' slices of the gradient into the whole one."""
    if not _carries(x):
        return mesh.shard(x, dim, axis)
    return _Scatter.apply(x, mesh, dim, axis)


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
    with a ``model``-way model axis and the other ranks' factor on
    ``data`` (``repro``'s ``make_host_mesh``: (n // model, model))."""
    return HostMesh(model, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> HostMesh:
    """This rank's view of the production mesh over the initialised default
    process group (``repro.launch.mesh.make_production_mesh``): (data 16,
    model 16) over 256 ranks, or with ``multi_pod`` (data 32, model 16)
    over 512, ``repro``'s (pod 2, data 16, model 16) with 'pod' folded into
    'data'. Tagged ``pod16x16`` / ``pod2x16x16``. Under NCCL the default
    device is this host's card ``LOCAL_RANK`` (as a launcher sets it);
    the fake backend takes ``device`` explicitly. Any other world
    raises."""
    tag = "pod2x16x16" if multi_pod else "pod16x16"
    data, model = PRODUCTION_MESHES[tag]
    world = dist.get_world_size()
    if world != data * model:
        sizes = " and ".join(f"{d * m} ranks ({t})"
                             for t, (d, m) in PRODUCTION_MESHES.items())
        raise ValueError(f"the production meshes take {sizes}; this "
                         f"process group has {world} (--multi-pod asks for "
                         f"{data * model})")
    if device is None and dist.get_backend() == "nccl":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return HostMesh(model, device=device, tag=tag)


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
