"""Fake tensors and a fake process group: what the production-mesh dry run
(``launch.dryrun``) traces one rank under.

``fake_world(n)`` initialises ``torch.distributed``'s ``fake`` backend as
rank 0 of ``n`` (every collective returns at once and moves nothing) and
destroys it on exit, so the default group never outlives the trace.
``fake_mode(device)`` is a ``torch._subclasses.FakeTensorMode``: every
tensor made inside has a shape, a dtype, strides and a device but no
storage, so a step of a 671 B-parameter model traces on a laptop.

On ``cuda`` the model runs as on the card, and each hand-written kernel's
wrapper meets a fake CUDA tensor and runs its shape rule
(``kernels.traced``). A build of PyTorch without CUDA (the CPU wheel) can
hold fake CUDA tensors, but a few ``Tensor`` methods written in C++ ask
the CUDA runtime for a device guard before they dispatch, and it has
none: indexing (``x[i]``, ``x[i] = v``), ``~x``, ``contiguous``,
``copy_`` and ``to(device)`` (the model's; ``new_tensor`` and ``nonzero``
too, which it never calls). There ``fake_mode`` routes those methods to the dispatcher's own ops (``select``, ``slice``,
``unsqueeze``, ``index``, ``index_put_``, ``bitwise_not``, ``clone``,
``copy_``, ``_to_copy``), which compute the same views and results with
no guard.
Autograd on a fake CUDA tensor aborts such a build outright (a C++
``terminate``), so a training step traces there only on ``cpu``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode

_A = torch.ops.aten


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group as rank 0 of ``world`` on the fake
    backend, for the block's duration (one already made for ``world`` is
    used as it is and left in place)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is already initialised; the "
                f"dry run needs a fake one of {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _index(x, idx):
    """``x[idx]``'s basic part (ints, slices, None, ...) as views, and the
    index tensors of its advanced part placed on the view's dims (None
    where a dim is not indexed), as ``aten.index`` takes them."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = tuple(torch.tensor(i, device=x.device) if isinstance(i, list)
                else i for i in idx)
    if any(isinstance(i, bool) for i in idx):
        raise NotImplementedError("a bool index on a fake CUDA tensor")
    used = sum(i.dim() if isinstance(i, torch.Tensor)
               and i.dtype == torch.bool else 1
               for i in idx if i is not None and i is not Ellipsis)
    for pos, i in enumerate(idx):
        if i is Ellipsis:
            idx = (idx[:pos] + (slice(None),) * (x.dim() - used)
                   + idx[pos + 1:])
            break
    out, dim, tensors = x, 0, {}
    for i in idx:
        if i is None:
            out = _A.unsqueeze.default(out, dim)
            dim += 1
        elif isinstance(i, slice):
            if (i.start, i.stop, i.step) not in ((None, None, None),
                                                 (0, None, None),
                                                 (None, None, 1)):
                out = _A.slice.Tensor(out, dim, i.start, i.stop,
                                      1 if i.step is None else i.step)
            dim += 1
        elif isinstance(i, torch.Tensor):
            tensors[dim] = i
            dim += i.dim() if i.dtype == torch.bool else 1
        else:
            out = _A.select.int(out, dim, int(i))
    if not tensors:
        return out, None
    indices, dim = [], 0
    while dim <= max(tensors):
        t = tensors.get(dim)
        indices.append(t)
        dim += t.dim() if t is not None and t.dtype == torch.bool else 1
    return out, indices


def _getitem(x, idx):
    out, indices = _index(x, idx)
    return out if indices is None else _A.index.Tensor(out, indices)


def _setitem(x, idx, value):
    view, indices = _index(x, idx)
    if indices is not None:
        if not isinstance(value, torch.Tensor):
            value = torch.full((), value, dtype=x.dtype, device=x.device)
        _A.index_put_.default(view, indices, value.to(x.dtype))
    elif isinstance(value, torch.Tensor):
        _A.copy_.default(view, value)
    else:
        _A.fill_.Scalar(view, value)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return _A.clone.default(x, memory_format=memory_format)


def _copy(dst, src, non_blocking=False):
    return _A.copy_.default(dst, src, non_blocking)


def _to(x, *args, **kwargs):
    copy = kwargs.pop("copy", False)
    device, dtype, _, memory_format = torch._C._nn._parse_to(*args,
                                                            **kwargs)
    device = x.device if device is None else torch.device(device)
    dtype = x.dtype if dtype is None else dtype
    if device == x.device and dtype == x.dtype and not copy:
        return x
    return _A._to_copy.default(x, dtype=dtype, device=device,
                               memory_format=memory_format)


_ROUTES = {torch.Tensor.__getitem__: _getitem,
           torch.Tensor.__invert__: _A.bitwise_not.default,
           torch.Tensor.__setitem__: _setitem,
           torch.Tensor.contiguous: _contiguous,
           torch.Tensor.copy_: _copy,
           torch.Tensor.to: _to}


class _GuardlessMethods(TorchFunctionMode):
    """Routes the methods that need CUDA's device guard (module docstring)
    to guard-free ops when their tensor is a fake CUDA one."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        route = _ROUTES.get(func)
        if route is not None and args and isinstance(args[0], FakeTensor) \
                and args[0].device.type == "cuda":
            return route(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_mode(device="cuda"):
    """A ``FakeTensorMode`` for a trace on ``device`` (yielded), with the
    guard-free methods where ``device`` is CUDA and this build has none."""
    with contextlib.ExitStack() as stack:
        mode = stack.enter_context(FakeTensorMode())
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            stack.enter_context(_GuardlessMethods())
        yield mode


def refuse_autograd(device) -> None:
    """Raise where autograd on fake ``device`` tensors would abort this
    process: fake CUDA in a build without CUDA (module docstring)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "autograd on fake CUDA tensors aborts a PyTorch built without "
            "CUDA; trace a training step with --device cpu here, or on a "
            "machine with a card")
