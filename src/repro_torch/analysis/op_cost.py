"""Counted cost of one traced step: the port's ``repro.analysis.hlo_cost``.

``repro`` reads a compiled program's HLO and weights each computation by
its loop trip count. The port has no HLO: ``OpCost`` is a
``TorchDispatchMode`` that sees every aten op a step dispatches (under
fake tensors in the dry run, ``launch.dryrun``) and logs each distinct
(op, argument shapes and dtypes) once with its count. The port's layers
run as a Python loop, so each layer's ops are dispatched, and counted,
once a layer: no trip-count weighting is needed. ``analyze`` turns a log
into ``hlo_cost.analyze``'s ``weighted`` keys, per device:

  * ``dot_flops``: ``torch.utils.flop_counter``'s formula of each
    matrix-product op, plus what the hand-written kernels' wrappers add
    (``kernels.FLOPS``, logged as ``kernel/<name>`` lines: a kernel is no
    aten op);
  * ``transcendental``: the elements of exp, log, tanh, sigmoid, rsqrt,
    erf, the softmaxes and the like;
  * ``result_bytes``: the bytes of every result that is not a view of an
    input (a view moves nothing), ``hbm_bytes`` twice that (written once,
    read once, ``hlo_cost``'s proxy);
  * ``coll_bytes`` and ``coll_counts`` under ``repro``'s kind names, from
    the mesh's own counts (``launch.mesh.COLLECTIVES`` and
    ``COLLECTIVE_BYTES``, logged as ``collective/<kind>/<axis>`` lines),
    and ``collective_bytes_total``.

The log (``save_log`` / ``load_log``: gzip, one JSON line an entry) holds
the ops' shapes, not their costs, so ``analysis.reanalyze`` re-derives
``weighted`` from it with no second trace.
"""
from __future__ import annotations

import functools
import gzip
import json
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import FLOPS, TRACED
from repro_torch.launch.mesh import COLLECTIVE_BYTES, COLLECTIVES

# ``repro``'s collective kinds (``hlo_cost._COLLECTIVES``) and the port's
# names for those it issues
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}

# ops whose elements each take a transcendental function; the reductions
# among them count their input's elements
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "tanh", "sigmoid", "rsqrt", "erf", "erfc", "erfinv",
                   "pow", "sin", "cos", "silu", "gelu", "softplus",
                   "_softmax", "_log_softmax", "logsumexp",
                   "_softmax_backward_data", "_log_softmax_backward_data",
                   "sigmoid_backward", "tanh_backward", "silu_backward",
                   "gelu_backward"}
_OVER_INPUT = {"_softmax", "_log_softmax", "logsumexp"}

# collectives are counted by the mesh, not by their c10d ops
_SKIPPED_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _sig(x):
    """A JSON form of one argument: a tensor's shape and dtype, anything
    else as a plain value or its ``str``."""
    if isinstance(x, torch.Tensor):
        return {"s": list(x.shape), "d": str(x.dtype).replace("torch.", "")}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_sig(v) for v in x]
    if isinstance(x, dict):
        return {k: _sig(v) for k, v in x.items()}
    return str(x)


def _key(x):
    """A hashable stand-in for ``_sig(x)`` (cheaper: an entry's JSON form is
    made only when it is first seen)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x if x is None or isinstance(x, (bool, int, float, str)) \
        else str(x)


def _outputs(out) -> List[list]:
    leaves, _ = tree_flatten(out)
    return [[list(t.shape), str(t.dtype).replace("torch.", "")]
            for t in leaves if isinstance(t, torch.Tensor)]


def _writes_new(func) -> bool:
    """Whether ``func``'s results are new tensors or writes (not views of
    an input, which move nothing)."""
    for r in func._schema.returns:
        info = r.alias_info
        if info is not None and not info.is_write:
            return False
    return True


class OpCost(TorchDispatchMode):
    """Logs every aten op dispatched inside the block (``log``: entries by
    key, each with its count ``n``), and on exit the kernels' traced calls
    and FLOPs and the mesh's collectives made inside it."""

    def __init__(self):
        super().__init__()
        self.entries: Dict[object, dict] = {}
        self.ops = 0

    def __enter__(self):
        self._before = (dict(FLOPS), dict(TRACED), dict(COLLECTIVES),
                        dict(COLLECTIVE_BYTES))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        flops, traced, calls, nbytes = self._before
        for name, n in TRACED.items():
            if n - traced.get(name, 0):
                self.entries[f"kernel/{name}"] = {
                    "op": f"kernel/{name}", "n": n - traced.get(name, 0),
                    "flops": FLOPS.get(name, 0) - flops.get(name, 0)}
        for key, n in COLLECTIVES.items():
            if n - calls.get(key, 0):
                self.entries[f"collective/{key}"] = {
                    "op": f"collective/{key}", "n": n - calls.get(key, 0),
                    "bytes": COLLECTIVE_BYTES.get(key, 0)
                    - nbytes.get(key, 0)}
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _SKIPPED_NAMESPACES:
            return out
        self.ops += 1
        key = (func, _key(args), _key(kwargs))
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = {
                "op": str(func), "args": _sig(list(args)),
                "kwargs": _sig(kwargs), "out": _outputs(out),
                "new": _writes_new(func), "n": 0}
        entry["n"] += 1
        return out

    @property
    def log(self) -> List[dict]:
        return list(self.entries.values())


def _meta(x):
    """An argument rebuilt from its JSON form, tensors as meta tensors (no
    storage) of their shape and dtype."""
    if isinstance(x, dict) and set(x) == {"s", "d"}:
        return torch.empty(x["s"], dtype=getattr(torch, x["d"]),
                           device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_meta(v) for v in x]
    return x


def _op(name: str):
    """The ``torch.ops`` overload named ``aten.mm.default`` and so on."""
    ns, packet, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, ns), packet), overload)


def _dot_flops(entry: dict) -> float:
    from torch.utils.flop_counter import flop_registry
    op = _op(entry["op"])
    fn = flop_registry.get(op.overloadpacket)
    if fn is None:
        return 0.0
    out = [torch.empty(s, dtype=getattr(torch, d), device="meta")
           for s, d in entry["out"]]
    return float(fn(*_meta(entry["args"]), **_meta(entry["kwargs"]),
                    out_val=out[0] if len(out) == 1 else tuple(out)))


def _elements(shapes) -> int:
    return sum(math.prod(s) for s, _ in shapes)


@functools.lru_cache(maxsize=None)
def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def analyze(log: List[dict]) -> dict:
    """``hlo_cost.analyze``'s per-device keys from an op log (module
    docstring)."""
    out = {"dot_flops": 0.0, "transcendental": 0.0, "result_bytes": 0.0,
           "coll_bytes": dict.fromkeys(COLLECTIVE_KINDS, 0.0),
           "coll_counts": dict.fromkeys(COLLECTIVE_KINDS, 0.0)}
    for e in log:
        n = e["n"]
        kind, _, rest = e["op"].partition("/")
        if kind == "kernel":
            out["dot_flops"] += e["flops"]
            continue
        if kind == "collective":
            name = _KIND.get(rest.split("/")[0])
            if name is not None:
                out["coll_bytes"][name] += e["bytes"]
                out["coll_counts"][name] += n
            continue
        out["dot_flops"] += n * _dot_flops(e)
        packet = e["op"].split(".")[1]
        if packet.rstrip("_") in _TRANSCENDENTAL:
            if packet in _OVER_INPUT:
                first = e["args"][0]
                out["transcendental"] += n * math.prod(first["s"])
            else:
                out["transcendental"] += n * _elements(e["out"])
        if e["new"]:
            out["result_bytes"] += n * sum(
                math.prod(s) * _dtype_bytes(d) for s, d in e["out"])
    out["collective_bytes_total"] = sum(out["coll_bytes"].values())
    out["hbm_bytes"] = 2.0 * out["result_bytes"]
    return out


def save_log(path: str, log: List[dict]) -> None:
    with gzip.open(path, "wt") as f:
        for e in log:
            f.write(json.dumps(e, separators=(",", ":")) + "\n")


def load_log(path: str) -> List[dict]:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def collectives(log: List[dict]) -> Dict[str, Dict[str, float]]:
    """``repro``'s record ``collectives``: per kind, its calls and bytes a
    device (every kind present, as ``dryrun.collective_bytes`` gives)."""
    w = analyze([e for e in log if e["op"].startswith("collective/")])
    return {k: {"count": w["coll_counts"][k], "bytes": w["coll_bytes"][k]}
            for k in COLLECTIVE_KINDS}


__all__ = ["COLLECTIVE_KINDS", "OpCost", "analyze", "collectives",
           "load_log", "save_log"]
