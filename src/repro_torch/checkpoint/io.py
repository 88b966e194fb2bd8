"""Tree checkpointing to .npz: ``repro.checkpoint.io``'s wire format in
numpy (``repro`` flattens its trees with JAX; the port with
``repro_torch.utils.tree.flat_paths``, which spells and orders the keys
the same way).

A checkpoint is ``step_N.npz`` in its directory, one array per flat key
path (``a/0/b``), written to a temporary file and renamed into place, so
a crash mid-write never leaves a torn envelope; ``keep`` bounds how many
the directory holds. Two load shapes, as in ``repro``:
``load_checkpoint(dir, template)`` restores into a known structure (exact
key-path match, dtypes coerced to the template's), the training path;
``load_checkpoint_tree`` rebuilds nested string-keyed dicts from the
paths, no template: a serving snapshot's structure (which requests were
live, which carried K/V) is data. Host metadata rides as a JSON-encoded
``uint8`` leaf (``json_leaf``/``json_unleaf``). Leaves are numpy arrays,
scalars or tensors (on any device); a bfloat16 leaf is stored as its
2-byte words (``|V2``), as numpy stores ``repro``'s.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import flat_paths, tree_map_with_path

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _host(v) for k, v in flat_paths(tree).items()}
    path = os.path.join(directory, f"step_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    _gc(directory, keep)
    return path


def _host(v) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor as its 2-byte words."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy().copy()


def _coerce(a: np.ndarray, like):
    """A stored array in the dtype (and, for a tensor, on the device) of
    the template leaf ``like``; 2-byte words (``|V2``) into bf16 by their
    bits."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(a, dtype=np.asarray(like).dtype)
    a = np.array(a, order="C")          # a writable copy, 0-d kept
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind != "f":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    return t.to(like.device)


def _path(directory: str, step: Optional[int]) -> Tuple[str, int]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step}.npz"), step


def load_checkpoint(directory: str, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (the same key paths;
    each leaf in its template leaf's dtype, and device for a tensor).
    Returns ``(tree, step)``; the newest step unless ``step`` is given."""
    path, step = _path(directory, step)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    paths = flat_paths(template)
    missing = set(paths) - set(flat)
    extra = set(flat) - set(paths)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    for key, like in paths.items():
        if tuple(flat[key].shape) != tuple(np.shape(like)):
            raise ValueError(f"checkpoint mismatch at {key}: shape "
                             f"{tuple(flat[key].shape)} != "
                             f"{tuple(np.shape(like))}")
    return tree_map_with_path(lambda k, like: _coerce(flat[k], like),
                              template), step


def load_checkpoint_tree(directory: str,
                         step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore a checkpoint as nested dicts: each flat key path ``a/b/c``
    becomes ``tree["a"]["b"]["c"]``. Returns ``(tree, step)``; the newest
    step unless ``step`` is given."""
    path, step = _path(directory, step)
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree, step


def json_leaf(obj: Any) -> np.ndarray:
    """Encode a JSON-able object as a ``uint8`` array leaf."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def json_unleaf(arr: np.ndarray) -> Any:
    return json.loads(np.asarray(arr, np.uint8).tobytes().decode("utf-8"))


def _steps(directory: str):
    return [int(m.group(1)) for m in map(_STEP_RE.search,
                                         os.listdir(directory)) if m]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _gc(directory: str, keep: int) -> None:
    for s in sorted(_steps(directory))[:-keep]:
        os.remove(os.path.join(directory, f"step_{s}.npz"))
