"""Carry ``repro`` parameters into the port.

``params_from_numpy`` takes the tree ``repro``'s ``LM.init`` returns, with
its leaves converted to numpy arrays (nested dicts and lists, per-stage
leaves stacked on a leading layer axis), and returns the port's tree with
the same names, shapes and stacking. It checks the tree against the port's
``LM.param_spec`` so a mismatch fails loudly. bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) go through float32, which is exact.
With ``mesh=`` (a ``launch.mesh.HostMesh``) it returns this rank's
shards (``serving.sharding.place_params``), so every rank carries the
same weights. ``classifier_params_from_numpy`` does the same for
``repro``'s ``Classifier.init(...)[0]`` against the port's
``Classifier``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.cnn import Classifier
from repro_torch.models.model import LM


def _to_tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    # a writable copy; bf16 widens to f32, which is exact
    a = np.array(a, dtype=np.float32 if a.dtype.name == "bfloat16"
                 else a.dtype)
    return torch.from_numpy(a).to(dtype).to(device)


def _convert(tree, spec, device):
    """``tree`` (nested dicts/lists of arrays) checked against ``spec``
    ((shape, dtype, init) leaves) and converted leaf by leaf."""

    def conv(node, sp, path):
        if isinstance(sp, dict):
            if not isinstance(node, dict) or set(node) != set(sp):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(sp)}, got {got}")
            return {k: conv(node[k], sp[k], f"{path}/{k}") for k in sp}
        if isinstance(sp, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(sp):
                raise ValueError(f"{path}: expected a list of {len(sp)}")
            return [conv(n, s, f"{path}[{i}]")
                    for i, (n, s) in enumerate(zip(node, sp))]
        shape, dtype, _ = sp
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(node))} != "
                             f"{tuple(shape)}")
        return _to_tensor(node, dtype, device)

    return conv(tree, spec, "")


def params_from_numpy(tree, cfg, device="cuda", mesh=None):
    """``repro`` params as numpy (nested dicts/lists) -> the port's params
    for ``cfg`` on ``device`` (on a mesh, this rank's shards)."""
    device = resolve_device(device)
    lm = LM(cfg, device="cpu")
    if mesh is None:
        return _convert(tree, lm.param_spec(), device)
    from repro_torch.serving.sharding import place_params
    local = place_params(mesh, lm, _convert(tree, lm.param_spec(), "cpu"))
    return _to_device(local, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def classifier_params_from_numpy(tree, cfg, device="cuda"):
    """``repro``'s ``Classifier`` params as numpy (``stages`` a list of
    dicts holding ``blocks`` lists) -> the port's ``Classifier`` params for
    the ``ClassifierConfig`` ``cfg`` on ``device``."""
    device = resolve_device(device)
    spec = Classifier(cfg, device="cpu").param_spec()
    return _convert(tree, spec, device)
