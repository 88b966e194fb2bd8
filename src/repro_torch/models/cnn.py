"""Compact conv classifiers for the ACE video-query application (paper §5).

EOC (edge object classifier, MobileNetV2 role) and COC (cloud object
classifier, ResNet152 role): residual conv stages, global average pooling,
softmax head. The port of ``repro.models.cnn``: parameters are the same
nested dicts, with the same names and layouts (conv kernels HWIO, scales
and biases f32), so ``repro_torch.bridge`` carries them by name; inputs
stay NHWC.

The convolutions are cuDNN's (``F.conv2d``), as ``repro``'s are XLA's:
no Pallas kernel stands behind them. Each call runs them in true f32,
with TF32 off for its duration (``f32_exact``), and pads a stride-2 conv
as ``padding="SAME"`` does: the odd pixel goes after, not before.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.ace_video_query import ClassifierConfig

Params = dict


@contextlib.contextmanager
def f32_exact():
    """cuDNN convolutions and cuBLAS matmuls without TF32 inside the block
    (both flags restored after), so an f32 classifier computes in f32 on
    the card as on the CPU.

    The flags are process-wide, not per thread: while the block runs, an
    f32 matmul on another thread (an engine step on a gateway's executor,
    say) loses TF32 too, and two blocks that overlap on two threads may
    restore the flags in the wrong order. Run the classifiers from one
    thread, with no other CUDA work in flight on another."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """``padding="SAME"``'s split: ceil(size / stride) outputs, the odd
    pad pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(w, x, stride: int = 1):
    """x (B, C, H, W) (NHWC memory is fine), w HWIO -> (B, O, H', W')."""
    k = w.shape[0]
    (top, bottom), (left, right) = (_same_pads(x.shape[2], k, stride),
                                    _same_pads(x.shape[3], k, stride))
    if top == bottom and left == right:
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                        padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x, scale, bias, groups: int = 8, eps: float = 1e-5):
    """GroupNorm over contiguous channel groups, population variance in
    f32, scaled by (1 + scale) (batch-size independent — edge batches are
    tiny)."""
    g = min(groups, x.shape[1])
    out = F.group_norm(x.float(), g, 1.0 + scale, bias, eps)
    return out.to(x.dtype)


class Classifier:
    """A conv classifier on one device (default "cuda"). Its calls set
    process-wide TF32 flags (``f32_exact``): make them from one thread."""

    def __init__(self, cfg: ClassifierConfig, dtype=torch.float32,
                 device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)

    # -- parameters -----------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree as (shape, dtype, fan_in) leaves, fan_in 0
        for the zero-initialised scales and biases — ``repro``'s names,
        shapes and nesting (``stages`` a list of dicts whose ``blocks`` is
        a list)."""
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32

        def conv(cin, cout, k=3):
            return ((k, k, cin, cout), dt, cin * k * k)

        def vec(n):
            return ((n,), f32, 0)

        w0 = cfg.widths[0]
        spec = {"stem": conv(3, w0), "stem_scale": vec(w0),
                "stem_bias": vec(w0)}
        stages, cin = [], w0
        for w in cfg.widths:
            stages.append({
                "down": conv(cin, w), "down_scale": vec(w),
                "down_bias": vec(w),
                "blocks": [{"c1": conv(w, w), "s1": vec(w), "b1": vec(w),
                            "c2": conv(w, w), "s2": vec(w), "b2": vec(w)}
                           for _ in range(cfg.num_blocks_per_stage)]})
            cin = w
        spec["stages"] = stages
        spec["head"] = ((cin, cfg.num_classes), dt, cin)
        spec["head_bias"] = vec(cfg.num_classes)
        return spec

    def init(self, seed: int) -> Params:
        """LeCun-normal kernels (std fan_in ** -0.5, drawn in f32 and cast)
        and zero scales and biases, from a CPU ``torch.Generator`` seeded
        with ``seed``, moved to the model's device."""
        gen = torch.Generator().manual_seed(seed)

        def make(leaf):
            if isinstance(leaf, dict):
                return {k: make(v) for k, v in leaf.items()}
            if isinstance(leaf, list):
                return [make(v) for v in leaf]
            shape, dtype, fan_in = leaf
            if fan_in == 0:
                x = torch.zeros(shape, dtype=torch.float32)
            else:
                x = torch.randn(shape, generator=gen,
                                dtype=torch.float32).mul_(fan_in ** -0.5)
            return x.to(dtype).to(self.device)

        return make(self.param_spec())

    # -- forward --------------------------------------------------------------
    def apply(self, params, images):
        """images: (B, H, W, 3) in [0, 1] -> logits (B, num_classes)."""
        with f32_exact():
            # NHWC memory seen as NCHW: channels-last, which cuDNN takes
            x = images.to(self.dtype).permute(0, 3, 1, 2)
            x = _conv(params["stem"], x)
            x = F.relu(_gn(x, params["stem_scale"], params["stem_bias"]))
            for stage in params["stages"]:
                x = _conv(stage["down"], x, stride=2)
                x = F.relu(_gn(x, stage["down_scale"], stage["down_bias"]))
                for blk in stage["blocks"]:
                    h = F.relu(_gn(_conv(blk["c1"], x), blk["s1"],
                                   blk["b1"]))
                    h = _gn(_conv(blk["c2"], h), blk["s2"], blk["b2"])
                    x = F.relu(x + h)
            x = torch.mean(x, dim=(2, 3))
            return x @ params["head"] + params["head_bias"]

    def predict(self, params, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (confidence of argmax, argmax class)."""
        probs = torch.softmax(self.apply(params, images), dim=-1)
        return torch.max(probs, dim=-1).values, torch.argmax(probs, dim=-1)

    def loss(self, params, images, labels):
        logits = self.apply(params, images)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return torch.mean(nll), {"acc": acc}
