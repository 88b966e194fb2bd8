"""The RG-LRU recurrent block (RecurrentGemma / Griffin):
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), after a depthwise
causal conv, gated by a GELU branch.

Port of the RG-LRU half of ``repro.models.recurrent`` (mLSTM and sLSTM are
a later slice). ``repro`` solves the full-sequence recurrence with
``jax.lax.associative_scan``; the port runs it through
``kernels.rglru_scan`` (the CUDA kernel on the card, its plain sequential
version on the CPU). One-token decode is a single ``h = a * h + b`` step
in plain PyTorch.

Two departures from ``repro``, both about serving:
- ``rglru_block_forward`` takes ``lengths`` (B,): every step at
  t >= length becomes the identity step (a = 1, b = 0), the padding the
  Pallas scan uses for its own tail, so the returned state is the one
  after each row's last *real* token and the conv tail holds its last
  ``cw - 1`` real inputs. ``repro`` returns the padded sequence's final
  state, so a prompt right-padded to its bucket taints the recurrent state.
- ``rglru_block_decode`` takes ``valid`` (B, 1): rows that are not valid
  leave ``h`` and ``conv`` untouched, the decode contract of
  ``LM.decode_step`` (``repro``'s recurrent decode ignores it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan

_RGLRU_C = 8.0
LAMBDA_INIT = "rglru_lambda"    # the param spec's leaf kind for ``lam``


def init_lambda(shape, generator, device) -> torch.Tensor:
    """``lam`` = log(expm1(-log(u) / c)) for u ~ U(0.9^2, 0.999^2), in f32,
    so that exp(-c * softplus(lam)) = u and the gate's a = u^r."""
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=generator)
    return torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))


def param_spec(cfg, n: int, dt) -> dict:
    """One stage's stacked RG-LRU mixer leaves as (shape, dtype, init):
    init is a normal std (0 means zeros) or ``LAMBDA_INIT``."""
    d, w, cw = cfg.d_model, cfg.resolved_lru_width, cfg.rglru_conv_width
    f32 = torch.float32
    return {
        "w_in_x": ((n, d, w), dt, d ** -0.5),
        "w_in_gate": ((n, d, w), dt, d ** -0.5),
        "conv_w": ((n, cw, w), dt, cw ** -0.5),
        "conv_b": ((n, w), f32, 0.0),
        "w_rgate": ((n, w, w), dt, w ** -0.5),
        "b_rgate": ((n, w), f32, 0.0),
        "w_igate": ((n, w, w), dt, w ** -0.5),
        "b_igate": ((n, w), f32, 0.0),
        "lam": ((n, w), f32, LAMBDA_INIT),
        "w_out": ((n, w, d), dt, w ** -0.5),
    }


def softplus(x):
    """f32 softplus as ``jax.nn.softplus`` computes it, log(1 + exp(x)) =
    max(x, 0) + log1p(exp(-|x|)), with no threshold (torch's ``F.softplus``
    returns x itself above 20)."""
    x = x.float()
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """Depthwise causal conv with f32 accumulation. x: (B, S, W); w:
    (cw, W); b: (W,) f32."""
    cw, s = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted.float() * w[cw - 1 - i].float()
    return (out + b).to(x.dtype)


def _conv_step(x1, prev, w, b):
    """One-step causal conv. x1: (B, 1, W); prev: (B, cw-1, W) past inputs.
    Returns (out (B, 1, W), the new past inputs)."""
    buf = torch.cat([prev, x1], dim=1)                  # (B, cw, W)
    out = torch.einsum("bcw,cw->bw", buf.float(), w.float()) + b
    return out.to(x1.dtype)[:, None, :], buf[:, 1:]


def _rglru_gates(params, xc):
    """The recurrence's a_t and input b_t (both f32) from the conv output."""
    r = torch.sigmoid((xc @ params["w_rgate"]).float() + params["b_rgate"])
    i = torch.sigmoid((xc @ params["w_igate"]).float() + params["b_igate"])
    log_a = -_RGLRU_C * softplus(params["lam"]) * r      # (B, S, W) f32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gated_x = mult * i * xc.float()
    return a, gated_x


def _gate_branch(params, x):
    return F.gelu((x @ params["w_in_gate"]).float(), approximate="tanh")


def rglru_block_forward(params, cfg, x, lengths=None):
    """Full-sequence recurrent block from a zero state. x: (B, S, D);
    ``lengths`` (B,): true lengths of right-padded rows. Returns (out
    (B, S, D), state {"h": (B, W) f32, "conv": (B, cw-1, W)})."""
    b, s, _ = x.shape
    gate = _gate_branch(params, x)
    xin = x @ params["w_in_x"]
    xc = _causal_conv(xin, params["conv_w"], params["conv_b"])
    a, bx = _rglru_gates(params, xc)
    if lengths is None:
        length = torch.full((b,), s, dtype=torch.int64, device=x.device)
    else:
        length = lengths.to(device=x.device, dtype=torch.int64).reshape(b)
        real = (torch.arange(s, device=x.device)[None, :]
                < length[:, None])[..., None]
        a = torch.where(real, a, torch.ones_like(a))       # identity steps
        bx = torch.where(real, bx, torch.zeros_like(bx))
    h0 = torch.zeros((b, a.shape[2]), dtype=torch.float32, device=x.device)
    h, h_last = rglru_scan(a, bx, h0)
    y = (h * gate).to(x.dtype)
    out = y @ params["w_out"]
    # the last cw-1 real inputs, zero-filled on the left of short rows
    idx = (length[:, None] - (cfg.rglru_conv_width - 1)
           + torch.arange(cfg.rglru_conv_width - 1, device=x.device)[None])
    tail = xin[torch.arange(b, device=x.device)[:, None],
               idx.clamp_min(0)]
    tail = torch.where((idx >= 0)[..., None], tail, torch.zeros_like(tail))
    return out, {"h": h_last, "conv": tail}


def rglru_block_decode(params, cfg, x1, state, valid=None):
    """One-step decode. x1: (B, 1, D); state {"h": (B, W), "conv":
    (B, cw-1, W)}; ``valid`` (B, 1): rows that are False keep their state.
    Returns (out (B, 1, D), the new state)."""
    gate = _gate_branch(params, x1)
    xin = x1 @ params["w_in_x"]
    xc, conv = _conv_step(xin, state["conv"], params["conv_w"],
                          params["conv_b"])
    a, bx = _rglru_gates(params, xc)
    h = a[:, 0] * state["h"] + bx[:, 0]
    y = (h[:, None, :] * gate).to(x1.dtype)
    out = y @ params["w_out"]
    if valid is not None:
        keep = valid.to(device=x1.device, dtype=torch.bool).reshape(-1, 1)
        h = torch.where(keep, h, state["h"])
        conv = torch.where(keep[..., None], conv, state["conv"])
    return out, {"h": h, "conv": conv}


def rglru_state_spec(cfg, batch: int, dtype, device) -> dict:
    """A zero state: ``h`` (B, W) f32 and ``conv`` (B, cw-1, W) in the
    param dtype."""
    w = cfg.resolved_lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, w),
                                dtype=dtype, device=device)}

