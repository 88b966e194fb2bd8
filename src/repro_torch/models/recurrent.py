"""Recurrent temporal mixers: the RG-LRU block (RecurrentGemma / Griffin),
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) after a depthwise
causal conv, gated by a GELU branch; and xLSTM's stabilised mLSTM (matrix
memory) and sLSTM (scalar memory, recurrent gate feedback).

Port of ``repro.models.recurrent``. ``repro`` solves the RG-LRU's
full-sequence recurrence with ``jax.lax.associative_scan``; the port runs
it through ``kernels.rglru_scan`` (the CUDA kernel on the card, its plain
sequential version on the CPU). The xLSTM mixers are jnp in ``repro``
(no Pallas kernel) and plain PyTorch here: the mLSTM's chunkwise-parallel
form for a full sequence, its sequential cell for decode, and the sLSTM's
strictly sequential cell as a Python loop over time (its hidden state
feeds its gates). One-token decode of every mixer is one cell step.

Two departures from ``repro``, both about serving:
- the block forwards take ``lengths`` (B,): every step at t >= length
  leaves the state as it was, so the returned state is the one after each
  row's last *real* token. The RG-LRU's pad steps become the identity
  (a = 1, b = 0), the padding the Pallas scan uses for its own tail, and
  its conv tail holds the last ``cw - 1`` real inputs; the mLSTM's get
  log_i = -1e30 and log_f = 0, ``repro``'s own padding of a partial chunk;
  the sLSTM keeps every step's state and returns the one at length - 1.
  ``repro`` returns the padded sequence's final state, so a prompt
  right-padded to its bucket taints the recurrent state.
- the block decodes take ``valid`` (B, 1): rows that are not valid keep
  their state, the decode contract of ``LM.decode_step`` (``repro``'s
  recurrent decode ignores it).

On a mesh (``tp``, a ``sharding.TensorParallel``) each block takes this
rank's shards and its state holds this rank's part; ``tp=None`` runs the
one-device code unchanged. The RG-LRU runs on its W/N channels
(``tp.lru``): ``w_in_x``, ``w_in_gate`` and the conv by column, the two
gate matrices (whose rows alone split) as partial products summed in one
all-reduce, cast to the param dtype where ``tp=None``'s GEMM rounds, of
which each rank keeps its columns; then the scan on its channels and
``w_out`` row-parallel. The mLSTM runs on its heads (``tp.rec_heads``),
``w_out`` row-parallel. The sLSTM's recurrence is block-diagonal by head,
so its time loop runs on the rank's heads with no collective inside; the
normed head outputs are joined over the ranks (one gather, exact), and
its GeGLU is column-parallel in ``w_up1``/``w_up2`` and row-parallel in
``w_down`` (``tp.rec_mlp``). Every row-parallel partial is all-reduced in
f32; a dimension that does not divide stays whole, with no reduction.
Where the mesh's data axis splits d_model's contraction side, each
mixer's input projections (the RG-LRU's ``w_in_x``/``w_in_gate``, the
mLSTM's five, the sLSTM's ``wx``) are one joined reduction over 'data'
(``layers.project``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import project, rmsnorm

_RGLRU_C = 8.0
LAMBDA_INIT = "rglru_lambda"    # the param spec's leaf kind for ``lam``


@dataclasses.dataclass(frozen=True)
class Constant:
    """The param spec's leaf kind for a constant leaf: ``values`` laid
    along axis ``axis`` of the leaf (counted from the end) and broadcast
    over the others, in f32."""
    values: tuple
    axis: int = -1

    def make(self, shape, device) -> torch.Tensor:
        view = [1] * len(shape)
        view[self.axis] = len(self.values)
        return torch.tensor(self.values, dtype=torch.float32,
                            device=device).reshape(view).expand(
                                shape).contiguous()


def init_lambda(shape, generator, device) -> torch.Tensor:
    """``lam`` = log(expm1(-log(u) / c)) for u ~ U(0.9^2, 0.999^2), in f32,
    so that exp(-c * softplus(lam)) = u and the gate's a = u^r."""
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=generator)
    return torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))


def rglru_param_spec(cfg, n: int, dt) -> dict:
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


def log_sigmoid(x):
    """``-softplus(-x)``, ``repro``'s log-sigmoid, bit for bit: min(x, 0) -
    log1p(exp(-|x|)) is that expression with its two negations folded
    (both exact), two kernels fewer in the sLSTM's per-step loop."""
    x = x.float()
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


def _keep_invalid(new: dict, old: dict, valid) -> dict:
    """``new`` where ``valid`` (B, 1) is True, else ``old``, per leaf."""
    if valid is None:
        return new
    keep = valid.to(device=next(iter(old.values())).device,
                    dtype=torch.bool).reshape(-1)
    return {key: torch.where(keep.view((-1,) + (1,) * (t.dim() - 1)), t,
                             old[key]) for key, t in new.items()}


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


def _gate_products(params, xc, tp):
    """``xc @ w_rgate`` and ``xc @ w_igate`` in the param dtype. On a mesh
    that splits the width, ``xc`` and the matrices' rows are this rank's:
    the two partial products are summed over the ranks in one all-reduce
    and each rank keeps its W/N columns of the sums."""
    if tp is None or not tp.lru:
        return xc @ params["w_rgate"], xc @ params["w_igate"]
    both = torch.cat([xc @ params["w_rgate"], xc @ params["w_igate"]], -1)
    # the sums are replicated; each rank's columns of both are one cut
    # (under autograd one gather of their gradients)
    both = tp.reduce(both, True).unflatten(-1, (2, -1))
    return tp.scatter(both, -1).unbind(-2)


def _rglru_gates(params, xc, tp=None):
    """The recurrence's a_t and input b_t (both f32) from the conv output."""
    pr, pi = _gate_products(params, xc, tp)
    r = torch.sigmoid(pr.float() + params["b_rgate"])
    i = torch.sigmoid(pi.float() + params["b_igate"])
    log_a = -_RGLRU_C * softplus(params["lam"]) * r      # (B, S, W) f32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gated_x = mult * i * xc.float()
    return a, gated_x


_SLSTM_MLP = ("w_up1", "w_up2", "w_down")


def region_reads(mixer: str, names, tp) -> set:
    """Which of a recurrent mixer's leaves (``names``; ``mixer`` "rglru",
    "mlstm" or "slstm") a rank reads inside a region split over 'model',
    as ``attention.region_reads``: the RG-LRU's from its input
    (``_rglru_inputs``) when its width splits; the mLSTM's and sLSTM's
    after their own norm (``_mlstm_inputs``, ``slstm_block_forward``)
    when their heads split, but the sLSTM's GeGLU, which reads the heads
    gathered (``_slstm_out``), only when its columns split."""
    if mixer == "rglru":
        return set(names) if tp.lru else set()
    heads = set(names) - {"norm"} if tp.rec_heads else set()
    if mixer == "mlstm":
        return heads
    mlp = set(_SLSTM_MLP) & set(names)
    return (heads - mlp) | (mlp if tp.rec_mlp else set())


def _rglru_inputs(params, x, tp):
    """The gate branch gelu(x @ w_in_gate) in f32 and x @ w_in_x, one
    reduction over 'data' where the mesh ``tp`` splits D there."""
    if tp is not None:
        x = tp.enter(x, tp.lru)          # the region of region_reads
    gin, xin = project(x, [params["w_in_gate"], params["w_in_x"]], tp,
                       tp is not None and tp.data_proj)
    return F.gelu(gin.float(), approximate="tanh"), xin


def _row_parallel(y, w, tp, field: str):
    """``y @ w``, summed over the ranks where the mesh ``tp`` splits its
    ``field`` (``lru``, ``rec_heads`` or ``rec_mlp``)."""
    out = y @ w
    return out if tp is None else tp.reduce(out, getattr(tp, field))


def rglru_block_forward(params, cfg, x, lengths=None, tp=None):
    """Full-sequence recurrent block from a zero state. x: (B, S, D);
    ``lengths`` (B,): true lengths of right-padded rows. Returns (out
    (B, S, D), state {"h": (B, W) f32, "conv": (B, cw-1, W)}; on a mesh
    this rank's W/N channels of it)."""
    b, s, _ = x.shape
    gate, xin = _rglru_inputs(params, x, tp)
    xc = _causal_conv(xin, params["conv_w"], params["conv_b"])
    a, bx = _rglru_gates(params, xc, tp)
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
    out = _row_parallel(y, params["w_out"], tp, "lru")
    # the last cw-1 real inputs, zero-filled on the left of short rows
    idx = (length[:, None] - (cfg.rglru_conv_width - 1)
           + torch.arange(cfg.rglru_conv_width - 1, device=x.device)[None])
    tail = xin[torch.arange(b, device=x.device)[:, None],
               idx.clamp_min(0)]
    tail = torch.where((idx >= 0)[..., None], tail, torch.zeros_like(tail))
    return out, {"h": h_last, "conv": tail}


def rglru_block_decode(params, cfg, x1, state, valid=None, tp=None):
    """One-step decode. x1: (B, 1, D); state {"h": (B, W), "conv":
    (B, cw-1, W)} (on a mesh this rank's channels); ``valid`` (B, 1): rows
    that are False keep their state. Returns (out (B, 1, D), the new
    state)."""
    gate, xin = _rglru_inputs(params, x1, tp)
    xc, conv = _conv_step(xin, state["conv"], params["conv_w"],
                          params["conv_b"])
    a, bx = _rglru_gates(params, xc, tp)
    h = a[:, 0] * state["h"] + bx[:, 0]
    y = (h[:, None, :] * gate).to(x1.dtype)
    out = _row_parallel(y, params["w_out"], tp, "lru")
    return out, _keep_invalid({"h": h, "conv": conv}, state, valid)


def rglru_state_spec(cfg, batch: int, dtype, device, tp=None) -> dict:
    """A zero state: ``h`` (B, W) f32 and ``conv`` (B, cw-1, W) in the
    param dtype; W/N channels on a mesh that splits the width."""
    w = cfg.resolved_lru_width
    if tp is not None and tp.lru:
        w //= tp.ways
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, w),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory), stabilised
# ---------------------------------------------------------------------------

_PAD_LOG_I = -1e30      # a step with log_i = -1e30, log_f = 0 keeps C, n, m
_TINY = torch.finfo(torch.float32).tiny


def mlstm_param_spec(cfg, n: int, dt) -> dict:
    """One stage's stacked mLSTM mixer leaves as (shape, dtype, init); the
    block norms its input itself (``norm``). ``b_if`` is (0, 3) per head:
    input gate 0, forget gate 3."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    f32 = torch.float32
    return {
        "norm": {"scale": ((n, d), f32, 0.0)},
        "wq": ((n, d, h, hd), dt, d ** -0.5),
        "wk": ((n, d, h, hd), dt, d ** -0.5),
        "wv": ((n, d, h, hd), dt, d ** -0.5),
        "w_if": ((n, d, h, 2), dt, d ** -0.5),
        "b_if": ((n, h, 2), f32, Constant((0.0, 3.0))),
        "w_ogate": ((n, d, h, hd), dt, d ** -0.5),
        "gn_scale": ((n, h, hd), f32, 0.0),
        "w_out": ((n, h, hd, d), dt, (h * hd) ** -0.5),
    }


def _headnorm(x, scale, eps):
    """Per-head RMS norm in f32. x: (B, S, H, hd); scale (H, hd)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale)).to(dt)


def _proj(x, w):
    """x (B, S, D) @ w (D, *out) -> (B, S, *out)."""
    return (x @ w.reshape(w.shape[0], -1)).view(x.shape[:2] + w.shape[1:])


def _projs(x, ws, tp):
    """``_proj`` of x by each w, one reduction over 'data' for all of them
    where the mesh ``tp`` splits D there."""
    outs = project(x, [w.reshape(w.shape[0], -1) for w in ws], tp,
                   tp is not None and tp.data_proj)
    return [o.view(x.shape[:2] + w.shape[1:]) for o, w in zip(outs, ws)]


def mlstm_state_init(batch: int, heads: int, head_dim: int,
                     device="cpu") -> dict:
    """A zero state: ``C`` (B, H, hd, hd), ``n`` (B, H, hd), ``m`` (B, H),
    all f32."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, heads, head_dim, head_dim), **f32),
            "n": torch.zeros((batch, heads, head_dim), **f32),
            "m": torch.zeros((batch, heads), **f32)}


def mlstm_cell_ref(q, k, v, log_i, log_f, state=None):
    """Sequential stabilised mLSTM (the oracle and the decode path).
    q, k, v: (B, S, H, hd); log_i, log_f: (B, S, H) f32; ``state`` as
    ``mlstm_state_init`` or None (zero). Returns (h (B, S, H, hd) f32, the
    final state)."""
    b, s, h, hd = q.shape
    if state is None:
        state = mlstm_state_init(b, h, hd, q.device)
    C, n, m = state["C"], state["n"], state["m"]
    scale = hd ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for t in range(s):
        li, lf = log_i[:, t], log_f[:, t]
        kt, vt = k[:, t], v[:, t]
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)[..., None]
        f_ = torch.exp(lf + m - m_new)[..., None]
        C = f_[..., None] * C + i_[..., None] * (vt[..., :, None]
                                                 * kt[..., None, :])
        n = f_ * n + i_ * kt
        qs = q[:, t] * scale
        num = (C @ qs[..., None])[..., 0]                  # (B, H, hd)
        den = torch.abs((n * qs).sum(-1))
        den = torch.maximum(den, torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_cell_chunkwise(q, k, v, log_i, log_f, state=None, chunk: int = 64):
    """Stabilised chunkwise-parallel mLSTM, the full-sequence path: the
    math of ``mlstm_cell_ref`` as S / chunk sequential steps of
    attention-like work within a chunk. S is padded to a multiple of
    ``chunk`` with steps that keep the state (log_i = -1e30, log_f = 0).
    Shapes as ``mlstm_cell_ref``."""
    b, s, h, hd = q.shape
    if state is None:
        state = mlstm_state_init(b, h, hd, q.device)
    pad = (-s) % chunk
    q, k, v = q.float(), k.float(), v.float()
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=_PAD_LOG_I)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    C, n, m = state["C"], state["n"], state["m"]
    scale = hd ** -0.5
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    hs = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        qh = q[:, sl].transpose(1, 2) * scale              # (B, H, T, hd)
        kh, vh = k[:, sl].transpose(1, 2), v[:, sl].transpose(1, 2)
        li = log_i[:, sl].transpose(1, 2)                   # (B, H, T)
        cum = torch.cumsum(log_f[:, sl].transpose(1, 2), dim=-1)
        u = li - cum
        m_t = cum + torch.maximum(m[..., None], torch.cummax(u, dim=2)[0])
        # across chunks: q_t . C_prev scaled by exp(m_prev + F_t - m_t)
        inter_w = torch.exp(m[..., None] + cum - m_t)
        num = (qh @ C.transpose(-1, -2)) * inter_w[..., None]
        den = (qh @ n[..., None])[..., 0] * inter_w
        # within: w_tj = exp(F_t - F_j + li_j - m_t) for j <= t (the
        # exponent masked above the diagonal, where it may overflow)
        expo = u[:, :, None, :] - (m_t - cum)[..., None]
        wmat = torch.exp(torch.where(tri, expo, torch.full_like(expo,
                                                                -torch.inf)))
        sc = (qh @ kh.transpose(-1, -2)) * wmat
        num = num + sc @ vh
        # floored at f32's least normal: a pad step (q = 0) behind a
        # stabiliser m_t > 87 would divide 0 by 0, and the NaN gradient of
        # that row reaches the inputs though the row is sliced off
        den = torch.maximum(torch.abs(den + sc.sum(-1)),
                            torch.exp(-m_t)).clamp_min(_TINY)
        hs.append((num / den[..., None]).transpose(1, 2))
        # the state at the chunk's end
        m_last = m_t[..., -1]
        decay = torch.exp(m[..., None] + cum[..., -1:] - m_last[..., None])
        wj = torch.exp(cum[..., -1:] - cum + li - m_last[..., None])
        C = C * decay[..., None] + (vh * wj[..., None]).transpose(-1, -2) @ kh
        n = n * decay + (wj[..., None] * kh).sum(2)
        m = m_last
    return torch.cat(hs, dim=1)[:, :s], {"C": C, "n": n, "m": m}


def _mlstm_inputs(params, cfg, x, tp=None):
    """q, k, v (B, S, H, hd) in x's dtype; log_i, log_f (B, S, H) and the
    output gate o (B, S, H, hd), f32."""
    xn = rmsnorm(params["norm"], x, cfg.rms_eps)
    if tp is not None:
        xn = tp.enter(xn, tp.rec_heads)
    q, k, v, gif, og = _projs(xn, [params[w] for w in (
        "wq", "wk", "wv", "w_if", "w_ogate")], tp)
    gif = gif.float() + params["b_if"]
    log_i = gif[..., 0]
    log_f = log_sigmoid(gif[..., 1])
    o = torch.sigmoid(og.float())
    return q, k, v, log_i, log_f, o


def _mlstm_out(params, cfg, h, o, dtype, tp=None):
    h = _headnorm(h, params["gn_scale"], cfg.rms_eps) * o
    w = params["w_out"]
    return _row_parallel(h.to(dtype).flatten(2), w.reshape(-1, w.shape[-1]),
                         tp, "rec_heads")


def mlstm_block_forward(params, cfg, x, lengths=None, chunk: int = 64,
                        tp=None):
    """Full-sequence mLSTM block from a zero state (chunkwise). x:
    (B, S, D); ``lengths`` (B,): steps past a row's length keep its state.
    Returns (out (B, S, D), state {"C", "n", "m"}; on a mesh this rank's
    heads' state)."""
    q, k, v, log_i, log_f, o = _mlstm_inputs(params, cfg, x, tp)
    if lengths is not None:
        b, s = x.shape[:2]
        length = lengths.to(device=x.device, dtype=torch.int64).reshape(b)
        real = (torch.arange(s, device=x.device)[None, :]
                < length[:, None])[..., None]
        log_i = torch.where(real, log_i, torch.full_like(log_i, _PAD_LOG_I))
        log_f = torch.where(real, log_f, torch.zeros_like(log_f))
    h, state = mlstm_cell_chunkwise(q, k, v, log_i, log_f, chunk=chunk)
    return _mlstm_out(params, cfg, h, o, x.dtype, tp), state


def mlstm_block_decode(params, cfg, x1, state, valid=None, tp=None):
    """One-step decode through the sequential cell. x1: (B, 1, D); state
    {"C", "n", "m"}; ``valid`` (B, 1): rows that are False keep their
    state. Returns (out (B, 1, D), the new state)."""
    q, k, v, log_i, log_f, o = _mlstm_inputs(params, cfg, x1, tp)
    h, new = mlstm_cell_ref(q, k, v, log_i, log_f, state)
    return (_mlstm_out(params, cfg, h, o, x1.dtype, tp),
            _keep_invalid(new, state, valid))


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory; recurrent gate feedback, so sequential)
# ---------------------------------------------------------------------------

def slstm_param_spec(cfg, n: int, dt) -> dict:
    """One stage's stacked sLSTM mixer leaves as (shape, dtype, init):
    input weights ``wx`` (D, 4, H, hd) and recurrent ``rh`` (4, H, hd, hd)
    for the z, i, f, o gates, ``bias`` with the forget gate's at 3, the
    head norm and the block's internal GeGLU (``w_up1``, ``w_up2``,
    ``w_down``, inner width H * hd to 2 D and back to D)."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    inner, dff = h * hd, 2 * d
    f32 = torch.float32
    return {
        "norm": {"scale": ((n, d), f32, 0.0)},
        "wx": ((n, d, 4, h, hd), dt, d ** -0.5),
        "rh": ((n, 4, h, hd, hd), dt, hd ** -0.5),
        "bias": ((n, 4, h, hd), f32, Constant((0.0, 0.0, 3.0, 0.0), -3)),
        "gn_scale": ((n, h, hd), f32, 0.0),
        "w_up1": ((n, inner, dff), dt, inner ** -0.5),
        "w_up2": ((n, inner, dff), dt, inner ** -0.5),
        "w_down": ((n, dff, d), dt, dff ** -0.5),
    }


def slstm_state_init(batch: int, heads: int, head_dim: int,
                     device="cpu") -> dict:
    """A zero state: ``c``, ``n``, ``h``, ``m``, each (B, H, hd) f32."""
    return {key: torch.zeros((batch, heads, head_dim), dtype=torch.float32,
                             device=device) for key in ("c", "n", "h", "m")}


def _slstm_step(z_pre, i_t, f_t, o_pre, c, n, m):
    """The sLSTM's stabilised update from its four gate pre-activations
    (f32, any common shape). Returns (c, n, h, m)."""
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    lf_m = log_sigmoid(f_t) + m
    m = torch.maximum(lf_m, i_t)
    i_ = torch.exp(i_t - m)
    f_ = torch.exp(lf_m - m)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    return c, n, o * c / torch.clamp_min(n, 1.0), m


def slstm_cell(params, zx, state):
    """One sLSTM step, ``repro``'s oracle. zx: (B, 4, H, hd)
    pre-activations from the input; ``state`` as ``slstm_state_init``.
    Returns (the new state, h (B, H, hd))."""
    rec = torch.einsum("bhk,ghkv->bghv", state["h"], params["rh"].float())
    pre = zx.float() + rec + params["bias"]
    c, n, h, m = _slstm_step(pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3],
                             state["c"], state["n"], state["m"])
    return {"c": c, "n": n, "h": h, "m": m}, h


def _slstm_scan(params, zx, state, lengths):
    """``slstm_cell`` over the S steps of zx (B, S, 4, H, hd), in a layout
    that makes a step few kernels: heads lead, the recurrent product is
    one batched matmul a step. Returns (h (B, S, H, hd) f32, the state
    after each row's last real step, or after step S - 1)."""
    b, s, _, nh, hd = zx.shape
    # (H, B, 4 hd) a step; rh as (H, hd, 4 hd); bias as (H, 1, 4 hd)
    zs = zx.float().permute(1, 3, 0, 2, 4).reshape(s, nh, b, 4 * hd)
    rh = params["rh"].float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    bias = params["bias"].permute(1, 0, 2).reshape(nh, 1, 4 * hd)
    c, n, h, m = (state[key].transpose(0, 1) for key in ("c", "n", "h", "m"))
    steps = []
    for t in range(s):
        pre = zs[t] + torch.bmm(h, rh) + bias
        c, n, h, m = _slstm_step(*pre.split(hd, dim=-1), c, n, m)
        steps.append((c, n, h, m))
    seq = {key: torch.stack(v).permute(2, 0, 1, 3)       # (B, S, H, hd)
           for key, v in zip(("c", "n", "h", "m"), zip(*steps))}
    if lengths is None:
        final = {key: v[:, -1] for key, v in seq.items()}
    else:
        length = lengths.to(device=zx.device, dtype=torch.int64).reshape(b)
        last = (length - 1).clamp_min(0)
        rows = torch.arange(b, device=zx.device)
        empty = (length == 0).view(b, 1, 1)
        final = {key: torch.where(empty, state[key], v[rows, last])
                 for key, v in seq.items()}
    return seq["h"], final


def _slstm_out(params, cfg, hs, dtype, tp=None):
    """Head norm, then the block's internal GeGLU. hs: (B, S, H, hd) (on a
    mesh this rank's heads, joined over the ranks in rank order into the
    whole (B, S, H * hd) row that ``w_up1``/``w_up2`` read)."""
    y = _headnorm(hs, params["gn_scale"], cfg.rms_eps).flatten(2).to(dtype)
    if tp is not None and tp.rec_heads:
        y = tp.gather(y, -1)
    if tp is not None:
        y = tp.enter(y, tp.rec_mlp)
    g = F.gelu((y @ params["w_up1"]).float(), approximate="tanh")
    u = y @ params["w_up2"]
    return _row_parallel(g.to(dtype) * u, params["w_down"], tp, "rec_mlp")


def rec_heads(cfg, tp=None) -> int:
    """The mLSTM / sLSTM heads a rank runs (all of them without a mesh)."""
    h = cfg.num_heads
    return h // tp.ways if tp is not None and tp.rec_heads else h


def slstm_block_forward(params, cfg, x, lengths=None, state=None, tp=None):
    """Full-sequence sLSTM block (from a zero state, or ``state``). x:
    (B, S, D); ``lengths`` (B,): the state returned is the one after each
    row's last real step. Returns (out (B, S, D), state {"c", "n", "h",
    "m"}; on a mesh this rank's heads' state)."""
    if state is None:
        state = slstm_state_init(x.shape[0], rec_heads(cfg, tp),
                                 cfg.resolved_head_dim, x.device)
    xn = rmsnorm(params["norm"], x, cfg.rms_eps)
    if tp is not None:
        xn = tp.enter(xn, tp.rec_heads)
    zx, = _projs(xn, [params["wx"]], tp)                 # (B, S, 4, H, hd)
    hs, state = _slstm_scan(params, zx, state, lengths)
    return _slstm_out(params, cfg, hs, x.dtype, tp), state


def slstm_block_decode(params, cfg, x1, state, valid=None, tp=None):
    """One-step decode. x1: (B, 1, D); ``valid`` (B, 1): rows that are
    False keep their state. Returns (out (B, 1, D), the new state)."""
    out, new = slstm_block_forward(params, cfg, x1, state=state, tp=tp)
    return out, _keep_invalid(new, state, valid)
