"""The port's backward passes on the CPU: ``flash_attention_bwd_plain``
against ``jax.vjp`` of ``repro.models.attention.blockwise_attention`` (its
custom VJP, causal and banded) and against ``torch.autograd`` of
``flash_attention_plain``; ``rglru_scan_bwd_plain`` against ``jax.vjp`` of
``repro.models.recurrent.rglru_scan_ref``; the autograd Functions the
wrappers go through when a gradient is needed; and the mLSTM's chunkwise
form where its upper triangle overflows.

Inputs are made from a seed with numpy. Tolerances (f32 on both sides,
only summation order differs): attention gradients 2e-5 times
max(1, max |reference|); the scan 1e-5 relative to max(1, |reference|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import blockwise_attention  # noqa: E402
from repro.models.recurrent import (  # noqa: E402
    mlstm_cell_chunkwise as jax_chunkwise, rglru_scan_ref)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain,
    flash_attention_plain)
from repro_torch.kernels.rglru_scan import (rglru_scan,  # noqa: E402
                                            rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.models.recurrent import (mlstm_cell_chunkwise,  # noqa: E402
                                          mlstm_cell_ref)

ATTN_TOL = 2e-5
SCAN_TOL = 1e-5

# (label, B, Sq, Sk, H, KV, hd, window): causal everywhere, as every
# training call; "banded" takes blockwise_attention's banded path (Sq = Sk
# >= 4 window, Sq a multiple of the window)
CASES = [
    ("causal", 2, 24, 24, 4, 4, 64, None),
    ("gqa", 1, 20, 20, 6, 2, 64, None),
    ("banded", 1, 32, 32, 4, 2, 64, 8),
    ("window", 2, 20, 20, 4, 1, 64, 6),
    ("sq_lt_sk", 2, 9, 21, 4, 2, 64, None),
    ("sq_lt_sk_window", 1, 9, 21, 2, 1, 64, 5),
    ("mla_hd192", 1, 16, 16, 4, 4, 192, None),
]


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    err = float(np.max(np.abs(ours - ref)))
    assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), err


def _inputs(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_plain_matches_repro_vjp(case):
    """dq, dk, dv (and the output) against ``jax.vjp`` of
    ``blockwise_attention`` on right-aligned positions."""
    _, b, sq, sk, h, kv, hd, window = case
    q, k, v, do = _inputs(1, b, sq, sk, h, kv, hd)
    scale = hd ** -0.5
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + sk - sq, (b, sq))
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))

    def ref(q, k, v):
        return blockwise_attention(q, k, v, jnp.asarray(q_pos),
                                   jnp.asarray(k_pos), window=window,
                                   scale=scale, kv_chunk=8)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, causal=True,
                                         window=window, scale=scale)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                           causal=True, window=window,
                                           scale=scale)
    _close(out, jout, ATTN_TOL)
    for ours, theirs in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(ours, theirs, ATTN_TOL)


AUTOGRAD_CASES = CASES + [
    # rows 0-2 see no key (Sq > Sk): zero gradients, no NaN
    ("empty_rows", 1, 12, 9, 4, 2, 64, None),
    ("empty_rows_window", 2, 12, 9, 2, 2, 8, 3),
]


@pytest.mark.parametrize("case", AUTOGRAD_CASES,
                         ids=[c[0] for c in AUTOGRAD_CASES])
def test_flash_autograd_function_matches_autograd_of_plain(case):
    """``flash_attention`` under autograd goes through ``FlashAttention``
    (plain forward with its log-sum-exp, plain backward) and equals
    ``torch.autograd`` of ``flash_attention_plain``; on CPU tensors it
    launches nothing."""
    _, b, sq, sk, h, kv, hd, window = case
    q, k, v, do = map(torch.from_numpy, _inputs(2, b, sq, sk, h, kv, hd))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(LAUNCHES)
    out = flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert LAUNCHES == before
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    ref_out = flash_attention_plain(q, k, v, causal=True, window=window)
    want = torch.autograd.grad(ref_out, (q, k, v), do)
    assert torch.equal(out, ref_out)
    for ours, theirs in zip(got, want):
        assert torch.isfinite(ours).all()
        _close(ours, theirs.numpy(), ATTN_TOL)
    if sq > sk:
        empty = sq - sk
        assert not got[0][:, :empty].any()


def test_flash_lse_is_the_rows_logsumexp():
    """The forward's log-sum-exp: logsumexp of the scaled scores over the
    valid keys, -inf for a row with none."""
    q, k, v, _ = map(torch.from_numpy, _inputs(3, 1, 10, 7, 2, 1, 16))
    _, lse = flash_attention_fwd_plain(q, k, v, causal=True, window=4)
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * 16 ** -0.5
    qpos = torch.arange(10)[:, None] - 3
    kpos = torch.arange(7)[None, :]
    valid = (kpos <= qpos) & (kpos > qpos - 4)
    want = torch.logsumexp(s.masked_fill(~valid, -torch.inf), -1)
    assert torch.equal(torch.isinf(lse), torch.isinf(want.transpose(1, 2)))
    fin = torch.isfinite(lse)
    assert torch.allclose(lse[fin], want.transpose(1, 2)[fin], atol=1e-5)
    assert torch.isinf(lse[0, :3]).all()


def _scan_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    bx = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    dl = rng.standard_normal((b, w)).astype(np.float32)
    return a, bx, h0, dh, dl


@pytest.mark.parametrize("b,s,w", [(2, 1, 5), (2, 17, 12), (1, 64, 130)])
def test_rglru_scan_bwd_plain_matches_repro_vjp(b, s, w):
    """(da, db, dh0) against ``jax.vjp`` of ``rglru_scan_ref`` with
    cotangents on both h and h_last."""
    a, bx, h0, dh, dl = _scan_inputs(4, b, s, w)
    (jh, jl), vjp = jax.vjp(rglru_scan_ref, jnp.asarray(a), jnp.asarray(bx),
                            jnp.asarray(h0))
    jda, jdb, jdh0 = vjp((jnp.asarray(dh), jnp.asarray(dl)))
    ta, tb, th0, tdh, tdl = map(torch.from_numpy, (a, bx, h0, dh, dl))
    h, _ = rglru_scan_plain(ta, tb, th0)
    da, db, dh0 = rglru_scan_bwd_plain(ta, h, th0, tdh, tdl)
    for ours, theirs in ((da, jda), (db, jdb), (dh0, jdh0)):
        theirs = np.asarray(theirs)
        err = np.abs(ours.numpy() - theirs) / np.maximum(1.0, np.abs(theirs))
        assert float(err.max()) <= SCAN_TOL, float(err.max())


def test_rglru_autograd_function_matches_autograd_of_plain():
    """``rglru_scan`` under autograd goes through ``RGLRUScan`` and equals
    ``torch.autograd`` through the plain loop, with a gradient on h only,
    on h_last only, and on both."""
    a, bx, h0, dh, dl = map(torch.from_numpy, _scan_inputs(5, 2, 11, 7))
    for use_h, use_last in ((True, False), (False, True), (True, True)):
        grads = []
        for fn in (rglru_scan, rglru_scan_plain):
            leaves = [t.clone().requires_grad_() for t in (a, bx, h0)]
            h, last = fn(*leaves)
            loss = ((h * dh).sum() if use_h else 0) + (
                (last * dl).sum() if use_last else 0)
            grads.append(torch.autograd.grad(loss, leaves))
        assert "RGLRUScan" in type(rglru_scan(
            a.requires_grad_(), bx, h0)[0].grad_fn).__name__
        a = a.detach()
        for ours, theirs in zip(*grads):
            assert torch.allclose(ours, theirs, rtol=1e-6, atol=1e-6)


def _mlstm_overflow_inputs(seed, b=1, s=24, h=2, hd=8):
    """Gates whose chunkwise exponent overflows f32 above the diagonal:
    the input gate climbs 12 a step, so exp(u_j - m_t) for j > t reaches
    exp(12 (j - t)), past f32's range beyond 7 steps."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    log_i = (12.0 * np.arange(s, dtype=np.float32))[None, :, None] \
        + rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    return q, k, v, np.broadcast_to(log_i, (b, s, h)).copy(), log_f


@pytest.mark.parametrize("s", [24, 32])
def test_mlstm_chunkwise_gradients_are_finite_where_the_triangle_overflows(s):
    """The port masks the upper triangle's exponent before ``exp`` and
    floors the denominator, so a padded step (S = 24 in chunks of 16)
    behind a stabiliser past f32's exp range adds no NaN: its output and
    its gradients stay finite and equal the sequential cell's within 1e-3
    of max(1, max |reference|) per input (f32 on both sides; at gates that
    climb 12 a step the two forms' stabilisers group the exponents
    differently, measured 3e-4)."""
    q, k, v, li, lf = map(torch.from_numpy, _mlstm_overflow_inputs(6, s=s))
    dh = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape).astype(np.float32))
    outs = []
    for fn in (lambda *x: mlstm_cell_chunkwise(*x, chunk=16),
               mlstm_cell_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
        h, _ = fn(*leaves)
        outs.append((h, torch.autograd.grad((h * dh).sum(), leaves)))
    (h, grads), (h_ref, grads_ref) = outs
    assert torch.isfinite(h).all()
    for ours, theirs in zip(grads, grads_ref):
        assert torch.isfinite(ours).all()
        err = float((ours - theirs).abs().max())
        assert err <= 1e-3 * max(1.0, float(theirs.abs().max())), err


def test_reference_chunkwise_mlstm_overflows_to_nan():
    """``repro``'s chunkwise mLSTM multiplies the overflowed upper triangle
    by 0 (``wmat * tri``), so the same inputs give NaN there (ROADMAP Queue
    3): the fault the port's masking avoids."""
    q, k, v, li, lf = map(jnp.asarray, _mlstm_overflow_inputs(6))
    h, _ = jax_chunkwise(q, k, v, li, lf, chunk=16)
    assert bool(jnp.isnan(h).any())
