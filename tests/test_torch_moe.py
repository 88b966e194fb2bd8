"""The port's MoE mixer (``repro_torch.models.moe``): ``tests/test_moe.py``'s
invariants (dispatch equals a dense reference when nothing drops, drops
degrade gracefully, slot ids are dense per expert, the switch aux loss),
and ``moe_forward`` / ``route`` against ``repro.models.moe`` on the same
numpy inputs, at ``repro``'s capacity factor 1.25 and at the dropless
factor E / k, at T = 1, 5 and 128 tokens a row. f32 on the CPU; tolerance
1e-5 on outputs of order 1 (the same arithmetic summed in another
order), routes and drops equal."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.param import unbox  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(base, e=4, k=2, shared=0, d=16):
    return base.ModelConfig(
        name="t", family="moe", source="t", num_layers=1, d_model=d,
        num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
        stages=(base.Stage(blocks=(base.BlockDef(mixer=base.ATTN,
                                                 mlp=base.MOE),),
                           repeat=1),),
        moe=base.MoEConfig(num_experts=e, num_experts_per_tok=k,
                           d_ff_expert=32, num_shared_experts=shared,
                           d_ff_shared=32 * shared))


def _params(seed, e=4, k=2, shared=0, d=16):
    """``repro``'s ``moe_init`` params as numpy, and the port's tensors."""
    jp, _ = unbox(jmoe.moe_init(jax.random.PRNGKey(seed),
                                _cfg(jbase, e, k, shared, d), jnp.float32))
    npp = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), npp)
    return npp, tp


def _dense_reference(params, cfg, x):
    """Every expert computed densely and combined with the router's
    weights: what ``moe_forward`` computes when nothing drops."""
    m = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    idx, w, _ = moe_lib.route(params, cfg, x_flat)
    outs = []
    for e in range(m.num_experts):
        g = x_flat @ params["w_gate"][e]
        u = x_flat @ params["w_up"][e]
        outs.append((F.silu(g.float()).to(x.dtype) * u) @ params["w_down"][e])
    outs = torch.stack(outs, 1)                             # (T, E, D)
    y = torch.zeros_like(x_flat)
    for j in range(m.num_experts_per_tok):
        y = y + outs[torch.arange(len(idx)), idx[:, j]] * w[:, j][:, None]
    if m.num_shared_experts:
        sp = params["shared"]
        g = x_flat @ sp["w_gate"]
        u = x_flat @ sp["w_up"]
        y = y + (F.silu(g.float()).to(x.dtype) * u) @ sp["w_down"]
    return y.reshape(b, s, d)


@pytest.mark.parametrize("shared", [0, 1])
def test_dispatch_matches_dense_reference(shared):
    cfg = _cfg(tbase, shared=shared)
    _, tp = _params(0, shared=shared)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32) * 0.5)
    y, aux = moe_lib.moe_forward(tp, cfg, x, capacity_factor=8.0)
    assert (y - _dense_reference(tp, cfg, x)).abs().max() < 1e-4
    assert float(aux) > 0.0


def test_capacity_drops_degrade_gracefully():
    cfg = _cfg(tbase, k=1)
    _, tp = _params(2, k=1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32))
    y_small, _ = moe_lib.moe_forward(tp, cfg, x, capacity_factor=0.25)
    y_big, _ = moe_lib.moe_forward(tp, cfg, x, capacity_factor=8.0)
    assert torch.isfinite(y_small).all()
    assert ((y_small - y_big).abs() > 1e-6).any()
    assert int(moe_lib.dropped_pairs(tp, cfg, x, capacity_factor=0.25)) > 0
    assert int(moe_lib.dropped_pairs(tp, cfg, x, capacity_factor=8.0)) == 0


@settings(max_examples=20, deadline=None)
@given(t=st.integers(2, 40), e=st.integers(2, 8), k=st.integers(1, 3),
       seed=st.integers(0, 2 ** 16))
def test_slot_assignment_properties(t, e, k, seed):
    """The port's ``dispatch``: a kept pair's column is ``expert * C +
    slot`` with slots unique, dense (0..n_e-1) in (token, choice) order
    and below the capacity; a dropped pair is the sentinel E * C."""
    k = min(k, e)
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, e, size=t * k)
    cap = int(rng.integers(1, t + 1))
    keep, target = moe_lib.dispatch(
        torch.from_numpy(flat_e).reshape(t, k), 1, t, e, cap)
    keep, target = keep[0].numpy(), target[0].numpy()
    for expert in range(e):
        mine = flat_e == expert
        slots = target[mine & keep] - expert * cap
        n = int(mine.sum())
        np.testing.assert_array_equal(slots, np.arange(min(n, cap)))
        assert keep[mine].sum() == min(n, cap)
    assert (target[~keep] == e * cap).all()


def test_router_aux_loss_balances():
    """The aux loss is ~1 for a balanced router and > 2 for one collapsed
    onto expert 0 (the switch loss)."""
    cfg = _cfg(tbase, k=1)
    _, tp = _params(4, k=1)
    collapsed = dict(tp)
    collapsed["router"] = torch.zeros_like(tp["router"])
    collapsed["router"][:, 0] = 10.0
    x = torch.from_numpy(np.abs(np.random.default_rng(5).standard_normal(
        (64, cfg.d_model))).astype(np.float32) + 0.1)
    _, _, aux_uniform = moe_lib.route(tp, cfg, x)
    _, _, aux_collapsed = moe_lib.route(collapsed, cfg, x)
    assert float(aux_collapsed) > 2.0
    assert float(aux_uniform) < float(aux_collapsed)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("t", [1, 5, 128])
@pytest.mark.parametrize("factor", [1.25, "dropless"])
def test_moe_forward_matches_repro(shared, t, factor):
    """Mixtral-style (softmax top-2 of 8) and DeepSeek-style (sigmoid
    top-2 of 8 plus a shared expert) routing, 2 rows of T tokens: routes,
    weights, aux, drops and outputs equal ``repro``'s. At E / k = 4 the
    capacity is T and nothing drops."""
    e, k = 8, 2
    cf = e / k if factor == "dropless" else factor
    jc, tc = _cfg(jbase, e, k, shared), _cfg(tbase, e, k, shared)
    npp, tp = _params(6 + shared, e, k, shared)
    x = np.random.default_rng(t).standard_normal(
        (2, t, tc.d_model)).astype(np.float32)
    jidx, jw, jaux = jmoe.route(npp, jc, jnp.asarray(x.reshape(-1, 16)))
    tidx, tw, taux = moe_lib.route(tp, tc, torch.from_numpy(x.reshape(-1,
                                                                     16)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.max(np.abs(tw.numpy() - np.asarray(jw))) < TOL
    assert abs(float(taux) - float(jaux)) < TOL
    jy, jaux2 = jmoe.moe_forward(npp, jc, jnp.asarray(x), capacity_factor=cf)
    ty, taux2 = moe_lib.moe_forward(tp, tc, torch.from_numpy(x),
                                    capacity_factor=cf)
    assert np.max(np.abs(ty.numpy() - np.asarray(jy))) < TOL
    assert abs(float(taux2) - float(jaux2)) < TOL
    dropped = int(moe_lib.dropped_pairs(tp, tc, torch.from_numpy(x),
                                        capacity_factor=cf))
    if factor == "dropless" or t == 1:
        assert moe_lib.capacity(t, k, e, cf) == (t if t > 1 else 1)
        assert dropped == 0
    if factor == "dropless":
        dense = _dense_reference(tp, tc, torch.from_numpy(x))
        assert (ty - dense).abs().max() < TOL


def test_a_short_chunk_drops_where_decode_does_not():
    """``repro``'s own property at 1.25: a 5-token chunk (a k = 4 verify)
    gives each expert a capacity below its load, so its output differs
    from the token-by-token one on some row, while one-token calls never
    drop. The port drops the same pairs."""
    e, k = 4, 2
    jc, tc = _cfg(jbase, e, k), _cfg(tbase, e, k)
    npp, tp = _params(11, e, k)
    x = np.random.default_rng(12).standard_normal(
        (4, 5, tc.d_model)).astype(np.float32)
    chunk, _ = jmoe.moe_forward(npp, jc, jnp.asarray(x))
    steps = np.concatenate([np.asarray(jmoe.moe_forward(
        npp, jc, jnp.asarray(x[:, i:i + 1]))[0]) for i in range(5)], axis=1)
    differs = np.abs(np.asarray(chunk) - steps).max(axis=-1) > 1e-6
    assert differs.any()
    ours, _ = moe_lib.moe_forward(tp, tc, torch.from_numpy(x))
    assert np.max(np.abs(ours.numpy() - np.asarray(chunk))) < TOL
    # the tokens that differ are exactly those with a dropped pair
    idx, _, _ = moe_lib.route(tp, tc, torch.from_numpy(x.reshape(-1, 16)))
    keep, _ = moe_lib.dispatch(idx, 4, 5, e, moe_lib.capacity(5, k, e, 1.25))
    np.testing.assert_array_equal(
        (~keep).reshape(4, 5, k).any(-1).numpy(), differs)
