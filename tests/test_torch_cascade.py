"""The port's cascade core against ``repro``'s, on the same numpy inputs.

- ``cascade_gate_plain`` against ``repro``'s Pallas ``cascade_gate`` in
  interpret mode and against ``ref.cascade_gate_ref``, on the sweep of
  ``tests/test_kernels.py`` and a hypothesis property. Tolerances: conf
  within 1e-5 in f32 (streaming vs dense sum-exp, another summation order)
  and 1e-2 in bf16 (the input's rounding, as ``repro`` holds its kernel);
  routes and counts equal in f32 on rows whose conf lies more than 1e-6
  from both thresholds; counts sum to T.
- Gate and routing: the partition, monotonicity, routing conservation,
  the stable escalated-first order and confidence bounds, each equal to
  ``repro``'s functions; the AP threshold updates equal ``repro``'s in f32.
- ``edge_variant`` gives a config field-equal to ``repro``'s for every
  architecture.
- ``CascadeLM`` on weights bridged from ``repro``'s ``LM.init``: conf
  within 1e-5; routes, counts and ``wan_bytes`` equal; ``pred`` equal
  wherever ``repro``'s top-2 final-logit margin exceeds 1e-4. Within the
  port, compact equals lockstep when every escalation fits the capacity.

``tests/test_torch_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.cascade import ecc_infer as jax_ecc  # noqa: E402
from repro.cascade import gate as jax_gate  # noqa: E402
from repro.cascade import routing as jax_routing  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.cascade_gate import cascade_gate as pallas_gate  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cascade import ecc_infer, gate, routing  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.cascade_gate import (cascade_gate,  # noqa: E402
                                              cascade_gate_plain)
from repro_torch.models.model import LM  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 1e-2
NEAR = 1e-6        # rows this close to a threshold may rightly flip
MARGIN = 1e-4      # logits tolerance of the greedy-prediction rule


def _logits(t, v, dtype, seed, scale=3.0):
    """Numpy logits, rounded to bf16 once when asked (both packages then
    read the same values)."""
    x = (np.random.default_rng(seed).standard_normal((t, v)) * scale
         ).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _away(conf, hi, lo):
    conf = np.asarray(conf, np.float64)
    return (np.abs(conf - np.float32(hi)) > NEAR) & \
        (np.abs(conf - np.float32(lo)) > NEAR)


def _assert_gate_equal(ours, theirs, hi, lo, dtype):
    conf, routes, counts = (np.asarray(a) for a in ours)
    tconf, troutes, tcounts = (np.asarray(a) for a in theirs)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert np.max(np.abs(conf - tconf)) < tol
    assert int(counts.sum()) == len(conf)
    if dtype == "float32":
        away = _away(tconf, hi, lo)
        np.testing.assert_array_equal(routes[away], troutes[away])
        if away.all():
            np.testing.assert_array_equal(counts, tcounts)


@pytest.mark.parametrize("t,v,dtype", [
    (64, 512, "float32"),
    (100, 500, "float32"),       # both dims ragged
    (7, 8000, "float32"),        # vocab >> tokens
    (128, 1024, "bfloat16"),
])
def test_cascade_gate_plain_matches_repro(t, v, dtype):
    x = _logits(t, v, dtype, seed=t + v)
    n = LAUNCHES["cascade_gate"]
    ours = cascade_gate(_to_torch(x, dtype))       # a CPU tensor: plain
    assert LAUNCHES["cascade_gate"] == n           # the plain path counts 0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    interp = pallas_gate(jx, block_t=32, block_v=256, interpret=True)
    oracle = ref.cascade_gate_ref(jx, jax_gate.make_thresholds())
    for theirs in (interp, (oracle["conf"], oracle["routes"],
                            oracle["counts"])):
        _assert_gate_equal(ours, theirs, 0.8, 0.1, dtype)
    # the defaults route nothing to accept at these widths: thresholds at
    # the confidences' tertiles exercise all three routes
    conf = np.sort(np.asarray(ours[0]))
    hi, lo = float(conf[2 * t // 3]), float(conf[t // 3])
    ours = cascade_gate(_to_torch(x, dtype), hi=hi, lo=lo)
    theirs = pallas_gate(jx, hi=hi, lo=lo, block_t=32, block_v=256,
                         interpret=True)
    _assert_gate_equal(ours, theirs, hi, lo, dtype)
    assert (np.asarray(ours[2]) > 0).all()


@settings(max_examples=15, deadline=None)
@given(t=st.integers(1, 60), v=st.integers(8, 600),
       hi=st.floats(0.5, 0.95), lo=st.floats(0.01, 0.4),
       seed=st.integers(0, 1000))
def test_cascade_gate_plain_property(t, v, hi, lo, seed):
    """Counts partition T, routes follow conf, and everything equals the
    Pallas kernel's (interpret mode) on rows away from the thresholds."""
    x = _logits(t, v, "float32", seed, scale=2.0)
    conf, routes, counts = (a.numpy() for a in
                            cascade_gate_plain(torch.from_numpy(x), hi, lo))
    hi32, lo32 = np.float32(hi), np.float32(lo)
    assert int(counts.sum()) == t
    assert np.all(routes[conf >= hi32] == 0)
    assert np.all(routes[conf < lo32] == 1)
    assert np.all(routes[(conf >= lo32) & (conf < hi32)] == 2)
    theirs = pallas_gate(jnp.asarray(x), hi=hi, lo=lo, block_t=16,
                         block_v=64, interpret=True)
    _assert_gate_equal((conf, routes, counts), theirs, hi, lo, "float32")


# -- gate -----------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 64), hi=st.floats(0.5, 0.99), lo=st.floats(0.0, 0.45),
       seed=st.integers(0, 10_000))
def test_gate_partitions_like_repro(n, hi, lo, seed):
    conf = np.random.default_rng(seed).random(n).astype(np.float32)
    th = gate.make_thresholds(hi, lo)
    routes = gate.basic_gate(torch.from_numpy(conf), th).numpy()
    theirs = np.asarray(jax_gate.basic_gate(
        jnp.asarray(conf), jax_gate.make_thresholds(hi, lo)))
    np.testing.assert_array_equal(routes, theirs)
    assert np.all(routes[conf >= np.float32(hi)] == gate.ACCEPT)
    assert np.all(routes[conf < np.float32(lo)] == gate.DROP)
    assert np.all(routes[(conf >= np.float32(lo)) & (conf < np.float32(hi))]
                  == gate.ESCALATE)
    counts = gate.gate_counts(torch.from_numpy(routes))
    tcounts = jax_gate.gate_counts(jnp.asarray(routes))
    assert {k: int(c) for k, c in counts.items()} == \
        {k: int(c) for k, c in tcounts.items()}
    assert sum(int(c) for c in counts.values()) == n
    # thresholds are float32 values, as repro's are
    assert th == (float(np.float32(hi)), float(np.float32(lo)))


def test_gate_monotone_in_confidence():
    """Raising confidence never moves a request down (drop < escalate <
    accept), and the port routes every point as ``repro`` does."""
    th = gate.make_thresholds()
    rank = {gate.DROP: 0, gate.ESCALATE: 1, gate.ACCEPT: 2}
    confs = np.linspace(0, 1, 101).astype(np.float32)
    routes = gate.basic_gate(torch.from_numpy(confs), th).tolist()
    assert all(rank[b] >= rank[a] for a, b in zip(routes, routes[1:]))
    theirs = jax_gate.basic_gate(jnp.asarray(confs),
                                 jax_gate.make_thresholds())
    assert routes == np.asarray(theirs).tolist()


def test_gate_logits_equals_the_unfused_gate():
    """``gate_logits`` (the kernel's plain version here) equals
    ``basic_gate(confidence_from_logits(...))`` on every row away from the
    thresholds, and its confidences equal ``repro``'s."""
    x = _logits(48, 300, "float32", seed=9, scale=2.0)
    conf0 = gate.confidence_from_logits(torch.from_numpy(x)).numpy()
    srt = np.sort(conf0)
    th = gate.make_thresholds(hi=float(srt[32]), lo=float(srt[16]))
    conf, routes, counts = gate.gate_logits(torch.from_numpy(x), th)
    np.testing.assert_allclose(conf.numpy(), conf0, rtol=0, atol=F32_TOL)
    theirs = np.asarray(jax_gate.confidence_from_logits(jnp.asarray(x)))
    np.testing.assert_allclose(conf0, theirs, rtol=0, atol=1e-6)
    away = _away(conf0, th.hi, th.lo)
    unfused = gate.basic_gate(torch.from_numpy(conf0), th).numpy()
    np.testing.assert_array_equal(routes.numpy()[away], unfused[away])
    assert counts.tolist() == [int((routes == r).sum()) for r in range(3)]
    assert min(counts.tolist()) > 0


def test_confidence_from_logits_bounds():
    x = np.random.default_rng(0).standard_normal((32, 100)).astype(
        np.float32) * 5
    conf = gate.confidence_from_logits(torch.from_numpy(x))
    assert float(conf.min()) >= 1.0 / 100
    assert float(conf.max()) <= 1.0


def test_adaptive_thresholds_shrink_and_recover_like_repro():
    """Sustained deterioration shrinks the band, recovery restores BP; every
    intermediate state equals ``repro``'s in f32."""
    ours, theirs = gate.ap_init(), jax_gate.ap_init()

    def upd(s, e, c):
        # eager, as repro's own test runs it: one rounding per op (a jit
        # may contract a multiply-add into an FMA)
        return jax_gate.adaptive_thresholds(s, e, c, deteriorate_s=0.3)

    def same():
        assert ours.th.hi == float(theirs.th.hi)
        assert ours.th.lo == float(theirs.th.lo)
        assert ours.eil_edge == float(theirs.eil_edge)
        assert ours.eil_cloud == float(theirs.eil_cloud)

    for e, c in [(2.0, 0.0)] * 5 + [(0.0, 0.7)] * 3:
        ours = gate.adaptive_thresholds(ours, e, c, deteriorate_s=0.3)
        theirs = upd(theirs, jnp.float32(e), jnp.float32(c))
        same()
    assert ours.th.hi < 0.8 and ours.th.lo > 0.1
    for _ in range(50):
        ours = gate.adaptive_thresholds(ours, 0.0, 0.0, deteriorate_s=0.3)
        theirs = upd(theirs, jnp.float32(0.0), jnp.float32(0.0))
        same()
    assert abs(ours.th.hi - 0.8) < 1e-3 and abs(ours.th.lo - 0.1) < 1e-3


# -- routing --------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(b=st.integers(1, 48), cap_frac=st.floats(0.1, 1.5),
       seed=st.integers(0, 10_000))
def test_routing_conservation_like_repro(b, cap_frac, seed):
    """scatter_back: escalated rows within capacity take the cloud value,
    everything else keeps the edge value; the permutation, its inverse,
    the kept mask and the result equal ``repro``'s."""
    cap = max(1, int(b * cap_frac))
    esc = np.random.default_rng(seed).random(b) < 0.4
    r = routing.compact_escalations(torch.from_numpy(esc), cap)
    jr = jax_routing.compact_escalations(jnp.asarray(esc), cap)
    for ours, theirs in zip(r, jr):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    order = r.order.numpy()
    assert sorted(order.tolist()) == list(range(b))
    edge = np.arange(b, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                              np.float32)
    cloud = routing.gather_compacted(torch.from_numpy(edge), r, cap) + 1000.0
    final = routing.scatter_back(torch.from_numpy(edge), cloud, r).numpy()
    jcloud = jax_routing.gather_compacted(jnp.asarray(edge), jr, cap) + 1000.0
    np.testing.assert_array_equal(
        final, np.asarray(jax_routing.scatter_back(jnp.asarray(edge), jcloud,
                                                   jr)))
    served = set(order[:cap][r.kept.numpy()[:min(cap, b)]].tolist())
    for i in range(b):
        want = i + 1000.0 if (esc[i] and i in served) else i
        assert final[i, 0] == want
    assert int(r.num_escalated) == int(esc.sum())


def test_escalated_first_stable_order():
    esc = torch.tensor([False, True, False, True, True, False])
    r = routing.compact_escalations(esc, 3)
    assert r.order[:3].tolist() == [1, 3, 4]
    assert r.order[3:].tolist() == [0, 2, 5]


# -- configs --------------------------------------------------------------------

@pytest.mark.parametrize("name", jax_configs.ARCHS.names())
def test_edge_variant_field_equal(name):
    if not isinstance(jax_configs.get_config(name),
                      jax_configs.ModelConfig):
        # not an LM config (the video-query app): both refuse alike
        with pytest.raises(AttributeError):
            jax_ecc.edge_variant(jax_configs.get_config(name))
        with pytest.raises(AttributeError):
            ecc_infer.edge_variant(tcfg.get_config(name))
        return
    ours = ecc_infer.edge_variant(tcfg.get_config(name))
    theirs = jax_ecc.edge_variant(jax_configs.get_config(name))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    one = ecc_infer.edge_variant(tcfg.get_config(name), layers=1,
                                 d_model=128)
    assert dataclasses.asdict(one) == dataclasses.asdict(
        jax_ecc.edge_variant(jax_configs.get_config(name), layers=1,
                             d_model=128))


# -- CascadeLM ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cascade_models():
    """smollm-135m reduced as the cloud, its 1-layer edge draft, in both
    packages, the port's weights bridged from ``repro``'s (cloud from
    PRNGKey(0), edge from PRNGKey(1))."""
    jc = jax_configs.get_config("smollm-135m").reduced()
    je = jax_ecc.edge_variant(jc, layers=1)
    tc = tcfg.get_config("smollm-135m").reduced()
    te = ecc_infer.edge_variant(tc, layers=1)
    jcloud, jedge = JaxLM(jc, kv_chunk=16), JaxLM(je, kv_chunk=16)
    jcp = jax.jit(lambda k: jcloud.init(k)[0])(jax.random.PRNGKey(0))
    jep = jax.jit(lambda k: jedge.init(k)[0])(jax.random.PRNGKey(1))
    tcp = params_from_numpy(jax.tree.map(np.asarray, jcp), tc, "cpu")
    tep = params_from_numpy(jax.tree.map(np.asarray, jep), te, "cpu")
    tokens = np.random.default_rng(2).integers(0, 100, (12, 12)).astype(
        np.int32)

    def last(lm, p):
        fwd = jax.jit(lambda p, t: lm.forward(p, {"tokens": t})[0][:, -1])
        return np.array(fwd(p, tokens), np.float32)

    edge_last, cloud_last = last(jedge, jep), last(jcloud, jcp)
    return ((jedge, jcloud, jep, jcp), (LM(te, device="cpu"),
                                        LM(tc, device="cpu"), tep, tcp),
            tokens, edge_last, cloud_last)


def _tertile_thresholds(conf):
    """hi/lo between neighbouring sorted confidences near the tertiles,
    where the gap is widest, so no row sits near a threshold."""
    srt = np.sort(np.asarray(conf, np.float64))
    n = len(srt)

    def split(k):
        cands = range(max(1, k - 1), min(n - 1, k + 1) + 1)
        i = max(cands, key=lambda j: srt[j] - srt[j - 1])
        return float((srt[i] + srt[i - 1]) / 2)

    return split(2 * n // 3), split(n // 3)


def _margins(x):
    top = np.sort(x, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


@pytest.mark.parametrize("step", ["serve_step", "lockstep_step"])
@pytest.mark.parametrize("capacity_frac", [0.25, 1.0])
def test_cascade_lm_matches_repro(step, capacity_frac):
    (jedge, jcloud, jep, jcp), (edge, cloud, tep, tcp), tokens, edge_last, \
        cloud_last = _cascade_models()
    conf0 = np.asarray(jax_gate.confidence_from_logits(jnp.asarray(
        edge_last)))
    hi, lo = _tertile_thresholds(conf0)
    theirs_cas = jax_ecc.CascadeLM(
        jedge, jcloud, thresholds=jax_gate.make_thresholds(hi, lo),
        capacity_frac=capacity_frac)
    ours_cas = ecc_infer.CascadeLM(
        edge, cloud, thresholds=gate.make_thresholds(hi, lo),
        capacity_frac=capacity_frac)
    theirs = {k: np.asarray(v) for k, v in jax.jit(
        getattr(theirs_cas, step))(jep, jcp, {"tokens": tokens}).items()}
    ours = {k: v.numpy() for k, v in getattr(ours_cas, step)(
        tep, tcp, {"tokens": torch.from_numpy(tokens)}).items()}
    assert set(ours) == set(theirs)
    np.testing.assert_allclose(ours["conf"], theirs["conf"], rtol=0,
                               atol=F32_TOL)
    assert _away(theirs["conf"], hi, lo).all()
    for key in ("routes", "accept", "drop", "escalate", "wan_bytes"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert min(int(theirs[k]) for k in ("accept", "drop", "escalate")) > 0
    # final logits of repro's step: cloud rows for escalations it served
    esc = theirs["routes"] == gate.ESCALATE
    cap = (ours_cas.capacity(len(tokens)) if step == "serve_step"
           else len(tokens))
    served = esc & (np.cumsum(esc) <= cap)
    final = np.where(served[:, None], cloud_last, edge_last)
    sure = _margins(final) > MARGIN
    assert sure.sum() >= len(tokens) // 2
    np.testing.assert_array_equal(ours["pred"][sure], theirs["pred"][sure])
    sure = _margins(edge_last) > MARGIN
    np.testing.assert_array_equal(ours["edge_pred"][sure],
                                  theirs["edge_pred"][sure])


def test_cascade_lm_compact_matches_lockstep():
    """Within capacity, the compacted cascade agrees with the
    paper-faithful lockstep on every row, and ships fewer bytes when not
    everything escalates."""
    _, (edge, cloud, tep, tcp), tokens, edge_last, _ = _cascade_models()
    hi, lo = _tertile_thresholds(
        gate.confidence_from_logits(torch.from_numpy(edge_last)).numpy())
    cas = ecc_infer.CascadeLM(edge, cloud,
                              thresholds=gate.make_thresholds(hi, lo),
                              capacity_frac=1.0)
    batch = {"tokens": torch.from_numpy(tokens)}
    a = cas.serve_step(tep, tcp, batch)
    b = cas.lockstep_step(tep, tcp, batch)
    assert torch.equal(a["routes"], b["routes"])
    assert torch.equal(a["pred"], b["pred"])
    assert int(a["escalate"]) < len(tokens)
    assert int(a["wan_bytes"]) < int(b["wan_bytes"])
