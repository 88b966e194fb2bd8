"""The port's xLSTM mixers (``repro_torch.models.recurrent``: the mLSTM's
sequential and chunkwise cells, the sLSTM) against ``repro``'s on shared
numpy inputs and bridged weights, on the CPU. It mirrors the mLSTM/sLSTM
half of ``tests/test_recurrent.py`` and adds what serving needs: padded
prefill with ``lengths`` keeps the unpadded state, and rows that are not
``valid`` keep theirs through a decode step.

Tolerances: f32 1e-5 for the cells and blocks, relative to max(1, |ref|)
(the same formulas, summed in another order: the chunkwise form against
the sequential one, torch's GEMMs against XLA's), as in
``tests/test_torch_recurrent.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jb  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

F32_TOL = 1e-5
MIXERS = ("mlstm", "slstm")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg):
    """A tiny xLSTM: (mLSTM, sLSTM) blocks with no separate MLP, d_model
    32, 2 heads of 8 (sLSTM inner width 16, its GeGLU 64), f32."""
    m = pkg.BlockDef(mixer=pkg.MLSTM, mlp=pkg.NONE)
    s = pkg.BlockDef(mixer=pkg.SLSTM, mlp=pkg.NONE)
    return pkg.ModelConfig(
        name="tiny-xlstm", family="ssm", source="t", num_layers=4,
        d_model=32, num_heads=2, num_kv_heads=2, head_dim=8, d_ff=0,
        vocab_size=96, stages=(pkg.Stage(blocks=(m, s), repeat=2),),
        param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _pair():
    """(repro LM, its params, port LM, bridged params); read, never
    written."""
    jlm = JaxLM(_cfg(jb))
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(5))
    tc = _cfg(tcfg.base)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _block(mixer):
    """Layer 1's ``mixer`` block params in both packages (b0 is the
    mLSTM, b1 the sLSTM)."""
    jlm, jp, lm, tp = _pair()
    b = "b0" if mixer == "mlstm" else "b1"
    jblk = jax.tree.map(lambda x: x[1], jp["stages"][0][b]["mixer"])
    tblk = jax.tree.map(lambda x: x[1], tp["stages"][0][b]["mixer"])
    return lm.cfg, jlm.cfg, tblk, jblk


def _close(ours, theirs, tol=F32_TOL):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
    assert ours.shape == theirs.shape
    scale = max(1.0, float(np.max(np.abs(theirs))))
    err = float(np.max(np.abs(ours - theirs)))
    assert err < tol * scale, (err, scale)


def _close_tree(ours, theirs, tol=F32_TOL):
    assert set(ours) == set(theirs)
    for key in ours:
        _close(ours[key], theirs[key], tol)


def _cell_inputs(s, seed=0, b=2, h=2, hd=8):
    """q, k, v (B, S, H, hd), log_i, and log_f = log sigmoid(N(0,1) - 1),
    as in ``tests/test_recurrent.py``, as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    z = rng.standard_normal((b, s, h)).astype(np.float32) - 1.0
    log_f = np.array(-jax.nn.softplus(-z))
    return q, k, v, log_i, log_f


def _mlstm_state(seed, b=2, h=2, hd=8):
    """A nonzero mLSTM state: C (B,H,hd,hd), n (B,H,hd), m (B,H)."""
    rng = np.random.default_rng(seed)
    return {"C": rng.standard_normal((b, h, hd, hd)).astype(np.float32),
            "n": np.abs(rng.standard_normal((b, h, hd))).astype(np.float32),
            "m": rng.standard_normal((b, h)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# -- the mLSTM cells ---------------------------------------------------------------

def test_mlstm_chunkwise_matches_sequential():
    """S = 50 with chunks of 16 (S not a multiple: padded with steps that
    keep the state), from a zero and from a nonzero state."""
    xs = [torch.from_numpy(x) for x in _cell_inputs(50)]
    for state in (None, _t(_mlstm_state(1))):
        h_seq, st_seq = TR.mlstm_cell_ref(*xs, state=state)
        h_chk, st_chk = TR.mlstm_cell_chunkwise(*xs, state=state, chunk=16)
        _close(h_chk, h_seq.numpy())
        _close_tree(st_chk, {k: v.numpy() for k, v in st_seq.items()})


@pytest.mark.parametrize("cell", ["mlstm_cell_ref", "mlstm_cell_chunkwise"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cells_match_repro(cell, with_state):
    xs = _cell_inputs(37, seed=2)
    state = _mlstm_state(3) if with_state else None
    kw = {"chunk": 16} if cell == "mlstm_cell_chunkwise" else {}
    h, st = getattr(TR, cell)(*(torch.from_numpy(x) for x in xs),
                              state=_t(state) if state else None, **kw)
    jh, jst = getattr(JR, cell)(*(jnp.asarray(x) for x in xs),
                                state=_j(state) if state else None, **kw)
    _close(h, jh)
    _close_tree(st, jst)


def test_log_sigmoid_is_repros_negated_softplus_bit_for_bit():
    x = np.concatenate([np.linspace(-90, 90, 721),
                        np.random.default_rng(0).standard_normal(1000) * 5])
    x = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(TR.log_sigmoid(x), -TR.softplus(-x))
    _close(TR.log_sigmoid(x), -jax.nn.softplus(-jnp.asarray(x.numpy())))


def test_slstm_cell_matches_repro():
    _, _, tblk, jblk = _block("slstm")
    rng = np.random.default_rng(4)
    zx = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    state = {k: rng.standard_normal((2, 2, 8)).astype(np.float32)
             for k in ("c", "h", "m")}
    state["n"] = np.abs(rng.standard_normal((2, 2, 8))).astype(np.float32)
    st, h = TR.slstm_cell(tblk, torch.from_numpy(zx), _t(state))
    jst, jh = JR.slstm_cell(jblk, jnp.asarray(zx), _j(state))
    _close(h, jh)
    _close_tree(st, jst)


# -- the blocks --------------------------------------------------------------------

def _x(s, seed=6, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 32)).astype(np.float32) * 0.5


@pytest.mark.parametrize("mixer", MIXERS)
def test_block_forward_and_decode_match_repro(mixer):
    """The full-sequence block (S = 70: two mLSTM chunks, the second
    partial) and one decode step from its state, against ``repro``'s."""
    cfg, jcfg, tblk, jblk = _block(mixer)
    x = _x(70)
    fwd, jfwd = getattr(TR, f"{mixer}_block_forward"), getattr(
        JR, f"{mixer}_block_forward")
    out, state = fwd(tblk, cfg, torch.from_numpy(x))
    jout, jstate = jfwd(jblk, jcfg, jnp.asarray(x))
    _close(out, jout)
    _close_tree(state, jstate)
    x1 = _x(1, seed=7)
    dec, jdec = getattr(TR, f"{mixer}_block_decode"), getattr(
        JR, f"{mixer}_block_decode")
    y, st = dec(tblk, cfg, torch.from_numpy(x1), state)
    jy, jst = jdec(jblk, jcfg, jnp.asarray(x1), jstate)
    _close(y, jy)
    _close_tree(st, jst)


@pytest.mark.parametrize("mixer", MIXERS)
def test_block_forward_matches_decode(mixer):
    """A forward over S tokens equals S one-token decodes from a zero
    state (the chunkwise mLSTM against its sequential cell)."""
    cfg, _, tblk, _ = _block(mixer)
    x = torch.from_numpy(_x(9))
    full, fstate = getattr(TR, f"{mixer}_block_forward")(tblk, cfg, x)
    state = getattr(TR, f"{mixer}_state_init")(2, 2, 8)
    outs = []
    for t in range(x.shape[1]):
        y, state = getattr(TR, f"{mixer}_block_decode")(
            tblk, cfg, x[:, t:t + 1], state)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full.numpy())
    _close_tree(state, {k: v.numpy() for k, v in fstate.items()})


@pytest.mark.parametrize("mixer", MIXERS)
def test_padded_forward_keeps_the_unpadded_state(mixer):
    """Rows right-padded to 80 tokens with ``lengths`` (5, 80, 66) end in
    the state of their unpadded prefix, and their real positions' outputs
    are the unpadded forward's. Without ``lengths`` the pads enter the
    state, as in ``repro`` (ROADMAP Queue 3)."""
    cfg, jcfg, tblk, jblk = _block(mixer)
    fwd = getattr(TR, f"{mixer}_block_forward")
    x = _x(80, seed=8, b=3)
    lengths = (5, 80, 66)
    out, state = fwd(tblk, cfg, torch.from_numpy(x),
                     lengths=torch.tensor(lengths))
    for row, n in enumerate(lengths):
        ref, ref_state = fwd(tblk, cfg, torch.from_numpy(x[row:row + 1, :n]))
        _close(out[row:row + 1, :n], ref.numpy())
        _close_tree({k: v[row:row + 1] for k, v in state.items()},
                    {k: v.numpy() for k, v in ref_state.items()})
    _, jstate = getattr(JR, f"{mixer}_block_forward")(jblk, jcfg,
                                                      jnp.asarray(x))
    tainted = np.asarray(jstate["m"])[0]
    clean = state["m"][0].numpy()
    assert np.max(np.abs(tainted - clean)) > 1e-3


@pytest.mark.parametrize("mixer", MIXERS)
def test_invalid_decode_rows_keep_their_state(mixer):
    cfg, _, tblk, _ = _block(mixer)
    fwd = getattr(TR, f"{mixer}_block_forward")
    _, state = fwd(tblk, cfg, torch.from_numpy(_x(12, b=3)))
    before = {k: v.clone() for k, v in state.items()}
    valid = torch.tensor([[True], [False], [True]])
    _, new = getattr(TR, f"{mixer}_block_decode")(
        tblk, cfg, torch.from_numpy(_x(1, seed=9, b=3)), state, valid)
    for key in new:
        assert torch.equal(new[key][1], before[key][1])
        assert not torch.equal(new[key][0], before[key][0])


@pytest.mark.parametrize("mixer", MIXERS)
def test_state_stays_finite_over_long_inputs(mixer):
    """2,000 tokens of unit-scale input: the stabilised states stay finite
    (the sLSTM's |h| <= 1: |c| <= n once n >= 1), and the mLSTM's
    chunkwise outputs agree with ``repro``'s at the end."""
    cfg, jcfg, tblk, jblk = _block(mixer)
    s = 2000 if mixer == "mlstm" else 600
    x = np.random.default_rng(10).standard_normal((1, s, 32)).astype(
        np.float32)
    out, state = getattr(TR, f"{mixer}_block_forward")(
        tblk, cfg, torch.from_numpy(x))
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    assert bool(torch.isfinite(out).all())
    if mixer == "slstm":
        assert float(state["h"].abs().max()) <= 1.0
    else:
        jout, _ = JR.mlstm_block_forward(jblk, jcfg, jnp.asarray(x))
        _close(out[:, -64:], jout[:, -64:])


# -- the LM's constant leaves --------------------------------------------------------

def test_init_makes_repros_constant_leaves():
    """``LM.init`` draws its own weights, but the mLSTM's ``b_if`` (0, 3)
    per head and the sLSTM's ``bias`` (forget gate 3) are constants: the
    port's equal ``repro``'s init exactly."""
    _, jp, lm, _ = _pair()
    ours = lm.init(0)["stages"][0]
    for b, leaf in (("b0", "b_if"), ("b1", "bias")):
        np.testing.assert_array_equal(
            ours[b]["mixer"][leaf].numpy(),
            np.asarray(jp["stages"][0][b]["mixer"][leaf]))
    assert float(ours["b1"]["mixer"]["bias"][:, 2].min()) == 3.0
