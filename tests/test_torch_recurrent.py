"""The port's RG-LRU path against ``repro`` on shared numpy inputs: the
scan's plain version, GeGLU, the conv and gate pieces, the recurrent block
and the hybrid LM (attention + RG-LRU, GeGLU) on bridged weights.

Tolerances: f32 module parity 1e-5 (the same f32 formulas, reductions and
transcendental functions from another library; a sequential scan against
an associative one), f32 logits 1e-4 (as in ``tests/test_torch_model.py``),
bf16 2e-2 (both sides round the same intermediates to bf16, at other
points of their matmuls).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import base as jb  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_scan  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.rglru_scan import (rglru_scan,  # noqa: E402
                                            rglru_scan_plain)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


def _hybrid_fields(pkg):
    """The tiny hybrid config of the reference fault's reproduction:
    (rglru, rglru, attn window 8), GeGLU, d_model 64, f32."""
    rec = pkg.BlockDef(mixer=pkg.RGLRU, mlp=pkg.GELU_MLP)
    att = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.GELU_MLP, window=8)
    return pkg.ModelConfig(
        name="tiny-hybrid", family="hybrid", source="t", num_layers=3,
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=96, stages=(pkg.Stage(blocks=(rec, rec, att), repeat=1),),
        param_dtype="float32", logit_softcap=30.0)


def _configs(which):
    """(repro config, port config) with equal fields."""
    if which == "recurrentgemma_reduced":
        return (jax_get_config("recurrentgemma-9b").reduced(),
                tcfg.get_config("recurrentgemma-9b").reduced())
    return _hybrid_fields(jb), _hybrid_fields(tcfg.base)


@functools.lru_cache(maxsize=None)
def _pair(which):
    """(repro LM, its params, port LM, bridged params); read, never
    written."""
    jc, tc = _configs(which)
    jlm = JaxLM(jc, kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _close(ours, theirs, tol):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
    assert ours.shape == theirs.shape
    err = float(np.max(np.abs(ours - theirs)))
    assert err < tol, err


# -- the scan's plain version ----------------------------------------------------

@pytest.mark.parametrize("s,w", [(37, 77), (1, 5), (130, 129)])
def test_rglru_scan_plain_matches_repro(s, w):
    """Against ``ref.rglru_scan_ref``, the Pallas kernel in interpret mode
    and the model's associative scan: odd S and W, B = 2, h0 != 0."""
    rng = np.random.default_rng(s * 1000 + w)
    a = rng.uniform(0.3, 0.999, (2, s, w)).astype(np.float32)
    b = rng.standard_normal((2, s, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    before = dict(LAUNCHES)
    h, h_last = rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert LAUNCHES == before                  # the CPU path launches nothing
    ph, ph_last = rglru_scan_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert torch.equal(h, ph) and torch.equal(h_last, ph_last)
    ja, jb_, jh0 = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    for theirs in (jref.rglru_scan_ref(ja, jb_, jh0),
                   pallas_scan(ja, jb_, jh0, block_t=16, block_w=32,
                               interpret=True),
                   JR.rglru_scan_ref(ja, jb_, jh0)):
        _close(h, theirs[0], F32_TOL)
        _close(h_last, theirs[1], F32_TOL)


# -- GeGLU, conv and gates ----------------------------------------------------------

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 9, 24)).astype(np.float32)
MLP = {k: RNG.standard_normal(s).astype(np.float32) * 0.3
       for k, s in (("w_gate", (24, 40)), ("w_up", (24, 40)),
                    ("w_down", (40, 24)))}
CONV_W = RNG.standard_normal((4, 24)).astype(np.float32) * 0.5
CONV_B = RNG.standard_normal((24,)).astype(np.float32) * 0.1
PREV = RNG.standard_normal((2, 3, 24)).astype(np.float32)
GATES = {"w_rgate": RNG.standard_normal((24, 24)).astype(np.float32) * 0.2,
         "b_rgate": RNG.standard_normal((24,)).astype(np.float32) * 0.1,
         "w_igate": RNG.standard_normal((24, 24)).astype(np.float32) * 0.2,
         "b_igate": RNG.standard_normal((24,)).astype(np.float32) * 0.1,
         # repro's init range, exp(-8 softplus(lam)) in [0.9^2, 0.999^2]:
         # near a = 1, 1 - exp(2 log a) cancels and one ulp of exp would
         # move sqrt(1 - a^2) past any f32 tolerance
         "lam": np.log(np.expm1(-np.log(RNG.uniform(
             0.9 ** 2, 0.999 ** 2, 24)) / 8)).astype(np.float32)}
F32_LEAVES = ("b_rgate", "b_igate", "lam")


def _cast(tree, dtype):
    """numpy leaves -> (torch tree, jax tree); weights in ``dtype``, the
    f32 leaves of ``repro``'s init stay f32."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = {k: torch.from_numpy(v).to(torch.float32 if k in F32_LEAVES else tdt)
         for k, v in tree.items()}
    j = {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES else jdt)
         for k, v in tree.items()}
    return t, j


PIECES = {
    "gelu_mlp": lambda t, j, dt: (
        TL.gelu_mlp(_cast(MLP, dt)[0], t(X)),
        JL.gelu_mlp(_cast(MLP, dt)[1], j(X))),
    "causal_conv": lambda t, j, dt: (
        TR._causal_conv(t(X), t(CONV_W), torch.from_numpy(CONV_B)),
        JR._causal_conv(j(X), j(CONV_W), jnp.asarray(CONV_B))),
    "conv_step": lambda t, j, dt: (
        TR._conv_step(t(X[:, :1]), t(PREV), t(CONV_W),
                      torch.from_numpy(CONV_B)),
        JR._conv_step(j(X[:, :1]), j(PREV), j(CONV_W), jnp.asarray(CONV_B))),
    "rglru_gates": lambda t, j, dt: (
        TR._rglru_gates(_cast(GATES, dt)[0], t(X)),
        JR._rglru_gates(_cast(GATES, dt)[1], j(X))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", sorted(PIECES))
def test_pieces_match_repro(piece, dtype):
    def t(x):
        return torch.from_numpy(x).to(getattr(torch, dtype))

    def j(x):
        return jnp.asarray(x, getattr(jnp, dtype))

    ours, theirs = PIECES[piece](t, j, dtype)
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for o, th in zip(ours, theirs):
        assert o.dtype == getattr(torch, str(th.dtype))
        _close(o, th, tol * max(1.0, float(jnp.max(jnp.abs(
            jnp.asarray(th, jnp.float32))))))


def test_softplus_matches_jax_past_torchs_threshold():
    x = np.linspace(-90, 90, 181).astype(np.float32)
    _close(TR.softplus(torch.from_numpy(x)), jax.nn.softplus(x), 1e-5)


# -- the recurrent block ------------------------------------------------------------

def _block():
    """An RG-LRU block of the tiny hybrid LM, its params in both packages
    (the port's bridged) and inputs."""
    jlm, jp, lm, tp = _pair("tiny_hybrid")
    jblk = jax.tree.map(lambda x: x[0], jp["stages"][0]["b0"]["mixer"])
    tblk = {k: v[0] for k, v in tp["stages"][0]["b0"]["mixer"].items()}
    x = np.random.default_rng(6).standard_normal(
        (2, 11, lm.cfg.d_model)).astype(np.float32) * 0.5
    return lm.cfg, jlm.cfg, tblk, jblk, x


def test_rglru_block_forward_and_decode_match_repro():
    cfg, jcfg, tblk, jblk, x = _block()
    out, state = TR.rglru_block_forward(tblk, cfg, torch.from_numpy(x))
    jout, jstate = JR.rglru_block_forward(jblk, jcfg, jnp.asarray(x))
    _close(out, jout, F32_TOL)
    _close(state["h"], jstate["h"], F32_TOL)
    _close(state["conv"], jstate["conv"], F32_TOL)
    tst = TR.rglru_state_spec(cfg, 2, torch.float32, "cpu")
    jst = JR.rglru_state_spec(jcfg, 2, jnp.float32)
    steps = []
    for t in range(x.shape[1]):
        y, tst = TR.rglru_block_decode(tblk, cfg,
                                       torch.from_numpy(x[:, t:t + 1]), tst)
        jy, jst = JR.rglru_block_decode(jblk, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        _close(y, jy, F32_TOL)
        steps.append(y)
    # forward then step-by-step decode equals the forward
    assert (torch.cat(steps, dim=1) - out).abs().max() < 1e-4
    _close(tst["h"], jst["h"], F32_TOL)
    _close(tst["conv"], state["conv"], F32_TOL)


def test_rglru_state_stays_bounded_and_invalid_rows_keep_it():
    cfg, _, tblk, _, _ = _block()
    rng = np.random.default_rng(8)
    st = TR.rglru_state_spec(cfg, 2, torch.float32, "cpu")
    peak = []
    for _ in range(300):
        x1 = torch.from_numpy(rng.standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32))
        _, st = TR.rglru_block_decode(tblk, cfg, x1, st)
        peak.append(float(st["h"].abs().max()))
    assert np.isfinite(peak).all() and max(peak) < 50
    # the late state is no larger than the early one (a contraction)
    assert max(peak[200:]) < 2 * max(peak[:100])
    before = {k: v.clone() for k, v in st.items()}
    _, after = TR.rglru_block_decode(tblk, cfg, x1, st,
                                     valid=torch.tensor([[True], [False]]))
    assert torch.equal(after["h"][1], before["h"][1])
    assert torch.equal(after["conv"][1], before["conv"][1])
    assert not torch.equal(after["h"][0], before["h"][0])


# -- the hybrid LM ---------------------------------------------------------------

CONFIGS = ["tiny_hybrid", "recurrentgemma_reduced"]


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_init_and_bridge_agree_on_the_hybrid_tree():
    """``LM.init`` builds ``repro``'s tree for both configs, ``lam`` in
    f32 with exp(-8 softplus(lam)) in [0.9^2, 0.999^2]; the bridge refuses
    a tree that is not it."""
    for which in CONFIGS:
        jlm, jp, lm, tp = _pair(which)
        ours = lm.init(0)
        shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), ours,
                              is_leaf=lambda x: isinstance(x, torch.Tensor))
        bridged = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tp,
                               is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert shapes == bridged
        lam = ours["stages"][0]["b0"]["mixer"]["lam"]
        assert lam.dtype == torch.float32
        a = torch.exp(-8.0 * TR.softplus(lam))
        assert a.min() >= 0.9 ** 2 - 1e-6 and a.max() <= 0.999 ** 2 + 1e-6
    bad = jax.tree.map(np.asarray, jp)
    del bad["stages"][0]["b0"]["mixer"]["lam"]
    with pytest.raises(ValueError, match="lam"):
        params_from_numpy(bad, lm.cfg, "cpu")


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_forward_matches_repro(which):
    jlm, jp, lm, tp = _pair(which)
    tok = _tokens(2, 13, lm.cfg.vocab_size)
    theirs = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])(jp, tok)
    ours, _ = lm.forward(tp, {"tokens": torch.from_numpy(tok)})
    assert tuple(ours.shape) == (2, 13, lm.cfg.padded_vocab)
    _close(ours, theirs, LOGIT_TOL)


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_prefill_and_decode_match_repro(which):
    """Prefill, then four decode steps: logits, recurrent state and ring
    positions agree with ``repro``'s; prefill + decode equals the forward
    over the whole sequence."""
    jlm, jp, lm, tp = _pair(which)
    width, s, n = 32, 9, 4
    tok = _tokens(2, s + n, lm.cfg.vocab_size, seed=3)
    jlog, jc = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, cache_width=width))(jp, tok[:, :s])
    tlog, tc = lm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :s])},
                          cache_width=width)
    _close(tlog, jlog, LOGIT_TOL)
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos))
    full, _ = lm.forward(tp, {"tokens": torch.from_numpy(tok)})
    for i in range(n):
        feed = tok[:, s + i:s + i + 1]
        jl, jc = jstep(jp, jc, feed, s + i)
        tl, tc = lm.decode_step(tp, tc, torch.from_numpy(feed), s + i)
        _close(tl, jl, LOGIT_TOL)
        assert (tl[:, 0] - full[:, s + i]).abs().max() < LOGIT_TOL
    for si, stage in enumerate(lm.cfg.stages):
        for bi, bdef in enumerate(stage.blocks):
            keys = ("h", "conv") if bdef.mixer == "rglru" else ("pos",)
            for key in keys:
                _close(tc[si][bi][key], jc[si][bi][key], F32_TOL)


@pytest.mark.parametrize("length", [1, 2, 3, 5, 16])
def test_padded_prefill_keeps_the_unpadded_state(length):
    """A prompt right-padded to its bucket (16), prefilled with
    ``lengths``, leaves the recurrent ``h`` and ``conv`` state (and the
    logits at its last real token) of ``repro``'s prefill on the unpadded
    prompt."""
    jlm, jp, lm, tp = _pair("tiny_hybrid")
    tok = _tokens(1, length, lm.cfg.vocab_size, seed=length)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :length] = tok[0]
    jlog, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, cache_width=32)
    tlog, tc = lm.prefill(tp, {"tokens": torch.from_numpy(padded)},
                          cache_width=32,
                          lengths=torch.tensor([length], dtype=torch.int32))
    _close(tlog[:, length - 1], jlog[:, -1], LOGIT_TOL)
    for bi in (0, 1):
        for key in ("h", "conv"):
            _close(tc[0][bi][key], jc[0][bi][key], F32_TOL)


def test_chunked_prefill_refuses_recurrent_mixers():
    _, _, lm, tp = _pair("tiny_hybrid")
    caches = lm.init_cache(1, 32)
    with pytest.raises(NotImplementedError, match="chunk length must be 1"):
        lm.prefill_chunk(tp, caches, torch.zeros((1, 4), dtype=torch.int32),
                         0)
    assert lm.chunk_incompatible_mixer() == "rglru"
