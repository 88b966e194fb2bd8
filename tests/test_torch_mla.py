"""The port's MLA (DeepSeek multi-head latent attention) against
``repro.models.attention``'s on the same numpy params and inputs, f32 on
the CPU: the expanded prefill form (through the flash wrapper's plain
version), the latent cache install with per-row lengths (a ring narrower
than the prompt included), and the absorbed decode over the ring and the
paged layout (single tokens and a multi-token chunk), plus
``tests/test_attention.py::test_mla_decode_matches_expanded`` within the
port. Tolerance 1e-5 on outputs of order 1 (the same f32 arithmetic
summed in another order); 2e-4 for decode against the expanded form, as
the reference's own test; positions equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models.param import unbox  # noqa: E402
from repro.serving.kv_cache import PagedLayout as JaxPaged  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.serving.kv_cache import PagedLayout  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(base):
    return base.ModelConfig(
        name="t", family="moe", source="t", num_layers=1, d_model=32,
        num_heads=4, num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64,
        stages=(base.Stage(blocks=(base.BlockDef(mixer=base.MLA,
                                                 mlp=base.SWIGLU),),
                           repeat=1),),
        mla=base.MLAConfig(q_lora_rank=24, kv_lora_rank=16,
                           qk_nope_head_dim=8, qk_rope_head_dim=8,
                           v_head_dim=8))


def _params(seed=8):
    jp, _ = unbox(jatt.mla_init(jax.random.PRNGKey(seed), _cfg(jbase),
                                jnp.float32))
    npp = jax.tree.map(np.asarray, jp)
    # non-trivial norm scales, so their f32 path is exercised
    for key in ("q_norm", "kv_norm"):
        npp[key] = (0.1 * np.arange(npp[key].size) / npp[key].size).astype(
            np.float32)
    return npp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), npp)


def _x(b, s, seed=9):
    return (np.random.default_rng(seed).standard_normal((b, s, 32)) * 0.3
            ).astype(np.float32)


def _close(ours, theirs, tol=TOL):
    assert np.max(np.abs(ours.numpy() - np.asarray(theirs))) < tol


@pytest.mark.parametrize("window", [None, 5])
def test_mla_forward_matches_repro(window):
    npp, tp = _params()
    x = _x(2, 11)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    jy, (jckv, jkr) = jatt.mla_forward(npp, _cfg(jbase), jnp.asarray(x),
                                       jnp.asarray(pos), window=window,
                                       kv_chunk=4)
    ty, (tckv, tkr) = att.mla_forward(tp, _cfg(tbase), torch.from_numpy(x),
                                      torch.from_numpy(pos), window=window)
    _close(ty, jy)
    _close(tckv, jckv)
    _close(tkr, jkr)


@pytest.mark.parametrize("width", [16, 6])
def test_mla_cache_fill_with_lengths_matches_repro(width):
    """Right-padded rows with their lengths install the same latents and
    positions, into a ring wider than the prompt and one narrower."""
    b, s = 3, 9
    rng = np.random.default_rng(1)
    ckv = rng.standard_normal((b, s, 16)).astype(np.float32)
    kr = rng.standard_normal((b, s, 8)).astype(np.float32)
    lengths = np.asarray([9, 4, 7], np.int32)
    for lens in (None, lengths):
        jc = jatt.mla_cache_fill(
            jatt.init_mla_cache(_cfg(jbase), b, width, jnp.float32),
            jnp.asarray(ckv), jnp.asarray(kr), s,
            None if lens is None else jnp.asarray(lens))
        tc = att.mla_cache_fill(
            att.init_mla_cache(_cfg(tbase), b, width, torch.float32, "cpu"),
            torch.from_numpy(ckv), torch.from_numpy(kr), s,
            None if lens is None else torch.from_numpy(lens))
        for key in ("ckv", "krope", "pos"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))


def test_mla_decode_matches_expanded():
    """Absorbed-form decode, token by token, equals the expanded forward
    (``repro``'s own identity)."""
    _, tp = _params()
    cfg = _cfg(tbase)
    s = 10
    x = torch.from_numpy(_x(2, s))
    pos = torch.arange(s, dtype=torch.int32)[None, :].expand(2, s)
    full, _ = att.mla_forward(tp, cfg, x, pos, window=None)
    cache = att.init_mla_cache(cfg, 2, s, torch.float32, "cpu")
    outs = []
    for t in range(s):
        y, cache = att.mla_decode(tp, cfg, x[:, t:t + 1], cache, t,
                                  window=None)
        outs.append(y)
    assert (full - torch.cat(outs, dim=1)).abs().max() < 2e-4


@pytest.mark.parametrize("window", [None, 4])
def test_mla_decode_on_the_ring_matches_repro(window):
    """Prefill 6 tokens with lengths (6, 3), then decode a 3-token chunk
    (the last token masked on row 1) and two single tokens at per-row
    positions: outputs and the ring equal ``repro``'s."""
    npp, tp = _params()
    jcfg, tcfg_ = _cfg(jbase), _cfg(tbase)
    width, b = 12, 2
    x = _x(b, 6)
    lengths = np.asarray([6, 3], np.int32)
    pos = np.tile(np.arange(6, dtype=np.int32), (b, 1))
    _, (jckv, jkr) = jatt.mla_forward(npp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos), window=window)
    jc = jatt.mla_cache_fill(jatt.init_mla_cache(jcfg, b, width, jnp.float32),
                             jckv, jkr, 6, jnp.asarray(lengths))
    _, (tckv, tkr) = att.mla_forward(tp, tcfg_, torch.from_numpy(x),
                                     torch.from_numpy(pos), window=window)
    tc = att.mla_cache_fill(
        att.init_mla_cache(tcfg_, b, width, torch.float32, "cpu"), tckv,
        tkr, 6, torch.from_numpy(lengths))
    start = lengths.copy()
    chunk = _x(b, 3, seed=3)
    valid = np.asarray([[True, True, True], [True, True, False]])
    jy, jc = jatt.mla_decode(npp, jcfg, jnp.asarray(chunk), jc,
                             jnp.asarray(start), window=window,
                             valid=jnp.asarray(valid))
    ty, tc = att.mla_decode(tp, tcfg_, torch.from_numpy(chunk), tc,
                            torch.from_numpy(start), window=window,
                            valid=torch.from_numpy(valid))
    _close(ty[:, :2], jy[:, :2])
    _close(ty[0], jy[0])
    start = start + valid.sum(1).astype(np.int32)
    for i in range(2):
        one = _x(b, 1, seed=4 + i)
        jy, jc = jatt.mla_decode(npp, jcfg, jnp.asarray(one), jc,
                                 jnp.asarray(start), window=window)
        ty, tc = att.mla_decode(tp, tcfg_, torch.from_numpy(one), tc,
                                torch.from_numpy(start), window=window)
        _close(ty, jy)
        start = start + 1
    for key in ("ckv", "krope", "pos"):
        _close(tc[key], jc[key])


def test_mla_decode_on_the_paged_layout_matches_repro():
    """The paged pool (no head axis on its latent leaves): a 5-token chunk
    into two slots' scattered blocks (slot 1's table with a hole), then a
    single token; outputs and the pool equal ``repro``'s."""
    npp, tp = _params()
    jcfg, tcfg_ = _cfg(jbase), _cfg(tbase)
    bs, n = 4, 8
    tables = np.asarray([[3, 5, 1, -1], [6, 2, -1, -1]], np.int32)
    jpool = {"ckv": jnp.zeros((n, bs, 16)), "krope": jnp.zeros((n, bs, 8)),
             "pos": jnp.full((n, bs), -1, jnp.int32)}
    tpool = {"ckv": torch.zeros((n, bs, 16)), "krope": torch.zeros((n, bs,
                                                                     8)),
             "pos": torch.full((n, bs), -1, dtype=torch.int32)}
    jlay, tlay = JaxPaged(bs), PagedLayout(bs)
    start = np.asarray([0, 2], np.int32)
    for step, t in enumerate((5, 1)):
        x = _x(2, t, seed=20 + step)
        jy, jpool = jatt.mla_decode(npp, jcfg, jnp.asarray(x), jpool,
                                    jnp.asarray(start), window=None,
                                    layout=jlay,
                                    block_tables=jnp.asarray(tables))
        ty, tpool = att.mla_decode(tp, tcfg_, torch.from_numpy(x), tpool,
                                   torch.from_numpy(start), window=None,
                                   layout=tlay,
                                   block_tables=torch.from_numpy(tables))
        _close(ty, jy)
        start = start + t
    for key in ("ckv", "krope", "pos"):
        _close(tpool[key][1:], jpool[key][1:])      # block 0 is the trash
