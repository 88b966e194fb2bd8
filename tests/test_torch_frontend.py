"""The port's modality frontends and the last three assigned architectures
on the CPU: a vision prefix (``internvl2-2b``: stubbed ViT patch
embeddings through the 2-layer projector in front of the text) and audio
codebooks (``musicgen-medium``: a (B, S, 4) token grid, summed
embeddings, one head per codebook) against ``repro``'s ``LM`` on bridged
weights and shared numpy inputs; the full-width parameter trees of
``xlstm-125m``, ``internvl2-2b`` and ``musicgen-medium``; and
``tests/test_models_smoke.py``'s forward and decode checks over all ten
``ASSIGNED_ARCHS`` in ``.reduced()`` form (the port has no loss yet, so
no train step).

Tolerance: f32 logits 1e-4, as in ``tests/test_torch_model.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.frontend import make_batch  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

TOL = 1e-4
MODAL = ("internvl2-2b", "musicgen-medium")
NEW = {"xlstm-125m": 134_161_200, "internvl2-2b": 1_895_925_760,
       "musicgen-medium": 1_837_254_144}
B, S = 2, 24


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(repro LM, its params, port LM, bridged params) at ``.reduced()``
    (f32; internvl2's prefix 8 patches of 64); read, never written."""
    jlm = JaxLM(jax_get_config(name).reduced(), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(1))
    tc = tcfg.get_config(name).reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _batch(cfg, s, seed=0):
    """numpy inputs: tokens (B, s) or (B, s, C), and for vision unit-norm
    ``image_embeds`` (B, P, E), as ``repro``'s stub makes them."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    shape = (B, s, fe.num_codebooks) if fe.kind == "audio" else (B, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if fe.kind == "vision":
        img = rng.standard_normal((B, fe.num_prefix_tokens, fe.embed_dim))
        out["image_embeds"] = (img / np.linalg.norm(img, axis=-1,
                                                    keepdims=True)).astype(
                                                        np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(ours, theirs, tol=TOL):
    theirs = np.asarray(theirs, np.float32)
    assert tuple(ours.shape) == theirs.shape
    err = float(np.max(np.abs(ours.float().numpy() - theirs)))
    assert err < tol, err


@pytest.mark.parametrize("name", MODAL)
def test_forward_matches_repro(name):
    """Full-sequence logits: (B, P + S, V) behind the vision prefix,
    (B, S, C, V) for the audio grid."""
    jlm, jp, lm, tp = _pair(name)
    batch = _batch(lm.cfg, 13)
    ours, _ = lm.forward(tp, _t(batch))
    theirs = jax.jit(lambda p, b: jlm.forward(p, b)[0])(jp, _j(batch))
    _close(ours, theirs)


@pytest.mark.parametrize("name", MODAL)
def test_prefill_and_decode_match_repro(name):
    """Prefill (vision: prefix + text; audio: the grid) into a cache as
    wide as the whole stream, then 5 decode steps of plain text (the prefix lives in the
    cache) or of (B, 1, C) codebook tokens at positions behind it."""
    jlm, jp, lm, tp = _pair(name)
    batch = _batch(lm.cfg, 12, seed=2)
    steps = _batch(lm.cfg, 5, seed=3)["tokens"]
    prefix = lm.cfg.frontend.num_prefix_tokens
    width = prefix + 12 + 5
    logits, caches = lm.prefill(tp, _t(batch), cache_width=width)
    jlog, jcaches = jlm.prefill(jp, _j(batch), cache_width=width)
    _close(logits, jlog)
    for t in range(5):
        pos = prefix + 12 + t
        tok = steps[:, t:t + 1]
        logits, caches = lm.decode_step(tp, caches, torch.from_numpy(tok),
                                        pos)
        jlog, jcaches = jlm.decode_step(jp, jcaches, jnp.asarray(tok), pos)
        _close(logits, jlog)


def test_audio_last_only_and_logits_index():
    """``last_only`` and ``logits_index`` pick positions of the (B, S, C, V)
    audio logits, the full forward's rows (to TOL: the unembedding GEMM
    runs at another M)."""
    _, _, lm, tp = _pair("musicgen-medium")
    batch = _t(_batch(lm.cfg, 9, seed=4))
    full, _ = lm.forward(tp, batch)
    last, _ = lm.forward(tp, batch, last_only=True)
    assert last.shape == (B, 1, 4, lm.cfg.padded_vocab)
    _close(last, full[:, -1:].numpy())
    idx = torch.tensor([3, 7], dtype=torch.int32)
    picked, _ = lm.forward(tp, batch, logits_index=idx)
    _close(picked, full[torch.arange(B), idx.long()][:, None].numpy())


@pytest.mark.parametrize("name", sorted(NEW))
def test_param_tree_matches_repro_at_full_width(name):
    """Full width and depth: ``param_spec``'s names, shapes and dtypes are
    those of ``repro``'s ``LM.abstract()`` (nothing allocated): the
    xLSTM blocks without norm1/norm2/mlp, the sLSTM's internal GeGLU,
    ``vision_proj``, the (C, V, D) codebook tables; and the count."""
    theirs, _ = JaxLM(jax_get_config(name)).abstract()
    ours = LM(tcfg.get_config(name), device="cpu").param_spec()
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), theirs),
        is_leaf=lambda x: isinstance(x, tuple))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x[0]), str(x[1])[6:]), ours,
                     is_leaf=lambda x: isinstance(x, tuple)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert flat_t == flat_j
    assert sum(int(np.prod(shape)) for _, (shape, _) in flat_t) == NEW[name]


@pytest.mark.parametrize("name", sorted(NEW))
def test_init_and_bridge_agree_on_the_tree(name):
    """``LM.init`` and the bridge make the same tree (names, shapes,
    dtypes) at ``.reduced()``, and ``init`` alone gives a working model."""
    _, _, lm, tp = _pair(name)
    mine = lm.init(0)
    spec = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    bridged = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert jax.tree_util.tree_leaves_with_path(spec) == \
        jax.tree_util.tree_leaves_with_path(bridged)
    logits, _ = lm.forward(mine, _t(_batch(lm.cfg, 7)))
    assert bool(torch.isfinite(logits).all())


def test_bridge_refuses_a_wrong_codebook_table():
    _, jp, lm, _ = _pair("musicgen-medium")
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"]["table"] = bad["embed"]["table"][:3]
    with pytest.raises(ValueError, match="embed/table"):
        params_from_numpy(bad, lm.cfg, "cpu")


# -- tests/test_models_smoke.py over the ten assigned architectures --------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward_smoke(arch):
    """A reduced variant of each family: one forward on a synthetic batch
    (``make_batch``) gives logits of the right shape, all finite."""
    cfg = tcfg.get_config(arch).reduced()
    lm = LM(cfg, device="cpu")
    params = lm.init(0)
    batch = make_batch(torch.Generator().manual_seed(0), cfg, B, S)
    logits, _ = lm.forward(params, batch)
    if cfg.frontend.kind == "audio":
        want = (B, S, cfg.frontend.num_codebooks, cfg.padded_vocab)
    else:
        want = (B, S, cfg.padded_vocab)
    assert tuple(logits.shape) == want
    assert bool(torch.isfinite(logits).all())
    assert (batch["labels"][:, -1] == -1).all()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_step_smoke(arch):
    """One decode step from an empty cache: finite logits, the cache keeps
    its structure and storage, and some leaf changed."""
    cfg = tcfg.get_config(arch).reduced()
    lm = LM(cfg, device="cpu")
    params = lm.init(0)
    caches = lm.init_cache(B, 32)
    before = [t.clone() for t in jax.tree.leaves(caches)]
    ptrs = [t.data_ptr() for t in jax.tree.leaves(caches)]
    shape = ((B, 1, cfg.frontend.num_codebooks)
             if cfg.frontend.kind == "audio" else (B, 1))
    logits, new = lm.decode_step(params, caches,
                                 torch.zeros(shape, dtype=torch.int32), 0)
    assert bool(torch.isfinite(logits).all())
    assert jax.tree.structure(new) == jax.tree.structure(caches)
    assert [t.data_ptr() for t in jax.tree.leaves(new)] == ptrs
    assert any(not torch.equal(a, b)
               for a, b in zip(before, jax.tree.leaves(new)))


# -- the engines serve text-token streams ------------------------------------------

def _engines():
    from repro.serving import DrainBatchEngine as JaxDrain
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.serving import DrainBatchEngine, ServingEngine
    return (ServingEngine, JaxEngine), (DrainBatchEngine, JaxDrain)


@pytest.mark.parametrize("which", ["continuous", "drain", "draft"])
def test_engines_refuse_audio_with_repros_message(which):
    """Audio: both packages' engines refuse at construction, with the same
    message (a draft model with audio too)."""
    jlm, jp, lm, tp = _pair("musicgen-medium")
    (ours, theirs), (drain, jdrain) = _engines()
    kw = dict(batch_slots=2, max_seq_len=32)
    if which == "draft":
        tlm, tparams = _pair("xlstm-125m")[2:]
        jt, jtp = _pair("xlstm-125m")[:2]
        calls = [lambda: ours(tlm, tparams, draft_model=lm, draft_params=tp,
                              speculative_tokens=2, **kw),
                 lambda: theirs(jt, jtp, draft_model=jlm, draft_params=jp,
                                speculative_tokens=2, **kw)]
    else:
        mine, ref = (ours, theirs) if which == "continuous" else (drain,
                                                                  jdrain)
        calls = [lambda: mine(lm, tp, **kw), lambda: ref(jlm, jp, **kw)]
    messages = []
    for call in calls:
        with pytest.raises(NotImplementedError) as err:
            call()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "text-token streams" in messages[0]


@pytest.mark.parametrize("which", ["continuous", "chunked", "drain"])
def test_engines_refuse_vision_and_name_why(which):
    """Vision: the port's engines refuse at construction (``repro``'s take
    the model and then fail on it, next test), naming both of
    ``repro``'s failures and where vision is served instead."""
    _, _, lm, tp = _pair("internvl2-2b")
    (ours, _), (drain, _) = _engines()
    kw = dict(batch_slots=2, max_seq_len=32)
    with pytest.raises(NotImplementedError) as err:
        if which == "drain":
            drain(lm, tp, **kw)
        else:
            ours(lm, tp, chunk_tokens=8 if which == "chunked" else None,
                 **kw)
    msg = str(err.value)
    assert "KeyError on 'image_embeds'" in msg and "chunked" in msg
    assert "CascadeEngine.query" in msg


@pytest.mark.parametrize("mode", ["monolithic", "chunked", "paged",
                                  "drain"])
def test_repros_engines_fail_on_a_vision_model(mode):
    """``repro``'s behaviour behind the port's refusal (ROADMAP Queue 3):
    its engines accept a vision model and fail with a ``KeyError`` on
    ``image_embeds`` before any token is served: the ring and paged
    backends trace a tokens-only prefill for the cache structure at
    construction (chunked or not), the drain batcher prefills tokens
    alone."""
    from repro.serving import DrainBatchEngine as JaxDrain
    from repro.serving import ServingEngine as JaxEngine

    jlm, jp, _, _ = _pair("internvl2-2b")
    kw = dict(batch_slots=2, max_seq_len=32)
    with pytest.raises(KeyError, match="image_embeds"):
        if mode == "drain":
            eng = JaxDrain(jlm, jp, **kw)
        else:
            eng = JaxEngine(jlm, jp, chunk_tokens=None if mode ==
                            "monolithic" else 8,
                            cache_backend="paged" if mode == "paged"
                            else "ring", **kw)
        eng.submit(np.arange(9, dtype=np.int32), max_new_tokens=3)
        eng.run()
