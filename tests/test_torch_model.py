"""The port's LM against ``repro``'s on weights carried across by
``repro_torch.bridge``: full forward, prefill (logits and installed
cache) and cached decode, in f32 on the CPU. Tolerance 1e-4 on logits of
order 1: the same f32 arithmetic, summed in another order (flash/dense
attention, BLAS)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers (two orders
    of magnitude slower under ``pytest -n``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(window=None):
    return dict(name="tiny", family="dense", source="t", num_layers=3,
                d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
                d_ff=96, vocab_size=128, param_dtype="float32",
                use_qk_norm=window is not None)


# the dense hd-128 zoo the port serves at full width on the card
ZOO = {"qwen3": "qwen3-4b", "glm4": "glm4-9b", "starcoder2": "starcoder2-7b"}
# the MoE models: mixtral (windowed GQA, softmax top-2 of 8) and deepseek
# (MLA, sigmoid top-8 of 256 plus a shared expert, MTP params)
MOE = {"mixtral": "mixtral-8x22b", "deepseek": "deepseek-v3-671b"}


def head_faithful(cfg):
    """``cfg`` cut to 2 layers, d_model 64, d_ff 128, vocab 512, f32, with
    its head layout kept: heads, KV heads, head_dim, window, qk-norm and
    tying (``.reduced()`` cuts every model to 4 heads at hd 64). The
    engine tests cut the same way."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-heads", num_layers=2, d_model=64, d_ff=128,
        vocab_size=512, param_dtype="float32",
        stages=(dataclasses.replace(cfg.stages[0], repeat=2),))


def _configs(which):
    """(repro config, port config) with equal fields."""
    if which == "smollm_reduced":
        return (jax_get_config("smollm-135m").reduced(),
                tcfg.get_config("smollm-135m").reduced())
    model, _, form = which.partition("_")
    if model in MOE:
        return (jax_get_config(MOE[model]).reduced(),
                tcfg.get_config(MOE[model]).reduced())
    if model in ZOO:
        jc, tc = jax_get_config(ZOO[model]), tcfg.get_config(ZOO[model])
        if form == "reduced":
            return jc.reduced(), tc.reduced()
        return head_faithful(jc), head_faithful(tc)
    window = 6 if which == "tiny_window" else None
    jc = ModelConfig(**_tiny(window), stages=dense_stages(3, window=window))
    tc = tcfg.ModelConfig(**_tiny(window),
                          stages=tcfg.dense_stages(3, window=window))
    return jc, tc


# the tiny dense config runs windowed with qk-norm (ring narrower than the
# prompt: masked install); smollm's reduced config covers the plain ring;
# the zoo in ``.reduced()`` form and head-faithful: qwen3 G = 4 with
# qk-norm and a tied table, glm4 G = 16, starcoder2 G = 9 with GeGLU and
# its 4096 window, all at hd 128
CONFIGS = ["tiny_window", "smollm_reduced"] + [
    f"{model}_{form}" for model in ZOO for form in ("reduced", "heads")] + [
    f"{model}_reduced" for model in MOE]


@functools.lru_cache(maxsize=None)
def _pair(which):
    """(repro LM, its params, port LM, bridged params), built once per
    config; tests read them and never write."""
    jc, tc = _configs(which)
    jlm = JaxLM(jc, kv_chunk=8)
    jparams = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    if tc.use_qk_norm:        # non-trivial qk-norm scales
        for st in jparams["stages"]:
            for key in ("q_scale", "k_scale"):
                leaf = st["b0"]["mixer"][key]
                st["b0"]["mixer"][key] = leaf + 0.1 * jnp.arange(
                    leaf.size, dtype=leaf.dtype).reshape(leaf.shape) / leaf.size
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")
    return jlm, jparams, LM(tc, device="cpu"), tparams


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("which", CONFIGS)
def test_forward_logits_match_repro(which):
    jlm, jp, lm, tp = _pair(which)
    tok = _tokens(2, 11, lm.cfg.vocab_size)
    theirs = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])(jp, tok)
    ours, _ = lm.forward(tp, {"tokens": torch.from_numpy(tok)})
    assert tuple(ours.shape) == (2, 11, lm.cfg.padded_vocab)
    assert np.max(np.abs(ours.numpy() - np.asarray(theirs))) < TOL


@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_and_decode_match_repro(which):
    """Prefill a right-padded batch with per-row lengths, then decode four
    tokens at per-row positions: logits and installed positions agree."""
    jlm, jp, lm, tp = _pair(which)
    width, s = 16, 8
    lengths = np.asarray([8, 6], np.int32)
    tok = _tokens(2, s, lm.cfg.vocab_size)
    jpre = jax.jit(lambda p, t, n: jlm.prefill(
        p, {"tokens": t}, cache_width=width, lengths=n))
    jlog, jcache = jpre(jp, tok, lengths)
    tlog, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                              cache_width=width,
                              lengths=torch.from_numpy(lengths))
    assert np.max(np.abs(tlog.numpy() - np.asarray(jlog))) < TOL
    np.testing.assert_array_equal(tcache[0][0]["pos"].numpy(),
                                  np.asarray(jcache[0][0]["pos"]))
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos))
    pos = lengths.copy()
    nxt = _tokens(2, 4, lm.cfg.vocab_size, seed=2)
    for i in range(4):
        feed = nxt[:, i:i + 1]
        jl, jcache = jstep(jp, jcache, feed, pos)
        tl, tcache = lm.decode_step(tp, tcache, torch.from_numpy(feed),
                                    torch.from_numpy(pos))
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL, i
        pos = pos + 1
    np.testing.assert_array_equal(tcache[0][0]["pos"].numpy(),
                                  np.asarray(jcache[0][0]["pos"]))


def test_prefill_then_decode_matches_full_forward():
    """The deployment identity of tests/test_serving.py, within the port:
    prefill(S) + decode(t) logits equal forward(S + t)."""
    lm = LM(_configs("tiny")[1], device="cpu")
    tp = lm.init(0)
    total, prompt = 12, 8
    tok = torch.from_numpy(_tokens(2, total, 100))
    full, _ = lm.forward(tp, {"tokens": tok})
    logits_p, caches = lm.prefill(tp, {"tokens": tok[:, :prompt]},
                                  cache_width=total)
    assert (logits_p[:, -1] - full[:, prompt - 1]).abs().max() < 1e-4
    for t in range(prompt, total):
        step, caches = lm.decode_step(tp, caches, tok[:, t:t + 1], t)
        assert (step[:, 0] - full[:, t]).abs().max() < 1e-4, t


def test_init_and_bridge_agree_on_the_tree():
    """``LM.init`` builds ``repro``'s tree (names, shapes, stacking); the
    bridge refuses a tree that is not it."""
    jlm, jp, lm, tp = _pair("smollm_reduced")
    ours = lm.init(0)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: tuple(x.shape), ours,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, tuple))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: tuple(x.shape), jp),
        is_leaf=lambda x: isinstance(x, tuple))
    assert flat_t == flat_j
    bad = jax.tree.map(np.asarray, jp)
    bad["stages"][0]["b0"]["mixer"]["wq"] = bad["stages"][0]["b0"]["mixer"][
        "wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, lm.cfg, "cpu")


@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_param_tree_matches_repro_at_full_width(model):
    """At full width and depth the port's ``param_spec`` names, shapes and
    dtypes are ``repro``'s ``LM.init`` tree (shapes only: nothing is
    allocated), and its parameter count is the model's."""
    name = ZOO[model]
    jlm = JaxLM(jax_get_config(name))
    theirs = jax.eval_shape(lambda k: jlm.init(k)[0], jax.random.PRNGKey(0))
    ours = LM(tcfg.get_config(name), device="cpu").param_spec()
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), theirs),
        is_leaf=lambda x: isinstance(x, tuple))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x[0]), str(x[1])[6:]), ours,
                     is_leaf=lambda x: isinstance(x, tuple)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert flat_t == flat_j
    count = sum(int(np.prod(shape)) for _, (shape, _) in flat_t)
    assert count == {"qwen3": 4_022_795_776, "glm4": 9_399_767_040,
                     "starcoder2": 10_116_960_768}[model]


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(tcfg.get_config("smollm-135m"))


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_param_tree_matches_repro_at_full_width(model):
    """The MoE models' full-width, full-depth ``param_spec`` against
    ``repro``'s ``LM.init`` tree (names, shapes, dtypes: the router f32;
    deepseek's MTP head included), and the parameter count."""
    name = MOE[model]
    jlm = JaxLM(jax_get_config(name))
    theirs = jax.eval_shape(lambda k: jlm.init(k)[0], jax.random.PRNGKey(0))
    ours = LM(tcfg.get_config(name), device="cpu").param_spec()
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), theirs),
        is_leaf=lambda x: isinstance(x, tuple))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: (tuple(x[0]), str(x[1])[6:]), ours,
                     is_leaf=lambda x: isinstance(x, tuple)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert flat_t == flat_j
    count = sum(int(np.prod(shape)) for _, (shape, _) in flat_t)
    assert count == {"mixtral": 140_630_071_296,
                     "deepseek": 671_712_655_360}[model]


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_aux_loss_matches_repro(model):
    """``forward(with_aux=True)`` sums the MoE layers' load-balance losses
    as ``repro``'s ``forward`` does."""
    jlm, jp, lm, tp = _pair(f"{model}_reduced")
    tok = _tokens(2, 11, lm.cfg.vocab_size)
    theirs = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[2])(jp, tok)
    _, _, aux = lm.forward(tp, {"tokens": torch.from_numpy(tok)},
                           with_aux=True)
    assert abs(float(aux) - float(theirs)) < 1e-5
    assert float(aux) > 0
