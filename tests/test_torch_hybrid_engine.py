"""The port's ServingEngine serving a hybrid model (RG-LRU + windowed
attention, GeGLU) on the ring backend, on the CPU, against ``repro``.

``repro``'s engine prefills a prompt right-padded to its bucket, and its
RG-LRU block returns the state of the *padded* sequence, so its streams
are wrong whenever a prompt's length is not a bucket size (ROADMAP Queue
3). The port keeps the state after the last real token. So its greedy
streams are held to ``repro``'s engine on bucket-length prompts only, and
on every prompt length to teacher-forced greedy from ``repro``'s
``LM.forward``, wherever ``repro``'s top-2 logit margin exceeds the logits
tolerance (1e-4 in f32, as in ``tests/test_torch_engine.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jb  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

TOL = 1e-4
KW = dict(batch_slots=2, max_seq_len=64)
MAX_NEW = 6
BUCKET_LENGTHS = (16, 32)
OTHER_LENGTHS = (1, 2, 5, 11, 20)


def _cfg(pkg):
    """(rglru, rglru, attn window 8), GeGLU, d_model 64, f32."""
    rec = pkg.BlockDef(mixer=pkg.RGLRU, mlp=pkg.GELU_MLP)
    att = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.GELU_MLP, window=8)
    return pkg.ModelConfig(
        name="tiny-hybrid", family="hybrid", source="t", num_layers=3,
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=96, stages=(pkg.Stage(blocks=(rec, rec, att), repeat=1),),
        param_dtype="float32", logit_softcap=30.0)


@functools.lru_cache(maxsize=None)
def _models():
    jlm = JaxLM(_cfg(jb), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(3))
    tc = _cfg(tcfg.base)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _prompts(lengths):
    return [np.random.default_rng(n).integers(0, 96, n).astype(np.int32)
            for n in lengths]


def _serve(engine, reqs):
    ids = [engine.submit(p, max_new_tokens=n, temperature=t)
           for p, n, t in reqs]
    done = engine.run()
    assert sorted(done) == sorted(ids)
    assert all(done[i].status == "done" for i in ids)
    return [done[i].output for i in ids]


def _greedy(engine, prompts):
    return _serve(engine, [(p, MAX_NEW, 0.0) for p in prompts])


@functools.lru_cache(maxsize=None)
def _teacher_forced():
    """repro's ``LM.forward`` as a function of the context."""
    jlm, jp, _, _ = _models()
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    return lambda ctx: np.asarray(fwd(jp, ctx[None]))[0]


def _agrees_with_forward(prompt, stream):
    """The first step where ``stream`` leaves teacher-forced greedy with a
    clear margin, or None; and how many steps were held to it."""
    fwd = _teacher_forced()
    logits = fwd(np.concatenate([prompt, stream[:-1]]).astype(np.int32))
    tail = logits[len(prompt) - 1:]
    top2 = np.sort(tail, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > TOL
    wrong = np.flatnonzero(sure & (tail.argmax(-1) != stream))
    return (int(wrong[0]) if len(wrong) else None), int(sure.sum())


def test_greedy_streams_equal_repro_engine_on_bucket_lengths():
    jlm, jp, lm, tp = _models()
    prompts = _prompts(BUCKET_LENGTHS)
    ours = _greedy(ServingEngine(lm, tp, **KW), prompts)
    theirs = _greedy(JaxEngine(jlm, jp, **KW), prompts)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_greedy_streams_equal_teacher_forced_repro_at_every_length():
    """Every prompt length, 5 and 11 among them: the port's stream is
    teacher-forced greedy of ``repro``'s forward. ``repro``'s own engine
    leaves it on a prompt that is not a bucket size (the reference fault)."""
    jlm, jp, lm, tp = _models()
    prompts = _prompts(OTHER_LENGTHS + BUCKET_LENGTHS)
    ours = _greedy(ServingEngine(lm, tp, **KW), prompts)
    held = 0
    for prompt, stream in zip(prompts, ours):
        wrong, n = _agrees_with_forward(prompt, stream)
        assert wrong is None, (len(prompt), wrong)
        held += n
    assert held >= 0.9 * MAX_NEW * len(prompts)
    theirs = _greedy(JaxEngine(jlm, jp, **KW), _prompts((5, 11)))
    assert any(_agrees_with_forward(p, s)[0] is not None
               for p, s in zip(_prompts((5, 11)), theirs))


@pytest.mark.parametrize("k", [2, 4])
def test_k_step_decode_equals_one_step(k):
    """K-step rounds equal one-step rounds with sampled and greedy
    requests, slots reused across admissions (the recurrent state of a
    finished tenant is overwritten, never read)."""
    _, _, lm, tp = _models()
    prompts = _prompts(OTHER_LENGTHS + BUCKET_LENGTHS)
    reqs = [(p, 3 + 2 * i, 0.0 if i % 2 else 1.5)
            for i, p in enumerate(prompts)]
    kw = dict(KW, batch_slots=3, seed=7)
    one = ServingEngine(lm, tp, **kw)
    many = ServingEngine(lm, tp, max_decode_steps=k, **kw)
    for a, b in zip(_serve(one, reqs), _serve(many, reqs)):
        np.testing.assert_array_equal(a, b)
    assert many.host_syncs < one.host_syncs


def test_inactive_slots_keep_their_recurrent_state():
    """A slot that is not decoding keeps its ``h`` and ``conv`` through
    other slots' decode steps (the ``valid`` mask of ``decode_step``)."""
    _, _, lm, tp = _models()
    eng = ServingEngine(lm, tp, **KW)
    eng.submit(_prompts((5,))[0], max_new_tokens=2)
    eng.submit(_prompts((11,))[0], max_new_tokens=12)
    for _ in range(3):
        eng.step()
    caches = eng._cache_state["caches"]
    idle = [s for s in range(2) if not bool(eng._state["active"][s])]
    assert len(idle) == 1
    before = caches[0][0]["h"][:, idle[0]].clone()
    eng.step()
    assert torch.equal(caches[0][0]["h"][:, idle[0]], before)
    eng.run()


def test_chunked_paged_and_speculative_refuse_recurrent_mixers():
    _, _, lm, tp = _models()
    with pytest.raises(NotImplementedError, match="chunked prefill needs "
                                                  "attention mixers"):
        ServingEngine(lm, tp, chunk_tokens=4, **KW)
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        ServingEngine(lm, tp, cache_backend="paged", **KW)
    with pytest.raises(NotImplementedError, match="folds tokens "
                                                  "sequentially"):
        ServingEngine(lm, tp, draft_model=lm, draft_params=tp,
                      speculative_tokens=2, **KW)
