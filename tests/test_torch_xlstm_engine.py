"""The port's engines serving ``xlstm-125m`` (``.reduced()``: one (mLSTM,
sLSTM) repeat, d_model 256, 4 heads of 64, f32) on the ring backend, on
the CPU, against ``repro``.

``repro``'s mLSTM and sLSTM blocks ignore ``lengths``, so its engine's
state after a prompt right-padded to its bucket has folded the pads in
(ROADMAP Queue 3), as its RG-LRU's does. The port keeps the state after
the last real token. So the port's greedy streams are held to ``repro``'s
engine on bucket-length prompts only, and on every prompt length to
teacher-forced greedy from ``repro``'s ``LM.forward`` wherever its top-2
margin exceeds the logits tolerance (1e-4 in f32), as in
``tests/test_torch_hybrid_engine.py``.

A recompute resume (ring preemption, snapshot -> restore) re-prefills
prompt plus generated tokens through the chunkwise mLSTM, where the
uninterrupted stream carried the sequential decode cell's state: the two
states differ by summation order, so the resumed stream is held to the
uninterrupted one under the near-tie rule (equal, or parted first where
``repro``'s teacher-forced top-2 margin is within 1e-4), not bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (DrainBatchEngine, ServingEngine,  # noqa: E402
                                 load_snapshot, save_snapshot)

TOL = 1e-4
KW = dict(batch_slots=2, max_seq_len=64)
MAX_NEW = 6
BUCKET_LENGTHS = (16, 32)
OTHER_LENGTHS = (1, 2, 5, 11, 20)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models():
    jlm = JaxLM(jax_get_config("xlstm-125m").reduced())
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(4))
    tc = tcfg.get_config("xlstm-125m").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _prompts(lengths):
    return [np.random.default_rng(n).integers(0, 500, n).astype(np.int32)
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
    logits = _teacher_forced()(
        np.concatenate([prompt, stream[:-1]]).astype(np.int32))
    tail = logits[len(prompt) - 1:]
    top2 = np.sort(tail, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > TOL
    wrong = np.flatnonzero(sure & (tail.argmax(-1) != stream))
    return (int(wrong[0]) if len(wrong) else None), int(sure.sum())


def _same_or_parted_at_near_tie(prompt, ours, base):
    """``ours`` equals ``base``, or parts first where ``repro``'s
    teacher-forced top-2 margin over ``base``'s context is within TOL."""
    diff = np.flatnonzero(ours != base)
    if not len(diff):
        return True
    p = int(diff[0])
    logits = _teacher_forced()(
        np.concatenate([prompt, base[:p]]).astype(np.int32))[-1]
    top2 = np.sort(logits)[-2:]
    return bool(top2[1] - top2[0] <= TOL)


def test_greedy_streams_equal_repro_engine_on_bucket_lengths():
    jlm, jp, lm, tp = _models()
    prompts = _prompts(BUCKET_LENGTHS)
    ours = _greedy(ServingEngine(lm, tp, **KW), prompts)
    theirs = _greedy(JaxEngine(jlm, jp, **KW), prompts)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_greedy_streams_equal_teacher_forced_repro_at_every_length():
    """Every prompt length: the port's stream is teacher-forced greedy of
    ``repro``'s forward. ``repro``'s own engine leaves it on a prompt that
    is not a bucket size (the reference fault)."""
    _, _, lm, tp = _models()
    prompts = _prompts(OTHER_LENGTHS + BUCKET_LENGTHS)
    ours = _greedy(ServingEngine(lm, tp, **KW), prompts)
    held = 0
    for prompt, stream in zip(prompts, ours):
        wrong, n = _agrees_with_forward(prompt, stream)
        assert wrong is None, (len(prompt), wrong)
        held += n
    assert held >= 0.9 * MAX_NEW * len(prompts)
    jlm, jp, _, _ = _models()
    theirs = _greedy(JaxEngine(jlm, jp, **KW), _prompts((5, 11)))
    assert any(_agrees_with_forward(p, s)[0] is not None
               for p, s in zip(_prompts((5, 11)), theirs))


@pytest.mark.parametrize("k", [2, 4])
def test_k_step_decode_equals_one_step(k):
    """K-step rounds equal one-step rounds with sampled and greedy
    requests, slots reused across admissions (a finished tenant's mLSTM
    and sLSTM state is overwritten, never read)."""
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


def test_drain_equals_continuous_greedy():
    """``DrainBatchEngine`` pads each batch to the longest prompt's bucket
    and passes the true lengths, so its recurrent state stops at each
    row's last real token: greedy streams equal the continuous engine's
    (the same f32 arithmetic, batched otherwise)."""
    _, _, lm, tp = _models()
    prompts = _prompts(OTHER_LENGTHS + BUCKET_LENGTHS)
    cont = _greedy(ServingEngine(lm, tp, **KW), prompts)
    drain = _greedy(DrainBatchEngine(lm, tp, batch_slots=3,
                                     max_seq_len=64), prompts)
    for prompt, a, b in zip(prompts, drain, cont):
        assert _same_or_parted_at_near_tie(prompt, a, b)


def test_inactive_slots_keep_their_recurrent_state():
    """A slot that is not decoding keeps its mLSTM ``C`` and sLSTM ``h``
    through other slots' decode steps (the ``valid`` mask)."""
    _, _, lm, tp = _models()
    eng = ServingEngine(lm, tp, **KW)
    eng.submit(_prompts((5,))[0], max_new_tokens=2)
    eng.submit(_prompts((11,))[0], max_new_tokens=12)
    for _ in range(3):
        eng.step()
    mlstm, slstm = eng._cache_state["caches"][0]
    idle = [s for s in range(2) if not bool(eng._state["active"][s])]
    assert len(idle) == 1
    before = (mlstm["C"][:, idle[0]].clone(), slstm["h"][:, idle[0]].clone())
    eng.step()
    assert torch.equal(mlstm["C"][:, idle[0]], before[0])
    assert torch.equal(slstm["h"][:, idle[0]], before[1])
    eng.run()


def test_warm_compile_registers_every_program_and_changes_no_stream():
    """``warm_compile`` builds the decode program at every horizon (greedy
    and sampled) and the admission at every bucket; traffic builds none,
    and the streams equal an engine that never warmed (on the card each
    program is a CUDA graph, ``tests/test_torch_gpu.py``)."""
    _, _, lm, tp = _models()
    prompts = _prompts(OTHER_LENGTHS + BUCKET_LENGTHS)
    reqs = [(p, 3 + i, 0.0 if i % 3 else 0.9)
            for i, p in enumerate(prompts)]
    kw = dict(KW, max_decode_steps=4, seed=3)
    base = _serve(ServingEngine(lm, tp, **kw), reqs)
    eng = ServingEngine(lm, tp, **kw)
    eng.warm_compile()
    want = ({("decode", k, s) for k in eng.scheduler.k_schedule
             for s in (False, True)}
            | {("admit", b) for b in eng.buckets})
    assert set(eng._programs) == want == set(eng.program_keys())
    out = _serve(eng, reqs)
    assert set(eng._programs) == want
    for a, b in zip(out, base):
        np.testing.assert_array_equal(a, b)
    drain = DrainBatchEngine(lm, tp, batch_slots=2, max_seq_len=64)
    drain.warm_compile()
    keys = set(drain._programs)
    assert keys == set(drain.program_keys())
    _greedy(drain, prompts[:3])
    assert set(drain._programs) == keys


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


def test_snapshot_restore_resumes_under_the_near_tie_rule(tmp_path):
    """Snapshot mid-flight through the .npz envelope, restore into a cold
    engine: every request finishes, and each stream equals the
    uninterrupted run's or parts first at a near-tie (the live slots
    re-prefill prompt + generated tokens through the chunkwise mLSTM)."""
    _, _, lm, tp = _models()
    prompts = _prompts((5, 11, 20, 32))
    kw = dict(KW, max_decode_steps=2, seed=1)
    base = _greedy(ServingEngine(lm, tp, **kw), prompts)
    eng1 = ServingEngine(lm, tp, **kw)
    for p in prompts:
        eng1.submit(p, max_new_tokens=MAX_NEW)
    for _ in range(3):
        eng1.step()
    save_snapshot(str(tmp_path), eng1.snapshot(), step=3)
    snap, _ = load_snapshot(str(tmp_path))
    eng2 = ServingEngine(lm, tp, **kw)
    info = eng2.restore(snap)
    assert info["live"] + info["terminal"] == len(prompts)
    done = eng2.run()
    assert len(done) == len(prompts)
    for rid, r in done.items():
        assert r.status == "done"
        assert _same_or_parted_at_near_tie(prompts[rid], r.output, base[rid])


def test_serve_cli_drains_xlstm(capsys):
    serve.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                "--requests", "4", "--max-new", "4", "--rate", "1000",
                "--quiet"])
    out = capsys.readouterr().out
    assert "served 4 arrivals" in out and "'done': 4" in out
