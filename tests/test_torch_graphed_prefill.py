"""The port's prefill programs, on the CPU, against ``repro``.

On the card ``warm_compile`` captures every program of the engines as a
CUDA graph: the admission, the prompt chunk and the draft fill of
``ServingEngine``, the cascade's gate and ``DrainBatchEngine``'s prefill,
sample and decode step, beside the decode programs. A graph replays its launches at
fixed addresses, so a program may read only staged device tensors, and
may neither sync the host nor take a shape from the data. These tests
hold what that rests on, on the CPU (where each program is the eager
call):

- the fixed-shape ring install (``models.attention.cache_fill``) equals
  ``repro``'s scatter at lengths below, at and above the ring's width,
  several rows at once, exactly;
- the fixed-shape paged install (``PagedCache.prefill_fill``) equals
  ``repro``'s in every block but the trash block 0, whose positions stay
  all -1, exactly;
- ``warm_compile`` registers exactly the admissions, chunks and draft
  fills that ``repro``'s jits compile (counted by ``_cache_size``), and
  sampled traffic registers nothing more;
- every program body runs under a dispatch mode that raises on a host
  sync or a data-dependent shape;
- after ``warm_compile`` the streams equal ``repro``'s on the ring, the
  chunked paged engine, the hybrid (teacher-forced, as
  ``tests/test_torch_hybrid_engine.py`` holds it), under speculation and
  through the cascade's gate: greedy tokens equal up to the first step
  where ``repro``'s top-2 logit margin is within 1e-4 (f32, as in
  ``tests/test_torch_engine.py``).

Models are tiny, their weights bridged from ``repro``'s ``LM.init``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.cascade.ecc_infer import CascadeLM as JaxCascadeLM  # noqa: E402
from repro.cascade.ecc_infer import edge_variant as jax_edge  # noqa: E402
from repro.cascade.gate import make_thresholds as jax_thresholds  # noqa: E402
from repro.configs import base as jb  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import CascadeServingEngine as JaxCascade  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.kv_cache import PagedCache as JaxPaged  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeServingEngine,  # noqa: E402
                                 DrainBatchEngine, ServingEngine)
from repro_torch.serving.kv_cache import PagedCache  # noqa: E402

TOL = 1e-4
aten = torch.ops.aten


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers sharing the
    cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(pkg, layers, window=None):
    """A tiny f32 config; ``window`` makes layer 0 a windowed layer."""
    fields = dict(name="tiny", family="dense", source="t",
                  num_layers=layers, d_model=32, num_heads=4, num_kv_heads=2,
                  head_dim=8, d_ff=64, vocab_size=64, param_dtype="float32")
    if window is None:
        return pkg.ModelConfig(**fields, stages=pkg.dense_stages(layers))
    win = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.SWIGLU, window=window)
    full = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.SWIGLU)
    return pkg.ModelConfig(**fields, stages=(
        pkg.Stage(blocks=(win, full), repeat=layers // 2),))


def _hybrid(pkg):
    """(rglru, rglru, attn window 8), GeGLU (tests/test_torch_hybrid_engine
    .py's config)."""
    rec = pkg.BlockDef(mixer=pkg.RGLRU, mlp=pkg.GELU_MLP)
    win = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.GELU_MLP, window=8)
    return pkg.ModelConfig(
        name="tiny-hybrid", family="hybrid", source="t", num_layers=3,
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=96, stages=(pkg.Stage(blocks=(rec, rec, win), repeat=1),),
        param_dtype="float32", logit_softcap=30.0)


@functools.lru_cache(maxsize=None)
def _pair(kind, seed):
    """(repro LM, params, port LM, bridged params)."""
    make = {"dense": lambda p: _dense(p, 2),
            "windowed": lambda p: _dense(p, 2, window=8),
            "draft": lambda p: _dense(p, 1), "hybrid": _hybrid}[kind]
    jlm = JaxLM(make(jb), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(seed))
    tc = make(tcfg.base)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _trace(n, seed, span=(3, 20), budgets=(3, 12), vocab=60):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(*span))).astype(
        np.int32), int(rng.integers(*budgets))) for _ in range(n)]


def _serve(eng, trace, temperature=0.0):
    ids = [eng.submit(p, max_new_tokens=m, temperature=temperature)
           for p, m in trace]
    done = eng.run()
    return [done[i].output for i in ids]


def _margin_rule(forward, trace, ours, theirs):
    """Greedy streams agree up to their first difference, which must sit on
    a near-tie (top-2 margin <= TOL) of ``repro``'s teacher-forced logits
    (``forward(tokens)``, jitted). Returns the tokens compared."""
    compared = 0
    for (prompt, _), a, b in zip(trace, ours, theirs):
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        upto = diff[0] if len(diff) else len(a)
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None].astype(np.int32)
            top = np.sort(np.asarray(forward(ctx))[0, -1].astype(np.float64))
            assert top[-1] - top[-2] <= TOL, (upto, a, b)
    return compared


def _forward(jlm, jp):
    return jax.jit(lambda t: jlm.forward(jp, {"tokens": t})[0])


# -- the fixed-shape installs ------------------------------------------------

@pytest.mark.parametrize("s,lengths", [
    (6, (1, 4, 6)),             # below the ring's width 8
    (8, (8, 3, 5)),             # at it
    (20, (20, 13, 8)),          # above it: the ring wraps
    (20, (2, 9, 17)),
    (20, None),                 # above it, no lengths
])
def test_ring_cache_fill_equals_repro(s, lengths):
    """``cache_fill`` into an 8-wide ring, three rows of different true
    lengths, equals ``repro``'s scatter in K, V and positions, exactly."""
    rng = np.random.default_rng(s)
    b, width = 3, 8
    k = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
    v = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
    ours = att.init_kv_cache(b, width, 2, 4, torch.float32, "cpu")
    ours["pos"].fill_(7)                  # stale content: every path resets
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    att.cache_fill(ours, torch.from_numpy(k), torch.from_numpy(v), s,
                   None if lens is None else torch.from_numpy(lens))
    theirs = jatt.cache_fill(
        {key: jnp.asarray(t.numpy()) for key, t in ours.items()},
        jnp.asarray(k), jnp.asarray(v), s,
        None if lens is None else jnp.asarray(lens))
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))


def test_paged_prefill_fill_equals_repro():
    """``PagedCache.prefill_fill`` of a prefilled request (a windowed layer
    whose ring wrapped, and a full one; bucket 16, true length 13) into a
    pool holding stale positions, through a table row of 4 blocks: every
    block but 0 equals ``repro``'s install, K, V and positions, and block
    0's positions are all -1. With a row of -1 only (a warm-up) nothing
    changes but block 0's positions, which stay -1."""
    jlm, jp, lm, tp = _pair("windowed", 4)
    kw = dict(batch_slots=2, max_seq_len=32, block_size=4)
    ours = PagedCache(lm, **kw)
    theirs = JaxPaged(jlm, jp, **kw)
    state = ours.init()
    rng = np.random.default_rng(0)
    for leaf in (c["pos"] for stage in state["caches"] for c in stage):
        leaf.copy_(torch.from_numpy(rng.integers(0, 32, leaf.shape).astype(
            np.int32)))
    leaf[:, 0] = -1
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    tokens = torch.from_numpy(rng.integers(0, 60, (1, 16)).astype(np.int32))
    _, one = lm.prefill(tp, {"tokens": tokens}, cache_width=32,
                        lengths=torch.tensor([13], dtype=torch.int32))
    jone = jax.tree.map(lambda t: jnp.asarray(t.numpy()), one)
    row = np.array([5, 2, 9, 7, -1, -1, -1, -1], np.int32)
    state = ours.prefill_fill(state, one, torch.tensor([1]),
                              torch.tensor([13], dtype=torch.int32),
                              torch.from_numpy(row))
    jstate = theirs.prefill_fill(jstate, jone, 1, 13, jnp.asarray(row))
    np.testing.assert_array_equal(state["tables"].numpy(),
                                  np.asarray(jstate["tables"]))
    for stage, jstage in zip(state["caches"], jstate["caches"]):
        for c, jc in zip(stage, jstage):
            for key in ("k", "v", "pos"):
                np.testing.assert_array_equal(c[key][:, 1:].numpy(),
                                              np.asarray(jc[key])[:, 1:])
            assert (c["pos"][:, 0] == -1).all()
    before = [{k: t.clone() for k, t in c.items()}
              for stage in state["caches"] for c in stage]
    state = ours.prefill_fill(state, one, torch.tensor([0]),
                              torch.tensor([13], dtype=torch.int32),
                              torch.full((8,), -1, dtype=torch.int32))
    for old, c in zip(before, (c for st in state["caches"] for c in st)):
        for key in ("k", "v", "pos"):
            torch.testing.assert_close(c[key][:, 1:], old[key][:, 1:],
                                       rtol=0, atol=0)
        assert (c["pos"][:, 0] == -1).all()
    assert (state["tables"][0] == -1).all()


# -- the program set ---------------------------------------------------------

@pytest.mark.parametrize("prefill", ["monolithic", "chunked"])
def test_warm_compile_builds_the_programs_repro_compiles(prefill):
    """A speculative engine (k = 2), monolithic on the ring or
    chunked (8-token chunks) on the paged backend: after ``warm_compile``
    the port registers one chunk program per executable ``repro``'s
    ``_chunk_fn`` compiled and one draft fill per ``_draft_fill_fn``
    executable; after sampled traffic over every prompt bucket, one
    admission per ``_admit_fn`` executable (``repro`` compiles those at
    first use), and traffic registers no further program."""
    jt, jtp, tgt, tp = _pair("dense", 0)
    jd, jdp, drf, dp = _pair("draft", 7)
    kw = dict(max_seq_len=32, min_bucket=4, batch_slots=4,
              speculative_tokens=2)
    if prefill == "chunked":
        kw.update(cache_backend="paged", block_size=8, chunk_tokens=8)
    eng = ServingEngine(tgt, tp, draft_model=drf, draft_params=dp, **kw)
    jeng = JaxEngine(jt, jtp, draft_model=jd, draft_params=jdp, **kw)
    for e in (eng, jeng):
        e.scheduler.spec_min_commit = 0.0
        e.warm_compile()

    def kinds():
        out = {}
        for key in eng._programs:
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    warm = kinds()
    assert warm.get("chunk", 0) == jeng._chunk_fn._cache_size()
    assert warm["draft_fill"] == jeng._draft_fill_fn._cache_size() == len(
        eng.buckets)
    assert ("admit" in warm) == (prefill == "monolithic")
    programs = dict(eng._programs)
    # a prompt in every bucket (4, 8, 16, 32), then a sampled trace
    trace = [(np.arange(n, dtype=np.int32) % 60, 4)
             for n in (3, 7, 12, 25)] + _trace(6, seed=3, budgets=(3, 9))
    for e in (eng, jeng):
        _serve(e, trace, temperature=0.9)
    assert eng._programs == programs, "traffic registered a program"
    assert eng.spec_rounds > 0
    if prefill == "monolithic":
        assert warm["admit"] == jeng._admit_fn._cache_size() == len(
            eng.buckets)
    else:
        assert jeng._chunk_fn._cache_size() == warm["chunk"]


# -- no host sync, no data-dependent shape -------------------------------------

class _NoHostSync(TorchDispatchMode):
    """Raises on what a CUDA graph cannot capture: a device-to-host read
    (``_local_scalar_dense``: ``.item()``, ``int()``, ``bool()`` of a
    tensor; a copy to the CPU from another device) and an op whose output
    shape depends on the data (``nonzero``, ``masked_select``, a boolean
    mask as an index)."""

    BANNED = {aten._local_scalar_dense.default, aten.nonzero.default,
              aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise AssertionError(f"host sync or data-dependent shape: {func}")
        if func in (aten.index.Tensor, aten.index_put_.default,
                    aten.index_put.default):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in args[1]):
                raise AssertionError(f"boolean mask index: {func}")
        if func is aten._to_copy.default and args[0].device.type != "cpu" \
                and str(kwargs.get("device", "")) == "cpu":
            raise AssertionError("device-to-host copy")
        return func(*args, **kwargs)


def _engines():
    """name -> (a warmed engine with staged arguments for a long admission,
    its program keys)."""
    _, _, lm, tp = _pair("dense", 0)
    _, _, wlm, wtp = _pair("windowed", 4)
    _, _, drf, dp = _pair("draft", 7)
    _, _, hyb, hp = _pair("hybrid", 3)
    spec = dict(draft_model=drf, draft_params=dp, speculative_tokens=2)
    edge = LM(edge_variant(lm.cfg, layers=1), device="cpu")
    return {
        "ring": lambda: ServingEngine(lm, tp, max_seq_len=32, min_bucket=4,
                                      batch_slots=2, **spec),
        "ring windowed": lambda: ServingEngine(wlm, wtp, max_seq_len=32,
                                               min_bucket=4, batch_slots=2),
        "ring chunked": lambda: ServingEngine(lm, tp, max_seq_len=32,
                                              min_bucket=4, batch_slots=2,
                                              chunk_tokens=8),
        "paged": lambda: ServingEngine(wlm, wtp, max_seq_len=32,
                                       min_bucket=4, batch_slots=2,
                                       cache_backend="paged", block_size=4),
        "paged chunked": lambda: ServingEngine(
            lm, tp, max_seq_len=32, min_bucket=4, batch_slots=2,
            cache_backend="paged", block_size=4, chunk_tokens=8, **spec),
        "hybrid": lambda: ServingEngine(hyb, hp, max_seq_len=32,
                                        min_bucket=4, batch_slots=2),
        "cascade": lambda: CascadeServingEngine(
            CascadeLM(edge, lm), edge.init(1), tp, batch_slots=2,
            max_seq_len=32),
        "drain": lambda: DrainBatchEngine(wlm, wtp, batch_slots=2,
                                          max_seq_len=32),
    }


@pytest.mark.parametrize("name", ["ring", "ring windowed", "ring chunked",
                                  "paged", "paged chunked", "hybrid",
                                  "cascade", "drain"])
def test_program_bodies_never_sync_the_host(name):
    """Every program body of the engine (``program_keys``: decode rounds,
    admissions, chunks, draft fills, the gate, the drain batch's prefill
    sample and decode step) runs under ``_NoHostSync``, its arguments staged for the
    longest prompt its shape holds (up to 27 tokens: the windowed ring
    wraps at 8) into slot 1, a chunk ending at its context bound, a draft
    fill reading two generated tokens."""
    eng = _engines()[name]()
    keys = eng.program_keys()
    assert keys
    prompt = np.arange(32, dtype=np.int32) % 60
    for key in keys:
        n = min(27, key[1]) if key[0] not in ("decode", "spec", "sample", "forward") \
            else 1
        if name == "cascade":
            eng._gate_args.put(length=n, tokens=prompt[:n])
        elif name == "drain":
            tokens = np.zeros((2, 32), np.int32)
            tokens[0, :n] = prompt[:n]
            eng._args.put(lengths=[n, 1], temp=[0.0, 0.7], tokens=tokens)
        else:
            row = np.full(eng._args["row"].numel(), -1)
            if eng.backend.supports_swap:
                row[:7] = np.arange(1, 8)
            start = key[2] - key[1] if key[0] == "chunk" else 0
            eng._args.put(slot=1, length=n, start=start,
                          prompt_len=max(1, n - 2) if key[0] == "draft_fill"
                          else start + n, max_new=3, rid=5, final=1,
                          temp=0.7, row=row, tokens=prompt[:n])
        with _NoHostSync():
            eng._program_body(key)


# -- streams after warm_compile --------------------------------------------------

STREAM_CASES = {
    "ring": ("dense", {}),
    "paged chunked": ("dense", dict(cache_backend="paged", block_size=8,
                                    chunk_tokens=8, max_decode_steps=4)),
    "speculative": ("dense", dict(speculative_tokens=2)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streams_after_warm_compile_equal_repro(case):
    """Greedy streams of a warmed port engine equal a warmed ``repro``
    engine's under the margin rule: the ring (monolithic), the chunked
    paged engine (K = 4) and the ring with a draft (k = 2, forced on)."""
    kind, extra = STREAM_CASES[case]
    jlm, jp, lm, tp = _pair(kind, 0)
    kw = dict(max_seq_len=64, min_bucket=4, batch_slots=3, **extra)
    if "speculative_tokens" in extra:
        jd, jdp, drf, dp = _pair("draft", 7)
        ours = ServingEngine(lm, tp, draft_model=drf, draft_params=dp, **kw)
        theirs = JaxEngine(jlm, jp, draft_model=jd, draft_params=jdp, **kw)
    else:
        ours, theirs = ServingEngine(lm, tp, **kw), JaxEngine(jlm, jp, **kw)
    trace = _trace(7, seed=17)
    outs = []
    for e in (ours, theirs):
        e.scheduler.spec_min_commit = 0.0
        e.warm_compile()
        outs.append(_serve(e, trace))
    if "speculative_tokens" in extra:
        assert ours.spec_rounds > 0
    assert _margin_rule(_forward(jlm, jp), trace, *outs) >= 30


def test_hybrid_streams_after_warm_compile_equal_teacher_forced_repro():
    """The hybrid (two RG-LRU layers and a windowed attention layer) on a
    warmed ring engine, prompts of 1-40 tokens (the window is 8): each
    greedy token equals the argmax of ``repro``'s teacher-forced forward
    over prompt + the stream so far, wherever the top-2 margin exceeds
    TOL (``repro``'s engine taints non-bucket prompts)."""
    jlm, jp, lm, tp = _pair("hybrid", 3)
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=64, min_bucket=4,
                        max_decode_steps=4)
    eng.warm_compile()
    trace = [(np.random.default_rng(n).integers(0, 96, n).astype(np.int32), 5)
             for n in (1, 7, 16, 23, 40)]
    outs = _serve(eng, trace)
    fwd = _forward(jlm, jp)
    checked = 0
    for (prompt, _), out in zip(trace, outs):
        ctx = np.concatenate([prompt, out]).astype(np.int32)[None]
        logits = np.asarray(fwd(ctx))[0].astype(np.float64)
        for i, tok in enumerate(out):
            row = logits[len(prompt) - 1 + i]
            top = np.sort(row)
            if top[-1] - top[-2] > TOL:
                assert tok == int(np.argmax(row)), (len(prompt), i)
                checked += 1
    assert checked >= 20


def test_cascade_gate_after_warm_compile_equals_repro():
    """A warmed port cascade (the gate captured at every edge bucket) and
    a warmed ``repro`` cascade, thresholds between the port's confidence
    tertiles at their widest gaps: the same route per request, and greedy
    accepted and escalated streams equal under the margin rule."""
    jlm, jp, lm, tp = _pair("dense", 0)
    te = LM(edge_variant(lm.cfg, layers=1), device="cpu")
    je = JaxLM(jax_edge(_dense(jb, 2), layers=1), kv_chunk=8)
    jep = jax.jit(lambda k: je.init(k)[0])(jax.random.PRNGKey(1))
    tep = params_from_numpy(jax.tree.map(np.asarray, jep), te.cfg, "cpu")
    trace = _trace(9, seed=5, span=(3, 30))
    kw = dict(batch_slots=2, max_seq_len=64)
    probe = CascadeServingEngine(CascadeLM(te, lm), tep, tp, **kw)
    conf = np.sort([probe._gate(p)[0] for p, _ in trace])
    gaps = np.diff(conf)
    lo_i = 1 + int(np.argmax(gaps[1:4]))
    hi_i = 5 + int(np.argmax(gaps[5:8]))
    hi = float(conf[hi_i] + conf[hi_i + 1]) / 2
    lo = float(conf[lo_i] + conf[lo_i + 1]) / 2
    ours = CascadeServingEngine(
        CascadeLM(te, lm, thresholds=make_thresholds(hi, lo)), tep, tp, **kw)
    theirs = JaxCascade(JaxCascadeLM(je, jlm, thresholds=jax_thresholds(
        hi, lo)), jep, jp, **kw)
    for e in (ours, theirs):
        e.warm_compile()
    th = ours.cascade.thresholds
    assert {k for k in ours._programs} == {
        ("gate", b, th.hi, th.lo) for b in ours.edge_engine.buckets}
    programs = dict(ours._programs)
    a = [ours.submit(p, max_new_tokens=m) for p, m in trace]
    b = [theirs.submit(p, max_new_tokens=m) for p, m in trace]
    da, db = ours.run(), theirs.run()
    assert ours._programs == programs
    routes = [da[i].route for i in a]
    assert routes == [db[i].route for i in b]
    assert {"accept", "escalate", "drop"} <= set(routes)
    compared = 0
    for route, fwd in (("accept", _forward(je, jep)),
                       ("escalate", _forward(jlm, jp))):
        mine = [j for j, r in enumerate(routes) if r == route]
        compared += _margin_rule(fwd, [trace[j] for j in mine],
                                 [da[a[j]].output for j in mine],
                                 [db[b[j]].output for j in mine])
    assert compared >= 15
