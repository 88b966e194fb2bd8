"""The port's paged KV pieces against ``repro``'s, on the same numpy inputs.

- The plain paged attention against ``repro.kernels.ref``'s oracle on every
  case of ``tests/test_paged_decode_attention.py`` plus chunk queries, a
  fragmented pool and a freed slot, and against ``repro``'s Pallas kernel
  in interpret mode on the cases marked ``PALLAS`` (about a second each on
  the CPU). Tolerance f32 1e-4, as ``repro`` holds its kernel to the
  oracle (streaming vs dense softmax, another summation order). Rows that
  see no key are 0 in all three.
- ``PagedLayout.append`` / ``context`` equal ``repro``'s bit for bit.
- ``PagedCache``'s allocator makes ``repro``'s decisions block for block
  through one seeded sequence of admissions, look-ahead top-ups, prefix
  registrations, frees and swaps: table rows, both free tiers, refcounts,
  the ledger, the prefix index and every counter. Its swap moves the K/V
  bytes exactly.

``tests/test_torch_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention as _pallas_paged)
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving.kv_cache import PagedCache as JaxPagedCache  # noqa: E402
from repro.serving.kv_cache import PagedLayout as JaxPagedLayout  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    gather_paged_kv, paged_decode_attention, paged_decode_attention_plain)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.kv_cache import PagedCache, PagedLayout  # noqa: E402

TOL = 1e-4

pallas_paged = jax.jit(_pallas_paged, static_argnames=(
    "window", "scale", "interpret"))
paged_ref = jax.jit(ref.paged_decode_attention_ref,
                    static_argnames=("window", "scale"))

# (h, kv, hd, bs, window, fills, t, shuffle): the cases of
# tests/test_paged_decode_attention.py (t = 1), its chunk cases (t > 1),
# a fragmented pool (shuffled block ids) and a freed slot (fill 0)
CASES = [
    (4, 4, 32, 16, None, (64, 64), 1, False),
    (4, 2, 32, 16, None, (26, 64), 1, False),
    (3, 1, 32, 16, None, (48, 5), 1, False),
    (4, 4, 32, 16, 24, (64, 64), 1, False),
    (8, 2, 64, 32, 16, (96, 40), 1, False),
    (4, 2, 16, 8, None, (1, 63), 1, False),
    (4, 2, 32, 16, None, (40, 64), 8, False),
    (4, 4, 32, 16, None, (26, 64), 5, False),
    (8, 2, 64, 32, 16, (96, 40), 8, False),
    (4, 2, 32, 16, None, (40, 64, 17), 1, True),
    (4, 2, 32, 16, None, (32, 0, 20), 4, True),
]
PALLAS = [CASES[4], CASES[5], CASES[8], CASES[10]]


def _pool(seed, h, kv, hd, bs, fills, t, shuffle):
    """A pool as the engine leaves it: block 0 is trash, slot s's token p
    at (table[s, p // bs], p % bs); a fill of 0 is a freed slot (row all
    -1). Each slot's t-token chunk ends at its last token."""
    rng = np.random.default_rng(seed)
    m = max(-(-f // bs) for f in fills)
    n = sum(-(-f // bs) for f in fills) + 1
    order = list(range(1, n))
    if shuffle:
        rng.shuffle(order)
    pos = np.full((n, bs), -1, np.int32)
    bt = np.full((len(fills), m), -1, np.int32)
    it = iter(order)
    for s, fill in enumerate(fills):
        for j in range(-(-fill // bs)):
            blk = next(it)
            bt[s, j] = blk
            tok = np.arange(j * bs, min(fill, (j + 1) * bs))
            pos[blk, tok - j * bs] = tok
    q = rng.standard_normal((len(fills), t, h, hd)).astype(np.float32)
    k = rng.standard_normal((n, bs, kv, hd)).astype(np.float32)
    v = rng.standard_normal((n, bs, kv, hd)).astype(np.float32)
    q_pos = np.asarray([max(f - t, 0) if t > 1 else max(f - 1, 0)
                        for f in fills], np.int32)
    return q, k, v, q_pos, pos, bt


def _case(case):
    h, kv, hd, bs, window, fills, t, shuffle = case
    arrs = _pool(0, h, kv, hd, bs, fills, t, shuffle)
    ours = paged_decode_attention(*(torch.from_numpy(a) for a in arrs),
                                  window=window).numpy()
    return ours, tuple(jnp.asarray(a) for a in arrs), fills


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_paged_plain_matches_oracle(case):
    ours, args, fills = _case(case)
    oracle = np.asarray(paged_ref(*args, window=case[4]))
    assert ours.shape == oracle.shape
    assert np.max(np.abs(ours - oracle)) < TOL
    for s, fill in enumerate(fills):
        if fill == 0:
            assert not ours[s].any()


@pytest.mark.parametrize("case", PALLAS, ids=[str(c) for c in PALLAS])
def test_paged_plain_matches_pallas_interpret(case):
    ours, args, _ = _case(case)
    pallas = np.asarray(pallas_paged(*args, window=case[4], interpret=True))
    assert np.max(np.abs(ours - pallas)) < TOL


def test_paged_wrapper_takes_the_plain_path_on_cpu():
    """A CPU tensor runs the plain version (3-D T = 1 queries too) and
    counts no launch; the gather surfaces holes as position -1."""
    q, k, v, q_pos, pos, bt = (torch.from_numpy(a) for a in
                               _pool(1, 4, 2, 16, 8, (20, 0), 1, True))
    before = dict(LAUNCHES)
    out = paged_decode_attention(q[:, 0], k, v, q_pos, pos, bt)
    assert torch.equal(out, paged_decode_attention_plain(
        q, k, v, q_pos, pos, bt)[:, 0])
    assert LAUNCHES == before
    ctx, ctx_pos = gather_paged_kv(k, pos, bt)
    jctx, jpos = ref.gather_paged_kv(jnp.asarray(k.numpy()),
                                     jnp.asarray(pos.numpy()),
                                     jnp.asarray(bt.numpy()))
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(ctx_pos.numpy(), np.asarray(jpos))
    assert (ctx_pos[1] == -1).all()


@pytest.mark.parametrize("t", [1, 5])
def test_paged_layout_append_and_context_match_repro(t):
    """The masked in-place append equals repro's scatter (pads and
    table holes parked in the trash block with position -1), and the
    context gather equals repro's."""
    rng = np.random.default_rng(t)
    n, bs, kv, hd = 9, 4, 2, 8
    k0 = rng.standard_normal((n, bs, kv, hd)).astype(np.float32)
    pos0 = rng.integers(-1, 20, (n, bs)).astype(np.int32)
    bt = np.asarray([[3, 5, 1, -1], [7, -1, -1, -1], [2, 8, 4, 6]], np.int32)
    upd = rng.standard_normal((3, t, kv, hd)).astype(np.float32)
    start = np.asarray([6, 2, 9], np.int32)
    valid = np.arange(t)[None, :] < np.asarray([t, 1, 0])[:, None]
    layout = JaxPagedLayout(bs)
    theirs = jax.jit(lambda c, u, s, b, v: layout.append(c, u, s, b, valid=v))(
        {"k": jnp.asarray(k0), "pos": jnp.asarray(pos0)},
        {"k": jnp.asarray(upd)}, jnp.asarray(start), jnp.asarray(bt),
        jnp.asarray(valid))
    ours = PagedLayout(bs).append(
        {"k": torch.from_numpy(k0.copy()), "pos": torch.from_numpy(pos0.copy())},
        {"k": torch.from_numpy(upd)}, torch.from_numpy(start),
        torch.from_numpy(bt), valid=torch.from_numpy(valid))
    # the trash block takes duplicate writes in an unspecified order: its
    # contents are never read, so compare every other block
    np.testing.assert_array_equal(ours["pos"].numpy(),
                                  np.asarray(theirs["pos"]))
    np.testing.assert_array_equal(ours["k"].numpy()[1:],
                                  np.asarray(theirs["k"])[1:])
    ctx = PagedLayout(bs).context(ours, torch.from_numpy(bt))
    jctx = layout.context(theirs, jnp.asarray(bt))
    np.testing.assert_array_equal(ctx["pos"].numpy(), np.asarray(jctx["pos"]))
    live = np.asarray(jctx["pos"]) >= 0
    np.testing.assert_array_equal(ctx["k"].numpy()[live],
                                  np.asarray(jctx["k"])[live])


# ---------------------------------------------------------------------------
# Allocator parity
# ---------------------------------------------------------------------------

FIELDS = dict(name="tiny", family="dense", source="t", num_layers=2,
              d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _lms():
    jlm = JaxLM(ModelConfig(**FIELDS, stages=dense_stages(2)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tlm = LM(tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(2)),
             device="cpu")
    return jlm, jp, tlm


COUNTERS = ("admitted", "blocks_allocated_total", "peak_blocks_in_use",
            "cow_copies", "lookahead_topups", "retained_block_hits",
            "swap_outs", "swap_ins", "preempt_swap_bytes")


def _same_state(ours, theirs, our_state, their_state):
    assert ours._free_plain == theirs._free_plain
    assert list(ours._free_cached) == list(theirs._free_cached)
    for name in ("_slot_blocks", "_ref", "_index", "_block_key",
                 "_slot_shared", "_slot_start", "_slot_cap", "_slot_gap",
                 "_gap_total"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name
    np.testing.assert_array_equal(our_state["tables"].numpy(),
                                  np.asarray(their_state["tables"]))
    ours.assert_invariants(our_state)
    theirs.assert_invariants()


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_decisions_match_repro_block_for_block(seed):
    jlm, jp, tlm = _lms()
    kw = dict(batch_slots=4, max_seq_len=64, block_size=4, num_blocks=41)
    theirs = JaxPagedCache(jlm, jp, **kw)
    ours = PagedCache(tlm, **kw)
    assert ours.block_bytes() == theirs.block_bytes()
    assert ours.hbm_bytes() == theirs.hbm_bytes()
    ts, os_ = theirs.init(), ours.init()
    begin_one = jax.jit(theirs.begin_slot)
    begin_many = jax.jit(theirs.begin_slots)
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, 64, n).astype(np.int32) for n in (8, 12)]
    live = {}          # slot -> (prompt, max_new, registered)
    swapped = []       # (prompt, max_new, their host_kv, our host_kv)
    kinds = {}         # prompt kinds admitted: template, +tail, unique
    for _ in range(260):
        op = rng.choice(["admit", "admit", "register", "lookahead", "free",
                         "swap_out", "swap_in"])
        free_slots = [s for s in range(4) if s not in live]
        if op == "admit" and free_slots:
            tpl = templates[rng.integers(2)]
            kind = rng.integers(3)
            prompt = (tpl.copy() if kind == 0 else
                      np.concatenate([tpl, rng.integers(0, 64, rng.integers(
                          1, 9))]).astype(np.int32) if kind == 1 else
                      rng.integers(0, 64, rng.integers(1, 20)).astype(
                          np.int32))
            max_new = int(rng.integers(1, 12))
            arg = prompt if rng.random() < 0.8 else len(prompt)
            ok = theirs.can_admit(arg, max_new)
            assert ours.can_admit(arg, max_new) == ok
            if ok:
                slot = free_slots[0]
                row_t = theirs.alloc_slot(slot, arg, max_new)
                row_o = ours.alloc_slot(slot, arg, max_new)
                np.testing.assert_array_equal(row_o, row_t)
                assert ours.take_pending_copies() == \
                    theirs.take_pending_copies()
                sb = theirs.shared_block_count(slot)
                assert ours.shared_block_count(slot) == sb
                assert ours.shared_prefill_start(slot) == \
                    theirs.shared_prefill_start(slot)
                ts = begin_one(ts, jnp.int32(slot), jnp.asarray(row_t),
                               jnp.int32(sb))
                os_ = ours.begin_slot(os_, slot, row_o, sb)
                live[slot] = (prompt, max_new, False)
                kinds[kind] = kinds.get(kind, 0) + 1
        elif op == "register" and live:
            slot = list(live)[rng.integers(len(live))]
            prompt, max_new, _ = live[slot]
            theirs.register_prefix(slot, prompt)
            ours.register_prefix(slot, prompt)
            live[slot] = (prompt, max_new, True)
        elif op == "lookahead" and live:
            slot = list(live)[rng.integers(len(live))]
            prompt, max_new, _ = live[slot]
            tokens = len(prompt) + int(rng.integers(0, max_new + 1))
            row_t, cov_t = theirs.reserve_lookahead(slot, tokens)
            row_o, cov_o = ours.reserve_lookahead(slot, tokens)
            assert cov_o == cov_t and (row_o is None) == (row_t is None)
            if row_t is not None:
                np.testing.assert_array_equal(row_o, row_t)
                os_ = ours.begin_slots(os_, [slot], row_o[None], [cov_o])
                ts = begin_many(ts, jnp.asarray([slot]),
                                jnp.asarray(row_t[None]),
                                jnp.asarray([cov_t]))
        elif op == "free" and live:
            slot = list(live)[rng.integers(len(live))]
            ts = theirs.free_slot(ts, slot)
            os_ = ours.free_slot(os_, slot)
            del live[slot]
        elif op == "swap_out" and live:
            slot = list(live)[rng.integers(len(live))]
            prompt, max_new, _ = live.pop(slot)
            host_t, ts = theirs.swap_out(ts, slot)
            host_o, os_ = ours.swap_out(os_, slot)
            assert host_o["n_blocks"] == host_t["n_blocks"]
            swapped.append((prompt, max_new, host_t, host_o))
        elif op == "swap_in" and swapped and free_slots:
            prompt, max_new, host_t, host_o = swapped[0]
            ok = theirs.can_resume(len(prompt), max_new)
            assert ours.can_resume(len(prompt), max_new) == ok
            if ok:
                swapped.pop(0)
                slot = free_slots[0]
                ts = theirs.swap_in(ts, slot, host_t, len(prompt), max_new)
                os_ = ours.swap_in(os_, slot, host_o, len(prompt), max_new)
                live[slot] = (prompt, max_new, True)
        _same_state(ours, theirs, os_, ts)
        assert ours.available_blocks() == theirs.available_blocks()
        for s in range(4):
            assert ours.slot_commitment(s) == theirs.slot_commitment(s)
        assert ours.blocks_in_use == theirs.blocks_in_use
    # the sequence reached every path it is meant to compare
    assert ours.cow_copies and ours.retained_block_hits and ours.swap_ins
    assert ours.lookahead_topups and len(kinds) == 3


def test_swap_moves_the_kv_bytes_and_wipes_nothing_shared():
    """swap_out gathers into fresh tensors (the released blocks can be
    overwritten at once) and swap_in restores the bytes into new blocks."""
    _, _, tlm = _lms()
    be = PagedCache(tlm, batch_slots=2, max_seq_len=32, block_size=4,
                    num_blocks=12)
    st = be.init()
    rng = np.random.default_rng(3)
    st = be.begin_slot(st, 0, be.alloc_slot(0, 10, 2), 0)
    blocks = list(be._slot_blocks[0])
    for leaf in st["caches"][0][0].values():
        leaf.copy_(torch.from_numpy(
            rng.integers(0, 50, leaf.shape).astype(np.float32)).to(leaf.dtype))
    before = {k: v[:, blocks].clone() for k, v in st["caches"][0][0].items()}
    host, st = be.swap_out(st, 0)
    for leaf in st["caches"][0][0].values():
        leaf.fill_(-7)                        # the pool is reused at once
    st = be.begin_slot(st, 1, be.alloc_slot(1, 5, 1), 0)   # other blocks
    st = be.swap_in(st, 0, host, 10, 2)
    new = be._slot_blocks[0]
    assert st["tables"][0, :len(new)].tolist() == new
    for key, leaf in st["caches"][0][0].items():
        assert torch.equal(leaf[:, new], before[key])
    be.assert_invariants(st)
