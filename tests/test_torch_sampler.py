"""The port's sampler (``repro_torch.serving.sampler``) on the CPU.

It mirrors every test of ``tests/test_sampler.py`` on the port, and holds
the threefry path against ``jax.random`` bit for bit: ``PRNGKey``,
``fold_in``, ``split``, the partitionable ``random_bits`` and ``uniform``.
The Gumbel noise is held to 2 ulp at unit scale (torch's ``log`` and
XLA's may differ by an ulp, which the outer ``log`` carries as an absolute
error), and sampled tokens to ``repro``'s on every row whose perturbed
top-2 margin exceeds 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch.serving.sampler import (categorical, fold_in,  # noqa: E402
                                         gumbel, prng_key, random_bits,
                                         request_keys, sample_logits,
                                         sample_logits_batch,
                                         sample_logits_keyed, split, uniform)

SEEDS = [0, 1, 2 ** 31 + 5]
SHAPES = [(7,), (3, 49152), (2, 5, 17)]
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers (two orders
    of magnitude slower under ``pytest -n``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits(seed=0, b=8, v=64):
    """``tests/test_sampler.py``'s logits, drawn by JAX, as a torch tensor."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (b, v)) * 3.0))


def _np(x):
    return np.asarray(x).astype(np.int64)


# -- tests/test_sampler.py on the port ---------------------------------------

def test_temperature_zero_rows_match_argmax_exactly():
    logits = _logits()
    temp = torch.zeros(8)
    for seed in range(3):                  # greedy must ignore the key
        out = sample_logits_batch(prng_key(seed), logits, temp)
        assert torch.equal(out, torch.argmax(logits, dim=-1).to(torch.int32))
    assert out.dtype == torch.int32


def test_mixed_rows_greedy_unaffected_by_stochastic_neighbors():
    logits = _logits(1)
    temp = torch.tensor([0.0, 1.0, 0.0, 2.0, 0.0, 0.5, 0.0, 1.5])
    out = sample_logits_batch(prng_key(7), logits, temp)
    greedy = torch.argmax(logits, dim=-1)
    for row in (0, 2, 4, 6):
        assert out[row] == greedy[row]


def test_stochastic_rows_respect_top_k():
    logits = _logits(2, b=4, v=32)
    temp = torch.full((4,), 1.5)
    k = 5
    allowed = torch.topk(logits, k, dim=-1).indices.numpy()
    for seed in range(20):
        out = sample_logits_batch(prng_key(seed), logits, temp,
                                  top_k=k).numpy()
        for row in range(4):
            assert out[row] in allowed[row], (seed, row)


def test_stochastic_rows_cover_more_than_argmax():
    logits = _logits(3, b=2, v=16)
    temp = torch.full((2,), 5.0)
    seen = {int(sample_logits_batch(prng_key(s), logits, temp)[0])
            for s in range(64)}
    assert len(seen) > 1


def test_mixed_rows_and_top_k_keep_shape_across_row_mixes():
    """``test_jit_traceable_with_mixed_rows``'s port: eager torch has no
    trace, so what is left is that mixed rows with top-k give one token a
    row whatever the mix."""
    logits = _logits(4)
    temp = torch.tensor([0.0, 1.0] * 4)
    out = sample_logits_batch(prng_key(0), logits, temp, top_k=4)
    assert out.shape == (8,)
    out2 = sample_logits_batch(prng_key(1), logits, temp.flip(0), top_k=4)
    assert out2.shape == (8,)


def test_request_keys_pure_function_of_rid_and_step():
    base = prng_key(0)
    a = request_keys(base, torch.tensor([3, 7]), torch.tensor([0, 5]))
    b = request_keys(base, torch.tensor([7, 3, 9]), torch.tensor([5, 0, 1]))
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0])
    assert not torch.equal(a[0], a[1])


def test_keyed_sampling_independent_of_batch_composition():
    logits = _logits(6, b=4, v=32)
    temp = torch.ones(4)
    base = prng_key(1)
    rids = torch.tensor([0, 1, 2, 3])
    steps = torch.tensor([0, 4, 2, 0])
    full = sample_logits_keyed(request_keys(base, rids, steps), logits, temp)
    perm = torch.tensor([2, 0, 3, 1])
    shuf = sample_logits_keyed(request_keys(base, rids[perm], steps[perm]),
                               logits[perm], temp[perm])
    for i, p in enumerate(perm.tolist()):
        assert shuf[i] == full[p]


def test_keyed_sampling_greedy_rows_exact():
    logits = _logits(7)
    temp = torch.tensor([0.0, 1.0] * 4)
    keys = request_keys(prng_key(2), torch.arange(8),
                        torch.zeros(8, dtype=torch.int32))
    out = sample_logits_keyed(keys, logits, temp)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(out[::2], greedy[::2])


def test_single_stream_sampler_consistency():
    logits = _logits(5, b=1)[0]
    single = sample_logits(prng_key(0), logits, temperature=0.0)
    batch = sample_logits_batch(prng_key(0), logits[None], torch.zeros(1))
    assert int(single) == int(batch[0])


# -- bit-equality with jax.random --------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_equal_jax(seed):
    key, jkey = prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _np(jkey))
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            fold_in(key, data).numpy(), _np(jax.random.fold_in(jkey, data)))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(split(key, n).numpy(),
                                      _np(jax.random.split(jkey, n)))
    # a batch of keys folds and splits row by row (jax.vmap)
    keys = split(key, 3)
    jkeys = jax.random.split(jkey, 3)
    data = np.asarray([5, 2 ** 32 - 1, 2 ** 31 + 3], np.uint32)
    np.testing.assert_array_equal(
        fold_in(keys, torch.from_numpy(data.astype(np.int64))).numpy(),
        _np(jax.vmap(jax.random.fold_in)(jkeys, data)))
    np.testing.assert_array_equal(
        split(keys, 2).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, 2))(jkeys)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_equal_jax(seed, shape):
    key, jkey = prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        random_bits(key, shape).numpy(),
        _np(jax.random.bits(jkey, shape, jnp.uint32)))
    ours = uniform(key, shape).numpy()
    theirs = np.asarray(jax.random.uniform(jkey, shape))
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))
    ours = uniform(key, shape, -2.0, 3.0).numpy()
    theirs = np.asarray(jax.random.uniform(jkey, shape, minval=-2.0,
                                           maxval=3.0))
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(seed, shape):
    ours = gumbel(prng_key(seed), shape).numpy()
    theirs = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    assert np.isfinite(ours).all()
    ulp = np.spacing(np.maximum(np.abs(theirs), 1.0).astype(np.float32))
    assert (np.abs(ours - theirs) <= 2 * ulp).all()


def test_request_keys_equal_repro():
    rids = np.asarray([0, 3, 2 ** 31 + 1, 2 ** 32 - 1, 17], np.uint32)
    steps = np.asarray([0, 9, 5, 2 ** 32 - 1, 2 ** 31], np.uint32)
    for seed in SEEDS:
        ours = request_keys(prng_key(seed),
                            torch.from_numpy(rids.astype(np.int64)),
                            torch.from_numpy(steps.astype(np.int64)))
        theirs = jsampler.request_keys(jax.random.PRNGKey(seed), rids, steps)
        np.testing.assert_array_equal(ours.numpy(), _np(theirs))
    # int32 request ids of -1 (a padded row) wrap as JAX's uint32 cast does
    ours = request_keys(prng_key(0), torch.tensor([-1]), torch.tensor([0]))
    theirs = jsampler.request_keys(jax.random.PRNGKey(0),
                                   np.asarray([-1], np.int32),
                                   np.asarray([0], np.int32))
    np.testing.assert_array_equal(ours.numpy(), _np(theirs))


def _clear_rows(logits, temp, noise):
    """Rows whose perturbed top-2 margin (logits / T + noise; logits alone
    at T = 0) exceeds MARGIN: the rows where an ulp of ``log`` cannot move
    the argmax."""
    scaled = logits / np.maximum(temp, 1e-6)[:, None] if noise is not None \
        else logits
    pert = np.sort(scaled + (noise if noise is not None else 0.0), axis=-1)
    return pert[:, -1] - pert[:, -2] > MARGIN


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.5])
def test_sampled_tokens_equal_repro(temperature):
    rng = np.random.default_rng(int(temperature * 10))
    b, v = 16, 1000
    logits = (rng.standard_normal((b, v)) * 3.0).astype(np.float32)
    temp = np.full((b,), temperature, np.float32)
    temp[::4] = 0.0                          # greedy rows in every batch
    rids = np.arange(b, dtype=np.int64) * 7 + 1
    steps = np.arange(b, dtype=np.int64) % 5
    keys = request_keys(prng_key(3), torch.from_numpy(rids),
                        torch.from_numpy(steps))
    jkeys = jsampler.request_keys(jax.random.PRNGKey(3), rids, steps)
    ours = sample_logits_keyed(keys, torch.from_numpy(logits),
                               torch.from_numpy(temp)).numpy()
    theirs = np.asarray(jsampler.sample_logits_keyed(jkeys, logits, temp))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (v,))) for k in jkeys])
    clear = np.where(temp > 0, _clear_rows(logits, temp, noise),
                     _clear_rows(logits, temp, None))
    assert clear.sum() >= b - 1
    np.testing.assert_array_equal(ours[clear], theirs[clear])
    # one key for the whole batch: the drain batcher's draw
    ours = sample_logits_batch(prng_key(4), torch.from_numpy(logits),
                               torch.from_numpy(temp)).numpy()
    theirs = np.asarray(jsampler.sample_logits_batch(
        jax.random.PRNGKey(4), logits, temp))
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(4), (b, v)))
    clear = np.where(temp > 0, _clear_rows(logits, temp, noise),
                     _clear_rows(logits, temp, None))
    assert clear.sum() >= b - 1
    np.testing.assert_array_equal(ours[clear], theirs[clear])
    # and categorical on its own, one key a row
    noise = np.stack([np.asarray(jax.random.gumbel(k, (v,))) for k in jkeys])
    clear = _clear_rows(logits, np.ones((b,), np.float32), noise)
    np.testing.assert_array_equal(
        categorical(keys, torch.from_numpy(logits)).numpy()[clear],
        np.asarray(jax.vmap(jax.random.categorical)(jkeys, logits))[clear])
