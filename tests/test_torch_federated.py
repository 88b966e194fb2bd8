"""``FederatedTrainer`` (FedAvg over a mesh's data axis, one edge cloud a
data rank) on gloo ranks.

A mirror of ``tests/test_training.py::test_federated_trainer_converges``
on 2 and 4 ranks, each an EC with its own slice of a shared linear
problem; a round equal to a one-process simulation (the D replicas
stepped in turn with the port's ``sgd_update``, then their mean) within
``TOL``, on that problem and on ``LM.loss`` of the reduced smollm-135m
with each EC's own ``TokenStream`` seed; the local phase issues no
collective and a round one all-reduce; and at one EC a round equal to
``repro``'s ``FederatedTrainer`` on its one-device host mesh, on the same
numpy inputs. Each world is spawned once for the module.

The rank workers import only torch, numpy and ``repro_torch``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

TOL = 1e-6           # f32, relative to the leaf's largest magnitude
LOSS_TOL = 1e-5      # f32, of the largest round loss: a mean of squares
ROUNDS = 20
LM_ROUNDS, LM_STEPS = 2, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_ec: int):
    """``repro``'s test data: each EC a different slice of one linear
    problem."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(4,)).astype(np.float32)
    xs = rng.normal(size=(n_ec, 64, 4)).astype(np.float32)
    return w_true, xs, xs @ w_true


def _linear_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2)


def _smollm():
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              param_dtype="float32")
    return LM(cfg, device="cpu")


def _lm_batch(lm, ec: int):
    """EC ``ec``'s batch: its own ``TokenStream`` seed."""
    from repro_torch.data.synthetic import TokenStream
    batch = next(TokenStream(lm.cfg.vocab_size, seed=ec).batches(2, 16))
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _lm_loss(lm):
    def loss(params, batch):
        return lm.loss(params, batch, train=False)[0]
    return loss


# -- rank workers (spawned: module-level, no JAX) -----------------------------

def fed_worker(rank, out_dir, xs, ys):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.training import FederatedTrainer

    mesh = make_host_mesh(1)
    d = mesh.data_rank
    batch = (torch.from_numpy(xs[d]), torch.from_numpy(ys[d]))
    ft = FederatedTrainer(_linear_loss, mesh, lr=0.1, local_steps=4)
    params = ft.replicate({"w": torch.zeros(4)})
    opt = ft.init_opt(params)
    rec = {"losses": [], "rounds": []}
    before = dict(COLLECTIVES)
    p1, o1, _ = ft.local_step(params, opt, batch)
    rec["local_step"] = tally(COLLECTIVES, "axis", before)
    for i in range(ROUNDS):
        before = dict(COLLECTIVES)
        params, opt, loss = ft.round(params, opt, batch)
        if i == 0:
            rec["round"] = tally(COLLECTIVES, "axis", before)
            rec["round_kinds"] = {k: n - before.get(k, 0)
                                  for k, n in COLLECTIVES.items()
                                  if n != before.get(k, 0)}
        rec["losses"].append(float(loss))
        rec["rounds"].append(ft.unreplicate(params)["w"].clone())
    rec["momentum"] = opt.momentum["w"].clone()
    lm = _smollm()
    ft = FederatedTrainer(_lm_loss(lm), mesh, lr=0.05,
                          local_steps=LM_STEPS)
    params = ft.replicate(lm.init(0))
    opt = ft.init_opt(params)
    rec["lm"] = []
    for _ in range(LM_ROUNDS):
        params, opt, loss = ft.round(params, opt, _lm_batch(lm, d))
        rec["lm"].append((params, float(loss)))
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))


# -- the parent --------------------------------------------------------------

def _spawn(tmp_path, nprocs, args):
    from repro_torch.launch.mesh import spawn
    out = tmp_path / "out"
    out.mkdir()
    spawn(fed_worker, nprocs, args=(str(out),) + tuple(args),
          rendezvous=f"file://{tmp_path / 'rendezvous'}", timeout_s=300.0)
    return [torch.load(out / f"rank{r}.pt") for r in range(nprocs)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (1, 2, 4):
        _, xs, ys = _problem(n)
        out[n] = _spawn(tmp_path_factory.mktemp(f"fed{n}"), n, (xs, ys))
    return out


def _simulate(loss_fn, start, batches, rounds, steps, lr):
    """D replicas of ``start``, each stepped ``steps`` times on its batch
    in turn (SGD, momentum local), then their f32 mean, ``rounds`` times:
    [(params, the mean last loss)] a round."""
    from repro_torch.optim import sgd_init, sgd_update
    from repro_torch.utils.tree import flat_paths, tree_leaves, tree_map

    n = len(batches)
    reps = [tree_map(lambda t: t.clone(), start) for _ in range(n)]
    opts = [sgd_init(r) for r in reps]
    out = []
    for _ in range(rounds):
        last = []
        for i in range(n):
            for _ in range(steps):
                live = tree_map(lambda t: t.detach().requires_grad_(),
                                reps[i])
                with torch.enable_grad():
                    loss = loss_fn(live, batches[i])
                    grads = torch.autograd.grad(loss, tree_leaves(live),
                                                allow_unused=True)
                g = dict(zip(flat_paths(live), grads))
                gt = dict(flat_paths(live))
                gtree = _like(reps[i], {k: torch.zeros_like(gt[k])
                                        if g[k] is None else g[k]
                                        for k in g})
                reps[i], opts[i] = sgd_update(reps[i], gtree, opts[i], lr=lr)
            last.append(float(loss.detach()))
        flats = [flat_paths(r) for r in reps]
        mean = {k: (sum(f[k].float() for f in flats) / n).to(
            flats[0][k].dtype) for k in flats[0]}
        reps = [_like(start, mean) for _ in range(n)]
        out.append((reps[0], sum(last) / n))
    return out


def _like(tree, by_key):
    from repro_torch.utils.tree import tree_map_with_path
    return tree_map_with_path(lambda k, _: by_key[k], tree)


def _close(a, b, tol=TOL):
    from repro_torch.utils.tree import flat_paths
    fa, fb = flat_paths(a), flat_paths(b)
    assert set(fa) == set(fb)
    for k in fb:
        scale = float(fb[k].abs().max().clamp_min(1e-30))
        assert float((fa[k] - fb[k]).abs().max()) <= tol * scale, k


@pytest.mark.parametrize("ranks", [2, 4])
def test_federated_trainer_converges(worlds, ranks):
    """``repro``'s test on D ECs: the FedAvg loss falls below 5% of the
    first round's and the averaged weights reach the true ones within
    0.15; after every round each EC holds the same params, bit for bit."""
    w_true, _, _ = _problem(ranks)
    recs = worlds[ranks]
    for rec in recs:
        assert rec["losses"] == recs[0]["losses"]
        assert all(torch.equal(a, b) for a, b in zip(rec["rounds"],
                                                     recs[0]["rounds"]))
    losses = recs[0]["losses"]
    assert losses[-1] < 0.05 * losses[0]
    assert np.allclose(recs[0]["rounds"][-1].numpy(), w_true, atol=0.15)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_a_round_equals_the_one_process_simulation(worlds, ranks):
    """Every round's averaged params equal the simulation's within
    ``TOL`` and its mean last loss within ``LOSS_TOL``: the toy problem's 20 rounds and the
    reduced smollm's ``LM.loss`` rounds, each EC on its own stream."""
    _, xs, ys = _problem(ranks)
    batches = [(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
               for i in range(ranks)]
    sim = _simulate(_linear_loss, {"w": torch.zeros(4)}, batches, ROUNDS,
                    4, 0.1)
    rec = worlds[ranks][-1]
    scale = max(loss for _, loss in sim)
    for (params, loss), got, got_loss in zip(sim, rec["rounds"],
                                             rec["losses"]):
        _close({"w": got}, params)
        assert abs(got_loss - loss) <= LOSS_TOL * scale
    lm = _smollm()
    sim = _simulate(_lm_loss(lm), lm.init(0),
                    [_lm_batch(lm, i) for i in range(ranks)], LM_ROUNDS,
                    LM_STEPS, 0.05)
    for (params, loss), (got, got_loss) in zip(sim, rec["lm"]):
        _close(got, params, 1e-5)
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_local_phase_issues_no_collective(worlds, ranks):
    """A local step issues no collective; a round, one all-reduce over
    'data' (the params and the last loss together); the momentum stays
    local (the ECs' differ)."""
    recs = worlds[ranks]
    for rec in recs:
        assert rec["local_step"] == {"model": 0, "data": 0, "world": 0}
        assert rec["round"] == {"model": 0, "data": 1, "world": 0}
        assert rec["round_kinds"] == {"all_reduce/data": 1}
    assert not torch.equal(recs[0]["momentum"], recs[1]["momentum"])


def test_one_ec_round_equals_repro(worlds):
    """At one EC, each of the 20 rounds equals ``repro``'s
    ``FederatedTrainer`` on its one-device host mesh, on the same numpy
    inputs: the params within ``TOL``, the loss within ``LOSS_TOL``."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.training.federated import FederatedTrainer

    mesh = make_host_mesh()
    assert mesh.shape["data"] == 1
    _, xs, ys = _problem(1)

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)

    ft = FederatedTrainer(loss_fn, mesh, lr=0.1, local_steps=4)
    params = ft.replicate({"w": jnp.zeros(4)})
    opt = ft.init_opt(params)
    rec = worlds[1][0]
    scale = max(rec["losses"])
    for got, got_loss in zip(rec["rounds"], rec["losses"]):
        params, opt, loss = ft.round(params, opt, (jnp.asarray(xs),
                                                   jnp.asarray(ys)))
        want = np.asarray(jax.device_get(ft.unreplicate(params)["w"]))
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
        assert abs(got_loss - float(loss[0])) <= LOSS_TOL * scale
