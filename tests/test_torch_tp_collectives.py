"""The mesh's collectives under autograd, and the vocab-parallel cross
entropy, on spawned gloo ranks against one process.

``launch.mesh``'s ``reduce``, ``copy``, ``gather`` and ``scatter`` are
Megatron's conjugate pairs over ``HostMesh``'s calls. On a (2, 2) mesh of 4
ranks, over each axis ("model", "data", "world"): each forward equals the
mesh's own call bit for bit (``copy`` is the identity), and the gradients
of a loss that every rank computes alike equal those of the same function
written on one process over the whole tensors (the oracle), within f32
rounding. ``models.model._xent`` on each rank's vocab slice of the logits
(``tp`` splitting the vocab) equals ``_xent`` on the whole logits, with
labels < 0, a global ``denom`` and its gradient, on 2 and 4 ranks.

The rank workers import only torch, numpy and ``repro_torch``.
"""
import os

import numpy as np
import pytest
import torch

TOL = 1e-5           # of a tensor's max |x|: f32 sums in another order
AXES = ("model", "data", "world")
V = 48               # the vocab (each rank's slice V / ranks)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n: int):
    """Per-rank pieces of every case, from one seed: ``x`` (3, 4) the
    replicated input, ``a`` (n, 4, 5) each rank's column block, ``w``
    (n, 3, 5) each rank's weights, ``part`` (n, 3, 4) each rank's slice,
    ``wg`` (3, 4 n) the replicated weights of a joined tensor."""
    rng = np.random.default_rng(7)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    return dict(x=f(3, 4), a=f(n, 4, 5), w=f(n, 3, 5), part=f(n, 3, 4),
                wg=f(3, 4 * n))


def _xent_inputs(ranks: int):
    rng = np.random.default_rng(11)
    logits = torch.as_tensor(rng.standard_normal((2, 5, V)) * 3,
                             dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, V, (2, 5)))
    labels[0, 1] = -1
    labels[1, 3:] = -1
    return logits, labels


def _oracle(n: int):
    """One process: for each case the loss's gradients over the whole
    tensors (the SPMD ranks' pieces stacked by their index on the axis)."""
    t = _inputs(n)
    out = {}
    # copy then a split product, ended by reduce: sum_r w_r . (x @ a_r)
    x = t["x"].clone().requires_grad_()
    a = t["a"].clone().requires_grad_()
    loss = sum(torch.sum(t["w"][r] * (x @ a[r])) for r in range(n))
    out["copy"] = dict(zip(("x", "a"), torch.autograd.grad(loss, [x, a])))
    # gather: the joined slices under replicated weights
    part = t["part"].clone().requires_grad_()
    loss = torch.sum(t["wg"] * torch.cat(list(part), -1))
    out["gather"], = torch.autograd.grad(loss, [part])
    # scatter: each rank's slice of x under its weights, then reduce
    xs = t["part"].transpose(0, 1).reshape(3, 4 * n)
    xs = xs.clone().requires_grad_()
    loss = sum(torch.sum(t["part"][r] * xs.narrow(-1, 4 * r, 4))
               for r in range(n))
    out["scatter"], = torch.autograd.grad(loss, [xs])
    return out


def collectives_worker(rank, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import _xent
    from repro_torch.sharding import tensor_parallel
    from repro_torch.configs import get_config
    import dataclasses

    mesh = M.make_host_mesh(2)
    rec = {}
    for axis in AXES:
        n, i = mesh.axis_size(axis), mesh.axis_rank(axis)
        t = _inputs(n)
        got = {}
        # forwards against the mesh's own calls
        y = t["part"][i].clone().requires_grad_()
        got["reduce_fwd"] = torch.equal(M.reduce(mesh, y, axis),
                                        mesh.all_reduce(t["part"][i].clone(),
                                                        axis))
        got["gather_fwd"] = torch.equal(M.gather(mesh, y, -1, axis),
                                        mesh.gather(t["part"][i], -1, axis))
        xs = t["part"].transpose(0, 1).reshape(3, 4 * n)
        got["scatter_fwd"] = torch.equal(
            M.scatter(mesh, xs.clone().requires_grad_(), -1, axis),
            mesh.shard(xs, -1, axis))
        got["copy_fwd"] = torch.equal(M.copy(mesh, y, axis), y)
        # gradients
        x = t["x"].clone().requires_grad_()
        a = t["a"][i].clone().requires_grad_()
        loss = M.reduce(mesh, torch.sum(t["w"][i] * (
            M.copy(mesh, x, axis) @ a)), axis)
        got["copy"] = dict(zip(("x", "a"), torch.autograd.grad(loss, [x, a])))
        got["copy_loss"] = loss.detach()
        part = t["part"][i].clone().requires_grad_()
        loss = torch.sum(t["wg"] * M.gather(mesh, part, -1, axis))
        got["gather"], = torch.autograd.grad(loss, [part])
        xs = xs.clone().requires_grad_()
        loss = M.reduce(mesh, torch.sum(t["part"][i] * M.scatter(
            mesh, xs, -1, axis)), axis)
        got["scatter"], = torch.autograd.grad(loss, [xs])
        rec[axis] = got
    # the vocab-parallel cross entropy on a 2-way and a 4-way model axis
    for model in (2, 4):
        m = mesh if model == 2 else M.make_host_mesh(4)
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                                  vocab_size=V)
        tp = tensor_parallel(cfg, m, mode="train")
        logits, labels = _xent_inputs(model)
        w = V // model
        mine = logits[..., m.model_rank * w:(m.model_rank + 1) * w]
        mine = mine.clone().requires_grad_()
        for denom in (None, torch.tensor(13)):
            loss = _xent(mine, labels, denom, tp)
            g, = torch.autograd.grad(loss, [mine])
            rec[f"xent{model}/{denom is not None}"] = (loss.detach(), g)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = tmp_path_factory.mktemp("tpc")
    spawn(collectives_worker, 4, args=(str(tmp),),
          rendezvous=f"file://{tmp / 'rendezvous'}", timeout_s=120.0)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(4)]


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * max(scale, 1e-30)


def _place(rank, axis):
    """Rank ``rank``'s (size, index) on ``axis`` of the (2, 2) mesh."""
    return {"model": (2, rank % 2), "data": (2, rank // 2),
            "world": (4, rank)}[axis]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", ["reduce", "copy", "gather", "scatter"])
def test_forward_is_the_mesh_call_bit_for_bit(ranks, axis, op):
    """Under autograd each collective's forward is ``HostMesh``'s call
    (``copy``: the identity), so serving's values and counts stay."""
    for rec in ranks:
        assert rec[axis][f"{op}_fwd"]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", ["copy", "gather", "scatter"])
def test_gradients_equal_the_one_process_oracle(ranks, axis, op):
    """``copy``'s backward sums the ranks' partial gradients of its input
    (and ``reduce`` passes the replicated gradient to each partial);
    ``gather``'s keeps the rank's slice; ``scatter``'s joins the slices'
    gradients: each equals the gradient of the same function on one
    process over the whole tensors."""
    for r, rec in enumerate(ranks):
        n, i = _place(r, axis)
        want = _oracle(n)[op]
        got = rec[axis][op]
        if op == "copy":
            _close(got["x"], want["x"])
            _close(got["a"], want["a"][i])
        elif op == "gather":
            _close(got, want[i])
        else:
            _close(got, want)


@pytest.mark.parametrize("denom", [False, True])
@pytest.mark.parametrize("model", [2, 4])
def test_vocab_parallel_xent_equals_xent_on_the_whole_logits(ranks, model,
                                                             denom):
    """Each rank's loss from its V/M slice of the logits (labels < 0
    ignored, a global count as the denominator) equals ``_xent`` on the
    whole logits within f32 rounding, on every rank, and its gradient is
    the rank's slice of the whole loss's gradient."""
    from repro_torch.models.model import _xent

    logits, labels = _xent_inputs(model)
    whole = logits.clone().requires_grad_()
    loss = _xent(whole, labels, torch.tensor(13) if denom else None)
    g, = torch.autograd.grad(loss, [whole])
    w = V // model
    # the (2, 2) mesh's model groups are ranks (0, 1) and (2, 3); the 4-way
    # axis is every rank
    for r, rec in enumerate(ranks):
        got_loss, got_g = rec[f"xent{model}/{denom}"]
        assert abs(float(got_loss) - float(loss.detach())) <= TOL * float(
            loss.detach())
        i = r % model
        _close(got_g, g[..., i * w:(i + 1) * w])
