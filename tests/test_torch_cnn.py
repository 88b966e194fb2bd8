"""The port's video-query classifiers and optimizers against ``repro``'s,
on the CPU, on weights carried across by ``repro_torch.bridge``.

Tolerances: logits 1e-5 relative to the largest logit (f32 convolutions
summed in another order, XLA's against oneDNN's); the loss 1e-6 and each
gradient leaf 1e-4 relative to its largest entry, at least 1e-7 (the
same, through the backward); optimizer steps 1e-6 (the same f32 update,
``b ** step`` by another ``pow``); schedules 1e-6 relative (f32 ``cos``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ace_video_query import ClassifierConfig as JaxCC  # noqa: E402
from repro.configs.ace_video_query import config as jax_vq  # noqa: E402
from repro.models.cnn import Classifier as JaxClassifier  # noqa: E402
from repro.optim import (adamw_init as j_adamw_init,  # noqa: E402
                         adamw_update as j_adamw_update,
                         cosine_schedule as j_cosine,
                         linear_warmup_cosine as j_warmup,
                         sgd_init as j_sgd_init, sgd_update as j_sgd_update)
from repro_torch.bridge import classifier_params_from_numpy  # noqa: E402
from repro_torch.configs.ace_video_query import ClassifierConfig  # noqa: E402
from repro_torch.models.cnn import Classifier, _gn, _same_pads  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, linear_warmup_cosine,
                               sgd_init, sgd_update)
from repro_torch.utils.tree import flat_paths, tree_leaves, tree_map  # noqa: E402

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6

# a tiny classifier, and the application's EOC and COC at full width
WIDTHS = {"tiny": JaxCC("tiny", 32, (4, 8), 3, 1),
          "eoc": jax_vq().eoc, "coc": jax_vq().coc}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(which, seed=0):
    """(repro Classifier, its params, port Classifier, bridged params)."""
    jcfg = WIDTHS[which]
    jm = JaxClassifier(jcfg)
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(seed))
    tcfg = ClassifierConfig(**dataclasses.asdict(jcfg))
    tp = classifier_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    return jm, jp, Classifier(tcfg, device="cpu"), tp


def _images(b, seed=1):
    return np.random.default_rng(seed).random((b, 32, 32, 3),
                                              dtype=np.float32)


@pytest.mark.parametrize("which", list(WIDTHS))
def test_apply_matches_repro(which):
    """Logits on bridged weights at each width: pins the stride-2 SAME
    padding (odd pixel after), GroupNorm and the head."""
    jm, jp, tm, tp = _pair(which)
    x = _images(3)
    theirs = np.asarray(jax.jit(jm.apply)(jp, x))
    ours = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert ours.shape == (3, WIDTHS[which].num_classes)
    assert np.max(np.abs(ours - theirs)) <= LOGIT_TOL * np.max(np.abs(theirs))
    jconf, jcls = jax.jit(jm.predict)(jp, x)
    tconf, tcls = tm.predict(tp, torch.from_numpy(x))
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=1e-5)
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))


@pytest.mark.parametrize("size,stride,want", [
    (32, 2, (0, 1)), (16, 2, (0, 1)), (7, 2, (1, 1)), (32, 1, (1, 1)),
    (5, 3, (0, 1)), (4, 3, (1, 1))])
def test_same_padding_split(size, stride, want):
    """SAME's pads for a 3x3 kernel, as ``lax.conv_general_dilated``
    places them (the odd pixel after)."""
    assert _same_pads(size, 3, stride) == want
    x = jnp.asarray(_images(1)[:, :size, :size])
    w = jnp.ones((3, 3, 3, 2), jnp.float32)
    theirs = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    from repro_torch.models.cnn import _conv
    ours = _conv(torch.from_numpy(np.array(w)),
                 torch.from_numpy(np.array(x)).permute(0, 3, 1, 2),
                 stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_group_norm_matches_repro():
    """``F.group_norm`` with weight 1 + scale against ``repro``'s ``_gn``
    (contiguous channel groups, population variance, f32)."""
    from repro.models.cnn import _gn as jax_gn
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (2, 5, 5, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    theirs = np.asarray(jax_gn(x, scale, bias))
    ours = _gn(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), theirs,
                               atol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "eoc"])
def test_loss_and_gradients_match_jax_grad(which):
    jm, jp, tm, tp = _pair(which)
    x = _images(4)
    y = np.array([0, 1, 1, 0], np.int32) % WIDTHS[which].num_classes
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, x, y)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), tp)
    tloss, taux = tm.loss(leaves, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(tloss, tree_leaves(leaves))
    assert abs(float(tloss.detach()) - float(jloss)) < 1e-6
    assert float(taux["acc"]) == float(jaux["acc"])
    jflat = flat_paths(jax.tree.map(np.asarray, jg))
    assert len(jflat) == len(grads)
    for (path, theirs), ours in zip(jflat.items(), grads):
        bound = GRAD_TOL * max(np.max(np.abs(theirs)), 1e-3)
        assert np.max(np.abs(ours.numpy() - theirs)) <= bound, path


def test_classifier_bridge_rejects_a_mismatch():
    jm, jp, _, _ = _pair("tiny")
    tree = jax.tree.map(np.asarray, jp)
    tcfg = ClassifierConfig(**dataclasses.asdict(WIDTHS["tiny"]))
    bad = dict(tree, stages=tree["stages"][:1])
    with pytest.raises(ValueError, match="stages"):
        classifier_params_from_numpy(bad, tcfg, "cpu")
    bad = dict(tree, head=tree["head"][:, :2])
    with pytest.raises(ValueError, match="head"):
        classifier_params_from_numpy(bad, tcfg, "cpu")


def test_classifier_init_is_seeded_and_shaped():
    tm = Classifier(ClassifierConfig(**dataclasses.asdict(WIDTHS["tiny"])),
                    device="cpu")
    a, b = tm.init(3), tm.init(3)

    def check(leaf, sp):        # sp: (shape, dtype, fan_in) leaves
        if isinstance(sp, dict):
            assert leaf.keys() == sp.keys()
            for k in sp:
                check(leaf[k], sp[k])
        elif isinstance(sp, list):
            assert len(leaf) == len(sp)
            for x, y in zip(leaf, sp):
                check(x, y)
        else:
            assert (tuple(leaf.shape), leaf.dtype) == (sp[0], sp[1])

    check(a, tm.param_spec())
    for path, leaf in flat_paths(a).items():
        assert torch.equal(leaf, flat_paths(b)[path])
    assert float(torch.std(a["stages"][1]["blocks"][0]["c1"])) == \
        pytest.approx((8 * 9) ** -0.5, rel=0.2)
    assert not torch.any(a["stem_scale"])


def _opt_problem(dtype):
    """Params and five gradient trees (dicts and lists), numpy."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)), "layers": [
        {"b": rng.normal(size=(4,))}, {"b": rng.normal(size=(2,))}]}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(
        np.float32), params) for _ in range(5)]
    return params, grads


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype),
                    tree)


def _close(ours, theirs, tol):
    jflat = flat_paths(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), theirs))
    tflat = flat_paths(ours)
    assert list(jflat) == list(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k].float().numpy(), jflat[k],
                                   atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1, "b2": 0.999},
                                {"grad_clip": None, "lr_schedule": True}])
def test_adamw_matches_repro(state, kw):
    """Five AdamW steps (the clip active: gradients of norm ~10), f32 or
    bf16 moments, with and without weight decay, a Python or a schedule
    learning rate."""
    kw = dict(kw)
    sched = kw.pop("lr_schedule", False)
    params, grads = _opt_problem(np.float32)
    jdt, tdt = getattr(jnp, state), getattr(torch, state)
    jp, jo = _to_jax(params, jnp.float32), None
    jo = j_adamw_init(jp, jdt)
    tp = _to_torch(params, torch.float32)
    to = adamw_init(tp, tdt)
    jlr, tlr = j_cosine(0.05, 5), cosine_schedule(0.05, 5)
    for i, g in enumerate(grads):
        jp, jo = j_adamw_update(jp, _to_jax(g, jnp.float32), jo,
                                lr=jlr(jo.step) if sched else 0.05, **kw)
        tp, to = adamw_update(tp, _to_torch(g, torch.float32), to,
                              lr=tlr(to.step) if sched else 0.05, **kw)
    assert int(to.step) == int(jo.step) == 5
    assert to.mu["w"].dtype == tdt
    _close(tp, jp, OPT_TOL)
    _close(to.mu, jo.mu, OPT_TOL if state == "float32" else 1e-2)
    _close(to.nu, jo.nu, OPT_TOL if state == "float32" else 1e-2)


def test_adamw_bf16_params_match_repro():
    params, grads = _opt_problem(np.float32)
    jp = _to_jax(params, jnp.bfloat16)
    jo = j_adamw_init(jp, jnp.bfloat16)
    tp = _to_torch(params, torch.bfloat16)
    to = adamw_init(tp, torch.bfloat16)
    for g in grads[:3]:
        jp, jo = j_adamw_update(jp, _to_jax(g, jnp.bfloat16), jo, lr=0.01)
        tp, to = adamw_update(tp, _to_torch(g, torch.bfloat16), to, lr=0.01)
    assert tp["w"].dtype == torch.bfloat16
    _close(tp, jp, 1e-2)


def test_adamw_reduces_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, opt = adamw_update(params, {"w": g}, opt, lr=0.05)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_repro(momentum):
    params, grads = _opt_problem(np.float32)
    jp = _to_jax(params, jnp.float32)
    jo = j_sgd_init(jp)
    tp = _to_torch(params, torch.float32)
    to = sgd_init(tp)
    for g in grads:
        jp, jo = j_sgd_update(jp, _to_jax(g, jnp.float32), jo, lr=0.01,
                              momentum=momentum)
        tp, to = sgd_update(tp, _to_torch(g, torch.float32), to, lr=0.01,
                            momentum=momentum)
    assert int(to.step) == 5
    _close(tp, jp, OPT_TOL)
    _close(to.momentum, jo.momentum, OPT_TOL)


@pytest.mark.parametrize("tensor_step", [False, True])
def test_schedules_match_repro(tensor_step):
    """Both schedules at every step of their range and past it, from a
    Python step (a float comes back) and a tensor step (a 0-d tensor)."""
    pairs = [(j_cosine(3e-3, 40), cosine_schedule(3e-3, 40)),
             (j_cosine(1.0, 1, 0.0), cosine_schedule(1.0, 1, 0.0)),
             (j_warmup(3e-3, 10, 50), linear_warmup_cosine(3e-3, 10, 50)),
             (j_warmup(0.5, 0, 7), linear_warmup_cosine(0.5, 0, 7))]
    for theirs, ours in pairs:
        for step in range(0, 60):
            want = float(theirs(jnp.int32(step) if tensor_step else step))
            got = ours(torch.tensor(step, dtype=torch.int32)
                       if tensor_step else step)
            if tensor_step:
                assert isinstance(got, torch.Tensor) and got.dim() == 0
                got = float(got)
            else:
                assert isinstance(got, float)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
