"""Training on one device on the CPU, against ``repro``: ``LM.loss`` and
its gradient per mixer family (GQA, MLA + MoE with MTP, RG-LRU, xLSTM,
vision, audio) against ``jax.value_and_grad`` of ``repro``'s ``LM.loss``
on bridged f32 weights; the ``Trainer`` (a mirror of
``tests/test_training.py::test_trainer_loss_decreases``, checkpoints that
each package reads from the other, a resumed run equal to the
uninterrupted one bit for bit); and ``launch/train.py``'s flags against
``repro``'s.

Inputs are made from a seed with numpy. Tolerances, f32 on both sides
(summation order only; measured at most 2.5e-7 and 2.5e-6): the loss and
its parts 1e-5 relative, every gradient leaf 1e-5 of that leaf's
max |g|.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.utils.tree import flat_paths as jax_flat_paths  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import latest_step, load_checkpoint  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import linear_warmup_cosine  # noqa: E402
from repro_torch.training import Trainer, make_eval_step  # noqa: E402
from repro_torch.utils.tree import (flat_paths, tree_leaves,  # noqa: E402
                                    tree_map)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# the least gap between a token's k-th and (k+1)-th router score: two f32
# paths that differ by ~1e-6 pick the same experts above it
ROUTE_MARGIN = 1e-4
FAMILIES = {"gqa": "smollm-135m", "mla_moe_mtp": "deepseek-v3-671b",
            "rglru": "recurrentgemma-9b", "xlstm": "xlstm-125m",
            "vision": "internvl2-2b", "audio": "musicgen-medium"}
B, S = 2, 16


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
    (f32); read, never written."""
    jlm = JaxLM(jax_get_config(name).reduced(), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(1))
    tc = tcfg.get_config(name).reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _batch(cfg, seed=0):
    """numpy tokens (B, S) or (B, S, C), next-token labels with the last
    position ignored (-1) and one more label masked, and for vision
    unit-norm ``image_embeds``."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    shape = (B, S, fe.num_codebooks) if fe.kind == "audio" else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full_like(tokens[:, :1], -1)],
                            axis=1)
    labels[0, 3] = -1
    out = {"tokens": tokens, "labels": labels}
    if fe.kind == "vision":
        img = rng.standard_normal((B, fe.num_prefix_tokens, fe.embed_dim))
        out["image_embeds"] = (img / np.linalg.norm(img, axis=-1,
                                                    keepdims=True)).astype(
                                                        np.float32)
    return out


def _route_gaps(monkeypatch):
    """Record, for every MoE call, each token's gap between its k-th and
    (k+1)-th router score."""
    gaps = []
    route = moe_lib.route

    def recording(params, cfg, x_flat, tp=None, over_data=None):
        out = route(params, cfg, x_flat, tp, over_data)
        logits = x_flat.detach().float() @ params["router"].detach().float()
        scores = (torch.sigmoid(logits) if cfg.moe.num_shared_experts
                  else logits)
        top = torch.topk(scores, cfg.moe.num_experts_per_tok + 1, -1)[0]
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return out

    monkeypatch.setattr(moe_lib, "route", recording)
    return gaps


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_repro(family, monkeypatch):
    """``loss(train=True)``, its ce/aux/mtp parts and the gradient of every
    parameter leaf (the same key paths) against ``repro``'s. MoE routes are
    compared first: every token's k-th expert clears the next by
    ``ROUTE_MARGIN``, so both packages route alike. The MTP family also
    holds ``loss(train=False)`` (no MTP, no remat)."""
    jlm, jp, lm, tp = _pair(FAMILIES[family])
    batch = _batch(lm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b, train=True), has_aux=True))(jp, jb)
    gaps = _route_gaps(monkeypatch)
    params = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, metrics = lm.loss(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, train=True)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    if lm.cfg.moe is not None:
        assert gaps and min(gaps) > ROUTE_MARGIN, gaps
    assert set(metrics) == set(jm)
    for key, want in [("loss", jloss)] + sorted(jm.items()):
        got = float((loss if key == "loss" else metrics[key]).detach())
        assert abs(got - float(want)) <= LOSS_TOL * max(abs(float(want)),
                                                        1e-6), key
    theirs = jax_flat_paths(jg)
    ours = dict(zip(flat_paths(params), grads))
    assert set(ours) == set(theirs)
    for key, g in ours.items():
        want = np.asarray(theirs[key], np.float32)
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= GRAD_TOL * float(np.max(np.abs(want))), (key, err)
    if lm.cfg.mtp_depth:
        jeval = jax.jit(lambda p, b: jlm.loss(p, b, train=False)[0])(jp, jb)
        got = make_eval_step(lm)(tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        assert "mtp" not in got
        assert abs(float(got["loss"]) - float(jeval)) <= LOSS_TOL * abs(
            float(jeval))


def _smollm_trainer(tmp_path, **kw):
    cfg = tcfg.get_config("smollm-135m").reduced()
    lm = LM(cfg, device="cpu")
    kw = {"log_every": 5, "ckpt_every": 10, **kw}
    return cfg, Trainer(lm, linear_warmup_cosine(3e-3, 2, 40),
                        ckpt_dir=str(tmp_path), **kw)


def test_trainer_loss_decreases(tmp_path):
    """``tests/test_training.py::test_trainer_loss_decreases`` on the port:
    the reduced smollm on ``TokenStream`` (B 4, S 32), 12 steps: the last
    logged loss is below the first by more than 1.0, a checkpoint was
    written at step 10 and restores (step counter 10)."""
    cfg, tr = _smollm_trainer(tmp_path)
    p, o = tr.init_state(0)
    stream = TokenStream(cfg.vocab_size, seed=0)
    p, o = tr.fit(p, o, stream.batches(4, 32), 12, echo=False)
    assert [m["step"] for m in tr.history] == [0, 5, 10, 11]
    assert set(tr.history[0]) == {"loss", "lr", "ce", "aux", "step",
                                  "wall_s"}
    assert tr.history[-1]["loss"] < tr.history[0]["loss"] - 1.0
    assert all(np.isfinite(m["loss"]) for m in tr.history)
    assert latest_step(str(tmp_path)) == 10
    (p2, o2), step = load_checkpoint(str(tmp_path), (p, o))
    assert step == 10 and int(o2.step) == 10 and int(o.step) == 12


def test_checkpoints_cross_between_packages(tmp_path):
    """A ``Trainer`` checkpoint of (params, AdamW state) has ``repro``'s
    key paths (``1/.step``, ``1/.mu/...``): ``repro``'s ``load_checkpoint``
    restores it into its own (params, opt) template leaf for leaf, and a
    checkpoint ``repro`` saves restores into a fresh port ``Trainer``
    through ``restore_or_init``."""
    cfg, tr = _smollm_trainer(tmp_path / "port", ckpt_every=2)
    p, o = tr.init_state(0)
    stream = TokenStream(cfg.vocab_size, seed=0)
    p, o = tr.fit(p, o, stream.batches(2, 16), 2, echo=False)
    jlm = JaxLM(jax_get_config("smollm-135m").reduced(), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(3))
    jtemplate = (jp, jax_adamw_init(jp))
    (jp2, jo2), step = jax_load(str(tmp_path / "port"), jtemplate)
    assert step == 2 and int(jo2.step) == 2
    ours = flat_paths((p, o))
    theirs = jax_flat_paths((jp2, jo2))
    assert set(ours) == set(theirs) and "1/.mu/final_norm/scale" in ours
    for key, t in ours.items():
        assert np.array_equal(t.numpy(), np.asarray(theirs[key])), key
    # the reverse: repro saves, a fresh port Trainer restores
    jax_save(str(tmp_path / "repro"), 7, jtemplate)
    _, tr2 = _smollm_trainer(tmp_path / "repro")
    p3, o3 = tr2.restore_or_init(0)
    assert int(o3.step) == 0 and o3.step.dtype == torch.int32
    want = jax_flat_paths(jtemplate)
    for key, t in flat_paths((p3, o3)).items():
        assert np.array_equal(t.numpy(), np.asarray(want[key])), key


def test_resumed_trainer_equals_the_uninterrupted_one(tmp_path):
    """12 steps in one run against 6, a checkpoint, and a fresh
    ``Trainer`` that restores it and runs the next 6 on the same batches:
    the same losses and the same final params and AdamW state, bit for
    bit, on the CPU."""
    cfg, tr = _smollm_trainer(tmp_path / "a", ckpt_every=6)
    stream = TokenStream(cfg.vocab_size, seed=0)
    tr.log_every = 1
    p, o = tr.fit(*tr.init_state(0), stream.batches(2, 16), 12, echo=False)
    _, first = _smollm_trainer(tmp_path / "b", ckpt_every=6)
    first.fit(*first.init_state(0), stream.batches(2, 16), 6, echo=False)
    _, second = _smollm_trainer(tmp_path / "b", ckpt_every=6)
    second.log_every = 1
    p2, o2 = second.fit(*second.restore_or_init(0),
                        stream.batches(2, 16, seed=6), 6, echo=False)
    assert [m["loss"] for m in tr.history[6:]] == \
        [m["loss"] for m in second.history]
    for a, b in zip(tree_leaves((p, o)), tree_leaves((p2, o2))):
        assert torch.equal(a, b)


def test_train_cli_flags_against_repro(monkeypatch, capsys):
    """``python -m repro_torch.launch.train`` keeps ``repro``'s flags and
    their defaults, adds ``--device``, ``--mesh-data`` (the port's stand-in
    for ``repro``'s device count), ``--mesh-model`` (its model axis),
    ``--warm`` and ``--report`` (the timed steps' figures) and
    ``--no-reduced``; ``--production`` and ``--multi-pod`` want a
    launcher's process group (outside one they raise and say so), and a
    short run on the CPU logs steps 0, 10 and the last."""
    import argparse

    import repro.launch.train as jtrain
    from repro_torch.launch import train as ttrain

    class Parsed(Exception):
        pass

    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        parsers.append(self)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for main in (jtrain.main, lambda: ttrain.main([])):
        with pytest.raises(Parsed):
            main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    theirs, ours = ({a.dest: a for a in p._actions if a.dest != "help"}
                    for p in parsers)
    assert set(ours) == set(theirs) | {"device", "mesh_data", "mesh_model",
                                       "warm", "report"}
    for dest in ("arch", "steps", "batch", "seq", "lr", "production",
                 "multi_pod", "reduced"):
        assert ours[dest].default == theirs[dest].default, dest
    assert "--no-reduced" in ours["reduced"].option_strings
    for flag in ("--production", "--multi-pod"):
        with pytest.raises(RuntimeError, match="launcher's process group"):
            ttrain.main([flag, "--device", "cpu"])
    ttrain.main(["--device", "cpu", "--steps", "12", "--batch", "2",
                 "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device=cpu arch=smollm-135m-reduced"
    assert [line.split()[1] for line in out[1:]] == ["0", "10", "11"]
    assert all(np.isfinite(float(line.split()[-1])) for line in out[1:])
