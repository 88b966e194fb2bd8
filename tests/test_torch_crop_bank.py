"""The port's model-backed crop bank against ``repro``'s on the CPU:
``train_classifier`` from a bridged init on the same batches,
``model_crop_bank`` at a tiny config, and ``CascadePair``.

Tolerances: trained weights 1e-5 for all but a bounded share of entries
(Adam's first step moves each weight by about +-lr, so a gradient entry
near 0 whose sign the two backends round apart moves by 2 lr: at most
1% of the entries, each within 2 lr per step); losses 1e-5. The bank
pass on the same weights: confidences 1e-5, booleans equal away from
near-ties (``BANK_TIE`` of a flip). The whole bank after a few steps:
such flips move a few weights by 2 lr and every later step sees them,
so confidences 2e-3 and losses 1e-3, booleans equal away from
near-ties. The cascade's confidences 1e-5, its routes equal.
"""
import functools
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.ace_video_query import ClassifierConfig as JaxCC  # noqa: E402
from repro.configs.ace_video_query import VideoQueryConfig as JaxVQ  # noqa: E402
from repro.core.patterns.inference import CascadePair as JaxPair  # noqa: E402
from repro.data import video as jvideo  # noqa: E402
from repro.models.cnn import Classifier as JaxClassifier  # noqa: E402
from repro_torch.bridge import classifier_params_from_numpy  # noqa: E402
from repro_torch.configs.ace_video_query import (ClassifierConfig,  # noqa: E402
                                                 VideoQueryConfig)
from repro_torch.core.patterns.inference import CascadePair  # noqa: E402
from repro_torch.data import video as tvideo  # noqa: E402
from repro_torch.data.synthetic import synth_crops  # noqa: E402
from repro_torch.models.cnn import Classifier  # noqa: E402
from repro_torch.utils.tree import flat_paths  # noqa: E402

WEIGHT_TOL = 1e-5
MOVED_SHARE = 0.01
BANK_TIE = 1e-4

EOC = JaxCC("eoc", 32, (4, 8), 2, 1)
COC = JaxCC("coc", 32, (8, 16), 10, 1)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    return ClassifierConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _inits(jcfg, seed):
    """``repro``'s ``Classifier.init(PRNGKey(seed))`` and the same weights
    carried into the port, on the CPU; tests read them and never write."""
    jp = JaxClassifier(jcfg).init(jax.random.PRNGKey(seed))[0]
    return jp, classifier_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            _port_cfg(jcfg), "cpu")


def _bridged_init(jcfg, seed):
    return _inits(jcfg, seed)[1]


def _weights_close(ours, theirs, lr, steps):
    jflat = flat_paths(jax.tree.map(np.asarray, theirs))
    tflat = flat_paths(ours)
    assert list(jflat) == list(tflat)
    diff = np.concatenate([np.abs(tflat[k].numpy() - jflat[k]).ravel()
                           for k in jflat])
    assert np.mean(diff > WEIGHT_TOL) <= MOVED_SHARE
    assert np.max(diff) <= 2 * lr * steps


@pytest.mark.parametrize("which,steps,seed", [("coc", 3, 0), ("eoc", 1, 2)])
def test_train_classifier_matches_repro(which, steps, seed, monkeypatch):
    """AdamW steps of ``train_classifier`` from ``repro``'s init on the
    batches both draw from ``default_rng(seed)``: three on the 10-class
    COC; one on the binary EOC, whose first step flips a few near-0
    gradient entries between the backends (the bounded share)."""
    jcfg = {"coc": COC, "eoc": EOC}[which]
    monkeypatch.setattr(Classifier, "init",
                        lambda self, seed: _bridged_init(jcfg, seed))
    imgs, lbls = synth_crops(256, seed=0)
    if which == "eoc":
        lbls = (lbls == tvideo.TARGET_CLASS).astype(np.int32)
    jparams, jrep = jvideo.train_classifier(JaxClassifier(jcfg), imgs, lbls,
                                            steps=steps, batch=32,
                                            seed=seed)
    model = Classifier(_port_cfg(jcfg), device="cpu")
    tparams, trep = tvideo.train_classifier(
        model, imgs, lbls, steps=steps, batch=32, seed=seed)
    assert trep["loss"] == pytest.approx(jrep["loss"], abs=1e-5)
    assert trep["acc"] == jrep["acc"]
    _weights_close(tparams, jparams, 3e-3, steps)


def _repro_bank_pass(jp_eoc, jp_coc, x):
    """``repro``'s bank pass (``data/video.py``'s inner function) on
    ``repro``'s classifiers."""
    import jax.numpy as jnp
    conf = jax.nn.softmax(JaxClassifier(EOC).apply(jp_eoc, x), -1)[:, 1]
    logits = JaxClassifier(COC).apply(jp_coc, x)
    top2 = jax.lax.top_k(logits, 2)[1]
    return tuple(np.asarray(a) for a in (
        conf, (conf >= 0.5).astype(jnp.int32),
        jnp.any(top2 == tvideo.TARGET_CLASS, axis=-1),
        jnp.argmax(logits, -1) == tvideo.TARGET_CLASS))


def test_bank_pass_matches_repro():
    """The bank pass on the same weights (random inits, EOC's head bias
    set so p(target) straddles 0.5) over 64 crops."""
    jp_e, tp_e = _inits(EOC, 7)
    jp_c, tp_c = _inits(COC, 8)
    x, _ = synth_crops(64, seed=4)
    eoc = Classifier(_port_cfg(EOC), device="cpu")
    coc = Classifier(_port_cfg(COC), device="cpu")
    with torch.no_grad():
        logits = eoc.apply(tp_e, torch.from_numpy(x))
    shift = -float(torch.median(logits[:, 1] - logits[:, 0]))
    bias = np.asarray([0.0, shift], np.float32)
    jp_e = dict(jp_e, head_bias=bias)
    tp_e = dict(tp_e, head_bias=torch.from_numpy(bias))
    theirs = _repro_bank_pass(jp_e, jp_c, x)
    ours = [a.numpy() for a in tvideo.bank_pass(eoc, coc, tp_e, tp_c,
                                                torch.from_numpy(x))]
    np.testing.assert_allclose(ours[0], theirs[0], atol=1e-5)
    assert 0 < ours[1].sum() < 64          # both predictions occur
    with torch.no_grad():
        ties = tvideo.bank_near_ties(torch.from_numpy(ours[0]),
                                     coc.apply(tp_c, torch.from_numpy(x)),
                                     BANK_TIE).numpy()
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a[~ties], b[~ties])


def test_model_crop_bank_matches_repro(monkeypatch):
    """The whole bank at a tiny config: COC trains, labels the training
    crops, EOC trains on them, one bank pass; both classifiers start from
    ``repro``'s inits (the port's own generator draws other weights)."""
    kw = dict(n_train=256, n_bank=128, coc_steps=4, eoc_steps=2, batch=32,
              seed=0)
    jcrops, jrep = jvideo.model_crop_bank(JaxVQ(eoc=EOC, coc=COC), **kw)

    jcfgs = {"eoc": EOC, "coc": COC}
    monkeypatch.setattr(Classifier, "init", lambda self, seed: _bridged_init(
        jcfgs[self.cfg.name], seed))
    trained = {}
    train = tvideo.train_classifier

    def keep(model, *a, **k):
        params, rep = train(model, *a, **k)
        trained[model.cfg.name] = (model, params)
        return params, rep

    monkeypatch.setattr(tvideo, "train_classifier", keep)
    cfg = VideoQueryConfig(eoc=_port_cfg(EOC), coc=_port_cfg(COC))
    tcrops, trep = tvideo.model_crop_bank(cfg, device="cpu", **kw)

    for key in ("coc", "eoc"):
        assert trep[key]["loss"] == pytest.approx(jrep[key]["loss"],
                                                  abs=1e-3)
    coc, coc_params = trained["coc"]
    bank, _ = synth_crops(128, seed=1)
    with torch.no_grad():
        logits = coc.apply(coc_params, torch.from_numpy(bank))
    conf = torch.tensor([c.eoc_conf for c in tcrops])
    ties = tvideo.bank_near_ties(conf, logits, 2e-3).numpy()
    assert len(tcrops) == len(jcrops) == 128
    for t, j, tie in zip(tcrops, jcrops, ties):
        assert t.crop_id == j.crop_id and t.nbytes == j.nbytes
        assert t.eoc_conf == pytest.approx(j.eoc_conf, abs=2e-3)
        if not tie:
            assert (t.positive_gt, t.eoc_pred, t.coc_hit) == \
                (j.positive_gt, j.eoc_pred, j.coc_hit)
    n_ties = int(ties.sum())
    for key in ("eoc_error_at_conf", "escalation_rate"):
        assert trep[key] == pytest.approx(jrep[key], abs=(n_ties + 1) / 128)


def test_bank_pass_near_ties():
    conf = torch.tensor([0.5, 0.7, 0.2])
    logits = torch.tensor([[3.0, 1.0, 0.0], [2.0, 1.0, 1.0],
                           [5.0, 5.0, 1.0]])
    assert tvideo.bank_near_ties(conf, logits, 1e-3).tolist() == \
        [True, True, True]
    assert tvideo.bank_near_ties(conf[:1] + 0.1, logits[:1], 1e-3).tolist() \
        == [False]


def test_cascade_pair_matches_repro():
    """The BP gate over bridged classifiers: confidences, predictions and
    the three routes; the cloud's top-5 hit."""
    x = np.random.default_rng(3).random((16, 32, 32, 3), dtype=np.float32)
    jm_e, jm_c = JaxClassifier(EOC), JaxClassifier(COC)
    (je, te), (jc, tc) = _inits(EOC, 7), _inits(COC, 8)
    tm_e = Classifier(_port_cfg(EOC), device="cpu")
    tm_c = Classifier(_port_cfg(COC), device="cpu")
    # thresholds inside the confidences' range, so every route occurs
    theirs = JaxPair(jm_e.apply, jm_c.apply, accept=0.52, drop=0.505)
    ours = CascadePair(tm_e.apply, tm_c.apply, accept=0.52, drop=0.505)
    jstep = theirs.edge_step(je, x)
    with torch.no_grad():
        tstep = ours.edge_step(te, torch.from_numpy(x))
    np.testing.assert_allclose(tstep["conf"].numpy(),
                               np.asarray(jstep["conf"]), atol=1e-5)
    for key in ("pred", "accept", "drop", "escalate"):
        np.testing.assert_array_equal(tstep[key].numpy(),
                                      np.asarray(jstep[key]), err_msg=key)
    for target in (1, 7):
        jhit = theirs.cloud_step(jc, x, target)["hit"]
        with torch.no_grad():
            thit = ours.cloud_step(tc, torch.from_numpy(x), target)["hit"]
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
