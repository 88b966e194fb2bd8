"""The port's video-query application (paper §5) against ``repro``'s: the
surrogate crop bank, every Fig. 5 cell's result dict (exactly: the
simulator is pure Python with the same seeds), the paper's Fig. 5 claims
on the port's own results, and the servers calibrated from the port's
``ServingEngine`` on the CPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ace_video_query import config as jax_config  # noqa: E402
from repro.core import video_query as jvq  # noqa: E402
from repro_torch.configs.ace_video_query import config  # noqa: E402
from repro_torch.core import video_query as tvq  # noqa: E402

PARADIGMS = ("ci", "ei", "ace", "ace+")
INTERVALS = (0.5, 0.1)
DELAYS = (0.0, 50.0)
DURATION_S = 20.0


@functools.lru_cache(maxsize=None)
def _cell(pkg, paradigm, interval, delay):
    """One Fig. 5 cell's result dict, run once per package."""
    vq, cfg = (jvq, jax_config()) if pkg == "repro" else (tvq, config())
    return vq.run_video_query(cfg, paradigm=paradigm,
                              frame_interval_s=interval,
                              wan_delay_ms=delay, duration_s=DURATION_S)


@pytest.mark.parametrize("seed", [0, 3])
def test_surrogate_crop_bank_equals_repro(seed):
    ours = tvq.surrogate_crop_bank(20_000, seed=seed)
    theirs = jvq.surrogate_crop_bank(20_000, seed=seed)
    assert [dataclasses.astuple(c) for c in ours] == \
        [dataclasses.astuple(c) for c in theirs]


@pytest.mark.parametrize("delay", DELAYS)
@pytest.mark.parametrize("interval", INTERVALS)
@pytest.mark.parametrize("paradigm", PARADIGMS)
def test_run_video_query_equals_repro(paradigm, interval, delay):
    ours = _cell("port", paradigm, interval, delay)
    assert ours == _cell("repro", paradigm, interval, delay)
    assert ours["crops"] > 0


def _results():
    return {(p, iv): _cell("port", p, iv, 50.0)
            for p in PARADIGMS for iv in INTERVALS}


def test_f1_ordering():
    """Paper: CI highest, EI lowest, ACE/ACE+ in between, at every load."""
    results = _results()
    for iv in INTERVALS:
        ci, ei = results[("ci", iv)]["f1"], results[("ei", iv)]["f1"]
        ace, acep = results[("ace", iv)]["f1"], results[("ace+", iv)]["f1"]
        assert ci > ace > ei
        assert ci > acep > ei


def test_bandwidth_ordering():
    """Paper: ACE/ACE+ << CI; EI ~ 0; BWC grows with load except EI."""
    results = _results()
    for iv in INTERVALS:
        ci = results[("ci", iv)]["bwc_mb"]
        ace = results[("ace", iv)]["bwc_mb"]
        ei = results[("ei", iv)]["bwc_mb"]
        assert ace < 0.5 * ci
        assert ei < 0.1 * ace
    assert results[("ci", 0.1)]["bwc_mb"] > results[("ci", 0.5)]["bwc_mb"]


def test_ace_plus_tradeoff_at_high_load():
    """Paper: under high load AP load-balances — more BWC, less EIL."""
    results = _results()
    ace, acep = results[("ace", 0.1)], results[("ace+", 0.1)]
    assert acep["bwc_mb"] > ace["bwc_mb"]
    assert acep["eil_s"] < ace["eil_s"]


def test_ci_eil_blows_up_with_load():
    """Paper: CI's EIL explodes under load (cloud queue backlog); the
    collaborative paradigms stay bounded."""
    results = _results()
    assert results[("ci", 0.1)]["eil_s"] > 10 * results[("ci", 0.5)]["eil_s"]
    assert results[("ace", 0.1)]["eil_s"] < 2.0
    assert results[("ei", 0.1)]["eil_s"] < 2.0


def test_crop_bank_calibration():
    """Surrogate bank matches the paper's reported model qualities."""
    bank = tvq.surrogate_crop_bank(20_000, seed=0)
    conf = np.array([c.eoc_conf for c in bank])
    correct = np.array([(c.eoc_pred == 1) == c.positive_gt for c in bank])
    err = 1 - correct[conf >= 0.8].mean()
    assert 0.03 < err < 0.2
    esc = ((conf >= 0.1) & (conf < 0.8)).mean()
    assert 0.1 < esc < 0.6


class _FixedEngine:
    """A stand-in engine: calibration is patched to return ``service``."""


@pytest.mark.parametrize("paradigm", ["ace", "ci"])
def test_fixed_service_dicts_give_repro_results(monkeypatch, paradigm):
    """The same engine-calibrated service profiles (EOC 4 workers at
    0.12 s, COC 8 at 0.05 s) in both packages give the same results."""
    services = iter([{"service_s": 0.12, "workers": 4, "tokens_s": 1.0},
                     {"service_s": 0.05, "workers": 8, "tokens_s": 1.0}] * 2)
    for mod in (jvq, tvq):
        monkeypatch.setattr(mod, "calibrate_server_from_engine",
                            lambda engine: next(services))
    out = {}
    for name, mod, cfg in (("repro", jvq, jax_config()),
                           ("port", tvq, config())):
        out[name] = mod.run_video_query(
            cfg, paradigm=paradigm, frame_interval_s=0.1, wan_delay_ms=50.0,
            duration_s=10.0, eoc_engine=_FixedEngine(),
            coc_engine=_FixedEngine())
    assert out["port"] == out["repro"]
    assert out["port"] != _cell("port", paradigm, 0.1, 50.0)


def _tiny_engine():
    from repro_torch.configs.base import ModelConfig, dense_stages
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = ModelConfig(
        name="tiny", family="dense", source="t", num_layers=2, d_model=32,
        num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
        stages=dense_stages(2), param_dtype="float32")
    lm = LM(cfg, device="cpu")
    return ServingEngine(lm, lm.init(0), batch_slots=2, max_seq_len=32,
                         min_bucket=16)


def test_engine_calibrated_servers():
    """The ACE application runs on the serving layer: EOC/COC service
    rates come from the port's continuous-batching engine, warmed first;
    calibration's warm-up and measured traffic build no program."""
    eng = _tiny_engine()
    eng.warm_compile()
    programs = dict(eng._programs)
    cal = tvq.calibrate_server_from_engine(eng, n_queries=3, prompt_len=8,
                                           max_new=2)
    assert cal["service_s"] > 0 and cal["tokens_s"] > 0
    assert cal["workers"] == 2
    assert eng._programs == programs

    out = tvq.run_video_query(config(), paradigm="ace", frame_interval_s=0.5,
                              wan_delay_ms=50.0, duration_s=5.0,
                              coc_engine=eng)
    assert out["crops"] > 0 and 0.0 <= out["f1"] <= 1.0
    assert eng._programs == programs
