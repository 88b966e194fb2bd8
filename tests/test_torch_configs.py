"""The port's configs are field-equal to ``repro``'s, and the port imports
neither JAX nor ``repro``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402

NAMES = jax_configs.ARCHS.names()


def test_same_registry():
    assert torch_configs.ARCHS.names() == NAMES
    assert torch_configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS


@pytest.mark.parametrize("name", NAMES)
def test_config_and_reduced_field_equal(name):
    ours, theirs = torch_configs.get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if hasattr(theirs, "reduced"):
        red = ours.reduced()
        assert dataclasses.asdict(red) == dataclasses.asdict(theirs.reduced())
        assert red.param_dtype == "float32"
        for prop in ("resolved_head_dim", "padded_vocab"):
            assert getattr(red, prop) == getattr(theirs.reduced(), prop)


def test_port_imports_no_jax_and_no_repro():
    """Each entry module, in a fresh interpreter, loads no ``jax``, no
    ``repro`` and no ``yaml`` (the card's machine lacks PyYAML; topology
    files import it only to read or write YAML). Importing the serving
    gateway and the CLI first also checks the import cycle through
    ``core.monitoring``."""
    src = Path(__file__).resolve().parents[1] / "src"
    entries = ["repro_torch.serving.gateway", "repro_torch.launch.serve",
               "repro_torch", "repro_torch.serving.engine",
               "repro_torch.bridge", "repro_torch.configs",
               "repro_torch.core", "repro_torch.core.platform",
               "repro_torch.core.video_query", "repro_torch.core.patterns",
               "repro_torch.models.cnn", "repro_torch.data.video",
               "repro_torch.optim", "repro_torch.models.frontend",
               "repro_torch.training", "repro_torch.launch.train",
               "repro_torch.checkpoint"]
    for first in (entries[0], entries[1], "repro_torch.core"):
        code = (f"import sys, {first}, {', '.join(entries)}; "
                "bad = [m for m in sys.modules if m in ('jax', 'repro', "
                "'yaml') or m.startswith(('jax.', 'repro.', 'yaml.'))]; "
                "assert not bad, bad")
        subprocess.run([sys.executable, "-c", code], check=True, cwd=src,
                       timeout=120)


@pytest.mark.parametrize("name", torch_configs.ASSIGNED_ARCHS)
def test_lm_builds_the_ported_archs_and_refuses_the_rest(name):
    """The port builds every assigned architecture (dense GQA, the RG-LRU
    hybrid, the MoE models, xLSTM, the vision and audio frontends); what
    is left to refuse is a frontend kind that no config has."""
    from repro_torch.models.model import LM

    cfg = torch_configs.get_config(name)
    assert LM(cfg, device="cpu").cfg is cfg
    odd = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, kind="video"))
    with pytest.raises(ValueError, match="unknown frontend"):
        LM(odd, device="cpu")
