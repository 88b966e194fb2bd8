"""The PyTorch port's examples (``examples/torch/``), each run to its end on
the CPU at small flags (``--device cpu``: the plain versions).

Each imports ``repro_torch`` and neither ``repro`` nor ``jax``; the
quickstart, a deterministic simulation of the platform, prints the same
lines as ``examples/quickstart.py``. On the card,
``tests/test_torch_gpu.py::test_examples_run_on_the_card`` runs them at
the same flags without ``--device``.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
# each example's small flags, and a line its end prints
RUNS = {
    "quickstart": ([], "quickstart OK"),
    "serve_stream": ([], "post-drain submit: rejected"),
    "serve_cascade": (["--cache-backend", "paged"], "generative cascade:"),
    "train_lm": (["--steps", "8", "--batch", "4", "--seq", "32"],
                 "(FELL)"),
    "federated_training": ([], "round 9: loss"),
    "video_query": (["--coc-steps", "4", "--eoc-steps", "4", "--bank", "64",
                     "--duration", "2"], "(expect: CI highest F1"),
}


def _run(path, *argv, env=None):
    """``path`` run to its end (one intra-op thread: the ops are small, and
    the suite's workers share the cores); its standard output."""
    out = subprocess.run([sys.executable, path, *argv], capture_output=True,
                         text=True, timeout=240, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1",
                                  **(env or {})))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_six_examples_are_there():
    assert sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == sorted(RUNS)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_imports_the_port_alone(name):
    """No import of ``repro`` or ``jax``, at any depth of the file; a
    ``main(argv=None)`` and a ``--device`` flag."""
    with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops and not tops & {"repro", "jax"}, tops
    main = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == "main"]
    assert main and [a.arg for a in main[0].args.args] == ["argv"]
    assert [d.value for d in main[0].args.defaults] == [None]
    assert any(isinstance(n, ast.Constant) and n.value == "--device"
               for n in ast.walk(main[0]))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_to_its_end_on_the_cpu(name):
    argv, last = RUNS[name]
    out = _run(os.path.join(EXAMPLES, f"{name}.py"), *argv, "--device",
               "cpu")
    assert last in out, out[-3000:]


def test_quickstart_prints_the_jax_examples_lines():
    ours = _run(os.path.join(EXAMPLES, "quickstart.py"), "--device", "cpu")
    theirs = _run(os.path.join(ROOT, "examples", "quickstart.py"),
                  env={"JAX_PLATFORMS": "cpu"})
    assert ours.splitlines() == theirs.splitlines()
    assert len(ours.splitlines()) > 30


def test_an_example_refuses_a_missing_card():
    """``--device`` defaults to cuda, and without a card an example stops
    (no run on the CPU that was not asked for)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable,
                          os.path.join(EXAMPLES, "quickstart.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
