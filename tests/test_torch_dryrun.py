"""The production-mesh dry run (``repro_torch.launch.dryrun``) against
``repro.launch.dryrun`` and against real steps of the port.

(a) For every assigned architecture and input shape, the port's
``launch.specs.input_specs`` equal ``repro``'s, the whole param shapes of
``LM.param_spec`` equal ``jax.eval_shape`` of ``repro``'s ``init_boxed``,
and the decode caches' whole shapes equal ``repro``'s ``abstract_cache``.
(b) A tiny model's train, prefill and decode step traced under fake
tensors on a one-rank fake group counts the FLOPs and bytes that
``analysis.roofline.step_record`` counts of the same step run for real.
(c) On a fake (2, 2) group it counts the collectives (kind, axis, calls,
bytes) of rank 0 of a real gloo (2, 2) step. gloo has no reduce-scatter of
the port's NCCL layout, so the fake mesh takes gloo's forms here (its
backend name set to gloo: the name picks the form, as
``test_torch_sharded_serving``'s gather test picks one).
(d) smollm-135m's train_4k on the 16 x 16 mesh (fake CPU) and decode_32k
on 2 x 16 x 16 carry ``repro``'s record keys, and rank 0's params summed
over the mesh, less the copies of the leaves every rank holds whole, are
``param_counts``' total. (e) Each forward kernel wrapper's shape rule on
fake CUDA tensors gives the plain version's shapes and dtypes, adds the
launch's FLOPs and no launch. (f) ``launch/train.py --production`` builds
the (16, 16) mesh on a fake 256-rank group; a world of 8 raises and names
256 and 512. (g) ``roofline_table`` reads a port record beside one in
``repro``'s format; ``analysis.reanalyze`` re-derives a record's
``weighted`` from its op log. The guard-free methods that trace fake
CUDA tensors in a build without CUDA (``launch.fake``) give real CPU
indexing's shapes and strides.

No test runs autograd on a fake CUDA tensor: a build without CUDA aborts
the process on it (``launch.fake``); the card's tests and ``chip_smoke.py``
phase 25 trace training on fake CUDA tensors. Alone the file takes ~45 s
(``-p xdist -n 1``); the smollm traces and the (2, 2) gloo spawn dominate.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape

SHAPES = list(INPUT_SHAPES)
DECODE = [s for s in SHAPES if INPUT_SHAPES[s].mode == "decode"]
# a tiny step: (B, S) and the cache width, in each mode
TINY = {"train": InputShape("tiny_train", 16, 4, "train"),
        "prefill": InputShape("tiny_prefill", 16, 4, "prefill"),
        "decode": InputShape("tiny_decode", 16, 4, "decode")}
# ``repro``'s record keys (src/repro/launch/dryrun.py, run_one), with the
# port's trace_s for lower_s/compile_s and ops for hlo_lines
RECORD_KEYS = {"arch", "shape", "mesh", "devices", "mode", "seq_len",
               "global_batch", "trace_s", "memory", "cost", "collectives",
               "weighted", "ops"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "generated_code_bytes"}
KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-4b").reduced(),
                               param_dtype="float32")


def _jax_paths(tree):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _spec_paths(spec, prefix=""):
    if isinstance(spec, dict):
        out = {}
        for k, v in spec.items():
            out.update(_spec_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(spec, list):
        out = {}
        for i, v in enumerate(spec):
            out.update(_spec_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: (tuple(spec[0]), str(spec[1]).replace("torch.", ""))}


def _tensor_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensor_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tensor_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape),
                          str(tree.dtype).replace("torch.", ""))}


@functools.lru_cache(maxsize=None)
def _repro_lm(arch, shape):
    from repro.launch.specs import resolved_config
    from repro.models.model import LM
    return LM(resolved_config(arch, shape))


# -- (a) specs, params and caches against repro ------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_repros(arch, shape):
    from repro.launch.specs import input_specs as theirs

    from repro_torch.launch.specs import input_specs, resolved_config

    got = input_specs(resolved_config(arch, shape), INPUT_SHAPES[shape])
    want = theirs(_repro_lm(arch, shape).cfg, INPUT_SHAPES[shape])
    assert set(got) == set(want)
    for k, spec in got.items():
        assert spec.shape == tuple(want[k].shape), k
        assert str(spec.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_shapes_equal_repros_init(arch, shape):
    import jax

    from repro.models import param as P

    from repro_torch.launch.specs import resolved_config
    from repro_torch.models.model import LM

    lm = _repro_lm(arch, shape)
    want, _ = P.unbox(jax.eval_shape(
        lambda: lm.init_boxed(jax.random.PRNGKey(0))))
    got = _spec_paths(LM(resolved_config(arch, shape),
                         device="cpu").param_spec())
    assert got == _jax_paths(want)


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_cache_shapes_equal_repros(arch, shape):
    from repro.launch.specs import abstract_cache as theirs

    from repro_torch.launch.fake import fake_mode
    from repro_torch.launch.specs import abstract_cache, resolved_config
    from repro_torch.models.model import LM

    with fake_mode("cpu"):
        got = abstract_cache(LM(resolved_config(arch, shape), device="cpu"),
                             INPUT_SHAPES[shape])
        got = _tensor_paths(got)
    assert got == _jax_paths(theirs(_repro_lm(arch, shape),
                                    INPUT_SHAPES[shape]))


# -- (b) a traced step counts what the real step counts ----------------------

def _real_inputs(lm, shape, mesh, seed=0):
    """The inputs of ``make_step_fn`` with values: params from ``LM.init``
    (cut by the step's rules), tokens and labels in the vocabulary."""
    from repro_torch.launch.specs import input_specs, rank_rows
    from repro_torch.optim import adamw_init
    g = torch.Generator().manual_seed(seed)
    specs = input_specs(lm.cfg, shape)
    mode = "train" if shape.mode == "train" else "decode"
    params = lm.init(seed, mesh=mesh, mode=mode)

    def tokens(spec):
        return torch.randint(0, lm.cfg.vocab_size, spec.shape, generator=g,
                             dtype=torch.int32)

    if shape.mode == "train":
        batch = {k: tokens(rank_rows(mesh, v)) for k, v in specs.items()}
        return (params, adamw_init(params), batch)
    if shape.mode == "prefill":
        return (params, {k: tokens(v) for k, v in specs.items()})
    caches = lm.init_cache(shape.global_batch, shape.seq_len, mesh=mesh)
    return (params, caches, tokens(specs["tokens"]),
            torch.zeros((), dtype=torch.int32))


def _bytes(tree):
    from repro_torch.launch.specs import tree_bytes
    return tree_bytes(tree)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_a_traced_step_counts_the_real_steps_flops_and_bytes(mode):
    from repro_torch.analysis import step_record
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.fake import fake_mode, fake_world
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.specs import make_step_fn
    from repro_torch.models.model import LM

    shape = TINY[mode]
    with fake_world(1):
        mesh = HostMesh(1, device="cpu")
        lm = LM(_tiny_cfg(), device="cpu")
        step, _ = make_step_fn(lm, shape, mesh, "cpu")
        real = _real_inputs(lm, shape, mesh)
        read = real[:2] if mode == "decode" else real[0]
        want = step_record(lambda: step(*real), arch="qwen3-4b", mode=mode,
                           seq_len=shape.seq_len,
                           global_batch=shape.global_batch, params=read)
        with fake_mode("cpu"):
            lm = LM(_tiny_cfg(), device="cpu")
            step, inputs = make_step_fn(lm, shape, mesh, "cpu")
            got, log = trace_step(
                step, inputs, params=inputs[0],
                read=inputs[:2] if mode == "decode" else inputs[0],
                device="cpu", arch="qwen3-4b", mode=mode)
    assert want["cost"]["flops"] > 0
    assert got["cost"]["flops"] == want["cost"]["flops"]
    assert got["weighted"]["dot_flops"] == want["cost"]["flops"]
    assert got["cost"]["bytes accessed"] == want["cost"]["bytes accessed"]
    assert got["memory"]["argument_bytes_per_device"] == _bytes(real)
    assert got["params_per_device"] == sum(
        t.numel() for t in _tensors(real[0]))
    names = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}
    assert {names[k]: v for k, v in want["collectives"].items()} == {
        k: {"count": v["count"], "bytes": v["bytes"]}
        for k, v in got["collectives"].items() if v["count"]}


def _tensors(tree):
    from repro_torch.utils.tree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# -- (c) a fake (2, 2) mesh counts a real one's collectives ------------------

def _tally(before, before_b):
    from repro_torch.launch.mesh import COLLECTIVE_BYTES, COLLECTIVES
    return {k: [n - before.get(k, 0),
                COLLECTIVE_BYTES[k] - before_b.get(k, 0)]
            for k, n in COLLECTIVES.items() if n - before.get(k, 0)}


def collectives_worker(rank, out_dir):
    """Rank ``rank`` of a real gloo (2, 2) mesh: each tiny step once, and
    the collectives it made (kind/axis: calls, bytes)."""
    from repro_torch.launch.mesh import (COLLECTIVE_BYTES, COLLECTIVES,
                                         make_host_mesh)
    from repro_torch.launch.specs import make_step_fn
    from repro_torch.models.model import LM

    torch.set_num_threads(1)
    mesh = make_host_mesh(2)
    lm = LM(_tiny_cfg(), device="cpu")
    rec = {}
    for mode, shape in TINY.items():
        step, _ = make_step_fn(lm, shape, mesh, "cpu")
        inputs = _real_inputs(lm, shape, mesh)
        before, before_b = dict(COLLECTIVES), dict(COLLECTIVE_BYTES)
        step(*inputs)
        rec[mode] = _tally(before, before_b)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def test_a_fake_2x2_mesh_counts_a_real_meshes_collectives(tmp_path):
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.fake import fake_mode, fake_world
    from repro_torch.launch.mesh import HostMesh, spawn
    from repro_torch.launch.specs import make_step_fn
    from repro_torch.models.model import LM

    out = tmp_path / "out"
    out.mkdir()
    spawn(collectives_worker, 4, args=(str(out),),
          rendezvous=f"file://{tmp_path / 'rendezvous'}", timeout_s=150.0)
    real = json.loads((out / "rank0.json").read_text())
    with fake_world(4):
        mesh = HostMesh(2, device="cpu")
        mesh.backend = "gloo"            # gloo's forms (module docstring)
        for mode, shape in TINY.items():
            with fake_mode("cpu"):
                lm = LM(_tiny_cfg(), device="cpu")
                step, inputs = make_step_fn(lm, shape, mesh, "cpu")
                _, log = trace_step(step, inputs, params=inputs[0],
                                    read=inputs[0], device="cpu")
            got = {e["op"].split("/", 1)[1]: [e["n"], e["bytes"]]
                   for e in log if e["op"].startswith("collective/")}
            assert got == real[mode], mode
            assert real[mode], mode
    assert real["train"].get("all_reduce/data")
    assert real["train"].get("all_reduce/model")


# -- (d) the production meshes' records --------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """smollm-135m's train_4k on pod16x16 (fake CPU) and decode_32k on
    pod2x16x16 (fake CUDA: a forward), traced once for the module."""
    from repro_torch.launch.dryrun import run_one
    out = str(tmp_path_factory.mktemp("dryrun"))
    train = run_one("smollm-135m", "train_4k", out_dir=out, device="cpu",
                    verbose=False)
    decode = run_one("smollm-135m", "decode_32k", multi_pod=True,
                     out_dir=out, device="cuda", verbose=False)
    return out, {"train": train, "decode": decode}


@pytest.mark.parametrize("which", ["train", "decode"])
def test_production_records_carry_repros_keys_and_the_params(records, which):
    from repro.analysis.hlo_cost import analyze

    from repro_torch.analysis import param_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.fake import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import LM

    rec = records[1][which]
    assert RECORD_KEYS <= set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    assert set(rec["collectives"]) == KINDS
    hlo = "ENTRY %main (p: f32[2]) -> f32[2] {\n  ROOT %p = f32[2] parameter(0)\n}\n"
    assert set(rec["weighted"]) == set(analyze(hlo))
    multi = which == "decode"
    assert rec["mesh"] == ("pod2x16x16" if multi else "pod16x16")
    assert rec["devices"] == (512 if multi else 256)
    assert rec["weighted"]["dot_flops"] > 0 and rec["trace_s"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    if which == "decode":
        assert rec["kernels"] == {"decode_attention": 30}
    else:
        assert rec["collectives"]["all-gather"]["count"] >= 1
        assert rec["collectives"]["reduce-scatter"]["count"] >= 1
    # rank 0's params times the ranks, less the copies that more than one
    # rank holds of a leaf cut fewer ways than the ranks, are the model's
    with fake_world(rec["devices"]):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        lm = LM(dryrun.resolved_config("smollm-135m", rec["shape"]),
                device="cpu")
        shares = dryrun.param_shares(lm, mesh, "train" if which == "train"
                                     else "decode")
    copies = sum(int(np.prod(s)) // w * (rec["devices"] // w - 1) * w
                 for s, _, w in shares)
    assert rec["devices"] * rec["params_per_device"] - copies \
        == param_counts("smollm-135m")["total"]
    assert copies > 0


def test_a_record_is_cached_and_reanalysed_from_its_op_log(records):
    from repro_torch.analysis.op_cost import analyze, load_log
    from repro_torch.analysis.reanalyze import reanalyze
    from repro_torch.launch.dryrun import run_one

    out, recs = records
    path = os.path.join(out, "smollm-135m__train_4k__pod16x16.json")
    log = load_log(path[:-len(".json")] + ".ops.gz")
    assert analyze(log) == recs["train"]["weighted"]
    with open(path) as f:
        rec = json.load(f)
    rec["weighted"] = {"dot_flops": 0.0}
    with open(path, "w") as f:
        json.dump(rec, f)
    assert path in reanalyze(out)
    again = run_one("smollm-135m", "train_4k", out_dir=out, device="cpu",
                    verbose=False)
    assert again["weighted"] == recs["train"]["weighted"]


# -- (g) the roofline reads both packages' records ---------------------------

def test_roofline_table_reads_a_port_record_beside_a_repro_one(records,
                                                               tmp_path):
    from repro.analysis.hlo_cost import analyze

    from repro_torch.analysis import roofline_from_record, roofline_table

    out, recs = records
    port = recs["decode"]
    theirs = {"arch": "glm4-9b", "shape": "prefill_32k", "mesh": "pod2x16x16",
              "devices": 512, "mode": "prefill", "seq_len": 32768,
              "global_batch": 32, "lower_s": 1.0, "compile_s": 2.0,
              "memory": {"argument_bytes_per_device": 2 ** 30,
                         "output_bytes_per_device": 0,
                         "temp_bytes_per_device": 2 ** 31},
              "cost": {"flops": 1.0, "bytes accessed": 1.0},
              "collectives": {k: {"count": 0, "bytes": 0} for k in KINDS},
              "weighted": analyze("ENTRY %main (p: f32[2]) -> f32[2] {\n"
                                  "  ROOT %p = f32[2] parameter(0)\n}\n"),
              "hlo_lines": 3}
    theirs["weighted"]["dot_flops"] = 4e15
    for rec in (port, theirs):
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(tmp_path / name, "w") as f:
            json.dump(rec, f)
    rows = roofline_table(str(tmp_path), "pod2x16x16")
    assert [r["arch"] for r in rows] == ["glm4-9b", "smollm-135m"]
    assert rows[0] == roofline_from_record(theirs)
    assert rows[1]["t_compute_s"] == \
        port["weighted"]["dot_flops"] / 989e12
    assert rows[1]["hbm_gib_per_device"] == (
        port["memory"]["argument_bytes_per_device"]
        + port["memory"]["temp_bytes_per_device"]) / 2 ** 30


# -- (e) the kernels' shape rules --------------------------------------------

def _forward_cases():
    from repro_torch.kernels import cascade_gate as cg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs

    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def ring(dev, shapes):
        b, t, h, kv, w, hd = shapes
        return (da.decode_attention,
                [((b, t, h, hd), bf), ((b, w, kv, hd), bf),
                 ((b, w, kv, hd), bf), ((b,), i32), ((b, w), i32)], {},
                da.decode_attention_flops(b, t, h, w, hd), "decode_attention")

    def paged(dev, shapes):
        b, t, h, kv, n, bs, m, hd = shapes
        return (da.paged_decode_attention,
                [((b, t, h, hd), bf), ((n, bs, kv, hd), bf),
                 ((n, bs, kv, hd), bf), ((b,), i32), ((n, bs), i32),
                 ((b, m), i32)], {},
                da.decode_attention_flops(b, t, h, m * bs, hd),
                "paged_decode_attention")

    def flash(dev, shapes, lse=False):
        b, sq, sk, h, kv, hd = shapes
        fn = (lambda q, k, v: fa._forward(q, k, v, True, None, hd ** -0.5,
                                          with_lse=True)) if lse \
            else fa.flash_attention
        return (fn, [((b, sq, h, hd), bf), ((b, sk, kv, hd), bf),
                     ((b, sk, kv, hd), bf)], {},
                fa.flash_attention_flops(b, sq, sk, h, hd), "flash_attention")

    def scan(dev, shapes):
        b, s, w = shapes
        return (rs.rglru_scan, [((b, s, w), f32), ((b, s, w), f32),
                                ((b, w), f32)], {}, 0, "rglru_scan")

    def gate(dev, shapes):
        t, v = shapes
        return (cg.cascade_gate, [((t, v), bf)], {"hi": 0.5, "lo": 0.1}, 0,
                "cascade_gate")

    return {"ring": (ring, (2, 1, 8, 2, 64, 64)),
            "ring_chunk": (ring, (2, 5, 8, 2, 64, 128)),
            "paged": (paged, (2, 1, 8, 2, 12, 16, 4, 64)),
            "flash": (flash, (2, 24, 24, 8, 2, 64)),
            "flash_lse": (functools.partial(flash, lse=True),
                          (1, 16, 40, 4, 4, 128)),
            "scan": (scan, (2, 40, 256)),
            "gate": (gate, (5, 1000))}


def _make(specs, device):
    g = torch.Generator().manual_seed(0)
    out = []
    for shape, dtype in specs:
        if dtype == torch.int32:
            t = torch.randint(0, 8, shape, generator=g, dtype=dtype)
        else:
            t = torch.rand(shape, generator=g).to(dtype) * 0.5 + 0.25
        out.append(t if device == "cpu" else
                   torch.empty(shape, dtype=dtype, device=device))
    return out


@pytest.mark.parametrize("case", list(_forward_cases()))
def test_a_forward_shape_rule_gives_the_plain_versions_outputs(case):
    from repro_torch import kernels
    from repro_torch.launch.fake import fake_mode

    make, shapes = _forward_cases()[case]
    fn, specs, kw, flops, name = make("cpu", shapes)
    want = fn(*_make(specs, "cpu"), **kw)
    want = want if isinstance(want, tuple) else (want,)
    launches, traced, before = (dict(kernels.LAUNCHES), dict(kernels.TRACED),
                                dict(kernels.FLOPS))
    with fake_mode("cuda"):
        got = fn(*_make(specs, "cuda"), **kw)
        got = got if isinstance(got, tuple) else (got,)
        assert all(t.device.type == "cuda" for t in got)
        got = [(tuple(t.shape), t.dtype) for t in got]
    assert got == [(tuple(t.shape), t.dtype) for t in want]
    assert kernels.LAUNCHES == launches
    assert kernels.TRACED[name] == traced[name] + 1
    assert kernels.FLOPS.get(name, 0) - before.get(name, 0) == flops


def test_a_shape_rule_still_runs_the_kernels_input_checks():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch.fake import fake_mode

    with fake_mode("cuda"):
        q = torch.empty((2, 1, 8, 60), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 64, 2, 60), dtype=torch.bfloat16, device="cuda")
        pos = torch.empty((2, 64), dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q, k, k, pos[:, 0], pos)
        q = torch.empty((2, 1, 8, 64), dtype=torch.bfloat16, device="cuda")
        off = torch.empty((2 * 64 * 2 * 64 + 1,), dtype=torch.bfloat16,
                          device="cuda")[1:].view(2, 64, 2, 64)
        with pytest.raises(ValueError, match="16-byte aligned"):
            decode_attention(q, off, off, pos[:, 0], pos)


# -- the guard-free methods of a fake CUDA trace -----------------------------

INDEXES = {"int": 1, "neg": -1, "slice": slice(1, 3), "step": slice(0, 4, 2),
           "none": (slice(None), None), "ellipsis": (Ellipsis, 0),
           "mixed": (0, slice(None), None, -1),
           "tensor": (slice(None), [0, 2, 2]),
           "two": ([0, 1], slice(None), [1, 0]),
           "mask": (slice(None), slice(None), slice(None), [True, False, True,
                                                           True])}


@pytest.mark.parametrize("name", list(INDEXES))
def test_guard_free_indexing_gives_cpu_indexings_shapes(name):
    from repro_torch.launch import fake

    idx = INDEXES[name]
    real = torch.arange(4 * 3 * 5 * 4, dtype=torch.float32).reshape(4, 3, 5,
                                                                     4)

    def index(x, i):
        if isinstance(i, tuple):
            i = tuple(torch.tensor(v, device=x.device) if isinstance(v, list)
                      else v for v in i)
        return x[i]

    want = index(real, idx)
    got = fake._getitem(real, idx if not isinstance(idx, tuple) else tuple(
        torch.tensor(v) if isinstance(v, list) else v for v in idx))
    assert torch.equal(got, want)
    assert got.stride() == want.stride()
    if name != "mask":            # a mask's output size needs the data
        with fake.fake_mode("cuda"):
            x = torch.empty((4, 3, 5, 4), device="cuda")
            y = index(x, idx)
            x[idx if not isinstance(idx, tuple) else tuple(
                torch.tensor(v, device="cuda") if isinstance(v, list) else v
                for v in idx)] = 0.0
            assert tuple(y.shape) == tuple(want.shape)
            assert y.contiguous().is_contiguous()


def test_guard_free_setitem_writes_cpu_indexings_elements():
    from repro_torch.launch import fake

    for idx, value in ((1, 7.0), ((slice(None), [0, 2]), 3.0),
                       ((0, slice(1, 3)), torch.ones(2, 5, 4))):
        want = torch.zeros(4, 3, 5, 4)
        got = want.clone()
        want[idx if not isinstance(idx, tuple) else tuple(
            torch.tensor(v) if isinstance(v, list) else v for v in idx)] = \
            value
        fake._setitem(got, idx if not isinstance(idx, tuple) else tuple(
            torch.tensor(v) if isinstance(v, list) else v for v in idx),
            value)
        assert torch.equal(got, want)


# -- (f) the launcher's production mesh --------------------------------------

@pytest.mark.parametrize("flag, world, shape, tag", [
    ("--production", 256, (16, 16), "pod16x16"),
    ("--multi-pod", 512, (32, 16), "pod2x16x16")])
def test_production_flags_build_the_production_mesh(flag, world, shape, tag):
    import argparse

    from repro_torch.launch import train
    from repro_torch.launch.fake import fake_world

    args = argparse.Namespace(production=flag == "--production",
                              multi_pod=flag == "--multi-pod",
                              device="cpu", arch="glm4-9b", reduced=None)
    with fake_world(world):
        mesh = train.production_mesh(args)
        assert (mesh.shape["data"], mesh.shape["model"]) == shape
        assert (mesh.tag, mesh.size, mesh.rank) == (tag, world, 0)
        assert mesh.device == torch.device("cpu")
        # off --reduced the launcher trains the full config, as repro's
        assert train._config(args).num_layers == 40
        with pytest.raises(RuntimeError, match="dry run"):
            mesh.broadcast_object({"stop": True})


def test_a_world_of_other_size_raises_and_names_the_two():
    import argparse

    from repro_torch.launch import train
    from repro_torch.launch.fake import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    args = argparse.Namespace(production=True, multi_pod=False, device="cpu")
    with fake_world(8):
        with pytest.raises(ValueError, match="256 ranks.*512 ranks"):
            train.production_mesh(args)
        with pytest.raises(ValueError, match="needs its device"):
            from repro_torch.launch.mesh import HostMesh
            HostMesh(2)
    with fake_world(256):
        with pytest.raises(ValueError, match="has 256"):
            make_production_mesh(multi_pod=True, device="cpu")
