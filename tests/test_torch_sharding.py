"""Mesh placement of the port against ``repro``'s, without devices.

The port's per-leaf split (``serving.sharding.param_shardings``: the
decode-mode ``launch.sharding_rules`` over ``LM.param_axes``) must equal
``repro``'s ``param_pspecs(AbstractMesh((1, N), ("data", "model")),
*LM.abstract(), mode="decode")`` leaf by leaf for every assigned
architecture at N = 2 and 4, and ``LM.param_axes`` must be ``repro``'s
``LM.abstract()[1]``. The cache specs and the per-device byte accounting
are held against ``repro.serving.sharding.cache_pspecs`` and ``repro``'s
backend walkers. An ``AbstractMesh`` is enough: rank 0's shapes need no
process group.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as repro_config
from repro.launch.sharding_rules import param_pspecs
from repro.models.model import LM as RLM
from repro.serving import kv_cache as rkv
from repro.serving.sharding import cache_pspecs as repro_cache_pspecs
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, dense_stages
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import LM
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import slots_for_hbm
from repro_torch.serving.sharding import cache_pspecs, param_shardings
from repro_torch.sharding import resolve, tensor_parallel


def _flat(tree, pre=""):
    """{path: leaf} over nested dicts and lists, paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)) and tree and not isinstance(
            tree[0], (str, type(None))):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}[{i}]"))
        return out
    return {pre: tree}


def _repro_flat(tree, leaf_type):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]}


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_axes_match_repro(name):
    _, axes = RLM(repro_config(name)).abstract()
    want = _repro_flat(axes, tuple)
    got = _flat(LM(get_config(name), device="cpu").param_axes())
    assert set(got) == set(want)
    for path, ax in got.items():
        assert tuple(ax) == tuple(want[path]), path


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_split_matches_repro_decode_pspecs(name, ways):
    """Every leaf's split at N ways is ``repro``'s decode-mode spec, and
    the mesh takes every assigned architecture (no assigned architecture's
    query heads straddle KV groups). The plan's fields (heads, KV, the
    dense MLP, vocab; MLA heads; experts, this rank's expert range, d_ff
    inside every expert, the router, the shared expert; the RG-LRU width,
    the recurrent heads and the sLSTM GeGLU's columns) split exactly what
    the specs split, and a model with no dense MLP has ``mlp`` False."""
    abstract, axes = RLM(repro_config(name)).abstract()
    ref = param_pspecs(AbstractMesh((1, ways), ("data", "model")), abstract,
                       axes, mode="decode")
    want = {k: tuple(v) for k, v in _repro_flat(ref, PartitionSpec).items()}
    cfg = get_config(name)
    got = _flat(param_shardings(tmesh.AbstractMesh(ways),
                                LM(cfg, device="cpu")))
    assert got == want
    tp = tensor_parallel(cfg, tmesh.AbstractMesh(ways))
    mixers = {b.mixer for st in cfg.stages for b in st.blocks}

    def leaf(block, key):
        """The spec of ``key`` in every stage's ``block`` ('mixer' or
        'mlp') that holds it."""
        return {v for k, v in got.items() if k.startswith("['stages']")
                and k.endswith(f"['{block}']['{key}']")}

    lru = leaf("mixer", "w_in_x")
    assert ("rglru" in mixers) == bool(lru)
    assert tp.lru == (lru == {(None, "data", "model")})   # (L, D, W)
    if tp.lru:
        # the channels' leaves split with it; the gates' second LRU axis
        # finds 'model' used, so their rows alone split
        assert leaf("mixer", "lam") == {(None, "model")}
        assert leaf("mixer", "w_rgate") == {(None, "model", None)}
        assert leaf("mixer", "w_out") == {(None, "model", None)}
    heads = {v[3] for v in leaf("mixer", "wx")}          # (L, D, 4, H, hd)
    if "mlstm" in mixers:
        heads |= {v[2] for v in leaf("mixer", "wq")}     # (L, D, H, hd)
    assert bool(heads) == bool(mixers & {"mlstm", "slstm"})
    assert tp.rec_heads == (heads == {"model"})
    up = {v[2] for v in leaf("mixer", "w_up1")}          # (L, H hd, 2 D)
    assert tp.rec_mlp == (up == {"model"})
    if name == "xlstm-125m":
        # d_ff = 0: no dense MLP; the sLSTM's 2 d_model GeGLU splits
        assert not tp.mlp and tp.rec_mlp and tp.rec_heads
    dense = [v for k, v in got.items() if k.startswith("['stages']")
             and k.endswith("['mlp']['w_down']") and len(v) == 3]
    assert tp.mlp == (bool(dense) and dense[0][1] == "model")
    if cfg.frontend.kind == "vision":
        # EMBED resolves to ('data',) of size 1: the projector stays whole
        assert "model" not in got["['vision_proj']['w1']"] + \
            got["['vision_proj']['w2']"]
    # the plan splits exactly what the specs split
    blocks = {b: got[k] for k in got for b in ("wq", "wk", "w_uq", "wo")
              if k.startswith("['stages']") and k.endswith(
                  f"['mixer']['{b}']")}
    mlp = {k.split("['mlp']")[1]: v for k, v in got.items()
           if k.startswith("['stages']") and "['mlp']" in k}
    vocab_dim = 1 if cfg.frontend.kind == "audio" else 0   # (C, V, D)
    assert tp.vocab == (got["['embed']['table']"][vocab_dim] == "model")
    if cfg.mla is None:
        assert tp.heads == (blocks["wq"][2] == "model")
        assert tp.kv == (blocks["wk"][2] == "model")
        assert not tp.mla_heads
    else:
        assert tp.mla_heads == (blocks["w_uq"][2] == "model")
        assert tp.mla_heads == (blocks["wo"][1] == "model")
    if cfg.moe is None:
        assert not (tp.experts or tp.expert_mlp or tp.router
                    or tp.shared_mlp)
        return
    e = cfg.moe.num_experts
    gate, down = mlp["['w_gate']"], mlp["['w_down']"]
    assert tp.experts == (gate[1] == ("data", "model"))
    assert tp.expert_range == ((0, e // ways) if tp.experts else (0, e))
    assert tp.expert_mlp == (gate[3] == "model") == (down[2] == "model")
    assert tp.router == (mlp["['router']"][2] == "model")
    if cfg.moe.num_shared_experts:
        assert tp.shared_mlp == (mlp["['shared']['w_gate']"][2] == "model")
        assert tp.shared_mlp == (mlp["['shared']['w_down']"][1] == "model")
    else:
        assert not tp.shared_mlp


def test_resolve_drops_splits_that_do_not_divide():
    rules = {"a": "model", "b": ("data", "model"), "c": "model"}
    mesh = {"data": 1, "model": 4}
    assert resolve(rules, ("a", "c"), (8, 8), mesh) == ("model", None)
    assert resolve(rules, ("a", None), (6, 8), mesh) == (None, None)
    assert resolve(rules, ("b",), (8,), mesh) == (("data", "model"),)


def test_straddled_kv_groups_refuse():
    """12 heads over 2 KV heads, 3 ways: 4 query heads a rank against KV
    groups of 6 — the engine's constructor (``tensor_parallel``) refuses
    and says why; 4 ways (3 heads a rank, in one group) and 6 ways serve."""
    cfg = ModelConfig(name="straddle", family="dense", source="test",
                      num_layers=1, d_model=64, num_heads=12,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                      stages=dense_stages(1))
    with pytest.raises(NotImplementedError, match="straddle"):
        tensor_parallel(cfg, tmesh.AbstractMesh(3))
    assert tensor_parallel(cfg, tmesh.AbstractMesh(4)).kv_range == (0, 1)
    assert tensor_parallel(cfg, tmesh.AbstractMesh(6)).kv_range == (0, 1)


def _tiny(kv):
    kw = dict(num_layers=2, d_model=64, num_heads=4 if kv != 3 else 9,
              num_kv_heads=kv, head_dim=16, d_ff=128, vocab_size=256,
              stages=dense_stages(2), param_dtype="float32")
    from repro.configs.base import ModelConfig as RConfig
    return (ModelConfig(name="tiny", family="dense", source="test", **kw),
            RConfig(name="tiny", family="dense", source="test", **kw))


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("kv,ways", [(4, 2), (4, 4), (2, 4), (3, 2)])
def test_cache_specs_and_bytes_match_repro(kind, kv, ways):
    cfg, rcfg = _tiny(kv)
    rlm = RLM(rcfg, kv_chunk=16)
    rparams, _ = rlm.init(jax.random.PRNGKey(0))
    kw = dict(batch_slots=3, max_seq_len=64)
    if kind == "paged":
        kw.update(block_size=8, num_blocks=20)
    rb = rkv.make_backend(kind, rlm, rparams, **kw)
    rmesh = AbstractMesh((1, ways), ("data", "model"))
    rstate = jax.eval_shape(rb.init)
    want = {k: tuple(v) for k, v in _repro_flat(
        repro_cache_pspecs(rmesh, rstate), PartitionSpec).items()}
    tb = tkv.make_backend(kind, LM(cfg, device="cpu"), **kw)
    got = _flat(cache_pspecs(tmesh.AbstractMesh(ways), tb.init()))
    got = {k: v for k, v in got.items() if v is not None}
    assert got == want
    rb.note_placement(rmesh)
    tb.note_placement(tmesh.AbstractMesh(ways))
    assert tb.kv_shards == rb.kv_shards == ways
    assert tb.hbm_bytes() == rb.hbm_bytes()
    assert tb.hbm_bytes_per_device() == rb.hbm_bytes_per_device()
    if kind == "paged":
        assert tb.block_bytes_per_device() == rb.block_bytes_per_device()
    # rank 0's state is the shard the walkers count
    state = tb.init()
    held = sum(t.numel() * t.element_size()
               for _, t in tkv._leaves(state["caches"]))
    assert held == tb.hbm_bytes_per_device()
    split = kv % ways == 0
    assert (tb.hbm_bytes_per_device() < tb.hbm_bytes()) == split


def test_slots_for_hbm_scaling():
    slot = 1000
    per_dev = 8 * slot
    assert slots_for_hbm(per_dev, slot, mesh_size=1) == 8
    assert slots_for_hbm(per_dev, slot, mesh_size=2) == 16
    assert slots_for_hbm(per_dev, slot, mesh_size=4) == 32
    assert slots_for_hbm(per_dev, slot, mesh_size=4, cap=20) == 20


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_kv_range_reads_the_range_in_place(paged):
    """``kv_range`` attends a range of the cache's KV heads: the same as
    attending a copy of that range (the plain versions here; the card
    tests hold the kernels)."""
    g = torch.Generator().manual_seed(0)
    b, t, h, hd, kv, w = 2, 3, 4, 16, 4, 24
    q = torch.randn(b, t, h, hd, generator=g)
    qpos = torch.tensor([5, 20], dtype=torch.int32)
    if paged:
        n, bs = 7, 8
        k = torch.randn(n, bs, kv, hd, generator=g)
        v = torch.randn(n, bs, kv, hd, generator=g)
        kpos = torch.arange(n * bs, dtype=torch.int32).reshape(n, bs) % 24
        tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)

        def run(kk, vv, rng=None):
            return paged_decode_attention(q, kk, vv, qpos, kpos, tables,
                                          kv_range=rng)
    else:
        k = torch.randn(b, w, kv, hd, generator=g)
        v = torch.randn(b, w, kv, hd, generator=g)
        kpos = torch.arange(w, dtype=torch.int32)[None].repeat(b, 1)

        def run(kk, vv, rng=None):
            return decode_attention(q, kk, vv, qpos, kpos, kv_range=rng)
    for first, count in ((1, 1), (2, 2), (0, 4)):
        want = run(k[..., first:first + count, :].contiguous(),
                   v[..., first:first + count, :].contiguous())
        np.testing.assert_array_equal(run(k, v, (first, count)).numpy(),
                                      want.numpy())
