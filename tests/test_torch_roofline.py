"""The port's roofline analysis (``repro_torch.analysis``) against
``repro.analysis.roofline``.

``param_counts`` equals ``repro``'s, total and active, for every assigned
architecture; ``roofline_from_record`` reads ``repro``'s record keys and
gives its result keys, with the H100's figures in place of the TPU's. Each
hand-written kernel's FLOP formula (what its wrapper adds to
``kernels.FLOPS`` where it launches) equals what ``FlopCounterMode``
counts over its plain version at the same shapes, so ``step_record``
counts a step alike on the card and on the CPU; the scan and the gate
compute elementwise, which the mode counts as nothing. ``step_record``
adds the wrappers' FLOPs and the collectives' bytes to the mode's count.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS


def _counted(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return counter.get_total_flops()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_equal_repros(arch):
    from repro.analysis.roofline import param_counts as theirs

    from repro_torch.analysis import param_counts

    assert param_counts(arch) == theirs(arch)


def _record(flops, nbytes, coll, mode="decode"):
    return {"arch": "smollm-135m", "shape": "decode_32k", "mesh": "2x2",
            "devices": 4, "mode": mode, "seq_len": 4096, "global_batch": 8,
            "cost": {"flops": flops, "bytes accessed": nbytes},
            "collectives": {"all_reduce": {"count": 3, "bytes": coll}},
            "memory": {"temp_bytes_per_device": 2 ** 30,
                       "argument_bytes_per_device": 2 ** 31}}


@pytest.mark.parametrize("term, rec", [
    ("compute", _record(1e15, 1e6, 1e3, "train")),
    ("memory", _record(1e6, 1e12, 1e3, "prefill")),
    ("collective", _record(1e6, 1e6, 1e12)),
])
def test_roofline_from_record_matches_repros_keys_and_dominant(term, rec):
    """A hand-made record, each term far ahead of the others under both
    packages' figures: the same keys, the same dominant term and usefulness
    ratio, and each time the H100's figure over the work."""
    from repro.analysis.roofline import roofline_from_record as theirs

    from repro_torch.analysis import roofline_from_record
    from repro_torch.launch import mesh

    counts = {"total": 2e8, "active": 1e8}
    got, want = roofline_from_record(rec, counts), theirs(rec, counts)
    assert set(got) == set(want)
    assert got["dominant"] == want["dominant"] == term
    for key in ("model_flops", "hlo_flops_total", "useful_ratio",
                "hbm_gib_per_device", "arch", "shape", "mesh", "mode"):
        assert got[key] == want[key], key
    assert got["t_compute_s"] == rec["cost"]["flops"] / mesh.PEAK_FLOPS_BF16
    assert got["t_memory_s"] == rec["cost"]["bytes accessed"] / mesh.HBM_BW
    assert got["t_collective_s"] == \
        rec["collectives"]["all_reduce"]["bytes"] / mesh.NVLINK_BW
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("t, kv_range", [(1, None), (3, None), (2, (1, 1))])
def test_decode_flops_equal_the_plain_ring_count(t, kv_range):
    from repro_torch.kernels.decode_attention import (decode_attention_flops,
                                                      decode_attention_plain)

    b, h, kv, w, hd = 2, 4, 2, 16, 8
    g = _gen(0)
    rows = kv if kv_range is None else kv_range[1]
    q = torch.randn(b, t, h // kv * rows, hd, generator=g)
    k, v = (torch.randn(b, w, kv, hd, generator=g) for _ in range(2))
    qp = torch.arange(t).repeat(b, 1) + 12
    kp = torch.arange(w).repeat(b, 1)
    got = _counted(decode_attention_plain, q, k, v, qp, kp,
                   kv_range=kv_range)
    assert got == decode_attention_flops(b, t, q.shape[2], w, hd) > 0


def test_paged_flops_equal_the_plain_paged_count():
    from repro_torch.kernels.decode_attention import (
        decode_attention_flops, paged_decode_attention_plain)

    b, t, h, kv, n, bs, m, hd = 2, 2, 6, 3, 7, 4, 3, 8
    g = _gen(1)
    q = torch.randn(b, t, h, hd, generator=g)
    k, v = (torch.randn(n, bs, kv, hd, generator=g) for _ in range(2))
    kp = torch.arange(n * bs).reshape(n, bs)
    tables = torch.tensor([[1, 2, -1], [4, 0, 5]], dtype=torch.int32)
    qp = torch.tensor([[9, 10], [11, 12]])
    got = _counted(paged_decode_attention_plain, q, k, v, qp, kp, tables)
    assert got == decode_attention_flops(b, t, h, m * bs, hd) > 0


@pytest.mark.parametrize("sq, sk, window", [(8, 8, None), (5, 12, None),
                                            (8, 8, 3)])
def test_flash_flops_equal_the_plain_counts(sq, sk, window):
    """The forward with and without its log-sum-exp, and the backward."""
    from repro_torch.kernels import flash_attention as fa

    b, h, kv, hd = 2, 4, 2, 16
    g = _gen(2)
    q = torch.randn(b, sq, h, hd, generator=g)
    k, v = (torch.randn(b, sk, kv, hd, generator=g) for _ in range(2))
    fwd = fa.flash_attention_flops(b, sq, sk, h, hd)
    assert _counted(fa.flash_attention_plain, q, k, v, window=window) == fwd
    assert _counted(fa.flash_attention_fwd_plain, q, k, v,
                    window=window) == fwd
    out, lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
    dout = torch.randn(out.shape, generator=g)
    assert _counted(fa.flash_attention_bwd_plain, q, k, v, out, lse, dout,
                    window=window) == fa.flash_attention_bwd_flops(
                        b, sq, sk, h, hd) > 0


def test_flash_lse_is_the_log_sum_exp_of_the_visible_scores():
    """The plain forward's log-sum-exp, computed from the scores its output
    used, against a direct one."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain

    g = _gen(3)
    q = torch.randn(1, 4, 4, 8, generator=g)
    k = torch.randn(1, 6, 2, 8, generator=g)
    _, lse = flash_attention_fwd_plain(q, k, k, causal=True)
    s = torch.einsum("bqhd,bchd->bqhc", q, k.repeat_interleave(2, 2)) \
        * 8 ** -0.5
    visible = torch.arange(6)[None] <= torch.arange(4)[:, None] + 2
    want = torch.logsumexp(s.masked_fill(~visible[None, :, None],
                                         -torch.inf), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_scan_and_gate_count_no_matrix_products():
    from repro_torch.kernels.cascade_gate import cascade_gate_plain
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                                rglru_scan_plain)

    g = _gen(4)
    a, b = (torch.rand(2, 5, 8, generator=g) for _ in range(2))
    h0 = torch.zeros(2, 8)
    assert _counted(rglru_scan_plain, a, b, h0) == 0
    h, _ = rglru_scan_plain(a, b, h0)
    assert _counted(rglru_scan_bwd_plain, a, h, h0, torch.ones_like(h),
                    torch.ones_like(h0)) == 0
    assert _counted(cascade_gate_plain, torch.randn(6, 32, generator=g),
                    0.5, 0.1) == 0


def test_step_record_adds_the_kernels_and_the_collectives():
    """What the wrappers add to ``kernels.FLOPS`` and the mesh to
    ``COLLECTIVE_BYTES`` inside the step is in the record beside the
    mode's own count; the bytes are the parameters' plus the cache's."""
    from repro_torch.analysis import roofline_from_record, step_record
    from repro_torch.kernels import FLOPS
    from repro_torch.launch.mesh import COLLECTIVE_BYTES, COLLECTIVES

    w = torch.randn(16, 32)
    x = torch.randn(4, 16)

    def step():
        x @ w                                        # 2 * 4 * 16 * 32
        FLOPS["flash_attention"] += 1000
        for key, n in (("all_reduce/model", 256), ("all_gather/data", 64),
                       ("all_reduce/data", 8)):
            COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1
            COLLECTIVE_BYTES[key] = COLLECTIVE_BYTES.get(key, 0) + n

    rec = step_record(step, arch="smollm-135m", mode="train", seq_len=16,
                      global_batch=4, params={"w": w}, cache_bytes=100,
                      devices=2)
    assert rec["cost"] == {"flops": 2 * 4 * 16 * 32 + 1000,
                           "bytes accessed": 16 * 32 * 4 + 100}
    assert rec["collectives"] == {"all_reduce": {"count": 2, "bytes": 264},
                                  "all_gather": {"count": 1, "bytes": 64}}
    assert rec["memory"]["temp_bytes_per_device"] is None
    row = roofline_from_record(rec, {"total": 10.0, "active": 10.0})
    assert row["model_flops"] == 6 * 10.0 * 16 * 4
    assert row["hlo_flops_total"] == 2 * rec["cost"]["flops"]


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_counts_each_collectives_result_bytes(one_rank_group):
    """A reduction counts its float32 payload, a gloo gather the joined
    tensor it reduces, a host message nothing; the calls are counted as
    before."""
    from repro_torch.launch.mesh import (COLLECTIVE_BYTES, COLLECTIVES,
                                         make_host_mesh)

    mesh = make_host_mesh(1)
    calls, nbytes = dict(COLLECTIVES), dict(COLLECTIVE_BYTES)
    mesh.all_reduce(torch.ones(4, 8, dtype=torch.bfloat16))
    mesh.gather(torch.ones(3, 2), -1)
    mesh.broadcast_object({"x": 1})
    grew = {k: (COLLECTIVES[k] - calls.get(k, 0),
                COLLECTIVE_BYTES.get(k, 0) - nbytes.get(k, 0))
            for k in COLLECTIVES if COLLECTIVES[k] != calls.get(k, 0)}
    assert grew == {"all_reduce/model": (2, 4 * 8 * 4 + 3 * 2 * 4),
                    "broadcast/world": (1, 0)}
