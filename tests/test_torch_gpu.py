"""The port on the card: each CUDA kernel against its plain version, and
the engine's paths through the kernels. Marked ``gpu``; every test skips
without a CUDA device. This file imports neither JAX nor ``repro``, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 1e-4 (summation order), bf16 2e-2 (bf16 output rounding,
and the kernel rounds P to bf16 before P V where the plain version keeps
f32). TF32 is off for the f32 comparisons.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

pytestmark = pytest.mark.gpu

# (b, w, h, kv, hd, window, filled, total_pos, t)
DECODE_CASES = [
    (1, 64, 4, 4, 32, None, 64, 64, 1),       # full cache, MHA
    (2, 96, 8, 2, 64, 16, 96, 96, 1),         # window + GQA g=4
    (2, 64, 4, 2, 32, None, 40, 40, 1),       # partially-empty cache
    (2, 64, 4, 2, 32, None, 64, 130, 1),      # ring-wrapped cache
    (1, 48, 4, 2, 32, 24, 48, 130, 1),        # ring-wrapped + window
    (2, 100, 6, 3, 128, None, 100, 100, 1),   # ragged width, hd 128
    (2, 64, 8, 2, 64, 16, 48, 48, 8),         # chunk + window + g=4
    (1, 96, 3, 1, 32, None, 70, 70, 16),      # MQA, bigger chunk
    (1, 64, 48, 1, 64, None, 64, 64, 2),      # 96 rows: two row tiles
]

# (b, sq, sk, h, kv, hd, window)
FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, None),
    (2, 64, 64, 4, 2, 64, None),
    (1, 100, 100, 3, 1, 32, None),            # ragged tail
    (2, 200, 200, 4, 4, 32, 24),              # sliding window
    (1, 1, 96, 4, 2, 32, None),               # right-aligned single query
    (1, 70, 90, 4, 2, 64, 16),                # right-aligned, windowed
    (1, 48, 48, 2, 2, 256, None),             # hd 256
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ring(dev, dt, b, w, h, kv, hd, filled, total_pos, t):
    gen = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((b, t, h, hd), generator=gen)
    k = torch.randn((b, w, kv, hd), generator=gen)
    v = torch.randn((b, w, kv, hd), generator=gen)
    tok = torch.arange(total_pos - filled, total_pos, dtype=torch.int32)
    k_pos = torch.full((b, w), -1, dtype=torch.int32)
    k_pos[:, tok % w] = tok
    start = total_pos if t == 1 else total_pos - t
    q_pos = torch.full((b,), start, dtype=torch.int32)
    return (q.to(dev, dt), k.to(dev, dt), v.to(dev, dt), q_pos.to(dev),
            k_pos.to(dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, w, h, kv, hd, window, filled, total_pos, t = case
    dt = getattr(torch, dtype)
    q, k, v, q_pos, k_pos = _ring(cuda, dt, b, w, h, kv, hd, filled,
                                  total_pos, t)
    n = LAUNCHES["decode_attention"]
    out = decode_attention(q, k, v, q_pos, k_pos, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == n + 1
    plain = decode_attention_plain(q, k, v, q_pos, k_pos, window=window)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max().item() < tol


def test_decode_kernel_empty_rows_are_zero(cuda):
    q, k, v, q_pos, k_pos = _ring(cuda, torch.bfloat16, 2, 64, 4, 2, 32, 40,
                                  40, 1)
    k_pos[1] = -1
    out = decode_attention(q, k, v, q_pos, k_pos)
    assert out[0].abs().sum() > 0 and not out[1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, sk, h, kv, hd, window = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dt) for shape in
               ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    n = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n + 1
    plain = flash_attention_plain(q, k, v, window=window)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max().item() < tol


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn((1, 8, 2, 12), device=cuda)        # head_dim 12
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x[:, :, :1], x[:, :, :1])
    q = torch.randn((1, 1, 2, 16), device=cuda)
    k = torch.randn((1, 8, 1, 16), device=cuda, dtype=torch.float16)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q, k, k, torch.zeros((1,), dtype=torch.int32,
                                              device=cuda), pos)


def test_engine_on_gpu_goes_through_the_kernels(cuda):
    """A tiny model served on the card: K=4 streams equal K=1 streams, and
    every prefill and decode attention was a kernel launch."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=96,
        stages=tcfg.dense_stages(3), param_dtype="float32")
    lm = LM(cfg, device=cuda)
    params = lm.init(0)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9))]
    outs = []
    for k in (1, 4):
        eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                            max_decode_steps=k)
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        assert LAUNCHES == {"flash_attention": 3 * eng.admissions,
                            "decode_attention": 3 * eng.decode_steps}
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
