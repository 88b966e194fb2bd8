#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py [--out FILE.json]``.
It needs a CUDA GPU and ``nvcc``, and fails (nonzero exit, no result line)
without them. Phases, each fatal on failure:

1. print the card and build every kernel from ``src/repro_torch/kernels``;
2. each kernel against its plain PyTorch version on the card, in bf16 at
   the serving path's shapes, with its time, the plain version's, the time
   of one PyTorch library call computing the same function (a yardstick
   the port never calls; for the paged kernel, attention over the context
   gathered beforehand, gather excluded) and its bound on this card;
3. smollm-135m at full width (30 layers, random weights from a seed):
   prefill-then-decode logits equal a full forward, and the GPU forward
   equals the plain CPU forward in f32;
4. a ``ServingEngine`` (ring cache, 8 slots, max_seq_len 1024, 4 decode
   steps per host sync) serves 18 requests; every request finishes, the
   streams equal a 1-step engine's, greedy tokens agree with a
   teacher-forced forward, and the launch counters show every prefill
   and decode attention went through the kernels;
5. a paged ``ServingEngine`` (block size 16, chunked prefill of 128-token
   chunks, prefix sharing, K = 4) serves two waves: 12 requests, 6 of them
   sharing a 256-token prefix, then 2 higher-class requests once all 8
   slots decode (swap preemption), then a prompt that is exactly the
   prefix (copy-on-write of a retained block) and the prefix plus a tail.
   Every request finishes, the allocator's invariants hold after each
   wave, the streams equal a K = 1 paged engine's and an uncontended
   engine's (nothing preempted), greedy tokens agree with a teacher-forced
   forward, and every paged attention call (30 per decode step and per
   chunk) went through ``paged_decode_attention``;
6. the one-shot cascade: ``CascadeEngine`` on 64 queries of 128 tokens,
   smollm-135m as the cloud (seed) and its 4-layer edge draft (seed + 1),
   thresholds between the edge confidences' tertiles, compact and lockstep
   at capacity_frac 0.5: all three routes occur, routes agree, the
   kernel's counts equal the host's, predictions agree wherever the
   cloud's top-2 margin clears the bf16 logits tolerance, and each query
   gates through one ``cascade_gate`` launch;
7. the generative cascade: ``CascadeServingEngine`` (ring, 8 slots,
   max_seq_len 1024, K = 4) serves 24 requests of 16-480 tokens with
   tertile thresholds, the first accepted and the first escalated one
   sampled at 0.8: every request finishes, each route takes at least
   4, dropped outputs are empty, accepted and escalated streams equal
   standalone edge and cloud engines' token for token, every gate is one
   ``cascade_gate`` launch and every prefill and decode attention a kernel
   launch.

Phase 2 also times ``cascade_gate`` at T = 1 (the serving gate) and
T = 64 (the one-shot batch) over smollm's 49152-entry vocab in f32 and
bf16, against ``torch.logsumexp`` as the library yardstick.

With ``--profile`` it then serves the phase-4 and phase-7 traces once
more under ``torch.profiler`` and prints the device's busy time by kernel
against the unprofiled run's wall time (the idle share).

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. TF32 is off for every f32 product.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 peak outside the tensor cores
BF16_TOL = 2e-2                # bf16 output rounding + P rounded to bf16
# logits of two bf16 paths through 30 layers (flash over the whole
# sequence vs prefill + cached decode) differ by activation roundings
BF16_LOGIT_TOL = 0.25
F32_LOGIT_TOL = 2e-3           # the same, in f32: summation order only
# the gate's confidence, kernel vs plain (relative): summation order only,
# for bf16 logits too (both sides read the same bf16 values, exact in f32,
# and sum in f32)
GATE_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
GATE_MARGIN = 1e-3             # no confidence this close (relative) to a threshold
LAYERS = 30                    # distinct inputs per timing loop (cold L2)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, from CUDA events around each of n calls.
    A device-side sleep first lets the host enqueue all n calls ahead of
    the device, so the events see kernel time, not launch gaps."""

    def __init__(self, torch):
        self.torch = torch
        s, e = self._events(2)
        s.record()
        torch.cuda._sleep(20_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 20_000_000 / s.elapsed_time(e)

    def _events(self, n):
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(n)]

    def __call__(self, fn, n: int = 25) -> float:
        torch = self.torch
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        starts, ends = self._events(n), self._events(n)
        torch.cuda._sleep(int(self.cycles_per_ms * (2 * n * host_ms + 5)))
        for i in range(n):
            starts[i].record()
            fn(i)
            ends[i].record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e)
                                 for s, e in zip(starts, ends))


def _bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# -- phase 2: kernels ----------------------------------------------------------

def check_decode(torch, timer, dev):
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    import torch.nn.functional as F

    b, w, kv, g, hd = 8, 1024, 3, 3, 64
    h = kv * g
    gen = torch.Generator(device=dev).manual_seed(1)
    ks = torch.randn((LAYERS, b, w, kv, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vs = torch.randn((LAYERS, b, w, kv, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    # per slot: filled prefix, ring-wrapped, all-empty rows (serving mix)
    totals = [300, 512, 2524, 0, 17, 900, 1023, 1500]
    k_pos = torch.full((b, w), -1, dtype=torch.int32)
    for i, total in enumerate(totals):
        tok = torch.arange(max(0, total - w), total, dtype=torch.int32)
        k_pos[i, tok % w] = tok
    k_pos = k_pos.to(dev)
    q_pos = torch.tensor(totals, dtype=torch.int32, device=dev)
    q1 = torch.randn((LAYERS, b, 1, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q16 = torch.randn((b, 16, h, hd), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    errs = []
    cases = [("T=1", q1[0], q_pos, None), ("T=1 window=256", q1[0], q_pos, 256),
             ("T=16", q16, torch.clamp(q_pos - 15, min=0), None)]
    for label, q, qp, window in cases:
        out = decode_attention(q, ks[0], vs[0], qp, k_pos, window=window)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, ks[0], vs[0], qp, k_pos,
                                     window=window)
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  decode_attention {label}: max|kernel - plain| = {err:.3e}"
              f" (tol {BF16_TOL})")
        if not err < BF16_TOL:
            raise AssertionError(f"decode_attention {label} disagrees")
        if not torch.all(out[3] == 0):
            raise AssertionError("decode_attention: empty ring row not 0")
        errs.append(err)

    def kern(i):
        return decode_attention(q1[i % LAYERS], ks[i % LAYERS],
                                vs[i % LAYERS], q_pos, k_pos)

    def plain(i):
        return decode_attention_plain(q1[i % LAYERS], ks[i % LAYERS],
                                      vs[i % LAYERS], q_pos, k_pos)

    mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[:, None, None, :]
    qt = [q1[i].transpose(1, 2) for i in range(LAYERS)]
    kt = [ks[i].transpose(1, 2) for i in range(LAYERS)]
    vt = [vs[i].transpose(1, 2) for i in range(LAYERS)]

    def library(i):
        j = i % LAYERS
        return F.scaled_dot_product_attention(qt[j], kt[j], vt[j],
                                              attn_mask=mask, enable_gqa=True)

    ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
    # the bytes this input needs: q, out, both position arrays, and the K/V
    # rows some query may see (tiles of empty slots are never read)
    live = int(((k_pos >= 0) & (k_pos <= q_pos[:, None])).sum())
    nbytes = (2 * _nbytes(q1[0]) + _nbytes(q_pos, k_pos)
              + 2 * live * kv * hd * 2)
    flops = 4 * live * h * hd
    bound, by = _bound_ms(nbytes, flops)
    print(f"  decode_attention B={b} W={w} KV={kv} G={g} hd={hd} T=1 bf16: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


def check_flash(torch, timer, dev):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F

    h, kv, hd = 9, 3, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = []
    for s, window in ((128, None), (512, None), (512, 128)):
        q = torch.randn((1, s, h, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((1, s, kv, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=True, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  flash_attention S={s} window={window}: max|kernel - plain|"
              f" = {err:.3e} (tol {BF16_TOL})")
        if not err < BF16_TOL:
            raise AssertionError(f"flash_attention S={s} disagrees")
        errs.append(err)
    s = 512
    qs = torch.randn((LAYERS, 1, s, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    ks, vs = (torch.randn((LAYERS, 1, s, kv, hd), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    qt = [qs[i].transpose(1, 2) for i in range(LAYERS)]
    kt = [ks[i].transpose(1, 2) for i in range(LAYERS)]
    vt = [vs[i].transpose(1, 2) for i in range(LAYERS)]

    def kern(i):
        j = i % LAYERS
        return flash_attention(qs[j], ks[j], vs[j], causal=True)

    def plain(i):
        j = i % LAYERS
        return flash_attention_plain(qs[j], ks[j], vs[j], causal=True)

    def library(i):
        j = i % LAYERS
        return F.scaled_dot_product_attention(qt[j], kt[j], vt[j],
                                              is_causal=True, enable_gqa=True)

    ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
    pairs = s * (s + 1) // 2                    # causal (query, key) pairs
    flops = 4 * pairs * h * hd
    nbytes = 2 * _nbytes(qs[0]) + _nbytes(ks[0], vs[0])
    bound, by = _bound_ms(nbytes, flops)
    print(f"  flash_attention B=1 S={s} H={h} KV={kv} hd={hd} causal bf16: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


def _paged_pool(rng, fills, bs, m, n_blocks, holes=()):
    """Block tables and per-token positions for ``fills`` tokens per slot
    over shuffled pool blocks (block 0 is trash; a fill of 0 is a freed
    slot, its row all -1); ``holes`` (slot, entry) punch -1 into a row."""
    order = iter(rng.permutation(np.arange(1, n_blocks)))
    pos = np.full((n_blocks, bs), -1, np.int32)
    bt = np.full((len(fills), m), -1, np.int32)
    for s, fill in enumerate(fills):
        for j in range(-(-fill // bs)):
            blk = next(order)
            bt[s, j] = blk
            tok = np.arange(j * bs, min(fill, (j + 1) * bs))
            pos[blk, tok - j * bs] = tok
    for s, j in holes:
        bt[s, j] = -1
    return pos, bt


def check_paged(torch, timer, dev):
    from repro_torch.kernels.decode_attention import (
        gather_paged_kv, paged_decode_attention, paged_decode_attention_plain)
    import torch.nn.functional as F

    b, kv, g, hd, max_seq = 8, 3, 3, 64, 1024
    h = kv * g
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    # per slot: 1, 17, 200, 480 and 1000 tokens, a freed slot, a table
    # with holes, and one more partial fill
    fills = [1, 17, 200, 480, 1000, 0, 700, 333]
    holes = [(6, 3), (6, 10), (6, 20)]

    def case(bs, n_layers=1):
        m = max_seq // bs
        n_blocks = b * m + 1
        pos, bt = _paged_pool(rng, fills, bs, m, n_blocks, holes)
        k, v = (torch.randn((n_layers, n_blocks, bs, kv, hd), generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        return (k, v, torch.from_numpy(pos).to(dev),
                torch.from_numpy(bt).to(dev))

    q_pos = torch.tensor([max(f - 1, 0) for f in fills], dtype=torch.int32,
                         device=dev)
    ks, vs, k_pos, bt = case(16, LAYERS)
    q1 = torch.randn((LAYERS, b, 1, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    # chunked prefill: 128 tokens at 256..383 of slot 4, its table cut to
    # the 512 positions below the next power of two (the engine's ctx)
    qc = torch.randn((1, 128, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    cases = [("bs=16 T=1", q1[0], ks[0], vs[0], q_pos, k_pos, bt, None),
             ("bs=16 T=1 window=256", q1[0], ks[0], vs[0], q_pos, k_pos, bt,
              256),
             ("bs=16 T=128 chunk", qc, ks[0], vs[0],
              torch.tensor([256], dtype=torch.int32, device=dev), k_pos,
              bt[4:5, :32].contiguous(), None)]
    for bs in (8, 32):
        k2, v2, p2, bt2 = case(bs)
        cases.append((f"bs={bs} T=1", q1[0], k2[0], v2[0], q_pos, p2, bt2,
                      None))
    errs = []
    for label, q, k, v, qp, kp, table, window in cases:
        out = paged_decode_attention(q, k, v, qp, kp, table, window=window)
        torch.cuda.synchronize()
        ref = paged_decode_attention_plain(q, k, v, qp, kp, table,
                                           window=window)
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  paged_decode_attention {label}: max|kernel - plain| = "
              f"{err:.3e} (tol {BF16_TOL})")
        if not err < BF16_TOL:
            raise AssertionError(f"paged_decode_attention {label} disagrees")
        if q.shape[0] == b and not torch.all(out[5] == 0):
            raise AssertionError("paged_decode_attention: freed slot not 0")
        errs.append(err)

    def kern(i):
        j = i % LAYERS
        return paged_decode_attention(q1[j], ks[j], vs[j], q_pos, k_pos, bt)

    def plain(i):
        j = i % LAYERS
        return paged_decode_attention_plain(q1[j], ks[j], vs[j], q_pos,
                                            k_pos, bt)

    # the yardstick reads a context gathered beforehand: no single PyTorch
    # call attends through block tables
    _, ctx_pos = gather_paged_kv(ks[0], k_pos, bt)
    visible = (ctx_pos >= 0) & (ctx_pos <= q_pos[:, None])
    mask = visible[:, None, None, :]
    qt = [q1[i].transpose(1, 2) for i in range(LAYERS)]
    kt = [gather_paged_kv(ks[i], k_pos, bt)[0].transpose(1, 2)
          for i in range(LAYERS)]
    vt = [gather_paged_kv(vs[i], k_pos, bt)[0].transpose(1, 2)
          for i in range(LAYERS)]

    def library(i):
        j = i % LAYERS
        return F.scaled_dot_product_attention(qt[j], kt[j], vt[j],
                                              attn_mask=mask, enable_gqa=True)

    ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
    # the bytes this input needs: q, out, q_pos, the tables, one position
    # per token of each table block, and the K/V rows some query may see
    live = int(visible.sum())
    table_blocks = int((bt >= 0).sum())
    nbytes = (2 * _nbytes(q1[0]) + _nbytes(q_pos, bt)
              + table_blocks * k_pos.shape[1] * k_pos.element_size()
              + 2 * live * kv * hd * ks.element_size())
    flops = 4 * live * h * hd
    bound, by = _bound_ms(nbytes, flops)
    print(f"  paged_decode_attention B={b} bs={k_pos.shape[1]} M=64 KV={kv} G={g} hd={hd} "
          f"T=1 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa on "
          f"the pre-gathered context (gather excluded) {lib_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


def _tertiles(conf):
    """hi/lo midway between neighbouring sorted confidences at the
    tertiles, or at the nearest split (up to 2 away) whose neighbours lie
    farther than GATE_MARGIN (relative) from the midpoint; fails if a
    confidence still lies that close to either."""
    srt = np.sort(np.asarray(conf, np.float64))
    n = len(srt)

    def cut(k):
        cands = [j for j in (k, k - 1, k + 1, k - 2, k + 2) if 0 < j < n]
        wide = [j for j in cands if srt[j] / srt[j - 1] > 1 + 4 * GATE_MARGIN]
        i = wide[0] if wide else cands[0]
        return float((srt[i] + srt[i - 1]) / 2)

    hi, lo = cut(2 * n // 3), cut(n // 3)
    for th in (hi, lo):
        if np.min(np.abs(srt - th)) <= GATE_MARGIN * th:
            raise AssertionError(f"a confidence lies within {GATE_MARGIN} "
                                 f"of the threshold {th:.6g}")
    return hi, lo


def check_cascade_gate(torch, timer, dev):
    from repro_torch.kernels.cascade_gate import (cascade_gate,
                                                  cascade_gate_plain)

    v = 49152                      # smollm-135m's padded vocab
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [(t, v, dt) for t in (1, 64) for dt in ("float32", "bfloat16")]
    cases += [(100, 500, "float32"), (7, 8000, "float32")]
    errs = []
    for t, vv, dtype in cases:
        x = (torch.randn((t, vv), generator=gen, device=dev) * 3).to(
            getattr(torch, dtype))
        conf0 = cascade_gate_plain(x, 1.0, 0.0)[0].cpu().numpy()
        hi, lo = _tertiles(conf0) if t >= 3 else (2.0, 0.0)
        conf, routes, counts = cascade_gate(x, hi=hi, lo=lo)
        torch.cuda.synchronize()
        pconf, proutes, pcounts = cascade_gate_plain(x, hi, lo)
        rel = ((conf - pconf).abs() / pconf).max().item()
        err = (conf - pconf).abs().max().item()
        near = (((pconf - hi).abs() < GATE_MARGIN * hi)
                | ((pconf - lo).abs() < GATE_MARGIN * max(lo, 1e-30)))
        print(f"  cascade_gate T={t} V={vv} {dtype}: max|kernel - plain| = "
              f"{err:.3e} ({rel:.3e} relative, tol {GATE_TOL[dtype]}); "
              f"counts {counts.tolist()}")
        if not rel < GATE_TOL[dtype]:
            raise AssertionError(f"cascade_gate T={t} {dtype} disagrees")
        if (near.any() or int(counts.sum()) != t
                or not torch.equal(routes, proutes)
                or not torch.equal(counts, pcounts)):
            raise AssertionError(f"cascade_gate T={t} {dtype}: routes or "
                                 f"counts disagree")
        errs.append(err)

    times = {}
    for t in (1, 64):
        for dtype in ("float32", "bfloat16"):
            xs = (torch.randn((LAYERS, t, v), generator=gen, device=dev)
                  * 3).to(getattr(torch, dtype))

            def kern(i):
                return cascade_gate(xs[i % LAYERS], hi=0.5, lo=0.1)

            def plain(i):
                return cascade_gate_plain(xs[i % LAYERS], 0.5, 0.1)

            def library(i):
                return torch.logsumexp(xs[i % LAYERS], dim=-1)

            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
            # logits read once; conf and routes written once, 3 counts
            nbytes = _nbytes(xs[0]) + t * 8 + 12
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * t * v / F32_FLOPS_PER_S * 1e3   # max, sub, exp, add
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            times[(t, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound,
                                     bound_by=by)
            print(f"  cascade_gate T={t} V={v} {dtype}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, logsumexp {lib_ms:.4f} ms, bound"
                  f" {bound:.4f} ms ({by}; {nbytes} B)")
    # the line's numbers: the serving gate's shape and type, (1, V) bf16
    return dict(max_abs_err=max(errs), **times[(1, "bfloat16")]), \
        {f"T={t} {dt}": r for (t, dt), r in times.items()}


# -- phase 3: model ---------------------------------------------------------------

def check_model(torch, dev, seed):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    base = get_config("smollm-135m")
    gen = np.random.default_rng(seed)
    tokens = torch.from_numpy(gen.integers(0, base.vocab_size, (2, 40))
                              .astype(np.int32)).to(dev)
    prompt = 24
    for dtype, tol in (("float32", F32_LOGIT_TOL),
                       ("bfloat16", BF16_LOGIT_TOL)):
        cfg = dataclasses.replace(base, param_dtype=dtype)
        lm = LM(cfg, device=dev)
        params = lm.init(seed)
        full, _ = lm.forward(params, {"tokens": tokens})
        logits, caches = lm.prefill(params, {"tokens": tokens[:, :prompt]},
                                    cache_width=64)
        err = (logits[:, -1] - full[:, prompt - 1]).abs().max().item()
        for t in range(prompt, tokens.shape[1]):
            step, caches = lm.decode_step(params, caches,
                                          tokens[:, t:t + 1], t)
            err = max(err, (step[:, 0] - full[:, t]).abs().max().item())
        scale = full.float().abs().max().item()
        print(f"  smollm-135m {dtype}: prefill+decode vs forward max|diff| "
              f"= {err:.3e} (tol {tol}; max|logit| {scale:.2f})")
        if not (np.isfinite(scale) and err < tol):
            raise AssertionError(f"prefill+decode != forward ({dtype})")
        if dtype == "float32":
            # the whole model through the kernels vs the plain CPU path
            cpu = LM(cfg, device="cpu")
            ref, _ = cpu.forward(_to_cpu(params),
                                 {"tokens": tokens[:1].cpu()})
            gpu_err = (full[:1].cpu() - ref).abs().max().item()
            print(f"  smollm-135m float32: GPU kernels vs CPU plain forward "
                  f"max|diff| = {gpu_err:.3e} (tol {tol})")
            if not gpu_err < tol:
                raise AssertionError("GPU forward != CPU plain forward")
        del params, caches, full


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# -- phase 4: engine --------------------------------------------------------------

def _trace(seed, vocab):
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, vocab, int(n)).astype(np.int32), 0.0)
            for n in rng.integers(16, 481, 16)]
    reqs += [(rng.integers(0, vocab, int(n)).astype(np.int32), 0.8)
             for n in rng.integers(16, 481, 2)]
    return reqs


def _serve(engine, reqs, max_new):
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=max_new, temperature=t)
           for p, t in reqs]
    done = engine.run()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(ids) or any(done[i].status != "done"
                                          for i in ids):
        raise AssertionError("not every request finished")
    return [done[i] for i in ids], wall


def check_engine(torch, dev, seed, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = get_config("smollm-135m")
    lm = LM(cfg, device=dev)
    params = lm.init(seed)
    reqs = _trace(seed, cfg.vocab_size)
    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed)
    # warm-up: allocator and library handles, outside the measured run
    _serve(ServingEngine(lm, params, max_decode_steps=4, **kw), reqs[:2], 4)
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve(eng, reqs, max_new)
    launches = dict(LAUNCHES)
    n_layers = cfg.num_layers
    want = {"flash_attention": n_layers * eng.admissions,
            "decode_attention": n_layers * eng.decode_steps,
            "paged_decode_attention": 0, "cascade_gate": 0}
    print(f"  launches on the main path: {launches} (expected {want}: "
          f"{n_layers} per admission x {eng.admissions}, {n_layers} per "
          f"decode step x {eng.decode_steps})")
    if launches != want:
        raise AssertionError("launch counts do not match the main path")

    one = ServingEngine(lm, params, max_decode_steps=1, **kw)
    ref, _ = _serve(one, reqs, max_new)
    for a, b in zip(out, ref):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"K=4 stream != K=1 stream (request "
                                 f"{a.request_id})")
    print(f"  K=4 streams equal K=1 streams token for token "
          f"({sum(len(r.output) for r in out)} tokens; host syncs "
          f"{eng.host_syncs} vs {one.host_syncs})")

    # greedy tokens vs a teacher-forced full forward, where the forward's
    # top-2 margin exceeds the bf16 logits tolerance of phase 3
    checked = agree = 0
    for r, (prompt, temp) in zip(out, reqs):
        if temp > 0:
            continue
        ctx = torch.from_numpy(np.concatenate([prompt, r.output[:-1]])
                               .astype(np.int32))[None].to(dev)
        logits, _ = lm.forward(params, {"tokens": ctx})
        tail = logits[0, len(prompt) - 1:].float()
        top2 = torch.topk(tail, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > BF16_LOGIT_TOL
        pred = tail.argmax(-1).cpu().numpy()
        sure = sure.cpu().numpy()
        checked += int(sure.sum())
        agree += int((pred[sure] == r.output[sure]).sum())
    print(f"  greedy tokens vs teacher-forced forward: {agree}/{checked} "
          f"agree where the margin exceeds {BF16_LOGIT_TOL}")
    if checked == 0 or agree != checked:
        raise AssertionError("engine tokens disagree with the model")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out)
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], decode_ms_per_step=step_ms,
                 decode_ms_per_token=eng.decode_s * 1e3 / gen,
                 decode_steps=eng.decode_steps, admissions=eng.admissions,
                 host_syncs=eng.host_syncs, launches=launches)
    print(f"  engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms"
          f", max {ttft[-1]:.1f} ms; decode {step_ms:.2f} ms per step of 8 "
          f"slots, {stats['decode_ms_per_token']:.2f} ms per token")
    return stats, launches


def _paged_trace(seed, vocab):
    """Wave 1 (priority 0): 6 prompts sharing one 256-token prefix (two
    128-token chunks) with tails of 16-200 tokens, 6 unique prompts of
    16-480 tokens; one of each kind sampled at 0.8. Then 2 unique prompts
    at priority 1. Wave 2: the prefix itself, and the prefix plus a
    64-token tail. 32 new tokens each."""
    rng = np.random.default_rng(seed + 1)
    pre = rng.integers(0, vocab, 256).astype(np.int32)

    def rand(n):
        return rng.integers(0, vocab, int(n)).astype(np.int32)

    wave1 = []
    for i in range(6):
        wave1.append((np.concatenate([pre, rand(rng.integers(16, 201))]),
                      0.8 if i == 1 else 0.0))
        wave1.append((rand(rng.integers(16, 481)), 0.8 if i == 4 else 0.0))
    hi = [(rand(rng.integers(16, 481)), 0.0) for _ in range(2)]
    wave2 = [(pre.copy(), 0.0), (np.concatenate([pre, rand(64)]), 0.0)]
    return wave1, hi, wave2


def _serve_waves(engine, trace, max_new, contended):
    """Wave 1; with ``contended``, step until all 8 slots decode, then the
    priority-1 requests (else they go in up front, so nothing is
    preempted); drain; check invariants; wave 2; drain; check. Returns
    the requests in submission order and the wall time."""
    wave1, hi, wave2 = trace
    t0 = time.perf_counter()

    def submit(reqs, priority=0):
        return [engine.submit(p, max_new_tokens=max_new, temperature=t,
                              priority=priority) for p, t in reqs]

    ids = submit(wave1)
    if contended:
        for _ in range(1000):
            if engine.metrics()["live"]["decoding"] == engine.batch_slots:
                break
            if not engine.pending:
                raise AssertionError("wave 1 drained before 8 slots decoded")
            engine.step()
        else:
            raise AssertionError("8 slots never decoded at once")
    ids += submit(hi, priority=1)
    done = engine.run()
    engine.assert_invariants()
    ids += submit(wave2)
    done.update(engine.run())
    engine.assert_invariants()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(ids) or any(done[i].status != "done"
                                          for i in ids):
        raise AssertionError("not every request finished")
    return [done[i] for i in ids], wall


def check_paged_engine(torch, dev, seed, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = get_config("smollm-135m")
    lm = LM(cfg, device=dev)
    params = lm.init(seed)
    trace = _paged_trace(seed, cfg.vocab_size)
    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed,
              cache_backend="paged", block_size=16, chunk_tokens=128,
              prefix_sharing=True)
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    chunks = [0]
    run_chunk = eng._run_chunk

    def counted(c, *args):
        chunks[0] += 1
        return run_chunk(c, *args)

    eng._run_chunk = counted
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve_waves(eng, trace, max_new, contended=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    n_layers = cfg.num_layers
    want = {"paged_decode_attention":
            n_layers * (eng.decode_steps + chunks[0]),
            "flash_attention": 0, "decode_attention": 0, "cascade_gate": 0}
    print(f"  launches on the paged path: {launches} (expected {want}: "
          f"{n_layers} per decode step x {eng.decode_steps} + per chunk x "
          f"{chunks[0]})")
    if launches != want:
        raise AssertionError("launch counts do not match the paged path")
    be = eng.backend
    seen = dict(preemptions=eng.preemptions, swap_ins=be.swap_ins,
                cow_copies=be.cow_copies,
                retained_block_hits=be.retained_block_hits,
                prefill_tokens_skipped=eng.prefill_tokens_skipped)
    print(f"  paths taken: {seen} (prefill tokens "
          f"{eng.prefill_tokens_total}, look-ahead dispatches "
          f"{eng.lookahead_dispatches}, peak blocks {be.peak_blocks_in_use}"
          f" of {be.num_blocks - 1})")
    if min(seen.values()) < 1:
        raise AssertionError("the trace missed a paged path")

    one = ServingEngine(lm, params, max_decode_steps=1, **kw)
    ref1, _ = _serve_waves(one, trace, max_new, contended=True)
    calm = ServingEngine(lm, params, max_decode_steps=4, **kw)
    ref2, _ = _serve_waves(calm, trace, max_new, contended=False)
    if calm.preemptions:
        raise AssertionError("the uncontended engine preempted")
    for label, ref in (("K=1", ref1), ("uncontended", ref2)):
        for a, b in zip(out, ref):
            if not np.array_equal(a.output, b.output):
                raise AssertionError(f"paged stream != {label} stream "
                                     f"(request {a.request_id})")
    print(f"  K=4 streams equal the K=1 engine's and the uncontended "
          f"engine's token for token ({sum(len(r.output) for r in out)} "
          f"tokens; {sum(r.preemptions for r in out)} preemptions here, "
          f"{one.preemptions} in the K=1 run)")

    wave1, hi, wave2 = trace
    reqs = wave1 + hi + wave2
    checked = agree = 0
    for r, (prompt, temp) in zip(out, reqs):
        if temp > 0:
            continue
        ctx = torch.from_numpy(np.concatenate([prompt, r.output[:-1]])
                               .astype(np.int32))[None].to(dev)
        logits, _ = lm.forward(params, {"tokens": ctx})
        tail = logits[0, len(prompt) - 1:].float()
        top2 = torch.topk(tail, 2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > BF16_LOGIT_TOL).cpu().numpy()
        pred = tail.argmax(-1).cpu().numpy()
        checked += int(sure.sum())
        agree += int((pred[sure] == r.output[sure]).sum())
    print(f"  greedy tokens vs teacher-forced forward: {agree}/{checked} "
          f"agree where the margin exceeds {BF16_LOGIT_TOL}")
    if checked == 0 or agree != checked:
        raise AssertionError("paged engine tokens disagree with the model")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out)
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], decode_ms_per_step=step_ms,
                 decode_steps=eng.decode_steps, chunks=chunks[0],
                 host_syncs=eng.host_syncs, launches=launches, **seen)
    print(f"  paged engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} "
          f"ms, max {ttft[-1]:.1f} ms; decode {step_ms:.2f} ms per step of 8 "
          f"slots; {chunks[0]} chunks")
    return stats, launches


# -- phases 6 and 7: the edge/cloud cascade ----------------------------------------

def _cascade_models(torch, dev, seed):
    """smollm-135m as the cloud (seed) and its 4-layer edge draft (seed + 1),
    random weights, bf16."""
    from repro_torch.cascade import edge_variant
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = get_config("smollm-135m")
    cloud, edge = LM(cfg, device=dev), LM(edge_variant(cfg, layers=4),
                                          device=dev)
    return edge, cloud, edge.init(seed + 1), cloud.init(seed)


def check_cascade_oneshot(torch, dev, seed, models):
    """``CascadeEngine`` on 64 queries of 128 tokens, compact and lockstep
    at capacity_frac 0.5, thresholds at the edge confidences' tertiles."""
    from repro_torch.cascade import CascadeLM
    from repro_torch.cascade.gate import (ESCALATE, confidence_from_logits,
                                          make_thresholds)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import CascadeEngine

    edge, cloud, ep, cp = models
    b, s = 64, 128
    tokens = np.random.default_rng(seed + 6).integers(
        0, cloud.cfg.vocab_size, (b, s)).astype(np.int32)
    tok = torch.from_numpy(tokens).to(dev)
    el, _ = edge.forward(ep, {"tokens": tok}, last_only=True)
    hi, lo = _tertiles(confidence_from_logits(el[:, 0]).cpu().numpy())
    cl, _ = cloud.forward(cp, {"tokens": tok}, last_only=True)
    top2 = torch.topk(cl[:, 0].float(), 2, dim=-1).values
    cloud_sure = ((top2[:, 0] - top2[:, 1]) > BF16_LOGIT_TOL).cpu().numpy()
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(hi, lo),
                    capacity_frac=0.5)
    runs, launches = {}, 0
    for name, compact in (("compact", True), ("lockstep", False)):
        eng = CascadeEngine(cas, ep, cp, compact=compact)
        torch.cuda.synchronize()
        reset_launches()
        out = eng.query(tokens)
        got = dict(LAUNCHES)
        want = {"cascade_gate": 1, "flash_attention": edge.cfg.num_layers
                + cloud.cfg.num_layers, "decode_attention": 0,
                "paged_decode_attention": 0}
        if got != want:
            raise AssertionError(f"one-shot {name}: launches {got} != {want}")
        launches += got["cascade_gate"]
        routes = out["routes"]
        host = [int((routes == r).sum()) for r in range(3)]
        kern = [int(out[k]) for k in ("accept", "drop", "escalate")]
        if host != kern or min(host) == 0:
            raise AssertionError(f"one-shot {name}: kernel counts {kern}, "
                                 f"host counts {host}")
        conf = out["conf"].astype(np.float64)
        if min(np.min(np.abs(conf - hi) / hi),
               np.min(np.abs(conf - lo) / lo)) <= GATE_MARGIN:
            raise AssertionError(f"one-shot {name}: a confidence lies near "
                                 f"a threshold")
        runs[name] = out
        print(f"  one-shot {name}: {b} queries x {s} tokens in "
              f"{out['latency_s'] * 1e3:.1f} ms; accept/drop/escalate "
              f"{kern}; wan_bytes {int(out['wan_bytes'])}; launches {got}")
    a, c = runs["compact"], runs["lockstep"]
    esc = a["routes"] == ESCALATE
    cap = cas.capacity(b)
    if not np.array_equal(a["routes"], c["routes"]) or esc.sum() > cap:
        raise AssertionError("one-shot: routes differ, or escalations "
                             "exceed the capacity")
    # edge rows: the same edge forward in both; escalated rows: the cloud
    # GEMM runs at M = cap and M = 64, so only confident rows must agree
    same = ~esc | cloud_sure
    if not np.array_equal(a["pred"][same], c["pred"][same]):
        raise AssertionError("one-shot: compact pred != lockstep pred")
    print(f"  one-shot compact == lockstep: routes on all {b} rows, pred on "
          f"{int(same.sum())} rows ({int((esc & ~cloud_sure).sum())} "
          f"escalated rows within {BF16_LOGIT_TOL} of a cloud tie skipped); "
          f"thresholds hi {hi:.6g}, lo {lo:.6g}")
    return launches, dict(
        queries=b, tokens_per_query=s, hi=hi, lo=lo, capacity=cap,
        routes=[int(n) for n in np.bincount(a["routes"], minlength=3)],
        compact_ms=a["latency_s"] * 1e3, lockstep_ms=c["latency_s"] * 1e3,
        compact_wan_bytes=int(a["wan_bytes"]),
        lockstep_wan_bytes=int(c["wan_bytes"]))


def _cascade_prompts(seed, vocab):
    rng = np.random.default_rng(seed + 7)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in rng.integers(16, 481, 24)]


def _cascade_trace(probe, prompts):
    """Thresholds at the tertiles of the edge confidences of ``prompts``
    (through ``probe``'s gate), and the trace: greedy, but for the first
    prompt that will be accepted and the first that will be escalated,
    sampled at 0.8, so both engines serve a sampled stream."""
    conf = [probe._gate(p)[0] for p in prompts]
    hi, lo = _tertiles(conf)
    first = {}
    for i, c in enumerate(conf):
        first.setdefault("accept" if c >= hi else
                         "drop" if c < lo else "escalate", i)
    sampled = {first["accept"], first["escalate"]}
    return hi, lo, [(p, 0.8 if i in sampled else 0.0)
                    for i, p in enumerate(prompts)]


def check_cascade_serving(torch, dev, seed, smi, models):
    """``CascadeServingEngine`` (ring, 8 slots, max_seq_len 1024, K = 4) on
    24 requests: routes, launches, and streams against standalone edge and
    cloud engines."""
    from repro_torch.cascade import CascadeLM
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import CascadeServingEngine, ServingEngine

    edge, cloud, ep, cp = models
    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=1024, max_decode_steps=4)
    probe = CascadeServingEngine(CascadeLM(edge, cloud), ep, cp, seed=seed,
                                 **kw)
    hi, lo, reqs = _cascade_trace(
        probe, _cascade_prompts(seed, cloud.cfg.vocab_size))
    del probe
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(hi, lo))
    eng = CascadeServingEngine(cas, ep, cp, seed=seed, **kw)
    gate_s = []
    gate = eng._gate

    def timed(prompt):          # host floats come back: the gate has synced
        t0 = time.perf_counter()
        out = gate(prompt)
        gate_s.append(time.perf_counter() - t0)
        return out

    eng._gate = timed
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=max_new, temperature=t)
           for p, t in reqs]
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    out = [done[i] for i in ids]
    if sorted(done) != sorted(ids) or any(r.status != "done" for r in out):
        raise AssertionError("not every cascade request finished")
    routes = {k: sum(r.route == k for r in out)
              for k in ("accept", "escalate", "drop", "failover")}
    if min(routes["accept"], routes["escalate"], routes["drop"]) < 4:
        raise AssertionError(f"routes {routes}: each needs >= 4 requests")
    for r in out:
        if len(r.output) != (0 if r.route == "drop" else max_new):
            raise AssertionError(f"request {r.request_id} ({r.route}) has "
                                 f"{len(r.output)} tokens")
    el, cl = edge.cfg.num_layers, cloud.cfg.num_layers
    ee, ce = eng.edge_engine, eng.cloud_engine
    gated = len(gate_s)
    want = {"cascade_gate": gated,
            "flash_attention": el * (gated + ee.admissions)
            + cl * ce.admissions,
            "decode_attention": el * ee.decode_steps + cl * ce.decode_steps,
            "paged_decode_attention": 0}
    print(f"  launches on the cascade path: {launches} (expected {want}: "
          f"{gated} gated, {ee.admissions} edge and {ce.admissions} cloud "
          f"admissions, {ee.decode_steps} edge and {ce.decode_steps} cloud "
          f"decode steps)")
    if launches != want or gated != len(reqs) or ee.admissions != \
            routes["accept"] or ce.admissions != routes["escalate"]:
        raise AssertionError("launch counts do not match the cascade path")

    for route, lm, params, s in (("accept", edge, ep, seed),
                                 ("escalate", cloud, cp, seed + 1)):
        mine = [(r, q) for r, q in zip(out, reqs) if r.route == route]
        ref, _ = _serve(ServingEngine(lm, params, seed=s, **kw),
                        [q for _, q in mine], max_new)
        for (r, _), x in zip(mine, ref):
            if not np.array_equal(r.output, x.output):
                raise AssertionError(f"cascade {route} stream != standalone "
                                     f"engine (request {r.request_id})")
    sampled = [r.route for r, (_, t) in zip(out, reqs) if t > 0]
    if sorted(sampled) != ["accept", "escalate"]:
        raise AssertionError(f"sampled requests took routes {sampled}")
    print(f"  accepted and escalated streams equal standalone edge (seed "
          f"{seed}) and cloud (seed {seed + 1}) engines token for token "
          f"(one of each sampled at 0.8); dropped outputs empty")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out if r.route != "drop")
    m = eng.metrics
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1],
                 gate_ms_per_request=sum(gate_s) * 1e3 / gated,
                 routes=routes, wan_bytes=m.wan_bytes, hi=hi, lo=lo,
                 trace=reqs,
                 edge_decode_steps=ee.decode_steps,
                 cloud_decode_steps=ce.decode_steps, launches=launches)
    print(f"  cascade engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms,"
          f" max {ttft[-1]:.1f} ms; gate {stats['gate_ms_per_request']:.2f} "
          f"ms per request (edge prefill + kernel); routes {routes}; "
          f"wan_bytes {m.wan_bytes}")
    return launches["cascade_gate"], stats


def _device_profile(torch, serve, wall_s):
    """Device busy time of ``serve()`` (which returns its wall time), by
    kernel name, from torch.profiler; idle share against the unprofiled
    wall time ``wall_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = serve()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): an operator's own entry
    # repeats the device time of the kernels it launched
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not rows:
        raise AssertionError("the profiler recorded no device events")
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"  profiled run: wall {prof_wall:.3f} s (unprofiled {wall_s:.3f} s)"
          f"; device busy {busy_s:.3f} s -> idle share "
          f"{1 - busy_s / wall_s:.3f} of the unprofiled wall")
    for us, n, name in rows[:12]:
        print(f"    {us / 1e3:9.2f} ms  {n:7d} x  {name[:70]}")
    return dict(device_busy_s=busy_s, profiled_wall_s=prof_wall,
                idle_share=1 - busy_s / wall_s,
                top=[dict(name=name, ms=us / 1e3, calls=n)
                     for us, n, name in rows[:12]])


def profile_engine(torch, dev, seed, wall_s):
    """The phase-4 trace (K=4 ring engine) under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = get_config("smollm-135m")
    lm = LM(cfg, device=dev)
    params = lm.init(seed)
    reqs = _trace(seed, cfg.vocab_size)
    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=1024,
                        seed=seed, max_decode_steps=4)
    return _device_profile(torch, lambda: _serve(eng, reqs, 32)[1], wall_s)


def profile_cascade(torch, dev, seed, stats):
    """The phase-7 trace (generative cascade, phase 7's thresholds) under
    the profiler."""
    from repro_torch.cascade import CascadeLM
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.serving import CascadeServingEngine

    edge, cloud, ep, cp = _cascade_models(torch, dev, seed)
    reqs = stats["trace"]
    cas = CascadeLM(edge, cloud,
                    thresholds=make_thresholds(stats["hi"], stats["lo"]))
    eng = CascadeServingEngine(cas, ep, cp, seed=seed, batch_slots=8,
                               max_seq_len=1024, max_decode_steps=4)

    def serve():
        t0 = time.perf_counter()
        for p, t in reqs:
            eng.submit(p, max_new_tokens=32, temperature=t)
        eng.run()
        return time.perf_counter() - t0

    return _device_profile(torch, serve, stats["wall_s"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full record here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the phase-4 and phase-7 traces "
                         "on the device")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {kind} (nvidia-smi: {smi}); torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.sources():
        build.load(name)
    print(f"    built {build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("[2] kernels vs plain versions (bf16; the gate also f32)")
    timer = Timer(torch)
    results = {"decode_attention": check_decode(torch, timer, dev),
               "flash_attention": check_flash(torch, timer, dev),
               "paged_decode_attention": check_paged(torch, timer, dev)}
    results["cascade_gate"], gate_times = check_cascade_gate(torch, timer,
                                                             dev)
    print("[3] model: smollm-135m, 30 layers, full width")
    check_model(torch, dev, args.seed)
    print("[4] engine: ring, 8 slots, max_seq_len 1024, K=4")
    stats, launches = check_engine(torch, dev, args.seed, smi)
    print("[5] engine: paged, block 16, chunks of 128, prefix sharing, K=4")
    paged_stats, paged_launches = check_paged_engine(torch, dev, args.seed,
                                                     smi)
    launches["paged_decode_attention"] = \
        paged_launches["paged_decode_attention"]
    models = _cascade_models(torch, dev, args.seed)
    print("[6] cascade, one-shot: smollm-135m cloud, 4-layer edge draft, "
          "64 queries x 128 tokens")
    oneshot_gates, oneshot_stats = check_cascade_oneshot(torch, dev,
                                                         args.seed, models)
    print("[7] cascade, generative: ring, 8 slots, max_seq_len 1024, K=4, "
          "24 requests")
    serving_gates, cascade_stats = check_cascade_serving(
        torch, dev, args.seed, smi, models)
    launches["cascade_gate"] = oneshot_gates + serving_gates
    del models
    if args.profile:
        print("[8] profiles of the phase-4 and phase-7 traces")
        stats["profile"] = profile_engine(torch, dev, args.seed,
                                          stats["wall_s"])
        cascade_stats["profile"] = profile_cascade(torch, dev, args.seed,
                                                   cascade_stats)

    meta = {
        "cascade_gate": ("src/repro_torch/kernels/csrc/cascade_gate.cu",
                         "src/repro/kernels/cascade_gate.py:85"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:136"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:122"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:282"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name],
                    **results[name]) for name in sorted(results)]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "torch": torch.__version__,
                       "kernels": kernels, "cascade_gate_times": gate_times,
                       "engine": stats, "paged_engine": paged_stats,
                       "cascade_oneshot": oneshot_stats,
                       "cascade_engine": {k: v for k, v in
                                          cascade_stats.items()
                                          if k != "trace"}}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
