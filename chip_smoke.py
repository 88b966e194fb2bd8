#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py [--out FILE.json]``.
It needs a CUDA GPU and ``nvcc``, and fails (nonzero exit, no result line)
without them, or without ``src/repro_torch`` beside it. Every engine
(phases 4, 5, 7, 9, 10, 11, 13, 16 and 17) calls ``warm_compile`` before its
measured traffic, which captures every program the engine can run as a
CUDA graph: the single step, the K-step scan at every horizon and the
speculative round at every depth, greedy and sampled; the admission at
every prompt bucket, or the prompt chunk at every (chunk bucket, context
bound); the draft fill at every bucket; the cascade's gate at every edge
bucket; ``DrainBatchEngine``'s prefill at every bucket, its sample and
its decode step. Each such phase then checks that ``warm_compile`` registered every program and
that no program was captured during the traffic, and counts the programs'
runs (replays), from which the kernel launches follow. Phases, each fatal
on failure:

1. print the card, build every kernel from ``src/repro_torch/kernels`` and
   print each kernel function's registers and spills as ptxas reports
   them (a bf16 tensor-core variant that spills fails the phase);
2. each kernel against its plain PyTorch version on the card, in bf16 at
   the serving path's shapes, with its time, the plain version's, the time
   of one PyTorch library call computing the same function (a yardstick
   the port never calls; for the paged kernel, attention over the context
   gathered beforehand, gather excluded) and its bound on this card. The
   ring decode and flash kernels are held per query row in bf16 and on
   the same values in f32 at every shape, with flash's TFLOP/s in the
   band, the decode's GB/s, its key splits and the bytes of its f32
   partials; the paged kernel likewise, at every head_dim class (24-256)
   at T = 1 and T > 1, with holes, one split and more keys than a split
   stages; the ring and paged kernels with ``kv_range`` at a tensor-
   parallel rank's shape (glm4-9b on 4 ranks: 8 query heads reading one
   of 2 KV heads in place, T = 1 and a T = 5 verify chunk), against the
   plain version and bit for bit against a copy of the range; then
   flash, ``rglru_scan`` and ``cascade_gate`` inside CUDA graphs: each
   captured into two graphs, each graph replayed twice on new inputs with
   an eager launch between, every replay held against the plain version;
3. smollm-135m at full width (30 layers, random weights from a seed):
   prefill-then-decode logits equal a full forward, and the GPU forward
   equals the plain CPU forward in f32;
4. a ``ServingEngine`` (ring cache, 8 slots, max_seq_len 1024, 4 decode
   steps per host sync) serves 18 requests; every request finishes, the
   streams equal a 1-step engine's, greedy tokens agree with a
   teacher-forced forward, and the launch counters show every prefill
   and decode attention went through the kernels. An A/B in the same
   call: an eager engine (graphs off) serves the trace first, then the
   graphed one; for each leg tokens/s, decode ms per step against the
   weights' read time, TTFT p50, ``warm_compile`` seconds, graphs and
   pool bytes, and the graphed streams equal the eager ones or part
   first at a near-tie; then each admission bucket's eager call against
   its graph's replay (device ms, also for qwen3-4b in phase 10 and the
   hybrid in phase 9);
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
   launch;
8. the RG-LRU hybrid recurrentgemma-9b at full width: cut to 4 layers in
   f32 (weights from the CPU generator, its rate printed), the GPU forward
   equals the plain CPU forward and a right-padded prefill with
   ``lengths`` keeps the unpadded prefill's recurrent state; then all 38
   layers in bf16 (10.4 B weights made on the card), prefill-then-decode
   logits equal a full forward;
9. a ``ServingEngine`` (ring, 8 slots, max_seq_len 4096, so each
   attention layer's 2048-wide ring wraps; K = 4) serves 12 requests of
   2-3000 tokens, none a bucket size, one sampled: every request
   finishes, the streams equal a 1-step engine's, greedy tokens agree with
   a teacher-forced forward, and every RG-LRU prefill scan, prefill
   attention and decode attention went through the kernels; with phase
   4's eager/graphed A/B;
10. the dense hd-128 zoo at full width in bf16, qwen3-4b at full depth,
   glm4-9b at 10 of its 40 layers and starcoder2-7b at 8 of its 32 (the
   run's length), one model at a time (weights made on the card, freed
   before the next, peak memory and seconds printed): each passes phase 3's
   prefill-then-decode check; qwen3-4b then serves phase 4's trace on the
   ring engine and phase 5's two waves on the paged engine with phase 4's
   and 5's checks (the ring with phase 4's eager/graphed A/B), glm4-9b
   serves 8 requests on the ring engine and
   starcoder2-7b 8 requests of 16-4600 tokens at max_seq_len 8192 (its
   4096-wide rings wrap), each with K = 4 == K = 1 streams, launch counts
   and greedy tokens against a teacher-forced forward; decode time per
   step is printed beside the weights' read time;
11. the baseline: phase 4's trace through ``DrainBatchEngine`` and the
   K = 4 ring ``ServingEngine`` in turns (drain, continuous, continuous,
   drain), both graphed: each engine's two runs give equal streams,
   greedy streams of the two engines are equal or part first at a
   near-tie of a teacher-forced forward (their prefills run other
   shapes), the drain engine's launches are flash per batch and the ring
   kernel per token, and the drain's first batch gives the same streams
   on an eager drain engine (graphs off); both engines' tokens/s, their
   ratio and host syncs per token;
13. speculative decoding (k = 4), four legs: qwen3-4b at full width and
   depth on the ring (phase 4's trace) with no draft at K = 1 (the
   baseline), with its 4-layer ``edge_variant`` draft forced on
   (``spec_min_commit`` 0), and under the default ``spec_min_commit`` (the
   acceptance EWMA suppresses drafting and probes); qwen3-4b at 12 of its
   36 layers (the run's length) on the paged backend (phase 5's waves)
   without and with the draft; smollm-135m
   drafting for itself on the ring (every proposal accepted, or rejected
   only at a near-tie); and phase 7's cascade with every prompt escalated,
   without and with ``speculative_tokens=4`` (the edge drafts for the
   cloud). Every stream equals its baseline's or parts first at a near-tie
   of a teacher-forced forward (the top-2 margin of the logits, or at T >
   0 of logits / T plus that step's keyed Gumbel noise); each kernel's
   launches equal the counts derived from the programs run; tokens/s, ms
   per committed token, acceptance and tokens committed a dispatch are
   printed beside the baseline's (random weights: acceptance says nothing
   of speed);
14. faults, durability and the gateway (chaos on the paged and self-draft
   ring engines, snapshot/restore, the gateway's open loop, hang and wedge
   with a restart, the cascade's tap and restore);
15. the ACE application: (a) ``PartitionedLM`` over smollm-135m at full
   width, split at 0, 15 and 30 on (2, 256) tokens, equals ``LM.forward``
   bit for bit with flash launched once a layer a pass, its halves timed
   and ``best_partition`` printed for the partition benchmark's scenarios;
   (b) the video-query classifiers at ``VideoQueryConfig``'s widths in
   f32: the card's forward equals the CPU's on 256 crops, then
   ``model_crop_bank`` with ``repro``'s defaults on the card (COC's loss
   falls), its bank pass equal to the CPU's on the same trained weights
   away from near-ties; (c) the Fig. 5 sweep (surrogate bank) with the
   benchmark's orderings, and the four paradigms on (b)'s bank; (d)
   phase 7's engines as COC and EOC servers calibrated by
   ``run_video_query``: every calibration request finishes, traffic
   captures nothing, launches equal the counted programs;
16. the MoE models at full width, one at a time (weights made on the
   card, freed before the next, peak memory and seconds printed):
   mixtral-8x22b at 6 of its 56 layers, deepseek-v3-671b at its 3 dense
   layers and 1 of its 58 MoE layers (MTP's params made, never read).
   (a) an f32 cut the host can hold (mixtral's first layer; deepseek's 4
   layers with 32 of its 256 routed experts) forwards on the card and
   on the CPU: routes compared first (a flip only at a near-tie of the
   router, ``ROUTE_TOL``), logits of every unflipped token to
   ``F32_LOGIT_TOL``. Then bf16 at the dropless capacity factor E / k
   (4 and 32, powers of two: every capacity is the group's length,
   asserted): (b) phase 3's prefill-then-decode check, routes first;
   (c) phase 4's ring and phase 5's paged engine with their checks
   (K = 4 == K = 1, preempted == uncontended, greedy tokens against a
   teacher-forced forward away from router near-ties, one flash launch
   per attention or MLA layer per admission, the ring or paged kernel
   per GQA layer per step or chunk, none for MLA decode), tokens/s and
   decode ms per step against the weights' read time; (d) at
   ``repro``'s 1.25, where a prefill drops pairs: the ring's K = 4
   streams equal K = 1 (decode never drops), the paged backend's
   swap-preempted streams equal uncontended ones (monolithic prefill),
   and the pairs the admissions dropped are printed;
17. the last three assigned architectures at full width and depth, one
   at a time (weights made on the card): (a) xlstm-125m (mLSTM and sLSTM
   blocks, no kernel of the five on its path: ``repro``'s are jnp): 4
   layers in f32 on the card against the CPU (``MODAL_F32_TOL``) and a
   right-padded prefill with ``lengths`` against the unpadded state; 12
   layers in bf16, prefill then decode against a full forward; the
   graphed ring engine (8 slots, max_seq_len ``XLSTM_SEQ``, K = 4) on 12
   mixed-length requests with phase 9's checks and A/B (no launch, K = 4
   == K = 1, teacher-forced greedy, graphed == eager or parted at a
   near-tie, nothing captured in traffic), its decode ms per step against
   the weights' plus the state's read and write, admission ms by bucket;
   the graphed ``DrainBatchEngine`` on its greedy requests against the
   continuous streams (equal, or parted first at a near-tie); (b)
   internvl2-2b: 4 layers f32 with ``image_embeds`` against the CPU; 24
   layers bf16: a prefill of the 256-token image prefix and 100 text
   tokens, 32 greedy decode steps, their logits against a teacher-forced
   forward, flash once a layer, the ring kernel once a layer a step,
   decode ms eager and as a CUDA graph against the weights' read; then
   ``CascadeEngine.query(tokens, extra={"image_embeds": ...})`` over its
   4-layer edge variant, compact and lockstep: equal routes, the gate's
   counts equal the host's, one gate launch a query batch; (c)
   musicgen-medium: 4 layers f32 on a (1, 40, 4) grid against the CPU;
   48 layers bf16 on a (2, 64, 4) grid through (b)'s decode checks;
18. training on one device (``repro_torch.training``): (a) the backward
   kernels against their plain versions, bf16 and f32: flash's dq, dk and
   dv row by row at smollm-135m's (B 8, S 512, 9 heads over 3, hd 64),
   qwen3-4b's (G = 4, hd 128), MLA's (128 heads of 192 dims, G = 1) and
   recurrentgemma-9b's (S 4096, 16 heads over 1, hd 256, window 2048)
   layouts from the forward kernel's output and log-sum-exp (itself held
   against the plain one), the scan's da, db and dh0 at (1, 512, 4096) and
   (1, 4096, 4096) within ``RGLRU_TOL`` (da_t = g_t h_{t-1} against
   max(1, |h_{t-1}|) max(1, |g_t|); equal bits on a repeated call),
   each timed against its plain version and its bound, flash also against
   SDPA's backward under autograd (a yardstick the port never calls); (b)
   smollm-135m at full width and depth in bf16, AdamW in f32, through
   ``Trainer.fit`` on ``TokenStream`` (B 8, S 512, ``TRAIN_STEPS`` steps
   over ``TRAIN_DISTINCT`` batches in turn):
   the loss falls by more than 1.0 and stays finite, flash forward twice a
   layer a step (remat) and flash backward once, ms per step by CUDA
   events, tokens/s, peak memory and 6 N D over the step time as a share
   of 989 TFLOP/s; the step-10 checkpoint restored by a fresh
   ``Trainer.restore_or_init`` continues within ``RESUME_TOL`` of the
   uninterrupted losses; (c) one (rec, rec, attn) repeat of
   recurrentgemma-9b at full width in f32 (B 1, S 256): loss and every
   gradient leaf on the card against the CPU, through both backward
   kernels; (d) each mixer family's ``.reduced()`` config (GQA, MLA + MoE
   + MTP, RG-LRU, xLSTM, vision, audio): one f32 train step's loss and
   gradients on the card against the CPU (MoE routes compared first), and
   the whole step (AdamW) on the card;
19. tensor-parallel serving (``launch.mesh``, ``serving.sharding``): (a)
   qwen3-4b at full width and depth on a one-rank NCCL mesh, ring and
   paged engines (K = 4, 8 slots, max_seq_len ``TP_SEQ``), graphed: the
   streams equal the ``mesh=None`` engines' bit for bit (every split the
   whole, every collective the identity), the launches equal theirs, and
   each captured program holds its collectives (1 + 2 a layer all-
   reduces and 1 all-gather a decode step); tokens/s and decode ms per
   step beside ``mesh=None``'s; on a machine with more cards, on
   min(count, 4) of them too; (b) real splits on this card, ranks as
   processes over gloo, each on it, eager
   (``TP_SPLITS``: qwen3-4b at 4 layers on 2 ranks, heads and KV heads
   split; glm4-9b at 1 layer on 4 ranks, its 2 KV heads whole on every
   rank, each rank's 8 query heads reading one in place): the ranks'
   streams equal bit for bit (and ``assert_invariants`` checks lockstep
   after each run), equal ``mesh=None``'s or part first at a near-tie
   (``BF16_LOGIT_TOL``), the K/V bytes a rank holds 1/N of the whole where
   the KV heads divide, and each rank's launches.

Phases 20-22 put MoE and MLA, the recurrent mixers and the frontends, and
the data axis on the mesh (``check_moe_mesh``, ``check_rec_mesh``,
``check_data_axis``). Phase 23 is a supervised restart on the mesh
(``check_supervise``): (a) smollm-135m whole on 2 gloo ranks of this card,
ring, eager: the trace served uninterrupted, then through rank 0's gateway
(journal, a snapshot every step, the watchdog) while every rank's fault
plan stalls step 2 past the grace window; after ``EngineWedgedError``
every rank releases its engine (a weak reference to it dead, at most
``SUP_RELEASED`` of its own bytes still allocated above what the rank
held before building it) before the fresh one is
built, the leader recovers from the snapshot and the journal and drains:
no acknowledged request lost, every stream equal to the uninterrupted
run's token for token and to ``mesh=None``'s or parted first at a
near-tie; restart -> first token and each rank's peak memory before the
wedge and after the restart; (b) with 2 cards or more, ``launch/serve.py
--arch qwen3-4b --no-reduced --mesh min(cards, 4) --wedge-demo`` over
NCCL, graphed, its printed restart lines held. Phase 24 trains on a model
axis above 1 (``check_tp_training``): (a) ``TPT_MODELS`` in f32 on a
(1, 2) mesh of 2 gloo ranks of this card, run in phase 22's spawn
after 22(c) and (d), each of ``TPT_STEPS`` steps of
``make_train_step(mesh=)`` held against the one-device step from the
same state (loss, the first gradient leaf by leaf, every step's params
and moments, at their storage precision), with the kernels' launches,
the heads and scan widths they ran at and the design's collectives a
step; (b) with 4 cards, ``launch/train.py`` on ``TPT_CARDS`` whole in
bf16 on a (1, 4) NCCL mesh (ms a step by CUDA events, tokens/s, 6·N·D
share, peak, bytes a rank, collectives a step, the loss falling), then
its 4-layer f32 cut held as (a). Phase 2 times flash, its backward and
the scan's backward at a training rank's layouts
(``check_tp_train_shapes``).
Phase 25 is the production-mesh dry run (``check_dryrun``, in this
process, no spawn): (a) each of the seven kernel wrappers (and flash's
form with its log-sum-exp) at its main-path shape (``DRY_SHAPES``), a
real launch against the same call on fake copies of its inputs: equal
shapes, dtypes, strides and devices, the same FLOPs added, a count in
``kernels.TRACED`` and none in ``LAUNCHES``; (b) ``DRY_ARCH`` x
``DRY_SHAPE`` on rank 0 of the 16 x 16 mesh (``launch.dryrun.trace_step``
over a fake 256-rank group), traced on fake CUDA tensors (the kernels'
fake rules, forward and backward) and on fake CPU tensors (their plain
versions): the same matrix-product FLOPs and collectives, with its
roofline row and trace seconds (``DRY_LAYERS`` cuts its depth); (c)
phase 24(b)'s (1, 4) glm4-9b step at B 4 x S 4,096 on fake CUDA: its
all-reduces over 'model' equal 24(b)'s count (``DRY_TP``), its argument
and temp bytes printed beside what 24(b) counted and measured. The
``TRACED`` counts print on a line of their own before the card's name.

Phase 2 also times ``cascade_gate`` at T = 1 (the serving gate) and
T = 64 (the one-shot batch) over smollm's 49152-entry vocab in f32 and
bf16, and at the reference's bulk shape (4096, 32768) in f32, against
``torch.logsumexp`` as the library yardstick, beside a one-launch floor
(an in-place add on one element, by the same timer); ``rglru_scan``
at (1, 512, 4096) and (1, 4096, 4096) in f32 (no library call computes a
linear recurrence); and ``decode_attention`` and ``flash_attention`` at
recurrentgemma-9b's hd 256, 16 heads over one KV head, window 2048,
against SDPA; and the three attention kernels at the hd-128 zoo's head
layouts (qwen3-4b G = 4, glm4-9b G = 16, starcoder2-7b G = 9 with its
4096 window, mixtral-8x22b G = 6 under its 4096 window): the ring decode
at B = 8, the paged kernel at T = 1 and on a 128-token chunk, flash on a
512-token prefill (a 4608-token banded one for starcoder2-7b), and flash
at deepseek-v3-671b's MLA prefill (S = 512, 128 heads of 192 dims, G =
1), each held row by row and timed against SDPA with its bound and split
count; the ring and the paged kernel at the speculative
verify chunk (T = 5 tokens a slot, B = 8) at smollm-135m's, qwen3-4b's and
glm4-9b's head layouts, likewise; the ring decode and flash at phase 17's
layouts (musicgen-medium's G = 1 at hd 64, internvl2-2b's G = 2 at hd 128
over its 256-token prefix) and ``cascade_gate`` at internvl2-2b's
92,672-entry vocab in bf16, likewise; and the keyed sampler (threefry2x32 in
plain torch): its bits and uniforms on the card at (8, 49152) and (8,
152064) equal the CPU's bit for bit, with its time per call.

Phase 2 then times the bf16 flash kernel at every launch shape and the
ring decode at several keys per split, at hd 64 and hd 256 as above and
at hd 128 (qwen3-4b's 512-token prefill, glm4-9b's ring), with the
floor of each, the paged kernel at several keys per split and over
all-hole tables, the scan at several chunk lengths, and the gate at 1 to
8 splits of V a row (the launch rules' picks are marked).

With ``--profile`` it then (phase 12) serves the phase-9, 4, 5 and 7
traces and qwen3-4b's phase-10 ring trace once more on graphed engines
under ``torch.profiler`` and prints the device's busy time by kernel
against the unprofiled run's wall time (the idle share).

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. TF32 is off for every f32 product.
"""
import argparse
import collections
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types
import warnings

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
BULK_GATE = (4096, 32768, "float32")   # benchmarks/bench_kernels.py's shape
LAYERS = 30                    # distinct inputs per timing loop (cold L2)
# the RG-LRU scan, kernel vs plain, per element relative to max(1, |h|):
# the chunked scan composes the same f32 steps in another order
RGLRU_TOL = 1e-5
# recurrentgemma-9b in bf16 through 38 layers (flash over the sequence vs
# prefill + cached decode): activation roundings, as BF16_LOGIT_TOL
HYBRID_LOGIT_TOL = 0.25
# recurrent state of a padded prefill vs the unpadded one, f32 at 4
# layers, relative to max(1, |state|): GEMMs at other M sum in another
# order
STATE_TOL = 1e-3
# the attention kernels at every phase-2 shape: a row that sees
# hundreds of keys averages to ~0.03, so BF16_TOL alone would pass a
# dropped key split or a wrong fragment layout. f32 on the same values:
# summation order only (tests/test_torch_gpu.py's bound). bf16: per query
# row, |kernel - plain| / |plain| over its heads and dims, where one output
# rounding is ~2^-9 and a missed tile of keys or a band edge off by a tile
# is ~0.1
ATTN_F32_TOL = 1e-4
ATTN_ROW_REL_TOL = 1e-2
# an MoE router whose k-th and (k+1)-th logits lie closer than this is at a
# near-tie: two paths that differ by rounding may pick different experts
# there, which moves that token's output by a whole expert, not a
# rounding. f32: summation order; bf16: activation roundings of two paths
ROUTE_TOL = {"float32": 1e-3, "bfloat16": 0.08}
# the backward kernels' counts on a path that computes no gradient
NO_BACKWARD = {"flash_attention_bwd": 0, "rglru_scan_bwd": 0}


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

def _ring_split(torch, b, t, h, kv, w, hd, dev):
    """The bf16 ring kernel's splits at this shape and the f32 partial
    bytes they write (none with one split: the CTA writes the output)."""
    from repro_torch.kernels.decode_attention import ring_split_len
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = -(-w // ring_split_len(b, t, h, kv, w, hd, sms))
    return nsplit, (b * t * h * nsplit * (hd + 2) * 4 if nsplit > 1 else 0)


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
    k_pos, q_pos = _ring_positions(torch, totals, w, dev)
    q1 = torch.randn((LAYERS, b, 1, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q16 = torch.randn((b, 16, h, hd), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    errs = []
    cases = [("T=1", q1[0], q_pos, None), ("T=1 window=256", q1[0], q_pos, 256),
             ("T=16", q16, torch.clamp(q_pos - 15, min=0), None)]
    # slot 3's ring is empty: its rows see no key and must be 0
    for label, q, qp, window in cases:
        errs.append(_check_rows(
            torch, f"decode_attention hd={hd} {label}",
            lambda *x, qp=qp, window=window: decode_attention(
                *x, qp, k_pos, window=window),
            lambda *x, qp=qp, window=window: decode_attention_plain(
                *x, qp, k_pos, window=window),
            (q, ks[0], vs[0]), rows=2, bf16_abs=BF16_TOL))

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
    nsplit, part = _ring_split(torch, b, 1, h, kv, w, hd, dev)
    print(f"  decode_attention B={b} W={w} KV={kv} G={g} hd={hd} T=1 bf16: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop); "
          f"{nbytes / ms / 1e6:.1f} GB/s; {nsplit} key splits, {part} B of "
          f"f32 partials")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms), \
        dict(gb_per_s=nbytes / ms / 1e6, splits=nsplit, partial_bytes=part)


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
        errs.append(_check_rows(
            torch, f"flash_attention hd={hd} S={s} window={window}",
            lambda *x, window=window: flash_attention(
                *x, causal=True, window=window),
            lambda *x, window=window: flash_attention_plain(
                *x, causal=True, window=window),
            (q, k, v), rows=2, bf16_abs=BF16_TOL))
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
          f"ms, bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop); "
          f"{flops / ms / 1e9:.1f} TFLOP/s in the band")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms), \
        dict(tflop_per_s=flops / ms / 1e9)


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

    def case(bs, n_layers=1, kv=kv, hd=hd, fills=fills, max_seq=max_seq):
        m = max_seq // bs
        n_blocks = len(fills) * m + 1
        pos, bt = _paged_pool(rng, fills, bs, m, n_blocks,
                              [(i, j) for i, j in holes if j < m])
        k, v = (torch.randn((n_layers, n_blocks, bs, kv, hd), generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        return (k, v, torch.from_numpy(pos).to(dev),
                torch.from_numpy(bt).to(dev))

    def starts(fills, t):
        return torch.tensor([max(f - t, 0) for f in fills], dtype=torch.int32,
                            device=dev)

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
    # every hd class of the bf16 kernel at T = 1 and T > 1: (h, kv, hd,
    # window, t, max_seq); hd 24 and 40 are multiples of 8 but not of 16,
    # hd 256 is recurrentgemma's 16 heads over one KV head; 64 keys take
    # one split, 2560 more than one split stages
    for hh, kvv, hdd, window, t, ms in (
            (16, 4, 128, None, 1, 1024), (16, 4, 128, 300, 8, 1024),
            (16, 1, 256, 2048, 1, 2048), (16, 1, 256, None, 16, 1024),
            (9, 3, 24, None, 1, 1024), (9, 3, 40, 100, 8, 1024),
            (9, 3, 64, None, 1, 64), (9, 3, 64, None, 8, 64),
            (9, 3, 64, None, 1, 2560), (9, 3, 64, 900, 4, 2560)):
        fl = [f * ms // 1024 for f in fills]
        k2, v2, p2, bt2 = case(16, kv=kvv, hd=hdd, fills=fl, max_seq=ms)
        qq = torch.randn((b, t, hh, hdd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        cases.append((f"hd={hdd} H={hh} KV={kvv} T={t} M*bs={ms} "
                      f"window={window}", qq, k2[0], v2[0], starts(fl, t), p2,
                      bt2, window))
    errs = []
    for label, q, k, v, qp, kp, table, window in cases:
        # rows that see no key (the freed slot 5, and rows whose keys all
        # sit in holes) must be exactly 0
        errs.append(_check_rows(
            torch, f"paged_decode_attention {label}",
            lambda *x, qp=qp, kp=kp, table=table, window=window:
                paged_decode_attention(*x, qp, kp, table, window=window),
            lambda *x, qp=qp, kp=kp, table=table, window=window:
                paged_decode_attention_plain(*x, qp, kp, table,
                                             window=window),
            (q, k, v), rows=2, bf16_abs=BF16_TOL))

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


def check_kv_range(torch, dev):
    """The ring and paged kernels at a tensor-parallel rank's shapes with
    ``kv_range``: glm4-9b on 4 ranks, where each rank's 8 query heads
    (hd 128) read one of the 2 KV heads that every rank keeps whole, in
    place (``kv_range=(1, 1)``: ranks 2 and 3), at T = 1 and at a T = 5
    verify chunk, over a wrapped ring and a pool with a hole. Each case is
    held against the plain version on the same range (``_check_rows``) and
    bit for bit against the kernel on a copy of the range, and its bf16
    in-place launch counts one launch. Returns each kernel's bf16 max abs
    error."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, paged_decode_attention,
        paged_decode_attention_plain)

    b, w, row, h, hd, bs = 8, 1024, 2, 8, 128, 16
    first, count = kv_range = (1, 1)
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    k_pos, ring_next = _ring_positions(
        torch, [300, 512, 2524, 0, 17, 900, 1023, 1500], w, dev)
    fills = [1, 17, 200, 480, 1000, 0, 700, 333]
    m = w // bs
    pos, bt = (torch.from_numpy(x).to(dev) for x in _paged_pool(
        np.random.default_rng(12), fills, bs, m, b * m + 1, [(6, 3)]))
    pool_next = torch.tensor(fills, dtype=torch.int32, device=dev)
    kernels = {
        "decode_attention": (
            (randn(b, w, row, hd), randn(b, w, row, hd)), ring_next,
            lambda q, k, v, qp, r: decode_attention(q, k, v, qp, k_pos,
                                                    kv_range=r),
            lambda q, k, v, qp, r: decode_attention_plain(
                q, k, v, qp, k_pos, kv_range=r)),
        "paged_decode_attention": (
            (randn(b * m + 1, bs, row, hd), randn(b * m + 1, bs, row, hd)),
            pool_next,
            lambda q, k, v, qp, r: paged_decode_attention(
                q, k, v, qp, pos, bt, kv_range=r),
            lambda q, k, v, qp, r: paged_decode_attention_plain(
                q, k, v, qp, pos, bt, kv_range=r)),
    }
    errs = {}
    for name, ((k, v), nxt, kern, plain) in kernels.items():
        errs[name] = []
        launches = 0
        for t in (1, 5):
            q = randn(b, t, h, hd)
            qp = torch.clamp(nxt - t, min=0)
            label = (f"{name} kv_range={kv_range} of {row} KV heads, H={h} "
                     f"hd={hd} T={t}")
            errs[name].append(_check_rows(
                torch, label,
                lambda q, k, v, qp=qp: kern(q, k, v, qp, kv_range),
                lambda q, k, v, qp=qp: plain(q, k, v, qp, kv_range),
                (q, k, v), rows=2, bf16_abs=BF16_TOL))
            before = LAUNCHES[name]
            got = kern(q, k, v, qp, kv_range)
            torch.cuda.synchronize()
            if LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the launch counted "
                                     f"{LAUNCHES[name] - before}")
            launches += 1
            copy = kern(q, k[..., first:first + count, :].contiguous(),
                        v[..., first:first + count, :].contiguous(), qp,
                        None)
            if not torch.equal(got, copy):
                raise AssertionError(f"{label}: reading the range in place "
                                     f"!= the kernel on a copy of it")
        print(f"  {name} kv_range={kv_range}: T=1 and T=5 agree with the "
              f"plain version and bit for bit with the kernel on a copied "
              f"range; {launches} in-place launches counted")
        errs[name] = max(errs[name])
    return errs


def _tertiles(conf):
    """hi/lo midway between neighbouring sorted confidences at the
    tertiles, or at the nearest split whose neighbours lie farther than
    GATE_MARGIN (relative) from the midpoint (at thousands of rows none
    may lie near a tertile); fails if a confidence still lies that close
    to either."""
    srt = np.sort(np.asarray(conf, np.float64))
    n = len(srt)

    def cut(k):
        near = [k] + [k + d for a in range(1, n) for d in (-a, a)]
        cands = [j for j in near if 0 < j < n]
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
    # the reference's bulk shape (benchmarks/bench_kernels.py)
    cases += [BULK_GATE, (100, 500, "float32"), (7, 8000, "float32")]
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
    # LAYERS distinct inputs, as for the other kernels (at T = 1 they
    # still sit in L2, as the serving gate's logits do after the unembed);
    # one bulk input (537 MB) exceeds L2, so 2 suffice there
    shapes = [(t, v, dt, LAYERS) for t in (1, 64)
              for dt in ("float32", "bfloat16")] + [BULK_GATE + (2,)]
    for t, vv, dtype, n_in in shapes:
        xs = (torch.randn((n_in, t, vv), generator=gen, device=dev)
              * 3).to(getattr(torch, dtype))

        def kern(i):
            return cascade_gate(xs[i % n_in], hi=0.5, lo=0.1)

        def plain(i):
            return cascade_gate_plain(xs[i % n_in], 0.5, 0.1)

        def library(i):
            return torch.logsumexp(xs[i % n_in], dim=-1)

        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        # logits read once; conf and routes written once, 3 counts
        nbytes = _nbytes(xs[0]) + t * 8 + 12
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * t * vv / F32_FLOPS_PER_S * 1e3   # max, sub, exp, add
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        key = f"T={t} {dtype}" if vv == v else f"T={t} V={vv} {dtype}"
        times[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
        print(f"  cascade_gate T={t} V={vv} {dtype}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, logsumexp {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {nbytes} B)")
        del xs
    # what no kernel can beat at T = 1: one launch of the smallest op
    one = torch.zeros(1, device=dev)
    times["one-launch floor"] = dict(ms=timer(lambda i: one.add_(1)))
    print(f"  one-launch floor (in-place add on one element): "
          f"{times['one-launch floor']['ms']:.4f} ms")
    # the line's numbers: the serving gate's shape and type, (1, V) bf16
    return dict(max_abs_err=max(errs), **times["T=1 bfloat16"]), times


def check_rglru(torch, timer, dev):
    """``rglru_scan`` against its plain version at the hybrid prefill's
    shapes (B = 1, W = 4096; S = 512 and 4096), an odd (2, 77, 4000), 2048
    chunks on one look-back chain (1, 65536, 128), many chains (8, 2048,
    1024) and same-shape calls queued back to back on other values (a
    stale look-back flag would hand the second the first's states), then
    on the first's again (equal bits), all with h0 != 0; timed at the two
    serving shapes and at the widths a rank of phase 21's meshes scans,
    (1, 4096, 2048) at N = 2 and (1, 4096, 1024) at N = 4."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain

    gen = torch.Generator(device=dev).manual_seed(5)

    def inputs(n, b, s, w):
        # a in [0.8, 1): the model's decays; long memory, |h| up to ~30
        a = 0.8 + 0.1999 * torch.rand((n, b, s, w), generator=gen,
                                      device=dev)
        x = torch.randn((n, b, s, w), generator=gen, device=dev)
        return a, x, torch.randn((n, b, w), generator=gen, device=dev)

    def check(label, args, got):
        ph, ph_last = rglru_scan_plain(*args)
        h, h_last = got
        rel = max(((out - ref).abs() / ref.abs().clamp_min(1)).max().item()
                  for out, ref in ((h, ph), (h_last, ph_last)))
        err = (h - ph).abs().max().item()
        print(f"  rglru_scan {label} f32, h0 != 0: max|kernel - plain| = "
              f"{err:.3e}, {rel:.3e} of max(1, |h|) (tol {RGLRU_TOL}); "
              f"max|h| {ph.abs().max().item():.2f}")
        if not rel <= RGLRU_TOL or not torch.equal(h[:, -1], h_last):
            raise AssertionError(f"rglru_scan {label} disagrees")
        return err

    errs, times = [], {}
    a, x, h0 = inputs(2, 1, 4096, 256)
    got = [rglru_scan(a[i % 2], x[i % 2], h0[i % 2]) for i in range(3)]
    torch.cuda.synchronize()
    for i in range(2):
        errs.append(check(f"(1, 4096, 256) back-to-back call {i + 1}",
                          (a[i], x[i], h0[i]), got[i]))
    if not (torch.equal(got[0][0], got[2][0])
            and torch.equal(got[0][1], got[2][1])):
        raise AssertionError("rglru_scan: two calls on the same inputs "
                             "differ (the engine's streams need equal bits)")
    for b, s, w in ((1, 512, 4096), (1, 4096, 4096), (1, 4096, 2048),
                    (1, 4096, 1024), (2, 77, 4000), (1, 65536, 128),
                    (8, 2048, 1024)):
        a, x, h0 = inputs(1, b, s, w)
        got = rglru_scan(a[0], x[0], h0[0])
        torch.cuda.synchronize()
        errs.append(check(f"({b}, {s}, {w})", (a[0], x[0], h0[0]), got))
        if b > 1 or w < 1024:
            continue
        n_in = LAYERS if s <= 512 else 3        # both beyond L2 at S = 4096
        a, x, h0 = inputs(n_in, b, s, w)

        def kern(i):
            return rglru_scan(a[i % n_in], x[i % n_in], h0[i % n_in])

        def plain(i):
            return rglru_scan_plain(a[i % n_in], x[i % n_in], h0[i % n_in])

        ms, plain_ms = timer(kern), timer(plain, n=5)
        # a and b read, h written, h0 read, h_last written; a mul and an
        # add per element on the f32 CUDA cores
        nbytes = 12 * b * s * w + 8 * b * w
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * b * s * w / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        times[s, w] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=None)
        print(f"  rglru_scan ({b}, {s}, {w}) f32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library: none (no PyTorch call computes a "
              f"linear recurrence), bound {bound:.4f} ms ({by}; {nbytes} B)")
        del a, x, h0
    # the line's numbers: the longest prefill bucket of the hybrid trace
    return dict(max_abs_err=max(errs), **times[4096, 4096]), \
        {f"S={s}" + ("" if w == 4096 else f" W={w}"): r
         for (s, w), r in times.items()}


def check_kernels_in_graphs(torch, dev):
    """flash, ``rglru_scan`` and ``cascade_gate`` launched inside captured
    CUDA graphs, as the engines' admission, prefill and gate programs
    launch them: each kernel is captured into two graphs at serving-path
    shapes (flash once with a query that is not 16-byte aligned, so its
    copy runs inside the capture), and each graph is replayed twice with
    new values copied into its fixed inputs, an eager launch of the other
    graph's shape between replays. Every replay and every eager launch is
    held against the plain version, and ``LAUNCHES`` grows by one a
    replay. Returns each kernel's largest error."""
    import repro_torch.kernels as K
    from repro_torch.kernels.cascade_gate import (cascade_gate,
                                                  cascade_gate_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.serving.engine import _Program, capture_stream

    gen = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    hi, lo = 0.5, 0.01

    def randn(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_case(qs, ks, misaligned):
        n = int(np.prod(qs))
        qbuf = torch.zeros(n + 8, dtype=bf16, device=dev)
        q = (qbuf[1:1 + n] if misaligned else qbuf[:n]).view(qs)
        ins = [q, torch.zeros(ks, dtype=bf16, device=dev),
               torch.zeros(ks, dtype=bf16, device=dev)]

        def fresh():
            for t in ins:
                t.copy_(randn(t.shape, bf16))

        def check(out):
            ref = flash_attention_plain(*ins, causal=True).float()
            diff = (out[0].float() - ref).flatten(2).norm(dim=2)
            err = (diff / ref.flatten(2).norm(dim=2).clamp_min(1e-6)).max()
            return err.item(), err.item() <= ATTN_ROW_REL_TOL

        return ins, fresh, lambda: [flash_attention(*ins, causal=True)], \
            check

    def scan_case(b, t, w):
        ins = [torch.zeros((b, t, w), device=dev) for _ in range(2)] + \
            [torch.zeros((b, w), device=dev)]

        def fresh():
            ins[0].copy_(0.8 + 0.1999 * torch.rand(
                ins[0].shape, generator=gen, device=dev))
            for x in ins[1:]:
                x.copy_(randn(x.shape))

        def check(out):
            err = max(((r - p).abs() / p.abs().clamp_min(1)).max().item()
                      for r, p in zip(out, rglru_scan_plain(*ins)))
            return err, err <= RGLRU_TOL

        return ins, fresh, lambda: list(rglru_scan(*ins)), check

    def gate_case(t, v, dtype):
        ins = [torch.zeros((t, v), dtype=dtype, device=dev)]

        def fresh():
            # a peak of 0-15 over unit noise: confidences ~1e-5 to ~0.9
            x = randn((t, v))
            x[torch.arange(t, device=dev), torch.randint(
                0, v, (t,), generator=gen, device=dev)] += \
                15 * torch.rand((t,), generator=gen, device=dev)
            ins[0].copy_(x.to(dtype))

        def check(out):
            conf, routes, counts = cascade_gate_plain(ins[0], hi, lo)
            err = ((out[0] - conf).abs() / conf).max().item()
            far = ((conf - hi).abs() > GATE_MARGIN * hi) & \
                ((conf - lo).abs() > GATE_MARGIN * lo)
            same = bool((out[1] == routes)[far].all()) and (
                not bool(far.all()) or torch.equal(out[2], counts))
            return err, same and err <= GATE_TOL["float32"]

        return ins, fresh, lambda: list(cascade_gate(ins[0], hi=hi, lo=lo)),\
            check

    cases = {
        # smollm-135m's and qwen3-4b's prefill layouts
        "flash_attention": [flash_case((1, 512, 9, 64), (1, 512, 3, 64), True),
                            flash_case((1, 256, 32, 128), (1, 256, 8, 128),
                                       False)],
        "rglru_scan": [scan_case(1, 512, 4096), scan_case(2, 77, 4000)],
        "cascade_gate": [gate_case(1, 49152, bf16),
                         gate_case(64, 49152, f32)],
    }
    pool = torch.cuda.graph_pool_handle()
    out = {}
    for name, specs in cases.items():
        graphs = []
        for i, (ins, fresh, run, check) in enumerate(specs):
            fresh()
            res = [x.clone() for x in run()]   # eager first: libraries

            def body(run=run, res=res):
                for r, x in zip(res, run()):
                    r.copy_(x)

            torch.cuda.synchronize()
            graphs.append((_Program((name, i), pool, capture_stream(dev),
                                    body), res))
        errs = []
        for rnd in range(2):
            for i, ((prog, res), (_, fresh, _, check)) in enumerate(
                    zip(graphs, specs)):
                fresh()
                before = K.LAUNCHES[name]
                prog.replay((name, i))
                torch.cuda.synchronize()
                if K.LAUNCHES[name] != before + 1:
                    raise AssertionError(f"{name}: a replay did not count "
                                         f"one launch")
                checks = [(f"graph {i} replay {rnd}", check(res))]
                _, fresh_other, run_other, check_other = specs[1 - i]
                fresh_other()
                checks.append(("an eager launch between replays",
                               check_other(run_other())))
                for label, (err, ok) in checks:
                    errs.append(err)
                    if not ok:
                        raise AssertionError(f"{name}: {label} disagrees "
                                             f"with the plain version "
                                             f"({err:.3e})")
        out[name] = max(errs)
        print(f"  {name} inside CUDA graphs: 2 graphs x 2 replays on new "
              f"inputs, an eager launch between replays: max error vs plain "
              f"{max(errs):.3e}; one launch counted a replay")
        del graphs
    return out


def time_admissions(torch, label, smi, eng, n=2):
    """Each admission bucket of a warmed, idle engine: the eager call of
    its program against the replay of its CUDA graph, a prompt of the
    bucket's length into slot 0 with ``max_new`` 0 (a no-op admission, as
    the warm-up's). Device time by CUDA events, the median of ``n`` calls
    (both ran in ``warm_compile`` and traffic already). Returns {bucket:
    {eager_ms, replay_ms}}."""
    rng = np.random.default_rng(3)
    rows = {}
    for key in [k for k in eng.program_keys() if k[0] == "admit"]:
        b = key[1]
        eng._args.put(slot=0, length=b, max_new=0, temp=0.0, rid=0,
                      row=np.full(eng._args["row"].numel(), -1),
                      tokens=rng.integers(0, eng.lm.cfg.vocab_size, b))
        prog = eng._programs[key]
        times = {}
        for how, fn in (("eager_ms", lambda: eng._program_body(key)),
                        ("replay_ms", lambda: prog.replay(key))):
            ms = []
            for _ in range(n):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize()
                s.record()
                fn()
                e.record()
                e.synchronize()
                ms.append(s.elapsed_time(e))
            times[how] = statistics.median(ms)
        rows[b] = times
    print(f"  {label} admission by bucket [{smi}], eager ms / replay ms: "
          + ", ".join(f"{b}: {t['eager_ms']:.2f} / {t['replay_ms']:.2f}"
                      for b, t in rows.items()))
    return rows


def _check_rows(torch, name, kernel, plain, inputs, rows, bf16_abs=None):
    """Hold ``kernel`` against ``plain`` on bf16 ``inputs`` (the main
    path's dtype), per query row to ATTN_ROW_REL_TOL (and to ``bf16_abs``
    absolute where given), and on the same values in f32 to ATTN_F32_TOL.
    The output's first ``rows`` dims index query rows, each of (heads, hd);
    rows that see no key must be 0 in both. Returns the bf16 max abs
    error."""
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        xs = [x.to(dt) for x in inputs]
        got = kernel(*xs).float()
        torch.cuda.synchronize()
        ref = plain(*xs).float()
        diff = got - ref
        err = diff.abs().max().item()
        num = diff.flatten(rows).norm(dim=-1)
        den = ref.flatten(rows).norm(dim=-1)
        seen = den > 0
        rel = (num[seen] / den[seen]).max().item()
        stray = (got.flatten(rows)[~seen].abs().max().item()
                 if bool((~seen).any()) else 0.0)
        print(f"  {name} {str(dt)[6:]}: max|plain| "
              f"{ref.abs().max().item():.3e}, RMS(plain) "
              f"{ref.square().mean().sqrt().item():.3e}, max|kernel - plain|"
              f" {err:.3e}, max row |kernel - plain|/|plain| {rel:.3e}, "
              f"rows seeing no key {int((~seen).sum())} (|kernel| "
              f"{stray:.1e})")
        if dt == torch.bfloat16:
            ok = rel < ATTN_ROW_REL_TOL and (bf16_abs is None
                                             or err < bf16_abs)
        else:
            ok = err < ATTN_F32_TOL
        if not ok or stray != 0:
            raise AssertionError(
                f"{name} disagrees in {dt} (tol: bf16 row "
                f"{ATTN_ROW_REL_TOL}, abs {bf16_abs}; f32 abs "
                f"{ATTN_F32_TOL})")
        errs[dt] = err
        del got, ref, diff
    return errs[torch.bfloat16]


def _ring_positions(torch, totals, w, dev):
    """k_pos (B, W) of rings that hold each slot's last ``min(total, W)``
    tokens at ``t % W`` (filled, wrapped, or empty at 0), and q_pos (B,) =
    the totals: each slot's next token."""
    k_pos = torch.full((len(totals), w), -1, dtype=torch.int32)
    for i, total in enumerate(totals):
        tok = torch.arange(max(0, total - w), total, dtype=torch.int32)
        k_pos[i, tok % w] = tok
    return k_pos.to(dev), torch.tensor(totals, dtype=torch.int32, device=dev)


def _ring_case(torch, timer, dev, gen, label, kv, g, hd, w, window, totals,
               t=1):
    """The bf16 ring decode at one main-path shape (B = len(totals)): a
    decode step (T = 1) or a speculative verify chunk of T tokens per slot
    appended at each slot's next position. Held row by row against its
    plain version, then timed beside it and SDPA over the same ring (the
    visible keys as a mask), with its bound and key splits."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, query_positions)
    import torch.nn.functional as F

    b, h = len(totals), kv * g
    # a verify chunk's own keys are in the ring before it attends (T = 1
    # keeps the ring of the earlier PRs' cases, the step's key not in it)
    ends = totals if t == 1 else [n + t for n in totals]
    k_pos, _ = _ring_positions(torch, ends, w, dev)
    q_pos = torch.tensor(totals, dtype=torch.int32, device=dev)
    ks, vs = (torch.randn((LAYERS, b, w, kv, hd), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    q1 = torch.randn((LAYERS, b, t, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    name = f"decode_attention {label} B={b} W={w} KV={kv} G={g} hd={hd} " \
        f"T={t} window={window}"
    err = _check_rows(
        torch, name,
        lambda *x: decode_attention(*x, q_pos, k_pos, window=window),
        lambda *x: decode_attention_plain(*x, q_pos, k_pos, window=window),
        (q1[0], ks[0], vs[0]), rows=2)
    qp = query_positions(q_pos, t)[:, :, None]
    visible = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= qp)
    if window is not None:
        visible &= k_pos[:, None, :] > qp - window
    mask = visible[:, None]
    qt = [q1[i].transpose(1, 2) for i in range(LAYERS)]
    kt = [ks[i].transpose(1, 2) for i in range(LAYERS)]
    vt = [vs[i].transpose(1, 2) for i in range(LAYERS)]
    ms = timer(lambda i: decode_attention(
        q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos,
        window=window))
    plain_ms = timer(lambda i: decode_attention_plain(
        q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos,
        window=window))
    lib_ms = timer(lambda i: F.scaled_dot_product_attention(
        qt[i % LAYERS], kt[i % LAYERS], vt[i % LAYERS], attn_mask=mask,
        enable_gqa=True))
    # q, out, both position arrays, and the K/V rows some query may see
    live = int(visible.any(dim=1).sum())
    nbytes = (2 * _nbytes(q1[0]) + _nbytes(q_pos, k_pos)
              + 2 * live * kv * hd * 2)
    bound, by = _bound_ms(nbytes, 4 * int(visible.sum()) * h * hd)
    nsplit, part = _ring_split(torch, b, t, h, kv, w, hd, dev)
    print(f"  {name} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes} B); "
          f"{nbytes / ms / 1e6:.1f} GB/s; {nsplit} key splits, {part} B of "
          f"f32 partials")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, gb_per_s=nbytes / ms / 1e6,
                splits=nsplit, partial_bytes=part)


def _flash_case(torch, timer, dev, gen, label, s, kv, g, hd, window, n_in):
    """The bf16 flash kernel on one S-token prefill (causal, or banded by
    ``window``): held row by row against its plain version, timed beside
    it and SDPA (``is_causal``, or the band as a mask) on ``n_in``
    distinct inputs, with its bound."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F

    h = kv * g
    qs = torch.randn((n_in, 1, s, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    ks, vs = (torch.randn((n_in, 1, s, kv, hd), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    name = f"flash_attention {label} B=1 S={s} H={h} KV={kv} hd={hd} " \
        f"window={window}"
    err = _check_rows(
        torch, name,
        lambda *x: flash_attention(*x, causal=True, window=window),
        lambda *x: flash_attention_plain(*x, causal=True, window=window),
        (qs[0], ks[0], vs[0]), rows=2)
    pos = torch.arange(s, device=dev)
    band = pos[None, :] <= pos[:, None]
    if window is not None:
        band &= pos[None, :] > pos[:, None] - window
    sdpa = dict(attn_mask=band) if window is not None else \
        dict(is_causal=True)
    qt = [qs[i].transpose(1, 2) for i in range(n_in)]
    kt = [ks[i].transpose(1, 2) for i in range(n_in)]
    vt = [vs[i].transpose(1, 2) for i in range(n_in)]
    n = 25 if n_in == LAYERS else 5
    ms = timer(lambda i: flash_attention(
        qs[i % n_in], ks[i % n_in], vs[i % n_in], causal=True,
        window=window), n=n)
    plain_ms = timer(lambda i: flash_attention_plain(
        qs[i % n_in], ks[i % n_in], vs[i % n_in], causal=True,
        window=window), n=n)
    lib_ms = timer(lambda i: F.scaled_dot_product_attention(
        qt[i % n_in], kt[i % n_in], vt[i % n_in], enable_gqa=True, **sdpa),
        n=n)
    flops = 4 * int(band.sum()) * h * hd
    nbytes = 2 * _nbytes(qs[0]) + _nbytes(ks[0], vs[0])
    bound, by = _bound_ms(nbytes, flops)
    print(f"  {name} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes} B, {flops} "
          f"flop); {flops / ms / 1e9:.1f} TFLOP/s in the band")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, tflop_per_s=flops / ms / 1e9)


def _paged_case(torch, timer, dev, gen, label, kv, g, hd, t, window,
                verify=False):
    """The bf16 paged kernel over phase 2's pool (8 slots of 1-1000 tokens
    in 16-token blocks, M = 64, a freed slot, a table with holes): T = 1
    decode for every slot; with ``verify`` a speculative verify chunk, the
    last T tokens of every slot; else a T-token prompt chunk of slot 4 at
    256.. under a table cut to 512 positions (the engine's ``ctx``). Held
    row by row against its plain version, timed beside it and SDPA on the
    pre-gathered context (gather excluded), with its bound and splits."""
    from repro_torch.kernels.decode_attention import (
        gather_paged_kv, paged_decode_attention, paged_decode_attention_plain,
        paged_split_len, query_positions)
    import torch.nn.functional as F

    bs, m, h = 16, 64, kv * g
    fills = [1, 17, 200, 480, 1000, 0, 700, 333]
    n_blocks = len(fills) * m + 1
    pos, bt = _paged_pool(np.random.default_rng(3), fills, bs, m, n_blocks,
                          [(6, 3), (6, 10), (6, 20)])
    k_pos, bt = torch.from_numpy(pos).to(dev), torch.from_numpy(bt).to(dev)
    ks, vs = (torch.randn((LAYERS, n_blocks, bs, kv, hd), generator=gen,
                          device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    if t == 1 or verify:
        q_pos = torch.tensor([max(f - t, 0) for f in fills],
                             dtype=torch.int32, device=dev)
    else:
        q_pos = torch.tensor([256], dtype=torch.int32, device=dev)
        bt = bt[4:5, :32].contiguous()
    b = bt.shape[0]
    qs = torch.randn((LAYERS, b, t, h, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    name = f"paged_decode_attention {label} B={b} bs={bs} M={bt.shape[1]} " \
        f"KV={kv} G={g} hd={hd} T={t} window={window}"
    err = _check_rows(
        torch, name,
        lambda *x: paged_decode_attention(*x, q_pos, k_pos, bt,
                                          window=window),
        lambda *x: paged_decode_attention_plain(*x, q_pos, k_pos, bt,
                                                window=window),
        (qs[0], ks[0], vs[0]), rows=2)
    _, ctx_pos = gather_paged_kv(ks[0], k_pos, bt)
    qp = query_positions(q_pos, t)
    visible = (ctx_pos[:, None, :] >= 0) & (ctx_pos[:, None, :]
                                            <= qp[:, :, None])
    if window is not None:
        visible &= ctx_pos[:, None, :] > qp[:, :, None] - window
    mask = visible[:, None]
    qt = [qs[i].transpose(1, 2) for i in range(LAYERS)]
    kt = [gather_paged_kv(ks[i], k_pos, bt)[0].transpose(1, 2)
          for i in range(LAYERS)]
    vt = [gather_paged_kv(vs[i], k_pos, bt)[0].transpose(1, 2)
          for i in range(LAYERS)]
    ms = timer(lambda i: paged_decode_attention(
        qs[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos, bt,
        window=window))
    plain_ms = timer(lambda i: paged_decode_attention_plain(
        qs[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos, bt,
        window=window))
    lib_ms = timer(lambda i: F.scaled_dot_product_attention(
        qt[i % LAYERS], kt[i % LAYERS], vt[i % LAYERS], attn_mask=mask,
        enable_gqa=True))
    # q, out, q_pos, the tables, one position per token of each table
    # block, and the K/V rows some query may see
    live = int(visible.any(dim=1).sum())
    nbytes = (2 * _nbytes(qs[0]) + _nbytes(q_pos, bt)
              + int((bt >= 0).sum()) * bs * k_pos.element_size()
              + 2 * live * kv * hd * 2)
    bound, by = _bound_ms(nbytes, 4 * int(visible.sum()) * h * hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mm = bt.shape[1]
    nsplit = -(-mm * bs // paged_split_len(b, t, h, kv, mm, bs, hd, sms))
    print(f"  {name} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"on the pre-gathered context (gather excluded) {lib_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}; {nbytes} B); {nsplit} key splits, "
          f"{-(-t * g // 64)} row tiles a KV head")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, splits=nsplit)


def check_attention_hd256(torch, timer, dev):
    """``decode_attention`` and ``flash_attention`` at recurrentgemma-9b's
    local attention (hd 256, 16 query heads over one KV head, window 2048)
    against their plain versions, timed against SDPA as the yardstick: the
    ring of 8 slots 2048 wide (partly filled, wrapped, empty) and one
    4096-token prefill bucket."""
    gen = torch.Generator(device=dev).manual_seed(6)
    args = dict(kv=1, g=16, hd=256, window=2048)
    return {
        "decode_attention": _ring_case(
            torch, timer, dev, gen, "recurrentgemma-9b", w=2048,
            totals=[300, 2048, 2900, 0, 17, 1500, 4000, 2100], **args),
        "flash_attention": _flash_case(
            torch, timer, dev, gen, "recurrentgemma-9b", s=4096, n_in=3,
            **args)}


# the hd-128 models: model -> (KV heads, G, ring width and window, the
# flash prefill's S and inputs); mixtral-8x22b's G = 6 under its 4096
# window on phase 16's 1024-wide ring
HD128 = {"qwen3-4b": (8, 4, 1024, None, 512, LAYERS),
         "glm4-9b": (2, 16, 1024, None, 512, LAYERS),
         "starcoder2-7b": (4, 9, 4096, 4096, 4608, 3),
         "mixtral-8x22b": (8, 6, 1024, 4096, 512, LAYERS)}


def check_attention_hd128(torch, timer, dev):
    """The three attention kernels at each hd-128 model's head layout:
    the ring decode (B = 8, T = 1; slots partly filled, wrapped and empty;
    starcoder2's 4096 window on its 4096-wide ring, mixtral's on a
    1024-wide one), the paged kernel at T = 1 and on one 128-token chunk
    (512, 2048, 1152 and 768 query rows a KV head), and flash on a
    512-token prefill (qwen3, glm4, mixtral under its window) or a
    4608-token one banded by starcoder2's window. Then flash at
    deepseek-v3-671b's MLA prefill: 128 heads of 192 dims, one KV head per
    query head (G = 1), S = 512."""
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for model, (kv, g, w, window, s, n_in) in HD128.items():
        args = dict(kv=kv, g=g, hd=128, window=window)
        rec = out[model] = {}
        rec["decode_attention"] = _ring_case(
            torch, timer, dev, gen, model, w=w,
            totals=[n * w // 1024 for n in (300, 512, 2524, 0, 17, 900,
                                             1023, 1500)], **args)
        for t in (1, 128):
            rec[f"paged_decode_attention T={t}"] = _paged_case(
                torch, timer, dev, gen, model, t=t, **args)
        rec["flash_attention"] = _flash_case(torch, timer, dev, gen, model,
                                             s=s, n_in=n_in, **args)
        torch.cuda.empty_cache()
    out["deepseek-v3-671b"] = {"flash_attention": _flash_case(
        torch, timer, dev, gen, "deepseek-v3-671b MLA", s=512, kv=128, g=1,
        hd=192, window=None, n_in=LAYERS)}
    torch.cuda.empty_cache()
    return out


# phase 24's per-rank layouts: glm4-9b's 32 query heads over 2 KV heads
# on 4 ranks (8 over the one KV head a rank reads, G = 8, hd 128) at its
# training sequence, and recurrentgemma-9b's scan at W/2 and W/4
TP_TRAIN_FLASH = ("glm4-9b on 4 ranks", 1, 4096, 8, 1, 128, None)
TP_TRAIN_SCANS = ((1, 4096, 2048), (1, 4096, 1024))


def check_tp_train_shapes(torch, timer, dev):
    """Phase 24's kernel shapes: flash forward (row by row, against SDPA)
    and its backward kernels at ``TP_TRAIN_FLASH``, the scan's reverse mode
    at ``TP_TRAIN_SCANS`` (its forward there: ``check_rglru``), each held
    against its plain version and timed with its bound."""
    gen = torch.Generator(device=dev).manual_seed(24)
    label, _, s, h, kv, hd, window = TP_TRAIN_FLASH
    return {"flash_attention": _flash_case(
                torch, timer, dev, gen, label, s=s, kv=kv, g=h // kv, hd=hd,
                window=window, n_in=1),
            "flash_attention_bwd": check_flash_bwd(
                torch, timer, dev, (TP_TRAIN_FLASH,))[1],
            "rglru_scan_bwd": check_rglru_bwd(torch, timer, dev,
                                              TP_TRAIN_SCANS)[1]}


# phase 17's new attention layouts: model -> (KV heads, G, hd, the flash
# prefill's S): musicgen-medium's MHA at hd 64 (G = 1: one query row a KV
# head in the decode kernels' tensor-core tile), internvl2-2b's G = 2 at hd
# 128 behind its 256-token image prefix
MODAL_ATTN = {"musicgen-medium": (24, 1, 64, 512),
              "internvl2-2b": (8, 2, 128, 256 + 128)}
# the cascade gate at internvl2-2b's padded vocab, the query batch's rows
MODAL_GATE = (16, 92672)


def check_modal_shapes(torch, timer, dev):
    """Phase 17's kernel shapes: the ring decode (B = 8, T = 1, a 1024-wide
    ring partly filled, wrapped and empty) and flash (one S-token
    prefill) at each ``MODAL_ATTN`` layout, held row by row against their
    plain versions and timed against SDPA; then ``cascade_gate`` at V =
    92,672 in bf16 (one query batch of 16 rows, and one row), held against
    its plain version, timed against logsumexp, with its bound."""
    from repro_torch.kernels.cascade_gate import (cascade_gate,
                                                  cascade_gate_plain)

    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for model, (kv, g, hd, s) in MODAL_ATTN.items():
        args = dict(kv=kv, g=g, hd=hd, window=None)
        out[model] = {
            "decode_attention": _ring_case(
                torch, timer, dev, gen, model, w=1024,
                totals=[300, 512, 2524, 0, 17, 900, 1023, 1500], **args),
            "flash_attention": _flash_case(torch, timer, dev, gen, model, s=s,
                                           n_in=LAYERS, **args)}
        torch.cuda.empty_cache()
    t_rows, v = MODAL_GATE
    for t in (t_rows, 1):
        xs = (torch.randn((LAYERS, t, v), generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        conf0 = cascade_gate_plain(xs[0], 1.0, 0.0)[0].cpu().numpy()
        hi, lo = _tertiles(conf0) if t >= 3 else (2.0, 0.0)
        conf, routes, counts = cascade_gate(xs[0], hi=hi, lo=lo)
        pconf, proutes, pcounts = cascade_gate_plain(xs[0], hi, lo)
        rel = ((conf - pconf).abs() / pconf).max().item()
        err = (conf - pconf).abs().max().item()
        if not rel < GATE_TOL["bfloat16"] or not torch.equal(
                routes, proutes) or not torch.equal(counts, pcounts):
            raise AssertionError(f"cascade_gate T={t} V={v} bf16 disagrees")
        ms = timer(lambda i: cascade_gate(xs[i % LAYERS], hi=0.5, lo=0.1))
        plain_ms = timer(lambda i: cascade_gate_plain(xs[i % LAYERS], 0.5,
                                                      0.1))
        lib_ms = timer(lambda i: torch.logsumexp(xs[i % LAYERS], dim=-1))
        nbytes = _nbytes(xs[0]) + t * 8 + 12
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * t * v / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[f"cascade_gate T={t} V={v}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by)
        print(f"  cascade_gate T={t} V={v} bfloat16: max|kernel - plain| "
              f"{err:.3e} ({rel:.3e} relative, tol {GATE_TOL['bfloat16']}); "
              f"counts {counts.tolist()}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, logsumexp {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {nbytes} B)")
        del xs
    return out


# the speculative verify chunk (k = 4: T = 5 tokens a slot) at the layouts
# phase 13 serves and glm4-9b's G = 16: model -> (KV heads, G, hd)
VERIFY = {"smollm-135m": (3, 3, 64), "qwen3-4b": (8, 4, 128),
          "glm4-9b": (2, 16, 128)}
VERIFY_T = 5


def check_verify_shapes(torch, timer, dev):
    """The ring and the paged kernel at the verify chunk's shapes: B = 8
    slots of T = 5 tokens each (T x G = 15, 20 and 80 query rows a KV
    head), the ring 1024 wide (slots partly filled, wrapped and empty), the
    paged pool phase 2's; each held row by row and timed against its plain
    version and SDPA, with its bound and key splits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for model, (kv, g, hd) in VERIFY.items():
        args = dict(kv=kv, g=g, hd=hd, window=None, t=VERIFY_T)
        out[model] = {
            "decode_attention": _ring_case(
                torch, timer, dev, gen, f"{model} verify", w=1024,
                totals=[300, 512, 2520, 0, 17, 900, 1000, 1500], **args),
            "paged_decode_attention": _paged_case(
                torch, timer, dev, gen, f"{model} verify", verify=True,
                **args)}
        torch.cuda.empty_cache()
    return out


def check_sampler(torch, timer, dev):
    """The keyed sampler (threefry2x32, plain torch: JAX computes it in XLA,
    outside any Pallas kernel) on the card: the bits and the uniforms of
    8 per-request keys at smollm-135m's and qwen3-4b's padded vocabularies
    equal the same draw on the CPU bit for bit, and so do the sampled
    tokens of random logits (the two devices' ``log`` may differ by an ulp,
    far below these rows' top-2 margins); then its time per call (device
    time by the timer, and host time) at (8, 49152) and (8, 152064), and
    the device time of one replay of the draw captured as a CUDA graph (as
    the engine's decode programs run it; same tokens)."""
    from repro_torch.serving.sampler import (prng_key, random_bits,
                                             request_keys,
                                             sample_logits_keyed, uniform)

    out = {}
    rids = torch.arange(8, dtype=torch.int64) * 977 + 3
    steps = torch.arange(8, dtype=torch.int64) * 31
    for v in (49152, 152064):
        keys = {d: request_keys(prng_key(7, device=d), rids.to(d),
                                steps.to(d)) for d in ("cpu", dev)}
        for fn in (random_bits, uniform):
            got = fn(keys[dev], (v,)).cpu()
            want = fn(keys["cpu"], (v,))
            if fn is uniform:
                got, want = got.view(torch.int32), want.view(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError(f"sampler {fn.__name__} at (8, {v}): "
                                     f"card != CPU")
        logits = torch.randn((8, v), generator=torch.Generator().manual_seed(
            v), dtype=torch.float32) * 3.0
        temp = torch.full((8,), 0.8)
        got = sample_logits_keyed(keys[dev], logits.to(dev), temp.to(dev))
        want = sample_logits_keyed(keys["cpu"], logits, temp)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"sampled tokens at (8, {v}): card != CPU")
        lg, tp = logits.to(dev), temp.to(dev)
        ms = timer(lambda i: sample_logits_keyed(keys[dev], lg, tp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            sample_logits_keyed(keys[dev], lg, tp)
        host_ms = (time.perf_counter() - t0) * 100
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graphed = sample_logits_keyed(keys[dev], lg, tp)
        graph.replay()
        if not torch.equal(graphed.cpu(), want):
            raise AssertionError(f"graphed sampler at (8, {v}): tokens != "
                                 f"CPU")
        graph_ms = timer(lambda i: graph.replay())
        del graph, graphed
        print(f"  sampler (8, {v}): threefry bits and uniforms equal the "
              f"CPU's bit for bit, sampled tokens equal; "
              f"sample_logits_keyed {ms:.4f} ms of device time, "
              f"{host_ms:.3f} ms of host time per call; as a CUDA graph "
              f"{graph_ms:.4f} ms of device time a replay")
        out[v] = dict(ms=ms, host_ms=host_ms, graph_ms=graph_ms)
    return out


def sweep_attention(torch, timer, dev):
    """The bf16 flash kernel at every launch shape it takes
    and the ring decode at several keys per split, at the phase-2 shapes
    (the launch rules' picks among them), and the fixed floor of each: the
    ring over an all-empty cache (no tile live: positions, the combine
    kernel and two launches) and a 16-token prefill (one key tile)."""
    import repro_torch.kernels.decode_attention as da
    import repro_torch.kernels.flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(8)
    rec = {"flash": {}, "decode": {}}
    for hd, s, h, kv, window, n_in in ((64, 512, 9, 3, None, LAYERS),
                                       (128, 512, 32, 8, None, LAYERS),
                                       (256, 4096, 16, 1, 2048, 3)):
        qs = torch.randn((n_in, 1, s, h, hd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        ks, vs = (torch.randn((n_in, 1, s, kv, hd), generator=gen,
                              device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
        pick = fa.flash_launch_shape(1, s, h, hd, torch.cuda.
                                     get_device_properties(dev).
                                     multi_processor_count)
        rule = fa.flash_launch_shape
        for shape in ((64, 1), (32, 1), (32, 2), (16, 1), (16, 2), (16, 4)):
            if shape[1] > (4 if hd <= 64 else 2):
                continue
            fa.flash_launch_shape = lambda *a, shape=shape: shape
            ms = timer(lambda i: fa.flash_attention(
                qs[i % n_in], ks[i % n_in], vs[i % n_in], causal=True,
                window=window), n=5 if n_in < LAYERS else 25)
            fa.flash_launch_shape = rule
            rec["flash"][f"hd={hd} rows={shape[0]} groups={shape[1]}"] = ms
            print(f"  sweep flash hd={hd} S={s}: {shape[0]} rows x "
                  f"{shape[1]} key groups {ms:.4f} ms"
                  f"{' (the rule)' if shape == pick else ''}")
        del qs, ks, vs
        q = torch.randn((1, 16, h, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((1, 16, kv, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        ms = timer(lambda i: fa.flash_attention(q, k, v, causal=True))
        rec["flash"][f"hd={hd} floor"] = ms
        print(f"  sweep flash hd={hd} S=16 (one key tile, the floor): "
              f"{ms:.4f} ms")
    for hd, w, kv, g, window, totals in (
            (64, 1024, 3, 3, None, [300, 512, 2524, 0, 17, 900, 1023, 1500]),
            (128, 1024, 2, 16, None, [300, 512, 2524, 0, 17, 900, 1023,
                                      1500]),
            (256, 2048, 1, 16, 2048,
             [300, 2048, 2900, 0, 17, 1500, 4000, 2100])):
        b, h = len(totals), kv * g
        ks, vs = (torch.randn((LAYERS, b, w, kv, hd), generator=gen,
                              device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
        q1 = torch.randn((LAYERS, b, 1, h, hd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        k_pos, q_pos = _ring_positions(torch, totals, w, dev)
        pick = _ring_split(torch, b, 1, h, kv, w, hd, dev)[0]
        rule = da.ring_split_len
        for keys in (64, 128, 256, 512, 1024):
            da.ring_split_len = lambda *a, keys=keys: keys
            ms = timer(lambda i: da.decode_attention(
                q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos,
                window=window))
            da.ring_split_len = rule
            nsplit = -(-w // keys)
            part = b * h * nsplit * (hd + 2) * 4 if nsplit > 1 else 0
            rec["decode"][f"hd={hd} keys/split={keys}"] = ms
            print(f"  sweep decode hd={hd}: {keys} keys a split ({nsplit} "
                  f"split(s), {part} B of partials) {ms:.4f} ms"
                  f"{' (the rule)' if nsplit == pick else ''}")
        empty = torch.full_like(k_pos, -1)
        ms = timer(lambda i: da.decode_attention(
            q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, empty,
            window=window))
        rec["decode"][f"hd={hd} floor"] = ms
        print(f"  sweep decode hd={hd} all-empty ring (the floor): "
              f"{ms:.4f} ms")
        del ks, vs, q1
    rec["paged"] = sweep_paged(torch, timer, dev, gen)
    rec["rglru"] = sweep_rglru(torch, timer, dev, gen)
    rec["gate"] = sweep_gate(torch, timer, dev)
    return rec


def sweep_paged(torch, timer, dev, gen):
    """The bf16 paged kernel at phase 2's decode shape (B=8, 64 blocks of
    16, KV=3, G=3, hd 64) at several keys per split, and over an all-hole
    table (no tile live: the floor)."""
    import repro_torch.kernels.decode_attention as da

    b, kv, g, hd, bs, m = 8, 3, 3, 64, 16, 64
    rng = np.random.default_rng(8)
    fills = [1, 17, 200, 480, 1000, 0, 700, 333]
    pos, bt = _paged_pool(rng, fills, bs, m, b * m + 1)
    k_pos, bt = torch.from_numpy(pos).to(dev), torch.from_numpy(bt).to(dev)
    ks, vs = (torch.randn((LAYERS, b * m + 1, bs, kv, hd), generator=gen,
                          device=dev, dtype=torch.bfloat16) for _ in range(2))
    q1 = torch.randn((LAYERS, b, 1, kv * g, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q_pos = torch.tensor([max(f - 1, 0) for f in fills], dtype=torch.int32,
                         device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pick = da.paged_split_len(b, 1, kv * g, kv, m, bs, hd, sms)
    rule, rec = da.paged_split_len, {}
    for keys in (128, 256, 512, 1024):
        da.paged_split_len = lambda *a, keys=keys: keys
        ms = timer(lambda i: da.paged_decode_attention(
            q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos, bt))
        da.paged_split_len = rule
        rec[f"keys/split={keys}"] = ms
        print(f"  sweep paged hd={hd}: {keys} keys a split "
              f"({-(-m * bs // keys)} split(s)) {ms:.4f} ms"
              f"{' (the rule)' if keys == pick else ''}")
    holes = torch.full_like(bt, -1)
    ms = timer(lambda i: da.paged_decode_attention(
        q1[i % LAYERS], ks[i % LAYERS], vs[i % LAYERS], q_pos, k_pos, holes))
    rec["floor"] = ms
    print(f"  sweep paged hd={hd} all-hole tables (the floor): {ms:.4f} ms")
    return rec


def sweep_rglru(torch, timer, dev, gen):
    """The one-pass scan at the hybrid's two prefill shapes at several
    chunk lengths and look-back group sizes (the rules' picks marked)."""
    import repro_torch.kernels.rglru_scan as rs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule, group, rec = rs.chunk_len, rs._GROUP, {}
    for s, n_in in ((512, LAYERS), (4096, 3)):
        a = 0.8 + 0.1999 * torch.rand((n_in, 1, s, 4096), generator=gen,
                                      device=dev)
        x = torch.randn((n_in, 1, s, 4096), generator=gen, device=dev)
        h0 = torch.randn((n_in, 1, 4096), generator=gen, device=dev)
        pick = rule(1, s, 4096, sms)
        for chunk, grp in ((8, group), (16, group), (32, group), (32, 4),
                           (32, 8), (32, 32)):
            rs.chunk_len, rs._GROUP = (lambda *args, chunk=chunk: chunk), grp
            ms = timer(lambda i: rs.rglru_scan(a[i % n_in], x[i % n_in],
                                               h0[i % n_in]))
            rs.chunk_len, rs._GROUP = rule, group
            rec[f"S={s} chunk={chunk} group={grp}"] = ms
            print(f"  sweep rglru_scan (1, {s}, 4096): {chunk}-step chunks "
                  f"({32 * -(-s // chunk)} CTAs), groups of {grp} {ms:.4f} "
                  f"ms{' (the rules)' if (chunk, grp) == (pick, group) else ''}")
        del a, x, h0
    return rec


def sweep_gate(torch, timer, dev):
    """``cascade_gate`` over smollm's vocab at the serving gate (T = 1,
    bf16 and f32) and the one-shot batch (T = 64, bf16) at 1 to 8 splits
    of V a row (one split: one CTA a row, no cluster; the rule's pick
    marked)."""
    import repro_torch.kernels.cascade_gate as cg

    v, rule, rec = 49152, cg.gate_splits, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(9)
    for t, dtype in ((1, "bfloat16"), (1, "float32"), (64, "bfloat16")):
        xs = (torch.randn((LAYERS, t, v), generator=gen, device=dev)
              * 3).to(getattr(torch, dtype))
        vec = 16 // xs.element_size()
        pick = rule(t, v, xs.element_size(), sms)[0]
        for splits in (1, 2, 4, 6, 8):
            split_len = -(-v // (splits * vec)) * vec
            cg.gate_splits = lambda *a, n=splits, k=split_len: (n, k)
            ms = timer(lambda i: cg.cascade_gate(xs[i % LAYERS], hi=0.5,
                                                 lo=0.1))
            cg.gate_splits = rule
            rec[f"T={t} {dtype} splits={splits}"] = ms
            print(f"  sweep cascade_gate T={t} V={v} {dtype}: {splits} "
                  f"split(s) of {split_len} {ms:.4f} ms"
                  f"{' (the rule)' if splits == pick else ''}")
        del xs
    return rec


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
        err, scale, full = _prefill_vs_forward(lm, params, tokens, prompt)
        print(f"  smollm-135m {dtype}: prefill+decode vs forward max|diff| "
              f"= {err:.3e} (tol {tol}; max|logit| {scale:.2f})")
        if not (np.isfinite(scale) and err < tol):
            raise AssertionError(f"prefill+decode != forward ({dtype})")
        if dtype == "float32":
            # the whole model through the kernels vs the plain CPU path
            cpu = LM(cfg, device="cpu")
            ref, _ = cpu.forward(_to_device(params, "cpu"),
                                 {"tokens": tokens[:1].cpu()})
            gpu_err = (full[:1].cpu() - ref).abs().max().item()
            print(f"  smollm-135m float32: GPU kernels vs CPU plain forward "
                  f"max|diff| = {gpu_err:.3e} (tol {tol})")
            if not gpu_err < tol:
                raise AssertionError("GPU forward != CPU plain forward")
        del params, full


def _prefill_vs_forward(lm, params, tokens, prompt: int, mesh=None):
    """Prefill ``tokens[:, :prompt]`` into a 64-wide cache, decode the rest
    one token at a time: the largest |logit| difference against one full
    forward over ``tokens``, the forward's largest |logit|, and the
    forward's logits. ``mesh``: both paths on this rank's shards."""
    full, _ = lm.forward(params, {"tokens": tokens}, mesh=mesh)
    logits, caches = lm.prefill(params, {"tokens": tokens[:, :prompt]},
                                cache_width=64, mesh=mesh)
    err = (logits[:, -1] - full[:, prompt - 1]).abs().max().item()
    for t in range(prompt, tokens.shape[1]):
        step, caches = lm.decode_step(params, caches, tokens[:, t:t + 1], t,
                                      mesh=mesh)
        err = max(err, (step[:, 0] - full[:, t]).abs().max().item())
    return err, full.float().abs().max().item(), full


def _greedy_vs_forward(torch, lm, params, out, reqs, tol):
    """Greedy engine tokens against a teacher-forced forward over prompt +
    output, where the forward's top-2 margin exceeds ``tol`` and, on an
    MoE model, no layer's router sits within ``ROUTE_TOL`` of a tie at
    that position (there two bf16 paths may pick different experts):
    (tokens checked, tokens that agree)."""
    checked = agree = excused = 0
    for r, (prompt, temp) in zip(out, reqs):
        if temp > 0:
            continue
        ctx = torch.from_numpy(np.concatenate([prompt, r.output[:-1]])
                               .astype(np.int32))[None].to(lm.device)
        with _Routes(torch) as routes:
            logits, _ = lm.forward(params, {"tokens": ctx})
        tail = logits[0, len(prompt) - 1:].float()
        del logits
        top2 = torch.topk(tail, 2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > tol).cpu().numpy()
        if routes.calls:
            tie = routes.near_ties(ROUTE_TOL["bfloat16"])[0, len(prompt) - 1:]
            excused += int((sure & tie).sum())
            sure &= ~tie
        pred = tail.argmax(-1).cpu().numpy()
        checked += int(sure.sum())
        agree += int((pred[sure] == r.output[sure]).sum())
    print(f"  greedy tokens vs teacher-forced forward: {agree}/{checked} "
          f"agree where the margin exceeds {tol}"
          + (f" ({excused} more excused: a router within "
             f"{ROUTE_TOL['bfloat16']} of a tie)" if excused else ""))
    return checked, agree


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


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


def _smollm(dev, seed):
    """smollm-135m at full width and depth, bf16, weights from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    lm = LM(get_config("smollm-135m"), device=dev)
    return lm, lm.init(seed)


def _registries(eng):
    """Every program registry of an engine: its own, and a cascade's legs'
    (the cascade's own holds its gate programs)."""
    if hasattr(eng, "cloud_engine"):
        return eng, eng.edge_engine, eng.cloud_engine
    return (eng,)


def _warm(eng):
    """``warm_compile`` an engine (a cascade: both legs and its gate) and
    check that it registered every program the engine can run
    (``program_keys``) and that on the card each became a CUDA graph;
    returns the programs, which traffic must leave as they are
    (``_no_capture``)."""
    eng.warm_compile()
    for reg in _registries(eng):
        if set(reg._programs) != set(reg.program_keys()):
            raise AssertionError("warm_compile missed a program")
        if reg._use_graphs and reg.graphs() != len(reg._programs):
            raise AssertionError("warm_compile left an eager program")
    return [dict(reg._programs) for reg in _registries(eng)]


def _no_capture(eng, warmed, label):
    """No program (decode, admission, chunk, draft fill, gate, drain
    prefill or step) was built, no graph captured, during traffic."""
    if [dict(reg._programs) for reg in _registries(eng)] != warmed:
        raise AssertionError(f"{label}: a program was captured during "
                             f"traffic")


def _leg(eng, out, wall, bound):
    """One A/B leg's record: tokens/s, decode ms per step against the
    weights' read time, the admissions' device ms, TTFT p50, and the
    engine's graphs. Decode and prefill are device time, each on its own
    spans (``decode_s``, ``prefill_s``)."""
    gen = sum(len(r.output) for r in out)
    step = eng.decode_s / eng.decode_steps * 1e3
    return dict(tokens_per_s=gen / wall, wall_s=wall,
                decode_ms_per_step=step, bound_ms=bound,
                bound_ratio=step / bound, prefill_ms=eng.prefill_s * 1e3,
                admissions=eng.admissions,
                ttft_ms_p50=statistics.median(r.ttft_s * 1e3 for r in out),
                warm_compile_s=eng.warm_compile_s, graphs=eng.graphs(),
                pool_bytes=eng.graph_pool_bytes())


def _ab(torch, label, smi, lm, params, seed, reqs, legs, outs, tol):
    """Print an eager/graphed A/B (both legs served the same trace in this
    call) and hold the graphed streams to the eager ones: equal, or parted
    first at a near-tie of a teacher-forced forward."""
    equal, parted = _parted_at_near_tie(torch, lm, params, seed, reqs,
                                        outs["graphed"], outs["eager"], tol)
    legs["graphed"]["streams_vs_eager"] = dict(equal=equal, parted=parted)
    for name, x in legs.items():
        print(f"  {label} A/B, {name} [{smi}]: {x['tokens_per_s']:.1f} "
              f"tokens/s; decode {x['decode_ms_per_step']:.2f} ms per step "
              f"= {x['bound_ratio']:.1f}x the {x['bound_ms']:.2f} ms "
              f"weight-read bound; prefill {x['prefill_ms']:.1f} ms over "
              f"{x['admissions']} admissions; TTFT p50 "
              f"{x['ttft_ms_p50']:.1f} ms; "
              f"warm_compile {x['warm_compile_s']:.2f} s, {x['graphs']} "
              f"graphs, pool {x['pool_bytes'] / 1e6:.1f} MB")
    speedup = legs["graphed"]["tokens_per_s"] / legs["eager"]["tokens_per_s"]
    legs["graphed"]["tokens_per_s_vs_eager"] = speedup
    print(f"  {label} A/B: graphed / eager tokens/s {speedup:.2f}x; graphed "
          f"streams: {equal} equal the eager ones, {parted} part first at a "
          f"near-tie (margin <= {tol})")
    if equal == 0:
        raise AssertionError(f"{label}: no graphed stream equals the eager "
                             f"one")
    return legs


def check_engine(torch, dev, seed, smi, lm, params, reqs, max_seq_len=1024,
                 ab=False):
    """The ring ``ServingEngine`` (8 slots, K = 4) on ``reqs``, 32 new
    tokens each, after an eager warm-up on two of them (allocator and
    library handles, outside the measured run) and ``warm_compile`` (every
    program captured as a CUDA graph): every request finishes, no graph is
    captured during traffic, every prefill and decode attention is a
    kernel launch (a replay adds its capture's launches), the streams
    equal a graphed K = 1 engine's, and greedy tokens agree with a
    teacher-forced forward. With ``ab`` an eager engine (graphs off)
    serves the trace first, both legs are printed side by side, and each
    admission bucket's eager and replay times follow
    (``time_admissions``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=max_seq_len, seed=seed)
    bound = _weight_bytes(params) / HBM_BYTES_PER_S * 1e3
    warm = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warm._use_graphs = False            # a warm-up: nothing to capture
    _serve(warm, reqs[:2], 4)
    legs, outs = {}, {}
    if ab:
        eager = ServingEngine(lm, params, max_decode_steps=4, **kw)
        eager._use_graphs = False
        eager.warm_compile()
        outs["eager"], wall = _serve(eager, reqs, max_new)
        legs["eager"] = _leg(eager, outs["eager"], wall, bound)
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warmed = _warm(eng)
    n = _count_programs(eng)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve(eng, reqs, max_new)
    launches = dict(LAUNCHES)
    _no_capture(eng, warmed, f"{lm.cfg.name} ring")
    n_attn, n_mla = _attn_layers(lm.cfg)
    want = {"flash_attention": (n_attn + n_mla) * n["admits"],
            "decode_attention": n_attn * n["steps"],
            "paged_decode_attention": 0, "cascade_gate": 0, "rglru_scan": 0,
            **NO_BACKWARD}
    print(f"  launches on the main path: {launches} (expected {want}: "
          f"{n_attn + n_mla} per admission x {n['admits']}, {n_attn} per "
          f"decode step x {n['steps']} (MLA decode attends in plain torch);"
          f" programs run {n['runs']})")
    if launches != want or n["steps"] != eng.decode_steps or \
            n["admits"] != eng.admissions:
        raise AssertionError("launch counts do not match the main path")

    one = ServingEngine(lm, params, max_decode_steps=1, **kw)
    _warm(one)
    ref, _ = _serve(one, reqs, max_new)
    for a, b in zip(out, ref):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"K=4 stream != K=1 stream (request "
                                 f"{a.request_id})")
    print(f"  K=4 streams equal K=1 streams token for token, both graphed "
          f"({sum(len(r.output) for r in out)} tokens; host syncs "
          f"{eng.host_syncs} vs {one.host_syncs})")
    checked, agree = _greedy_vs_forward(torch, lm, params, out, reqs,
                                        BF16_LOGIT_TOL)
    if checked == 0 or agree != checked:
        raise AssertionError("engine tokens disagree with the model")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out)
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], decode_ms_per_step=step_ms,
                 decode_ms_per_token=eng.decode_s * 1e3 / gen,
                 decode_bound_ms=bound, prefill_ms=eng.prefill_s * 1e3,
                 decode_steps=eng.decode_steps, admissions=eng.admissions,
                 host_syncs=eng.host_syncs, launches=launches,
                 warm_compile_s=eng.warm_compile_s, graphs=eng.graphs(),
                 pool_bytes=eng.graph_pool_bytes(),
                 prompt_lengths=[len(p) for p, _ in reqs],
                 streams=[r.output.tolist() for r in out])
    print(f"  {lm.cfg.name} ring engine [{smi}]: {gen} tokens in {wall:.3f} "
          f"s = {gen / wall:.1f} tokens/s; TTFT p50 "
          f"{stats['ttft_ms_p50']:.1f} ms, max {ttft[-1]:.1f} ms; decode "
          f"{step_ms:.2f} ms per step of 8 slots, "
          f"{stats['decode_ms_per_token']:.2f} ms per token; prefill "
          f"{stats['prefill_ms']:.1f} ms over {eng.admissions} admissions; "
          f"warm_compile "
          f"{eng.warm_compile_s:.2f} s, {eng.graphs()} graphs, pool "
          f"{stats['pool_bytes'] / 1e6:.1f} MB")
    if ab:
        legs["graphed"] = _leg(eng, out, wall, bound)
        outs["graphed"] = out
        stats["ab"] = _ab(torch, f"{lm.cfg.name} ring", smi, lm, params,
                          seed, reqs, legs, outs, BF16_LOGIT_TOL)
        stats["admission_ms"] = time_admissions(
            torch, f"{lm.cfg.name} ring", smi, eng)
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


def _serve_waves(engine, trace, max_new, contended, strict=True):
    """Wave 1; with ``contended``, step until all 8 slots decode, then the
    priority-1 requests (else they go in up front, so nothing is
    preempted); drain; check invariants; wave 2; drain; check. Returns
    the requests in submission order and the wall time. Not ``strict``
    (a chaos run): a request may end cancelled or failed, and wave 1 may
    never fill all 8 slots at once."""
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
                if not strict:
                    break
                raise AssertionError("wave 1 drained before 8 slots decoded")
            engine.step()
        else:
            if strict:
                raise AssertionError("8 slots never decoded at once")
    ids += submit(hi, priority=1)
    done = engine.run()
    engine.assert_invariants()
    ids += submit(wave2)
    done.update(engine.run())
    engine.assert_invariants()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(ids) or (strict and any(
            done[i].status != "done" for i in ids)):
        raise AssertionError("not every request finished")
    return [done[i] for i in ids], wall


def check_paged_engine(torch, dev, seed, smi, lm, params):
    """The paged ``ServingEngine`` (block 16, 128-token chunks, prefix
    sharing, K = 4) on the two-wave trace with contended swap preemption:
    launches, the paths taken, streams against a K = 1 and an uncontended
    engine, and greedy tokens against a teacher-forced forward."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    trace = _paged_trace(seed, lm.cfg.vocab_size)
    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed,
              cache_backend="paged", block_size=16, chunk_tokens=128,
              prefix_sharing=True)
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warmed = _warm(eng)
    n = _count_programs(eng)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve_waves(eng, trace, max_new, contended=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _no_capture(eng, warmed, f"{lm.cfg.name} paged")
    n_attn, _ = _attn_layers(lm.cfg)
    chunks = n["chunks"]
    want = {"paged_decode_attention": n_attn * (n["steps"] + chunks),
            "flash_attention": 0, "decode_attention": 0, "cascade_gate": 0,
            "rglru_scan": 0, **NO_BACKWARD}
    print(f"  launches on the paged path: {launches} (expected {want}: "
          f"{n_attn} per decode step x {n['steps']} + per chunk x "
          f"{chunks}, MLA layers none; programs run {n['runs']})")
    if launches != want or n["steps"] != eng.decode_steps:
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
    _warm(one)
    ref1, _ = _serve_waves(one, trace, max_new, contended=True)
    calm = ServingEngine(lm, params, max_decode_steps=4, **kw)
    _warm(calm)
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
    checked, agree = _greedy_vs_forward(torch, lm, params, out,
                                        wave1 + hi + wave2, BF16_LOGIT_TOL)
    if checked == 0 or agree != checked:
        raise AssertionError("paged engine tokens disagree with the model")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out)
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], decode_ms_per_step=step_ms,
                 prefill_ms=eng.prefill_s * 1e3,
                 decode_steps=eng.decode_steps, chunks=chunks,
                 host_syncs=eng.host_syncs, launches=launches,
                 warm_compile_s=eng.warm_compile_s, graphs=eng.graphs(),
                 pool_bytes=eng.graph_pool_bytes(),
                 streams=[r.output.tolist() for r in out], **seen)
    print(f"  {lm.cfg.name} paged engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} "
          f"ms, max {ttft[-1]:.1f} ms; decode {step_ms:.2f} ms per step of 8 "
          f"slots; {chunks} chunks, prefill {stats['prefill_ms']:.1f} ms; "
          f"warm_compile {eng.warm_compile_s:.2f} s, "
          f"{eng.graphs()} graphs, pool {stats['pool_bytes'] / 1e6:.1f} MB")
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
                "paged_decode_attention": 0, "rglru_scan": 0, **NO_BACKWARD}
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
    warmed = _warm(eng)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=max_new, temperature=t)
           for p, t in reqs]
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _no_capture(eng, warmed, "cascade")
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
            "paged_decode_attention": 0, "rglru_scan": 0, **NO_BACKWARD}
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
        alone = ServingEngine(lm, params, seed=s, **kw)
        _warm(alone)
        ref, _ = _serve(alone, [q for _, q in mine], max_new)
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
                 trace=reqs, streams=[r.output.tolist() for r in out],
                 route_of=[r.route for r in out],
                 edge_decode_steps=ee.decode_steps,
                 cloud_decode_steps=ce.decode_steps, launches=launches,
                 warm_compile_s=ee.warm_compile_s + ce.warm_compile_s,
                 graphs=ee.graphs() + ce.graphs(),
                 pool_bytes=ee.graph_pool_bytes() + ce.graph_pool_bytes())
    print(f"  cascade engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms,"
          f" max {ttft[-1]:.1f} ms; gate {stats['gate_ms_per_request']:.2f} "
          f"ms per request (edge prefill + kernel); routes {routes}; "
          f"wan_bytes {m.wan_bytes}; warm_compile "
          f"{stats['warm_compile_s']:.2f} s, {stats['graphs']} graphs, "
          f"pools {stats['pool_bytes'] / 1e6:.1f} MB")
    return launches["cascade_gate"], stats


# -- phases 8 and 9: the RG-LRU hybrid, recurrentgemma-9b ---------------------

def _hybrid_cfg(dtype: str, cut: bool = False):
    """recurrentgemma-9b at full width in ``dtype``; ``cut`` keeps one
    (rec, rec, attn) repeat and one trailing rec block (4 layers)."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              param_dtype=dtype)
    if cut:
        cfg = dataclasses.replace(
            cfg, num_layers=4, stages=tuple(dataclasses.replace(st, repeat=1)
                                            for st in cfg.stages))
    return cfg


def _attn_layers(cfg):
    """(GQA attention blocks, MLA blocks) of a config."""
    n = {"attn": 0, "mla": 0}
    for st in cfg.stages:
        for bdef in st.blocks:
            if bdef.mixer in n:
                n[bdef.mixer] += st.repeat
    return n["attn"], n["mla"]


def _mixer_counts(cfg):
    """(RG-LRU blocks, attention blocks) of a config."""
    n = {"rglru": 0, "attn": 0}
    for st in cfg.stages:
        for bdef in st.blocks:
            n[bdef.mixer] += st.repeat
    return n["rglru"], n["attn"]


def _leaves(tree):
    """The tensors of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_numel(tree):
    return sum(t.numel() for t in _leaves(tree))


def _weight_bytes(tree) -> int:
    """Bytes of the weights serving reads (deepseek's MTP head is only
    read by ``repro``'s training loss)."""
    if isinstance(tree, dict) and "mtp" in tree:
        tree = {k: v for k, v in tree.items() if k != "mtp"}
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _state_err(caches, ref, row, lm):
    """Max over recurrent blocks (RG-LRU, mLSTM, sLSTM) and their state
    leaves of |state - ref| / max(1, max|ref|) for one batch row of
    ``caches`` against row 0 of ``ref``."""
    worst = 0.0
    for st, c, r in zip(lm.cfg.stages, caches, ref):
        for bi, bdef in enumerate(st.blocks):
            if bdef.mixer not in ("rglru", "mlstm", "slstm"):
                continue
            for key in c[bi]:
                x = c[bi][key][:, row].float()
                y = r[bi][key][:, 0].float()
                scale = max(1.0, y.abs().max().item())
                worst = max(worst, (x - y).abs().max().item() / scale)
    return worst


def check_hybrid_model(torch, dev, seed):
    """recurrentgemma-9b at full width, depth cut to 4 layers, in f32: the
    card's forward (through the kernels) against the CPU plain forward,
    and a right-padded prefill with ``lengths`` against the unpadded
    prefill's recurrent state."""
    from repro_torch.models.model import LM

    cfg = _hybrid_cfg("float32", cut=True)
    cpu = LM(cfg, device="cpu")
    t0 = time.perf_counter()
    cpu_params = cpu.init(seed)
    init_s = time.perf_counter() - t0
    n = _tree_numel(cpu_params)
    print(f"  weight init, CPU generator: {n / 1e9:.3f} B values in "
          f"{init_s:.1f} s ({n / init_s / 1e6:.0f} M/s; the 10.4 B of the "
          f"full depth would take ~{10.4e9 * init_s / n:.0f} s)")
    lm = LM(cfg, device=dev)
    params = _to_device(cpu_params, dev)
    tokens = np.random.default_rng(seed + 8).integers(
        0, cfg.vocab_size, (1, 40)).astype(np.int32)
    tok = torch.from_numpy(tokens).to(dev)
    full, _ = lm.forward(params, {"tokens": tok})
    ref, _ = cpu.forward(cpu_params, {"tokens": tok.cpu()})
    err = (full.cpu() - ref).abs().max().item()
    print(f"  recurrentgemma-9b 4 layers f32: GPU kernels vs CPU plain "
          f"forward max|diff| = {err:.3e} (tol {F32_LOGIT_TOL}; max|logit| "
          f"{ref.abs().max().item():.2f})")
    if not err < F32_LOGIT_TOL:
        raise AssertionError("hybrid GPU forward != CPU plain forward")
    del ref, cpu_params
    # two prompts right-padded to the 64 bucket in one batch, with lengths
    lengths = (3, 37)
    padded = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    for row, length in enumerate(lengths):
        padded[row, :length] = tok[0, :length]
    lp, caches = lm.prefill(params, {"tokens": padded}, cache_width=64,
                            lengths=torch.tensor(lengths, dtype=torch.int32,
                                                 device=dev))
    worst = logit_err = 0.0
    for row, length in enumerate(lengths):
        lu, ref_caches = lm.prefill(params, {"tokens": tok[:, :length]},
                                    cache_width=64)
        worst = max(worst, _state_err(caches, ref_caches, row, lm))
        logit_err = max(logit_err, (lp[row, length - 1] - lu[0, -1])
                        .abs().max().item())
    print(f"  padded prefill with lengths {lengths} vs unpadded: recurrent "
          f"state {worst:.3e} of max(1, |state|) (tol {STATE_TOL}), logits "
          f"at the last real token {logit_err:.3e} (tol {F32_LOGIT_TOL})")
    if not (worst < STATE_TOL and logit_err < F32_LOGIT_TOL):
        raise AssertionError("padded prefill state != unpadded state")
    return dict(layers=cfg.num_layers, init_cpu_s=init_s, init_values=n,
                gpu_vs_cpu_err=err, padded_state_err=worst,
                padded_logit_err=logit_err)


def hybrid_full_depth(torch, dev, seed):
    """recurrentgemma-9b at full width and depth in bf16, weights made on
    the card: prefill then decode equals the full forward."""
    from repro_torch.models.model import LM

    cfg = _hybrid_cfg("bfloat16")
    lm = LM(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init(seed, on_device=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = _tree_numel(params)
    print(f"  weight init on the card (torch.Generator(device='cuda')): "
          f"{n / 1e9:.3f} B values, {2 * n / 1e9:.1f} GB bf16, in "
          f"{init_s:.1f} s")
    tokens = torch.from_numpy(np.random.default_rng(seed + 9).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
    err, scale, _ = _prefill_vs_forward(lm, params, tokens, 24)
    print(f"  recurrentgemma-9b 38 layers bf16: prefill+decode vs forward "
          f"max|diff| = {err:.3e} (tol {HYBRID_LOGIT_TOL}; max|logit| "
          f"{scale:.2f})")
    if not (np.isfinite(scale) and err < HYBRID_LOGIT_TOL):
        raise AssertionError("hybrid prefill+decode != forward (bf16)")
    return lm, params, dict(init_device_s=init_s, init_values=n,
                            prefill_decode_err=err, max_logit=scale)


def _hybrid_trace(seed, vocab):
    """12 prompts: a 2-token one, ~2300 and ~2900 tokens (longer than the
    2048 window), 9 drawn from 3-3000, none a bucket size (a power of
    two); the sixth sampled at 0.8."""
    rng = np.random.default_rng(seed + 14)
    lengths = [2, 2300, 2900]
    while len(lengths) < 12:
        n = int(rng.integers(3, 3001))
        if n & (n - 1):
            lengths.append(n)
    lengths = [lengths[i] for i in rng.permutation(12)]
    return [(rng.integers(0, vocab, n).astype(np.int32),
             0.8 if i == 5 else 0.0) for i, n in enumerate(lengths)]


def check_hybrid_engine(torch, dev, seed, smi, lm, params):
    """recurrentgemma-9b served by the ring ``ServingEngine`` (8 slots,
    max_seq_len 4096: each attention layer's ring is 2048 wide and wraps;
    K = 4; its decode programs captured as CUDA graphs by
    ``warm_compile``): streams against a graphed K = 1 engine's, launches,
    no capture during traffic, and greedy tokens against a teacher-forced
    forward; an eager engine (graphs off) serves the trace first, the A/B's
    other leg."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    reqs = _hybrid_trace(seed, lm.cfg.vocab_size)
    max_new = 32
    kw = dict(batch_slots=8, max_seq_len=4096, seed=seed)
    bound = _weight_bytes(params) / HBM_BYTES_PER_S * 1e3
    warm = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warm._use_graphs = False            # a warm-up: nothing to capture
    _serve(warm, [(r[0][:20], 0.0) for r in reqs[:2]], 4)
    eager = ServingEngine(lm, params, max_decode_steps=4, **kw)
    eager._use_graphs = False
    eager.warm_compile()
    outs = {}
    outs["eager"], wall = _serve(eager, reqs, max_new)
    legs = {"eager": _leg(eager, outs["eager"], wall, bound)}
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warmed = _warm(eng)
    n = _count_programs(eng)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve(eng, reqs, max_new)
    launches = dict(LAUNCHES)
    _no_capture(eng, warmed, "hybrid")
    n_rec, n_attn = _mixer_counts(lm.cfg)
    want = {"rglru_scan": n_rec * n["admits"],
            "flash_attention": n_attn * n["admits"],
            "decode_attention": n_attn * n["steps"],
            "paged_decode_attention": 0, "cascade_gate": 0, **NO_BACKWARD}
    print(f"  launches on the hybrid path: {launches} (expected {want}: "
          f"{n_rec} scans and {n_attn} flash per admission x "
          f"{n['admits']}, {n_attn} per decode step x "
          f"{n['steps']}; programs run {n['runs']})")
    if launches != want or n["steps"] != eng.decode_steps or \
            n["admits"] != eng.admissions:
        raise AssertionError("launch counts do not match the hybrid path")

    one = ServingEngine(lm, params, max_decode_steps=1, **kw)
    _warm(one)
    ref, _ = _serve(one, reqs, max_new)
    for a, b in zip(out, ref):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"hybrid K=4 stream != K=1 stream (request "
                                 f"{a.request_id})")
    print(f"  K=4 streams equal K=1 streams token for token, both graphed "
          f"({sum(len(r.output) for r in out)} tokens; prompt lengths "
          f"{[len(p) for p, _ in reqs]})")

    checked, agree = _greedy_vs_forward(torch, lm, params, out, reqs,
                                        HYBRID_LOGIT_TOL)
    if checked == 0 or agree != checked:
        raise AssertionError("hybrid engine tokens disagree with the model")

    gen = sum(len(r.output) for r in out)
    ttft = sorted(r.ttft_s * 1e3 for r in out)
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    stats = dict(requests=len(out), generated_tokens=gen, wall_s=wall,
                 tokens_per_s=gen / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], decode_ms_per_step=step_ms,
                 decode_ms_per_token=eng.decode_s * 1e3 / gen,
                 decode_steps=eng.decode_steps, admissions=eng.admissions,
                 host_syncs=eng.host_syncs, launches=launches,
                 greedy_checked=checked, decode_bound_ms=bound,
                 prefill_ms=eng.prefill_s * 1e3,
                 warm_compile_s=eng.warm_compile_s, graphs=eng.graphs(),
                 pool_bytes=eng.graph_pool_bytes(),
                 prompt_lengths=[len(p) for p, _ in reqs],
                 streams=[r.output.tolist() for r in out])
    print(f"  hybrid engine [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms"
          f", max {ttft[-1]:.1f} ms; decode {step_ms:.2f} ms per step of 8 "
          f"slots, {stats['decode_ms_per_token']:.2f} ms per token; prefill "
          f"{stats['prefill_ms']:.1f} ms over {eng.admissions} admissions")
    legs["graphed"] = _leg(eng, out, wall, bound)
    outs["graphed"] = out
    stats["ab"] = _ab(torch, "hybrid", smi, lm, params, seed, reqs, legs,
                      outs, HYBRID_LOGIT_TOL)
    stats["admission_ms"] = time_admissions(torch, "hybrid", smi, eng)
    return stats, launches, reqs


def _device_rows(prof):
    """(device us, calls, name) of a profile's device-side events only
    (kernels, copies: an operator's own entry repeats the device time of
    the kernels it launched), most device time first."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(((dev_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    if not rows:
        raise AssertionError("the profiler recorded no device events")
    return rows


def _device_profile(torch, serve, wall_s):
    """Device busy time of ``serve()`` (which returns its wall time), by
    kernel name, from torch.profiler; idle share against the unprofiled
    wall time ``wall_s``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = serve()
        torch.cuda.synchronize()

    rows = _device_rows(prof)
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


def profile_engine(torch, seed, lm, params, reqs, wall_s,
                   max_seq_len=1024):
    """A ring engine's trace (8 slots, K=4) under the profiler."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=max_seq_len,
                        seed=seed, max_decode_steps=4)
    eng.warm_compile()
    return _device_profile(torch, lambda: _serve(eng, reqs, 32)[1], wall_s)


def profile_paged_engine(torch, seed, lm, params, wall_s):
    """The phase-5 trace (paged engine, K=4, contended) under the
    profiler."""
    from repro_torch.serving import ServingEngine

    trace = _paged_trace(seed, lm.cfg.vocab_size)
    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=1024,
                        seed=seed, cache_backend="paged", block_size=16,
                        chunk_tokens=128, prefix_sharing=True,
                        max_decode_steps=4)
    eng.warm_compile()
    return _device_profile(
        torch, lambda: _serve_waves(eng, trace, 32, contended=True)[1],
        wall_s)


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
    eng.warm_compile()

    def serve():
        t0 = time.perf_counter()
        for p, t in reqs:
            eng.submit(p, max_new_tokens=32, temperature=t)
        eng.run()
        return time.perf_counter() - t0

    return _device_profile(torch, serve, stats["wall_s"])


# -- phase 10: the dense hd-128 zoo at full width --------------------------------

def _cut_depth(cfg, layers):
    """``cfg`` with each stage repeated ``layers`` times (one-stage dense
    configs: ``layers`` layers), widths unchanged."""
    return dataclasses.replace(cfg, num_layers=layers, stages=tuple(
        dataclasses.replace(st, repeat=layers) for st in cfg.stages))


ZOO = ("qwen3-4b", "glm4-9b", "starcoder2-7b")
# layers served in phase 10 (full width; None = full depth): glm4-9b and
# starcoder2-7b at a quarter of their depth, so that the whole run, with
# every prefill program captured, stays within its earlier length. Both
# served at full depth (glm4-9b 40 layers, starcoder2-7b 32), every
# program graphed, in the runs PERF.md §6 lists before this cut
ZOO_LAYERS = {"qwen3-4b": None, "glm4-9b": 10, "starcoder2-7b": 8}
# starcoder2-7b's ring serve: max_seq_len, and the range of its four long
# prompts' lengths (past the 4096 window: the ring wraps at install)
STARCODER2_RING = (8192, 4097, 4601)


def _zoo_trace(seed, vocab, lengths, sampled):
    """Prompts of the given lengths, the ``sampled``-th at 0.8."""
    rng = np.random.default_rng(seed + 20)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32),
             0.8 if i == sampled else 0.0) for i, n in enumerate(lengths)]


def check_zoo(torch, dev, seed, smi):
    """qwen3-4b, glm4-9b and starcoder2-7b at full width, bf16, at the
    depths of ``ZOO_LAYERS``, one at a time, weights made on the card from
    ``seed``: prefill then
    decode equals a full forward; then qwen3-4b through phase 4's ring and
    phase 5's paged engine on their traces, glm4-9b through the ring
    engine on 8 requests of 16-480 tokens, starcoder2-7b on 8 of 16-4600
    tokens at max_seq_len 8192 (four longer than its 4096 window, so its
    4096-wide rings wrap). Each decode step is printed beside the weights'
    read time, its bound."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    out = {}
    for name in ZOO:
        t_model = time.perf_counter()
        cfg = get_config(name)
        if ZOO_LAYERS[name] is not None:
            cfg = _cut_depth(cfg, ZOO_LAYERS[name])
        lm = LM(cfg, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        params = lm.init(seed, on_device=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n, wbytes = _tree_numel(params), _weight_bytes(params)
        bound = wbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, hd "
              f"{cfg.resolved_head_dim}: {n / 1e9:.3f} B values, "
              f"{wbytes / 1e9:.2f} GB bf16, made on the card in {init_s:.1f}"
              f" s; weight-read bound per decode step {bound:.2f} ms")
        tokens = torch.from_numpy(np.random.default_rng(seed + 21).integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
        err, scale, _ = _prefill_vs_forward(lm, params, tokens, 24)
        print(f"  {name} bf16: prefill+decode vs forward max|diff| = "
              f"{err:.3e} (tol {BF16_LOGIT_TOL}; max|logit| {scale:.2f})")
        if not (np.isfinite(scale) and err < BF16_LOGIT_TOL):
            raise AssertionError(f"{name}: prefill+decode != forward")
        rec = out[name] = dict(values=n, weight_bytes=wbytes, init_s=init_s,
                               prefill_decode_err=err, max_logit=scale,
                               decode_bound_ms=bound)
        rng = np.random.default_rng(seed + 22)
        if name == "qwen3-4b":
            rec["ring"], _ = check_engine(torch, dev, seed, smi, lm, params,
                                          _trace(seed, cfg.vocab_size),
                                          ab=True)
            rec["paged"], _ = check_paged_engine(torch, dev, seed, smi, lm,
                                                 params)
        elif name == "glm4-9b":
            rec["ring"], _ = check_engine(
                torch, dev, seed, smi, lm, params,
                _zoo_trace(seed, cfg.vocab_size, rng.integers(16, 481, 8), 7))
        else:
            width, lo, hi = STARCODER2_RING
            lengths = list(rng.integers(lo, hi, 4)) + list(
                rng.integers(16, lo, 4))
            rec["ring"], _ = check_engine(
                torch, dev, seed, smi, lm, params,
                _zoo_trace(seed, cfg.vocab_size, lengths, 7),
                max_seq_len=width)
        for kind in ("ring", "paged"):
            if kind in rec:
                print(f"  {name} {kind}: decode "
                      f"{rec[kind]['decode_ms_per_step']:.2f} ms per step of "
                      f"8 slots against the {bound:.2f} ms weight-read bound "
                      f"({rec[kind]['decode_ms_per_step'] / bound:.1f}x)")
        rec["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        rec["seconds"] = time.perf_counter() - t_model
        print(f"  {name}: peak device memory {rec['peak_gb']:.1f} GB above "
              f"the {held / 1e9:.1f} GB held before it; "
              f"{rec['seconds']:.1f} s")
        del lm, params
        gc.collect()            # engines that patched a bound method form cycles
        torch.cuda.empty_cache()
    return out


# -- phase 11: the drain-batch baseline --------------------------------------------

def check_baseline(torch, dev, seed, smi, lm, params):
    """Phase 4's trace through ``DrainBatchEngine`` and the K = 4 ring
    ``ServingEngine`` in turns (drain, continuous, continuous, drain): each
    engine gives equal streams on its two runs; greedy streams of the two
    engines are equal, or part first at a near-tie (top-2 margin within
    BF16_LOGIT_TOL) of a teacher-forced forward: their prefills run other
    shapes, so bf16 roundings differ; the drain engine prefills each batch
    through flash and decodes through the ring kernel, one host sync a
    token. Both engines are graphed; the drain's first batch then runs
    again on an eager drain engine (graphs off), its streams held to the
    graphed ones likewise."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import DrainBatchEngine, ServingEngine

    reqs = _trace(seed, lm.cfg.vocab_size)
    n_layers = lm.cfg.num_layers
    runs = {"drain": [], "continuous": []}
    outs = {}
    for kind in ("drain", "continuous", "continuous", "drain"):
        kw = dict(batch_slots=8, max_seq_len=1024, seed=seed)
        eng = (DrainBatchEngine(lm, params, **kw) if kind == "drain" else
               ServingEngine(lm, params, max_decode_steps=4, **kw))
        warmed = _warm(eng)     # both engines graphed
        torch.cuda.synchronize()
        reset_launches()
        out, wall = _serve(eng, reqs, 32)
        launches = dict(LAUNCHES)
        _no_capture(eng, warmed, kind)
        gen = sum(len(r.output) for r in out)
        if kind == "drain":
            batches = -(-len(reqs) // eng.batch_slots)
            want = {"flash_attention": n_layers * batches,
                    "decode_attention": n_layers * eng.host_syncs,
                    "paged_decode_attention": 0, "cascade_gate": 0,
                    "rglru_scan": 0, **NO_BACKWARD}
            if launches != want:
                raise AssertionError(f"drain launches {launches} != {want}")
        if kind in outs:
            for a, b in zip(outs[kind], out):
                if not np.array_equal(a.output, b.output):
                    raise AssertionError(f"{kind}: two runs differ (request "
                                         f"{a.request_id})")
        outs[kind] = out
        runs[kind].append(dict(wall_s=wall, tokens_per_s=gen / wall,
                               host_syncs=eng.host_syncs,
                               host_syncs_per_token=eng.host_syncs / gen,
                               launches=launches))
        print(f"  {kind} [{smi}]: {gen} tokens in {wall:.3f} s = "
              f"{gen / wall:.1f} tokens/s; {eng.host_syncs} host syncs "
              f"({eng.host_syncs / gen:.4f} a token); launches {launches}")
    def greedy_parts(label, ours, theirs, trace):
        """Greedy streams equal, or parted first at a near-tie of a
        teacher-forced forward; sampled ones equal."""
        equal = parted = 0
        for r, c, (prompt, temp) in zip(ours, theirs, trace):
            diff = np.flatnonzero(r.output != c.output)
            if not len(diff):
                equal += 1
                continue
            if temp > 0:
                raise AssertionError(f"{label}: sampled request "
                                     f"{r.request_id} differs")
            ctx = torch.from_numpy(np.concatenate(
                [prompt, c.output[:diff[0]]]).astype(np.int32))[None].to(dev)
            last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
            top2 = torch.topk(last[0, 0].float(), 2).values
            margin = (top2[0] - top2[1]).item()
            print(f"  {label}, request {r.request_id}: the streams part at "
                  f"token {diff[0]}, top-2 margin {margin:.4f}")
            if margin > BF16_LOGIT_TOL:
                raise AssertionError(f"{label}: request {r.request_id} "
                                     f"differs off a near-tie")
            parted += 1
        print(f"  {label}: {equal} streams equal token for token, {parted} "
              f"part first at a near-tie (margin <= {BF16_LOGIT_TOL})")
        if equal == 0:
            raise AssertionError(f"{label}: no stream equal")
        return equal, parted

    greedy = [i for i, (_, t) in enumerate(reqs) if t == 0]
    equal, parted = greedy_parts(
        "greedy streams, drain against continuous",
        [outs["drain"][i] for i in greedy],
        [outs["continuous"][i] for i in greedy], [reqs[i] for i in greedy])
    # the first batch again through an eager drain engine (graphs off)
    eager = DrainBatchEngine(lm, params, batch_slots=8, max_seq_len=1024,
                             seed=seed)
    eager._use_graphs = False
    first, _ = _serve(eager, reqs[:8], 32)
    eager_equal, _ = greedy_parts("the drain's first batch, graphed against "
                                  "eager", outs["drain"][:8], first, reqs[:8])
    drain = statistics.mean(x["tokens_per_s"] for x in runs["drain"])
    cont = statistics.mean(x["tokens_per_s"] for x in runs["continuous"])
    print(f"  continuous / drain tokens/s, both graphed [{smi}]: "
          f"{cont:.1f} / {drain:.1f} = "
          f"{cont / drain:.2f}x; drain host syncs per token "
          f"{runs['drain'][0]['host_syncs_per_token']:.4f}, continuous "
          f"{runs['continuous'][0]['host_syncs_per_token']:.4f}")
    return dict(runs=runs, ratio=cont / drain, greedy_equal=equal,
                greedy_parted_at_near_tie=parted,
                drain_graphed_equals_eager=eager_equal)


# -- phase 13: speculative decoding -------------------------------------------

SPEC_K = 4
# qwen3-4b's depth on phase 13's paged leg (phase 10 serves the paged
# engine at full depth): the run's length, with every chunk captured
SPEC_PAGED_LAYERS = 12


def _count_programs(eng):
    """Wrap ``eng``'s program runner with counters: plain decode steps (a
    K-step program, graph replay or eager call, adds K), speculative
    rounds and their draft steps (k + 1 a round), admissions, prompt
    chunks and draft fills, and runs by decode program (horizon or depth,
    greedy or sampled), from which each kernel's launches follow."""
    n = dict(steps=0, rounds=0, draft_steps=0, admits=0, fills=0, chunks=0,
             runs={})
    run = eng._run_program

    def counted_run(key):
        kind = key[0]
        if kind == "decode":
            n["steps"] += key[1]
        elif kind == "spec":
            n["rounds"] += 1
            n["draft_steps"] += key[1] + 1
        else:
            n[{"admit": "admits", "chunk": "chunks",
               "draft_fill": "fills"}[kind]] += 1
            return run(key)
        name = f"{kind} {key[1]}{' sampled' if key[2] else ''}"
        n["runs"][name] = n["runs"].get(name, 0) + 1
        return run(key)

    eng._run_program = counted_run
    return n


def _spec_launches(eng, n):
    """Each kernel's launches from the counted programs: the target's
    layers once per plain step, verify chunk and prompt chunk (its
    backend's kernel) or per monolithic admission (flash); the draft's
    layers once per draft step (its ring) and per fill (flash)."""
    lt = eng.lm.cfg.num_layers
    ld = eng.draft_lm.cfg.num_layers if eng.speculative else 0
    target = lt * (n["steps"] + n["rounds"] + n["chunks"])
    paged = eng.backend.supports_swap
    return {"flash_attention": ld * n["fills"] + lt * n["admits"],
            "decode_attention": ld * n["draft_steps"] + (
                0 if paged else target),
            "paged_decode_attention": target if paged else 0,
            "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}


def _parted_at_near_tie(torch, lm, params, seed, reqs, out, base, tol):
    """Each stream of ``out`` equals ``base``'s, or parts first where the
    teacher-forced forward's top-2 margin is within ``tol``: of the logits
    for a greedy request, of logits / T plus that step's Gumbel noise (the
    request's keyed draw, reproducible) within ``tol / T`` for a sampled
    one. A verify chunk's bf16 logits are not bit-equal to a T = 1 step's.
    Returns (equal, parted)."""
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys

    equal = parted = 0
    for a, b, (prompt, temp) in zip(out, base, reqs):
        diff = np.flatnonzero(a.output != b.output)
        if len(a.output) == len(b.output) and not len(diff):
            equal += 1
            continue
        p = int(diff[0]) if len(diff) else min(len(a.output), len(b.output))
        ctx = torch.from_numpy(np.concatenate([prompt, b.output[:p]])
                               .astype(np.int32))[None].to(lm.device)
        last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        x, t = last[0, 0].float(), tol
        if temp > 0:
            i32 = dict(dtype=torch.int32, device=lm.device)
            key = request_keys(prng_key(seed, device=lm.device),
                               torch.tensor([b.request_id], **i32),
                               torch.tensor([p], **i32))
            x = x / temp + gumbel(key, x.shape)[0]
            t = tol / temp
        top2 = torch.topk(x, 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"    request {b.request_id} (T={temp}): parts from the "
              f"baseline at token {p}, top-2 margin {margin:.4f} (tol "
              f"{t:.4f})")
        if margin > t:
            raise AssertionError(f"speculative stream != baseline (request "
                                 f"{b.request_id}, token {p})")
        parted += 1
    return equal, parted


def _spec_serve(torch, eng, serve):
    """``warm_compile``, then serve with the device programs counted and
    the launch counters reset, no graph captured during traffic:
    (requests, wall s, program counts, launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    warmed = _warm(eng)
    n = _count_programs(eng)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = serve(eng)
    torch.cuda.synchronize()
    _no_capture(eng, warmed, eng.lm.cfg.name)
    return out, wall, n, dict(LAUNCHES)


def _spec_report(label, smi, eng, out, wall, n, launches, want):
    """Print one engine's line (tokens/s, ms per committed token, the
    speculative counters) and check its launches; returns its record."""
    gen = sum(len(r.output) for r in out)
    m = eng.speculative_metrics()
    print(f"  {label} [{smi}]: {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s, {wall * 1e3 / gen:.2f} ms per "
          f"committed token; {n['steps']} plain steps, {m['rounds']} "
          f"speculative rounds, acceptance {m['acceptance_rate']:.3f}, "
          f"{m['committed_per_dispatch']:.2f} committed a slot-dispatch; "
          f"host syncs {eng.host_syncs}")
    print(f"    launches {launches} (expected {want}, from {n})")
    if launches != want:
        raise AssertionError(f"{label}: launch counts do not match the path")
    return dict(tokens=gen, wall_s=wall, tokens_per_s=gen / wall,
                ms_per_token=wall * 1e3 / gen, host_syncs=eng.host_syncs,
                programs=n, launches=launches, speculative=m)


def _spec_check_streams(torch, label, lm, params, seed, reqs, out, base):
    equal, parted = _parted_at_near_tie(torch, lm, params, seed, reqs, out,
                                        base, BF16_LOGIT_TOL)
    print(f"    {label}: {equal} streams equal the baseline's, {parted} part "
          f"first at a near-tie (margin <= {BF16_LOGIT_TOL})")
    if equal == 0:
        raise AssertionError(f"{label}: no stream equals the baseline")
    return dict(equal=equal, parted=parted)


def _spec_ring_leg(torch, dev, seed, smi, lm, params, draft, dparams):
    """qwen3-4b on the ring: phase 4's trace (18 requests, 32 new tokens
    each, two sampled at 0.8) at K = 1 with no draft (the baseline), with
    the 4-layer edge draft at k = 4 forced on (``spec_min_commit`` 0) and
    under the default ``spec_min_commit`` (the acceptance EWMA suppresses
    drafting and probes)."""
    from repro_torch.serving import ServingEngine

    reqs = _trace(seed, lm.cfg.vocab_size)
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed)
    spec = dict(draft_model=draft, draft_params=dparams,
                speculative_tokens=SPEC_K)

    def serve(eng):
        return _serve(eng, reqs, 32)

    rec = {}
    for label, extra, force in (("baseline", {}, False),
                                ("forced", spec, True),
                                ("default", spec, False)):
        eng = ServingEngine(lm, params, **kw, **extra)
        if force:
            eng.scheduler.spec_min_commit = 0.0
        out, wall, n, launches = _spec_serve(torch, eng, serve)
        rec[label] = _spec_report(f"qwen3-4b ring, {label}", smi, eng, out,
                                  wall, n, launches, _spec_launches(eng, n))
        rec[label].update(suppressed_plans=eng.scheduler._spec_suppressed,
                          acceptance_ewma=eng.scheduler.speculative_acceptance()
                          or 0.0,
                          spec_min_commit=eng.scheduler.spec_min_commit)
        if label == "baseline":
            base = out
        else:
            rec[label]["streams"] = _spec_check_streams(
                torch, label, lm, params, seed, reqs, out, base)
    default = rec["default"]
    ewma = default["acceptance_ewma"]
    print(f"    default spec_min_commit ({default['spec_min_commit']}): "
          f"acceptance EWMA {ewma:.3f} accepted a slot-round, "
          f"{default['suppressed_plans']} plans suppressed, "
          f"{default['programs']['rounds']} speculative rounds")
    if rec["forced"]["speculative"]["rounds"] == 0 or \
            default["programs"]["rounds"] == 0:
        raise AssertionError("qwen3-4b ring: an engine with a draft never "
                             "drafted")
    if 1.0 + ewma < default["spec_min_commit"] and \
            not default["suppressed_plans"]:
        raise AssertionError("qwen3-4b ring: the EWMA is below "
                             "spec_min_commit and nothing was suppressed")
    return rec


def _spec_paged_leg(torch, dev, seed, smi, lm, params, draft, dparams):
    """qwen3-4b on the paged backend: phase 5's two waves (128-token
    chunks, prefix sharing, swap preemption) at K = 1 with no draft, and
    with the edge draft at k = 4 forced on."""
    from repro_torch.serving import ServingEngine

    trace = _paged_trace(seed, lm.cfg.vocab_size)
    wave1, hi, wave2 = trace
    reqs = wave1 + hi + wave2
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed,
              cache_backend="paged", block_size=16, chunk_tokens=128,
              prefix_sharing=True)

    def serve(eng):
        return _serve_waves(eng, trace, 32, contended=True)

    rec = {}
    for label, extra in (("baseline", {}),
                         ("forced", dict(draft_model=draft,
                                         draft_params=dparams,
                                         speculative_tokens=SPEC_K))):
        eng = ServingEngine(lm, params, **kw, **extra)
        if extra:
            eng.scheduler.spec_min_commit = 0.0
        out, wall, n, launches = _spec_serve(torch, eng, serve)
        rec[label] = _spec_report(f"qwen3-4b paged, {label}", smi, eng, out,
                                  wall, n, launches, _spec_launches(eng, n))
        rec[label]["preemptions"] = eng.preemptions
        if label == "baseline":
            base = out
        else:
            rec[label]["streams"] = _spec_check_streams(
                torch, label, lm, params, seed, reqs, out, base)
            if rec[label]["speculative"]["rounds"] == 0:
                raise AssertionError("qwen3-4b paged: no speculative round")
    return rec


def _spec_self_leg(torch, dev, seed, smi, lm, params):
    """smollm-135m drafting for itself on the ring, phase 4's trace: every
    proposal is the baseline's token, so every one is accepted and each
    dispatch commits k + 1 tokens a slot (k clamped to the budget). A
    rejection may only sit at a near-tie of the teacher-forced logits (the
    draft's T = 1 logits and the verify chunk's round apart in bf16)."""
    from repro_torch.serving import ServingEngine

    reqs = _trace(seed, lm.cfg.vocab_size)
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed)

    def serve(eng):
        return _serve(eng, reqs, 32)

    plain = ServingEngine(lm, params, **kw)
    base, wall, n, launches = _spec_serve(torch, plain, serve)
    rec = {"baseline": _spec_report("smollm-135m ring, baseline", smi, plain,
                                    base, wall, n, launches,
                                    _spec_launches(plain, n))}
    eng = ServingEngine(lm, params, draft_model=lm, draft_params=params,
                        speculative_tokens=SPEC_K, **kw)
    rounds = []
    run = eng._run_program

    def spy(key):                           # what locates a rejection
        if key[0] != "spec":
            return run(key)
        st = eng._state
        rid, steps, active = (st["rid"].clone(), st["steps"].clone(),
                              st["active"].clone())
        run(key)
        # a round commits the anchor and the accepted prefix j (no EOS, and
        # the scheduler keeps k below every slot's headroom)
        rounds.append((rid, steps, active, st["steps"] - steps - 1, key[1]))

    eng._run_program = spy
    out, wall, n, launches = _spec_serve(torch, eng, serve)
    rec["self"] = _spec_report("smollm-135m ring, self-draft", smi, eng, out,
                               wall, n, launches, _spec_launches(eng, n))
    rec["self"]["streams"] = _spec_check_streams(
        torch, "self-draft", lm, params, seed, reqs, out, base)
    m = rec["self"]["speculative"]
    by_rid = {r.request_id: (p, r) for (p, _), r in zip(reqs, base)}
    rejected = []
    for rid, steps, active, j, k in rounds:
        for row in np.flatnonzero((active & (j < k)).cpu().numpy()):
            rejected.append((int(rid[row]), int(steps[row] + j[row] + 1)))
    for rid, p in rejected:
        prompt, r = by_rid[rid]
        ctx = torch.from_numpy(np.concatenate([prompt, r.output[:p]])
                               .astype(np.int32))[None].to(dev)
        last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        top2 = torch.topk(last[0, 0].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"    request {rid}: a proposal rejected at token {p}, top-2 "
              f"margin {margin:.4f}")
        if margin > BF16_LOGIT_TOL:
            raise AssertionError("self-draft rejected a proposal off a "
                                 "near-tie")
    print(f"    self-draft: {m['accepted_tokens']} of {m['drafted_tokens']} "
          f"proposals accepted ({len(rejected)} rejected, each at a "
          f"near-tie); committed {m['committed_tokens']} = slot-rounds "
          f"{m['slot_rounds']} + accepted")
    unaccepted = m["drafted_tokens"] - m["accepted_tokens"]
    if m["rounds"] == 0 or m["committed_tokens"] != \
            m["slot_rounds"] + m["accepted_tokens"] or \
            unaccepted < len(rejected) or (unaccepted > 0) != bool(rejected):
        raise AssertionError("self-draft accounting is off")
    rec["self"]["rejected_at_near_ties"] = len(rejected)
    return rec


def _spec_cascade_leg(torch, dev, seed, smi, models):
    """Phase 7's cascade (smollm-135m cloud, 4-layer edge) with thresholds
    that escalate every prompt (hi 2.0, lo 0.0), without and with
    ``speculative_tokens=4`` (forced on): the edge model drafts for the
    cloud engine. 24 requests of 16-480 tokens, 32 new each, the first
    two sampled at 0.8."""
    from repro_torch.cascade import CascadeLM
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import CascadeServingEngine

    edge, cloud, ep, cp = models
    prompts = _cascade_prompts(seed, cloud.cfg.vocab_size)
    reqs = [(p, 0.8 if i < 2 else 0.0) for i, p in enumerate(prompts)]
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(hi=2.0, lo=0.0))
    el, rec, outs = edge.cfg.num_layers, {}, {}
    for label, k in (("baseline", 0), ("speculative", SPEC_K)):
        eng = CascadeServingEngine(cas, ep, cp, seed=seed, batch_slots=8,
                                   max_seq_len=1024, max_decode_steps=4,
                                   speculative_tokens=k)
        ce = eng.cloud_engine
        ce.scheduler.spec_min_commit = 0.0
        warmed = _warm(eng)
        n = _count_programs(ce)
        torch.cuda.synchronize()
        reset_launches()
        out, wall = _serve(eng, reqs, 32)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        _no_capture(eng, warmed, f"cascade, {label}")
        if any(r.route != "escalate" for r in out):
            raise AssertionError("a cascade request was not escalated")
        want = _spec_launches(ce, n)
        want["cascade_gate"] = len(reqs)
        want["flash_attention"] += el * len(reqs)
        rec[label] = _spec_report(f"cascade, {label}", smi, ce, out, wall,
                                  n, launches, want)
        outs[label] = out
    # the cloud engine samples with seed + 1, and its request ids follow the
    # gate order, which is the submission order: the cascade's ids
    rec["speculative"]["streams"] = _spec_check_streams(
        torch, "cascade", cloud, cp, seed + 1, reqs, outs["speculative"],
        outs["baseline"])
    if rec["speculative"]["speculative"]["rounds"] == 0:
        raise AssertionError("the cascade's cloud engine never drafted")
    return rec


def check_speculative(torch, dev, seed, smi, smollm, models):
    """Phase 13: speculative decoding on the card, four legs (qwen3-4b at
    full width with its 4-layer edge draft, at full depth on the ring and
    at ``SPEC_PAGED_LAYERS`` on the paged backend, smollm-135m drafting for
    itself, and the cascade's edge drafting for its cloud). Random weights
    make acceptance meaningless as
    a speed figure: with a tied table both models mostly echo their input
    token, so a random draft agrees with its target far more often than
    a trained one would."""
    from repro_torch.cascade import edge_variant
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = get_config("qwen3-4b")
    lm = LM(cfg, device=dev)
    params = lm.init(seed, on_device=True)
    draft = LM(edge_variant(cfg, layers=4), device=dev)
    dparams = draft.init(seed + 1, on_device=True)
    dc = draft.cfg
    print(f"  qwen3-4b target ({cfg.num_layers} layers), its draft "
          f"edge_variant(layers=4): {dc.num_layers} layers, d_model "
          f"{dc.d_model}, {dc.num_heads} heads over {dc.num_kv_heads}, hd "
          f"{dc.resolved_head_dim}, vocab {dc.padded_vocab}; k = {SPEC_K}. "
          f"Random weights: acceptance and tokens/s here say nothing of a "
          f"trained draft's speed")
    out = {"qwen3-4b ring": _spec_ring_leg(torch, dev, seed, smi, lm, params,
                                           draft, dparams)}
    del lm, params
    gc.collect()
    lm = LM(_cut_depth(cfg, SPEC_PAGED_LAYERS), device=dev)
    params = lm.init(seed, on_device=True)
    print(f"  qwen3-4b paged leg: {SPEC_PAGED_LAYERS} of its "
          f"{cfg.num_layers} layers, full width")
    out["qwen3-4b paged"] = _spec_paged_leg(torch, dev, seed, smi, lm,
                                            params, draft, dparams)
    del lm, params, draft, dparams
    gc.collect()
    torch.cuda.empty_cache()
    out["smollm-135m self-draft"] = _spec_self_leg(torch, dev, seed, smi,
                                                   *smollm)
    out["cascade"] = _spec_cascade_leg(torch, dev, seed, smi, models)
    return out


# -- phase 14: faults, durability and the gateway -------------------------------

# the watchdog on the card: a step's deadline far above smollm-135m's
# longest step (a round of admissions plus a K = 4 round, ~0.1 s), the
# grace window, and the stalls that the hang seam injects: a hang ends
# inside the grace window (rolled back in process), a wedge outlasts it
STEP_TIMEOUT_S = 1.0
HANG_GRACE = 1.0
WEDGE_GRACE = 0.5


def _as_requests(streams):
    """Stored streams (lists) as request stand-ins for the near-tie rule."""
    return [types.SimpleNamespace(request_id=i, output=np.asarray(x,
                                                                  np.int32))
            for i, x in enumerate(streams)]


def _quiet(fn, *args):
    """``fn(*args)`` with the launch counters left as they were: a
    warm-up's eager runs and a teacher-forced comparison are not the main
    path."""
    import torch

    from repro_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    try:
        return fn(*args)
    finally:
        LAUNCHES.update(before)


def _hold_streams(torch, label, lm, params, seed, reqs, got, base,
                  skip=()):
    return _quiet(_hold, torch, label, lm, params, seed, reqs, got, base,
                  skip)


def _hold(torch, label, lm, params, seed, reqs, got, base, skip):
    """Hold the streams ``got`` (rid -> tokens) of a trace to ``base`` (the
    fault-free graphed run's, in rid order): equal, or parted first at a
    near-tie of the teacher-forced forward (a recompute-resume rebuilds the
    K/V through the prefill GEMMs, not the decode ones). Requests in
    ``skip`` (cancelled ones) are left out. Returns (equal, parted)."""
    ids = [i for i in range(len(base)) if i not in skip]
    if sorted(got) != sorted(ids):
        raise AssertionError(f"{label}: requests {sorted(set(ids) - set(got))}"
                             f" never finished")
    out = [types.SimpleNamespace(request_id=i, output=np.asarray(
        got[i], np.int32)) for i in ids]
    ref = [_as_requests(base)[i] for i in ids]
    equal, parted = _parted_at_near_tie(torch, lm, params, seed,
                                        [reqs[i] for i in ids], out, ref,
                                        BF16_LOGIT_TOL)
    print(f"    {label}: {equal} streams equal the fault-free graphed run's,"
          f" {parted} part first at a near-tie (margin <= {BF16_LOGIT_TOL})")
    if equal == 0:
        raise AssertionError(f"{label}: no stream equals the fault-free run")
    return dict(equal=equal, parted=parted)


def _counted(eng, wants):
    """Count ``eng``'s programs (a cascade: its legs' and its gates) and
    register the launches they imply with ``wants``, read at the end of
    the phase."""
    if hasattr(eng, "cloud_engine"):
        legs = [(leg, _count_programs(leg))
                for leg in (eng.edge_engine, eng.cloud_engine)]
        gated = [0]
        gate = eng._gate

        def counted_gate(prompt):
            gated[0] += 1
            return gate(prompt)

        eng._gate = counted_gate

        def want():
            w = _sum_launches([_spec_launches(leg, n) for leg, n in legs])
            w["cascade_gate"] += gated[0]
            w["flash_attention"] += eng.cascade.edge.cfg.num_layers * gated[0]
            return w

        wants.append(want)
        return legs
    n = _count_programs(eng)
    wants.append(lambda: _spec_launches(eng, n))
    return n


def _sum_launches(ws):
    total = {k: 0 for k in ("flash_attention", "decode_attention",
                            "paged_decode_attention", "cascade_gate",
                            "rglru_scan", *NO_BACKWARD)}
    for w in ws:
        for k, v in w.items():
            total[k] += v
    return total


def _recovery_line(label, smi, m):
    rec = m["recovery"]
    print(f"  {label} [{smi}]: faults {m['faults_injected']}; recoveries "
          f"{m['fault_recoveries']}, retries {m['retries_total']}, "
          f"quarantined {m['quarantined']}, fallbacks "
          f"{m['speculative']['fallbacks']}; recovery (fault -> re-grant) "
          f"p50 {rec['p50_s'] * 1e3:.2f} ms, p99 {rec['p99_s'] * 1e3:.2f} ms "
          f"over {rec['count']}")


def _chaos(torch, seed, smi, lm, params, reqs, ring_base, paged_base, wants):
    """14(a): phase 5's waves on the paged engine (swap preemption, K = 4)
    under a plan that fires step, scan, swap_out, swap_in, pool and cancel;
    phase 4's trace on the self-draft ring engine (k = 4) with half its
    draft rounds failing. Survivors against the fault-free graphed runs,
    the allocator after the drain, no capture in traffic."""
    from repro_torch.serving import FaultPlan, ServingEngine

    rec = {}
    trace = _paged_trace(seed, lm.cfg.vocab_size)
    plan = FaultPlan(seed=seed, step=[1], scan=[2], swap_out=[0, 2],
                     swap_in=[0], pool=[3], cancel=[5])
    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=1024,
                        seed=seed, cache_backend="paged", block_size=16,
                        chunk_tokens=128, prefix_sharing=True,
                        max_decode_steps=4, fault_plan=plan, max_retries=8)
    warmed = _quiet(_warm, eng)
    _counted(eng, wants)
    out, wall = _serve_waves(eng, trace, 32, contended=True, strict=False)
    torch.cuda.synchronize()
    _no_capture(eng, warmed, "chaos paged")
    fired = plan.fired()
    missing = [s for s in ("step", "scan", "swap_out", "swap_in", "pool",
                           "cancel") if not fired.get(s)]
    if missing:
        raise AssertionError(f"chaos paged: seams {missing} never fired")
    be = eng.backend
    eng.assert_invariants()
    if be._gap_total or be._ref or sorted(eng._free) != list(range(8)):
        raise AssertionError("chaos paged: the drain left blocks or slots")
    statuses = {r.request_id: r.status for r in out}
    cancelled = {i for i, st in statuses.items() if st == "cancelled"}
    if set(statuses.values()) - {"done", "cancelled"} or len(cancelled) != 1:
        raise AssertionError(f"chaos paged: statuses {statuses}")
    wave1, hi, wave2 = trace
    m = eng.metrics()
    _recovery_line("chaos, paged", smi, m)
    rec["paged"] = dict(
        metrics={k: m[k] for k in ("faults_injected", "fault_recoveries",
                                   "retries_total", "quarantined",
                                   "recovery", "preemptions")},
        wall_s=wall, swap_outs=be.swap_outs, swap_ins=be.swap_ins,
        streams=_hold_streams(
            torch, "chaos, paged", lm, params, seed, wave1 + hi + wave2,
            {r.request_id: r.output for r in out if r.status == "done"},
            paged_base, skip=cancelled))
    paged = eng

    plan = FaultPlan(seed=seed, draft={"prob": 0.5})
    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=1024,
                        seed=seed, draft_model=lm, draft_params=params,
                        speculative_tokens=SPEC_K, fault_plan=plan)
    eng.scheduler.spec_min_commit = 0.0
    warmed = _quiet(_warm, eng)
    _counted(eng, wants)
    out, wall = _serve(eng, reqs, 32)
    torch.cuda.synchronize()
    _no_capture(eng, warmed, "chaos draft")
    m = eng.metrics()
    if not (eng.spec_fallbacks and eng.spec_rounds) or \
            m["faults_injected"].get("draft") != eng.spec_fallbacks:
        raise AssertionError("chaos draft: no fallback, or no round")
    _recovery_line("chaos, self-draft ring", smi, m)
    rec["draft"] = dict(
        fallbacks=eng.spec_fallbacks, spec_rounds=eng.spec_rounds,
        wall_s=wall, streams=_hold_streams(
            torch, "chaos, self-draft ring", lm, params, seed, reqs,
            {r.request_id: r.output for r in out}, ring_base))
    return rec, paged


def _reused(eng):
    """A warmed engine of an earlier leg, drained, as a cold one: no fault
    plan, no tap, request ids from 0 again (so the sampled streams' keys
    are the fault-free run's)."""
    if eng.pending or eng._done:
        raise AssertionError("a reused engine must be drained")
    eng._faults, eng.on_tokens, eng._next_id = None, None, 0
    return eng


def _snapshot_leg(torch, label, smi, lm, params, seed, eng1, build,
                  trace_reqs, base, serve_some, serve_rest, state_dir):
    """14(b) for one backend: ``serve_some`` drives the warmed, drained
    engine ``eng1`` part of the way; its snapshot is saved; a fresh engine
    is built and warmed, loads the snapshot, restores it and finishes
    (``serve_rest``). Times every stage; streams against the uninterrupted
    run."""
    from repro_torch.serving import load_snapshot, save_snapshot

    serve_some(_reused(eng1))
    live = len(eng1._slots)
    t0 = time.perf_counter()
    snap = eng1.snapshot()
    snap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = save_snapshot(state_dir, snap, step=1)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    del eng1, snap
    gc.collect()
    torch.cuda.synchronize()
    restart = time.perf_counter()
    eng2 = build()
    first = []
    eng2.on_tokens = lambda ev: first or first.append(time.perf_counter())
    t0 = time.perf_counter()
    warmed = _quiet(_warm, eng2)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, _ = load_snapshot(state_dir)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = eng2.restore(loaded)
    restore_s = time.perf_counter() - t0
    got = serve_rest(eng2)
    torch.cuda.synchronize()
    _no_capture(eng2, warmed, f"{label} restored")
    rec = dict(live_slots=live, snapshot_ms=snap_s * 1e3,
               snapshot_bytes=nbytes, save_ms=save_s * 1e3,
               load_ms=load_s * 1e3, restore_ms=restore_s * 1e3,
               warm_compile_s=warm_s,
               restart_to_first_token_ms=(first[0] - restart) * 1e3,
               restored=info, swap_ins=getattr(eng2.backend, "swap_ins", 0))
    print(f"  snapshot/restore, {label} [{smi}]: {live} slots decoding; "
          f"snapshot {rec['snapshot_ms']:.1f} ms, {nbytes / 1e6:.1f} MB; "
          f"save {rec['save_ms']:.1f} ms, load {rec['load_ms']:.1f} ms, "
          f"restore {rec['restore_ms']:.2f} ms; the fresh engine's "
          f"warm_compile {warm_s:.2f} s; restart -> first token "
          f"{rec['restart_to_first_token_ms']:.0f} ms; restored {info}, "
          f"swap-ins {rec['swap_ins']}")
    rec["streams"] = _hold_streams(torch, f"restored {label}", lm, params,
                                   seed, trace_reqs, got, base)
    return rec, eng2


def _durability(torch, seed, smi, lm, params, reqs, ring_base, paged_base,
                wants, state_dir, ring_eng, paged_eng):
    """14(b): ring (recompute) and paged (with K/V) snapshot mid-flight,
    then restore into a fresh warmed engine. The engines snapshotted are
    earlier legs' (the wedge's recovered ring engine, the paged chaos
    engine), drained."""
    from repro_torch.serving import ServingEngine

    rec = {}
    ring_kw = dict(batch_slots=8, max_seq_len=1024, seed=seed,
                   max_decode_steps=4)

    def ring_some(eng):
        for p, t in reqs:
            eng.submit(p, max_new_tokens=32, temperature=t)
        for _ in range(6):
            eng.step()

    def ring_build():
        eng = ServingEngine(lm, params, **ring_kw)
        _counted(eng, wants)
        return eng

    def drain(eng):
        return {rid: r.output for rid, r in eng.run().items()}

    rec["ring"], _ = _snapshot_leg(
        torch, "ring", smi, lm, params, seed, ring_eng, ring_build, reqs,
        ring_base, ring_some, drain, os.path.join(state_dir, "ring"))

    trace = _paged_trace(seed, lm.cfg.vocab_size)
    wave1, hi, wave2 = trace
    paged_kw = dict(batch_slots=8, max_seq_len=1024, seed=seed,
                    cache_backend="paged", block_size=16, chunk_tokens=128,
                    prefix_sharing=True, max_decode_steps=4)

    def paged_build():
        eng = ServingEngine(lm, params, **paged_kw)
        _counted(eng, wants)
        return eng

    def paged_some(eng):
        for p, t in wave1:
            eng.submit(p, max_new_tokens=32, temperature=t)
        for _ in range(1000):
            if len(eng._slots) == 8:
                break
            eng.step()
        for p, t in hi:
            eng.submit(p, max_new_tokens=32, temperature=t, priority=1)
        for _ in range(3):
            eng.step()

    def paged_rest(eng):
        got = drain(eng)
        eng.assert_invariants()
        for p, t in wave2:
            eng.submit(p, max_new_tokens=32, temperature=t)
        got.update(drain(eng))
        eng.assert_invariants()
        return got

    rec["paged"], eng = _snapshot_leg(
        torch, "paged", smi, lm, params, seed, paged_eng, paged_build,
        wave1 + hi + wave2, paged_base, paged_some, paged_rest,
        os.path.join(state_dir, "paged"))
    if not rec["paged"]["swap_ins"]:
        raise AssertionError("restored paged: no K/V came back by swap-in")
    return rec


async def _gw_serve(gw, reqs, rate, rng):
    """Open-loop clients at ``rate`` req/s (exponential gaps), each
    streaming its tokens: {rid: (request, streamed tokens)}, and the
    arrivals' span in s."""
    import asyncio

    out = {}

    async def client(p, t):
        h = await gw.submit(p, max_new_tokens=32, temperature=t)
        toks = [x async for x in h.stream()]
        r = await h.result()
        out[r.request_id] = (r, np.asarray(toks, np.int32))

    tasks, t0 = [], time.perf_counter()
    for p, t in reqs:
        tasks.append(asyncio.ensure_future(client(p, t)))
        await asyncio.sleep(float(rng.exponential(1.0 / rate)))
    span = time.perf_counter() - t0
    await asyncio.gather(*tasks)
    return out, span


def _gateway(torch, seed, smi, lm, params, reqs, ring_base, ring_stats,
             wants, state_dir):
    """14(c): phase 4's trace through ``ServingGateway`` on a warmed ring
    engine, open loop; then a hang (recovered in process through
    ``note_hang``) and a wedge (``EngineWedgedError``, then
    ``recover_engine`` on a fresh engine from snapshot + journal)."""
    import asyncio
    import threading

    from repro_torch.serving import (EngineWedgedError, FaultPlan,
                                     RequestJournal, ServingEngine,
                                     ServingGateway, recover_engine)

    rec = {}
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed, max_decode_steps=4)
    eng = ServingEngine(lm, params, **kw)
    warmed = _quiet(_warm, eng)
    _counted(eng, wants)
    rng = np.random.default_rng(seed)

    async def open_loop(**gw_kw):
        async with ServingGateway(eng, **gw_kw) as gw:
            t0 = time.perf_counter()
            out, span = await _gw_serve(gw, reqs, 1000.0, rng)
            return out, span, time.perf_counter() - t0, gw.stats()

    torch.cuda.synchronize()
    out, span, wall, stats = asyncio.run(open_loop())
    _no_capture(eng, warmed, "gateway")
    for rid, (r, toks) in out.items():
        if r.status != "done" or not np.array_equal(toks, r.output):
            raise AssertionError(f"gateway request {rid}: {r.status}, "
                                 f"stream != output")
    gen = sum(len(toks) for _, toks in out.values())
    ttft = statistics.median(r.ttft_s * 1e3 for r, _ in out.values())
    rec["open_loop"] = dict(
        arrivals_span_s=span, wall_s=wall, tokens_per_s=gen / wall,
        ttft_ms_p50=ttft, direct_tokens_per_s=ring_stats["tokens_per_s"],
        direct_ttft_ms_p50=ring_stats["ttft_ms_p50"],
        streams=_hold_streams(torch, "gateway, open loop", lm, params, seed,
                              reqs, {i: t for i, (_, t) in out.items()},
                              ring_base))
    print(f"  gateway, open loop [{smi}]: {len(reqs)} arrivals over "
          f"{span * 1e3:.1f} ms, {gen} tokens streamed in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s, TTFT p50 {ttft:.1f} ms (at the "
          f"stream); direct run() of the trace (phase 4): "
          f"{ring_stats['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{ring_stats['ttft_ms_p50']:.1f} ms")

    # the hang: the same warmed engine, request ids from 0 again (so the
    # sampled streams' keys are phase 4's), a stall of 1.5 deadlines
    eng._next_id = 0
    eng._faults = FaultPlan(seed=seed, hang=[3],
                            hang_s=1.5 * STEP_TIMEOUT_S)
    out, _, wall, stats = asyncio.run(open_loop(
        step_timeout_s=STEP_TIMEOUT_S, hang_grace=HANG_GRACE))
    _no_capture(eng, warmed, "gateway hang")
    m = eng.metrics()
    if stats["watchdog_timeouts"] < 1 or m["hang_recoveries"] < 1 or \
            any(r.status != "done" for r, _ in out.values()):
        raise AssertionError(f"hang not recovered in process: {stats}")
    rec["hang"] = dict(watchdog_timeouts=stats["watchdog_timeouts"],
                       hang_recoveries=m["hang_recoveries"],
                       retries=m["retries_total"], wall_s=wall,
                       streams=_hold_streams(
                           torch, "gateway, hang", lm, params, seed, reqs,
                           {i: t for i, (_, t) in out.items()}, ring_base))
    print(f"  gateway, hang of {1.5 * STEP_TIMEOUT_S:.1f} s against a "
          f"{STEP_TIMEOUT_S:.1f} s deadline [{smi}]: watchdog timeouts "
          f"{stats['watchdog_timeouts']}, hang recoveries "
          f"{m['hang_recoveries']}, retries {m['retries_total']}; every "
          f"request done in process ({wall:.2f} s)")

    # the wedge: a stall past deadline + grace; the gateway journals and
    # snapshots every 2 steps; asyncio.run joins the stalled step's thread
    # before the fresh engine captures anything
    eng._next_id = 0
    hang_s = STEP_TIMEOUT_S * (1 + WEDGE_GRACE) + 1.0
    eng._faults = FaultPlan(seed=seed, hang=[4], hang_s=hang_s)
    snap_dir = os.path.join(state_dir, "gateway")
    journal = RequestJournal(os.path.join(state_dir, "journal.jsonl"))
    gw_kw = dict(journal=journal, snapshot_dir=snap_dir, snapshot_every=2,
                 step_timeout_s=STEP_TIMEOUT_S, hang_grace=WEDGE_GRACE)
    snap_s = []
    take = eng.snapshot

    def timed_snapshot():
        t0 = time.perf_counter()
        snap = take()
        snap_s.append(time.perf_counter() - t0)
        return snap

    eng.snapshot = timed_snapshot

    async def wedged():
        got = {}
        gw = ServingGateway(eng, **gw_kw)
        try:
            async with gw:
                got, _ = await _gw_serve(gw, reqs, 1000.0, rng)
        except EngineWedgedError:
            return got, gw.stats(), True
        return got, gw.stats(), False

    out, stats, was_wedged = asyncio.run(wedged())
    if not was_wedged or any(t.name.startswith("asyncio")
                             for t in threading.enumerate()):
        raise AssertionError("the wedge leg never wedged, or a step's "
                             "thread outlived the event loop")
    acked = set(range(len(reqs)))
    resolved = {rid for rid, (r, _) in out.items() if r.status == "done"}
    restart = time.perf_counter()
    fresh = ServingEngine(lm, params, **kw)
    first = []
    fresh.on_tokens = lambda ev: first or first.append(time.perf_counter())
    fwarmed = _quiet(_warm, fresh)
    _counted(fresh, wants)
    info = recover_engine(fresh, snapshot_dir=snap_dir, journal=journal)
    done = fresh.run()
    torch.cuda.synchronize()
    _no_capture(fresh, fwarmed, "recovered engine")
    journal.close()
    got = {rid: out[rid][1] for rid in resolved}
    lost = acked - resolved - set(done)
    if lost or any(done[i].status != "done" for i in done):
        raise AssertionError(f"wedge: requests {sorted(lost)} lost")
    got.update({rid: r.output for rid, r in done.items()
                if rid not in resolved})
    rec["wedge"] = dict(
        watchdog_timeouts=stats["watchdog_timeouts"],
        snapshots_taken=stats["snapshots_taken"],
        snapshot_ms=[x * 1e3 for x in snap_s], recovered=info,
        done_before=len(resolved),
        restart_to_first_token_ms=(first[0] - restart) * 1e3,
        warm_compile_s=fresh.warm_compile_s,
        streams=_hold_streams(torch, "gateway, wedge + restart", lm, params,
                              seed, reqs, got, ring_base))
    print(f"  gateway, wedge ({hang_s:.1f} s stall) [{smi}]: "
          f"EngineWedgedError after {stats['watchdog_timeouts']} watchdog "
          f"timeout(s); {stats['snapshots_taken']} snapshots taken "
          f"({statistics.median(snap_s) * 1e3:.2f} ms median); "
          f"{len(resolved)} done before the wedge; restart: warm_compile "
          f"{fresh.warm_compile_s:.2f} s, recovered {info['restored']} + "
          f"replayed {info['replayed']}, restart -> first token "
          f"{rec['wedge']['restart_to_first_token_ms']:.0f} ms; no "
          f"acknowledged request lost")
    return rec, fresh


def _cascade_durability(torch, seed, smi, models, cstats, wants):
    """14(d): phase 7's cascade through the gateway (the legs' taps, inner
    ids translated), then a snapshot mid-flight restored into a fresh
    warmed cascade; streams and routes against phase 7's."""
    import asyncio

    from repro_torch.cascade import CascadeLM
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.serving import CascadeServingEngine, ServingGateway

    edge, cloud, ep, cp = models
    reqs = cstats["trace"]
    cas = CascadeLM(edge, cloud,
                    thresholds=make_thresholds(cstats["hi"], cstats["lo"]))

    def build():
        eng = CascadeServingEngine(cas, ep, cp, seed=seed, batch_slots=8,
                                   max_seq_len=1024, max_decode_steps=4)
        return eng

    base = {i: np.asarray(x, np.int32)
            for i, x in enumerate(cstats["streams"])}

    def hold(label, got):
        for i, (route, x) in got.items():
            if route != cstats["route_of"][i] or not np.array_equal(
                    x, base[i]):
                raise AssertionError(f"{label}: request {i} ({route}) != "
                                     f"phase 7's")

    eng = build()
    warmed = _quiet(_warm, eng)
    _counted(eng, wants)

    async def through_gateway():
        out = {}

        async def client(p, t):
            h = await gw.submit(p, max_new_tokens=32, temperature=t)
            toks = [x async for x in h.stream()]
            r = await h.result()
            out[r.request_id] = (r.route, np.asarray(toks, np.int32))

        async with ServingGateway(eng) as gw:
            await asyncio.gather(*(client(p, t) for p, t in reqs))
        return out

    t0 = time.perf_counter()
    hold("cascade through the gateway", asyncio.run(through_gateway()))
    wall = time.perf_counter() - t0
    _no_capture(eng, warmed, "cascade gateway")
    # the same trace again, ids from 0 on the cascade and its legs
    for e in (eng, eng.edge_engine, eng.cloud_engine):
        e._next_id = 0
    eng.on_tokens = None
    for p, t in reqs:
        eng.submit(p, max_new_tokens=32, temperature=t)
    for _ in range(4):
        eng.step()
    t0 = time.perf_counter()
    snap = eng.snapshot()
    snap_s = time.perf_counter() - t0
    fresh = build()
    fwarmed = _quiet(_warm, fresh)
    _counted(fresh, wants)
    t0 = time.perf_counter()
    info = fresh.restore(snap)
    restore_s = time.perf_counter() - t0
    done = fresh.run()
    torch.cuda.synchronize()
    _no_capture(fresh, fwarmed, "cascade restored")
    if sorted(done) != list(range(len(reqs))):
        raise AssertionError("restored cascade: a request was lost")
    hold("restored cascade", {i: (r.route, r.output)
                              for i, r in done.items()})
    print(f"  cascade [{smi}]: {len(reqs)} requests streamed through the "
          f"gateway (legs' taps, ids translated) equal phase 7's streams "
          f"and routes ({wall:.2f} s); snapshot after 4 steps "
          f"{snap_s * 1e3:.1f} ms, restore {restore_s * 1e3:.2f} ms "
          f"({info['live']} live, {info['terminal']} terminal), the "
          f"restored cascade's streams and routes equal phase 7's")
    return dict(gateway_wall_s=wall, snapshot_ms=snap_s * 1e3,
                restore_ms=restore_s * 1e3, restored=info)


def check_durability(torch, dev, seed, smi, smollm, reqs, ring_stats,
                     paged_stats, models, cascade_stats):
    """Phase 14 on smollm-135m at full width, graphed: (a) chaos, (c) the
    gateway, its hang and its wedge, (b) snapshot and restore (on engines
    of (a) and (c), drained), (d) the cascade. Every engine is warmed first and captures nothing in traffic;
    the phase's launches equal what its counted programs imply. Returns
    (record, launches)."""
    import shutil
    import tempfile

    from repro_torch.kernels import LAUNCHES, reset_launches

    lm, params = smollm
    wants = []
    state_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    torch.cuda.synchronize()
    reset_launches()
    ring_base, paged_base = ring_stats["streams"], paged_stats["streams"]
    try:
        rec = {}
        rec["chaos"], paged_eng = _chaos(torch, seed, smi, lm, params, reqs,
                                         ring_base, paged_base, wants)
        rec["gateway"], ring_eng = _gateway(torch, seed, smi, lm, params,
                                            reqs, ring_base, ring_stats,
                                            wants, state_dir)
        rec["snapshot"] = _durability(torch, seed, smi, lm, params, reqs,
                                      ring_base, paged_base, wants,
                                      state_dir, ring_eng, paged_eng)
        rec["cascade"] = _cascade_durability(torch, seed, smi, models,
                                             cascade_stats, wants)
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = _sum_launches([w() for w in wants])
    print(f"  launches in phase 14: {launches} (expected {want} from the "
          f"counted programs of {len(wants)} engines)")
    if launches != want:
        raise AssertionError("phase 14: launch counts do not match the "
                             "programs run")
    if min(launches[k] for k in ("flash_attention", "decode_attention",
                                 "paged_decode_attention",
                                 "cascade_gate")) < 1:
        raise AssertionError("phase 14 missed a kernel of its path")
    rec["launches"] = launches
    return rec, launches


def profile_gateway(torch, seed, lm, params, reqs, wall_s):
    """Phase 4's trace through the gateway (open loop at 1,000 req/s, as
    in 14(c)) under the profiler: does the executor thread change the
    device's idle share?"""
    import asyncio

    from repro_torch.serving import ServingEngine, ServingGateway

    eng = ServingEngine(lm, params, batch_slots=8, max_seq_len=1024,
                        seed=seed, max_decode_steps=4)
    eng.warm_compile()

    def serve():
        async def main():
            async with ServingGateway(eng) as gw:
                t0 = time.perf_counter()
                await _gw_serve(gw, reqs, 1000.0,
                                np.random.default_rng(seed))
                return time.perf_counter() - t0
        return asyncio.run(main())

    return _device_profile(torch, serve, wall_s)


# -- phase 15: the ACE application ----------------------------------------------

# benchmarks/bench_partition.py's scenarios:
# (name, edge FLOP/s, cloud FLOP/s, uplink Mbps, delay s)
PARTITION_SCENARIOS = [
    ("lan", 5e10, 5e12, 1000.0, 0.001),
    ("campus", 5e10, 5e12, 20.0, 0.05),
    ("cellular", 5e10, 5e12, 2.0, 0.10),
    ("edge-strong", 5e11, 5e12, 2.0, 0.10),
]
PARTITION_TOKENS = (2, 256)     # batch, sequence
PARTITION_SPLITS = (0, 15, 30)
# repro.data.video.model_crop_bank's defaults
ACE_BANK = dict(n_train=4096, n_bank=2048, coc_steps=300, eoc_steps=120,
                batch=128)
# the classifiers in f32, card (cuDNN) vs CPU (oneDNN) on the same
# weights: summation order only, relative to the largest logit; bank
# confidences absolute; a boolean may differ only within this of a flip
CLS_TOL = 1e-4
CONF_TOL = 1e-4
# benchmarks/bench_video_query.py's sweep
FIG5_INTERVALS = (0.5, 0.2, 0.1)
FIG5_DELAYS = (0.0, 50.0)
FIG5_PARADIGMS = ("ci", "ei", "ace", "ace+")
FIG5_DURATION_S = 20.0
# calibrate_server_from_engine's warm-up request and its 8 queries
CALIBRATION_REQUESTS = 1 + 8


def _fig5_violations(vals):
    """``benchmarks/bench_video_query.py``'s ``check()``: the paper's
    qualitative Fig. 5 claims over {(paradigm, interval, delay): result}."""
    bad = []
    for delay in FIG5_DELAYS:
        d = int(delay)
        for iv in FIG5_INTERVALS:
            ci, ei, ace = (vals[(p, iv, delay)] for p in ("ci", "ei", "ace"))
            if not (ci["f1"] > ace["f1"] > ei["f1"]):
                bad.append(f"F1 ordering violated at iv={iv} d={d}")
            if not (ace["bwc_mb"] < 0.5 * ci["bwc_mb"]):
                bad.append(f"ACE bandwidth not << CI at iv={iv} d={d}")
        hi, lo = vals[("ci", 0.1, delay)], vals[("ci", 0.5, delay)]
        if not (hi["eil_s"] > 5 * lo["eil_s"]):
            bad.append(f"CI EIL blowup missing at d={d}")
    return bad


def _time_halves(torch, timer, lm, params, part, batch, hidden, pos, full):
    """Each half and the monolithic forward: device ms of an eager call
    (CUDA events; the device waits on the host's launches, ~40 kernels a
    layer), host ms of one (synchronised), and device ms of a CUDA graph
    replay, the graphs' logits held equal to ``full``."""
    calls = {"edge": lambda: part.edge_forward(params, batch)[0],
             "cloud": lambda: part.cloud_forward(params, hidden, pos),
             "forward": lambda: lm.forward(params, batch)[0]}
    out = {}
    for name, fn in calls.items():
        eager_ms = timer(lambda i: fn(), n=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 200
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        graph.replay()
        torch.cuda.synchronize()
        if name != "edge" and not torch.equal(got, full):
            raise AssertionError(f"{name} as a CUDA graph: logits != "
                                 f"LM.forward's")
        if name == "edge" and not torch.equal(got, hidden):
            raise AssertionError("the edge half as a CUDA graph: boundary "
                                 "!= eager")
        out[name] = dict(eager_ms=eager_ms, host_ms=host_ms,
                         graph_ms=timer(lambda i: graph.replay(), n=10))
        del graph, got
    return out


def _ace_partition(torch, timer, dev, seed, smi, lm, params):
    """(a) ``PartitionedLM`` over smollm-135m at full width: at each split
    the edge half, then the cloud half, equal ``LM.forward``'s logits bit
    for bit (the same kernels in the same order), each full pass launching
    flash once per layer; the halves' device ms at the middle split, the
    boundary bytes, and ``best_partition`` for the partition benchmark's
    scenarios."""
    from repro_torch.configs import get_config
    from repro_torch.core.patterns.inference import (PartitionedLM,
                                                     best_partition)
    from repro_torch.kernels import LAUNCHES, reset_launches

    b, s = PARTITION_TOKENS
    n_layers = lm.cfg.num_layers
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, lm.cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    batch = {"tokens": tok}
    reset_launches()
    full, _ = lm.forward(params, batch)
    passes, flash = 1, LAUNCHES["flash_attention"]
    if flash != n_layers:
        raise AssertionError(f"forward launched flash {flash} times, not "
                             f"{n_layers}")
    stats = {"splits": {}}
    for split in PARTITION_SPLITS:
        part = PartitionedLM(lm, split)
        reset_launches()
        hidden, pos = part.edge_forward(params, batch)
        edge = LAUNCHES["flash_attention"]
        logits = part.cloud_forward(params, hidden, pos)
        passes += 1
        flash += LAUNCHES["flash_attention"]
        if edge != split or LAUNCHES["flash_attention"] != n_layers:
            raise AssertionError(f"split {split}: flash launched {edge} + "
                                 f"{LAUNCHES['flash_attention'] - edge}")
        if not torch.equal(logits, full):
            raise AssertionError(f"split {split}: partitioned logits != "
                                 f"LM.forward's (max |diff| "
                                 f"{float((logits - full).abs().max())})")
        rec = dict(boundary_bytes=part.boundary_bytes(b, s))
        if 0 < split < n_layers:
            rec.update(_time_halves(torch, timer, lm, params, part, batch,
                                    hidden, pos, full))
        stats["splits"][split] = rec
    mid = stats["splits"][PARTITION_SPLITS[1]]
    if mid["boundary_bytes"] != b * s * lm.cfg.d_model * torch.empty(
            (), dtype=lm.dtype).element_size():
        raise AssertionError("boundary_bytes is not B x S x d x itemsize")
    print(f"  (a) PartitionedLM, {lm.cfg.name} {lm.cfg.param_dtype}, "
          f"tokens ({b}, {s}): "
          f"splits {list(PARTITION_SPLITS)} equal LM.forward bit for bit; "
          f"{flash} flash launches over {passes} full passes "
          f"({n_layers} each)")
    print(f"      split {PARTITION_SPLITS[1]} [{smi}]: eager, device "
          f"(host) ms: edge {mid['edge']['eager_ms']:.3f} "
          f"({mid['edge']['host_ms']:.3f}) + cloud "
          f"{mid['cloud']['eager_ms']:.3f} ({mid['cloud']['host_ms']:.3f}), "
          f"monolith {mid['forward']['eager_ms']:.3f} "
          f"({mid['forward']['host_ms']:.3f}); as CUDA graphs (equal "
          f"logits) {mid['edge']['graph_ms']:.3f} + "
          f"{mid['cloud']['graph_ms']:.3f}, monolith "
          f"{mid['forward']['graph_ms']:.3f}; boundary "
          f"{mid['boundary_bytes']} B")
    stats["best_partition"] = {}
    for arch in ("smollm-135m", "internvl2-2b"):
        cfg = get_config(arch)
        total = sum(st.repeat for st in cfg.stages)
        row = {}
        for name, ef, cf, up, delay in PARTITION_SCENARIOS:
            k, t = best_partition(cfg, batch=1, seq_len=256, edge_flops_s=ef,
                                  cloud_flops_s=cf, uplink_mbps=up,
                                  delay_s=delay)
            row[name] = dict(split=k, total=total, est_s=t)
        stats["best_partition"][arch] = row
        print(f"      best_partition {arch} (seq 256): " + "; ".join(
            f"{n} {r['split']}/{total} ({r['est_s'] * 1e3:.2f} ms)"
            for n, r in row.items()))
    stats["flash_launches"] = flash
    return stats


def _ace_classifiers(torch, timer, dev, seed, smi):
    """(b) EOC and COC at ``VideoQueryConfig``'s widths in f32: the card's
    forward equals the CPU's on 256 crops; then ``model_crop_bank`` with
    ``repro``'s defaults on the card (COC's loss falls from its first
    step); then its two trainings again through ``train_classifier``,
    timed, and ``bank_pass`` on their weights equals the CPU's. Returns
    the crop bank and the stats."""
    from repro_torch.configs.ace_video_query import config
    from repro_torch.data import video
    from repro_torch.data.synthetic import synth_crops
    from repro_torch.models.cnn import Classifier
    from repro_torch.utils.tree import tree_map

    vq = config()
    x, _ = synth_crops(256, seed=seed + 5)
    stats = {"forward_rel_err": {}}
    for cfg in (vq.eoc, vq.coc):
        cpu = Classifier(cfg, device="cpu")
        params = cpu.init(seed)
        with torch.no_grad():
            want = cpu.apply(params, torch.from_numpy(x))
            got = Classifier(cfg, device=dev).apply(
                tree_map(lambda t: t.to(dev), params),
                torch.from_numpy(x).to(dev)).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        stats["forward_rel_err"][cfg.name] = rel
        if not rel <= CLS_TOL:
            raise AssertionError(f"{cfg.name}: card logits differ from the "
                                 f"CPU's by {rel:.2e} relative")

    # COC's first-step loss: model_crop_bank's first batch on its init
    train, lbls = synth_crops(ACE_BANK["n_train"], seed=seed)
    idx = np.random.default_rng(seed).integers(0, len(train),
                                               size=ACE_BANK["batch"])
    coc = Classifier(vq.coc, device=dev)
    with torch.no_grad():
        first, _ = coc.loss(coc.init(seed), torch.from_numpy(train[idx]).to(
            dev), torch.from_numpy(lbls[idx].astype(np.int64)).to(dev))
    first = float(first)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank, report = video.model_crop_bank(vq, seed=seed, device=dev,
                                         **ACE_BANK)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    if not report["coc"]["loss"] < first:
        raise AssertionError(f"COC's loss did not fall: {first:.4f} -> "
                             f"{report['coc']['loss']:.4f}")

    # model_crop_bank's two trainings again, each timed, for ms per step
    # and for trained weights to hold the card's bank pass against the
    # CPU's (never against the trainings above: cuDNN's backward need
    # not be deterministic)
    def timed(model, images, labels, steps, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = video.train_classifier(model, images, labels,
                                           steps=steps, seed=seed,
                                           batch=ACE_BANK["batch"])
        torch.cuda.synchronize()
        return params, (time.perf_counter() - t0) / steps

    coc_p, coc_step = timed(coc, train, lbls, ACE_BANK["coc_steps"], seed)
    with torch.no_grad():
        coc_labels = torch.argmax(coc.apply(
            coc_p, torch.from_numpy(train).to(dev)), -1).cpu().numpy()
    eoc = Classifier(vq.eoc, device=dev)
    eoc_p, eoc_step = timed(
        eoc, train, (coc_labels == video.TARGET_CLASS).astype(np.int32),
        ACE_BANK["eoc_steps"], seed + 2)
    imgs, _ = synth_crops(ACE_BANK["n_bank"], seed=seed + 1)
    x_dev = torch.from_numpy(imgs).to(dev)
    pass_ms = timer(lambda i: video.bank_pass(eoc, coc, eoc_p, coc_p, x_dev),
                    n=5)
    got = [t.cpu() for t in video.bank_pass(eoc, coc, eoc_p, coc_p, x_dev)]
    eoc_c, coc_c = (Classifier(c, device="cpu") for c in (vq.eoc, vq.coc))
    eoc_pc, coc_pc = (tree_map(lambda t: t.cpu(), p) for p in (eoc_p, coc_p))
    t0 = time.perf_counter()
    want = video.bank_pass(eoc_c, coc_c, eoc_pc, coc_pc,
                           torch.from_numpy(imgs))
    cpu_s = time.perf_counter() - t0
    conf_err = float((got[0] - want[0]).abs().max())
    if not conf_err <= CONF_TOL:
        raise AssertionError(f"bank confidences differ from the CPU's by "
                             f"{conf_err:.2e}")
    with torch.no_grad():
        ties = video.bank_near_ties(want[0], coc_c.apply(
            coc_pc, torch.from_numpy(imgs)), CONF_TOL)
    for name, a, b in zip(("pred", "hit", "posthoc"), got[1:], want[1:]):
        if not torch.equal(a[~ties], b[~ties]):
            raise AssertionError(f"bank {name} differs from the CPU's away "
                                 f"from near-ties")
    stats.update(
        coc_first_loss=first, report=report, coc_ms_per_step=coc_step * 1e3,
        eoc_ms_per_step=eoc_step * 1e3, bank_pass_ms=pass_ms,
        bank_s=bank_s, cpu_bank_pass_s=cpu_s, bank_conf_err=conf_err,
        near_ties=int(ties.sum()))
    print(f"  (b) classifiers f32 [{smi}]: card vs CPU logits "
          + ", ".join(f"{k} {v:.1e}" for k, v in
                      stats["forward_rel_err"].items())
          + f" relative (tol {CLS_TOL})")
    print(f"      model_crop_bank ({ACE_BANK}) in {bank_s:.1f} s: COC "
          f"loss {first:.3f} -> {report['coc']['loss']:.3f}, train acc "
          f"{report['coc']['acc']:.3f}; EOC train acc "
          f"{report['eoc']['acc']:.3f}. Trained again: COC "
          f"{coc_step * 1e3:.2f} ms per step (wall), EOC "
          f"{eoc_step * 1e3:.2f}; bank pass {pass_ms:.2f} ms device over "
          f"{len(imgs)} crops (CPU {cpu_s:.2f} s)")
    print(f"      eoc_error_at_conf {report['eoc_error_at_conf']:.4f} (paper "
          f"0.1106), escalation_rate {report['escalation_rate']:.4f}; bank "
          f"vs CPU: conf {conf_err:.1e}, booleans equal away from "
          f"{int(ties.sum())} near-ties")
    return bank, stats


def _ace_fig5(bank, smi):
    """(c) The Fig. 5 sweep on the surrogate bank with the benchmark's
    orderings, then the four paradigms on the model-backed bank."""
    from repro_torch.configs.ace_video_query import config
    from repro_torch.core.video_query import run_video_query

    cfg = config()
    t0 = time.perf_counter()
    vals = {(p, iv, d): run_video_query(cfg, paradigm=p, frame_interval_s=iv,
                                        wan_delay_ms=d,
                                        duration_s=FIG5_DURATION_S)
            for d in FIG5_DELAYS for iv in FIG5_INTERVALS
            for p in FIG5_PARADIGMS}
    sweep_s = time.perf_counter() - t0
    bad = _fig5_violations(vals)
    if bad:
        raise AssertionError(f"Fig. 5 claims violated: {bad}")
    print(f"  (c) Fig. 5 sweep: {len(vals)} cells in {sweep_s:.1f} s, the "
          f"benchmark's orderings hold")
    for d in FIG5_DELAYS:
        for iv in FIG5_INTERVALS:
            print(f"      d {int(d)} ms, iv {iv} s: " + "; ".join(
                f"{p} F1 {vals[(p, iv, d)]['f1']:.3f} BWC "
                f"{vals[(p, iv, d)]['bwc_mb']:.2f} MB EIL "
                f"{vals[(p, iv, d)]['eil_s']:.3f} s" for p in FIG5_PARADIGMS))
    model = {}
    for p in FIG5_PARADIGMS:
        r = run_video_query(cfg, paradigm=p, frame_interval_s=0.2,
                            wan_delay_ms=50.0, duration_s=FIG5_DURATION_S,
                            crop_bank=bank)
        if not (r["crops"] > 0 and 0.0 <= r["f1"] <= 1.0):
            raise AssertionError(f"model-backed {p}: {r}")
        model[p] = r
    if model["ei"]["bwc_mb"] > 1e-6:
        raise AssertionError(f"EI sent {model['ei']['bwc_mb']} MB over the "
                             f"WAN")
    print("      model-backed bank, iv 0.2 s, d 50 ms: " + "; ".join(
        f"{p} F1 {r['f1']:.3f} BWC {r['bwc_mb']:.2f} MB EIL "
        f"{r['eil_s']:.3f} s" for p, r in model.items()))
    return {"sweep": {f"{p}/iv{iv}/d{int(d)}ms": r
                      for (p, iv, d), r in vals.items()},
            "sweep_s": sweep_s, "model_bank": model}


def _ace_engines(torch, dev, seed, smi, models):
    """(d) The servers calibrated from phase 7's engines: smollm-135m's
    graphed ring engine (8 slots, max_seq_len 1024, K = 4) as COC and its
    4-layer edge draft's as EOC, each warmed first.
    ``calibrate_server_from_engine`` on each; then ``run_video_query``
    (ace, the surrogate bank, whose middle band escalates) at 0.5 s and
    0.1 s, which calibrates both again, and once more with the EOC engine
    alone: the escalated crops reach the engine-calibrated COC server
    (its service time moves EIL), every calibration request finishes
    (the engines' terminal counts), nothing is captured in the traffic,
    and each kernel's launches equal the counted programs'."""
    from repro_torch.configs.ace_video_query import config
    from repro_torch.core.video_query import (calibrate_server_from_engine,
                                              run_video_query)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    edge, cloud, edge_params, cloud_params = models
    kw = dict(batch_slots=8, max_seq_len=1024, max_decode_steps=4, seed=seed)
    engines = {"eoc": ServingEngine(edge, edge_params, **kw),
               "coc": ServingEngine(cloud, cloud_params, **kw)}
    warmed = {name: _warm(eng) for name, eng in engines.items()}
    counts = {name: _count_programs(eng) for name, eng in engines.items()}
    before = {name: dict(eng.metrics()["terminal"])
              for name, eng in engines.items()}
    torch.cuda.synchronize()
    reset_launches()
    cal = {name: calibrate_server_from_engine(eng)
           for name, eng in engines.items()}
    calibrations = {"eoc": 1, "coc": 1}
    print(f"  (d) engine-calibrated servers [{smi}]: " + "; ".join(
        f"{name.upper()} service_s {c['service_s'] * 1e3:.2f} ms, workers "
        f"{c['workers']}, tokens_s {c['tokens_s']:.0f}"
        for name, c in cal.items()))
    stats = {"calibration": cal}
    for iv in (0.5, 0.1):
        run = dict(paradigm="ace", frame_interval_s=iv, wan_delay_ms=50.0,
                   duration_s=FIG5_DURATION_S)
        r = run_video_query(config(), eoc_engine=engines["eoc"],
                            coc_engine=engines["coc"], **run)
        edge_only = run_video_query(config(), eoc_engine=engines["eoc"],
                                    **run)
        calibrations["eoc"] += 2
        calibrations["coc"] += 1
        if not (r["crops"] > 0 and 0.0 <= r["f1"] <= 1.0):
            raise AssertionError(f"ace at iv {iv}: {r}")
        if r["eil_s"] == edge_only["eil_s"]:
            raise AssertionError(f"ace at iv {iv}: the engine-calibrated "
                                 f"COC server moved no crop's EIL (none "
                                 f"escalated)")
        stats[f"iv{iv}"] = dict(result=r, edge_only=edge_only)
        print(f"      ace at iv {iv} s, d 50 ms, surrogate bank: F1 "
              f"{r['f1']:.3f}, BWC {r['bwc_mb']:.2f} MB, EIL "
              f"{r['eil_s']:.4f} s (COC at its default "
              f"{config().coc_infer_ms} ms: {edge_only['eil_s']:.4f} s), "
              f"COC backlog {r['coc_backlog_s']:.3f} s")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, eng in engines.items():
        done = dict(before[name])
        done["done"] = (done.get("done", 0)
                        + CALIBRATION_REQUESTS * calibrations[name])
        if eng.metrics()["terminal"] != done:
            raise AssertionError(f"{name}: terminal requests "
                                 f"{eng.metrics()['terminal']} != {done}: "
                                 f"a calibration request did not finish")
        _no_capture(eng, warmed[name], f"{name} engine")
    want = _sum_launches([_spec_launches(eng, counts[name])
                          for name, eng in engines.items()])
    if launches != want:
        raise AssertionError(f"calibration launches {launches} != the "
                             f"counted programs' {want}")
    print(f"      {calibrations} calibrations, every request done; "
          f"captured nothing; launches {launches} equal the counted "
          f"programs' (EOC {edge.cfg.num_layers} layers, COC "
          f"{cloud.cfg.num_layers})")
    stats["launches"] = launches
    return stats


def check_ace_app(torch, dev, seed, smi, timer, smollm, models):
    """Phase 15, the ACE platform and its video-query application on the
    card: (a) ``PartitionedLM``, (b) the classifiers and the model-backed
    crop bank, (c) the Fig. 5 sweep, (d) engine-calibrated servers.
    Returns (stats, the kernel launches of (a) and (d))."""
    stats = {"partition": _ace_partition(torch, timer, dev, seed, smi,
                                         *smollm)}
    bank, stats["classifiers"] = _ace_classifiers(torch, timer, dev, seed,
                                                  smi)
    stats["fig5"] = _ace_fig5(bank, smi)
    stats["engines"] = _ace_engines(torch, dev, seed, smi, models)
    launches = dict(stats["engines"]["launches"])
    launches["flash_attention"] += stats["partition"]["flash_launches"]
    return stats, launches


# -- phase 16: MoE and MLA at full width -----------------------------------------

class _Routes:
    """Records the MoE routing of eager calls while active: for each
    ``moe.route`` call, the sorted top-k expert sets (T, k) and the gap
    between the k-th and (k+1)-th router logits (T,). ``moe_forward`` looks
    ``route`` up at call time, so the wrapper sees every MoE layer (a
    model without MoE records nothing; on a mesh each rank gathers the
    logits again, all ranks alike). Never active around a graph capture or
    replay."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import moe as moe_lib
        self._lib, self._route = moe_lib, moe_lib.route
        torch, orig, calls = self.torch, moe_lib.route, self.calls

        def route(params, cfg, x_flat, tp=None, over_data=None):
            idx, w, aux = orig(params, cfg, x_flat, tp, over_data)
            k = cfg.moe.num_experts_per_tok
            logits = moe_lib.router_logits(params, x_flat, tp)
            top = torch.topk(logits, k + 1, dim=-1).values
            calls.append((idx.sort(dim=-1).values, top[:, k - 1] - top[:, k]))
            return idx, w, aux

        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        self._lib.route = self._route

    def near_ties(self, tol):
        """(1, S) numpy bool of a forward over (1, S) tokens: some MoE
        layer's gap at that position is below ``tol``."""
        gaps = self.torch.stack([g for _, g in self.calls])
        return (gaps < tol).any(dim=0).cpu().numpy().reshape(1, -1)


def _cut_stages(cfg, repeats, experts=None, dtype=None):
    """``cfg`` with stage i repeated ``repeats[i]`` times, widths unchanged;
    ``experts`` cuts the routed experts (top-k kept), ``dtype`` the
    parameter dtype."""
    stages = tuple(dataclasses.replace(st, repeat=r)
                   for st, r in zip(cfg.stages, repeats))
    out = dataclasses.replace(
        cfg, stages=stages,
        num_layers=sum(len(st.blocks) * st.repeat for st in stages))
    if experts is not None:
        out = dataclasses.replace(out, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    if dtype is not None:
        out = dataclasses.replace(out, param_dtype=dtype)
    return out


def _dropless(cfg) -> float:
    return cfg.moe.num_experts / cfg.moe.num_experts_per_tok


def _moe_layers(cfg) -> int:
    return sum(st.repeat for st in cfg.stages for b in st.blocks
               if b.mlp == "moe")


MOE_MODELS = ("mixtral-8x22b", "deepseek-v3-671b")
# layers served at full width, per stage: mixtral 6 of its 56, deepseek
# its 3 dense layers and 1 of its 58 MoE layers (MTP's params made too)
MOE_DEPTH = {"mixtral-8x22b": (6,), "deepseek-v3-671b": (3, 1)}
# (a)'s f32 cut, which the host holds beside the card's copy: mixtral's
# first layer; deepseek's 4 layers with 32 of its 256 routed experts
# (top-8 kept, expert widths kept)
MOE_F32_CUT = {"mixtral-8x22b": ((1,), None), "deepseek-v3-671b": ((3, 1), 32)}
MOE_F32_TOKENS = 40


def _route_flips(torch, a, b, tol, rows=1):
    """Routes of two runs over the same ``rows`` rows of tokens, layer by
    layer ((T, k) sets and (T,) gaps per MoE call, in layer order, T
    row-major): (flipped (T,) numpy bool, a set differs at some layer;
    the flips that are not near-ties, their gap at least ``tol`` on both
    sides; the largest gap at such a first flip). Only a flip that no
    earlier one can reach must be a near-tie: a token that took another
    expert at layer l carries it into its own later layers and, through
    attention, into later tokens of its row, which may then route apart
    at any gap."""
    flipped = np.zeros(a[0][0].shape[0], bool)
    reach = flipped.copy()
    bad, widest = 0, 0.0
    for (ia, ga), (ib, gb) in zip(a, b):
        f = (ia.cpu() != ib.cpu()).any(dim=-1).numpy()
        gap = torch.minimum(ga.cpu(), gb.cpu()).numpy()
        first = f & ~reach
        bad += int((first & (gap >= tol)).sum())
        if first.any():
            widest = max(widest, float(gap[first].max()))
        flipped |= f
        reach = np.maximum.accumulate(flipped.reshape(rows, -1),
                                      axis=1).reshape(-1)
    return flipped, bad, widest


def _moe_f32_vs_cpu(torch, dev, seed, name, base):
    """(a) The card's f32 forward against the plain CPU forward on the
    ``MOE_F32_CUT`` of ``base``, dropless: routes compared first (a flip
    only at a near-tie, within ``ROUTE_TOL['float32']``), then the logits
    of every token whose routes agree (a flipped token moves by a whole
    expert; in both cuts the MoE layers' flips reach no later layer's
    cache but mixtral's single layer's and deepseek's last)."""
    from repro_torch.models.model import LM

    repeats, experts = MOE_F32_CUT[name]
    cfg = _cut_stages(base, repeats, experts, "float32")
    cf = _dropless(cfg)
    gpu = LM(cfg, device=dev, capacity_factor=cf)
    params = gpu.init(seed + 30, on_device=True)
    n = _tree_numel(params)
    tok = torch.from_numpy(np.random.default_rng(seed + 31).integers(
        0, cfg.vocab_size, (1, MOE_F32_TOKENS)).astype(np.int32))
    with _Routes(torch) as rg:
        got, _ = gpu.forward(params, {"tokens": tok.to(dev)})
    got = got[0].cpu()
    t0 = time.perf_counter()
    host = _to_device(params, "cpu")
    del params
    torch.cuda.empty_cache()
    cpu = LM(cfg, device="cpu", capacity_factor=cf)
    with _Routes(torch) as rc:
        ref, _ = cpu.forward(host, {"tokens": tok})
    cpu_s = time.perf_counter() - t0
    del host
    flipped, bad, widest = _route_flips(torch, rg.calls, rc.calls,
                                        ROUTE_TOL["float32"])
    ok = ~flipped
    err = (got[ok] - ref[0][ok]).abs().max().item()
    cut = (f"{cfg.num_layers} layer{'s' * (cfg.num_layers > 1)}"
           + (f", {experts} of {base.moe.num_experts} routed experts"
              if experts else ""))
    print(f"  (a) {name} f32 ({cut}, {n / 1e9:.2f} B "
          f"values, dropless): GPU vs CPU plain forward over "
          f"{MOE_F32_TOKENS} tokens: routes flipped at {int(flipped.sum())} "
          f"of {len(flipped)} tokens x {len(rg.calls)} MoE layers (largest "
          f"gap at a first flip {widest:.2e}, tol "
          f"{ROUTE_TOL['float32']}), "
          f"max|diff| {err:.3e} over the {int(ok.sum())} others (tol "
          f"{F32_LOGIT_TOL}; max|logit| {ref.abs().max().item():.2f}); CPU "
          f"copy + forward {cpu_s:.1f} s")
    if bad or not err < F32_LOGIT_TOL or ok.sum() < len(ok) // 2:
        raise AssertionError(f"{name}: f32 GPU forward != CPU forward")
    return dict(cut=cut, flipped=int(flipped.sum()), compared=int(ok.sum()),
                max_abs_err=err, widest_flipped_gap=widest)


def _moe_prefill_vs_forward(torch, lm, params, tokens, prompt, mesh=None):
    """(b) Phase 3's check on an MoE model, routes first: prefill
    ``tokens[:, :prompt]`` then decode the rest, against one forward over
    ``tokens``. A token's first route that differs must be a near-tie
    (within ``ROUTE_TOL['bfloat16']`` on both paths, ``_route_flips``);
    the logits of every position whose routes agree are held to
    ``BF16_LOGIT_TOL``. ``mesh``: both paths on this rank's shards."""
    b, s = tokens.shape
    n_moe = _moe_layers(lm.cfg)
    with _Routes(torch) as fwd:
        full, _ = lm.forward(params, {"tokens": tokens}, mesh=mesh)
    with _Routes(torch) as dec:
        logits, caches = lm.prefill(params, {"tokens": tokens[:, :prompt]},
                                    cache_width=64, mesh=mesh)
        rows = [logits[:, -1]]
        for t in range(prompt, s):
            step, caches = lm.decode_step(params, caches, tokens[:, t:t + 1],
                                          t, mesh=mesh)
            rows.append(step[:, 0])
    got = torch.stack(rows, dim=1).float()                 # prompt-1 .. s-1
    want = full[:, prompt - 1:].float()
    k = fwd.calls[0][0].shape[-1]
    path = []
    for layer in range(n_moe):
        sets = [dec.calls[layer][0].reshape(b, prompt, k)]
        gaps = [dec.calls[layer][1].reshape(b, prompt)]
        for j in range(s - prompt):
            c = dec.calls[n_moe * (1 + j) + layer]
            sets.append(c[0].reshape(b, 1, k))
            gaps.append(c[1].reshape(b, 1))
        path.append((torch.cat(sets, 1).reshape(b * s, k),
                     torch.cat(gaps, 1).reshape(b * s)))
    flipped, bad, widest = _route_flips(torch, fwd.calls, path,
                                        ROUTE_TOL["bfloat16"], rows=b)
    ok = torch.from_numpy(~flipped.reshape(b, s)[:, prompt - 1:]).to(
        got.device)
    err = (got - want).abs().amax(dim=-1)[ok].max().item()
    return dict(err=err, max_logit=want.abs().max().item(),
                flipped=int(flipped.sum()), tokens=b * s,
                compared=int(ok.sum()), positions=ok.numel(), bad=bad,
                compared_rows=ok.sum(dim=1).tolist(),
                widest_flipped_gap=widest, moe_layers=n_moe)


def _count_drops(torch, lm, params, reqs, eng, mesh=None):
    """The (token, choice) pairs that ``reqs``' admissions drop on ``eng``
    (monolithic prefill at each prompt's bucket, right-padded, every MoE
    layer), recomputed eagerly: each MoE call's routing re-run on its
    input by ``moe.dropped_pairs`` over the prompt's real tokens.
    ``mesh``: on this rank's shards. Returns (dropped, pairs)."""
    from repro_torch.models import moe as moe_lib

    total = [0, 0]
    orig = moe_lib.moe_forward
    k = lm.cfg.moe.num_experts_per_tok

    def counted(p, cfg, x, *, capacity_factor, tp=None, over_data=None):
        total[0] += int(moe_lib.dropped_pairs(
            p, cfg, x, capacity_factor=capacity_factor, length=length[0],
            tp=tp))
        total[1] += length[0] * k
        return orig(p, cfg, x, capacity_factor=capacity_factor, tp=tp,
                    over_data=over_data)

    length = [0]
    moe_lib.moe_forward = counted
    try:
        for prompt, _ in reqs:
            length[0] = len(prompt)
            bucket = next(bk for bk in eng.buckets if bk >= len(prompt))
            tok = np.zeros((1, bucket), np.int32)
            tok[0, :len(prompt)] = prompt
            lm.prefill(params, {"tokens": torch.from_numpy(tok).to(
                lm.device)}, cache_width=eng.max_seq_len,
                lengths=torch.tensor([len(prompt)], device=lm.device),
                logits_index=torch.tensor([len(prompt) - 1],
                                          device=lm.device), mesh=mesh)
    finally:
        moe_lib.moe_forward = orig
    return total[0], total[1]


def _moe_default_factor(torch, dev, seed, smi, cfg, params):
    """(d) ``repro``'s capacity factor 1.25, where a prefill drops pairs:
    on the ring (8 slots, max_seq_len 1024) 8 of phase 4's requests (6
    greedy, 2 sampled) give equal streams at K = 4 and K = 1 (decode never
    drops); on the paged backend with monolithic prefill, phase 5's waves
    with swap preemption equal an uncontended run (a swapped slot's K/V
    comes back as it was, and each prompt is prefilled at its own bucket).
    Prints the pairs the ring's admissions dropped."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    lm = LM(cfg, device=dev)
    full = _trace(seed, cfg.vocab_size)
    reqs = full[:6] + full[16:]
    kw = dict(batch_slots=8, max_seq_len=1024, seed=seed)
    outs, counts = {}, collections.Counter()
    for k in (4, 1):
        eng = ServingEngine(lm, params, max_decode_steps=k, **kw)
        warmed = _warm(eng)
        torch.cuda.synchronize()
        reset_launches()
        outs[k], _ = _serve(eng, reqs, 32)
        counts.update(LAUNCHES)
        _no_capture(eng, warmed, f"{cfg.name} ring at 1.25")
    for a, b in zip(outs[4], outs[1]):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"{cfg.name} at 1.25: K=4 stream != K=1 "
                                 f"stream (request {a.request_id})")
    dropped, pairs = _count_drops(torch, lm, params, reqs, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    trace = _paged_trace(seed, cfg.vocab_size)
    pkw = dict(kw, cache_backend="paged", block_size=16,
               max_decode_steps=4)
    paged = {}
    for contended in (True, False):
        eng = ServingEngine(lm, params, **pkw)
        warmed = _warm(eng)
        torch.cuda.synchronize()
        reset_launches()
        paged[contended], _ = _serve_waves(eng, trace, 32, contended)
        counts.update(LAUNCHES)
        _no_capture(eng, warmed, f"{cfg.name} paged at 1.25")
        if contended:
            swaps = (eng.preemptions, eng.backend.swap_ins)
        elif eng.preemptions:
            raise AssertionError("the uncontended engine preempted")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if min(swaps) < 1:
        raise AssertionError(f"{cfg.name} at 1.25: nothing was swapped")
    for a, b in zip(paged[True], paged[False]):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"{cfg.name} at 1.25: swap-preempted stream"
                                 f" != uncontended (request {a.request_id})")
    gen = sum(len(r.output) for r in outs[4])
    print(f"  (d) {cfg.name} at capacity factor 1.25 [{smi}]: ring K=4 "
          f"streams equal K=1 ({gen} tokens); the admissions dropped "
          f"{dropped} of {pairs} (token, choice) pairs of real tokens; "
          f"paged (monolithic) swap-preempted streams equal the "
          f"uncontended ones ({swaps[0]} preemptions, {swaps[1]} swap-ins, "
          f"{sum(len(r.output) for r in paged[True])} tokens)")
    return dict(ring_tokens=gen, dropped_pairs=dropped, pairs=pairs,
                preemptions=swaps[0], swap_ins=swaps[1]), counts


def check_moe(torch, dev, seed, smi):
    """Phase 16: mixtral-8x22b and deepseek-v3-671b at full width (bf16,
    depths cut per ``MOE_DEPTH``), one model at a time, weights made on
    the card and freed before the next: (a) ``_moe_f32_vs_cpu``; (b) at
    the dropless factor E / k, prefill then decode against a full forward
    (``_moe_prefill_vs_forward``); (c) at that factor, phase 4's ring and
    phase 5's paged engine with their checks (K = 4 == K = 1, launches,
    greedy tokens against a teacher-forced forward; paged: preempted ==
    uncontended, the paths taken), every program captured by
    ``warm_compile`` and none in traffic; (d) ``_moe_default_factor``.
    Returns (records, launches on the served paths)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import LM

    out, launches = {}, collections.Counter()
    for name in MOE_MODELS:
        t_model = time.perf_counter()
        base = get_config(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        rec = out[name] = {"f32_vs_cpu": _moe_f32_vs_cpu(torch, dev, seed,
                                                         name, base)}
        torch.cuda.empty_cache()
        cfg = _cut_stages(base, MOE_DEPTH[name])
        m, cf = cfg.moe, _dropless(cfg)
        lm = LM(cfg, device=dev, capacity_factor=cf)
        t0 = time.perf_counter()
        params = lm.init(seed, on_device=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n, wbytes = _tree_numel(params), _weight_bytes(params)
        bound = wbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {name}: {cfg.num_layers} of {base.num_layers} layers at "
              f"full width (d_model {cfg.d_model}, {m.num_experts} experts "
              f"top-{m.num_experts_per_tok}, {cfg.num_heads} heads): "
              f"{n / 1e9:.3f} B values, made on the card in {init_s:.1f} s; "
              f"serving reads {wbytes / 1e9:.2f} GB bf16, the weight-read "
              f"bound per decode step {bound:.2f} ms (every expert: the "
              f"dropless decode reads all of them)")
        # E / k is a power of two: every capacity the served shapes meet
        # (prompt buckets, chunks, the (b) sequence) is the group's length
        for s in (1, 5, 24, 40, 128) + tuple(
                16 * 2 ** i for i in range(7)):
            if moe_lib.capacity(s, m.num_experts_per_tok, m.num_experts,
                                cf) != s:
                raise AssertionError(f"capacity at {s} tokens is not {s}")
        tokens = torch.from_numpy(np.random.default_rng(seed + 32).integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
        pf = _moe_prefill_vs_forward(torch, lm, params, tokens, 24)
        print(f"  (b) {name} bf16, dropless (factor {cf:g}): prefill+decode"
              f" vs forward: routes flipped at {pf['flipped']} of "
              f"{pf['tokens']} tokens x {pf['moe_layers']} MoE layers "
              f"(largest gap at a first flip "
              f"{pf['widest_flipped_gap']:.3f}, tol "
              f"{ROUTE_TOL['bfloat16']}); max|diff| {pf['err']:.3e} over "
              f"{pf['compared']} of {pf['positions']} positions (tol "
              f"{BF16_LOGIT_TOL}; max|logit| {pf['max_logit']:.2f})")
        if pf["bad"] or not (np.isfinite(pf["max_logit"])
                             and pf["err"] < BF16_LOGIT_TOL) \
                or pf["compared"] < pf["positions"] // 2:
            raise AssertionError(f"{name}: prefill+decode != forward")
        rec.update(values=n, weight_bytes=wbytes, init_s=init_s,
                   decode_bound_ms=bound, prefill_vs_forward=pf)
        rec["ring"], got = check_engine(torch, dev, seed, smi, lm, params,
                                        _trace(seed, cfg.vocab_size))
        launches.update(got)
        rec["paged"], got = check_paged_engine(torch, dev, seed, smi, lm,
                                               params)
        launches.update(got)
        for kind in ("ring", "paged"):
            print(f"  (c) {name} {kind} [{smi}]: "
                  f"{rec[kind]['tokens_per_s']:.1f} tokens/s; decode "
                  f"{rec[kind]['decode_ms_per_step']:.2f} ms per step of 8 "
                  f"slots against the {bound:.2f} ms weight-read bound "
                  f"({rec[kind]['decode_ms_per_step'] / bound:.2f}x); TTFT "
                  f"p50 {rec[kind]['ttft_ms_p50']:.1f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        rec["default_factor"], got = _moe_default_factor(
            torch, dev, seed, smi, cfg, params)
        launches.update(got)
        rec["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        rec["seconds"] = time.perf_counter() - t_model
        print(f"  {name}: peak device memory {rec['peak_gb']:.1f} GB above "
              f"the {held / 1e9:.1f} GB held before it; "
              f"{rec['seconds']:.1f} s")
        del lm, params
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


# -- phase 17: xLSTM and the modality frontends ----------------------------------

# logits of two f32 paths (the card's kernels and GEMMs vs the CPU's plain
# ones) at 4 layers: summation order only
MODAL_F32_TOL = 1e-4
# the xLSTM leg's engines: max_seq_len bounds the prompt buckets (16-256),
# and a bucket of S tokens captures S sequential sLSTM steps a layer
XLSTM_SEQ = 256
XLSTM_MAX_NEW = 32
MODAL_DECODE_STEPS = 32
VISION_TEXT = 100              # text tokens behind internvl2's 256-token prefix
AUDIO_PROMPT = 64              # musicgen's prompt frames (B, S, 4)
VISION_QUERIES = 16            # CascadeEngine.query's batch
_RECURRENT = ("rglru", "mlstm", "slstm")


def _modal_cfg(name, dtype, layers=None):
    """``name``'s config in ``dtype``, its stage repeats cut so that the
    model has ``layers`` layers (None: full depth), widths unchanged."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), param_dtype=dtype)
    if layers is None:
        return cfg
    st = cfg.stages[0]
    return _cut_stages(cfg, (layers // len(st.blocks),))


def _decode_read_bytes(lm, params) -> int:
    """Bytes of the weights one decode step reads: all but an untied
    embedding table (a step gathers B rows of it) and the vision projector
    (only the prefill reads it)."""
    skip = {"vision_proj"} | ({"embed"} if not lm.cfg.tie_embeddings
                               else set())
    return _weight_bytes({k: v for k, v in params.items() if k not in skip})


def _state_bytes(caches, lm) -> int:
    """Bytes of the recurrent state in ``caches`` (every slot)."""
    n = 0
    for st, c in zip(lm.cfg.stages, caches):
        for bi, bdef in enumerate(st.blocks):
            if bdef.mixer in _RECURRENT:
                n += sum(t.numel() * t.element_size()
                         for t in c[bi].values())
    return n


def _f32_vs_cpu(torch, dev, seed, name, batch):
    """``name`` cut to 4 layers at full width in f32: the card's forward
    (kernels, GEMMs in f32, TF32 off) against the CPU's plain forward on
    the same weights and ``batch`` (numpy arrays): max |diff| of the
    logits."""
    from repro_torch.models.model import LM

    cfg = _modal_cfg(name, "float32", layers=4)
    cpu = LM(cfg, device="cpu")
    cpu_params = cpu.init(seed)
    ref, _ = cpu.forward(cpu_params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    lm = LM(cfg, device=dev)
    got, _ = lm.forward(_to_device(cpu_params, dev),
                        {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()})
    err = (got.cpu() - ref).abs().max().item()
    print(f"  {name} 4 layers f32: card vs CPU plain forward max|diff| = "
          f"{err:.3e} (tol {MODAL_F32_TOL}; max|logit| "
          f"{ref.abs().max().item():.2f})")
    if not err < MODAL_F32_TOL:
        raise AssertionError(f"{name}: card forward != CPU forward (f32)")
    return lm, _to_device(cpu_params, dev), err


def _xlstm_padded_state(torch, dev, lm, params, tokens):
    """Two prompts right-padded to one 64-token bucket, with ``lengths``,
    against their unpadded prefills: the recurrent state and the logits
    at the last real token (the engines' admission path)."""
    lengths = (3, 37)
    padded = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    for row, length in enumerate(lengths):
        padded[row, :length] = tokens[0, :length]
    lp, caches = lm.prefill(params, {"tokens": padded}, cache_width=64,
                            lengths=torch.tensor(lengths, dtype=torch.int32,
                                                 device=dev))
    worst = logit_err = 0.0
    for row, length in enumerate(lengths):
        lu, ref = lm.prefill(params, {"tokens": tokens[:, :length]},
                             cache_width=64)
        worst = max(worst, _state_err(caches, ref, row, lm))
        logit_err = max(logit_err, (lp[row, length - 1] - lu[0, -1])
                        .abs().max().item())
    print(f"  padded prefill with lengths {lengths} vs unpadded: recurrent "
          f"state {worst:.3e} of max(1, |state|) (tol {STATE_TOL}), logits "
          f"at the last real token {logit_err:.3e} (tol {F32_LOGIT_TOL})")
    if not (worst < STATE_TOL and logit_err < F32_LOGIT_TOL):
        raise AssertionError("xlstm: padded prefill state != unpadded")
    return worst, logit_err


def _xlstm_trace(seed, vocab):
    """12 prompts of 2-224 tokens, none a bucket size but the 2, the
    sixth sampled at 0.8."""
    rng = np.random.default_rng(seed + 17)
    lengths = [2]
    while len(lengths) < 12:
        n = int(rng.integers(3, XLSTM_SEQ - XLSTM_MAX_NEW + 1))
        if n & (n - 1):
            lengths.append(n)
    lengths = [lengths[i] for i in rng.permutation(12)]
    return [(rng.integers(0, vocab, n).astype(np.int32),
             0.8 if i == 5 else 0.0) for i, n in enumerate(lengths)]


def _xlstm_engines(torch, seed, smi, lm, params):
    """xlstm-125m on the ring ``ServingEngine`` (8 slots, K = 4) and on
    ``DrainBatchEngine``: an eager leg (graphs off), the graphed leg (no
    capture in traffic; no kernel of the five launched, the counted
    programs; greedy tokens against a teacher-forced forward), a graphed
    K = 1 engine (equal streams) and a graphed drain engine (greedy
    streams equal, or part first at a near-tie)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import DrainBatchEngine, ServingEngine

    reqs = _xlstm_trace(seed, lm.cfg.vocab_size)
    kw = dict(batch_slots=8, max_seq_len=XLSTM_SEQ, seed=seed)
    state = _state_bytes(lm.init_cache(8, XLSTM_SEQ), lm)
    # a step reads the weights and reads and writes the recurrent state
    bound = (_decode_read_bytes(lm, params) + 2 * state) \
        / HBM_BYTES_PER_S * 1e3
    eager = ServingEngine(lm, params, max_decode_steps=4, **kw)
    eager._use_graphs = False
    eager.warm_compile()
    outs = {}
    outs["eager"], wall = _serve(eager, reqs, XLSTM_MAX_NEW)
    legs = {"eager": _leg(eager, outs["eager"], wall, bound)}
    eng = ServingEngine(lm, params, max_decode_steps=4, **kw)
    warmed = _warm(eng)
    n = _count_programs(eng)
    torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve(eng, reqs, XLSTM_MAX_NEW)
    launches = dict(LAUNCHES)
    _no_capture(eng, warmed, "xlstm")
    if any(launches.values()) or n["steps"] != eng.decode_steps \
            or n["admits"] != eng.admissions:
        raise AssertionError(f"xlstm: launches {launches} (the path has no "
                             f"kernel of the five) or program counts {n}")
    print(f"  launches on the xlstm path: {launches} (none expected: "
          f"repro's mLSTM and sLSTM are jnp); programs: {n['admits']} "
          f"admissions, {n['steps']} decode steps in runs {n['runs']}")
    one = ServingEngine(lm, params, max_decode_steps=1, **kw)
    _warm(one)
    ref, _ = _serve(one, reqs, XLSTM_MAX_NEW)
    for a, b in zip(out, ref):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"xlstm K=4 stream != K=1 stream (request "
                                 f"{a.request_id})")
    print(f"  K=4 streams equal K=1 streams token for token, both graphed "
          f"(prompt lengths {[len(p) for p, _ in reqs]})")
    checked, agree = _greedy_vs_forward(torch, lm, params, out, reqs,
                                        BF16_LOGIT_TOL)
    if checked == 0 or agree != checked:
        raise AssertionError("xlstm engine tokens disagree with the model")
    legs["graphed"] = _leg(eng, out, wall, bound)
    outs["graphed"] = out
    ab = _ab(torch, "xlstm", smi, lm, params, seed, reqs, legs, outs,
             BF16_LOGIT_TOL)
    admission_ms = time_admissions(torch, "xlstm", smi, eng)

    drain = DrainBatchEngine(lm, params, **kw)
    dwarm = _warm(drain)
    greedy = [i for i, (_, t) in enumerate(reqs) if t == 0]
    dout, dwall = _serve(drain, [reqs[i] for i in greedy], XLSTM_MAX_NEW)
    _no_capture(drain, dwarm, "xlstm drain")
    d_equal, d_parted = _parted_at_near_tie(
        torch, lm, params, seed, [reqs[i] for i in greedy], dout,
        [out[i] for i in greedy], BF16_LOGIT_TOL)
    if d_equal == 0:
        raise AssertionError("xlstm: no drain stream equals the continuous "
                             "one")
    dgen = sum(len(r.output) for r in dout)
    print(f"  drain [{smi}]: {len(dout)} greedy requests, {dgen} tokens in "
          f"{dwall:.3f} s = {dgen / dwall:.1f} tokens/s; streams: {d_equal} "
          f"equal the continuous engine's, {d_parted} part first at a "
          f"near-tie; warm_compile {drain.warm_compile_s:.2f} s, "
          f"{drain.graphs()} graphs, pool "
          f"{drain.graph_pool_bytes() / 1e6:.1f} MB")
    gen = sum(len(r.output) for r in out)
    return dict(
        requests=len(out), generated_tokens=gen, wall_s=wall,
        tokens_per_s=gen / wall, decode_bound_ms=bound, state_bytes=state,
        decode_ms_per_step=eng.decode_s / eng.decode_steps * 1e3,
        ttft_ms_p50=statistics.median(r.ttft_s * 1e3 for r in out),
        warm_compile_s=eng.warm_compile_s, graphs=eng.graphs(),
        pool_bytes=eng.graph_pool_bytes(), greedy_checked=checked,
        ab=ab, admission_ms=admission_ms, launches=launches,
        prompt_lengths=[len(p) for p, _ in reqs],
        drain=dict(tokens_per_s=dgen / dwall, equal=d_equal,
                   parted=d_parted, warm_compile_s=drain.warm_compile_s,
                   graphs=drain.graphs(),
                   pool_bytes=drain.graph_pool_bytes()))


def _check_xlstm(torch, dev, seed, smi):
    """17(a): xlstm-125m. 4 layers f32 against the CPU and a padded
    prefill's state; 12 layers bf16, prefill + decode against the forward;
    then its engines (``_xlstm_engines``)."""
    from repro_torch.models.model import LM

    name = "xlstm-125m"
    tokens = np.random.default_rng(seed + 18).integers(
        0, _modal_cfg(name, "float32").vocab_size, (1, 40)).astype(np.int32)
    f32_lm, f32_params, err = _f32_vs_cpu(torch, dev, seed, name,
                                          {"tokens": tokens})
    state_err, pad_logit_err = _xlstm_padded_state(
        torch, dev, f32_lm, f32_params, torch.from_numpy(tokens).to(dev))
    del f32_params
    lm = LM(_modal_cfg(name, "bfloat16"), device=dev)
    params = lm.init(seed, on_device=True)
    tok = torch.from_numpy(np.random.default_rng(seed + 19).integers(
        0, lm.cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
    perr, scale, _ = _prefill_vs_forward(lm, params, tok, 24)
    print(f"  {name} {lm.cfg.num_layers} layers bf16: prefill+decode vs "
          f"forward max|diff| = {perr:.3e} (tol {BF16_LOGIT_TOL}; max|logit| "
          f"{scale:.2f}); {_tree_numel(params) / 1e6:.1f} M parameters")
    if not (np.isfinite(scale) and perr < BF16_LOGIT_TOL):
        raise AssertionError("xlstm prefill+decode != forward (bf16)")
    stats = _xlstm_engines(torch, seed, smi, lm, params)
    print(f"  xlstm engine [{smi}]: {stats['tokens_per_s']:.1f} tokens/s; "
          f"decode {stats['decode_ms_per_step']:.3f} ms per step of 8 slots "
          f"against the {stats['decode_bound_ms']:.4f} ms bound (weights + "
          f"state {stats['state_bytes'] / 1e6:.1f} MB read and written); "
          f"TTFT p50 {stats['ttft_ms_p50']:.1f} ms; warm_compile "
          f"{stats['warm_compile_s']:.2f} s, {stats['graphs']} graphs, pool "
          f"{stats['pool_bytes'] / 1e6:.1f} MB")
    stats.update(f32_vs_cpu_err=err, padded_state_err=state_err,
                 padded_logit_err=pad_logit_err, prefill_decode_err=perr)
    return stats


def _modal_decode(torch, timer, smi, name, lm, params, batch, text_len):
    """Prefill ``batch`` at full depth, ``MODAL_DECODE_STEPS`` greedy
    decode steps, then one teacher-forced forward over the batch plus the
    generated tokens: the prefill's and the steps' logits equal the
    forward's within BF16_LOGIT_TOL, and each generated token (each
    codebook's, for audio) is the forward's argmax wherever its top-2
    margin exceeds that. Flash runs once a layer in the prefill, the ring
    kernel once a layer a step. Decode device ms a step, eager (CUDA
    events on every step, the median: the device waits on the host's
    launches) and as a CUDA graph of one step, against the weights'
    read."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    b = batch["tokens"].shape[0]
    prefix = lm.cfg.frontend.num_prefix_tokens if "image_embeds" in batch \
        else 0
    torch.cuda.synchronize()
    reset_launches()
    logits, caches = lm.prefill(params, batch, cache_width=prefix
                                + text_len + MODAL_DECODE_STEPS,
                                last_only=True)
    gen, times, seen = [], [], [logits[:, -1].float()]
    nxt = seen[0].argmax(-1)
    for t in range(MODAL_DECODE_STEPS):
        gen.append(nxt)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        logits, caches = lm.decode_step(params, caches, nxt[:, None].to(
            torch.int32), prefix + text_len + t)
        e.record()
        times.append((s, e))
        seen.append(logits[:, -1].float())
        nxt = seen[-1].argmax(-1)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    layers = lm.cfg.num_layers
    want = {"flash_attention": layers,
            "decode_attention": layers * MODAL_DECODE_STEPS,
            "paged_decode_attention": 0, "cascade_gate": 0, "rglru_scan": 0,
            **NO_BACKWARD}
    print(f"  {name}: launches over the prefill and {MODAL_DECODE_STEPS} "
          f"decode steps {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{name}: launches do not match the path")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times)
    gen = torch.stack(gen, 1)                        # (B, T) or (B, T, C)
    full = dict(batch, tokens=torch.cat([batch["tokens"], gen[:, :-1].to(
        torch.int32)], dim=1))
    fwd, _ = lm.forward(params, full)
    tail = fwd[:, prefix + text_len - 1:].float()
    del fwd
    # the prefill's logits and each step's but the last (whose input the
    # forward does not see) against the forward at the same positions
    err = (torch.stack(seen[:-1], 1) - tail).abs().max().item()
    top2 = torch.topk(tail, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > BF16_LOGIT_TOL
    bad = sure & (tail.argmax(-1) != gen)
    print(f"  {name}: prefill + {MODAL_DECODE_STEPS} decode steps vs the "
          f"teacher-forced forward: logits max|diff| {err:.3e} (tol "
          f"{BF16_LOGIT_TOL}; max|logit| {tail.abs().max().item():.2f}); "
          f"greedy tokens: {int(sure.sum())} of {sure.numel()} held (top-2 "
          f"margin > {BF16_LOGIT_TOL}), {int(bad.sum())} disagree")
    if not err < BF16_LOGIT_TOL or bool(bad.any()) or not bool(
            torch.isfinite(tail).all()):
        raise AssertionError(f"{name}: decode != teacher-forced forward")
    del tail
    # one more step as a CUDA graph (its cache writes land at one
    # position again and again: a timing, after the checks)
    tok = nxt[:, None].to(torch.int32)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lm.decode_step(params, caches, tok, prefix + text_len
                       + MODAL_DECODE_STEPS)
    graph_ms = timer(lambda i: graph.replay(), n=10)
    del graph
    bound = _decode_read_bytes(lm, params) / HBM_BYTES_PER_S * 1e3
    print(f"  {name} decode [{smi}]: {graph_ms:.3f} ms a step (B={b}) as a "
          f"CUDA graph, {step_ms:.3f} eager, against the {bound:.3f} ms "
          f"weight-read bound ({_decode_read_bytes(lm, params) / 1e9:.2f} "
          f"GB)")
    return dict(decode_ms_per_step=graph_ms, eager_decode_ms_per_step=step_ms,
                decode_bound_ms=bound, decode_vs_forward_err=err,
                held_tokens=int(sure.sum()), launches=launches)


def _check_vision(torch, timer, dev, seed, smi):
    """17(b): internvl2-2b. 4 layers f32 with ``image_embeds`` against the
    CPU; 24 layers bf16 through ``_modal_decode``; then
    ``CascadeEngine.query`` with the image over its 4-layer edge variant,
    compact and lockstep."""
    from repro_torch.cascade import CascadeLM, edge_variant
    from repro_torch.cascade.gate import (ESCALATE, confidence_from_logits,
                                          make_thresholds)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.frontend import synth_image_embeds
    from repro_torch.models.model import LM
    from repro_torch.serving import CascadeEngine

    name = "internvl2-2b"
    base = _modal_cfg(name, "float32")
    rng = np.random.default_rng(seed + 20)
    img = rng.standard_normal((1, base.frontend.num_prefix_tokens,
                               base.frontend.embed_dim)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    batch = {"tokens": rng.integers(0, base.vocab_size, (1, 40))
             .astype(np.int32), "image_embeds": img}
    _, _, err = _f32_vs_cpu(torch, dev, seed, name, batch)
    torch.cuda.empty_cache()

    lm = LM(_modal_cfg(name, "bfloat16"), device=dev)
    params = lm.init(seed, on_device=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    vb = {"tokens": torch.randint(0, lm.cfg.vocab_size, (2, VISION_TEXT),
                                  generator=gen, device=dev,
                                  dtype=torch.int32),
          "image_embeds": synth_image_embeds(gen, lm.cfg, 2)}
    stats = _modal_decode(torch, timer, smi, name, lm, params, vb,
                          VISION_TEXT)
    stats["f32_vs_cpu_err"] = err

    edge = LM(edge_variant(lm.cfg, layers=4), device=dev)
    ep = edge.init(seed + 1, on_device=True)
    qb = {"tokens": torch.randint(0, lm.cfg.vocab_size,
                                  (VISION_QUERIES, VISION_TEXT),
                                  generator=gen, device=dev,
                                  dtype=torch.int32),
          "image_embeds": synth_image_embeds(gen, lm.cfg, VISION_QUERIES)}
    el, _ = edge.forward(ep, qb, last_only=True)
    hi, lo = _tertiles(confidence_from_logits(el[:, 0]).cpu().numpy())
    cas = CascadeLM(edge, lm, thresholds=make_thresholds(hi, lo),
                    capacity_frac=0.5)
    tokens, extra = qb["tokens"].cpu().numpy(), {
        "image_embeds": qb["image_embeds"]}
    runs, query_launches = {}, collections.Counter()
    for how, compact in (("compact", True), ("lockstep", False)):
        eng = CascadeEngine(cas, ep, params, compact=compact)
        eng.query(tokens, extra=extra)                     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        out = eng.query(tokens, extra=extra)
        got = dict(LAUNCHES)
        want = {"cascade_gate": 1, "flash_attention": edge.cfg.num_layers
                + lm.cfg.num_layers, "decode_attention": 0,
                "paged_decode_attention": 0, "rglru_scan": 0, **NO_BACKWARD}
        if got != want:
            raise AssertionError(f"vision query {how}: launches {got} != "
                                 f"{want}")
        query_launches.update(got)
        routes = out["routes"]
        host = [int((routes == r).sum()) for r in range(3)]
        kern = [int(out[k]) for k in ("accept", "drop", "escalate")]
        if host != kern or min(host) == 0:
            raise AssertionError(f"vision query {how}: kernel counts {kern},"
                                 f" host counts {host}")
        runs[how] = out
        print(f"  {name} CascadeEngine.query ({how}, image_embeds in extra):"
              f" {VISION_QUERIES} queries x ({lm.cfg.frontend.num_prefix_tokens}"
              f" + {VISION_TEXT}) tokens in "
              f"{out['latency_s'] * 1e3:.1f} ms [{smi}]; accept/drop/"
              f"escalate {kern}; launches {got}")
    a, c = runs["compact"], runs["lockstep"]
    if not np.array_equal(a["routes"], c["routes"]) or \
            int((a["routes"] == ESCALATE).sum()) > cas.capacity(
                VISION_QUERIES):
        raise AssertionError("vision query: compact routes != lockstep")
    print(f"  compact routes equal lockstep routes on all {VISION_QUERIES} "
          f"queries; thresholds hi {hi:.6g}, lo {lo:.6g}")
    stats.update(query_compact_ms=a["latency_s"] * 1e3,
                 query_lockstep_ms=c["latency_s"] * 1e3,
                 routes=[int(x) for x in np.bincount(a["routes"],
                                                     minlength=3)])
    return stats, query_launches


def _check_audio(torch, timer, dev, seed, smi):
    """17(c): musicgen-medium. 4 layers f32 on a (1, 40, 4) grid against
    the CPU; 48 layers bf16 on a (2, AUDIO_PROMPT, 4) grid through
    ``_modal_decode``."""
    from repro_torch.models.frontend import synth_audio_tokens
    from repro_torch.models.model import LM

    name = "musicgen-medium"
    base = _modal_cfg(name, "float32")
    tokens = np.random.default_rng(seed + 22).integers(
        0, base.vocab_size, (1, 40, 4)).astype(np.int32)
    _, _, err = _f32_vs_cpu(torch, dev, seed, name, {"tokens": tokens})
    torch.cuda.empty_cache()
    lm = LM(_modal_cfg(name, "bfloat16"), device=dev)
    params = lm.init(seed, on_device=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    batch = {"tokens": synth_audio_tokens(gen, lm.cfg, 2, AUDIO_PROMPT)}
    stats = _modal_decode(torch, timer, smi, name, lm, params, batch,
                          AUDIO_PROMPT)
    stats["f32_vs_cpu_err"] = err
    return stats


def check_modalities(torch, timer, dev, seed, smi):
    """Phase 17: the last three assigned architectures at full width and
    depth: xlstm-125m (17(a)), internvl2-2b (17(b)), musicgen-medium
    (17(c)). Returns (stats, launches of the kernels on their main
    paths)."""
    launches = collections.Counter()
    out = {}
    t0 = time.perf_counter()
    out["xlstm-125m"] = _check_xlstm(torch, dev, seed, smi)
    out["xlstm-125m"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vision, query_launches = _check_vision(torch, timer, dev, seed, smi)
    vision["seconds"] = time.perf_counter() - t0
    out["internvl2-2b"] = vision
    launches.update(vision["launches"])
    launches.update(query_launches)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["musicgen-medium"] = _check_audio(torch, timer, dev, seed, smi)
    out["musicgen-medium"]["seconds"] = time.perf_counter() - t0
    launches.update(out["musicgen-medium"]["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    return out, dict(launches)


# -- phase 18: training --------------------------------------------------------

# flash's backward, kernel vs plain on the same inputs (both in f32 from
# them): bf16 per row (dq over (B, Sq), dk and dv over (B, Sk)) relative to
# the row's norm, where the output's bf16 rounding is ~2^-9 and a missed
# key tile or a band edge off by a tile is far more; a row's norm is
# floored at BWD_ROW_FLOOR of the median row's (the first query's dq
# cancels to 0 in exact arithmetic: it sees one key, so P = 1 and dP = D,
# and both sides keep only f32 rounding there); f32 absolute against
# max(1, max|plain|): summation order over up to G x Sq rows
BWD_ROW_REL_TOL = 1e-2
BWD_ROW_FLOOR = 1e-3
BWD_F32_TOL = 1e-4
# the forward kernel's log-sum-exp against the plain one, natural-log
# units, absolute (ex2.approx and another summation order)
LSE_TOL = 1e-3
# (label, B, S, H, KV, hd, window): the training path's attention layouts
BWD_SHAPES = (("smollm-135m", 8, 512, 9, 3, 64, None),
              ("qwen3-4b", 1, 512, 32, 8, 128, None),
              ("deepseek-v3-671b MLA", 1, 512, 128, 128, 192, None),
              ("recurrentgemma-9b", 1, 4096, 16, 1, 256, 2048))
TRAIN_STEPS = 30
TRAIN_BATCH = (8, 512)
# distinct TokenStream batches, taken in turn by the TRAIN_STEPS steps
# (numpy makes one in 1.5-3 s)
TRAIN_DISTINCT = 4
TRAIN_LR = 3e-3                # peak, after TRAIN_WARMUP steps, as the tests
TRAIN_WARMUP = 5
RESUME_AT = 10
# a resumed run's losses against the uninterrupted one's, relative: the
# embedding's backward adds by atomics, so the bits may differ
RESUME_TOL = 1e-3
# f32 loss and gradients, card vs CPU: the kernels, cuBLAS and the CPU's
# BLAS sum in other orders; loss relative, each gradient leaf against the
# leaf's max |g|
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
FAMILIES = (("GQA", "smollm-135m"), ("MLA+MoE+MTP", "deepseek-v3-671b"),
            ("RG-LRU", "recurrentgemma-9b"), ("xLSTM", "xlstm-125m"),
            ("vision", "internvl2-2b"), ("audio", "musicgen-medium"))


def _band_pairs(sq, sk, window):
    """(query, key) pairs a causal (windowed) attention with right-aligned
    queries computes."""
    q = np.arange(sq)[:, None] + sk - sq
    k = np.arange(sk)[None, :]
    ok = k <= q
    if window:
        ok &= k > q - window
    return int(ok.sum())


def _bwd_err(torch, label, got, ref, rows, dt):
    """|kernel - plain| of one gradient, per row (bf16) or absolute (f32);
    raises past the tolerance. Returns the max abs error."""
    diff = (got.float() - ref.float())
    err = diff.abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if dt == torch.bfloat16:
        num = diff.flatten(rows).norm(dim=-1)
        den = ref.float().flatten(rows).norm(dim=-1)
        floor = BWD_ROW_FLOOR * den[den > 0].median()
        rel = (num / den.clamp_min(floor)).max().item()
        ok = rel < BWD_ROW_REL_TOL
        detail = (f"max row |kernel - plain|/|plain| {rel:.3e} (rows' norms "
                  f"floored at {floor.item():.2e})")
    else:
        ok = err <= BWD_F32_TOL * scale
        detail = f"{err / scale:.3e} of max(1, |plain|)"
    print(f"    {label}: max|kernel - plain| {err:.3e}, {detail}")
    if not ok:
        raise AssertionError(f"{label} disagrees (tol: bf16 row "
                             f"{BWD_ROW_REL_TOL}, f32 {BWD_F32_TOL})")
    return err


def check_flash_bwd(torch, timer, dev, shapes=BWD_SHAPES):
    """Flash's backward kernels against ``flash_attention_bwd_plain`` at
    the training path's layouts (``shapes``), bf16 and f32, from the
    forward kernel's
    output and log-sum-exp; timed in bf16 against the plain version,
    SDPA's backward under autograd (K and V expanded to the query heads)
    and the bound (2.5 x the forward's flops in the band at the bf16
    peak, or the bytes: q, k, v, out, dout and lse read, dq, dk, dv
    written). Returns (the line's numbers at the first layout (smollm-
    135m's), every layout's)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_plain)

    gen = torch.Generator(device=dev).manual_seed(18)
    errs, times = [], {}
    for label, b, s, h, kv, hd, window in shapes:
        scale = hd ** -0.5

        def make(n, dt):
            q = torch.randn((n, b, s, h, hd), generator=gen, device=dev,
                            dtype=dt)
            k, v = (torch.randn((n, b, s, kv, hd), generator=gen, device=dev,
                                dtype=dt) for _ in range(2))
            do = torch.randn((n, b, s, h, hd), generator=gen, device=dev,
                             dtype=dt)
            fwd = [_launch(q[i], k[i], v[i], True, window, scale,
                           with_lse=True) for i in range(n)]
            return q, k, v, do, [o for o, _ in fwd], [l for _, l in fwd]

        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do, out, lse = make(1, dt)
            args = (q[0], k[0], v[0], out[0], lse[0], do[0])
            _, lse_ref = flash_attention_fwd_plain(q[0], k[0], v[0],
                                                   causal=True,
                                                   window=window)
            fin = torch.isfinite(lse_ref)
            lse_err = (lse[0][fin] - lse_ref[fin]).abs().max().item()
            got = flash_attention_bwd(*args, causal=True, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_bwd_plain(*args, causal=True,
                                            window=window)
            print(f"  flash_attention_bwd {label} B={b} S={s} H={h} KV={kv} "
                  f"hd={hd} window={window} {str(dt)[6:]}: forward lse vs "
                  f"plain {lse_err:.3e} (tol {LSE_TOL})")
            if not (lse_err < LSE_TOL and torch.equal(fin,
                                                      torch.isfinite(lse[0]))):
                raise AssertionError(f"flash lse {label} disagrees")
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                e = _bwd_err(torch, name, g, r, 2, dt)
                if dt == torch.bfloat16:
                    errs.append(e)
            del q, k, v, do, out, lse, args, got, ref
        # bf16 timing: distinct inputs beyond the L2 where they fit
        n_in = 4 if s <= 512 else 1
        q, k, v, do, out, lse = make(n_in, torch.bfloat16)

        def kern(i):
            j = i % n_in
            return flash_attention_bwd(q[j], k[j], v[j], out[j], lse[j],
                                       do[j], causal=True, window=window)

        def plain(i):
            j = i % n_in
            return flash_attention_bwd_plain(q[j], k[j], v[j], out[j],
                                             lse[j], do[j], causal=True,
                                             window=window)

        qt, kt, vt = (x[0].transpose(1, 2).repeat_interleave(
            h // x.shape[3], dim=1).detach().requires_grad_()
            for x in (q, k, v))
        mask = None
        if window:
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None)
        dot = do[0].transpose(1, 2)

        def library(i):
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        n = 25 if s <= 512 else 5
        ms, plain_ms, lib_ms = (timer(kern, n=n), timer(plain, n=3),
                                timer(library, n=n))
        pairs = _band_pairs(s, s, window)
        flops = 10 * pairs * h * hd * b
        # q, out, dout, k, v and lse read; dq (q's size), dk, dv written
        nbytes = (_nbytes(q[0], out[0], do[0], lse[0]) + _nbytes(q[0])
                  + 2 * _nbytes(k[0], v[0]))
        bound, by = _bound_ms(nbytes, flops)
        times[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=lib_ms)
        print(f"  flash_attention_bwd {label} bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {nbytes} B, {flops} flop); "
              f"{flops / ms / 1e9:.1f} TFLOP/s in the band")
        del q, k, v, do, out, lse, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    return (dict(max_abs_err=max(errs), **times[shapes[0][0]]), times)


def check_rglru_bwd(torch, timer, dev,
                    shapes=((1, 512, 4096), (1, 4096, 4096))):
    """The scan's reverse mode against ``rglru_scan_bwd_plain`` at the
    hybrid's training widths (``shapes``: B 1, W 4096; S 512 and 4096),
    f32, from the
    forward kernel's states with h0 != 0 and both output gradients; equal
    bits on a repeated call after a forward launch on the same stream;
    timed against the plain loop and the bound (a, h and dh read, da and
    db written: 20 bytes an element). Returns (the line's numbers at the
    last shape, (1, 4096, 4096), every shape's)."""
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                rglru_scan_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(19)
    errs, times = [], {}
    for b, s, w in shapes:
        n_in = 4 if s <= 512 else 2

        def make():
            a = 0.8 + 0.1999 * torch.rand((n_in, b, s, w), generator=gen,
                                          device=dev)
            x, dh = (torch.randn((n_in, b, s, w), generator=gen, device=dev)
                     for _ in range(2))
            h0, dl = (torch.randn((n_in, b, w), generator=gen, device=dev)
                      for _ in range(2))
            hs = [rglru_scan(a[i], x[i], h0[i])[0] for i in range(n_in)]
            return a, hs, h0, dh, dl

        a, hs, h0, dh, dl = make()
        args = (a[0], hs[0], h0[0], dh[0], dl[0])
        got = rglru_scan_bwd(*args)
        rglru_scan(a[1], dh[1], h0[1])        # the stream's state moves on
        again = rglru_scan_bwd(*args)
        torch.cuda.synchronize()
        ref = rglru_scan_bwd_plain(*args)
        # db and dh0 against max(1, |plain|); da_t = g_t h_{t-1} carries g's
        # error times h_{t-1}: against max(1, |h_{t-1}|) max(1, |g_t|)
        prev = torch.cat([h0[0][:, None], hs[0][:, :-1]], dim=1)
        scales = (prev.abs().clamp_min(1) * ref[1].abs().clamp_min(1),
                  ref[1].abs().clamp_min(1), ref[2].abs().clamp_min(1))
        rel = max(((g - r).abs() / sc).max().item()
                  for g, r, sc in zip(got, ref, scales))
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"  rglru_scan_bwd ({b}, {s}, {w}) f32: max|kernel - plain| "
              f"{err:.3e}, {rel:.3e} of max(1, |plain|) (da: of max(1, "
              f"|h_(t-1)|) max(1, |db|); tol {RGLRU_TOL}); repeated call "
              f"equal bits: {same}")
        if not (rel <= RGLRU_TOL and same):
            raise AssertionError(f"rglru_scan_bwd ({b}, {s}, {w}) disagrees")
        errs.append(err)

        def kern(i):
            j = i % n_in
            return rglru_scan_bwd(a[j], hs[j], h0[j], dh[j], dl[j])

        def plain(i):
            j = i % n_in
            return rglru_scan_bwd_plain(a[j], hs[j], h0[j], dh[j], dl[j])

        ms, plain_ms = timer(kern), timer(plain, n=2)
        nbytes = 20 * b * s * w + 12 * b * w
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * b * s * w / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        times[b, s, w] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, library_ms=None)
        print(f"  rglru_scan_bwd ({b}, {s}, {w}) f32: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library: none, bound {bound:.4f} ms "
              f"({by}; {nbytes} B)")
        del a, hs, h0, dh, dl, args, got, again, ref
    return (dict(max_abs_err=max(errs), **times[shapes[-1]]),
            {"x".join(map(str, k)): r for k, r in times.items()})


def _train_launches(cfg, steps):
    """The launches ``steps`` train steps make: each attention (or MLA) and
    RG-LRU layer's forward kernel twice (the forward and its recomputation
    in the backward pass), its backward kernel once; the MTP block (not
    rematerialised) once each."""
    n = collections.Counter()
    for st in cfg.stages:
        for bdef in st.blocks:
            n[bdef.mixer] += st.repeat
    attn, rec, mtp = n["attn"] + n["mla"], n["rglru"], int(cfg.mtp_depth > 0)
    return {"flash_attention": steps * (2 * attn + mtp),
            "flash_attention_bwd": steps * (attn + mtp),
            "rglru_scan": steps * 2 * rec, "rglru_scan_bwd": steps * rec,
            "decode_attention": 0, "paged_decode_attention": 0,
            "cascade_gate": 0}


def _profile_steps(torch, step, step_ms, n=2):
    """``n`` calls of ``step`` under ``torch.profiler``: the device's busy
    ms a step, the idle share against the unprofiled ``step_ms``, the
    device events a step and the eight with the most device time a
    step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3 / n
    return dict(busy_ms=busy, idle_share=1 - busy / step_ms,
                launches=sum(r[1] for r in rows) // n,
                top=[(name[:40], us / 1e3 / n) for us, _, name in rows[:8]])


def check_train_smollm(torch, dev, seed, smi):
    """Phase 18(b): smollm-135m at full width and depth in bf16 through
    ``Trainer.fit`` on ``TRAIN_DISTINCT`` ``TokenStream`` batches in turn;
    then a fresh ``Trainer`` restores the step-10 checkpoint and runs the
    remaining steps on the same batches."""
    import itertools
    import shutil
    import tempfile

    from repro_torch.analysis import param_counts, step_record
    from repro_torch.analysis.roofline import (format_table,
                                               roofline_from_record)
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.training import Trainer
    from repro_torch.training.train_loop import to_device

    cfg = get_config("smollm-135m")
    b, s = TRAIN_BATCH
    t0 = time.perf_counter()
    made = list(itertools.islice(
        TokenStream(cfg.vocab_size, seed=seed).batches(b, s, seed),
        TRAIN_DISTINCT))
    data_s = time.perf_counter() - t0
    batches = [made[i % TRAIN_DISTINCT] for i in range(TRAIN_STEPS)]
    sched = linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tr = Trainer(LM(cfg, device=dev), sched, ckpt_dir=f"{root}/run",
                     log_every=1, ckpt_every=RESUME_AT)
        params, opt = tr.init_state(seed)
        n_params = _tree_numel(params)
        n_active = param_counts("smollm-135m")["active"]
        if n_active != n_params:
            raise AssertionError(f"param_counts gives {n_active} active "
                                 f"parameters, the tree holds {n_params}")
        events, step = [], tr.train_step

        def timed(p, o, batch):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = step(p, o, batch)
            end.record()
            events.append((start, end))
            return out

        tr.train_step = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        params, opt = tr.fit(params, opt, iter(batches), TRAIN_STEPS,
                             echo=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = _train_launches(cfg, TRAIN_STEPS)
        step_ms = statistics.median(a.elapsed_time(e) for a, e in events[2:])
        first = to_device(batches[0], dev)
        prof = _profile_steps(torch, lambda: step(params, opt, first),
                              step_ms)
        roof = roofline_from_record(step_record(
            lambda: step(params, opt, first), arch="smollm-135m",
            mode="train", seq_len=s, global_batch=b, params=params,
            device=dev, shape=f"B{b} S{s}"))
        losses = [m["loss"] for m in tr.history]
        tok_s = b * s / step_ms * 1e3
        share = 6 * n_active * b * s / (step_ms / 1e3) / BF16_FLOPS_PER_S
        print(f"  smollm-135m train, {cfg.num_layers} layers, B={b} S={s}, "
              f"bf16 params, AdamW f32, lr {TRAIN_LR} (warmup "
              f"{TRAIN_WARMUP}) [{smi}]: {TRAIN_STEPS} steps in {wall:.2f} s "
              f"({TRAIN_DISTINCT} batches in turn, made beforehand in "
              f"{data_s:.1f} s); "
              f"{step_ms:.2f} ms"
              f" per train step (CUDA events, median of steps 2..), "
              f"{tok_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, "
              f"6 N D / step time = {share:.4f} of 989 TFLOP/s (N = "
              f"{n_params})")
        print(f"    two more steps under torch.profiler: device busy "
              f"{prof['busy_ms']:.2f} ms a step (idle share "
              f"{prof['idle_share']:.3f} of the unprofiled step), "
              f"{prof['launches']} device events a step; device ms a step "
              f"by kernel: " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in prof["top"]))
        print(f"    roofline of one step (analysis.step_record: "
              f"FlopCounterMode + the kernels' FLOPs; bytes the params' "
              f"alone, a lower bound) [{smi}]:")
        for line in format_table([roof]).splitlines():
            print(f"      {line}")
        top = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
        print(f"    the step's largest term {top:.3f} ms against "
              f"{step_ms:.2f} ms measured; FLOPs counted "
              f"{roof['hlo_flops_total']:.4g}, 6 N "
              f"D {roof['model_flops']:.4g} (useful ratio "
              f"{roof['useful_ratio']:.3f})")
        print("    loss by step: " + ", ".join(f"{x:.3f}" for x in losses))
        print(f"    launches {launches} (expected {want}: flash forward "
              f"twice a layer a step under remat, backward once)")
        if not all(np.isfinite(losses)):
            raise AssertionError("smollm-135m train: a loss is not finite")
        if not losses[-1] < losses[0] - 1.0:
            raise AssertionError("smollm-135m train: the loss did not fall "
                                 "by 1.0")
        if launches != want:
            raise AssertionError("smollm-135m train: launches do not match "
                                 "the path")
        # resume: only the step-10 checkpoint in a fresh directory
        os.makedirs(f"{root}/resume")
        shutil.copy(f"{root}/run/step_{RESUME_AT}.npz", f"{root}/resume")
        tr2 = Trainer(LM(cfg, device=dev), sched, ckpt_dir=f"{root}/resume",
                      log_every=1, ckpt_every=0)
        p2, o2 = tr2.restore_or_init(seed + 1)   # other weights, replaced
        if int(o2.step) != RESUME_AT:
            raise AssertionError(f"restored step {int(o2.step)}")
        reset_launches()
        tr2.fit(p2, o2, iter(batches[RESUME_AT:]), TRAIN_STEPS - RESUME_AT,
                echo=False)
        resumed = [m["loss"] for m in tr2.history]
        rel = max(abs(x - y) / abs(y)
                  for x, y in zip(resumed, losses[RESUME_AT:]))
        print(f"    resumed from step {RESUME_AT} by a fresh "
              f"Trainer.restore_or_init: losses {rel:.3e} relative of the "
              f"uninterrupted run's (tol {RESUME_TOL})")
        if not rel < RESUME_TOL:
            raise AssertionError("the resumed run departs from the "
                                 "uninterrupted one")
        more = dict(LAUNCHES)
        for name in launches:
            launches[name] += more[name]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(steps=TRAIN_STEPS, batch=b, seq=s, ms_per_step=step_ms,
                profile=prof, tokens_per_s=tok_s, peak_bytes=peak,
                flops_share=share, roofline=roof,
                n_params=n_params, losses=losses, resumed_losses=resumed,
                resume_rel=rel, wall_s=wall, data_s=data_s), launches


def _card_vs_cpu_step(torch, dev, label, cfg, params, batch):
    """Loss, its parts and every gradient leaf of one f32 train step on the
    card against the CPU, on the same weights (made on the card, copied)
    and ``batch`` (numpy); MoE routes compared first (equal expert sets).
    Returns (loss rel err, worst leaf err / max|g|, the card's launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.training import loss_and_grads
    from repro_torch.utils.tree import flat_paths

    results = []
    for where in ("cpu", dev):
        lm = LM(cfg, device=where)
        p = _to_device(params, where)
        bt = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        reset_launches()
        with _Routes(torch) as routes:
            loss, metrics, grads = loss_and_grads(lm, p, bt)
        if where != "cpu":
            torch.cuda.synchronize()
        results.append((loss, metrics, flat_paths(grads), routes.calls,
                        dict(LAUNCHES)))
        del p, bt
    (lc, mc, gc_, rc, _), (lg, mg, gg, rg, launches) = results
    if len(rc) != len(rg) or any(not torch.equal(a.cpu(), b)
                                 for (a, _), (b, _) in zip(rg, rc)):
        raise AssertionError(f"{label}: the card routes MoE tokens to "
                             f"other experts than the CPU")
    gap = min((g.min().item() for _, g in rc), default=None)
    rel = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])),
                                                     1e-6)
              for k in mc)
    rel = max(rel, abs(float(lg) - float(lc)) / abs(float(lc)))
    worst, where_ = 0.0, None
    for key, ref in gc_.items():
        scale = ref.abs().max().item()
        e = (gg[key].cpu() - ref).abs().max().item() / max(scale, 1e-30)
        if e > worst:
            worst, where_ = e, key
    print(f"  {label}: loss {float(lg):.5f} (card) vs {float(lc):.5f} "
          f"(CPU), parts {sorted(mc)}: {rel:.3e} relative (tol "
          f"{TRAIN_LOSS_TOL}); gradients of {len(gc_)} leaves: worst "
          f"{worst:.3e} of the leaf's max|g| at {where_} (tol "
          f"{TRAIN_GRAD_TOL})" + (f"; MoE routes equal, least top-k gap "
                                  f"{gap:.3e}" if gap is not None else ""))
    if not (rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{label}: the card's step departs from the "
                             f"CPU's")
    return rel, worst, launches


def check_train_hybrid(torch, dev, seed):
    """Phase 18(c): one (rec, rec, attn) repeat of recurrentgemma-9b at
    full width in f32, B 1, S 256 (the scan in several chunks): loss and
    gradients on the card against the CPU, through both backward
    kernels."""
    from repro_torch.models.model import LM

    cfg = _cut_stages(_hybrid_cfg("float32"), (1,))
    params = _to_device(LM(cfg, device=dev).init(seed, on_device=True),
                        "cpu")
    rng = np.random.default_rng(seed + 18)
    tokens = rng.integers(0, cfg.vocab_size, (1, 257)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    rel, worst, launches = _card_vs_cpu_step(
        torch, dev, f"recurrentgemma-9b 1 repeat ({cfg.num_layers} layers, "
        f"{_tree_numel(params) / 1e9:.2f} B values) f32 B=1 S=256", cfg,
        params, batch)
    want = _train_launches(cfg, 1)
    print(f"    launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("hybrid train step: launches do not match")
    return dict(loss_rel=rel, grad_worst=worst), launches


def check_train_families(torch, dev, seed, smi):
    """Phase 18(d): each mixer family's ``.reduced()`` config, f32: one
    train step's loss and gradients on the card against the CPU, then the
    whole step (AdamW) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.training import make_train_step
    from repro_torch.utils.tree import tree_leaves

    stats, total = {}, collections.Counter()
    for label, name in FAMILIES:
        cfg = get_config(name).reduced()
        params = LM(cfg, device="cpu").init(seed)
        rng = np.random.default_rng(seed + 19)
        fe = cfg.frontend
        shape = (2, 33, fe.num_codebooks) if fe.kind == "audio" else (2, 33)
        tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if fe.kind == "vision":
            img = rng.standard_normal((2, fe.num_prefix_tokens,
                                       fe.embed_dim)).astype(np.float32)
            batch["image_embeds"] = img / np.linalg.norm(img, axis=-1,
                                                         keepdims=True)
        rel, worst, launches = _card_vs_cpu_step(
            torch, dev, f"{label} ({cfg.name}) f32", cfg, params, batch)
        lm = LM(cfg, device=dev)
        p = _to_device(params, dev)
        step = make_train_step(lm, linear_warmup_cosine(3e-4, 10, 50))
        reset_launches()
        p, _, m = step(p, adamw_init(p), {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})
        torch.cuda.synchronize()
        for k, v in LAUNCHES.items():
            launches[k] += v
        want = _train_launches(cfg, 2)
        if launches != want or not all(bool(torch.isfinite(t).all())
                                        for t in tree_leaves(p)):
            raise AssertionError(f"{label}: launches {launches} != {want}, "
                                 f"or a stepped weight is not finite")
        stats[label] = dict(loss_rel=rel, grad_worst=worst,
                            step_loss=float(m["loss"]))
        total.update(launches)
    print(f"    launches of the 12 steps (loss and gradients, then the "
          f"whole step, per family): {dict(total)}")
    return stats, dict(total)


def check_training(torch, timer, dev, seed, smi):
    """Phase 18: returns (the kernels-line numbers of the two backward
    kernels, the phase's record, its launches)."""
    results, launches = {}, collections.Counter()
    print("  (a) backward kernels vs plain versions")
    results["flash_attention_bwd"], flash_times = check_flash_bwd(
        torch, timer, dev)
    results["rglru_scan_bwd"], scan_times = check_rglru_bwd(torch, timer,
                                                            dev)
    torch.cuda.empty_cache()
    print("  (b) smollm-135m, full width and depth, bf16, Trainer.fit")
    smollm, got = check_train_smollm(torch, dev, seed, smi)
    launches.update(got)
    gc.collect()
    torch.cuda.empty_cache()
    print("  (c) recurrentgemma-9b, one (rec, rec, attn) repeat, full width, "
          "f32, card vs CPU")
    hybrid, got = check_train_hybrid(torch, dev, seed)
    launches.update(got)
    gc.collect()
    torch.cuda.empty_cache()
    print("  (d) each mixer family's reduced config, f32, card vs CPU")
    families, got = check_train_families(torch, dev, seed, smi)
    launches.update(got)
    return results, dict(flash_bwd=flash_times, scan_bwd=scan_times,
                         smollm=smollm, hybrid=hybrid,
                         families=families), dict(launches)


# -- phase 19: tensor-parallel serving ------------------------------------------

# 19(b): (model, layers served at full width, ranks) sharing one card over
# gloo: qwen3-4b's 32 heads and 8 KV heads split 2 ways; glm4-9b's 32 heads
# split 4 ways over 2 KV heads that every rank keeps whole (each rank's 8
# query heads read one of them in place); qwen3 cut to 4 layers and glm4
# to 1, to keep the script inside its time limit on a slower host
TP_SPLITS = (("qwen3-4b", 4, 2), ("glm4-9b", 1, 4))
TP_MAX_NEW = 16
TP_SEQ = 512


def _tp_trace(seed, vocab):
    """8 prompts of 16-400 tokens, the last sampled at 0.8."""
    rng = np.random.default_rng(seed + 40)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32),
             0.8 if i == 7 else 0.0)
            for i, n in enumerate(rng.integers(16, 401, 8))]


def _tp_engine(lm, params, seed, backend, mesh=None):
    """Phase 4's ring engine or phase 5's paged one (K = 4), at
    ``TP_SEQ``."""
    from repro_torch.serving import ServingEngine

    kw = dict(batch_slots=8, max_seq_len=TP_SEQ, seed=seed,
              max_decode_steps=4, mesh=mesh)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=16, chunk_tokens=128)
    return ServingEngine(lm, params, **kw)


def _tp_kv_bytes(eng):
    """(this rank's K/V bytes, its position bytes, the engine's global
    bytes, its per-device bytes)."""
    from repro_torch.serving.kv_cache import _leaves

    kv = pos = 0
    for key, t in _leaves(eng._cache_state["caches"]):
        n = t.numel() * t.element_size()
        if key in ("k", "v"):
            kv += n
        else:
            pos += n
    return kv, pos, eng.hbm_bytes(), eng.hbm_bytes_per_device()


def _tp_serve(torch, eng, reqs, graphed):
    """Serve ``reqs`` (``TP_MAX_NEW`` tokens each) with the launch counters
    zeroed just before: graphed after ``warm_compile`` (and no capture
    during traffic: the graph pool's bytes the same after the traffic as
    after the warm-up), or eager. Returns (requests, wall s, launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    cuda = eng.device.type == "cuda"
    if graphed:
        warmed = _warm(eng)
        pool = eng.graph_pool_bytes()
    else:
        eng._use_graphs = False
    if cuda:
        torch.cuda.synchronize()
    reset_launches()
    out, wall = _serve(eng, reqs, TP_MAX_NEW)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if graphed:
        _no_capture(eng, warmed, "tensor-parallel engine")
        if eng.graph_pool_bytes() != pool:
            raise AssertionError(f"the graph pool grew during traffic: "
                                 f"{pool} -> {eng.graph_pool_bytes()} B")
    eng.assert_invariants()
    return out, wall, launches


def _tp_rank(rank, out_dir, cfg, seed, reqs, graphed, device="cuda"):
    """One rank of a phase-19 mesh (spawned): ``cfg`` made on its device
    from ``seed`` (the parent's values), both engines on the mesh, its
    streams, launches, K/V bytes and times to ``out_dir``. Under NCCL each
    rank has its own card; over gloo every rank shares card 0 (or, to
    rehearse on the CPU, ``device="cpu"``)."""
    import torch

    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.models.model import LM

    world = torch.distributed.get_world_size()
    if device == "cuda":
        nccl = torch.distributed.get_backend() == "nccl"
        device = f"cuda:{rank}" if nccl else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh = make_host_mesh(world, device=dev)
    lm = LM(cfg, device=dev)
    params = lm.init(seed, on_device=True)
    rec = {}
    for backend in ("ring", "paged"):
        eng = _tp_engine(lm, params, seed, backend, mesh)
        if backend == "ring":
            del params          # the engine keeps this rank's shards
        before = dict(COLLECTIVES)
        out, wall, launches = _tp_serve(torch, eng, reqs, graphed)
        since = tally(COLLECTIVES, before=before)
        step = eng.decode_s / eng.decode_steps * 1e3
        rec[backend] = dict(
            streams=[r.output.tolist() for r in out], wall_s=wall,
            tokens_per_s=sum(len(r.output) for r in out) / wall,
            decode_ms_per_step=step, launches=launches,
            all_reduces=since["all_reduce"],
            all_gathers=since["all_gather"],
            kv_bytes=_tp_kv_bytes(eng), graphs=eng.graphs(),
            mesh_devices=eng.metrics()["mesh_devices"])
        if backend == "ring":
            params = eng.params
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _spawn_ranks(fn, ranks, args, backend, timeout_s=600):
    """Spawn ``ranks`` processes of ``fn(rank, out_dir, *args)``, each
    writing its record to ``out_dir``; the records in rank order."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    out_dir = tempfile.mkdtemp(prefix="tp_")
    spawn(fn, ranks, args=(out_dir,) + tuple(args), backend=backend,
          timeout_s=timeout_s)
    recs = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _tp_mesh(cfg, ranks, seed, reqs, graphed, backend, device="cuda"):
    """Spawn ``ranks`` processes of ``_tp_rank``; their records."""
    return _spawn_ranks(_tp_rank, ranks, (cfg, seed, reqs, graphed, device),
                        backend)


def _tp_hold(torch, label, smi, lm, params, seed, reqs, recs, base, cfg,
             ranks):
    """Hold a spawned mesh's records: every rank's streams equal rank 0's
    bit for bit; rank 0's equal ``base`` (the ``mesh=None`` engine's on the
    same trace) or part first at a near-tie (``BF16_LOGIT_TOL``); the K/V
    bytes a rank holds are 1/N of the whole where the KV heads divide
    (whole on every rank where they do not); the launches per rank."""
    out = {}
    for backend in ("ring", "paged"):
        mine = [rec[backend] for rec in recs]
        for r, rec in enumerate(mine[1:], 1):
            if rec["streams"] != mine[0]["streams"]:
                raise AssertionError(f"{label} {backend}: rank {r}'s "
                                     f"streams differ from rank 0's")
        equal, parted = _quiet(
            _parted_at_near_tie, torch, lm, params, seed, reqs,
            _as_requests(mine[0]["streams"]), _as_requests(base[backend]),
            BF16_LOGIT_TOL)
        kv, pos, whole, per_dev = mine[0]["kv_bytes"]
        split = cfg.num_kv_heads % ranks == 0
        if per_dev != kv + pos or (kv * ranks + pos == whole) != split \
                or (not split and per_dev != whole):
            raise AssertionError(f"{label} {backend}: K/V bytes {kv} a rank"
                                 f" + {pos} positions against {whole} whole")
        for r, rec in enumerate(mine):
            print(f"  {label} {backend}, rank {r} [{smi}]: "
                  f"{rec['tokens_per_s']:.1f} tokens/s; decode "
                  f"{rec['decode_ms_per_step']:.2f} ms per step; "
                  f"{rec['all_reduces']} all-reduces, {rec['all_gathers']} "
                  f"all-gathers; graphs "
                  f"{rec['graphs']}; launches {rec['launches']}")
        print(f"  {label} {backend}: the {ranks} ranks' streams are equal "
              f"bit for bit; against mesh=None {equal} equal, {parted} "
              f"part first at a near-tie (margin <= {BF16_LOGIT_TOL}); K/V "
              f"{kv / 1e6:.1f} MB a rank of {(whole - pos) / 1e6:.1f} MB "
              f"({'1/%d' % ranks if split else 'whole: the KV heads do not'
               ' divide'}), positions {pos / 1e6:.2f} MB on every rank")
        if mine[0]["mesh_devices"] != ranks or not any(
                mine[0]["launches"].values()):
            raise AssertionError(f"{label} {backend}: no kernel launched")
        out[backend] = dict(ranks=mine, equal=equal, parted=parted)
    return out


def _tp_base(torch, seed, lm, params, reqs, graphed, bound=None,
             backends=("ring", "paged")):
    """The ``mesh=None`` engines on ``reqs``: their streams, launches and,
    with ``bound``, their ``_leg`` records."""
    base, launches, legs = {}, {}, {}
    for backend in backends:
        eng = _tp_engine(lm, params, seed, backend)
        out, wall, launches[backend] = _tp_serve(torch, eng, reqs, graphed)
        base[backend] = [r.output.tolist() for r in out]
        if bound is not None:
            legs[backend] = _leg(eng, out, wall, bound)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return base, launches, legs


def _step_collectives(cfg):
    """(all-reduces, all-gathers) a decode step issues on a mesh, by the
    code, where every dimension splits (a mesh of one): the embedding's
    reduce; one for each attention, MLA and mLSTM mixer, two for an RG-LRU
    (its gates' partials and its ``w_out``), one for an sLSTM (its GeGLU's
    ``w_down``) beside its gather of the head outputs; one for each dense
    or MoE MLP (an MoE layer's routed and shared partials reduce once)
    and a gather of each MoE layer's router logits; a gather of the
    logits."""
    reduces = gathers = 1
    for st in cfg.stages:
        for b in st.blocks:
            reduces += st.repeat * ((2 if b.mixer == "rglru" else 1)
                                    + (b.mlp != "none"))
            gathers += st.repeat * ((b.mixer == "slstm") + (b.mlp == "moe"))
    return reduces, gathers


def _nccl_one(torch, dev, seed, smi, lm, params, reqs, bound,
              backends=("ring", "paged")):
    """``lm`` on a one-rank NCCL mesh, on ``backends``, graphed, against
    ``mesh=None`` in the same call: streams and launches bit for bit
    (every collective the identity), the collectives inside each captured
    program (``_step_collectives`` a decode step), tokens/s and decode ms
    per step side by side. ``params`` serve both legs (a one-rank
    placement keeps every leaf as it is). Returns (record, launches of
    the mesh legs, the mesh=None streams)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_host_mesh, tally

    name = lm.cfg.name
    base, none_launches, none_legs = _tp_base(torch, seed, lm, params, reqs,
                                              True, bound, backends)
    reduces, gathers = _step_collectives(lm.cfg)
    rec, total = {}, collections.Counter()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_host_mesh(1, device=dev)
        for backend in backends:
            eng = _tp_engine(lm, params, seed, backend, mesh)
            out, wall, launches = _tp_serve(torch, eng, reqs, True)
            total.update(launches)
            got = [r.output.tolist() for r in out]
            if got != base[backend]:
                raise AssertionError(f"{name} {backend}: the NCCL mesh "
                                     f"of one != mesh=None")
            if launches != none_launches[backend]:
                raise AssertionError(f"{name} {backend}: launches "
                                     f"{launches} != mesh=None's "
                                     f"{none_launches[backend]}")
            for key, prog in eng._programs.items():
                got = tally(prog.collectives)
                n, g = got["all_reduce"], got["all_gather"]
                want = ((reduces * key[1], gathers * key[1])
                        if key[0] == "decode" else (n, g))
                if (n, g) != want or n == 0 or g == 0:
                    raise AssertionError(
                        f"program {key}: {n} all-reduces and {g} all-gathers"
                        f" captured (want {want}, each > 0)")
            legs = {"mesh=None": none_legs[backend],
                    "NCCL mesh of 1": _leg(eng, out, wall, bound)}
            for label, x in legs.items():
                print(f"  {name} {backend}, {label} [{smi}]: "
                      f"{x['tokens_per_s']:.1f} tokens/s; decode "
                      f"{x['decode_ms_per_step']:.2f} ms per step "
                      f"({x['bound_ratio']:.1f}x the {bound:.2f} ms "
                      f"weight-read bound); prefill {x['prefill_ms']:.1f} "
                      f"ms; warm_compile {x['warm_compile_s']:.2f} s, "
                      f"{x['graphs']} graphs")
            print(f"  {name} {backend}: the mesh streams equal mesh=None's"
                  f" bit for bit; {len(eng._programs)} programs captured, "
                  f"each with its collectives inside ({reduces} all-"
                  f"reduces and {gathers} all-gather{'s' * (gathers > 1)} "
                  f"a decode step); launches {launches}")
            legs["collectives_per_step"] = [reduces, gathers]
            rec[backend] = legs
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return rec, dict(total), base


def _tp_nccl_one(torch, dev, seed, smi):
    """19(a): qwen3-4b at full width and depth on a one-rank NCCL mesh
    (``_nccl_one``). Returns (record, launches of the mesh legs, the
    mesh=None streams, lm, params, the requests)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = get_config("qwen3-4b")
    lm = LM(cfg, device=dev)
    params = lm.init(seed, on_device=True)
    bound = _weight_bytes(params) / HBM_BYTES_PER_S * 1e3
    reqs = _tp_trace(seed, cfg.vocab_size)
    rec, launches, base = _nccl_one(torch, dev, seed, smi, lm, params, reqs,
                                    bound)
    return rec, launches, base, lm, params, reqs


def check_tensor_parallel(torch, dev, seed, smi, splits=True):
    """Phase 19: (a) the NCCL mesh of one rank (``_tp_nccl_one``), and on
    min(count, 4) cards when the machine has more than one; (b), unless
    ``splits`` is off, real splits on this one card: ranks as processes
    over gloo, each on it, eager (``TP_SPLITS``), held to each other and to
    ``mesh=None``. Returns (record, the 19(a) mesh legs' launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    rec = {}
    rec["nccl_one"], launches, base, lm, params, reqs = _tp_nccl_one(
        torch, dev, seed, smi)
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(cards, 4)
        print(f"  {cards} cards: qwen3-4b over an NCCL mesh of {n}, one card"
              f" a rank, graphed")
        recs = _tp_mesh(lm.cfg, n, seed, reqs, True, "nccl")
        rec[f"nccl_{n}"] = _tp_hold(torch, f"qwen3-4b NCCL x{n}", smi, lm,
                                    params, seed, reqs, recs, base,
                                    lm.cfg, n)
    else:
        print("  one card: no multi-card NCCL mesh on this machine")
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    for name, layers, ranks in TP_SPLITS if splits else ():
        cfg = _cut_depth(get_config(name), layers)
        lm = LM(cfg, device=dev)
        params = lm.init(seed, on_device=True)
        reqs = _tp_trace(seed, cfg.vocab_size)
        base, _, _ = _tp_base(torch, seed, lm, params, reqs, False)
        t0 = time.perf_counter()
        recs = _tp_mesh(cfg, ranks, seed, reqs, False, "gloo",
                        dev.type)
        label = f"{name} ({layers} layers) over gloo x{ranks} on one card"
        rec[name] = _tp_hold(torch, label, smi, lm, params, seed, reqs, recs,
                             base, cfg, ranks)
        rec[name]["seconds"] = time.perf_counter() - t0
        del lm, params
        gc.collect()
        torch.cuda.empty_cache()
    return rec, launches


# -- phase 20: MoE and MLA on the mesh ----------------------------------------

# 20(b): (model, layers per stage at full width, ranks) sharing one card
# over gloo, eager: mixtral's 8 experts 2 a rank (48 heads 12 a rank, its
# 8 KV heads 2 a rank); deepseek's 256 experts 64 a rank, its MLA's 128
# heads 32 a rank, the shared expert's and the dense layers' d_ff split;
# deepseek cut to one dense and one MoE layer, for the script's time limit
MESH_MOE_GLOO = (("mixtral-8x22b", (1,), 4), ("deepseek-v3-671b", (1, 1), 4))
# 20(c), one card a rank on a machine with >= 2 cards, ring and paged
# engines: mixtral at full depth and deepseek's 3 dense + 9 MoE layers
# (MTP's params too), at 4 ranks; fewer cards serve the depth that fits as
# 4 would, scaled by N / 4
MESH_MOE_CARDS = {"mixtral-8x22b": (56,), "deepseek-v3-671b": (3, 9)}


def _expert_bytes(params) -> int:
    """Bytes of the routed experts' leaves (``w_gate``, ``w_up``,
    ``w_down`` of every MoE layer) in ``params`` (a rank's, or whole)."""
    out = 0
    for stage in params["stages"]:
        for block in stage.values():
            mlp = block.get("mlp", {})
            if "router" in mlp:
                out += sum(mlp[k].numel() * mlp[k].element_size()
                           for k in ("w_gate", "w_up", "w_down"))
    return out


def _moe_rank(rank, out_dir, cfg, seed, reqs, graphed, backends,
              device="cuda"):
    """One rank of a phase-20 mesh (spawned): ``cfg`` at the dropless
    factor, its shards drawn by ``LM.init(..., mesh=)`` on its device from
    ``seed`` (the parent's values); ranks sharing one card over gloo draw
    them one after another. Over gloo (eager) it counts the pairs the
    trace's admissions drop at 1.25; under NCCL (graphed) it holds prefill
    then decode against a forward, both on the mesh. Then ``backends``'
    engines serve the trace. Its record to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.models.model import LM

    world = dist.get_world_size()
    nccl = dist.get_backend() == "nccl"
    if device == "cuda":
        if not nccl:
            # ranks sharing a card: segments that grow in place, so a
            # rank's freed init temporaries do not strand its share
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        device = f"cuda:{rank}" if nccl else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh = make_host_mesh(world, device=dev)
    lm = LM(cfg, device=dev, capacity_factor=_dropless(cfg))
    t0 = time.perf_counter()
    for turn in range(1 if nccl else world):
        if nccl or turn == rank:
            if cuda and rank == world - 1:
                free, _ = torch.cuda.mem_get_info(dev)
                print(f"  rank {rank}: {free / 1e9:.2f} GB free on the "
                      f"card before it draws its shards", flush=True)
            params = lm.init(seed, on_device=True, mesh=mesh)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        if not nccl:
            dist.barrier()
    rec = dict(init_s=time.perf_counter() - t0,
               weight_bytes=_weight_bytes(params),
               expert_bytes=_expert_bytes(params))
    if nccl:
        tokens = torch.from_numpy(np.random.default_rng(seed + 32).integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
        rec["prefill_vs_forward"] = _moe_prefill_vs_forward(
            torch, lm, params, tokens, 24, mesh=mesh)
    else:
        probe = _tp_engine(lm, params, seed, "ring", mesh)
        rec["drops"] = _count_drops(
            torch, LM(cfg, device=dev, capacity_factor=1.25), params, reqs,
            probe, mesh=mesh)
        del probe
    for backend in backends:
        eng = _tp_engine(lm, params, seed, backend, mesh)
        before = dict(COLLECTIVES)
        out, wall, launches = _tp_serve(torch, eng, reqs, graphed)
        since = tally(COLLECTIVES, before=before)
        step = eng.decode_s / eng.decode_steps * 1e3
        rec[backend] = dict(
            streams=[r.output.tolist() for r in out], wall_s=wall,
            tokens_per_s=sum(len(r.output) for r in out) / wall,
            decode_ms_per_step=step, launches=launches,
            all_reduces=since["all_reduce"],
            all_gathers=since["all_gather"],
            graphs=eng.graphs(), pool_bytes=eng.graph_pool_bytes(),
            mesh_devices=eng.metrics()["mesh_devices"])
        del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _teacher_ties(torch, lm, params, seed, reqs, streams):
    """For each ``mesh=None`` stream, per generated token: whether a
    teacher-forced forward parts there at a near-tie, its top-2 margin
    within ``BF16_LOGIT_TOL`` (of logits / T plus that step's Gumbel noise
    within ``BF16_LOGIT_TOL / T`` for a sampled request), or some MoE
    layer's router gap within ``ROUTE_TOL['bfloat16']`` at a position up
    to it. Lists of bools, computed before the mesh runs."""
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys

    out = []
    for rid, ((prompt, temp), got) in enumerate(zip(reqs, streams)):
        got = np.asarray(got, np.int32)
        ctx = torch.from_numpy(np.concatenate([prompt, got[:-1]]).astype(
            np.int32))[None].to(lm.device)
        with _Routes(torch) as routes:
            logits, _ = lm.forward(params, {"tokens": ctx})
        tail = logits[0, len(prompt) - 1:].float()
        del logits
        router = (np.maximum.accumulate(routes.near_ties(
            ROUTE_TOL["bfloat16"])[0])[len(prompt) - 1:] if routes.calls
            else np.zeros(len(got), bool))
        ties = []
        for j in range(len(got)):
            x, tol = tail[j], BF16_LOGIT_TOL
            if temp > 0:
                i32 = dict(dtype=torch.int32, device=lm.device)
                key = request_keys(prng_key(seed, device=lm.device),
                                   torch.tensor([rid], **i32),
                                   torch.tensor([j], **i32))
                x, tol = x / temp + gumbel(key, x.shape)[0], tol / temp
            top2 = torch.topk(x, 2).values
            ties.append(bool((top2[0] - top2[1]).item() <= tol
                             or router[j]))
        out.append(ties)
    return out


def _moe_hold(label, smi, recs, base, ties, none_launches, whole_experts,
              ranks, backends):
    """Hold a phase-20 mesh's records (``_mesh_hold``), and that every rank
    holds 1/N of the routed experts' bytes."""
    for r, rec in enumerate(recs):
        if rec["expert_bytes"] * ranks != whole_experts:
            raise AssertionError(f"{label}: rank {r} holds "
                                 f"{rec['expert_bytes']} expert bytes of "
                                 f"{whole_experts}")
    return _mesh_hold(label, smi, recs, base, ties, none_launches, ranks,
                      backends)


def _mesh_hold(label, smi, recs, base, ties, none_launches, ranks,
               backends):
    """Hold a spawned mesh's engine records: every rank's streams equal
    rank 0's bit for bit; rank 0's equal ``base`` (``mesh=None``'s) or part
    first where ``ties`` says the teacher-forced ``mesh=None`` forward is
    at a near-tie; every rank launches what ``mesh=None`` launched on the
    same schedule (MLA's chunks and decode launch none)."""
    out = {}
    for backend in backends:
        mine = [rec[backend] for rec in recs]
        for r, rec in enumerate(mine[1:], 1):
            if rec["streams"] != mine[0]["streams"]:
                raise AssertionError(f"{label} {backend}: rank {r}'s "
                                     f"streams differ from rank 0's")
        equal = parted = 0
        for rid, (got, want) in enumerate(zip(mine[0]["streams"],
                                              base[backend])):
            if got == want:
                equal += 1
                continue
            p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            print(f"    request {rid}: parts from mesh=None at token {p} "
                  f"(near-tie: {ties[backend][rid][p]})")
            if not ties[backend][rid][p]:
                raise AssertionError(f"{label} {backend}: request {rid} "
                                     f"parts from mesh=None at token {p}, "
                                     f"not at a near-tie")
            parted += 1
        for r, rec in enumerate(mine):
            print(f"  {label} {backend}, rank {r} [{smi}]: "
                  f"{rec['tokens_per_s']:.1f} tokens/s; decode "
                  f"{rec['decode_ms_per_step']:.2f} ms per step; "
                  f"{rec['all_reduces']} all-reduces, {rec['all_gathers']} "
                  f"all-gathers; graphs {rec['graphs']}; launches "
                  f"{rec['launches']}")
        print(f"  {label} {backend}: the {ranks} ranks' streams are equal "
              f"bit for bit; against mesh=None {equal} equal, {parted} "
              f"part first at a near-tie (top-2 margin <= {BF16_LOGIT_TOL} "
              f"or a router gap <= {ROUTE_TOL['bfloat16']})")
        if mine[0]["mesh_devices"] != ranks or any(
                rec["launches"] != none_launches[backend] for rec in mine):
            raise AssertionError(f"{label} {backend}: launches "
                                 f"{mine[0]['launches']} != mesh=None's "
                                 f"{none_launches[backend]}")
        out[backend] = dict(ranks=mine, equal=equal, parted=parted)
    return out


def _moe_gloo(torch, dev, seed, smi, name, depth, ranks):
    """20(b): ``name`` cut to ``depth`` at full width on ``ranks`` gloo
    ranks sharing this card, eager, ring and paged, against ``mesh=None``
    (its streams and their near-ties computed, then its weights freed
    before the ranks start)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = _cut_stages(get_config(name), depth)
    lm = LM(cfg, device=dev, capacity_factor=_dropless(cfg))
    params = lm.init(seed, on_device=True)
    reqs = _tp_trace(seed, cfg.vocab_size)
    base, none_launches, _ = _tp_base(torch, seed, lm, params, reqs, False)
    ties = {b: _quiet(_teacher_ties, torch, lm, params, seed, reqs, base[b])
            for b in base}
    probe = _tp_engine(lm, params, seed, "ring")
    drops = _count_drops(torch, LM(cfg, device=dev, capacity_factor=1.25),
                         params, reqs, probe)
    whole = _expert_bytes(params)
    del lm, params, probe
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  {name}: before the ranks start this process holds "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"({torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved); the "
          f"card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    t0 = time.perf_counter()
    recs = _spawn_ranks(_moe_rank, ranks, (cfg, seed, reqs, False,
                                           ("ring", "paged"), dev.type),
                        "gloo")
    label = (f"{name} ({'+'.join(map(str, depth))} layers) over gloo "
             f"x{ranks} on one card")
    rec = _moe_hold(label, smi, recs, base, ties, none_launches, whole,
                    ranks, ("ring", "paged"))
    per_rank = [r["drops"] for r in recs]
    if any(d != per_rank[0] for d in per_rank):
        raise AssertionError(f"{label}: the ranks drop different pairs at "
                             f"1.25: {per_rank}")
    mine = recs[0]["expert_bytes"] / 1e9
    print(f"  {label}: at 1.25 the admissions drop {per_rank[0][0]} of "
          f"{per_rank[0][1]} (token, choice) pairs on every rank "
          f"(mesh=None {drops[0]}); routed experts {mine:.2f} GB a rank "
          f"of {whole / 1e9:.2f} GB (1/{ranks}); "
          f"weights {recs[0]['weight_bytes'] / 1e9:.2f} GB a rank; shards "
          f"drawn in {max(r['init_s'] for r in recs):.1f} s")
    rec.update(drops=per_rank, drops_none=list(drops),
               expert_bytes_whole=whole, seconds=time.perf_counter() - t0)
    return rec


def _moe_cards(torch, seed, smi, name, n):
    """20(c): ``name`` at ``MESH_MOE_CARDS``' depth (scaled by n / 4) on
    n cards, one a rank, NCCL, the ring and paged engines graphed: the
    ranks in lockstep with equal streams, prefill then decode against a
    forward on the mesh (routes first), per-rank weight bytes, peak
    memory, decode ms a step against the per-rank weight-read bound,
    tokens/s."""
    from repro_torch.configs import get_config

    base = get_config(name)
    depth = tuple(max(1, d * n // 4) for d in MESH_MOE_CARDS[name])
    cfg = _cut_stages(base, depth)
    reqs = _tp_trace(seed, cfg.vocab_size)
    t0 = time.perf_counter()
    backends = ("ring", "paged")
    recs = _spawn_ranks(_moe_rank, n, (cfg, seed, reqs, True, backends),
                        "nccl", timeout_s=900)
    label = f"{name} ({cfg.num_layers} of {base.num_layers} layers) NCCL x{n}"
    for r, rec in enumerate(recs[1:], 1):
        for backend in backends:
            if rec[backend]["streams"] != recs[0][backend]["streams"]:
                raise AssertionError(f"{label} {backend}: rank {r}'s "
                                     f"streams differ")
    for r, rec in enumerate(recs):
        pf, ring = rec["prefill_vs_forward"], rec["ring"]
        bound = rec["weight_bytes"] / HBM_BYTES_PER_S * 1e3
        legs = "; ".join(
            f"{b} {rec[b]['tokens_per_s']:.1f} tokens/s, decode "
            f"{rec[b]['decode_ms_per_step']:.2f} ms a step "
            f"({rec[b]['decode_ms_per_step'] / bound:.2f}x), "
            f"{rec[b]['graphs']} graphs, pool "
            f"{rec[b]['pool_bytes'] / 1e9:.2f} GB" for b in backends)
        print(f"  {label}, rank {r} [{smi}]: weights "
              f"{rec['weight_bytes'] / 1e9:.2f} GB (experts "
              f"{rec['expert_bytes'] / 1e9:.2f}), peak "
              f"{rec.get('peak_bytes', 0) / 1e9:.2f} GB; shards drawn in "
              f"{rec['init_s']:.1f} s; per-rank weight-read bound "
              f"{bound:.2f} ms; {legs}; prefill+decode vs "
              f"forward: max|diff| {pf['err']:.3e} over {pf['compared']} of "
              f"{pf['positions']} positions, routes flipped at "
              f"{pf['flipped']} of {pf['tokens']} tokens x "
              f"{pf['moe_layers']} MoE layers ({pf['bad']} first flips "
              f"off a near-tie; largest gap at a first flip "
              f"{pf['widest_flipped_gap']:.3f}, tol "
              f"{ROUTE_TOL['bfloat16']})")
        # a flip reaches every later position of its row, and at 9 or more
        # MoE layers of top-8 of 256 most rows meet a near-tie early: each
        # row must keep a compared position (phase 16's one MoE layer keeps
        # half of them)
        rows = np.asarray(pf["compared_rows"])
        if pf["bad"] or not (np.isfinite(pf["max_logit"])
                             and pf["err"] < BF16_LOGIT_TOL) \
                or not (rows > 0).all():
            raise AssertionError(f"{label}: rank {r}: prefill+decode != "
                                 f"forward on the mesh")
        if not any(ring["launches"].values()):
            raise AssertionError(f"{label}: no kernel launched")
    return dict(ranks=recs, layers=cfg.num_layers,
                seconds=time.perf_counter() - t0)


def check_moe_mesh(torch, dev, seed, smi, legs="abc"):
    """Phase 20, its ``legs``: (a) mixtral-8x22b and deepseek-v3-671b at
    phase 16's depths on a one-rank NCCL mesh against ``mesh=None``,
    dropless, graphed (``_nccl_one``); (b) both split 4 ways over gloo on
    this card (``_moe_gloo``); (c) on min(cards, 4) cards when the machine
    has more than one (``_moe_cards``). Returns (record, the (a) mesh
    legs' launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    rec, launches = {}, collections.Counter()
    for name in MOE_MODELS if "a" in legs else ():
        cfg = _cut_stages(get_config(name), MOE_DEPTH[name])
        lm = LM(cfg, device=dev, capacity_factor=_dropless(cfg))
        params = lm.init(seed, on_device=True)
        bound = _weight_bytes(params) / HBM_BYTES_PER_S * 1e3
        reqs = _tp_trace(seed, cfg.vocab_size)
        rec[f"{name}_nccl_one"], got, _ = _nccl_one(
            torch, dev, seed, smi, lm, params, reqs, bound)
        launches.update(got)
        del lm, params
        gc.collect()
        torch.cuda.empty_cache()
    for name, depth, ranks in MESH_MOE_GLOO if "b" in legs else ():
        rec[f"{name}_gloo"] = _moe_gloo(torch, dev, seed, smi, name, depth,
                                        ranks)
        gc.collect()
        torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards >= 2 and "c" in legs:
        n = min(cards, 4)
        for name in MOE_MODELS:
            rec[f"{name}_nccl_{n}"] = _moe_cards(torch, seed, smi, name, n)
    elif "c" in legs:
        print("  one card: no multi-card NCCL mesh on this machine")
    return rec, dict(launches)


# -- phase 21: the recurrent mixers and the frontends on the mesh -------------

REC_MESH_MODELS = ("recurrentgemma-9b", "xlstm-125m")
# 21(b): (model, stage repeats at full width (None: full depth), ranks)
# sharing one card over gloo, eager: recurrentgemma's one (rec, rec, attn)
# repeat and one trailing rec block, its 4,096 channels 1,024 a rank (16
# query heads 4 a rank, each reading the one KV head whole); xlstm cut to
# two of its six (mLSTM, sLSTM) repeats, for the script's time limit, its
# 4 heads 2 and 1 a rank, its sLSTM GeGLU's 1,536 columns split
MESH_REC_GLOO = (("recurrentgemma-9b", (1, 1), 4), ("xlstm-125m", (2,), 2),
                 ("xlstm-125m", (2,), 4))
# 21(a) whole and 21(b) at MESH_MODAL_LAYERS layers on MESH_MODAL_RANKS
# ranks, through LM: internvl2's projector whole on every rank, musicgen's
# 2,048 rows of each of its 4 codebooks 512 a rank
MESH_MODAL = ("internvl2-2b", "musicgen-medium")
MESH_MODAL_LAYERS = 4
MESH_MODAL_RANKS = 4
MESH_MODAL_STEPS = 8       # greedy decode steps after the prefill (B = 2)
# 21(c): recurrentgemma-9b at all 38 layers on min(cards, 4) cards
MESH_REC_CARDS = "recurrentgemma-9b"


def _rec_cfg(name, depth=None):
    """``name``'s config, its stage repeats cut to ``depth`` (None: whole),
    widths unchanged."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if depth is None else _cut_stages(cfg, depth)


def _rec_state_bytes(eng) -> int:
    """Bytes of the recurrent state an engine's cache holds (on a mesh
    this rank's)."""
    from repro_torch.serving.kv_cache import _split_leaves

    return sum(t.numel() * t.element_size() for _, t, _, mixer in
               _split_leaves(eng._cache_state["caches"])
               if mixer in _RECURRENT)


def _collectives_alone(torch, mesh, cfg, b=8, n=20):
    """Device ms of one decode step's collectives alone on ``mesh``, as a
    CUDA graph replayed ``n`` times (CUDA events, the median): what
    ``_step_collectives`` counts, at the shapes a ``b``-slot step gives
    them: a (b, 1, d_model) partial a reduce, (b, 1, 2 W) for an RG-LRU's
    two gates, an sLSTM's (b, 1, H hd / N) head outputs and the
    (b, 1, V / N) logits gathered; no MoE or audio layer."""
    dt, dev = torch.bfloat16, mesh.device
    d, ways = cfg.d_model, mesh.shape["model"]
    parts = [("r", d)]
    for st in cfg.stages:
        for blk in st.blocks:
            one = []
            if blk.mixer == "rglru":
                one += [("r", 2 * cfg.resolved_lru_width // ways), ("r", d)]
            elif blk.mixer == "slstm":
                one += [("g", cfg.num_heads * cfg.resolved_head_dim // ways),
                        ("r", d)]
            else:
                one += [("r", d)]
            if blk.mlp != "none":
                one += [("r", d)]
            parts += one * st.repeat
    parts.append(("g", cfg.padded_vocab // ways))
    bufs = [(kind, torch.zeros((b, 1, w), dtype=dt, device=dev))
            for kind, w in parts]

    def step():
        for kind, x in bufs:
            if kind == "r":
                mesh.all_reduce(x)
            else:
                mesh.gather(x, -1)

    step()                                   # the communicator, eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    times = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        graph.replay()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    del graph
    reduces = sum(kind == "r" for kind, _ in parts)
    return dict(ms=statistics.median(s.elapsed_time(e) for s, e in times),
                all_reduces=reduces, all_gathers=len(parts) - reduces)


def _rec_rank(rank, out_dir, cfg, seed, reqs, graphed, device="cuda"):
    """One rank of a phase-21 recurrent mesh (spawned): its shards drawn by
    ``LM.init(..., mesh=)`` on its device from ``seed`` (ranks sharing one
    card over gloo draw in turns); under NCCL prefill then decode against a
    forward, both on the mesh, and a decode step's collectives timed alone;
    then the ring engine serves the trace, graphed or eager. Its record to
    ``out_dir``, the engine's under "ring"."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.models.model import LM

    world = dist.get_world_size()
    nccl = dist.get_backend() == "nccl"
    if device == "cuda":
        if not nccl:
            # ranks sharing a card: segments that grow in place, so a
            # rank's freed init temporaries do not strand its share
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        device = f"cuda:{rank}" if nccl else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh = make_host_mesh(world, device=dev)
    lm = LM(cfg, device=dev)
    t0 = time.perf_counter()
    for turn in range(1 if nccl else world):
        if nccl or turn == rank:
            params = lm.init(seed, on_device=True, mesh=mesh)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        if not nccl:
            dist.barrier()
    rec = dict(init_s=time.perf_counter() - t0,
               weight_bytes=_weight_bytes(params))
    if nccl:
        tokens = torch.from_numpy(np.random.default_rng(seed + 33).integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)
        err, top, _ = _prefill_vs_forward(lm, params, tokens, 24, mesh=mesh)
        rec["prefill_vs_forward"] = dict(err=err, max_logit=top)
        rec["collectives_alone"] = _collectives_alone(torch, mesh, cfg)
    eng = _tp_engine(lm, params, seed, "ring", mesh)
    before = dict(COLLECTIVES)
    out, wall, launches = _tp_serve(torch, eng, reqs, graphed)
    since = tally(COLLECTIVES, before=before)
    rec["ring"] = dict(
        streams=[r.output.tolist() for r in out], wall_s=wall,
        tokens_per_s=sum(len(r.output) for r in out) / wall,
        decode_ms_per_step=eng.decode_s / eng.decode_steps * 1e3,
        launches=launches,
        all_reduces=since["all_reduce"],
        all_gathers=since["all_gather"],
        graphs=eng.graphs(), pool_bytes=eng.graph_pool_bytes(),
        mesh_devices=eng.metrics()["mesh_devices"])
    rec["state_bytes"] = _rec_state_bytes(eng)
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _rec_gloo(torch, dev, seed, smi, name, depth, ranks):
    """21(b): ``name`` (cut to ``depth`` at full width) on ``ranks`` gloo
    ranks sharing this card, eager, ring, against ``mesh=None`` (its
    streams and their near-ties computed, then its weights freed before
    the ranks start): the ranks' streams equal, rank 0's equal
    ``mesh=None``'s or parted at a near-tie, every rank's launches
    ``mesh=None``'s, and 1/N of the recurrent state's bytes a rank."""
    from repro_torch.models.model import LM

    cfg = _rec_cfg(name, depth)
    lm = LM(cfg, device=dev)
    params = lm.init(seed, on_device=True)
    reqs = _tp_trace(seed, cfg.vocab_size)
    base, none_launches, _ = _tp_base(torch, seed, lm, params, reqs, False,
                                      backends=("ring",))
    ties = {"ring": _quiet(_teacher_ties, torch, lm, params, seed, reqs,
                           base["ring"])}
    probe = _tp_engine(lm, params, seed, "ring")
    whole = _rec_state_bytes(probe)
    del lm, params, probe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = _spawn_ranks(_rec_rank, ranks, (cfg, seed, reqs, False,
                                           dev.type), "gloo")
    label = f"{name} ({cfg.num_layers} layers) over gloo x{ranks} on one card"
    for r, rec in enumerate(recs):
        if rec["state_bytes"] * ranks != whole:
            raise AssertionError(f"{label}: rank {r} holds "
                                 f"{rec['state_bytes']} recurrent state "
                                 f"bytes of {whole}")
    out = _mesh_hold(label, smi, recs, base, ties, none_launches, ranks,
                     ("ring",))
    print(f"  {label}: recurrent state {recs[0]['state_bytes'] / 1e6:.2f} MB"
          f" a rank of {whole / 1e6:.2f} MB (1/{ranks}); weights "
          f"{recs[0]['weight_bytes'] / 1e9:.2f} GB a rank; shards drawn in "
          f"{max(r['init_s'] for r in recs):.1f} s")
    out.update(state_bytes=[r["state_bytes"] for r in recs],
               state_bytes_whole=whole, seconds=time.perf_counter() - t0)
    return out


def _rec_cards(torch, seed, smi, n):
    """21(c): recurrentgemma-9b at all 38 layers on ``n`` cards, one a
    rank, NCCL, the ring engine graphed: the ranks' streams equal, prefill
    then decode within ``BF16_LOGIT_TOL`` of a forward on the mesh; per
    rank the weight bytes, peak memory, decode ms a step against the
    per-rank weight-read bound, a step's collectives alone, tokens/s."""
    cfg = _rec_cfg(MESH_REC_CARDS)
    reqs = _tp_trace(seed, cfg.vocab_size)
    t0 = time.perf_counter()
    recs = _spawn_ranks(_rec_rank, n, (cfg, seed, reqs, True), "nccl",
                        timeout_s=900)
    label = f"{cfg.name} ({cfg.num_layers} layers) NCCL x{n}"
    for r, rec in enumerate(recs[1:], 1):
        if rec["ring"]["streams"] != recs[0]["ring"]["streams"]:
            raise AssertionError(f"{label}: rank {r}'s streams differ")
    for r, rec in enumerate(recs):
        pf, ring, alone = (rec["prefill_vs_forward"], rec["ring"],
                           rec["collectives_alone"])
        bound = rec["weight_bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"  {label}, rank {r} [{smi}]: weights "
              f"{rec['weight_bytes'] / 1e9:.2f} GB, peak "
              f"{rec.get('peak_bytes', 0) / 1e9:.2f} GB, recurrent state "
              f"{rec['state_bytes'] / 1e6:.2f} MB; shards drawn in "
              f"{rec['init_s']:.1f} s; ring {ring['tokens_per_s']:.1f} "
              f"tokens/s, decode {ring['decode_ms_per_step']:.2f} ms a step "
              f"({ring['decode_ms_per_step'] / bound:.2f}x the {bound:.2f} ms "
              f"per-rank weight-read bound), {ring['graphs']} graphs, pool "
              f"{ring['pool_bytes'] / 1e9:.2f} GB; a step's "
              f"{alone['all_reduces']} all-reduces and {alone['all_gathers']}"
              f" all-gather alone {alone['ms']:.3f} ms (a CUDA graph); "
              f"prefill+decode vs forward: max|diff| {pf['err']:.3e} (max "
              f"|logit| {pf['max_logit']:.2f}, tol {BF16_LOGIT_TOL})")
        if not (np.isfinite(pf["max_logit"]) and pf["err"] < BF16_LOGIT_TOL):
            raise AssertionError(f"{label}: rank {r}: prefill+decode != "
                                 f"forward on the mesh")
        if not any(ring["launches"].values()):
            raise AssertionError(f"{label}: no kernel launched")
    return dict(ranks=recs, layers=cfg.num_layers,
                seconds=time.perf_counter() - t0)


def _modal_batch(torch, lm, dev, seed):
    """The frontend's B = 2 inputs (``models.frontend.make_batch``: an
    image prefix and ``VISION_TEXT`` text tokens, or an ``AUDIO_PROMPT``
    x 4 codebook grid) from a generator on ``dev``, the same in every
    process: (batch, its text length)."""
    from repro_torch.models.frontend import make_batch

    cfg = lm.cfg
    vision = cfg.frontend.kind == "vision"
    text = VISION_TEXT if vision else AUDIO_PROMPT
    gen = torch.Generator(device=dev).manual_seed(seed + 34)
    batch = make_batch(gen, cfg, 2, text + (cfg.frontend.num_prefix_tokens
                                            if vision else 0))
    del batch["labels"]
    return batch, text


def _modal_greedy(torch, lm, params, batch, text_len, steps, mesh=None):
    """Prefill ``batch``, then ``steps`` greedy decode steps (each
    codebook's argmax for audio), eager, on ``mesh`` or off it: (the
    tokens (B, steps[, C]), each call's last-position logits in f32, the
    last step's (all-reduces, all-gathers), the launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import COLLECTIVES, tally

    prefix = lm.cfg.frontend.num_prefix_tokens if "image_embeds" in batch \
        else 0
    cuda = lm.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    reset_launches()
    logits, caches = lm.prefill(params, batch, cache_width=prefix + text_len
                                + steps, last_only=True, mesh=mesh)
    seen, gen = [logits[:, -1].float()], []
    for t in range(steps):
        nxt = seen[-1].argmax(-1)
        gen.append(nxt)
        before = dict(COLLECTIVES)
        logits, caches = lm.decode_step(params, caches, nxt[:, None].to(
            torch.int32), prefix + text_len + t, mesh=mesh)
        seen.append(logits[:, -1].float())
    if cuda:
        torch.cuda.synchronize()
    since = tally(COLLECTIVES, before=before)
    coll = (since["all_reduce"], since["all_gather"])
    return torch.stack(gen, 1), seen, coll, dict(LAUNCHES)


def _modal_nccl_one(torch, dev, seed, smi, name):
    """21(a): ``name`` whole (bf16) through ``LM.prefill`` and
    ``MESH_MODAL_STEPS`` greedy ``LM.decode_step``s, eager, B = 2, off the
    mesh and on a one-rank NCCL mesh in the same call: every logit and
    token bit-equal, the launches equal, a decode step's collectives
    ``_step_collectives``. Returns (record, the mesh leg's launches)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_host_mesh
    from repro_torch.models.model import LM

    lm = LM(_modal_cfg(name, "bfloat16"), device=dev)
    params = lm.init(seed, on_device=True)
    batch, text = _modal_batch(torch, lm, dev, seed)
    runs = {"mesh=None": _modal_greedy(torch, lm, params, batch, text,
                                       MESH_MODAL_STEPS)}
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_host_mesh(1, device=dev)
        runs["mesh of 1"] = _modal_greedy(torch, lm, params, batch, text,
                                          MESH_MODAL_STEPS, mesh)
    finally:
        dist.destroy_process_group()
    (tok0, seen0, _, l0), (tok1, seen1, coll, l1) = runs.values()
    want = _step_collectives(lm.cfg)
    same = torch.equal(tok0, tok1) and all(
        torch.equal(a, b) for a, b in zip(seen0, seen1))
    print(f"  {name} (whole) through LM.prefill + {MESH_MODAL_STEPS} "
          f"decode_steps, B = 2 [{smi}]: the NCCL mesh of one "
          f"{'equals' if same else 'differs from'} mesh=None bit for bit "
          f"(logits and tokens); a decode step runs {coll[0]} all-reduces"
          f" and {coll[1]} all-gather (by the code {want[0]} and {want[1]});"
          f" launches {l1}")
    if not same:
        raise AssertionError(f"{name}: the NCCL mesh of one != mesh=None")
    if l0 != l1 or not l1.get("flash_attention") or not l1.get(
            "decode_attention"):
        raise AssertionError(f"{name}: launches {l1} != mesh=None's {l0}")
    if coll != want:
        raise AssertionError(f"{name}: {coll} collectives a decode step, "
                             f"not {want}")
    del lm, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(collectives_per_step=list(coll), launches=l1), l1


def _modal_rank(rank, out_dir, seed, device="cuda"):
    """One rank of phase 21(b)'s frontend mesh (spawned, gloo, every rank
    on card 0): each of ``MESH_MODAL`` at ``MESH_MODAL_LAYERS`` layers, its
    shards drawn in turns, through ``_modal_greedy`` on the mesh. Its
    record to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM

    world = dist.get_world_size()
    if device == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        device = "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh = make_host_mesh(world, device=dev)
    rec = {}
    for name in MESH_MODAL:
        lm = LM(_modal_cfg(name, "bfloat16", MESH_MODAL_LAYERS), device=dev)
        for turn in range(world):
            if turn == rank:
                params = lm.init(seed, on_device=True, mesh=mesh)
            dist.barrier()
        batch, text = _modal_batch(torch, lm, dev, seed)
        t0 = time.perf_counter()
        tokens, _, _, launches = _modal_greedy(torch, lm, params, batch,
                                               text, MESH_MODAL_STEPS, mesh)
        rec[name] = dict(tokens=tokens.tolist(), launches=launches,
                         seconds=time.perf_counter() - t0,
                         weight_bytes=_weight_bytes(params))
        del params
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _modal_gloo(torch, dev, seed, smi):
    """21(b): ``MESH_MODAL`` at ``MESH_MODAL_LAYERS`` layers on
    ``MESH_MODAL_RANKS`` gloo ranks sharing this card, through ``LM``,
    eager, against ``mesh=None`` (computed first, its weights freed): the
    ranks' tokens equal; rank 0's equal ``mesh=None``'s or part first, in
    each row, at a step where ``mesh=None``'s top-2 margin (of a codebook
    that parts) is within ``BF16_LOGIT_TOL``; launches equal."""
    from repro_torch.models.model import LM

    base = {}
    for name in MESH_MODAL:
        lm = LM(_modal_cfg(name, "bfloat16", MESH_MODAL_LAYERS), device=dev)
        params = lm.init(seed, on_device=True)
        batch, text = _modal_batch(torch, lm, dev, seed)
        tokens, seen, _, launches = _modal_greedy(
            torch, lm, params, batch, text, MESH_MODAL_STEPS)
        top2 = torch.stack(seen[:-1], 1).topk(2, dim=-1).values
        base[name] = (tokens.cpu().numpy(), (top2[..., 0] - top2[..., 1])
                      .cpu().numpy(), launches, _weight_bytes(params))
        del lm, params, seen
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n = MESH_MODAL_RANKS
    recs = _spawn_ranks(_modal_rank, n, (seed, dev.type), "gloo")
    out = {}
    for name in MESH_MODAL:
        want, margin, launches, whole = base[name]
        mine = [np.asarray(r[name]["tokens"]) for r in recs]
        label = (f"{name} ({MESH_MODAL_LAYERS} layers) over gloo x{n} on "
                 f"one card through LM")
        if any(not np.array_equal(m, mine[0]) for m in mine[1:]):
            raise AssertionError(f"{label}: the ranks' tokens differ")
        if any(r[name]["launches"] != launches for r in recs):
            raise AssertionError(f"{label}: launches "
                                 f"{recs[0][name]['launches']} != mesh=None's "
                                 f"{launches}")
        equal = parted = 0
        for row in range(want.shape[0]):
            diff = (mine[0][row] != want[row]).reshape(want.shape[1], -1)
            steps = np.nonzero(diff.any(-1))[0]
            if not len(steps):
                equal += 1
                continue
            t = int(steps[0])
            gap = float(margin[row, t].reshape(-1)[diff[t]].min())
            print(f"    row {row}: parts from mesh=None at step {t} "
                  f"(mesh=None's top-2 margin {gap:.4f})")
            if gap > BF16_LOGIT_TOL:
                raise AssertionError(f"{label}: row {row} parts from "
                                     f"mesh=None at step {t}, not at a "
                                     f"near-tie")
            parted += 1
        per_rank = recs[0][name]["weight_bytes"]
        print(f"  {label} [{smi}]: the {n} ranks' tokens are equal; against "
              f"mesh=None {equal} of {want.shape[0]} rows equal, {parted} "
              f"part first at a near-tie (margin <= {BF16_LOGIT_TOL}); "
              f"weights {per_rank / 1e9:.2f} GB a rank of {whole / 1e9:.2f} "
              f"GB; {max(r[name]['seconds'] for r in recs):.1f} s a rank; "
              f"launches {launches}")
        out[name] = dict(equal=equal, parted=parted, weight_bytes=per_rank,
                         whole_bytes=whole)
    out["seconds"] = time.perf_counter() - t0
    return out


def check_rec_mesh(torch, dev, seed, smi, legs="abc"):
    """Phase 21, its ``legs``: (a) recurrentgemma-9b at all 38 layers and
    xlstm-125m whole on a one-rank NCCL mesh against ``mesh=None``, the
    ring engine graphed (``_nccl_one``), then internvl2-2b and
    musicgen-medium whole through ``LM`` (``_modal_nccl_one``); (b) real
    splits over gloo on this card (``_rec_gloo``, ``_modal_gloo``); (c) on
    min(cards, 4) cards when the machine has more than one
    (``_rec_cards``). Returns (record, the (a) mesh legs' launches)."""
    from repro_torch.models.model import LM

    rec, launches = {}, collections.Counter()
    for name in REC_MESH_MODELS if "a" in legs else ():
        lm = LM(_rec_cfg(name), device=dev)
        params = lm.init(seed, on_device=True)
        bound = _weight_bytes(params) / HBM_BYTES_PER_S * 1e3
        reqs = _tp_trace(seed, lm.cfg.vocab_size)
        t0 = time.perf_counter()
        rec[f"{name}_nccl_one"], got, _ = _nccl_one(
            torch, dev, seed, smi, lm, params, reqs, bound,
            backends=("ring",))
        rec[f"{name}_nccl_one"]["seconds"] = time.perf_counter() - t0
        launches.update(got)
        del lm, params
        gc.collect()
        torch.cuda.empty_cache()
    for name in MESH_MODAL if "a" in legs else ():
        rec[f"{name}_nccl_one"], got = _modal_nccl_one(torch, dev, seed, smi,
                                                       name)
        launches.update(got)
    for name, depth, ranks in MESH_REC_GLOO if "b" in legs else ():
        rec[f"{name}_gloo_{ranks}"] = _rec_gloo(torch, dev, seed, smi, name,
                                                depth, ranks)
        gc.collect()
        torch.cuda.empty_cache()
    if "b" in legs:
        rec["modal_gloo"] = _modal_gloo(torch, dev, seed, smi)
    cards = torch.cuda.device_count()
    if cards >= 2 and "c" in legs:
        n = min(cards, 4)
        rec[f"{MESH_REC_CARDS}_nccl_{n}"] = _rec_cards(torch, seed, smi, n)
    elif "c" in legs:
        print("  one card: no multi-card NCCL mesh on this machine")
    return rec, dict(launches)


# -- phase 22: the data axis ---------------------------------------------------

# 22(a): (model, stage repeats at full width, backends) on a (2, 2) mesh of
# gloo ranks sharing this card, eager: qwen3-4b's heads, KV heads and d_ff
# split 2 ways on 'model' and d_model's contraction side 2 ways on 'data';
# mixtral's 8 experts over ("data", "model"), 2 a rank, dropless
DATA_MESH_GLOO = (("qwen3-4b", (4,), ("ring", "paged")),
                  ("mixtral-8x22b", (1,), ("ring",)))
DATA_MESH = (2, 2)                 # (data, model)
DATA_MESH_CARDS = "qwen3-4b"       # 22(b): whole, on 4 cards as (2, 2)
DP_MODEL = "smollm-135m"
DP_BATCH = (8, 512)                # 22(c)'s global batch
DP_F32_STEPS = 3
DP_BF16_STEPS = 10
DP_LR = 1e-3
# f32: each data-parallel step against the one-device step on the global
# batch from the same state (the first from the init, each later one from
# the data-parallel state before it, so no step inherits an earlier one's
# rounding): the loss (relative) and the first step's gradient (each leaf,
# of its max |g|) as phase 18's TRAIN_LOSS_TOL / TRAIN_GRAD_TOL; every leaf
# of AdamW's moments within TRAIN_GRAD_TOL of its max |.| (they sum
# gradients, with no eps in them); every param within DP_PARAM_TOL of its
# leaf's max |p| plus DP_STEP_TOL lr plus lr times the most by which
# AdamW's step m^/(sqrt(v^) + eps) of the one-device moments moves when
# they move by their leaf's measured disagreement (an element whose m is
# near 0 may step either way, one whose sqrt(v^) is near eps moves with
# its gradient's last bits), and never past 2.5 lr
DP_PARAM_TOL = 1e-5
DP_STEP_TOL = 1e-4
FED_ROUNDS, FED_LOCAL = 2, 4       # 22(d)
FED_BATCH = (4, 256)               # each edge cloud's batch
FED_LR = 0.01
FED_TOL = 1e-5                     # f32, of a leaf's max |p|


def _dm_step_collectives(cfg):
    """(model, data, world) collectives one decode step issues on a (2, 2)
    mesh by the design, for a dense GQA or an MoE stack whose heads, KV
    heads, d_ff, vocab and experts all divide: per attention layer ``wo``'s
    model sum and one data sum of the joined q/k/v partials; per dense MLP
    ``w_down``'s model sum and one data sum of gate/up; per MoE layer the
    router's data sum, its logits' model gather and one sum of the routed
    and shared partials over the whole mesh; once a step the norm scales'
    data gather, the embedding's join over the whole mesh and the
    unembedding's data sum and model gather."""
    model, data, world = 1, 2, 1
    for st in cfg.stages:
        for b in st.blocks:
            model += st.repeat * (1 + (b.mlp == "moe"))
            data += st.repeat * 2
            world += st.repeat * (b.mlp == "moe")
            model += st.repeat * (b.mlp not in ("moe", "none"))
    return {"model": model, "data": data, "world": world}


def _dm_shard_bytes(lm, data, model):
    """Bytes a rank's shards of ``lm``'s params take at (data, model) under
    the decode rules (``serving.sharding``'s specs)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.serving.sharding import param_shardings, shard_shape

    mesh = AbstractMesh(model, data)

    def walk(spec, leaf):
        if isinstance(spec, dict):
            return sum(walk(spec[k], leaf[k]) for k in spec)
        if isinstance(spec, list):
            return sum(walk(s, x) for s, x in zip(spec, leaf))
        shape, dtype, _ = leaf
        return int(np.prod(shard_shape(mesh, shape, spec))) * dtype.itemsize

    return walk(param_shardings(mesh, lm), lm.param_spec())


def _dm_rank(rank, out_dir, cfg, seed, reqs, model, backends, graphed,
             device="cuda"):
    """One rank of a phase-22 (data, model) mesh (spawned): its 2-D shards
    drawn by ``LM.init(..., mesh=)`` (ranks sharing one card over gloo in
    turns), one decode step's collectives by axis, then ``backends``'
    engines on the trace (graphed under NCCL: each decode program's
    collectives by axis). Its record to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.models.model import LM

    world = dist.get_world_size()
    nccl = dist.get_backend() == "nccl"
    if device == "cuda":
        if not nccl:
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        device = f"cuda:{rank}" if nccl else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh = make_host_mesh(model, device=dev)
    lm = LM(cfg, device=dev, capacity_factor=_dropless(cfg) if cfg.moe
            else 1.25)
    t0 = time.perf_counter()
    for turn in range(1 if nccl else world):
        if nccl or turn == rank:
            params = lm.init(seed, on_device=True, mesh=mesh)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        if not nccl:
            dist.barrier()
    rec = dict(init_s=time.perf_counter() - t0,
               place=[mesh.rank, mesh.data_rank, mesh.model_rank],
               param_bytes=sum(t.numel() * t.element_size()
                               for t in _leaves(params)))
    cache = lm.init_cache(2, 64, mesh=mesh)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    before = dict(COLLECTIVES)
    lm.decode_step(params, cache, tokens, 0, mesh=mesh)
    rec["step_collectives"] = tally(COLLECTIVES, "axis", before)
    del cache
    for backend in backends:
        eng = _tp_engine(lm, params, seed, backend, mesh)
        before = dict(COLLECTIVES)
        out, wall, launches = _tp_serve(torch, eng, reqs, graphed)
        since = tally(COLLECTIVES, before=before)
        step = eng.decode_s / eng.decode_steps * 1e3
        rec[backend] = dict(
            streams=[r.output.tolist() for r in out], wall_s=wall,
            tokens_per_s=sum(len(r.output) for r in out) / wall,
            decode_ms_per_step=step, launches=launches,
            all_reduces=since["all_reduce"],
            all_gathers=since["all_gather"],
            kv_bytes=_tp_kv_bytes(eng), graphs=eng.graphs(),
            mesh_devices=eng.metrics()["mesh_devices"],
            programs={str(k): p.collectives
                      for k, p in eng._programs.items()
                      if graphed and k[0] == "decode"})
        del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _dm_serve(torch, dev, seed, smi, name, depth, backends, ranks, backend,
              graphed, other=None):
    """22(a) and (b): ``name`` at ``depth`` (None: whole) on a
    ``DATA_MESH`` mesh of ``ranks`` processes over ``backend``, against
    ``mesh=None`` (its streams and their near-ties computed first, then its
    weights freed): the ranks' streams equal, equal ``mesh=None``'s or
    part first at a near-tie (``_mesh_hold``), launches equal
    ``mesh=None``'s; each rank's parameter bytes the decode specs' shard
    at (2, 2); a decode step's collectives by axis the design's
    (``_dm_step_collectives``), and under NCCL each decode program's; with
    ``other`` ({backend: streams} of a 1-D mesh of the same model and
    trace), how many streams equal it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import tally
    from repro_torch.models.model import LM

    cfg = get_config(name)
    if depth is not None:
        cfg = _cut_stages(cfg, depth)
    lm = LM(cfg, device=dev, capacity_factor=_dropless(cfg) if cfg.moe
            else 1.25)
    params = lm.init(seed, on_device=True)
    reqs = _tp_trace(seed, cfg.vocab_size)
    base, none_launches, _ = _tp_base(torch, seed, lm, params, reqs,
                                      graphed, backends=backends)
    ties = {b: _quiet(_teacher_ties, torch, lm, params, seed, reqs, base[b])
            for b in base}
    whole = _weight_bytes(params)
    shard = _dm_shard_bytes(lm, *DATA_MESH)
    design = _dm_step_collectives(cfg)
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = _spawn_ranks(_dm_rank, ranks, (cfg, seed, reqs, DATA_MESH[1],
                                          backends, graphed, dev.type),
                        backend)
    cut = ("whole" if depth is None
           else "+".join(map(str, depth)) + " layers")
    label = f"{name} ({cut}) on a (2, 2) mesh over {backend}"
    rec = _mesh_hold(label, smi, recs, base, ties, none_launches, ranks,
                     backends)
    for r, got in enumerate(recs):
        d, m = r // DATA_MESH[1], r % DATA_MESH[1]
        if got["place"] != [r, d, m]:
            raise AssertionError(f"{label}: rank {r} sits at {got['place']}")
        if got["param_bytes"] != shard:
            raise AssertionError(f"{label}: rank {r} holds "
                                 f"{got['param_bytes']} B of params, the "
                                 f"decode specs' (2, 2) shard is {shard} B")
        if got["step_collectives"] != design:
            raise AssertionError(f"{label}: rank {r}'s decode step issues "
                                 f"{got['step_collectives']}, the design "
                                 f"{design}")
        for b in backends:
            for key, n in got[b]["programs"].items():
                k = int(key.split(",")[1])
                if tally(n, "axis") != {a: k * c
                                        for a, c in design.items()}:
                    raise AssertionError(f"{label} {b}: program {key} "
                                         f"captured {n}, the design "
                                         f"{design} a step")
    print(f"  {label}: {shard / 1e9:.3f} GB of params a rank (the decode "
          f"specs' (2, 2) shard of {whole / 1e9:.3f} GB); a decode step "
          f"issues {design} collectives (model, data, world), the design's;"
          f" peak {max(g.get('peak_bytes', 0) for g in recs) / 1e9:.2f} GB "
          f"a rank [{smi}]")
    for b in backends:
        if b in (other or {}):
            same = sum(a == o for a, o in zip(rec[b]["ranks"][0]["streams"],
                                              other[b]))
            print(f"  {label} {b}: {same} of {len(reqs)} streams equal the "
                  f"1-D mesh's")
            rec[b]["equal_1d"] = same
    rec.update(param_bytes=shard, whole_bytes=whole, step_collectives=design,
               seconds=time.perf_counter() - t0)
    return rec


def _dp_f32_schedule(step):
    import torch
    return torch.full((), DP_LR, dtype=torch.float32, device=step.device)


def _spec_bytes(spec) -> int:
    """Bytes of a ``param_spec`` tree ((shape, dtype, init) leaves)."""
    if isinstance(spec, dict):
        return sum(_spec_bytes(v) for v in spec.values())
    if isinstance(spec, list):
        return sum(_spec_bytes(v) for v in spec)
    shape, dtype, _ = spec
    return int(np.prod(shape)) * dtype.itemsize


def _adam_step_spread(m, v, dm, dv, k, b1=0.9, b2=0.95, eps=1e-8):
    """The most by which AdamW's step ``m^/(sqrt(v^) + eps)`` after step
    ``k`` (``optim.adamw_update``'s defaults) moves when its moments ``m``
    and ``v`` move by up to ``dm`` and ``dv`` (elementwise; the quotient's
    interval over the box of moments)."""
    c1, c2 = 1 - b1 ** k, 1 - b2 ** k
    u = (m / c1) / ((v / c2).sqrt() + eps)
    d_lo = ((v - dv).clamp_min(0) / c2).sqrt() + eps
    d_hi = ((v + dv) / c2).sqrt() + eps
    n_lo, n_hi = (m - dm) / c1, (m + dm) / c1
    hi = (n_hi / d_lo).maximum(n_hi / d_hi)
    lo = (n_lo / d_lo).minimum(n_lo / d_hi)
    return (hi - u).maximum(u - lo)


def _dp_leaf_check(k, leaves, rounding: float = 0.0):
    """Step ``k``'s params and AdamW moments against the one-device step's
    from the same state, leaf by leaf, under the ``DP_*`` rule.
    ``leaves``: key -> a callable that yields the leaf's parts, each
    (params got, want, mu got, want, nu got, want) of the same elements
    (``_whole_parts``: the whole leaf as one; called twice, for the
    leaf's maxima and then its elements). ``rounding``: the moments'
    storage unit roundoff (0 for f32; 2^-8 for bf16, where each side
    rounds its f32 moment, so an element may also differ by 2 x 2^-8 of
    its value). Returns (the largest moment error of a leaf's max, the
    share of elements whose tolerance reaches the 2.5 lr cap, the largest
    |diff|, the failures)."""
    fails, m_err = [], 0.0
    capped = total = 0
    worst = 0.0
    cap = 2.5 * DP_LR
    for key, parts in leaves.items():
        # per moment: the largest |diff|, the largest beyond the storage
        # rounding, the largest |want|; and the params' largest |want|
        dm, over, top = ({"mu": 0.0, "nu": 0.0} for _ in range(3))
        top_p = 0.0
        for part in parts():
            top_p = max(top_p, float(part[1].float().abs().max()))
            for name, gm, wm in (("mu", *part[2:4]), ("nu", *part[4:6])):
                b = wm.float()
                diff = (gm.float() - b).abs()
                dm[name] = max(dm[name], float(diff.max()))
                over[name] = max(over[name], float(
                    (diff - 2 * rounding * b.abs()).clamp_min(0).max()))
                top[name] = max(top[name], float(b.abs().max()))
        for name in ("mu", "nu"):
            err = over[name] / max(top[name], 1e-30)
            m_err = max(m_err, err)
            if err > TRAIN_GRAD_TOL:
                fails.append(f"{name} of {key} off by {err:.3g} of its max")
        for gp, wp, _, mu, _, nu in parts():
            a, b = gp.float(), wp.float()
            off = (a - b).abs()
            spread = DP_LR * _adam_step_spread(mu.float(), nu.float(),
                                               dm["mu"], dm["nu"], k)
            tol = (DP_PARAM_TOL * top_p + DP_STEP_TOL * DP_LR
                   + spread).clamp_max(cap)
            bad = off > tol
            if bool(bad.any()):
                fails.append(f"{key}: {int(bad.sum())} of {off.numel()} "
                             f"elements past their tolerance, max |diff| "
                             f"{float(off[bad].max()):.3g}")
            capped += int((tol >= cap).sum())
            total += off.numel()
            worst = max(worst, float(off.max()))
    return m_err, capped / total, worst, fails[:8]


def _whole_parts(got, want, moments):
    """``_dp_leaf_check``'s leaves from flat dicts of whole leaves:
    ``got`` and ``want`` params, ``moments`` ((mu, nu) got, (mu, nu)
    want)."""
    (gm, gv), (wm, wv) = moments
    return {key: (lambda key=key: [(got[key], want[key], gm[key], wm[key],
                                    gv[key], wv[key])]) for key in want}


def _dp_rank(rank, out_dir, seed, device="cuda", tp_leg=False):
    """One rank of 22(c) and (d) on a (world, 1) mesh (spawned); with
    ``tp_leg`` (2 gloo ranks sharing one card) 24(a) after them, in the
    same processes (``_tpt_leg``: no spawn of its own). (c):
    smollm-135m at full width in f32, ``DP_F32_STEPS`` data-parallel steps
    on its rows of ``DP_BATCH`` global batches, each followed (rank 0) by
    the one-device step on the global batch from the state the step began
    from, compared; ``DP_BF16_STEPS`` bf16 steps
    timed. (d): ``FederatedTrainer`` on ``LM.loss``, each data rank an
    edge cloud with its own ``TokenStream``, ``FED_ROUNDS`` rounds of
    ``FED_LOCAL`` steps; the ranks' params hashed after each round, and
    (rank 0) a one-process simulation. Its record to ``out_dir``."""
    import hashlib
    import itertools

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally
    from repro_torch.models.model import LM
    from repro_torch.optim import (adamw_init, linear_warmup_cosine,
                                   sgd_init, sgd_update)
    from repro_torch.training import FederatedTrainer
    from repro_torch.training.train_loop import (gather_whole, loss_and_grads,
                                                 make_train_step,
                                                 mesh_loss_and_grads,
                                                 place_train_params, rebuild,
                                                 train_splits)
    from repro_torch.utils.tree import flat_paths, tree_leaves, tree_map

    nccl = dist.get_backend() == "nccl"
    if device == "cuda":
        if not nccl:
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        device = f"cuda:{rank}" if nccl else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rec = {}

    def data_legs():
        """(c) and (d) into ``rec``; their memory goes with the call."""
        mesh = make_host_mesh(1, device=dev)
        world, lead = mesh.size, rank == 0

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        def to_dev(b):
            return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

        t0 = time.perf_counter()
        # (c) f32: the data-parallel steps, then the one-device ones
        cfg32 = dataclasses.replace(get_config(DP_MODEL),
                                    param_dtype="float32")
        lm = LM(cfg32, device=dev)
        start = lm.init(seed, on_device=True)
        params = place_train_params(mesh, lm, start)
        if not lead:
            del start
        host = list(zip(range(DP_F32_STEPS), TokenStream(
            cfg32.vocab_size, seed=seed).batches(*DP_BATCH)))
        step = make_train_step(lm, _dp_f32_schedule, mesh=mesh)
        dims = tree_leaves(train_splits(mesh, lm))
        opt = adamw_init(params)
        losses, ref, checks = [], [], []
        if lead:
            ref_step = make_train_step(lm, _dp_f32_schedule)
            p, o = start, adamw_init(start)
        reset_launches()
        for i, hb in host:
            rows = next(ShardedLoader(iter([hb]), mesh=mesh, device=dev))
            if i == 0:
                _, _, g1 = mesh_loss_and_grads(lm, mesh, params, rows, dims)
                g1 = rebuild(g1, gather_whole(mesh, tree_leaves(g1), dims))
            params, opt, m = step(params, opt, rows)
            losses.append(float(m["loss"]))
            got = rebuild(params, gather_whole(mesh, tree_leaves(params),
                                               dims))
            mom = [rebuild(params, gather_whole(mesh, tree_leaves(t), dims))
                   for t in (opt.mu, opt.nu)]
            if lead:
                # the one-device step on the global batch from the state this
                # step started from (the data-parallel one after the first)
                b = to_dev(hb)
                if i == 0:
                    _, _, rg1 = loss_and_grads(lm, p, b)
                    a, w = flat_paths(g1), flat_paths(rg1)
                    grad_err = max(float((a[k] - w[k]).abs().max()
                                         / w[k].abs().max().clamp_min(1e-30))
                                   for k in w)
                    del rg1
                p, o, m = ref_step(p, o, b)
                ref.append(float(m["loss"]))
                checks.append(_dp_leaf_check(i + 1, _whole_parts(
                    flat_paths(got), flat_paths(p),
                    ([flat_paths(t) for t in mom],
                     [flat_paths(o.mu), flat_paths(o.nu)]))))
                p, o = got, o._replace(mu=mom[0], nu=mom[1])
            del got, mom
        rec["f32"] = dict(losses=losses, launches=dict(LAUNCHES),
                          seconds=time.perf_counter() - t0)
        if lead:
            rec["f32"].update(ref_losses=ref, grad_err=grad_err, steps=checks)
            del p, o, start
        del params, opt, g1
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        mesh.barrier()
        # (c) bf16: timed steps
        t0 = time.perf_counter()
        cfg16 = get_config(DP_MODEL)
        lm16 = LM(cfg16, device=dev)
        params = place_train_params(mesh, lm16,
                                    lm16.init(seed, on_device=True))
        opt = adamw_init(params)
        step = make_train_step(lm16, linear_warmup_cosine(3e-3, 5,
                                                          DP_BF16_STEPS),
                               mesh=mesh)
        # the f32 steps' global batches in turn (numpy makes one in 2-6 s), as
        # phase 18 takes TRAIN_DISTINCT batches
        loader = ShardedLoader(itertools.cycle([hb for _, hb in host]),
                               mesh=mesh, device=dev)
        times, losses = [], []
        reset_launches()
        for _ in range(DP_BF16_STEPS):
            b = next(loader)
            sync()
            ts = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - ts) * 1e3)
        rec["bf16"] = dict(
            ms=times, losses=losses, launches=dict(LAUNCHES),
            param_bytes=sum(t.numel() * t.element_size()
                            for t in tree_leaves(params)),
            moment_bytes=sum(t.numel() * t.element_size()
                             for t in tree_leaves((opt.mu, opt.nu))),
            whole_param_bytes=_spec_bytes(lm16.param_spec()),
            peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0,
            seconds=time.perf_counter() - t0)
        del params, opt
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # (d) FedAvg over the ranks, each an edge cloud
        t0 = time.perf_counter()
        fed_start = lm.init(seed + 1, on_device=True)

        def loss_fn(p, b):
            return lm.loss(p, b, train=True)[0]

        clouds = [to_dev(next(TokenStream(
            cfg32.vocab_size, seed=seed + 100 + c).batches(*FED_BATCH)))
            for c in range(world)]
        ft = FederatedTrainer(loss_fn, mesh, lr=FED_LR, local_steps=FED_LOCAL)
        params = ft.replicate(fed_start)
        opt = ft.init_opt(params)
        fed = dict(losses=[], digests=[], rounds=[], counts=[])
        reset_launches()
        for _ in range(FED_ROUNDS):
            before = dict(COLLECTIVES)
            params, opt, loss = ft.round(params, opt, clouds[mesh.data_rank])
            fed["counts"].append(tally(COLLECTIVES, "axis", before))
            fed["losses"].append(float(loss))
            h = hashlib.sha1()
            for t in tree_leaves(params):
                h.update(t.detach().cpu().numpy().tobytes())
            box = [None] * world
            dist.all_gather_object(box, h.hexdigest(), group=mesh._host)
            fed["digests"].append(box)
            if lead:
                fed["rounds"].append(tree_map(lambda t: t.detach().clone(),
                                              params))
        fed["launches"] = dict(LAUNCHES)
        if lead:
            # the one-process simulation: the replicas stepped in turn, then
            # their f32 mean
            reps = [tree_map(lambda t: t.clone(), fed_start)
                    for _ in range(world)]
            opts = [sgd_init(r) for r in reps]
            errs = []
            for rnd in range(FED_ROUNDS):
                for c in range(world):
                    for _ in range(FED_LOCAL):
                        live = tree_map(lambda t: t.detach().requires_grad_(),
                                        reps[c])
                        leaves = tree_leaves(live)
                        with torch.enable_grad():
                            loss = loss_fn(live, clouds[c])
                            grads = torch.autograd.grad(loss, leaves,
                                                        allow_unused=True)
                        g = rebuild(reps[c], [torch.zeros_like(x) if d is None
                                              else d
                                              for x, d in zip(leaves, grads)])
                        reps[c], opts[c] = sgd_update(reps[c], g, opts[c],
                                                      lr=FED_LR)
                flats = [flat_paths(r) for r in reps]
                mean = {k: sum(f[k].float() for f in flats) / world
                        for k in flats[0]}
                reps = [rebuild(fed_start, list(mean.values()))
                        for _ in range(world)]
                mine = flat_paths(fed["rounds"][rnd])
                errs.append(max(float((mine[k] - mean[k]).abs().max()
                                      / mean[k].abs().max().clamp_min(1e-30))
                                for k in mean))
            fed["sim_err"] = errs
        del fed["rounds"]
        fed["seconds"] = time.perf_counter() - t0
        rec["fed"] = fed

    data_legs()
    if tp_leg:
        gc.collect()
        if cuda:
            # its peers' shards reach rank 0 by CUDA IPC, which takes plain
            # segments (the allocator keeps its expandable ones apart)
            torch.cuda.empty_cache()
            with warnings.catch_warnings():     # its newer name is private
                warnings.simplefilter("ignore", FutureWarning)
                torch.cuda.memory._set_allocator_settings(
                    "expandable_segments:False")
        rec["tp_train"] = _tpt_leg(torch, make_host_mesh(TPT_RANKS,
                                                         device=dev),
                                   dev, seed)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def check_data_parallel(torch, dev, seed, smi, ranks, backend):
    """22(c) and (d) on ``ranks`` processes over ``backend`` (``_dp_rank``;
    on 2 gloo ranks 24(a)'s leg too, its records under ``tp_train``),
    held: each of ``DP_F32_STEPS`` f32 data-parallel steps against the
    one-device step from the same state, its loss within
    ``TRAIN_LOSS_TOL``, the first step's reduced gradient every leaf's
    within ``TRAIN_GRAD_TOL`` of its max |g|, the moments and params under
    the ``DP_*`` rule (``_dp_leaf_check``); the bf16 ms a
    step, each rank's params and moments bytes (1/ranks of the whole
    where the train rules split), the flash launches a step; FedAvg: the
    ranks' params bit-equal after each round, each round one all-reduce
    over 'data' and no other collective, within ``FED_TOL`` of the
    one-process simulation, the mean loss falling. Returns (record, rank
    0's launches)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    recs = _spawn_ranks(_dp_rank, ranks, (seed, dev.type,
                                          backend == "gloo"), backend)
    lead = recs[0]
    f32, bf16, fed = lead["f32"], lead["bf16"], lead["fed"]
    label = f"smollm-135m data-parallel on {ranks} {backend} ranks"
    for r, rec in enumerate(recs):
        if rec["f32"]["losses"] != f32["losses"] or \
                rec["bf16"]["losses"] != bf16["losses"]:
            raise AssertionError(f"{label}: rank {r}'s losses differ")
    for a, b in zip(f32["losses"], f32["ref_losses"]):
        if abs(a - b) > TRAIN_LOSS_TOL * abs(b):
            raise AssertionError(f"{label}: f32 losses {f32['losses']} != "
                                 f"the one-device {f32['ref_losses']}")
    if f32["grad_err"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"{label}: a reduced gradient leaf is off by "
                             f"{f32['grad_err']:.3g} of its max |g|")
    for k, (_, _, _, fails) in enumerate(f32["steps"], 1):
        if fails:
            raise AssertionError(f"{label}: after step {k}: "
                                 + "; ".join(fails))
    cfg = get_config(DP_MODEL)
    want = _train_launches(cfg, DP_BF16_STEPS)
    for k in ("flash_attention", "flash_attention_bwd"):
        if bf16["launches"].get(k, 0) != want[k]:
            raise AssertionError(f"{label}: {k} launched "
                                 f"{bf16['launches'].get(k, 0)} times in "
                                 f"{DP_BF16_STEPS} steps, want {want[k]}")
    ms = statistics.median(bf16["ms"][2:])
    print(f"  {label}, f32, {DP_F32_STEPS} steps of {DP_BATCH[0]} x "
          f"{DP_BATCH[1]}: losses {[round(x, 6) for x in f32['losses']]} "
          f"against one device's {[round(x, 6) for x in f32['ref_losses']]}"
          f"; first-step gradient within {f32['grad_err']:.2g} of each "
          f"leaf's max |g|; after each step, the moments within "
          f"{[f'{c[0]:.2g}' for c in f32['steps']]} of each leaf's max, the"
          f" params within {DP_PARAM_TOL} max|p| + {DP_STEP_TOL} lr + the "
          f"moments' spread (the 2.5 lr cap for "
          f"{[f'{c[1]:.2g}' for c in f32['steps']]} of the elements), max "
          f"|diff| {[f'{c[2]:.3g}' for c in f32['steps']]}")
    print(f"  {label}, bf16 [{smi}]: {ms:.1f} ms a step (median of steps "
          f"3-{DP_BF16_STEPS}), loss {bf16['losses'][0]:.3f} -> "
          f"{bf16['losses'][-1]:.3f}; params {bf16['param_bytes'] / 1e6:.1f}"
          f" MB and moments {bf16['moment_bytes'] / 1e6:.1f} MB a rank (of "
          f"{bf16['whole_param_bytes'] / 1e6:.1f} MB of params whole); "
          f"peak {bf16['peak_bytes'] / 1e9:.2f} GB; launches "
          f"{bf16['launches']}")
    for r, rec in enumerate(recs):
        for rnd, box in enumerate(rec["fed"]["digests"]):
            if len(set(box)) != 1:
                raise AssertionError(f"{label}: FedAvg round {rnd}: the "
                                     f"ranks' params differ")
        for rnd, c in enumerate(rec["fed"]["counts"]):
            if c != {"model": 0, "data": 1, "world": 0}:
                raise AssertionError(f"{label}: FedAvg round {rnd} issued "
                                     f"{c} collectives")
    if max(fed["sim_err"]) > FED_TOL or \
            not fed["losses"][-1] < fed["losses"][0]:
        raise AssertionError(f"{label}: FedAvg against the simulation "
                             f"{fed['sim_err']}, losses {fed['losses']}")
    print(f"  {label}: rank 0's seconds: f32 (with the one-device steps) "
          f"{f32['seconds']:.1f}, bf16 {bf16['seconds']:.1f}, FedAvg (with "
          f"the simulation) {fed['seconds']:.1f}; the phase "
          f"{time.perf_counter() - t0:.1f} with the spawn")
    print(f"  FedAvg on {ranks} edge clouds ({FED_ROUNDS} rounds of "
          f"{FED_LOCAL} local steps, {FED_BATCH[0]} x {FED_BATCH[1]} a "
          f"cloud, f32): the ranks' params bit-equal after every round; one"
          f" all-reduce over 'data' a round and no other collective; "
          f"within {max(fed['sim_err']):.2g} of the one-process simulation;"
          f" mean loss {fed['losses']}; launches {fed['launches']}")
    launches = collections.Counter(bf16["launches"])
    launches.update(f32["launches"])
    launches.update(fed["launches"])
    return dict(ranks=ranks, backend=backend, f32=f32,
                bf16=dict(bf16, median_ms=ms), fed=fed,
                tp_train=[r.get("tp_train") for r in recs],
                seconds=time.perf_counter() - t0), dict(launches)


def check_data_axis(torch, dev, seed, smi, legs="abcd", tp_stats=None):
    """Phase 22, its ``legs``: (a) ``DATA_MESH_GLOO`` on a (2, 2) mesh of
    4 gloo ranks sharing this card, eager (``_dm_serve``; qwen3-4b's
    streams also against phase 19's (1, 2) mesh when given); (b) with 4
    cards or more, ``DATA_MESH_CARDS`` whole on a (2, 2) NCCL mesh, graphed
    (against phase 19's four-card streams when given); (c) and (d) on
    min(cards, 4) NCCL ranks, or 2 gloo ranks sharing this card
    (``check_data_parallel``). Returns (record, launches of (a)'s rank 0
    and of (c) and (d))."""
    rec, launches = {}, collections.Counter()
    for name, depth, backends in DATA_MESH_GLOO if "a" in legs else ():
        other = None
        if tp_stats is not None and name in tp_stats:
            other = {b: tp_stats[name][b]["ranks"][0]["streams"]
                     for b in backends if b in tp_stats[name]}
        got = _dm_serve(torch, dev, seed, smi, name, depth, backends, 4,
                        "gloo", False, other)
        for b in backends:
            launches.update(got[b]["ranks"][0]["launches"])
        rec[f"{name}_gloo"] = got
        gc.collect()
        torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if "b" in legs and cards >= 4:
        other = None
        if tp_stats is not None and "nccl_4" in tp_stats:
            other = {b: tp_stats["nccl_4"][b]["ranks"][0]["streams"]
                     for b in ("ring", "paged")}
        rec[f"{DATA_MESH_CARDS}_nccl_4"] = _dm_serve(
            torch, dev, seed, smi, DATA_MESH_CARDS, None, ("ring", "paged"),
            4, "nccl", True, other)
    elif "b" in legs:
        print(f"  {cards} card{'s' * (cards > 1)}: 22(b), the (2, 2) NCCL "
              f"mesh, needs 4 cards; skipped")
    if "c" in legs:
        n = min(cards, 4)
        ranks, backend = (n, "nccl") if n >= 2 else (2, "gloo")
        rec["train"], got = check_data_parallel(torch, dev, seed, smi,
                                                ranks, backend)
        launches.update(got)
    return rec, dict(launches)


SUP_MODEL = "smollm-135m"            # 23(a): whole, on gloo ranks
SUP_RANKS = 2
SUP_STEP_TIMEOUT = 2.0               # s, the watchdog's deadline a step
SUP_GRACE = 0.5                      # of the deadline
SUP_HANG_S = SUP_STEP_TIMEOUT * (1 + SUP_GRACE) + 2.0   # step 2's stall
SUP_RELEASED = 0.25                  # of the engine's own bytes left after
SUP_CARDS = "qwen3-4b"               # 23(b): whole, NCCL, graphed


def _sup_rank(rank, out_dir, cfg, seed, reqs, device="cuda"):
    """One rank of 23(a) (spawned; gloo, card 0 shared): the trace served
    uninterrupted on the mesh (every rank the same calls), then again
    through rank 0's gateway over a ``MeshLeader`` (journal, a snapshot
    every step, the watchdog), every rank's fault plan stalling step 2
    past the grace window; after the wedge, each rank's engine written
    off (a weak reference to it dead, the bytes it held released) before
    ``rebuild`` makes the fresh one (weights drawn again from ``seed``),
    ``recover_engine`` over the leader and ``MeshLeader.run``. gloo's
    collectives cannot be captured, so these engines serve eager and
    ``warm_compile`` (which refuses a gloo mesh on the card) is skipped.
    Its record to ``out_dir`` (``device="cpu"`` rehearses it on the CPU,
    memory read as 0)."""
    import asyncio
    import tempfile
    import weakref

    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.serving import (EngineWedgedError, FaultPlan,
                                     MeshLeader, RequestJournal,
                                     ServingEngine, ServingGateway, follow,
                                     recover_engine)

    dev = torch.device("cuda:0" if device == "cuda" else device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False

    def mem(peak=False):
        if not cuda:
            return 0
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() if peak
                else torch.cuda.memory_allocated())

    mesh = make_host_mesh(torch.distributed.get_world_size(), device=dev)
    lm = LM(cfg, device=dev)
    rec = {"released": []}

    def build(plan=None):
        eng = ServingEngine(lm, lm.init(seed, on_device=True, mesh=mesh),
                            batch_slots=8, max_seq_len=TP_SEQ, seed=seed,
                            max_decode_steps=4, mesh=mesh, fault_plan=plan)
        eng.warm_compile = lambda: None
        return eng

    def rebuild(ref):
        def fresh():
            rec["released"].append(ref() is None)
            rec["after_release_bytes"] = mem()
            rec["peak_before_bytes"] = mem(peak=True)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            return build()
        return fresh

    eng = build()
    out, _ = _serve(eng, reqs, TP_MAX_NEW)
    rec["uninterrupted"] = [r.output.tolist() for r in out]
    del eng, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    plan = FaultPlan(seed=seed, hang=[2], hang_s=SUP_HANG_S)
    rec["base_bytes"] = mem()
    reset_launches()
    if mesh.rank:
        box = [build(plan)]
        ref = weakref.ref(box[0])
        rec["held_bytes"] = mem()
        follow(box.pop(), mesh, rebuild=rebuild(ref))
    else:
        state = tempfile.mkdtemp(prefix="sup_")
        journal = RequestJournal(os.path.join(state, "journal.jsonl"))
        snaps = os.path.join(state, "snapshots")
        eng = build(plan)
        ref = weakref.ref(eng)
        rec["held_bytes"] = mem()
        leader = MeshLeader(eng, mesh)
        del eng
        gw = ServingGateway(leader, journal=journal, snapshot_dir=snaps,
                            snapshot_every=1, step_timeout_s=SUP_STEP_TIMEOUT,
                            hang_grace=SUP_GRACE)
        before = {}

        async def clients():
            async with gw:
                hs = [await gw.submit(p, max_new_tokens=TP_MAX_NEW,
                                      temperature=t) for p, t in reqs]

                async def read(h):
                    toks = [int(x) async for x in h.stream()]
                    before[h.request_id] = ((await h.result()).status, toks)

                await asyncio.gather(*(read(h) for h in hs))

        try:
            asyncio.run(clients())
            rec["wedged"] = False
        except EngineWedgedError:
            rec["wedged"] = True
        stats = gw.stats()
        first = []
        restart = time.perf_counter()
        leader.rebuild(rebuild(ref))
        leader.on_tokens = lambda ev: first or first.append(
            time.perf_counter())
        info = recover_engine(leader, snapshot_dir=snaps, journal=journal)
        done = leader.run()
        mem()
        leader.assert_invariants()
        leader.stop()
        journal.close()
        streams = {rid: toks for rid, (status, toks) in before.items()
                   if status == "done"}
        streams.update({rid: r.output.tolist() for rid, r in done.items()
                        if r.status == "done"})
        rec.update(
            streams=[streams.get(i) for i in range(len(reqs))],
            done_before=sum(st == "done" for st, _ in before.values()),
            watchdog_timeouts=stats["watchdog_timeouts"],
            snapshots_taken=stats["snapshots_taken"],
            restored=info["restored"], replayed=info["replayed"],
            restart_to_first_token_ms=(first[0] - restart) * 1e3
            if first else None)
    rec["launches"] = dict(LAUNCHES)
    rec["peak_after_bytes"] = mem(peak=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _sup_gloo(torch, dev, seed, smi):
    """23(a): ``SUP_MODEL`` whole on ``SUP_RANKS`` gloo ranks sharing this
    card (``_sup_rank``), against ``mesh=None`` (its ring streams and
    their near-ties computed first, then its weights freed): the wedge
    happened, every rank released its written-off engine before the
    rebuild, no acknowledged request was lost, every stream equals the
    mesh's uninterrupted one token for token and ``mesh=None``'s or parts
    first at a near-tie; restart -> first token, peak memory a rank before
    the wedge and after the restart. Returns (record, rank 0's launches
    over the wedged run and the restart)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = get_config(SUP_MODEL)
    lm = LM(cfg, device=dev)
    params = lm.init(seed, on_device=True)
    reqs = _tp_trace(seed, cfg.vocab_size)
    base, _, _ = _tp_base(torch, seed, lm, params, reqs, False,
                          backends=("ring",))
    ties = _quiet(_teacher_ties, torch, lm, params, seed, reqs, base["ring"])
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = _spawn_ranks(_sup_rank, SUP_RANKS, (cfg, seed, reqs, dev.type),
                        "gloo")
    seconds = time.perf_counter() - t0
    lead = recs[0]
    label = f"{SUP_MODEL} (whole) on {SUP_RANKS} gloo ranks of this card"
    if not lead["wedged"] or lead["watchdog_timeouts"] < 1:
        raise AssertionError(f"{label}: the hang seam never wedged the "
                             f"engine")
    for r, rec in enumerate(recs):
        if rec["uninterrupted"] != lead["uninterrupted"]:
            raise AssertionError(f"{label}: rank {r}'s uninterrupted "
                                 f"streams differ from rank 0's")
        own = rec["held_bytes"] - rec["base_bytes"]
        if rec["released"] != [True] or rec["after_release_bytes"] - \
                rec["base_bytes"] > SUP_RELEASED * own:
            raise AssertionError(
                f"{label}: rank {r} built its fresh engine beside the old "
                f"one (released {rec['released']}, "
                f"{rec['after_release_bytes']} B left of "
                f"{rec['held_bytes']} B)")
    lost = [i for i, got in enumerate(lead["streams"]) if got is None]
    if lost:
        raise AssertionError(f"{label}: requests {lost} lost")
    if lead["streams"] != lead["uninterrupted"]:
        raise AssertionError(f"{label}: a resumed stream differs from the "
                             f"uninterrupted run's")
    equal = parted = 0
    for rid, (got, want) in enumerate(zip(lead["streams"], base["ring"])):
        if got == want:
            equal += 1
            continue
        p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        if not ties["ring"][rid][p]:
            raise AssertionError(f"{label}: request {rid} parts from "
                                 f"mesh=None at token {p}, not at a "
                                 f"near-tie")
        parted += 1
    launches = lead["launches"]
    if not (launches["decode_attention"] and launches["flash_attention"]):
        raise AssertionError(f"{label}: no kernel launched: {launches}")
    gib = 2 ** 30
    print(f"  {label}, ring, eager [{smi}]: wedged at step 2 "
          f"({SUP_HANG_S:.1f} s stall against a {SUP_STEP_TIMEOUT:.1f} s "
          f"deadline + {SUP_GRACE} grace) after "
          f"{lead['watchdog_timeouts']} watchdog timeout(s), "
          f"{lead['snapshots_taken']} snapshots, {lead['done_before']} done "
          f"before; every rank released its engine before the rebuild "
          f"(allocated before the engine / with it / after its release: " +
          ", ".join(f"rank {r} {rec['base_bytes'] / gib:.3f} / "
                    f"{rec['held_bytes'] / gib:.3f} / "
                    f"{rec['after_release_bytes'] / gib:.3f} GiB"
                    for r, rec in enumerate(recs)) + ")")
    print(f"    restart: recovered {lead['restored']} + replayed "
          f"{lead['replayed']}, restart -> first token "
          f"{lead['restart_to_first_token_ms']:.0f} ms, warm_compile "
          f"skipped (gloo: eager); peak a rank before the wedge / after "
          f"the restart: " + ", ".join(
              f"{rec['peak_before_bytes'] / gib:.3f} / "
              f"{rec['peak_after_bytes'] / gib:.3f} GiB" for rec in recs))
    print(f"    no acknowledged request lost; {len(reqs)} streams equal the "
          f"mesh's uninterrupted run token for token; against mesh=None "
          f"{equal} equal, {parted} part first at a near-tie; launches "
          f"(rank 0, wedged run and restart) {launches}; {seconds:.1f} s")
    return dict(ranks=recs, equal=equal, parted=parted,
                seconds=seconds), launches


def _sup_cards(smi, n):
    """23(b): ``launch/serve.py --arch SUP_CARDS --no-reduced --mesh n
    --wedge-demo`` on n cards over NCCL, graphed: the launcher's own
    lines say it wedged, restarted once and drained every request."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           SUP_CARDS, "--no-reduced", "--mesh", str(n), "--wedge-demo",
           "--snapshot-every", "1", "--quiet"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=root, env=dict(os.environ, PYTHONPATH=os.path
                                            .join(root, "src")))
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("engine wedged", "recovered", "restart:",
                               "durability"))]
    label = f"{SUP_CARDS} (whole) on {n} cards over NCCL, graphed"
    if out.returncode or "post-restart drain: {'done': 8}" not in out.stdout \
            or "'restarts': 1" not in out.stdout:
        raise AssertionError(f"{label}: serve --wedge-demo failed "
                             f"(exit {out.returncode}):\n{out.stdout[-2000:]}"
                             f"\n{out.stderr[-2000:]}")
    print(f"  {label} [{smi}]: serve --wedge-demo in {seconds:.1f} s:")
    for ln in lines:
        print(f"    {ln}")
    return dict(lines=lines, seconds=seconds)


def check_supervise(torch, dev, seed, smi):
    """Phase 23: (a) ``_sup_gloo``; (b) with 2 cards or more,
    ``_sup_cards`` on min(cards, 4). Returns (record, (a)'s launches)."""
    rec, launches = _sup_gloo(torch, dev, seed, smi)
    rec = {"gloo": rec}
    cards = torch.cuda.device_count()
    if cards >= 2:
        gc.collect()
        torch.cuda.empty_cache()
        rec["nccl"] = _sup_cards(smi, min(cards, 4))
    else:
        print("  1 card: 23(b), serve --wedge-demo over NCCL, needs 2 "
              "cards; skipped")
    return rec, launches


# -- phase 24: training on a model axis above 1 ---------------------------------

# 24(a): (model, what is held, its cut, its moments' dtype) on a (1, 2)
# mesh of gloo ranks sharing one card, f32, TPT_STEPS steps of
# make_train_step(mesh=) on TPT_BATCH global batches. "state": each
# step's loss, params and moments against the one-device step from the
# state the mesh's step began from (``_tpt_ref_parts``, held by
# ``_dp_leaf_check``), and the first step's gradient. qwen3-4b at 19(b)'s
# 4-layer cut; recurrentgemma-9b's (rec, rec, attn) repeat, 2.8 B values,
# whose moments are stored in bf16 (the port's ``adamw_init(...,
# torch.bfloat16)``; in f32 the ranks' old and new states and gradients
# in a step, 77 GB, pass what the card leaves) and held at that precision
TPT_MODELS = (("qwen3-4b", "state", 4, "float32"),
              ("recurrentgemma-9b", "state", None, "bfloat16"))
TPT_RANKS = 2
TPT_STEPS = 3
TPT_BATCH = (2, 256)
TPT_WD, TPT_CLIP = 0.01, 1.0       # make_train_step's weight decay, clip
# 24(b), with 4 cards: launch/train.py on TPT_CARDS whole, bf16, on a (1, 4)
# NCCL mesh (warm, timed steps; each global batch drawn once, by one rank:
# its TokenStream takes ~28 s of a host core at glm4-9b's vocab), then its
# f32 4-layer cut on the same mesh, "grads": each step's loss and the
# first gradient (its whole f32 state gathered beside one device's step
# would not fit a card)
TPT_CARDS = "glm4-9b"
TPT_CARD_BATCH = (4, 4096)
TPT_CARD_STEPS = (2, 10)
TPT_CARD_LR = 1e-3                # peak, after launch/train.py's warm-up
TPT_CARD_F32 = (("glm4-9b", "grads", 4, "float32"),)


def _tpt_cfg(name, cut):
    """24's f32 cut of ``name``, widths whole: ``cut`` repeats of its first
    stage, or (repeats a stage, routed experts kept), or None (whole);
    recurrentgemma-9b its (rec, rec, attn) repeat."""
    from repro_torch.configs import get_config

    if name == "recurrentgemma-9b":
        return _cut_stages(_hybrid_cfg("float32"), (1,))
    cfg = dataclasses.replace(get_config(name), param_dtype="float32")
    if cut is None:
        return cfg
    repeats, experts = (cut if isinstance(cut, tuple) else ((cut,), None))
    return _cut_stages(cfg, repeats, experts=experts)


def _tpt_batches(cfg, seed, n):
    """``n`` global ``TPT_BATCH`` batches: ``TokenStream``'s text, or (a
    frontend) numpy's audio codebook tokens or text behind unit-norm image
    embeddings."""
    from repro_torch.data.synthetic import TokenStream

    b, s = TPT_BATCH
    fe = cfg.frontend
    if fe.kind == "none":
        host = TokenStream(cfg.vocab_size, seed=seed + 24).batches(b, s)
        return [next(host) for _ in range(n)]
    rng = np.random.default_rng(seed + 24)
    out = []
    for _ in range(n):
        shape = (b, s + 1) + ((fe.num_codebooks,) if fe.kind == "audio"
                              else ())
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if fe.kind == "vision":
            img = rng.standard_normal((b, fe.num_prefix_tokens,
                                       fe.embed_dim)).astype(np.float32)
            batch["image_embeds"] = img / np.linalg.norm(img, axis=-1,
                                                         keepdims=True)
        out.append(batch)
    return out


def _tpt_regions(tp, bdef):
    """A block's collectives over 'model' on a training mesh: (its
    forward's, its backward's, whether its last op is one)."""
    i = int
    if bdef.mixer in ("attn", "mla"):
        on = i(tp.heads if bdef.mixer == "attn" else tp.mla_heads)
        f, b, last = on, on, on
    elif bdef.mixer == "rglru":
        f, b, last = 2 * i(tp.lru), 2 * i(tp.lru), i(tp.lru)
    elif bdef.mixer == "mlstm":
        f, b, last = i(tp.rec_heads), i(tp.rec_heads), i(tp.rec_heads)
    else:       # sLSTM: the gather after its loop; its GeGLU
        f = b = i(tp.rec_heads) + i(tp.rec_mlp)
        last = i(tp.rec_mlp)
    if bdef.mlp == "moe":
        routed = i(tp.experts or tp.expert_mlp)
        entry = i(bool(routed or tp.router or tp.shared_mlp))
        f, b, last = f + i(tp.router) + entry, b + entry + routed, entry
    elif bdef.mlp != "none":
        f, b, last = f + i(tp.mlp), b + i(tp.mlp), i(tp.mlp)
    return f, b, last


def _tpt_design(cfg, ranks):
    """The collectives over 'model' of one step on a (1, ``ranks``) mesh,
    by the design (``PERF.md`` §6): each scanned layer's forward
    ends each split region with its collective (an all-reduce of partial
    sums, two for the RG-LRU's gates and ``w_out``; the router's and the
    sLSTM's gathers), its remat runs them again but for the layer's last
    op (the checkpoint stops once it has what the backward needs), its
    backward sums the gradient at each region's entry (the RG-LRU's gates'
    cut and MoE's combine weights one more each); the MTP block, outside
    the checkpoint, once each way; then, with the vocab split, the
    embedding's reduce, the loss's max and its joined sums and the
    unembedding's entry (again for the MTP head); the sum of the partial
    leaves (``partial_leaves``, when any) and the clip's norm."""
    from repro_torch.configs.base import ATTN, MLA, SWIGLU, BlockDef
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.sharding import tensor_parallel
    from repro_torch.training.train_loop import partial_leaves
    from repro_torch.utils.tree import tree_leaves

    mesh = AbstractMesh(ranks)
    tp = tensor_parallel(cfg, mesh, mode="train")
    head = 4 * int(tp.vocab)
    n = 0
    for stage in cfg.stages:
        parts = [_tpt_regions(tp, b) for b in stage.blocks]
        n += stage.repeat * (2 * sum(p[0] for p in parts) - parts[-1][2]
                             + sum(p[1] for p in parts))
    if cfg.mtp_depth:
        f, b, _ = _tpt_regions(tp, BlockDef(
            mixer=MLA if cfg.mla else ATTN, mlp=SWIGLU))
        n += f + b + head
    partial = any(tree_leaves(partial_leaves(mesh, LM(cfg, device="cpu"))))
    return n + head + int(partial) + 1


def _tpt_pieces(torch, mesh, leaves, dims):
    """Every rank's shards of ``leaves`` (cut on ``dims`` over 'model', -1:
    whole) on rank 0, per leaf in model-rank order (a whole leaf: its
    own); None on the other ranks. Over NCCL (or on the CPU) one gather a
    dtype (each leaf comes back whole: one piece); gloo ranks sharing one
    card read
    each other's memory through CUDA IPC (no copy), which the peers keep
    until the next ``mesh.barrier()``."""
    from repro_torch.training.train_loop import gather_whole

    if mesh.backend == "nccl" or mesh.device.type != "cuda":
        whole = gather_whole(mesh, leaves, dims, "model")
        return [[w] for w in whole] if mesh.rank == 0 else None
    from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                  reduce_tensor)
    cut = [t for t, d in zip(leaves, dims) if d >= 0]
    box = [None] * mesh.size
    torch.distributed.all_gather_object(
        box, None if mesh.rank == 0 else [reduce_tensor(t)[1] for t in cut],
        group=mesh._host)
    if mesh.rank != 0:
        return None
    peers = [[rebuild_cuda_tensor(*a) for a in m] for m in box[1:]]
    out, i = [], 0
    for t, d in zip(leaves, dims):
        if d < 0:
            out.append([t])
        else:
            out.append([t] + [p[i] for p in peers])
            i += 1
    return out


def _tpt_whole(torch, pieces, dims):
    """Whole leaves from ``_tpt_pieces``' pieces."""
    return [p[0] if len(p) == 1 else torch.cat(p, d)
            for p, d in zip(pieces, dims)]


def _tpt_err(pieces, dims, want):
    """The largest |piece - its slice of want| over a leaf's max |want|, of
    every leaf, and the leaf."""
    worst, where = 0.0, None
    for key, p, d, w in zip(want, pieces, dims, want.values()):
        n = w.shape[d] // len(p) if d >= 0 else 0
        off = max(float((x.float() - (w if len(p) == 1 else w.narrow(
            d, i * n, n)).float()).abs().max()) for i, x in enumerate(p))
        e = off / max(float(w.abs().max()), 1e-30)
        if e >= worst:
            worst, where = e, key
    return worst, where


def _tpt_ref_parts(torch, keys, pieces, dims, grads, step, lr):
    """``_dp_leaf_check``'s leaves for a "state" step of 24(a): per leaf,
    per rank's piece of it and per run of its rows of at most
    ``optim.adamw._CHUNK`` elements, (the mesh's new params, the one-device
    step's; mu and nu alike), the one-device step made on demand from the
    old pieces and the one-device gradient ``grads`` (whole leaves, in
    ``keys``' order): AdamW at ``step`` (the old state's count) and ``lr``
    with ``TPT_WD``, its clip's scale taken from the whole gradient's norm
    as ``adamw_update`` takes it and applied to each part, as its own
    chunks apply it (the update is elementwise). ``pieces``: the six trees'
    ``_tpt_pieces`` (old params, mu, nu; new params, mu, nu)."""
    from repro_torch.optim.adamw import (_CHUNK, AdamWState, _global_sq,
                                         adamw_update)

    norm = torch.sqrt(_global_sq(grads, None, None))
    scale = torch.clamp(TPT_CLIP / torch.clamp(norm, min=1e-9), max=1.0)

    def parts(j):
        old_p, old_m, old_v, new_p, new_m, new_v = (t[j] for t in pieces)
        g, d = grads[j], dims[j]
        for r, p in enumerate(old_p):
            gr = g if d < 0 else g.narrow(d, r * p.shape[d], p.shape[d])
            rows = max(1, _CHUNK * p.shape[0] // p.numel()) if p.dim() \
                else None
            for i in range(0, p.shape[0] if p.dim() else 1, rows or 1):
                cut = slice(i, i + rows) if rows else ...
                w, st = adamw_update(
                    {"w": p[cut]}, {"w": gr[cut] * scale.to(g.dtype)},
                    AdamWState(step=step, mu={"w": old_m[r][cut]},
                               nu={"w": old_v[r][cut]}),
                    lr=lr, weight_decay=TPT_WD, grad_clip=None)
                yield (new_p[r][cut], w["w"], new_m[r][cut], st.mu["w"],
                       new_v[r][cut], st.nu["w"])

    return {key: (lambda j=j: parts(j)) for j, key in enumerate(keys)}


def _tpt_leg(torch, mesh, dev, seed, models=TPT_MODELS):
    """24(a) on this rank of a (1, M) mesh (every rank calls it): per model
    of ``models``, ``TPT_STEPS`` f32 steps of ``make_train_step(mesh=)``
    from ``LM.init(seed, mesh=, mode="train")``, rank 0 holding each
    against the one-device step (``TPT_MODELS``' comment), with the
    collectives over 'model' and the kernel launches of the mesh's steps
    alone, and the head layouts and scan widths they ran at. Returns the
    record."""
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import COLLECTIVES, tally
    from repro_torch.models import attention as att_mod
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw_init
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step,
                                                 mesh_loss_and_grads, rebuild,
                                                 train_splits)
    from repro_torch.utils.tree import flat_paths, tree_leaves

    lead = mesh.rank == 0
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def to_dev(b):
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    def settle():
        # the peers' views are dropped: hand the checks' memory back to
        # the card, which the ranks share
        mesh.barrier()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def whole(tree, pieces):
        return rebuild(tree, _tpt_whole(torch, pieces, dims))

    seen = {"flash": set(), "scan": set()}
    flash0, scan0 = att_mod.flash_attention, rec_mod.rglru_scan

    def flash(q, k, v, **kw):
        seen["flash"].add((q.shape[2], k.shape[2], q.shape[3]))
        return flash0(q, k, v, **kw)

    def scan(a, b, h0):
        seen["scan"].add(a.shape[-1])
        return scan0(a, b, h0)

    out = {}
    for name, held, layers, moments in models:
        t0 = time.perf_counter()
        cfg = _tpt_cfg(name, layers)
        lm = LM(cfg, device=dev)
        dims = tree_leaves(train_splits(mesh, lm, "model"))
        params = lm.init(seed, on_device=True, mesh=mesh, mode="train")
        keys = list(flat_paths(params))
        step = make_train_step(lm, _dp_f32_schedule, weight_decay=TPT_WD,
                               grad_clip=TPT_CLIP, mesh=mesh)
        batches = _tpt_batches(cfg, seed, TPT_STEPS)
        rec = dict(losses=[], ref_losses=[], steps=[], counts=[],
                   launches=collections.Counter())
        # the first step's gradient from the init, against one device
        rows = next(ShardedLoader(iter([batches[0]]), mesh=mesh, device=dev))
        _, _, g = mesh_loss_and_grads(lm, mesh, params, rows)
        ps = _tpt_pieces(torch, mesh, tree_leaves(params), dims)
        gs = _tpt_pieces(torch, mesh, tree_leaves(g), dims)
        if lead:
            rl, _, rg = loss_and_grads(lm, whole(params, ps),
                                       to_dev(batches[0]))
            rec["grad_err"], rec["grad_worst"] = _tpt_err(
                gs, dims, flat_paths(rg))
            first = float(rl)
            del rg
        del ps, gs
        settle()
        del g
        opt = adamw_init(params, getattr(torch, moments))
        for i, hb in enumerate(batches):
            rows = next(ShardedLoader(iter([hb]), mesh=mesh, device=dev))
            if held == "grads" and i:
                # the one-device loss from the params this step starts at
                ps = _tpt_pieces(torch, mesh, tree_leaves(params), dims)
                if lead:
                    with torch.no_grad():
                        loss, _ = lm.loss(whole(params, ps), to_dev(hb),
                                          train=True)
                    rec["ref_losses"].append(float(loss))
                del ps
                settle()
            elif held == "grads" and lead:
                # the gradient check's loss, from the same params
                rec["ref_losses"].append(first)
            old = (params, opt)
            sync()
            before, was = dict(COLLECTIVES), dict(LAUNCHES)
            att_mod.flash_attention, rec_mod.rglru_scan = flash, scan
            try:
                params, opt, m = step(params, opt, rows)
                sync()
            finally:
                att_mod.flash_attention, rec_mod.rglru_scan = flash0, scan0
            rec["counts"].append(tally(COLLECTIVES, "axis", before))
            rec["launches"].update({k: v - was.get(k, 0)
                                    for k, v in LAUNCHES.items()})
            rec["losses"].append(float(m["loss"]))
            if held == "state":
                # the one-device step from the old state, part by part
                # against the new one (every rank's pieces by IPC; the
                # peers' freed blocks handed back to the card first)
                if cuda:
                    torch.cuda.empty_cache()
                pieces = [_tpt_pieces(torch, mesh, tree_leaves(t), dims)
                          for t in (old[0], old[1].mu, old[1].nu, params,
                                    opt.mu, opt.nu)]
                if lead:
                    rl, _, rg = loss_and_grads(lm, whole(old[0], pieces[0]),
                                               to_dev(hb))
                    rec["ref_losses"].append(float(rl))
                    rec["steps"].append(_dp_leaf_check(
                        i + 1, _tpt_ref_parts(
                            torch, keys, pieces, dims, tree_leaves(rg),
                            old[1].step, _dp_f32_schedule(old[1].step)),
                        0.0 if moments == "float32" else 2.0 ** -8))
                    del rg
                del pieces
            del old
            settle()
        rec.update(launches=dict(rec["launches"]),
                   flash=sorted(seen["flash"]), scan=sorted(seen["scan"]),
                   seconds=time.perf_counter() - t0)
        seen["flash"].clear()
        seen["scan"].clear()
        out[name] = rec
        del params, opt, m
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        mesh.barrier()
    return out


def _tp_train_rank(rank, out_dir, seed, device="cuda", models=TPT_MODELS):
    """24(a) (``_tpt_leg``) as ranks of their own (spawned): on one card
    over gloo (``--only 24``, or beside 22(c) on NCCL ranks), or with
    ``models`` on one card a rank over NCCL (24(b)'s f32 cut)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if device == "cuda":
        device = f"cuda:{rank}" if dist.get_backend() == "nccl" else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    rec = _tpt_leg(torch, make_host_mesh(dist.get_world_size(), device=dev),
                   dev, seed, models)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _tpt_hold(recs, models, ranks, label, smi):
    """24(a)'s records held (``check_tp_training``); rank 0's launches."""
    launches = collections.Counter()
    for name, held, layers, moments in models:
        cfg = _tpt_cfg(name, layers)
        lead = recs[0][name]
        what = f"{name} ({cfg.num_layers} layers, f32) {label}"
        for r, rec in enumerate(recs):
            if rec[name]["losses"] != lead["losses"]:
                raise AssertionError(f"{what}: rank {r}'s losses differ")
        refs = lead["ref_losses"]
        bad = [(a, b) for a, b in zip(lead["losses"], refs)
               if abs(a - b) > TRAIN_LOSS_TOL * abs(b)]
        if bad or len(refs) != TPT_STEPS:
            raise AssertionError(f"{what}: losses {lead['losses']} against "
                                 f"one device's {refs}")
        if lead["grad_err"] > TRAIN_GRAD_TOL:
            raise AssertionError(f"{what}: the first gradient's "
                                 f"{lead['grad_worst']} off by "
                                 f"{lead['grad_err']:.3g} of its max |g|")
        if len(lead["steps"]) != TPT_STEPS * (held == "state"):
            raise AssertionError(f"{what}: {len(lead['steps'])} steps' "
                                 f"states held")
        for k, (_, _, _, fails) in enumerate(lead["steps"], 1):
            if fails:
                raise AssertionError(f"{what}: after step {k}: "
                                     + "; ".join(fails))
        want = _train_launches(cfg, TPT_STEPS)
        for k in ("flash_attention", "flash_attention_bwd", "rglru_scan",
                  "rglru_scan_bwd"):
            if lead["launches"].get(k, 0) != want[k]:
                raise AssertionError(f"{what}: {k} launched "
                                     f"{lead['launches'].get(k, 0)} times in "
                                     f"{TPT_STEPS} steps, want {want[k]}")
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        if cfg.mla is not None:     # one KV head a query head, at qk's width
            kv, hd = h, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        heads = [[h // ranks, kv // ranks if kv % ranks == 0 else 1, hd]] \
            if want["flash_attention"] else []
        widths = [cfg.resolved_lru_width // ranks] if want["rglru_scan"] \
            else []
        if lead["flash"] != heads or lead["scan"] != widths:
            raise AssertionError(f"{what}: flash ran at {lead['flash']} "
                                 f"(H, KV, hd), want {heads}; the scan at "
                                 f"widths {lead['scan']}, want {widths}")
        design = _tpt_design(cfg, ranks)
        for c in lead["counts"]:
            if c != {"model": design, "data": 0, "world": 0}:
                raise AssertionError(f"{what}: a step issued {c} "
                                     f"collectives, the design {design} over "
                                     f"'model'")
        launches.update(lead["launches"])
        state = ""
        if lead["steps"]:
            state = (f"; after each step the {moments} moments within "
                     f"{[f'{c[0]:.2g}' for c in lead['steps']]} of each "
                     f"leaf's max"
                     + (" beyond each element's bf16 rounding (2 x 2^-8 "
                        "of it)" if moments == "bfloat16" else "")
                     + f", the params as 22(c) holds them (the 2.5 lr cap "
                     f"for {[f'{c[1]:.2g}' for c in lead['steps']]} of the "
                     f"elements, max |diff| "
                     f"{[f'{c[2]:.3g}' for c in lead['steps']]})")
        print(f"  {what} [{smi}]: losses "
              f"{[round(x, 6) for x in lead['losses']]} against one "
              f"device's {[round(x, 6) for x in refs]} from the same "
              f"{'state' if held == 'state' else 'params'}; "
              f"first gradient within {lead['grad_err']:.2g} of each leaf's "
              f"max |g|{state}; flash at (H, KV, hd) {lead['flash']}"
              + (f", the scan at W {lead['scan']}" if widths else "")
              + f"; {design} collectives over 'model' a step (the design's);"
              f" launches {lead['launches']}; {lead['seconds']:.1f} s on "
              f"rank 0")
    return launches


def _tpt_cards(torch, seed, smi, n):
    """24(b) on ``n`` cards: ``launch/train.py --arch TPT_CARDS --no-reduced
    --mesh-model n`` (bf16, NCCL; its report), the loss falling and
    finite, the step's collectives the design's; then ``TPT_CARD_F32`` on
    the same mesh, held as (a)."""
    import tempfile

    from repro_torch.configs import get_config

    root = os.path.dirname(os.path.abspath(__file__))
    report = os.path.join(tempfile.mkdtemp(prefix="tpt_"), "report.json")
    warm, timed = TPT_CARD_STEPS
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TPT_CARDS, "--no-reduced", "--mesh-model", str(n), "--batch",
           str(TPT_CARD_BATCH[0]), "--seq", str(TPT_CARD_BATCH[1]),
           "--steps", str(warm + timed), "--warm", str(warm), "--lr",
           str(TPT_CARD_LR), "--report", report]
    log = report + ".log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        try:
            # the ranks make their batches on the host at once: a share
            # of its cores each
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                timeout=480, cwd=root,
                                env=dict(os.environ, PYTHONPATH=os.path.join(
                                    root, "src"), OMP_NUM_THREADS=str(max(
                                        1, (os.cpu_count() or n) // n))
                                         )).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout (480 s)"
    seconds = time.perf_counter() - t0
    label = f"{TPT_CARDS} whole on a (1, {n}) NCCL mesh, bf16"
    if rc or not os.path.exists(report):
        with open(log) as f:
            raise AssertionError(f"{label}: launch/train.py failed ({rc}) "
                                 f"after {seconds:.1f} s:\n"
                                 f"{f.read()[-4000:]}")
    with open(report) as f:
        rep = json.load(f)
    losses = rep["losses"]
    design = _tpt_design(get_config(TPT_CARDS), n)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    if rep["collectives"] != {"all_reduce/model": design}:
        raise AssertionError(f"{label}: a step's collectives "
                             f"{rep['collectives']}, the design {design}")
    print(f"  {label} [{smi}], B {TPT_CARD_BATCH[0]} x S "
          f"{TPT_CARD_BATCH[1]}: {rep['median_ms']:.1f} ms a step (median of"
          f" {timed} after {warm}; CUDA events, rank 0), "
          f"{rep['tokens_per_s']:.0f} tokens/s, 6·N·D "
          f"{rep['model_flops_share']:.3f} of {n} x 989 TFLOP/s (N "
          f"{rep['params'] / 1e9:.3f} B); peak {rep['peak_gib']:.2f} GiB a "
          f"rank; a rank's weights {rep['weight_bytes'] / 2 ** 30:.2f}, "
          f"gradients {rep['grad_bytes'] / 2 ** 30:.2f}, moments "
          f"{rep['moment_bytes'] / 2 ** 30:.2f} GiB; {design} all-reduces "
          f"over 'model' a step; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"the launcher {seconds:.1f} s")
    recs = _spawn_ranks(_tp_train_rank, n, (seed, "cuda", TPT_CARD_F32),
                        "nccl")
    launches = _tpt_hold(recs, TPT_CARD_F32, n, f"on a (1, {n}) NCCL mesh",
                         smi)
    return dict(report=rep, seconds=seconds,
                f32=recs[0]), launches


def check_tp_training(torch, dev, seed, smi, recs=None, legs="ab"):
    """Phase 24, its ``legs``: (a) ``TPT_MODELS`` on a (1, 2) mesh of gloo
    ranks sharing this card (``recs``: 22(c)'s ranks' records of it; else
    its own spawn), held by ``_tpt_hold``; (b) with 4 cards,
    ``_tpt_cards``. Returns (record, (a)'s rank-0 launches and (b)'s)."""
    t0 = time.perf_counter()
    rec, launches = {}, collections.Counter()
    if "a" in legs:
        if recs is None:
            recs = _spawn_ranks(_tp_train_rank, TPT_RANKS,
                                (seed, dev.type), "gloo")
        launches.update(_tpt_hold(recs, TPT_MODELS, TPT_RANKS,
                                  f"on a (1, {TPT_RANKS}) mesh of gloo "
                                  f"ranks on one card", smi))
        rec = {"gloo": recs[0], "seconds": time.perf_counter() - t0}
    cards = torch.cuda.device_count()
    if "b" in legs and cards >= 4:
        gc.collect()
        torch.cuda.empty_cache()
        rec["cards"], got = _tpt_cards(torch, seed, smi, 4)
        launches.update(got)
    elif "b" in legs:
        print(f"  {cards} card{'s' * (cards > 1)}: 24(b), {TPT_CARDS} whole "
              f"on a (1, 4) NCCL mesh, needs 4 cards; skipped")
    return rec, dict(launches)


# -- phase 25: the production-mesh dry run --------------------------------------

# 25(a): each wrapper at its main-path shape (PERF.md §6's table), a real
# launch against the same call on fake copies of its inputs
DRY_SHAPES = {
    "decode_attention": (8, 1, 9, 3, 1024, 64),          # B, T, H, KV, W, hd
    "paged_decode_attention": (8, 1, 9, 3, 512, 16, 64, 64),  # .., N, bs, M, hd
    "flash_attention": (1, 512, 512, 9, 3, 64),          # B, Sq, Sk, H, KV, hd
    "flash_attention_lse": (8, 512, 512, 9, 3, 64),      # training's forward
    "flash_attention_bwd": (8, 512, 512, 9, 3, 64),
    "rglru_scan": (1, 4096, 4096),                       # B, S, W
    "rglru_scan_bwd": (1, 4096, 4096),
    "cascade_gate": (1, 49152, "bfloat16"),              # T, V
}
# 25(b): this arch x shape on the 16 x 16 mesh, traced on fake CUDA and
# on fake CPU tensors; DRY_LAYERS cuts it to that many layers (None: whole)
DRY_ARCH, DRY_SHAPE, DRY_LAYERS = "glm4-9b", "train_4k", None
# 25(c): phase 24(b)'s step, glm4-9b whole on a (1, 4) mesh at B 4 x S
# 4,096: its all-reduces over 'model' a step, and what 24(b) counted and
# measured on four NVIDIA H100 80GB HBM3 at 700.00 W: weights + gradients
# + moments a rank, GiB, and the peak a rank
DRY_TP = {"batch": (4, 4096), "all_reduce/model": 206,
          "counted_gib": (4.50, 4.50, 17.98), "peak_gib": 51.51}


def _dry_inputs(torch, name, shape, dev):
    """(call, inputs) of the wrapper ``name`` at ``shape`` on ``dev``:
    positions in range, tables over the pool, f32 where a kernel takes
    only f32."""
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.rglru_scan as rs
    from repro_torch.kernels.cascade_gate import cascade_gate
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)

    gen = torch.Generator(device=dev).manual_seed(25)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def randn(*s, dtype=bf):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    if name == "decode_attention":
        b, t, h, kv, w, hd = shape
        pos = torch.arange(w, dtype=i32).repeat(b, 1).to(dev)
        return decode_attention, (randn(b, t, h, hd), randn(b, w, kv, hd),
                                  randn(b, w, kv, hd),
                                  torch.full((b,), w - t, dtype=i32,
                                             device=dev), pos)
    if name == "paged_decode_attention":
        b, t, h, kv, n, bs, m, hd = shape
        pos = torch.arange(n * bs, dtype=i32).reshape(n, bs).to(dev)
        tables = (torch.arange(b * m, dtype=i32).reshape(b, m) % n).to(dev)
        return paged_decode_attention, (
            randn(b, t, h, hd), randn(n, bs, kv, hd), randn(n, bs, kv, hd),
            torch.full((b,), m * bs - t, dtype=i32, device=dev), pos, tables)
    if name.startswith("flash"):
        b, sq, sk, h, kv, hd = shape
        qkv = (randn(b, sq, h, hd), randn(b, sk, kv, hd),
               randn(b, sk, kv, hd))
        if name == "flash_attention":
            return fa.flash_attention, qkv
        if name == "flash_attention_lse":
            return (lambda q, k, v: fa._forward(
                q, k, v, True, None, hd ** -0.5, with_lse=True)), qkv
        out, lse = fa._forward(*qkv, True, None, hd ** -0.5, with_lse=True)
        return fa.flash_attention_bwd, qkv + (out, lse, randn(b, sq, h, hd))
    if name.startswith("rglru"):
        b, s, w = shape
        a = torch.rand(b, s, w, generator=gen, device=dev).mul(0.5).add(0.4)
        x, h0 = randn(b, s, w, dtype=f32), randn(b, w, dtype=f32)
        if name == "rglru_scan":
            return rs.rglru_scan, (a, x, h0)
        h, _ = rs._forward(a, x, h0)
        return rs.rglru_scan_bwd, (a, h, h0, randn(b, s, w, dtype=f32),
                                   randn(b, w, dtype=f32))
    t, v, dtype = shape
    return (lambda x: cascade_gate(x, 0.5, 0.1)), (
        randn(t, v, dtype=getattr(torch, dtype)),)


def _dry_rules(torch, dev):
    """25(a): each wrapper's fake rule against a real launch at
    ``DRY_SHAPES``: equal shapes, dtypes, strides and devices, the same
    FLOPs added, a ``TRACED`` count and no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels

    for name, shape in DRY_SHAPES.items():
        kernel = "flash_attention" if name == "flash_attention_lse" else name
        fn, args = _dry_inputs(torch, name, shape, dev)
        flops, launched = dict(kernels.FLOPS), kernels.LAUNCHES[kernel]
        real = fn(*args)
        torch.cuda.synchronize(dev)
        real = real if isinstance(real, tuple) else (real,)
        real_flops = kernels.FLOPS.get(kernel, 0) - flops.get(kernel, 0)
        assert kernels.LAUNCHES[kernel] == launched + 1, name
        with FakeTensorMode() as mode:
            fakes = [mode.from_tensor(t) for t in args]
            launches, traced = dict(kernels.LAUNCHES), kernels.TRACED[kernel]
            flops = dict(kernels.FLOPS)
            got = fn(*fakes)
        got = got if isinstance(got, tuple) else (got,)
        fake_flops = kernels.FLOPS.get(kernel, 0) - flops.get(kernel, 0)
        meta = [[(tuple(t.shape), t.dtype, t.stride(), t.device)
                 for t in ts] for ts in (got, real)]
        assert meta[0] == meta[1], (name, meta)
        assert kernels.LAUNCHES == launches, name
        assert kernels.TRACED[kernel] == traced + 1, name
        assert fake_flops == real_flops, (name, fake_flops, real_flops)
        print(f"  25(a) {name} {shape}: fake rule == launch "
              f"({', '.join(str(tuple(t.shape)) for t in real)}), "
              f"FLOPs {fake_flops}, no launch")
        del real, args, fakes, got
    torch.cuda.empty_cache()


def _dry_trace(torch, cfg, shape, mesh_shape, device):
    """(record, op log) of one rank of a ``mesh_shape`` (data, model) fake
    group tracing ``cfg``'s ``shape`` step on fake ``device`` tensors."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.fake import fake_mode, fake_world
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.specs import make_step_fn
    from repro_torch.models.model import LM

    data, model = mesh_shape
    with fake_world(data * model):
        mesh = HostMesh(model, device=device)
        with fake_mode(device):
            lm = LM(cfg, device=device)
            step, inputs = make_step_fn(lm, shape, mesh, device)
            return trace_step(
                step, inputs, params=inputs[0],
                read=inputs[:2] if shape.mode == "decode" else inputs[0],
                device=device, arch=DRY_ARCH, shape=shape.name,
                mesh=f"{data}x{model}", devices=data * model,
                mode=shape.mode, seq_len=shape.seq_len,
                global_batch=shape.global_batch)


def check_dryrun(torch, dev, seed, smi):
    """Phase 25: (a) ``_dry_rules``; (b) ``DRY_ARCH`` x ``DRY_SHAPE`` on
    the 16 x 16 mesh traced on fake CUDA (the kernels' fake rules, forward
    and backward) and on fake CPU tensors (their plain versions): the same
    matrix-product FLOPs and collectives, its roofline row; (c) phase
    24(b)'s (1, 4) glm4-9b step on fake CUDA: its all-reduces over
    'model' equal 24(b)'s count, its argument and temp bytes beside what
    24(b) counted and measured. Returns its record."""
    from repro_torch.analysis.roofline import (format_table,
                                               roofline_from_record)
    from repro_torch.configs.shapes import InputShape, get_shape
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    from repro_torch.launch.specs import resolved_config

    t0 = time.perf_counter()
    _dry_rules(torch, dev)
    rec = {"rules_s": time.perf_counter() - t0}
    print(f"  25(a) {rec['rules_s']:.1f} s")
    cfg = resolved_config(DRY_ARCH, DRY_SHAPE)
    if DRY_LAYERS is not None:
        cfg = _cut_stages(cfg, (DRY_LAYERS,))
    shape = get_shape(DRY_SHAPE)
    got = {}
    for device in ("cuda", "cpu"):
        got[device], _ = _dry_trace(torch, cfg, shape,
                                    PRODUCTION_MESHES["pod16x16"], device)
    a, b = got["cuda"], got["cpu"]
    assert a["weighted"]["dot_flops"] == b["weighted"]["dot_flops"] > 0, \
        (a["weighted"]["dot_flops"], b["weighted"]["dot_flops"])
    assert a["collectives"] == b["collectives"], (a["collectives"],
                                                  b["collectives"])
    assert a["kernels"].get("flash_attention_bwd", 0) > 0, a["kernels"]
    layers = "whole" if DRY_LAYERS is None else f"{DRY_LAYERS} layers"
    gib = [a["memory"][k] / 2 ** 30 for k in ("argument_bytes_per_device",
                                               "temp_bytes_per_device")]
    coll = {k: v for k, v in a["collectives"].items() if v["count"]}
    print(f"  25(b) {DRY_ARCH} ({layers}) x {DRY_SHAPE} x pod16x16, rank 0"
          f": trace {a['trace_s']:.2f} s on fake cuda ({a['ops']} ops, "
          f"kernels {a['kernels']}), {b['trace_s']:.2f} s on fake cpu; "
          f"dot_flops {a['weighted']['dot_flops']:.6e} and collectives "
          f"{coll} equal; args {gib[0]:.2f} + temp {gib[1]:.2f} GiB a rank "
          f"(fake cuda), fits {a['fits']} [counted, not timed; {smi}]")
    print("\n".join("    " + line for line in format_table(
        [roofline_from_record(a)]).splitlines()))
    rec["pod16x16"] = {"cuda": a, "cpu": b}
    batch, seq = DRY_TP["batch"]
    tp, log = _dry_trace(torch, resolved_config(DRY_ARCH, "train_4k"),
                         InputShape(f"b{batch}s{seq}", seq, batch, "train"),
                         (1, 4), "cuda")
    counts = {e["op"].split("/", 1)[1]: e["n"] for e in log
              if e["op"].startswith("collective/")}
    assert counts.get("all_reduce/model") == DRY_TP["all_reduce/model"], \
        counts
    w, g, m = DRY_TP["counted_gib"]
    args, temp = (tp["memory"][k] / 2 ** 30 for k in (
        "argument_bytes_per_device", "temp_bytes_per_device"))
    print(f"  25(c) {DRY_ARCH} whole on a fake (1, 4) mesh, B {batch} x S "
          f"{seq}: {counts['all_reduce/model']} all-reduces over 'model' a "
          f"step (24(b) counted {DRY_TP['all_reduce/model']}); argument "
          f"bytes {args:.2f} GiB a rank (24(b): weights {w} + moments {m} = "
          f"{w + m:.2f}, gradients {g} made in the step), temp peak "
          f"{temp:.2f} GiB (+ args {args + temp:.2f}; 24(b) measured a "
          f"{DRY_TP['peak_gib']} GiB peak on the cards); trace "
          f"{tp['trace_s']:.2f} s")
    rec["tp_1x4"] = tp
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full record here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the phase-4, 5, 7, 9 and qwen3-4b's "
                         "phase-10 ring traces on the device")
    ap.add_argument("--only", choices=["19", "19a", "20", "20a", "20c", "21",
                                       "21a", "21c", "22", "22b", "22c",
                                       "23", "24", "24b", "25"],
                    help="run phase 1 and this phase alone, or its NCCL "
                         "meshes alone (19a, 20a, 21a), or 20(c), 21(c), "
                         "22(b), 22(c) and (d) (on one card with 24(a) in "
                         "their ranks), or 24(b) alone (no result lines: "
                         "the contract's run is the whole script)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def phase(text):             # a phase header, with the seconds so far
        print(f"{text} [{time.perf_counter() - t_start:.1f} s]")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    try:
        from repro_torch.kernels import build
    except ModuleNotFoundError:
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    phase(f"[1] card: {kind} (nvidia-smi: {smi}); torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.sources():
        build.load(name)
    print(f"    built {build.sources()} in {time.perf_counter() - t0:.1f} s")
    spills = []
    for name, log in reports.items():
        for u in build.ptxas_usage(log):
            print(f"    {name}: {u['name']}: {u['registers']} registers, "
                  f"spill {u['spill_stores']} B stored / {u['spill_loads']} "
                  f"B loaded")
            if "mma" in u["name"] and u["spill_stores"] + u["spill_loads"]:
                spills.append(u["name"])
    if spills:       # the tensor-core bodies keep O in registers
        raise AssertionError(f"bf16 tensor-core kernels spill: {spills}")

    if args.only:
        if args.only == "25":
            phase("[25] the production-mesh dry run alone")
            check_dryrun(torch, dev, args.seed, smi)
        elif args.only == "23":
            phase("[23] supervised restart on the mesh alone")
            check_supervise(torch, dev, args.seed, smi)
        elif args.only.startswith("24"):
            phase(f"[{args.only}] training on a model axis above 1 alone")
            check_tp_training(torch, dev, args.seed, smi,
                              legs="ab" if args.only == "24" else "b")
        elif args.only.startswith("19"):
            phase(f"[{args.only}] tensor-parallel serving alone")
            check_tensor_parallel(torch, dev, args.seed, smi,
                                  splits=args.only == "19")
        elif args.only.startswith("22"):
            phase(f"[{args.only}] the data axis alone")
            got, _ = check_data_axis(torch, dev, args.seed, smi,
                                     legs={"22": "abc", "22b": "b",
                                           "22c": "c"}[args.only])
            recs = got.get("train", {}).get("tp_train", [None])
            if recs[0] is not None:      # 24(a), run in 22(c)'s spawn
                check_tp_training(torch, dev, args.seed, smi, recs, "a")
        elif args.only.startswith("21"):
            phase(f"[{args.only}] the recurrent mixers and the frontends on "
                  f"the mesh alone")
            check_rec_mesh(torch, dev, args.seed, smi,
                           legs={"21": "abc", "21a": "ac",
                                 "21c": "c"}[args.only])
        else:
            phase(f"[{args.only}] MoE and MLA on the mesh alone")
            check_moe_mesh(torch, dev, args.seed, smi,
                           legs={"20": "abc", "20a": "ac",
                                 "20c": "c"}[args.only])
        phase(f"phase {args.only[:2]} passed")
        return 0

    phase("[2] kernels vs plain versions (bf16; the gate also f32; the "
          "RG-LRU scan f32)")
    timer = Timer(torch)
    results, rates = {}, {}
    results["decode_attention"], rates["decode_attention"] = check_decode(
        torch, timer, dev)
    results["flash_attention"], rates["flash_attention"] = check_flash(
        torch, timer, dev)
    results["paged_decode_attention"] = check_paged(torch, timer, dev)
    for name, err in check_kv_range(torch, dev).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    results["cascade_gate"], gate_times = check_cascade_gate(torch, timer,
                                                             dev)
    results["rglru_scan"], rglru_times = check_rglru(torch, timer, dev)
    in_graphs = check_kernels_in_graphs(torch, dev)
    hd256_times = check_attention_hd256(torch, timer, dev)
    hd128_times = check_attention_hd128(torch, timer, dev)
    verify_times = check_verify_shapes(torch, timer, dev)
    modal_times = check_modal_shapes(torch, timer, dev)
    tp_train_times = check_tp_train_shapes(torch, timer, dev)
    sampler_times = check_sampler(torch, timer, dev)
    rates["sweep"] = sweep_attention(torch, timer, dev)
    phase("[3] model: smollm-135m, 30 layers, full width")
    check_model(torch, dev, args.seed)
    smollm = _smollm(dev, args.seed)
    reqs = _trace(args.seed, smollm[0].cfg.vocab_size)
    phase("[4] engine: ring, 8 slots, max_seq_len 1024, K=4")
    stats, launches = check_engine(torch, dev, args.seed, smi, *smollm, reqs,
                                   ab=True)
    phase("[5] engine: paged, block 16, chunks of 128, prefix sharing, K=4")
    paged_stats, paged_launches = check_paged_engine(torch, dev, args.seed,
                                                     smi, *smollm)
    launches["paged_decode_attention"] = \
        paged_launches["paged_decode_attention"]
    models = _cascade_models(torch, dev, args.seed)
    phase("[6] cascade, one-shot: smollm-135m cloud, 4-layer edge draft, "
          "64 queries x 128 tokens")
    oneshot_gates, oneshot_stats = check_cascade_oneshot(torch, dev,
                                                         args.seed, models)
    phase("[7] cascade, generative: ring, 8 slots, max_seq_len 1024, K=4, "
          "24 requests")
    serving_gates, cascade_stats = check_cascade_serving(
        torch, dev, args.seed, smi, models)
    launches["cascade_gate"] = oneshot_gates + serving_gates
    phase("[8] hybrid model: recurrentgemma-9b at full width (4 layers f32, "
          "then 38 layers bf16)")
    hybrid_stats = check_hybrid_model(torch, dev, args.seed)
    torch.cuda.empty_cache()
    hlm, hparams, full_stats = hybrid_full_depth(torch, dev, args.seed)
    hybrid_stats.update(full_stats)
    phase("[9] hybrid engine: recurrentgemma-9b, ring, 8 slots, max_seq_len "
          "4096, K=4, 12 requests")
    hybrid_engine, hybrid_launches, hybrid_reqs = check_hybrid_engine(
        torch, dev, args.seed, smi, hlm, hparams)
    launches["rglru_scan"] = hybrid_launches["rglru_scan"]
    del hlm, hparams
    gc.collect()            # engines with counted methods form cycles
    torch.cuda.empty_cache()
    phase("[10] dense zoo at hd 128: qwen3-4b (ring and paged engines, "
          "full depth), glm4-9b (10 layers) and starcoder2-7b (8 layers) "
          "(ring), full width, bf16")
    zoo_stats = check_zoo(torch, dev, args.seed, smi)
    phase("[11] baseline: DrainBatchEngine and ServingEngine (ring, K=4) in "
          "turns on phase 4's trace")
    baseline_stats = check_baseline(torch, dev, args.seed, smi, *smollm)
    phase(f"[13] speculative decoding, k = {SPEC_K}: qwen3-4b (ring; paged "
          f"at {SPEC_PAGED_LAYERS} layers) with its 4-layer edge draft, "
          f"smollm-135m drafting for itself, the cascade's edge drafting for "
          f"its cloud")
    spec_stats = check_speculative(torch, dev, args.seed, smi, smollm,
                                   models)
    phase("[14] faults, durability and the gateway: smollm-135m (chaos on "
          "the paged and the self-draft ring engine; snapshot/restore, ring "
          "and paged; the gateway: open loop, hang, wedge + restart) and "
          "phase 7's cascade")
    durability, durability_launches = check_durability(
        torch, dev, args.seed, smi, smollm, reqs, stats, paged_stats, models,
        cascade_stats)
    for name, n in durability_launches.items():
        launches[name] += n
    phase("[15] the ACE application: PartitionedLM (smollm-135m), the "
          "video-query classifiers and model-backed crop bank, the Fig. 5 "
          "sweep, engine-calibrated servers")
    ace_stats, ace_launches = check_ace_app(torch, dev, args.seed, smi,
                                            timer, smollm, models)
    for name, n in ace_launches.items():
        launches[name] += n
    del models
    gc.collect()
    torch.cuda.empty_cache()
    phase("[16] MoE and MLA at full width: mixtral-8x22b (6 of 56 layers) "
          "and deepseek-v3-671b (4 of 61), f32 cuts vs the CPU, then bf16 "
          "on graphed ring and paged engines, dropless and at 1.25")
    moe_stats, moe_launches = check_moe(torch, dev, args.seed, smi)
    for name, n in moe_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[17] xLSTM and the modality frontends at full width and depth: "
          "xlstm-125m (4 layers f32 vs the CPU, 12 bf16, graphed ring and "
          "drain engines), internvl2-2b (24 layers with its 256-token image "
          "prefix, CascadeEngine.query with the image) and musicgen-medium "
          "(48 layers on a 4-codebook grid)")
    modal_stats, modal_launches = check_modalities(torch, timer, dev,
                                                   args.seed, smi)
    for name, n in modal_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[18] training on one device: the backward kernels vs their plain "
          "versions; smollm-135m (30 layers, bf16) through Trainer.fit and a "
          "resumed Trainer; recurrentgemma-9b (one repeat, f32) and each "
          "family's reduced config (f32), card vs CPU")
    train_results, train_stats, train_launches = check_training(
        torch, timer, dev, args.seed, smi)
    results.update(train_results)
    for name, n in train_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[19] tensor-parallel serving: qwen3-4b on a one-rank NCCL mesh "
          "(ring and paged, graphed) against mesh=None; real splits on this "
          "card over gloo: qwen3-4b (4 layers) on 2 ranks, glm4-9b (1 "
          "layer) on 4")
    tp_stats, tp_launches = check_tensor_parallel(torch, dev, args.seed, smi)
    for name, n in tp_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[20] MoE and MLA on the mesh: mixtral-8x22b (6 layers) and "
          "deepseek-v3-671b (3 + 1) on a one-rank NCCL mesh (ring and "
          "paged, graphed, dropless) against mesh=None; real splits on this "
          "card over gloo: mixtral (1 layer) and deepseek (1 + 1) on 4 "
          "ranks")
    moe_mesh_stats, moe_mesh_launches = check_moe_mesh(torch, dev,
                                                       args.seed, smi)
    for name, n in moe_mesh_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[21] the recurrent mixers and the frontends on the mesh: "
          "recurrentgemma-9b (38 layers) and xlstm-125m on a one-rank NCCL "
          "mesh (ring, graphed), internvl2-2b and musicgen-medium through "
          "LM, against mesh=None; real splits on this card over gloo: "
          "recurrentgemma (4 layers) on 4 ranks, xlstm (4 layers) on 2 and "
          "4, the "
          "frontends (4 layers) on 4")
    rec_mesh_stats, rec_mesh_launches = check_rec_mesh(torch, dev,
                                                       args.seed, smi)
    for name, n in rec_mesh_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[22] the data axis: qwen3-4b (4 layers, ring and paged) and "
          "mixtral-8x22b (1 layer, ring) on a (2, 2) mesh of gloo ranks on "
          "this card against mesh=None; with 4 cards qwen3-4b whole on a "
          "(2, 2) NCCL mesh, graphed; smollm-135m data-parallel training "
          "(f32 against one device, bf16 timed) and FedAvg on min(cards, "
          "4) NCCL ranks or 2 gloo ranks")
    dm_stats, dm_launches = check_data_axis(torch, dev, args.seed, smi,
                                            tp_stats=tp_stats)
    for name, n in dm_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase("[23] supervised restart on the mesh: smollm-135m whole on 2 gloo "
          "ranks of this card (ring, eager) wedged at step 2, every rank's "
          "engine written off and rebuilt, recovered from rank 0's snapshot "
          "and journal; with 2 cards or more, serve --arch qwen3-4b "
          "--no-reduced --mesh min(cards, 4) --wedge-demo over NCCL")
    sup_stats, sup_launches = check_supervise(torch, dev, args.seed, smi)
    for name, n in sup_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[24] training on a model axis above 1: qwen3-4b (4 layers) and "
          f"recurrentgemma-9b ((rec, rec, attn)) on a (1, 2) mesh of gloo "
          f"ranks on this card (run in phase 22's spawn), f32, against one "
          f"device; with 4 cards {TPT_CARDS} whole on a (1, 4) NCCL mesh "
          f"through launch/train.py (bf16, timed) and its 4-layer f32 cut")
    gloo_recs = dm_stats["train"]["tp_train"]
    tpt_stats, tpt_launches = check_tp_training(
        torch, dev, args.seed, smi,
        None if gloo_recs[0] is None else gloo_recs)
    for name, n in tpt_launches.items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[25] the production-mesh dry run: each kernel's fake rule "
          f"against a real launch at its main-path shape; {DRY_ARCH} x "
          f"{DRY_SHAPE} on one rank of the 16 x 16 mesh under fake CUDA and "
          f"fake CPU tensors; phase 24(b)'s (1, 4) step under fake CUDA "
          f"tensors")
    dry_stats = check_dryrun(torch, dev, args.seed, smi)
    if args.profile:
        from repro_torch.configs import get_config
        from repro_torch.models.model import LM

        phase("[12] profiles of the phase-9, 4, 5, 7 and 10 (qwen3-4b ring) "
              "traces, and phase 4's through the gateway (14(c))")
        for cfg, rec, trace, width in (
                (_hybrid_cfg("bfloat16"), hybrid_engine, hybrid_reqs, 4096),
                (get_config("qwen3-4b"), zoo_stats["qwen3-4b"]["ring"],
                 _trace(args.seed, get_config("qwen3-4b").vocab_size),
                 1024)):
            big = LM(cfg, device=dev)
            big_params = big.init(args.seed, on_device=True)
            rec["profile"] = profile_engine(torch, args.seed, big, big_params,
                                            trace, rec["wall_s"], width)
            del big, big_params
            torch.cuda.empty_cache()
        stats["profile"] = profile_engine(torch, args.seed, *smollm, reqs,
                                          stats["wall_s"])
        paged_stats["profile"] = profile_paged_engine(
            torch, args.seed, *smollm, paged_stats["wall_s"])
        cascade_stats["profile"] = profile_cascade(torch, dev, args.seed,
                                                   cascade_stats)
        gw = durability["gateway"]["open_loop"]
        gw["profile"] = profile_gateway(torch, args.seed, *smollm, reqs,
                                        gw["wall_s"])
        print(f"  idle share, phase 4's trace: direct run() "
              f"{stats['profile']['idle_share']:.3f}, through the gateway "
              f"(open loop) {gw['profile']['idle_share']:.3f} [{smi}]")

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
        "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru_scan.py:77"),
        # no Pallas backward exists: the JAX gradients they compute
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/models/attention.py:226"),
        "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                           "src/repro/models/recurrent.py:80"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name],
                    **results[name]) for name in sorted(results)]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "torch": torch.__version__,
                       "kernels": kernels, "cascade_gate_times": gate_times,
                       "rglru_scan_times": rglru_times,
                       "kernels_in_graphs": in_graphs,
                       "attention_rates": rates,
                       "attention_hd256": hd256_times,
                       "attention_hd128": hd128_times,
                       "attention_verify": verify_times,
                       "modal_shapes": modal_times,
                       "tp_train_shapes": tp_train_times,
                       "modalities": modal_stats,
                       "sampler": sampler_times,
                       "speculative": spec_stats,
                       "durability": durability, "ace_app": ace_stats,
                       "moe": moe_stats, "training": train_stats,
                       "tensor_parallel": tp_stats,
                       "moe_mesh": moe_mesh_stats,
                       "rec_mesh": rec_mesh_stats,
                       "data_axis": dm_stats,
                       "supervise": sup_stats,
                       "tp_training": tpt_stats,
                       "dryrun": dry_stats,
                       "zoo": zoo_stats, "baseline": baseline_stats,
                       "hybrid_model": hybrid_stats,
                       "hybrid_engine": hybrid_engine,
                       "engine": stats, "paged_engine": paged_stats,
                       "cascade_oneshot": oneshot_stats,
                       "cascade_engine": {k: v for k, v in
                                          cascade_stats.items()
                                          if k != "trace"}}, f, indent=1)
    phase("all phases passed")
    from repro_torch.kernels import TRACED
    print(json.dumps({"traced": TRACED}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
