"""Cascade LM serving on the PyTorch port (the paper's inter-model ECC
inference on an LM workload): an edge draft model answers one-shot
queries; the confidence gate (the ``cascade_gate`` kernel on the card)
escalates uncertain ones to the cloud model; the compacted variant bounds
cloud compute + boundary bytes.

The port of ``examples/serve_cascade.py``, on the card or with ``--device
cpu`` on the plain versions.

    PYTHONPATH=src python examples/torch/serve_cascade.py \
        [--cache-backend paged] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np

from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant
from repro_torch.cascade.gate import make_thresholds
from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serving import (CascadeEngine, CascadeServingEngine,
                                 ServingEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-backend", choices=("ring", "paged"),
                    default="ring",
                    help="KV-cache backend for the serving engines: 'paged' "
                         "reserves pool blocks per request instead of a "
                         "max_seq_len ring per slot")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    cloud_cfg = get_config("smollm-135m").reduced()
    edge_cfg = edge_variant(cloud_cfg, layers=1)
    cloud = LM(cloud_cfg, device=args.device)
    edge = LM(edge_cfg, device=args.device)
    cp, ep = cloud.init(0), edge.init(1)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cloud_cfg.vocab_size, size=(16, 24))

    # paper-style thresholds; untrained draft -> almost everything escalates,
    # so loosen the gate for the demo to show all three routes
    th = make_thresholds(hi=0.03, lo=0.005)
    for mode, compact in (("lockstep (paper-faithful)", False),
                          ("compacted (beyond-paper)", True)):
        cascade = CascadeLM(edge, cloud, thresholds=th, capacity_frac=0.5)
        eng = CascadeEngine(cascade, ep, cp, compact=compact)
        eng.query(tokens)
        m = eng.metrics
        print(f"{mode:28s} accept={m.accepted:2d} drop={m.dropped:2d} "
              f"escalate={m.escalated:2d} wan_bytes={m.wan_bytes:6d} "
              f"edge/cloud agreement={m.agreement:.2f}")

    # continuous-batching autoregressive serving: 8 mixed-length requests
    # share 4 slots; new requests slide in as short ones finish, and
    # multi-step decode runs up to 8 fused decode steps per host sync
    eng = ServingEngine(cloud, cp, batch_slots=4, max_seq_len=64,
                        min_bucket=8, cache_backend=args.cache_backend,
                        max_decode_steps=8)
    for i in range(8):
        eng.submit(rng.integers(0, 100, size=5 + 3 * i),
                   max_new_tokens=4 + 2 * i)
    done = eng.run()
    print(f"\ncontinuous-batching engine [{args.cache_backend}] served "
          f"{len(done)} requests in {eng.decode_steps} decode steps "
          f"across {eng.host_syncs} host syncs "
          f"(dispatch utilization {eng.occupancy():.0%}, "
          f"KV HBM {eng.hbm_bytes() / 1024:.0f} KiB), e.g. "
          f"req0 -> {done[0].output.tolist()}")

    # SLO-aware serving: a bulk backlog saturates a deliberately starved
    # paged pool; a priority-2 query submitted behind it preempts a bulk
    # request's blocks (swapped to the host, resumed token-exactly later)
    # and is answered orders of magnitude sooner than its queue position
    slo = ServingEngine(cloud, cp, batch_slots=2, max_seq_len=64,
                        min_bucket=8, cache_backend="paged", block_size=8,
                        num_pool_blocks=13, chunk_tokens=32,
                        max_decode_steps=8)
    slo.warm_compile()                 # measure scheduling, not capture
    for i in range(6):
        slo.submit(rng.integers(0, 100, size=16), max_new_tokens=32)
    for _ in range(3):
        slo.step()                     # bulk now holds every pool block
    slo.submit(rng.integers(0, 100, size=6), max_new_tokens=4, priority=2)
    done = slo.run()
    hi = done[6]
    print(f"SLO engine: priority-2 request ttft={hi.ttft_s * 1e3:.1f} ms "
          f"behind a 6-request bulk backlog "
          f"({slo.preemptions} preemption(s), "
          f"{slo.backend.swap_outs} swap-out(s); bulk requests preempted: "
          f"{[r.preemptions for rid, r in sorted(done.items())][:6]})")

    # generative cascade: the edge gate routes each prompt, generation runs
    # on the routed continuous-batching engine
    gen = CascadeServingEngine(CascadeLM(edge, cloud, thresholds=th),
                               ep, cp, batch_slots=4, max_seq_len=64,
                               cache_backend=args.cache_backend)
    for i in range(8):
        gen.submit(rng.integers(0, 100, size=6 + i), max_new_tokens=6)
    gen.run()
    m = gen.metrics
    print(f"generative cascade: accept={m.accepted} drop={m.dropped} "
          f"escalate={m.escalated} wan_bytes={m.wan_bytes}")


if __name__ == "__main__":
    main()
