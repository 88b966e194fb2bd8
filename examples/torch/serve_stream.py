"""Async gateway serving on the PyTorch port: open-loop arrivals streamed
token by token.

Four short demos on one tiny engine:

1. streaming — tokens print as each engine step's host sync lands;
2. client disconnect — abandoning a stream cancels the request and
   frees its slot and paged blocks;
3. backpressure — a saturating burst against a 2-deep inbox under the
   `shed` policy: high-class arrivals displace queued low-class work;
4. graceful drain — accepted work finishes, late submits are refused.

The port of ``examples/serve_stream.py``, on the card (the paged decode and
flash kernels, the engine's programs as CUDA graphs) or with ``--device
cpu`` on the plain versions.

    PYTHONPATH=src python examples/torch/serve_stream.py [--device cpu]
"""
import argparse
import asyncio
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serving import ServingEngine, ServingGateway


def _engine(cfg, device, params_seed=0, **kw):
    lm = LM(cfg, device=device)
    base = dict(batch_slots=2, max_seq_len=64, min_bucket=8,
                cache_backend="paged", block_size=8)
    base.update(kw)
    return ServingEngine(lm, lm.init(params_seed), **base)


async def _streaming_demo(eng, rng, rate_hz):
    print("== streaming: open-loop arrivals, tokens as they land ==")
    async with ServingGateway(eng, policy="block") as gw:
        async def client(i):
            h = await gw.submit(rng.integers(0, 100, size=4 + 2 * i),
                                max_new_tokens=6)
            toks = [t async for t in h.stream()]
            r = await h.result()
            print(f"  req {r.request_id}: {toks} "
                  f"ttft={r.ttft_s * 1e3:.0f}ms "
                  f"latency={r.latency_s * 1e3:.0f}ms")

        clients = []
        for i in range(4):
            clients.append(asyncio.create_task(client(i)))
            # open loop: the next arrival does not wait on service
            await asyncio.sleep(float(rng.exponential(1.0 / rate_hz)))
        await asyncio.gather(*clients)


async def _disconnect_demo(eng, rng):
    print("== disconnect: an abandoned stream cancels its request ==")
    async with ServingGateway(eng) as gw:
        h = await gw.submit(rng.integers(0, 100, size=8),
                            max_new_tokens=24)
        got = []
        async for t in h.stream():
            got.append(t)
            if len(got) == 3:
                break                       # client walks away
        r = await h.result()
        print(f"  req {r.request_id}: status={r.status} after {got}; "
              f"reason={r.failure_reason!r}")
    assert sorted(eng._free) == list(range(eng.batch_slots))
    print("  slot free list full; paged pool clean after drain")


async def _backpressure_demo(eng, rng):
    print("== backpressure: shed policy under a saturating burst ==")
    async with ServingGateway(eng, max_queue=2, forward_depth=1,
                              policy="shed") as gw:
        lo = [await gw.submit(rng.integers(0, 100, size=6),
                              max_new_tokens=4) for _ in range(4)]
        hi = [await gw.submit(rng.integers(0, 100, size=6),
                              max_new_tokens=4, priority=2)
              for _ in range(2)]
        for name, hs in (("lo", lo), ("hi", hi)):
            for h in hs:
                r = await h.result()
                why = f" ({r.failure_reason})" if r.status != "done" else ""
                print(f"  {name} req {r.request_id}: {r.status}{why}")
        print(f"  gateway stats: {gw.stats()}")


async def _drain_demo(eng, rng):
    print("== drain: graceful shutdown ==")
    gw = ServingGateway(eng)
    h = await gw.submit(rng.integers(0, 100, size=6), max_new_tokens=5)
    await gw.drain()
    r = await h.result()
    print(f"  accepted req {r.request_id} finished: {r.output.tolist()}")
    late = await gw.submit(rng.integers(0, 100, size=6), max_new_tokens=5)
    r2 = await late.result()
    print(f"  post-drain submit: {r2.status} ({r2.failure_reason})")


async def main_async(args):
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)
    eng = _engine(cfg, args.device)
    await _streaming_demo(eng, rng, args.rate)
    await _disconnect_demo(eng, rng)
    await _backpressure_demo(eng, rng)
    await _drain_demo(eng, rng)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--rate", type=float, default=30.0,
                    help="offered load for the streaming demo, req/s")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    asyncio.run(main_async(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
