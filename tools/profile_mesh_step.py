#!/usr/bin/env python3
"""Where a graphed program's device time goes on a one-rank NCCL mesh,
beside ``mesh=None``, on one card.

    python3 tools/profile_mesh_step.py [--arch xlstm-125m,recurrentgemma-9b]
                                       [--replays 20]

For each ``--arch`` (full width and depth, bf16, weights from seed 0) it
serves phase 19's trace through ``chip_smoke.py``'s ring engine (8 slots,
max_seq_len 512, K = 4, every program a CUDA graph), with ``mesh=None``
and on a one-rank NCCL mesh in turns (A, B, A, B), then replays two of the
engine's programs ``--replays`` times each: the greedy 4-step decode and
the longest admission bucket. Per program: the median device time of a
replay (CUDA events) and, under torch.profiler (over ``--replays`` decode
replays and 2 admission replays: an xLSTM admission is ~60,000 kernels),
its device events' time, the NCCL kernels and the device-to-device
copies apart (a one-rank NCCL collective may be a copy, or nothing).
Prints one line ``PROFILE {json}``. Needs a CUDA GPU; run it from the
root of a checkout.
"""
import argparse
import gc
import json
import os
import statistics
import sys


def _replay_ms(torch, prog, key, n):
    """Median device ms of one replay of ``prog`` (CUDA events)."""
    times = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        prog.replay(key)
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _kernel_ms(torch, cs, prog, key, n):
    """{device events' ms, NCCL kernels' ms and calls, copies' ms and
    calls} of one replay, from torch.profiler over ``n`` replays."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            prog.replay(key)
        torch.cuda.synchronize()
    rows = cs._device_rows(prof)
    out = {"device_ms": sum(r[0] for r in rows) / 1e3 / n}
    for label, word in (("nccl", "nccl"), ("copy", "memcpy")):
        mine = [(us, calls) for us, calls, name in rows
                if word in name.lower()]
        out[f"{label}_ms"] = sum(us for us, _ in mine) / 1e3 / n
        out[f"{label}_calls"] = sum(calls for _, calls in mine) / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m,recurrentgemma-9b")
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("profile_mesh_step: no CUDA device visible", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch.mesh import free_port, make_host_mesh
    from repro_torch.models.model import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"card": cs._smi(), "replays": args.replays, "legs": []}
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_host_mesh(1, device=dev)
        for arch in args.arch.split(","):
            lm = LM(cs._rec_cfg(arch), device=dev)
            params = lm.init(0, on_device=True)
            reqs = cs._tp_trace(0, lm.cfg.vocab_size)
            for label, m in (("mesh=None", None), ("mesh of 1", mesh)) * 2:
                eng = cs._tp_engine(lm, params, 0, "ring", m)
                cs._tp_serve(torch, eng, reqs, True)
                admit = max(k for k in eng._programs if k[0] == "admit")
                rec = {"arch": arch, "leg": label}
                for name, key, n in (("decode", ("decode", 4, False),
                                      args.replays), ("admit", admit, 2)):
                    prog = eng._programs[key]
                    ms = _replay_ms(torch, prog, key, args.replays)
                    prof = _kernel_ms(torch, cs, prog, key, n)
                    rec[name] = dict(key=list(key), ms=ms,
                                     collectives=prog.collectives, **prof)
                    print(f"  {arch} {label} {key} [{out['card']}]: "
                          f"{ms:.3f} ms a replay; device events "
                          f"{prof['device_ms']:.3f} ms, NCCL kernels "
                          f"{prof['nccl_ms']:.3f} ms in "
                          f"{prof['nccl_calls']:.0f}, copies "
                          f"{prof['copy_ms']:.3f} ms in "
                          f"{prof['copy_calls']:.0f}; collectives "
                          f"{prog.collectives}", flush=True)
                out["legs"].append(rec)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
            del lm, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print("PROFILE " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
