"""End-to-end intelligent video query on the PyTorch port (paper §5) with
real classifiers.

Unlike the benchmark (which uses the calibrated surrogate crop bank for the
full Fig. 5 sweep), this example runs the paper's actual pipeline:

  1. train COC (cloud classifier) on synthetic 'historical video' crops;
  2. COC labels the crops; EOC (edge binary classifier) trains on-the-fly
     against those labels — the paper's hybrid-collaboration detail;
  3. precompute the crop bank with one batched inference pass;
  4. deploy the ACE application and run the DES on the model-backed bank.

The port of ``examples/video_query.py``: the classifiers train and infer on
the card, or with ``--device cpu`` on the CPU.

    PYTHONPATH=src python examples/torch/video_query.py [--coc-steps 120]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.configs.ace_video_query import config
from repro_torch.core.video_query import run_video_query
from repro_torch.data.video import model_crop_bank


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coc-steps", type=int, default=200)
    ap.add_argument("--eoc-steps", type=int, default=80)
    ap.add_argument("--bank", type=int, default=1024)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--full-coc", action="store_true",
                    help="train the paper-ratio COC (slow on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = config()
    if not args.full_coc:
        # CPU-friendly COC: same role, ~20x EOC capacity instead of ~40x
        cfg = dataclasses.replace(
            cfg, coc=dataclasses.replace(cfg.coc, widths=(32, 64, 128, 256),
                                         num_blocks_per_stage=1))
    print("training COC (cloud) and EOC (edge, on-the-fly, COC-labelled)...")
    bank, report = model_crop_bank(
        cfg, n_train=2048, n_bank=args.bank, coc_steps=args.coc_steps,
        eoc_steps=args.eoc_steps, batch=64, device=args.device)
    print(f"  COC train acc: {report['coc']['acc']:.3f}")
    print(f"  EOC train acc: {report['eoc']['acc']:.3f}")
    print(f"  EOC error @ conf>=0.8: {report['eoc_error_at_conf']:.3f} "
          f"(paper: 0.1106)")
    print(f"  escalation band fraction: {report['escalation_rate']:.3f}")

    print("\nrunning the ACE application on the model-backed crop bank:")
    print(f"{'paradigm':8s} {'F1':>6s} {'BWC(MB)':>8s} {'EIL(s)':>7s}")
    for paradigm in ("ci", "ei", "ace", "ace+"):
        r = run_video_query(cfg, paradigm=paradigm, frame_interval_s=0.2,
                            wan_delay_ms=50.0, duration_s=args.duration,
                            crop_bank=bank)
        print(f"{paradigm:8s} {r['f1']:6.3f} {r['bwc_mb']:8.2f} "
              f"{r['eil_s']:7.3f}")
    print("\n(expect: CI highest F1 + highest BWC; EI lowest F1, ~0 BWC; "
          "ACE between)")


if __name__ == "__main__":
    main()
