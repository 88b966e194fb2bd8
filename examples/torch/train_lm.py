"""End-to-end training on the PyTorch port: train an LM on the synthetic
Markov stream with the full substrate — the batch loader, AdamW +
warmup-cosine, rematerialised scanned stages (flash attention and its
backward kernel on the card), checkpointing.

The port of ``examples/train_lm.py``. The default is a small run (reduced
smollm); the full smollm-135m (~134M parameters) is the same code path:

    PYTHONPATH=src python examples/torch/train_lm.py --arch smollm-135m \
        --full --steps 300 --batch 32 --seq 512        # on the card

    PYTHONPATH=src python examples/torch/train_lm.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.model import LM
from repro_torch.optim import linear_warmup_cosine
from repro_torch.training import Trainer
from repro_torch.utils.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="train the full config (not the reduced variant)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    lm = LM(cfg, device=args.device)
    stream = TokenStream(cfg.vocab_size, seed=0)
    loader = ShardedLoader(stream.batches(args.batch, args.seq),
                           device=lm.device)

    trainer = Trainer(lm, linear_warmup_cosine(args.lr, 10, args.steps),
                      ckpt_dir=args.ckpt_dir, log_every=5,
                      ckpt_every=50 if args.ckpt_dir else 0)
    params, opt = trainer.restore_or_init(0) if args.ckpt_dir \
        else trainer.init_state(0)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name}  params~{n / 1e6:.1f}M")
    params, opt = trainer.fit(params, opt, iter(loader), args.steps)

    losses = [h["loss"] for h in trainer.history]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'FELL' if losses[-1] < losses[0] else 'DID NOT FALL'})")


if __name__ == "__main__":
    main()
