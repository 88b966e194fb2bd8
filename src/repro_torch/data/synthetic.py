"""Synthetic data generators.

Token streams: a learnable Markov-ish process (not uniform noise) so that
training ~100M models for a few hundred steps shows a *falling* loss curve —
the end-to-end example's acceptance signal.

Video crops: class-conditional structured images for the EOC/COC classifiers
of the video-query application (10 classes; class 1 is the query target,
playing 'motorcycle').
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Order-1 Markov chain over the vocab with a low-rank transition
    structure; entropy well below log(V) so models can learn it."""
    vocab_size: int
    seed: int = 0
    rank: int = 16
    temp: float = 0.7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v, r = self.vocab_size, self.rank
        self._a = rng.normal(size=(v, r)).astype(np.float32)
        self._b = rng.normal(size=(r, v)).astype(np.float32)

    def _probs(self, tok: np.ndarray) -> np.ndarray:
        logits = (self._a[tok] @ self._b) / self.temp
        logits -= logits.max(axis=-1, keepdims=True)
        p = np.exp(logits)
        return p / p.sum(axis=-1, keepdims=True)

    def sample(self, batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len), np.int32)
        tok = rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq_len):
            p = self._probs(tok)
            # vectorized categorical sampling via inverse CDF
            u = rng.random(batch)[:, None]
            tok = (p.cumsum(axis=-1) < u).sum(axis=-1)
            tok = np.minimum(tok, self.vocab_size - 1)
            out[:, t] = tok
        return out

    def batches(self, batch: int, seq_len: int,
                seed: int = 0) -> Iterator[dict]:
        i = 0
        while True:
            tokens = self.sample(batch, seq_len, seed=seed + i)
            labels = np.concatenate(
                [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
            yield {"tokens": tokens, "labels": labels}
            i += 1


def synth_crops(n: int, *, num_classes: int = 10, image_size: int = 32,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional crops: each class is a distinct oriented grating +
    colour tint + noise. Learnable by small conv nets within a few hundred
    steps, with enough overlap that classifiers stay imperfect (the cascade
    needs a confidence distribution, not a solved task)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    images = np.empty((n, image_size, image_size, 3), np.float32)
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        if len(idx) == 0:
            continue
        theta = np.pi * c / num_classes
        freq = 0.25 + 0.06 * c
        base = np.sin(freq * (np.cos(theta) * xx + np.sin(theta) * yy))
        tint = np.array([np.cos(2.1 * c), np.sin(1.3 * c), np.cos(0.7 * c)])
        tint = 0.5 + 0.35 * tint
        # grating (second-order cue) + DC colour tint (first-order cue)
        img = (0.5 + 0.4 * base[..., None] * tint[None, None, :]
               + 0.18 * (tint[None, None, :] - 0.5))
        noise = rng.normal(scale=0.55, size=(len(idx), image_size,
                                             image_size, 3))
        # small jitter only: full wraparound shifts made the task
        # unlearnable for CPU-scale training budgets
        shift = rng.integers(0, 4, size=(len(idx), 2))
        batch = np.clip(img[None] + noise, 0, 1).astype(np.float32)
        for k, i in enumerate(idx):
            images[i] = np.roll(batch[k], tuple(shift[k]), axis=(0, 1))
    return images, labels
