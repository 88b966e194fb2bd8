"""Model-backed crop bank: real classifiers behind the video-query DES.

The full end-to-end path of paper §5.1.2: COC trained on all 10 classes;
EOC trained *on the fly* as a binary (target vs rest) classifier on crops
labelled by COC (the paper's hybrid-collaboration detail); then every crop's
(EOC confidence, EOC prediction, COC top-2 hit, COC post-hoc label) is
precomputed in one batched pass and replayed by the simulator.

The port of ``repro.data.video``: the classifiers train and run on the
card (``device="cuda"``, the default) with ``torch.autograd`` and the
port's AdamW, on the batches ``repro`` draws from the same seeds.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.ace_video_query import VideoQueryConfig
from repro_torch.core.video_query import Crop
from repro_torch.data.synthetic import synth_crops
from repro_torch.models.cnn import Classifier, f32_exact
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map

TARGET_CLASS = 1    # plays 'motorcycle'


def train_classifier(model: Classifier, images, labels, *, steps: int,
                     batch: int = 128, lr: float = 3e-3, seed: int = 0):
    """AdamW steps from ``model.init(seed)`` on batches drawn with
    ``np.random.default_rng(seed)`` from ``images``/``labels`` (numpy).
    The data moves to the model's device once; a step syncs the host only
    for the batch indices' copy."""
    dev = model.device
    params = model.init(seed)
    opt = adamw_init(params)
    x_all = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    y_all = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    rng = np.random.default_rng(seed)
    n = len(images)
    loss = acc = torch.zeros(())
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=batch)).to(dev)
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        with f32_exact():     # the backward's convolutions too
            loss, aux = model.loss(params, x_all[idx], y_all[idx])
            by_id = dict(zip(map(id, leaves),
                             torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda p: by_id[id(p)], params)
        params, opt = adamw_update(params, grads, opt, lr=lr)
        acc = aux["acc"]
    params = tree_map(lambda p: p.detach(), params)
    return params, {"loss": float(loss.detach()), "acc": float(acc)}


@torch.no_grad()
def bank_pass(eoc: Classifier, coc: Classifier, eoc_params, coc_params,
              images):
    """Every crop's (EOC confidence, EOC prediction, COC top-2 hit, COC
    post-hoc label) in one batched pass: four (N,) tensors."""
    eoc_probs = torch.softmax(eoc.apply(eoc_params, images), -1)
    # the paper's 'object identification confidence' is p(target),
    # not max-softmax (for a binary head the latter never drops
    # below 0.5, so nothing would ever be dropped or escalated)
    conf = eoc_probs[:, 1]
    pred = (conf >= 0.5).to(torch.int32)
    coc_logits = coc.apply(coc_params, images)
    # paper uses top-5 of 1000 ImageNet classes; with 10 synthetic
    # classes the proportional analogue is top-2
    top2 = torch.topk(coc_logits, 2).indices
    hit = torch.any(top2 == TARGET_CLASS, dim=-1)
    posthoc = torch.argmax(coc_logits, -1) == TARGET_CLASS
    return conf, pred, hit, posthoc


def bank_near_ties(conf, coc_logits, tol: float):
    """(N,) bool: crops whose bank booleans sit within ``tol`` of a flip —
    ``pred`` (conf against 0.5), ``hit`` (the 2nd against the 3rd COC
    logit) or ``posthoc`` (the 1st against the 2nd) — where two backends'
    roundings may decide them apart."""
    top = torch.topk(coc_logits.float(), min(3, coc_logits.shape[-1])).values
    gaps = top[:, :-1] - top[:, 1:]
    return (torch.abs(conf - 0.5) < tol) | torch.any(gaps < tol, dim=-1)


def model_crop_bank(cfg: VideoQueryConfig, *, n_train: int = 4096,
                    n_bank: int = 2048, coc_steps: int = 300,
                    eoc_steps: int = 120, seed: int = 0,
                    confidence_threshold: float = 0.8,
                    batch: int = 128, device="cuda"
                    ) -> Tuple[List[Crop], dict]:
    """Returns (crop bank, training report)."""
    dev = resolve_device(device)
    # 1. 'historical video data' -> crops (the YOLO extraction stub:
    #    synth_crops plays the cropped objects directly)
    train_imgs, train_lbls = synth_crops(n_train, seed=seed)
    bank_imgs, bank_lbls = synth_crops(n_bank, seed=seed + 1)

    # 2. COC: multi-class cloud classifier
    coc = Classifier(cfg.coc, device=dev)
    coc_params, coc_rep = train_classifier(coc, train_imgs, train_lbls,
                                           steps=coc_steps, seed=seed,
                                           batch=batch)

    # 3. COC labels the historical crops; EOC trains on-the-fly against them
    with torch.no_grad():
        coc_labels = torch.argmax(coc.apply(
            coc_params, torch.from_numpy(train_imgs).to(dev)), -1)
    eoc_targets = (coc_labels.cpu().numpy() == TARGET_CLASS).astype(np.int32)
    eoc = Classifier(cfg.eoc, device=dev)
    eoc_params, eoc_rep = train_classifier(eoc, train_imgs, eoc_targets,
                                           steps=eoc_steps, seed=seed + 2,
                                           batch=batch)

    # 4. batched precomputation over the bank
    conf, pred, hit, posthoc = (a.cpu().numpy() for a in bank_pass(
        eoc, coc, eoc_params, coc_params,
        torch.from_numpy(bank_imgs).to(dev)))
    crops = [Crop(i, bool(posthoc[i]), float(conf[i]), int(pred[i]),
                  bool(hit[i]), cfg.crop_bytes) for i in range(n_bank)]
    decided = (conf >= confidence_threshold) | (conf < 0.1)
    eoc_err = float(np.mean((pred != (bank_lbls == TARGET_CLASS))[decided])) \
        if np.any(decided) else 1.0
    report = {
        "coc": coc_rep, "eoc": eoc_rep,
        "eoc_error_at_conf": eoc_err,
        "escalation_rate": float(np.mean((conf < confidence_threshold)
                                         & (conf >= 0.1))),
    }
    return crops, report
