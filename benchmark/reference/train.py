"""Plain reference of the first training steps: crops from the raw memmap
echograms, the train augmentation, the train label chain, the
architecture's reference forward in train mode (handed in by the cell, from
the configuration's adapter), the class-weighted cross entropy and SGD
with momentum.

The laws are the reference pipeline's (CRIMAC-classifiers-unet
batch/dataset.py, batch/transforms.py, the label and data transforms,
pipeline.py), as the configuration selects them:

* crop: rows ``[y - (h + 1)//2 + 1, ... + h)`` and columns likewise
  around a center; pixels outside the echogram read sv 0 and label -100
  (boundary); non-finite sv reads 0.  The program's batches carry the
  crop's upper-left in a canvas padded by one window on every side,
  which is what the reference reads back (the crops are the program's
  draws, as served tokens are a model's);
* augmentation: per sample with p = 0.5 multiply each pixel, with p =
  0.05, by U[1, 10) (p = 0.5) or U[0, 1); then flip the ping axis with p
  = 0.5.  The draws come from a generator the benchmark seeds and hands
  to the program, in the program's documented order (apply, change,
  increase, up, down for the noise; then the flip);
* labels: inside the crop's non-boundary box, a labelled pixel whose 200
  kHz sv lies outside (1e-7, 1e-4) after a 7x7-disc closing of the
  in-threshold mask (dilation zeroed outside the box, borders 0) becomes
  -30; then codes {0, 27, 1} -> {0, 1, 2}, the rest ignored;
* data: pixels whose first channel is not finite are ignored, sv
  non-finite -> 0, then ``clip(10 log10(sv + 1e-10), -75, 0)``;
* loss: cross entropy weighted [10, 300, 250] by class, the weighted
  mean over pixels not ignored; BatchNorm on batch statistics (biased
  variance); SGD ``buf = momentum * buf + grad`` (``buf = grad`` at the
  first step), ``p -= lr * buf``, lr halved every ``lr_step`` steps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import exact_float32

IGNORE = -100
REFINE = -30
CLASS_WEIGHTS = (10.0, 300.0, 250.0)
DISC = torch.tensor([[0, 0, 1, 1, 1, 0, 0], [0, 1, 1, 1, 1, 1, 0],
                     [1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1],
                     [1, 1, 1, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1, 0],
                     [0, 0, 1, 1, 1, 0, 0]], dtype=torch.float32)


def crop(survey_data, survey_labels, y0, x0, wh, ww):
    """One crop from an echogram's (C, H, W) sv and (H, W) labels at the
    window-padded upper-left (y0, x0)."""
    C, H, W = survey_data.shape
    ry, rx = y0 - wh, x0 - ww          # echogram coordinates
    data = np.zeros((C, wh, ww), np.float32)
    labels = np.full((wh, ww), IGNORE, np.int64)
    a, b = max(ry, 0), min(ry + wh, H)
    c, d = max(rx, 0), min(rx + ww, W)
    if a < b and c < d:
        data[:, a - ry:b - ry, c - rx:d - rx] = survey_data[:, a:b, c:d]
        labels[a - ry:b - ry, c - rx:d - rx] = survey_labels[a:b, c:d]
    return np.nan_to_num(data, nan=0.0, posinf=0.0, neginf=0.0), labels


def augment(gen, data, labels):
    B = data.shape[0]

    def u(shape):
        return torch.rand(shape, generator=gen, device=data.device)

    apply, change, increase = u((B,)) < 0.5, u(data.shape) < 0.05, \
        u(data.shape) < 0.5
    up, down = 1.0 + 9.0 * u(data.shape), u(data.shape)
    factor = torch.where(change, torch.where(increase, up, down), 1.0)
    data = data * torch.where(apply[:, None, None, None], factor, 1.0)
    flip = u((B,)) < 0.5
    data = torch.where(flip[:, None, None, None], data.flip(-1), data)
    labels = torch.where(flip[:, None, None], labels.flip(-1), labels)
    return data, labels


def _count(mask):
    k = DISC.to(mask.device)[None, None]
    return F.conv2d(mask[:, None].float(), k, padding=3)[:, 0]


def closing(mask, clip):
    dil = (_count(mask) > 0.5) & clip
    return _count(dil) > DISC.sum().item() - 0.5


def train_labels(data, labels):
    valid = labels != IGNORE
    rows = valid.any(dim=2)
    cols = valid.any(dim=1)
    H, W = labels.shape[1:]
    ar_h = torch.arange(H, device=labels.device)
    ar_w = torch.arange(W, device=labels.device)
    box = []
    for r, c in zip(rows, cols):
        ys, xs = ar_h[r], ar_w[c]
        b = torch.zeros((H, W), dtype=torch.bool, device=labels.device)
        if len(ys):
            b[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
        box.append(b)
    box = torch.stack(box)
    d = data[:, -1]
    inside = (labels > 0) & (d > 1e-7) & (d < 1e-4)
    relabel = ~closing(inside, box) & (labels > 0) & box
    out = torch.where(relabel, REFINE, labels)
    out = torch.where(valid.flatten(1).any(1)[:, None, None], out, labels)
    conv = torch.full_like(out, IGNORE)
    for code, cls in ((0, 0), (27, 1), (1, 2)):
        conv = torch.where(out == code, cls, conv)
    return conv


def step_inputs(data, labels):
    labels = torch.where(torch.isfinite(data[:, 0]), labels, IGNORE)
    data = torch.where(torch.isfinite(data), data, 0.0)
    return torch.clamp(10.0 * torch.log10(data + 1e-10), -75.0, 0.0), labels


def weighted_ce(logits, labels):
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.tensor(CLASS_WEIGHTS, device=logits.device)[safe] * valid
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def run_steps(state, batches, gen, cfg, forward, quant=None):
    """Follow the first ``len(batches)`` training steps from ``state``
    (float32 leaves, copied); each batch is (data (B, C, H, W) raw sv,
    labels (B, H, W)) on the device.  ``forward(state, x, quant, mode)``
    is the architecture's reference forward.  Returns (losses, the
    gradients of the first step, the parameters after the last)."""
    params = {k: v.detach().clone().float() for k, v in state.items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    bufs, losses, grad1 = {}, [], None
    lr0, rate, every = (float(cfg["lr"]), float(cfg["lr_reduction"]),
                        int(cfg["lr_step"]))
    mom = float(cfg["momentum"])
    for step, (data, labels) in enumerate(batches):
        data, labels = augment(gen, data, labels)
        labels = train_labels(data, labels)
        x, labels = step_inputs(data, labels)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        with exact_float32():
            logits = forward(leaves, x, quant, "train")
            loss = weighted_ce(logits, labels)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.item())
        lr = lr0 * rate ** (step // every)
        with torch.no_grad():
            new = {}
            for (k, p), g in zip(leaves.items(), grads):
                bufs[k] = g.clone() if k not in bufs else \
                    bufs[k] * mom + g
                new[k] = (p - lr * bufs[k]).detach()
            params = new
        if step == 0:
            grad1 = {k: g.detach() for k, g in zip(leaves, grads)}
    return losses, grad1, params


def leaf_gaps(prog, ref, skip=()):
    """The worst leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves in ``skip`` are left out."""
    norms = {k: float(torch.linalg.vector_norm(v.float()))
             for k, v in ref.items() if k not in skip}
    med = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].float())) - n)
               / max(n, med) for k, n in norms.items())
