"""Loss functionals of the port (counterpart of the reference's
``nn/functional/loss.py``): the hard-label ``cross_entropy`` that
``LlamaPretrainingCriterion`` uses."""
from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy against integer labels, in float32:
    ``-log_softmax(input)[label]``, 0 where ``label == ignore_index``.
    reduction "mean" divides by the count of non-ignored labels (at
    least 1), "sum" sums, "none" keeps the labels' shape. Soft labels,
    class weights, label smoothing and ``use_softmax=False`` are not
    ported yet."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "cross_entropy: only hard labels with softmax, no class "
            "weights and no label smoothing are ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    ax = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=ax)
    lab = label
    if lab.dim() == input.dim():
        lab = lab.squeeze(ax)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
