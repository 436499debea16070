"""Loss functionals of the port (counterpart of the reference's
``nn/functional/loss.py``): ``cross_entropy`` with hard or soft labels,
class weights, label smoothing and ``use_softmax=False``, and
``softmax_with_cross_entropy``."""
from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross-entropy over ``axis`` in float32, the reference's rule.

    The log-probabilities are ``log_softmax(input)``, or with
    ``use_softmax=False`` ``log(max(input, 1e-30))`` (the input already
    probabilities). Hard labels (integers; a trailing size-1 class axis
    is squeezed): ``-logp[label]``, 0 where ``label == ignore_index``;
    with ``label_smoothing`` ``ls``, ``-(1 - ls) * logp[label] + ls *
    mean(-logp)``; with class ``weight`` [C] each loss times its label's
    weight, and "mean" divides by the sum of the valid labels' weights
    (at least 1e-12), else by the count of valid labels (at least 1).
    Soft labels (a distribution over ``axis``, smoothed to ``(1 - ls) *
    soft + ls / C``): ``-sum(soft * logp)``, and "mean" averages over
    every position. "sum" sums, "none" keeps the per-position losses.

    Soft labels with a class ``weight`` or an ``ignore_index`` other
    than -100 raise ``NotImplementedError``: the reference accepts both
    there and reads neither.
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    if soft_label and (weight is not None or ignore_index != -100):
        raise NotImplementedError(
            "cross_entropy: soft labels with a class weight or an "
            "ignore_index (the reference reads neither with soft labels)")
    ax = axis % input.dim()
    lf = input.float()
    if use_softmax:
        logp = torch.log_softmax(lf, dim=ax)
    else:
        logp = torch.log(torch.clamp_min(lf, 1e-30))
    n_classes = input.shape[ax]
    if soft_label:
        soft = label.float()
        if label_smoothing > 0.0:
            soft = (1 - label_smoothing) * soft \
                + label_smoothing / n_classes
        return _reduce(-torch.sum(soft * logp, dim=ax), reduction)
    lab = label
    if lab.dim() == input.dim():
        lab = lab.squeeze(ax)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0.0:
        smooth_loss = -torch.mean(logp, dim=ax)
        loss = -(1 - label_smoothing) * picked \
            + label_smoothing * smooth_loss
    else:
        loss = -picked
    zero = torch.zeros_like(loss)
    loss = torch.where(valid, loss, zero)
    if weight is not None:
        wt = torch.where(valid, weight.float()[safe], zero)
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(wt.sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    return _reduce(loss, reduction)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-position :func:`cross_entropy` (reduction "none") with the
    class axis kept as size 1; with ``return_softmax`` also
    ``softmax(logits)`` over ``axis`` (in the logits' dtype).
    ``numeric_stable_mode=False`` raises ``NotImplementedError``: the
    reference accepts it and always runs the stable form."""
    if not numeric_stable_mode:
        raise NotImplementedError(
            "softmax_with_cross_entropy: numeric_stable_mode=False (the "
            "reference always runs the stable form)")
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis % logits.dim())
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
