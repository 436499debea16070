"""The port's ``cross_entropy`` modes and ``softmax_with_cross_entropy``
against the JAX package's, forward and gradient, on the CPU.

Inputs are float32 logits (or probabilities, for ``use_softmax=False``)
from a seeded numpy RandomState; hard labels carry ``ignore_index``
entries. Every mode (hard, hard with label smoothing, class weights,
weights with smoothing, soft, soft with smoothing, ``use_softmax=False``
hard and soft) runs under each reduction, with the class axis last and
first. Tolerance: loss and gradient within 1e-6 relative + 1e-7 (the
same float32 operations, reductions summed in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn.functional as TF

N, C = 6, 5
RTOL, ATOL = 1e-6, 1e-7

# id: (soft_label, use_softmax, weight, label_smoothing, ignore)
MODES = {
    "hard": (False, True, False, 0.0, True),
    "hard_smooth": (False, True, False, 0.1, True),
    "weight": (False, True, True, 0.0, True),
    "weight_smooth": (False, True, True, 0.2, True),
    "soft": (True, True, False, 0.0, False),
    "soft_smooth": (True, True, False, 0.1, False),
    "probs_hard": (False, False, False, 0.0, True),
    "probs_soft": (True, False, False, 0.0, False),
}


def _inputs(mode, axis, seed=0):
    soft, use_softmax, weighted, _, ignore = MODES[mode]
    rng = np.random.RandomState(seed)
    x = rng.randn(N, 3, C).astype(np.float32)
    if not use_softmax:   # probabilities, one of them exactly 0
        e = np.exp(x)
        x = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        x[0, 0, 0] = 0.0
    if soft:
        lab = rng.rand(N, 3, C).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.randint(0, C, size=(N, 3)).astype(np.int64)
        if ignore:
            lab[1, 2] = lab[4, 0] = -100
    w = rng.rand(C).astype(np.float32) + 0.5 if weighted else None
    if axis == 0:
        x = np.moveaxis(x, -1, 0).copy()
        if soft:
            lab = np.moveaxis(lab, -1, 0).copy()
    return x, lab, w


def _run(mode, reduction, axis, ignore_index=-100, keep_label_axis=False):
    soft, use_softmax, _, smooth, _ = MODES[mode]
    x, lab, w = _inputs(mode, axis)
    if not soft:   # no label outside [0, C) but the one ignored
        lab[lab == -100] = ignore_index
    if keep_label_axis and not soft:
        lab = np.expand_dims(lab, axis)
    kw = dict(reduction=reduction, soft_label=soft, axis=axis,
              use_softmax=use_softmax, label_smoothing=smooth,
              ignore_index=ignore_index)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jl = paddle.to_tensor(lab)
    jout = JF.cross_entropy(jx, jl, weight=None if w is None
                            else paddle.to_tensor(w), **kw)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tout = TF.cross_entropy(tx, torch.from_numpy(lab), weight=None
                            if w is None else torch.from_numpy(w), **kw)
    jout.sum().backward()
    tout.sum().backward()
    return (np.asarray(jout._data), tout.detach().numpy(),
            np.asarray(jx.grad._data), tx.grad.numpy())


@pytest.mark.parametrize("axis", [-1, 0], ids=["last", "first"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_the_reference(mode, reduction, axis):
    jv, tv, jg, tg = _run(mode, reduction, axis)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["hard", "weight", "hard_smooth"])
def test_ignore_index_and_a_kept_label_axis(mode):
    """Another ``ignore_index`` (a real class here), and hard labels that
    keep a size-1 class axis."""
    for kw in ({"ignore_index": 2}, {"keep_label_axis": True}):
        jv, tv, jg, tg = _run(mode, "mean", -1, **kw)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_every_label_ignored():
    """"mean" over no valid label is 0 (the count and the weight sum are
    clamped), in both packages."""
    x = np.random.RandomState(1).randn(4, C).astype(np.float32)
    lab = np.full(4, -100, np.int64)
    w = np.ones(C, np.float32)
    for weight in (None, w):
        j = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(lab),
                             weight=None if weight is None
                             else paddle.to_tensor(weight))
        t = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                             weight=None if weight is None
                             else torch.from_numpy(weight))
        assert float(t) == float(np.asarray(j._data)) == 0.0


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("axis", [-1, 0], ids=["last", "first"])
def test_softmax_with_cross_entropy(soft, axis):
    x, lab, _ = _inputs("soft" if soft else "hard", axis, seed=2)
    if not soft:
        lab = np.expand_dims(lab, axis)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    jloss, jsm = JF.softmax_with_cross_entropy(
        jx, paddle.to_tensor(lab), soft_label=soft, axis=axis,
        return_softmax=True)
    tloss, tsm = TF.softmax_with_cross_entropy(
        tx, torch.from_numpy(lab), soft_label=soft, axis=axis,
        return_softmax=True)
    assert tuple(tloss.shape) == tuple(jloss.shape)
    np.testing.assert_allclose(tloss.detach().numpy(),
                               np.asarray(jloss._data), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsm.detach().numpy(), np.asarray(jsm._data),
                               rtol=RTOL, atol=ATOL)
    jloss.sum().backward()
    tloss.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=RTOL, atol=ATOL)
    only = TF.softmax_with_cross_entropy(tx, torch.from_numpy(lab),
                                         soft_label=soft, axis=axis)
    assert torch.equal(only, tloss)


def test_bf16_logits_compute_in_float32():
    x = np.random.RandomState(3).randn(8, C).astype(np.float32)
    lab = np.arange(8) % C
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TF.cross_entropy(xb, torch.from_numpy(lab), label_smoothing=0.1,
                           weight=torch.full((C,), 2.0))
    want = TF.cross_entropy(xb.float(), torch.from_numpy(lab),
                            label_smoothing=0.1,
                            weight=torch.full((C,), 2.0))
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("call", [
    lambda x, s, h: TF.cross_entropy(x, s, soft_label=True,
                                     weight=torch.ones(C)),
    lambda x, s, h: TF.cross_entropy(x, s, soft_label=True, ignore_index=0),
    lambda x, s, h: TF.softmax_with_cross_entropy(
        x, h, numeric_stable_mode=False),
], ids=["soft_weight", "soft_ignore_index", "numeric_unstable"])
def test_options_the_reference_never_reads_raise(call):
    x = torch.zeros(2, C)
    with pytest.raises(NotImplementedError):
        call(x, torch.full((2, C), 1.0 / C), torch.zeros(2, 1,
                                                         dtype=torch.long))
    with pytest.raises(ValueError):
        TF.cross_entropy(x, torch.zeros(2, dtype=torch.long),
                         reduction="bogus")
