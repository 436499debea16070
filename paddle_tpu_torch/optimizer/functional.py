"""In-place optimizer update rules of the port (counterpart of the
reference's ``optimizer/functional.py``: the upstream ops ``sgd_``,
``momentum_``, ``adam_``, ``adamw_``, ``adagrad_``, ``adadelta_``,
``adamax_``, ``rmsprop_``, ``lamb_``, ``asgd_``, ``lars_momentum_``,
``merged_adam_``, ``merged_momentum_`` and ``rprop_``).

Each rule reads its tensors in float32, computes the reference's update
and writes every result back into its tensor in place (cast to that
tensor's dtype), then returns the tensors as the reference does. The
multi-precision master is the optimizer classes' business, not these
rules'. They run without autograd.
"""
from __future__ import annotations

import torch


def _f32(t):
    return t.float()


def _write(t, new):
    with torch.no_grad():
        t.copy_(new)
    return t


def _full(value, like):
    """``value`` as a float32 tensor shaped like ``like``: a true
    float32 division by a tensor, where ``value / tensor`` would multiply
    by a reciprocal."""
    return torch.full_like(like, float(value), dtype=torch.float32)


@torch.no_grad()
def sgd_(param, learning_rate, grad, name=None):
    """param <- param - lr * grad (upstream sgd_ op)."""
    lr = float(learning_rate)
    return _write(param, _f32(param) - lr * _f32(grad))


@torch.no_grad()
def momentum_(param, grad, velocity, learning_rate, mu=0.9,
              use_nesterov=False, name=None):
    """Heavy-ball / Nesterov momentum (upstream momentum_ op)."""
    lr, mu = float(learning_rate), float(mu)
    vf = mu * _f32(velocity) + _f32(grad)
    if use_nesterov:
        pf = _f32(param) - lr * (_f32(grad) + mu * vf)
    else:
        pf = _f32(param) - lr * vf
    return _write(param, pf), _write(velocity, vf)


@torch.no_grad()
def adam_(param, grad, moment1, moment2, beta1_pow, beta2_pow,
          learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8, name=None):
    """Adam (upstream adam_ op): the beta powers are multiplied first and
    the bias correction reads the new ones; every tensor updated in
    place."""
    lr = float(learning_rate)
    gf = _f32(grad)
    mf = beta1 * _f32(moment1) + (1 - beta1) * gf
    vf = beta2 * _f32(moment2) + (1 - beta2) * gf * gf
    nbp1 = _f32(beta1_pow) * beta1
    nbp2 = _f32(beta2_pow) * beta2
    mhat = mf / (1 - nbp1)
    vhat = vf / (1 - nbp2)
    pf = _f32(param) - lr * mhat / (torch.sqrt(vhat) + epsilon)
    for t, n in zip((param, moment1, moment2, beta1_pow, beta2_pow),
                    (pf, mf, vf, nbp1, nbp2)):
        _write(t, n)
    return param, moment1, moment2, beta1_pow, beta2_pow


@torch.no_grad()
def adamw_(param, grad, moment1, moment2, beta1_pow, beta2_pow,
           learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8,
           weight_decay=0.01, lr_ratio=1.0, name=None):
    """AdamW (upstream adamw_ op): the decoupled decay written into the
    parameter first, then :func:`adam_` at ``lr * lr_ratio``."""
    lr = float(learning_rate) * float(lr_ratio)
    _write(param, _f32(param) * (1 - lr * weight_decay))
    return adam_(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                 lr, beta1, beta2, epsilon)


@torch.no_grad()
def adagrad_(param, grad, moment, learning_rate, epsilon=1e-6, name=None):
    """Adagrad (upstream adagrad_ op)."""
    lr = float(learning_rate)
    gf = _f32(grad)
    af = _f32(moment) + gf * gf
    pf = _f32(param) - lr * gf / (torch.sqrt(af) + epsilon)
    return _write(param, pf), _write(moment, af)


@torch.no_grad()
def adadelta_(param, grad, avg_squared_grad, avg_squared_update,
              learning_rate=1.0, rho=0.95, epsilon=1e-6, name=None):
    """Adadelta (upstream adadelta_ op)."""
    lr = float(learning_rate)
    gf = _f32(grad)
    eg = rho * _f32(avg_squared_grad) + (1 - rho) * gf * gf
    dx = torch.sqrt(_f32(avg_squared_update) + epsilon) \
        / torch.sqrt(eg + epsilon) * gf
    ed = rho * _f32(avg_squared_update) + (1 - rho) * dx * dx
    pf = _f32(param) - lr * dx
    return (_write(param, pf), _write(avg_squared_grad, eg),
            _write(avg_squared_update, ed))


@torch.no_grad()
def adamax_(param, grad, moment, inf_norm, beta1_pow, learning_rate,
            beta1=0.9, beta2=0.999, epsilon=1e-8, name=None):
    """Adamax (upstream adamax_ op): an infinity-norm second moment."""
    lr = float(learning_rate)
    gf = _f32(grad)
    mf = beta1 * _f32(moment) + (1 - beta1) * gf
    uf = torch.maximum(beta2 * _f32(inf_norm), torch.abs(gf))
    nbp = _f32(beta1_pow) * beta1
    step = _full(lr, nbp) / (1 - nbp)
    pf = _f32(param) - step * mf / (uf + epsilon)
    for t, n in zip((param, moment, inf_norm, beta1_pow),
                    (pf, mf, uf, nbp)):
        _write(t, n)
    return param, moment, inf_norm, beta1_pow


@torch.no_grad()
def rmsprop_(param, grad, mean_square, moment, learning_rate,
             mean_grad=None, rho=0.95, epsilon=1e-6, momentum=0.0,
             centered=False, name=None):
    """RMSProp (upstream rmsprop_ op), plain or centered; returns the
    parameter."""
    lr = float(learning_rate)
    gf = _f32(grad)
    sf = rho * _f32(mean_square) + (1 - rho) * gf * gf
    if centered:
        gavg = rho * _f32(mean_grad) + (1 - rho) * gf
        denom = sf - gavg * gavg
    else:
        denom = sf
    vf = momentum * _f32(moment) + lr * gf / torch.sqrt(denom + epsilon)
    _write(param, _f32(param) - vf)
    _write(mean_square, sf)
    _write(moment, vf)
    if centered:
        _write(mean_grad, gavg)
    return param


@torch.no_grad()
def lamb_(param, grad, moment1, moment2, beta1_pow, beta2_pow,
          learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-6,
          weight_decay=0.01, name=None):
    """LAMB (upstream lamb_ op): the bias-corrected Adam direction plus
    the decay, scaled by the layerwise trust ratio ||p|| / ||update||."""
    lr = float(learning_rate)
    gf = _f32(grad)
    pf = _f32(param)
    mf = beta1 * _f32(moment1) + (1 - beta1) * gf
    vf = beta2 * _f32(moment2) + (1 - beta2) * gf * gf
    nbp1 = _f32(beta1_pow) * beta1
    nbp2 = _f32(beta2_pow) * beta2
    mhat = mf / (1 - nbp1)
    vhat = vf / (1 - nbp2)
    r = mhat / (torch.sqrt(vhat) + epsilon) + weight_decay * pf
    p_norm = torch.sqrt(torch.sum(pf * pf))
    r_norm = torch.sqrt(torch.sum(r * r))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    new_p = pf - lr * trust * r
    for t, n in zip((param, moment1, moment2, beta1_pow, beta2_pow),
                    (new_p, mf, vf, nbp1, nbp2)):
        _write(t, n)
    return param, moment1, moment2, beta1_pow, beta2_pow


@torch.no_grad()
def asgd_(param, grad, d, y, n, learning_rate, name=None):
    """ASGD (upstream asgd_ op): ``d <- d - y + g; y <- g;
    param <- param - lr / n * d``."""
    lr = float(learning_rate)
    nf = float(n.item() if isinstance(n, torch.Tensor) else n)
    gf = _f32(grad)
    df = _f32(d) - _f32(y) + gf
    pf = _f32(param) - (lr / nf) * df
    return _write(param, pf), _write(d, df), _write(y, gf)


@torch.no_grad()
def lars_momentum_(param, grad, velocity, learning_rate, mu=0.9,
                   lars_coeff=0.001, lars_weight_decay=0.0005,
                   epsilon=0.0, name=None):
    """LARS momentum (upstream lars_momentum op): the local rate scaled
    by ||p|| / (||g|| + wd * ||p||)."""
    lr = float(learning_rate)
    pf, gf = _f32(param), _f32(grad)
    p_norm = torch.sqrt(torch.sum(pf * pf))
    g_norm = torch.sqrt(torch.sum(gf * gf))
    local = lr * lars_coeff * p_norm / (
        g_norm + lars_weight_decay * p_norm + epsilon + 1e-20)
    vf = mu * _f32(velocity) + local * (gf + lars_weight_decay * pf)
    return _write(param, pf - vf), _write(velocity, vf)


def merged_adam_(params, grads, moments1, moments2, beta1_pows,
                 beta2_pows, learning_rate, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, name=None):
    """:func:`adam_` over parameter lists (upstream merged_adam_ op)."""
    for p, g, m1, m2, b1, b2 in zip(params, grads, moments1, moments2,
                                    beta1_pows, beta2_pows):
        adam_(p, g, m1, m2, b1, b2, learning_rate, beta1, beta2, epsilon)
    return params


def merged_momentum_(params, grads, velocities, learning_rate, mu=0.9,
                     use_nesterov=False, name=None):
    """:func:`momentum_` over parameter lists (upstream merged_momentum_
    op)."""
    for p, g, v in zip(params, grads, velocities):
        momentum_(p, g, v, learning_rate, mu, use_nesterov)
    return params


@torch.no_grad()
def rprop_(param, grad, prev_grad, learning_rate,
           learning_rate_range=(1e-5, 50.0), etas=(0.5, 1.2), name=None):
    """Rprop (upstream rprop_ op): ``learning_rate`` is the tensor of
    per-weight step sizes, grown or shrunk by the sign agreement of
    successive gradients; returns (param, learning_rate, prev_grad)."""
    eta_n, eta_p = float(etas[0]), float(etas[1])
    lo, hi = float(learning_rate_range[0]), float(learning_rate_range[1])
    gf, pgf = _f32(grad), _f32(prev_grad)
    sign = torch.sign(gf * pgf)
    factor = torch.where(sign > 0, eta_p, torch.where(sign < 0, eta_n, 1.0))
    new_lr = torch.clamp(_f32(learning_rate) * factor, lo, hi)
    gf = torch.where(sign < 0, 0.0, gf)
    new_p = _f32(param) - torch.sign(gf) * new_lr
    return (_write(param, new_p), _write(learning_rate, new_lr),
            _write(prev_grad, gf))
