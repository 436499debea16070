"""Adamax, Adadelta, NAdam, RAdam, Rprop, ASGD and LBFGS of the port
(counterpart of the reference's ``optimizer/extra.py``), each the
reference's update in per-parameter float32 torch code: the float32
master is stepped (the parameter is the master cast back), a weight
decay is folded into the gradient (``g += coeff * p``), and the
per-parameter scalars (beta powers, step counts) are numpy float32
values on the host, computed as the reference computes its float32
0-d arrays.

No class here reads a ``ParamAttr`` learning rate (the reference's do
not), so a rate other than 1 raises ``NotImplementedError``; so do
LBFGS's ``weight_decay`` and ``grad_clip``, which the reference's LBFGS
accepts and never reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adamax", "Adadelta", "NAdam", "RAdam", "Rprop", "ASGD", "LBFGS"]

_F = np.float32


def _decayed(opt, p32, grad):
    g32 = grad.float()
    coeff = opt._decay_coeff()
    if coeff:
        g32 = g32 + coeff * p32
    return g32


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment (upstream adamax.py)."""

    _accum_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("Adamax", rate=True)
        self._b1p = self._aux_scalars("amax_b1p", self._beta1)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = _decayed(self, p32, grad)
        b1 = self._beta1
        m_new = b1 * self._acc32("moment", i) + (1 - b1) * g32
        u_new = torch.maximum(self._beta2 * self._acc32("inf_norm", i),
                              torch.abs(g32))
        step = float(lr / (_F(1.0) - self._b1p[i]))
        p_new = p32 - step * m_new / (u_new + self._epsilon)
        self._b1p[i] = self._b1p[i] * _F(b1)
        self._put("moment", i, m_new)
        self._put("inf_norm", i, u_new)
        self._commit(i, p_new)


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        self._epsilon = float(epsilon)
        self._rho = float(rho)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("Adadelta", rate=True)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = _decayed(self, p32, grad)
        rho, eps = self._rho, self._epsilon
        ex = self._acc32("avg_squared_update", i)
        eg_new = rho * self._acc32("avg_squared_grad", i) \
            + (1 - rho) * g32 * g32
        update = -torch.sqrt((ex + eps) / (eg_new + eps)) * g32
        ex_new = rho * ex + (1 - rho) * update * update
        p_new = p32 + float(lr) * update
        self._put("avg_squared_grad", i, eg_new)
        self._put("avg_squared_update", i, ex_new)
        self._commit(i, p_new)


class NAdam(Optimizer):
    """Adam with Nesterov momentum (upstream nadam.py)."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._psi = float(momentum_decay)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("NAdam", rate=True)
        self._step = self._aux_scalars("nadam_step", 0.0)
        self._mu_prod = self._aux_scalars("nadam_mu_prod", 1.0)
        self._b2p = self._aux_scalars("nadam_b2p", 1.0)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = _decayed(self, p32, grad)
        t = self._step[i] + _F(1.0)
        b1, b2, psi = _F(self._beta1), _F(self._beta2), _F(self._psi)
        mu_t = b1 * (_F(1.0) - _F(0.5) * np.power(_F(0.96), t * psi))
        mu_t1 = b1 * (_F(1.0) - _F(0.5) * np.power(_F(0.96),
                                                   (t + _F(1.0)) * psi))
        mu_prod = self._mu_prod[i] * mu_t
        b2p = self._b2p[i] * b2
        m_new = self._beta1 * self._acc32("moment1", i) \
            + (1 - self._beta1) * g32
        v_new = self._beta2 * self._acc32("moment2", i) \
            + (1 - self._beta2) * g32 * g32
        m_hat = (float(mu_t1) * m_new / float(_F(1.0) - mu_prod * mu_t1)
                 + float(_F(1.0) - mu_t) * g32 / float(_F(1.0) - mu_prod))
        v_hat = v_new / float(_F(1.0) - b2p)
        p_new = p32 - float(lr) * m_hat / (torch.sqrt(v_hat) + self._epsilon)
        self._step[i], self._mu_prod[i], self._b2p[i] = t, mu_prod, b2p
        self._put("moment1", i, m_new)
        self._put("moment2", i, v_new)
        self._commit(i, p_new)


class RAdam(Optimizer):
    """Rectified Adam (upstream radam.py): SGD-like steps with bias-
    corrected momentum until the variance's rectification term exists
    (rho_t > 5), adaptive steps after."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("RAdam", rate=True)
        self._step = self._aux_scalars("radam_step", 0.0)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = _decayed(self, p32, grad)
        b1, b2 = self._beta1, self._beta2
        t = self._step[i] + _F(1.0)
        m_new = b1 * self._acc32("moment1", i) + (1 - b1) * g32
        v_new = b2 * self._acc32("moment2", i) + (1 - b2) * g32 * g32
        b1p = np.power(_F(b1), t)
        b2p = np.power(_F(b2), t)
        rho_inf = 2.0 / (1.0 - b2) - 1.0          # a Python float
        rho_t = _F(rho_inf) - _F(2.0) * t * b2p / (_F(1.0) - b2p)
        m_hat = m_new / float(_F(1.0) - b1p)
        if rho_t > _F(5.0):
            r_num = (rho_t - _F(4.0)) * (rho_t - _F(2.0)) * _F(rho_inf)
            r_den = _F((rho_inf - 4.0) * (rho_inf - 2.0)) * rho_t
            rect = np.sqrt(np.maximum(r_num, _F(1e-30))
                           / np.maximum(r_den, _F(1e-30)))
            v_hat = torch.sqrt(v_new / float(_F(1.0) - b2p)) + self._epsilon
            p_new = p32 - float(lr * rect) * m_hat / v_hat
        else:
            p_new = p32 - float(lr) * m_hat
        self._step[i] = t
        self._put("moment1", i, m_new)
        self._put("moment2", i, v_new)
        self._commit(i, p_new)


class Rprop(Optimizer):
    """Resilient backprop (upstream rprop.py): full-batch sign-based
    steps with a step size a weight, grown or shrunk by the sign
    agreement of successive gradients."""

    _accum_names = ("prev_grad", "learning_rate_local")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, name=None):
        self._lr_range = (float(learning_rate_range[0]),
                          float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))
        self._init_lr = float(learning_rate)
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name, multi_precision)
        self._refuse_ignored("Rprop", rate=True)
        self._seeded = set()

    def _step_sizes(self, i):
        """The step sizes of parameter i, seeded with the learning rate
        on their first use only from the blank (all-zero) state: a
        restored state is strictly positive and keeps its values."""
        acc = self._accums["learning_rate_local"][i]
        if i not in self._seeded:
            if not bool(torch.any(acc != 0)):
                acc.fill_(self._init_lr)
            self._seeded.add(i)
        return acc

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = grad.float()
        eta_minus, eta_plus = self._etas
        lo, hi = self._lr_range
        sign = torch.sign(g32 * self._acc32("prev_grad", i))
        factor = torch.where(
            sign > 0, eta_plus, torch.where(sign < 0, eta_minus, 1.0))
        lr_new = torch.clamp(self._step_sizes(i).float() * factor, lo, hi)
        g_eff = torch.where(sign < 0, 0.0, g32)
        p_new = p32 - lr_new * torch.sign(g_eff)
        self._put("prev_grad", i, g_eff)
        self._put("learning_rate_local", i, lr_new)
        self._commit(i, p_new)


class ASGD(Optimizer):
    """Averaged SGD (upstream asgd.py): the direction is the running sum
    of the last ``batch_num`` gradients, ``d <- d - y + g; p -= lr * d /
    n; y <- g`` with ``n`` ramping up to ``batch_num``, and a running
    average of the iterates (:meth:`averaged_params`). The step count
    is not part of the ``state_dict``, as in the reference."""

    _accum_names = ("averaged_param", "asgd_d", "asgd_y")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        self._t = 0
        self._batch_num = max(int(batch_num), 1)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("ASGD", rate=True)

    def step(self):
        self._t += 1
        super().step()

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = _decayed(self, p32, grad)
        n = float(min(self._t, self._batch_num))
        d_new = self._acc32("asgd_d", i) - self._acc32("asgd_y", i) + g32
        p_new = p32 - float(lr) * d_new / n
        t = float(self._t)
        avg = self._acc32("averaged_param", i) * ((t - 1.0) / t) + p_new / t
        self._put("averaged_param", i, avg)
        self._put("asgd_d", i, d_new)
        self._put("asgd_y", i, g32)
        self._commit(i, p_new)

    def averaged_params(self):
        """``{name: the running average of the parameter's iterates}``."""
        return dict(zip(self._names, self._accums["averaged_param"]))


def _scalar(loss):
    return float(loss.detach()) if isinstance(loss, torch.Tensor) \
        else float(loss)


def _dot(a, b):
    return float(torch.dot(a, b))


class LBFGS(Optimizer):
    """Limited-memory BFGS with the two-loop recursion (upstream
    lbfgs.py). ``step(closure)`` re-evaluates the loss and the gradients
    (the closure runs the forward and the backward and returns the
    loss) as the line search probes new points. The flat vectors are
    float32 over every parameter, on the parameters' device; the
    parameters themselves are read and written (a master is kept and
    never read, as in the reference)."""

    _accum_names = ()

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._refuse_ignored("LBFGS", rate=True, decay=True, clip=True)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(f"LBFGS: unknown line_search_fn "
                             f"{line_search_fn!r}")
        self._lr0 = float(learning_rate)
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist = history_size
        self._line_search = line_search_fn
        self._s, self._y = [], []

    # -- flat views --------------------------------------------------------
    def _gather_flat_grad(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .float().reshape(-1) for p in self._parameter_list])

    def _gather_flat_params(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._parameter_list])

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape))
            off += n

    def _directional_evaluate(self, closure, x, t, d):
        self._set_flat_params(x + t * d)
        with torch.enable_grad():
            lval = _scalar(closure())
        return lval, self._gather_flat_grad()

    def step(self, closure=None):
        """One LBFGS step of up to ``max_iter`` iterations; returns the
        closure's first loss."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        with torch.enable_grad():
            loss = closure()
        lval = _scalar(loss)
        flat_grad = self._gather_flat_grad()
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return loss
        n_evals = 1
        for _ in range(self._max_iter):
            # two-loop recursion
            q = flat_grad
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / _dot(y, s)
                a = rho * _dot(s, q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y:
                y_last, s_last = self._y[-1], self._s[-1]
                q = q * (_dot(s_last, y_last) / _dot(y_last, y_last))
            for a, rho, s, y in reversed(alphas):
                b = rho * _dot(y, q)
                q = q + s * (a - b)
            d = -q
            gtd = _dot(flat_grad, d)
            if gtd > -1e-32:
                break
            x0 = self._gather_flat_params()
            t = self._lr0 if self._s else min(
                1.0, 1.0 / float(flat_grad.abs().sum())) * self._lr0
            if self._line_search == "strong_wolfe":
                def evaluate(tt, _x0=x0, _d=d):
                    return self._directional_evaluate(closure, _x0, tt, _d)

                evaluate.gtd = lambda g, _d=d: _dot(g, _d)
                t, lval, flat_grad_new, evals = _strong_wolfe(
                    evaluate, lval, gtd, t)
                n_evals += evals
                self._set_flat_params(x0 + t * d)
            else:
                self._set_flat_params(x0 + t * d)
                with torch.enable_grad():
                    lval = _scalar(closure())
                flat_grad_new = self._gather_flat_grad()
                n_evals += 1
            s_vec = t * d
            y_vec = flat_grad_new - flat_grad
            if _dot(s_vec, y_vec) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self._hist:
                    self._s.pop(0)
                    self._y.pop(0)
            delta = float(s_vec.abs().max())
            flat_grad = flat_grad_new
            if (float(flat_grad.abs().max()) <= self._tol_grad
                    or delta <= self._tol_change
                    or n_evals >= self._max_eval):
                break
        return loss


def _strong_wolfe(evaluate, f0, gtd0, t, c1=1e-4, c2=0.9, max_evals=25):
    """Strong-Wolfe line search: bracket, then bisection zoom (upstream
    lbfgs.py ``_strong_wolfe``). ``evaluate(t)`` returns ``(f,
    flat_grad)``; ``evaluate.gtd(g)`` the directional derivative along
    the caller's direction. Returns ``(t, f, flat_grad, evals)``."""
    gtd = evaluate.gtd
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f0, None, gtd0
    evals = 0
    bracket = None
    for _ in range(max_evals):
        f_t, g_t = evaluate(t)
        evals += 1
        gtd_t = gtd(g_t)
        if f_t > f0 + c1 * t * gtd0 or (evals > 1 and f_t >= f_prev):
            bracket = (t_prev, f_prev, g_prev, gtd_prev,
                       t, f_t, g_t, gtd_t)
            break
        if abs(gtd_t) <= -c2 * gtd0:
            return t, f_t, g_t, evals
        if gtd_t >= 0:
            bracket = (t, f_t, g_t, gtd_t,
                       t_prev, f_prev, g_prev, gtd_prev)
            break
        t_prev, f_prev, g_prev, gtd_prev = t, f_t, g_t, gtd_t
        t = t * 2.0
    if bracket is None:
        return t, f_t, g_t, evals
    lo_t, lo_f, lo_g, lo_gtd, hi_t, hi_f, hi_g, hi_gtd = bracket
    if lo_g is None:
        lo_f, lo_g = evaluate(lo_t)
        evals += 1
        lo_gtd = gtd(lo_g)
    for _ in range(max_evals - evals):
        t = 0.5 * (lo_t + hi_t)
        f_t, g_t = evaluate(t)
        evals += 1
        gtd_t = gtd(g_t)
        if f_t > f0 + c1 * t * gtd0 or f_t >= lo_f:
            hi_t, hi_f, hi_g, hi_gtd = t, f_t, g_t, gtd_t
        else:
            if abs(gtd_t) <= -c2 * gtd0:
                return t, f_t, g_t, evals
            if gtd_t * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g, hi_gtd = lo_t, lo_f, lo_g, lo_gtd
            lo_t, lo_f, lo_g, lo_gtd = t, f_t, g_t, gtd_t
        if abs(hi_t - lo_t) < 1e-9:
            break
    return lo_t, lo_f, lo_g, evals
