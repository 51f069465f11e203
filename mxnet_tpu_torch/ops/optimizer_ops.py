"""Optimizer update operators (counterpart of the registered per-op update
bodies of ``mxnet_tpu/ops/optimizer_ops.py``).

Each is a pure function returning the *new* values (weight, then the new
states); ``nd.<op>(..., out=w)`` writes the first into ``w`` (the
imperative invoke writes ``out=`` only after the op has computed, so an
output may alias an input).  Semantics follow the reference exactly:
``rescale_grad``, then ``clip_gradient``, then ``wd``, in the same update
order, so convergence curves are comparable.

The reference keeps ``lr``/``wd``/``rescale_grad`` as traced arguments so
one compiled program serves every value; here the ops run eagerly, so a
new value never compiles anything.

The tree-wide update of the fused train step (:func:`make_fused_apply`)
and its divergence guard (:func:`make_guarded_apply`) follow the
reference's ``make_fused_apply``/``make_guarded_apply``: the reference
maps one rule over the parameter tree inside one jitted program, and here
the torch meaning is one multi-tensor update, ``torch._foreach_*`` over
the parameter list, with the same arithmetic as the per-parameter
optimizers of :mod:`mxnet_tpu_torch.optimizer`, op for op.  The ZeRO-1
stage (sharded optimizer state) belongs to the multi-device slice.
"""
from __future__ import annotations

import math
import os

import torch

from .registry import register_op


def _rescale(grad, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    return grad


def _live_rows(grad):
    """Rows the gradient touches (any nonzero), broadcastable over the
    weight: the reference's lazy-update predicate."""
    live = torch.any(grad.reshape(grad.shape[0], -1) != 0, dim=1)
    return live.reshape((-1,) + (1,) * (grad.dim() - 1))


@register_op("sgd_update", arg_names=("weight", "grad"),
             param_defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0, "lazy_update": False})
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=False):
    g = _rescale(grad, rescale_grad, clip_gradient)
    new_w = weight - lr * (g + wd * weight)
    if lazy_update:
        # rows absent from the gradient stay untouched, weight decay too
        return torch.where(_live_rows(grad), new_w, weight)
    return new_w


@register_op("sgd_mom_update", arg_names=("weight", "grad", "mom"),
             num_outputs=2,
             param_defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                             "rescale_grad": 1.0, "clip_gradient": -1.0,
                             "lazy_update": False})
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    g = _rescale(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    if lazy_update:
        live = _live_rows(grad)
        new_mom = torch.where(live, new_mom, mom)
        return torch.where(live, weight + new_mom, weight), new_mom
    return weight + new_mom, new_mom


@register_op("mp_sgd_update", arg_names=("weight", "grad", "weight32"),
             num_outputs=2,
             param_defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0})
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    # low-precision weights with an fp32 master copy
    grad = _rescale(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (grad + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register_op("mp_sgd_mom_update",
             arg_names=("weight", "grad", "mom", "weight32"), num_outputs=3,
             param_defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                             "rescale_grad": 1.0, "clip_gradient": -1.0})
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    grad = _rescale(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (grad + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register_op("adam_update", arg_names=("weight", "grad", "mean", "var"),
             num_outputs=3,
             param_defaults={"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                             "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0, "lazy_update": False})
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=False):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_weight = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    if lazy_update:
        live = _live_rows(grad)
        return (torch.where(live, new_weight, weight),
                torch.where(live, new_mean, mean),
                torch.where(live, new_var, var))
    return new_weight, new_mean, new_var


# -- tree-wide fused apply ---------------------------------------------------

FUSED_KINDS = ("sgd", "sgd_mom", "adam")


def make_fused_apply(kind, mults, momentum=0.0, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, clip_gradient=None):
    """Build ``(init_state, apply)`` for a tree-wide optimizer update.

    ``kind``  -- one of :data:`FUSED_KINDS`.
    ``mults`` -- ``{name: (lr_mult, wd_mult)}``; a missing name is (1, 1).

    ``init_state(params) -> {name: state}`` (``()``, the momentum, or
    Adam's ``(mean, var)``, zeros like the parameter).
    ``apply(params, grads, state, lr, wd, rescale_grad, t, inplace=False)
    -> (new_params, new_state)``: with ``inplace`` the parameter and state
    tensors are updated and returned; otherwise the new values go into
    fresh tensors and the inputs stay as they are.  ``t`` is the 1-based
    update count of Adam's bias correction, ``lr * sqrt(1 - beta2^t) /
    (1 - beta1^t)``.  The arithmetic is the per-parameter optimizers'
    (``rescale_grad``, then clipping to ``[-c, c]`` when ``clip_gradient``
    is positive, then ``+ wd * w``), each step one ``torch._foreach_*``
    call over the list."""
    if kind not in FUSED_KINDS:
        raise ValueError("unsupported fused optimizer kind %r (want one of "
                         "%s)" % (kind, list(FUSED_KINDS)))
    mults = {k: (float(lm), float(wm)) for k, (lm, wm) in mults.items()}
    clip = float(clip_gradient) if clip_gradient is not None and \
        clip_gradient > 0 else None

    def init_state(params):
        if kind == "sgd":
            return {name: () for name in params}
        if kind == "sgd_mom":
            return {name: torch.zeros_like(w) for name, w in params.items()}
        return {name: (torch.zeros_like(w), torch.zeros_like(w))
                for name, w in params.items()}

    @torch.no_grad()
    def apply(params, grads, state, lr, wd, rescale_grad, t, inplace=False):
        def upd(op, xs, *args, **kw):
            # the first write to a parameter or a state: in place, or into
            # a fresh list
            if inplace:
                getattr(torch, "_foreach_%s_" % op)(xs, *args, **kw)
                return xs
            return getattr(torch, "_foreach_%s" % op)(xs, *args, **kw)

        names = list(params)
        if not names:
            return {}, {}
        ws = [params[n] for n in names]
        lrs = [lr * mults.get(n, (1.0, 1.0))[0] for n in names]
        if kind == "adam":
            # the per-parameter Adam's order: (lr * lr_mult) * correction
            coef = math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
            lrs = [x * coef for x in lrs]
        wds = [wd * mults.get(n, (1.0, 1.0))[1] for n in names]
        g = torch._foreach_mul([grads[n] for n in names], rescale_grad)
        if clip is not None:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        torch._foreach_add_(g, torch._foreach_mul(ws, wds))
        if kind == "sgd":
            new_w = upd("sub", ws, torch._foreach_mul(g, lrs))
            return dict(zip(names, new_w)), {n: () for n in names}
        if kind == "sgd_mom":
            new_m = upd("mul", [state[n] for n in names], momentum)
            torch._foreach_sub_(new_m, torch._foreach_mul(g, lrs))
            new_w = upd("add", ws, new_m)
            return dict(zip(names, new_w)), dict(zip(names, new_m))
        mean = upd("mul", [state[n][0] for n in names], beta1)
        torch._foreach_add_(mean, g, alpha=1.0 - beta1)
        var = upd("mul", [state[n][1] for n in names], beta2)
        torch._foreach_addcmul_(var, g, g, value=1.0 - beta2)
        denom = torch._foreach_sqrt(var)
        torch._foreach_add_(denom, epsilon)
        step = torch._foreach_mul(mean, lrs)
        torch._foreach_div_(step, denom)
        new_w = upd("sub", ws, step)
        return dict(zip(names, new_w)), \
            {n: (m, v) for n, m, v in zip(names, mean, var)}

    return init_state, apply


# -- divergence guard --------------------------------------------------------
#
# One batch with a non-finite gradient must not drive the parameters to NaN.
# The guard checks the whole gradient list on the device and, when any value
# is NaN or Inf, turns the update into a no-op for every parameter and every
# optimizer state.  Where the caller reads the verdict at once, the update
# runs only after the check; where it reads it a step late, the update
# runs into temporaries and a select on the device keeps the old values,
# so the step never waits for the host.

def all_finite(tensors):
    """0-dim bool tensor: every tensor of the list is entirely finite.  One
    multi-tensor reduction (each tensor's max |x|, NaN if it holds one)."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(True)
    norms = torch._foreach_norm(tensors, float("inf"))
    # one dtype to stack (a no-op for float32 norms)
    return torch.isfinite(torch.stack([n.float() for n in norms])).all()


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _flat_leaves(values):
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(_flat_leaves(v))
    return out


@torch.no_grad()
def select_(olds, news, ok):
    """``olds[i] <- news[i] if ok else olds[i]``, in place and bit for bit.

    A select, not a product: NaN * 0 is NaN, so blending floats would let a
    skipped step's NaN through.  The blend runs on the tensors' bits as
    integers instead (same element size), where ``bits * 0`` is 0 whatever
    the float was: ``old * (1 - ok) + new * ok`` with one term exactly 0.
    Three multi-tensor calls for each element size."""
    by_size = {}
    for o, n in zip(olds, news):
        by_size.setdefault(o.element_size(), []).append((o, n))
    for size, pairs in by_size.items():
        itype = _INT_OF_SIZE[size]
        keep_new = ok.to(itype)
        keep_old = (~ok).to(itype)
        o_bits = [o.view(itype) for o, _ in pairs]
        n_bits = [n.view(itype) for _, n in pairs]
        torch._foreach_mul_(n_bits, keep_new)
        torch._foreach_mul_(o_bits, keep_old)
        torch._foreach_add_(o_bits, n_bits)


def make_guarded_apply(apply_fn, defer_verdict=False):
    """Wrap a tree-wide ``apply`` (from :func:`make_fused_apply`) with the
    divergence guard.

    Returns ``guarded(params, grads, state, lr, wd, rescale_grad, t,
    poison=0.0) -> ok``: ``params`` and ``state`` are updated in place
    when every gradient (plus ``poison``) is finite; otherwise both stay
    bit for bit as they were.  ``poison`` is added to every gradient: 0.0
    in training, NaN when a test drives the skip through the same code.

    Two forms, for the two ways the verdict is read:

    - ``defer_verdict=False`` (``Module.fit_step``, which reads the verdict
      at once): the check, one host sync, then the update in place when
      it passed.  ``ok`` is a Python bool.
    - ``defer_verdict=True`` (the Gluon ``Trainer``, which reads it one
      step late so that ``step`` never waits for the device): the update
      goes into temporaries and :func:`select_` keeps the old or takes the
      new values on the device.  ``ok`` is a 0-dim bool tensor."""
    @torch.no_grad()
    def guarded(params, grads, state, lr, wd, rescale_grad, t, poison=0.0):
        if poison != 0.0:
            grads = {n: g + poison for n, g in grads.items()}
        ok = all_finite(grads.values())
        if not defer_verdict:
            ok = bool(ok)
            if ok:
                apply_fn(params, grads, state, lr, wd, rescale_grad, t,
                         inplace=True)
            return ok
        new_params, new_state = apply_fn(params, grads, state, lr, wd,
                                         rescale_grad, t)
        names = list(new_params)
        select_([params[n] for n in names], [new_params[n] for n in names],
                ok)
        select_(_flat_leaves(state[n] for n in names),
                _flat_leaves(new_state[n] for n in names), ok)
        return ok

    return guarded


def max_consecutive_skips():
    """K of the graceful-degradation contract: after K consecutive
    guard-skipped steps the training loop raises ``MXNetError`` instead of
    looping on a divergent configuration (``MXTPU_MAX_CONSECUTIVE_SKIPS``,
    default 100)."""
    return int(os.environ.get("MXTPU_MAX_CONSECUTIVE_SKIPS", "100"))


def raise_skip_limit_error(limit):
    from ..base import MXNetError
    raise MXNetError(
        "divergence guard: %d consecutive steps produced non-finite "
        "gradients -- training cannot progress (lower the learning "
        "rate, check the data pipeline, or raise "
        "MXTPU_MAX_CONSECUTIVE_SKIPS)" % limit)


def handle_guard_verdict(ok, optimizer, indices, streak, pre_num_update,
                         raise_on_limit=True):
    """Host bookkeeping after a guarded update, shared by
    ``Module.fit_step`` and the Gluon ``Trainer``.

    On a skipped step the optimizer clocks rewind, so the batch is as if
    it never arrived: ``_index_update_count`` (Adam's t) for every updated
    index and ``num_update`` (the scheduler's clock, captured by the
    caller before its ``_update_count`` calls).  Returns the new
    consecutive-skip streak; with ``raise_on_limit`` it raises
    ``MXNetError`` at :func:`max_consecutive_skips` (the Trainer, which
    resolves its verdicts one step late, checks the limit at the top of
    its next step instead)."""
    if bool(ok):
        return 0
    for i in indices:
        optimizer._index_update_count[i] -= 1
    optimizer.num_update = pre_num_update
    streak += 1
    limit = max_consecutive_skips()
    if raise_on_limit and streak >= limit:
        raise_skip_limit_error(limit)
    return streak


def _clip_weights(weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(weight, -clip_weights, clip_weights)
    return weight


@register_op("rmsprop_update", arg_names=("weight", "grad", "n"),
             num_outputs=2,
             param_defaults={"lr": 0.001, "gamma1": 0.95, "epsilon": 1e-8,
                             "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0, "clip_weights": -1.0})
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(grad) + gamma1 * n
    new_weight = weight - lr * grad / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_weight, clip_weights), new_n


@register_op("rmspropalex_update",
             arg_names=("weight", "grad", "n", "g", "delta"), num_outputs=4,
             param_defaults={"lr": 0.001, "gamma1": 0.95, "gamma2": 0.9,
                             "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0, "clip_weights": -1.0})
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(grad) + gamma1 * n
    new_g = (1 - gamma1) * grad + gamma1 * g
    new_delta = gamma2 * delta - lr * grad / \
        torch.sqrt(new_n - torch.square(new_g) + epsilon)
    new_weight = weight + new_delta
    return _clip_weights(new_weight, clip_weights), new_n, new_g, new_delta


@register_op("ftrl_update", arg_names=("weight", "grad", "z", "n"),
             num_outputs=3,
             param_defaults={"lr": 0.1, "lamda1": 0.01, "beta": 1.0,
                             "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0})
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(grad)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + grad - sigma * weight
    new_weight = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1) /
        ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_weight, new_z, new_n


@register_op("adamax_update", arg_names=("weight", "grad", "m", "u"),
             num_outputs=3,
             param_defaults={"lr": 0.002, "beta1": 0.9, "beta2": 0.999,
                             "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0})
def _adamax_update(weight, grad, m, u, lr=0.002, beta1=0.9, beta2=0.999,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    # ``lr`` arrives bias-corrected (lr / (1 - beta1^t)), as adam_update's
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    new_m = beta1 * m + (1.0 - beta1) * g
    new_u = torch.maximum(beta2 * u, torch.abs(g))
    return weight - lr * new_m / new_u, new_m, new_u


@register_op("nadam_update", arg_names=("weight", "grad", "m", "v"),
             num_outputs=3,
             param_defaults={"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                             "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                             "clip_gradient": -1.0, "momentum_t": 0.9,
                             "momentum_t_1": 0.9, "m_schedule": 0.9,
                             "m_schedule_next": 0.81, "coef2": 1.0})
def _nadam_update(weight, grad, m, v, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  momentum_t=0.9, momentum_t_1=0.9, m_schedule=0.9,
                  m_schedule_next=0.81, coef2=1.0):
    # Nesterov Adam; the momentum schedule and 1 - beta2^t come from the
    # host as scalars
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    new_m = beta1 * m + (1.0 - beta1) * g
    new_v = beta2 * v + (1.0 - beta2) * torch.square(g)
    g_prime = g / (1.0 - m_schedule)
    m_prime = new_m / (1.0 - m_schedule_next)
    v_prime = new_v / coef2
    m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
    return (weight - lr * m_bar / (torch.sqrt(v_prime) + epsilon),
            new_m, new_v)
