"""Optimizers (the reference's ``mxnet_tpu/optimizer.py``, whose update
arithmetic is ``mxnet_tpu/ops/optimizer_ops.py``).

The same registry (:func:`register`, :func:`create`), the same per-weight
learning-rate and weight-decay multipliers resolved by the same rules (a
multiplier keyed by the parameter's index wins over one keyed by its
name; the symbol's ``__lr_mult__``/``__wd_mult__`` attributes seed them;
:meth:`Optimizer.set_wd_mult` zeroes decay for names that end in neither
``_weight`` nor ``_gamma`` unless told otherwise), the same
``rescale_grad``/``clip_gradient`` order, ``num_update`` and the
per-index update count for schedulers and Adam's bias correction.

Updates run in place on ``torch.Tensor`` weights under ``torch.no_grad()``
(the reference returns new arrays; a copy of every parameter per step
would double the step's memory traffic).  :class:`Updater` is the
per-index closure the Module's split path and the Gluon ``Trainer`` call
with NDArrays or tensors.

The fused hooks (:meth:`Optimizer.fused_kind` and the rest) let
``Module.fit_step`` and the ``Trainer`` run SGD, SGD with momentum and Adam
as one multi-tensor update (``ops.optimizer_ops.make_fused_apply``), held
with its state, its clocks and its guard's verdict by one
:class:`FusedUpdate` each;
:func:`fused_state_from_updater`/:func:`fused_state_to_updater` carry the
state between that update and the Updater both ways.

Not ported: lazy (row-sparse) updates, which wait for sparse storage (S6).
"""
from __future__ import annotations

import math
import pickle

import torch

from .ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Test",
           "create", "get_updater", "Updater", "register",
           "fused_state_from_updater", "fused_state_to_updater",
           "FusedUpdate"]


class Optimizer:
    """Base optimizer (reference ``optimizer.py:35-183``)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) if sym \
            else ((), ())

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _sym_mults(self, key):
        attr, arg_names = self.sym_info
        return {name: float(attr[name][key]) for name in arg_names
                if name in attr and key in attr[name]}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight")
                                or n.endswith("_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        """Count one more update of ``index`` (from ``begin_num_update``)
        and advance ``num_update``; returns the index's count."""
        t = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = t
        self.num_update = max(t, self.num_update)
        return t

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        return lr * self._mult(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult(self.wd_mult, index)

    def _mult(self, mults, index):
        """The index's multiplier: keyed by index, else by its name."""
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _rescaled(self, grad):
        """``grad * rescale_grad``, clipped to ``[-c, c]`` when
        ``clip_gradient`` is a positive ``c`` (0, None or negative: no
        clipping), as the reference's updates call
        ``optimizer_ops._rescale``."""
        g = grad * self.rescale_grad
        c = self.clip_gradient
        if c and c > 0:
            g = g.clamp(-c, c)
        return g

    # -- fused train-step support -----------------------------------------
    def fused_kind(self):
        """One of ``optimizer_ops.FUSED_KINDS``, or None where the
        configuration keeps the per-parameter path."""
        return None

    def fused_hyper(self):
        """The hyperparameters the fused update closes over."""
        return {}

    def fused_mults(self, index_to_name):
        """``{name: (lr_mult, wd_mult)}`` resolved as :meth:`_get_lr` and
        :meth:`_get_wd` resolve them."""
        return {name: (self._mult(self.lr_mult, index),
                       self._mult(self.wd_mult, index))
                for index, name in index_to_name.items()}

    def make_fused_apply(self, index_to_name):
        """``(init_state, apply)`` over the named parameters, or None when
        this configuration cannot fuse."""
        kind = self.fused_kind()
        if kind is None:
            return None
        from .ops.optimizer_ops import make_fused_apply as _make
        return _make(kind, self.fused_mults(index_to_name),
                     **self.fused_hyper())

    def fused_base_lr(self):
        """The step's base lr (the scheduler's at ``num_update``); the
        fused update multiplies in each parameter's lr_mult."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return float(self.lr)


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros(weight, dtype=None):
    return torch.zeros_like(weight, dtype=dtype)


def _low_precision(weight):
    return weight.dtype in (torch.float16, torch.bfloat16)


@register
class SGD(Optimizer):
    """SGD with optional momentum (``sgd_update`` / ``sgd_mom_update``):
    ``mom = momentum * mom - lr * (g + wd * w); w += mom``.  With
    ``multi_precision`` a float16 or bfloat16 weight keeps a float32
    master copy (``mp_sgd_update`` / ``mp_sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def fused_kind(self):
        if self.multi_precision:
            return None
        return "sgd" if self.momentum == 0.0 else "sgd_mom"

    def fused_hyper(self):
        return {"momentum": self.momentum,
                "clip_gradient": self.clip_gradient}

    def create_state(self, index, weight):
        if self.multi_precision and _low_precision(weight):
            weight32 = weight.detach().to(torch.float32, copy=True)
            mom = _zeros(weight32) if self.momentum != 0.0 else None
            return (mom, weight32)
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        if isinstance(state, tuple):
            mom, weight32 = state
            step = self._rescaled(grad.to(torch.float32)) + wd * weight32
            if mom is None:
                weight32.sub_(lr * step)
            else:
                mom.mul_(self.momentum).sub_(lr * step)
                weight32.add_(mom)
            weight.copy_(weight32)
            return
        step = self._rescaled(grad) + wd * weight
        if state is None:
            weight.sub_(lr * step)
        else:
            state.mul_(self.momentum).sub_(lr * step)
            weight.add_(state)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference ``optimizer.py:234``)."""

    def fused_kind(self):
        return None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad) + wd * weight
        if state is not None:
            state.mul_(self.momentum).add_(grad)
            weight.sub_(lr * (grad + self.momentum * state))
        else:
            weight.sub_(lr * grad)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference
    ``optimizer.py:258``): ``w -= lr / 2 * (g + wd * w)`` plus normal
    noise of variance ``lr``, drawn from ``generator`` (a
    ``torch.Generator`` on the weight's device; None: torch's default)."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        noise = torch.empty_like(weight).normal_(
            0.0, math.sqrt(lr), generator=self.generator)
        weight.sub_(lr / 2 * (grad + wd * weight)).add_(noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference ``optimizer.py:276``)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        mon, previous_weight = state
        comp = grad + wd * weight + \
            self.lamda * grad * grad * (weight - previous_weight)
        if mon is not None:
            mon.mul_(self.momentum).sub_(lr * comp)
            step = mon
        else:
            step = -lr * comp
        previous_weight.copy_(weight)
        weight.add_(step)


@register
class Adam(Optimizer):
    """Adam with the reference's bias-corrected learning rate
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and ``adam_update``:
    ``g = rescaled grad + wd * w``, ``w -= lr * m / (sqrt(v) + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def fused_kind(self):
        return "adam"

    def fused_hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon,
                "clip_gradient": self.clip_gradient}

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._update_count(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        g = self._rescaled(grad) + wd * weight
        mean.mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
        var.mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
        weight.sub_(lr * mean / (var.sqrt() + self.epsilon))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference ``optimizer.py:383``)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        state.add_(grad * grad)
        weight.sub_(lr * (grad / (state + self.float_stable_eps).sqrt()
                          + wd * weight))


@register
class RMSProp(Optimizer):
    """RMSProp, Hinton's and the centered (Graves) variant (reference
    ``optimizer.py:404``): ``rmsprop_update`` / ``rmspropalex_update``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad) + wd * weight
        g1 = self.gamma1
        if not self.centered:
            (n,) = state
            n.mul_(g1).add_((1 - g1) * (grad * grad))
            weight.sub_(lr * grad / (n + self.epsilon).sqrt())
        else:
            n, g, delta = state
            n.mul_(g1).add_((1 - g1) * (grad * grad))
            g.mul_(g1).add_((1 - g1) * grad)
            delta.mul_(self.gamma2).sub_(
                lr * grad / (n - g * g + self.epsilon).sqrt())
            weight.add_(delta)
        c = self.clip_weights
        if c and c > 0:
            weight.clamp_(-c, c)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference ``optimizer.py:446``)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        acc_g, acc_delta = state
        acc_g.mul_(self.rho).add_((1.0 - self.rho) * (grad * grad))
        delta = (acc_delta + self.epsilon).sqrt() / \
            (acc_g + self.epsilon).sqrt() * grad
        acc_delta.mul_(self.rho).add_((1.0 - self.rho) * (delta * delta))
        decay = wd * weight
        weight.sub_(delta).sub_(decay)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference ``optimizer.py:476``), ``ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        z, n = state
        grad = self._rescaled(grad)
        sqrt_n = n.sqrt()
        n.add_(grad * grad)
        z.add_(grad).sub_((n.sqrt() - sqrt_n) / lr * weight)
        new_w = -(z - z.sign() * self.lamda1) / \
            ((self.beta + n.sqrt()) / lr + wd)
        weight.copy_(torch.where(z.abs() <= self.lamda1,
                                 torch.zeros_like(weight), new_w))


@register
class Adamax(Optimizer):
    """AdaMax (reference ``optimizer.py:506``): ``lr / (1 - beta1^t)``
    into ``adamax_update``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._update_count(index)
        lr /= (1.0 - self.beta1 ** t)
        m_t, u_t = state
        g = self._rescaled(grad) + wd * weight
        m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
        torch.maximum(self.beta2 * u_t, g.abs(), out=u_t)
        weight.sub_(lr * m_t / u_t)


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference ``optimizer.py:537``): the momentum
    schedule is host state, as in ``nadam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._update_count(index)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        g = self._rescaled(grad) + wd * weight
        m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
        v_t.mul_(self.beta2).add_((1.0 - self.beta2) * (g * g))
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m_t / (1.0 - m_schedule_next)
        v_prime = v_t / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        weight.sub_(lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class Test(Optimizer):
    """Test optimizer: ``w -= lr * g * rescale_grad`` (reference
    ``optimizer.py:578``)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.sub_(self.lr * grad * self.rescale_grad)


def _tensor(x):
    return x.data if isinstance(x, NDArray) else x


def _state_to(state, device):
    """A state (None, a tensor, or a tuple of them) on ``device``; loaded
    states arrive on the host."""
    if isinstance(state, tuple):
        return tuple(_state_to(s, device) for s in state)
    if isinstance(state, torch.Tensor) and state.device != device:
        return state.to(device)
    return state


def _state_to_host(state):
    if isinstance(state, tuple):
        return tuple(_state_to_host(s) for s in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    return state


class Updater:
    """The per-index update closure (reference ``optimizer.py:613``):
    ``updater(index, grad, weight)`` with NDArrays or tensors; the weight
    is updated in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        weight, grad = _tensor(weight), _tensor(grad)
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = _state_to(self.states[index], weight.device)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Restore states (onto the host; each moves to its weight's
        device at its next update); a ``(states, optimizer)`` pair also
        restores the optimizer."""
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2:
            self.states, self.optimizer = obj
        else:
            self.states = obj

    def get_states(self, dump_optimizer=False):
        """The states pickled with every tensor on the host."""
        host = {k: _state_to_host(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((host, self.optimizer))
        return pickle.dumps(host)


def get_updater(optimizer):
    return Updater(optimizer)


def fused_state_from_updater(kind, state, weight):
    """One Updater state (None before its first update) in the fused
    update's form, on the weight's device."""
    weight = _tensor(weight)
    if kind == "sgd":
        return ()
    if kind == "sgd_mom":
        return _state_to(state, weight.device) if state is not None \
            else _zeros(weight)
    if kind == "adam":
        if state is None:
            return (_zeros(weight), _zeros(weight))
        return _state_to(tuple(state), weight.device)
    raise ValueError("unknown fused kind %r" % kind)


def _zname(name, r):
    return "%s#%d" % (name, r)


def _map_state(fn, st):
    """A fused state (``()``, a tensor, or a tuple of tensors) with ``fn``
    applied to each tensor."""
    if isinstance(st, torch.Tensor):
        return fn(st)
    return tuple(_map_state(fn, s) for s in st)


def _state_leaves(st):
    if isinstance(st, torch.Tensor):
        return [st]
    return [t for s in st for t in _state_leaves(s)]


def _zero_guarded(inner, dims, replicas):
    """The guarded update over ZeRO-1 slices: each sharded parameter's
    weight and summed gradient cut along its dimension, slice r on replica
    r against state slice r, then the slices that moved to another device
    copied back into the weight."""
    n = len(replicas)

    def guarded(params, grads, state, lr, wd, rescale_grad, t, poison=0.0):
        zp, zg, zs, back = {}, {}, {}, []
        for name, w in params.items():
            d = dims.get(name)
            if d is None:
                zp[name], zg[name], zs[name] = w, grads[name], state[name]
                continue
            for r, (wr, gr) in enumerate(zip(torch.chunk(w, n, d),
                                             torch.chunk(grads[name], n, d))):
                key = _zname(name, r)
                dev = replicas[r]
                if wr.device != dev:
                    back.append((wr, key))
                    wr = wr.to(dev)
                zp[key], zg[key], zs[key] = wr, gr.to(dev), state[name][r]
        ok = inner(zp, zg, zs, lr, wd, rescale_grad, t, poison)
        with torch.no_grad():
            for dst, key in back:
                dst.copy_(zp[key])
        guarded.sync_ns = getattr(inner, "sync_ns", None)
        return ok

    return guarded


def fused_state_to_updater(kind, state):
    """A fused per-parameter state in the layout ``create_state`` makes."""
    if kind == "sgd":
        return None
    if kind == "sgd_mom":
        return state
    if kind == "adam":
        return tuple(state)
    raise ValueError("unknown fused kind %r" % kind)


class FusedUpdate:
    """The fused multi-tensor update of one optimizer and its state,
    shared by ``Module.fit_step`` and the Gluon ``Trainer``.

    ``configure(keys, params)`` (re)builds the guarded update
    (``ops.optimizer_ops.make_guarded_apply``) for ``keys`` (``{Updater
    index: name}``) over ``params`` (``{name: tensor}``) when anything it
    closes over changed: the kind, the names, multipliers,
    hyperparameters, shapes or the precision policy.  A rebuild parks the
    state in the Updater and re-seeds from it, so momentum survives.
    ``begin()`` ticks the optimizer clocks and returns the step's
    ``(lr, wd, rescale_grad, t)``; the caller runs ``guarded`` on its
    gradients; ``finish(ok)`` applies the verdict: the skip streak, the
    clock rewind of a skipped step and the loss scaler's update.  With
    ``defer_verdict`` (the Trainer) the verdict is a device scalar read
    at the next ``resolve()``, which every hand-off of state calls first;
    otherwise (the Module) it is read at once and the streak limit
    raises there.

    Over replicas (``configure(..., replicas=[devices], zero_specs=...)``,
    a context list), ZeRO-1 (``MXTPU_ZERO=1``, the reference's
    ``executor.py:151``): the state of each parameter whose spec shards a
    dimension over ``dp`` is held as N slices, slice i on replica i, and
    the update runs slice by slice: replica i updates its slice of the
    weight from its slice of the summed gradient (the reduce-scatter) and
    the slices come back into the weight (the all-gather; on one device
    the slices are views, updated in place).  The state goes to the
    Updater whole (``flush``) and comes back sliced.  The ``sharding.*``
    gauges (``opt_state_bytes_per_device``, ``collective_bytes_modeled``,
    ``collective_bytes_per_step``, ``zero_stage``) are set at each
    rebuild over replicas, as the reference sets them at each fit-step
    setup."""

    def __init__(self, optimizer, updater, defer_verdict=False):
        self.optimizer = optimizer
        self.updater = updater
        self.defer_verdict = defer_verdict
        self.precision = None       # a precision.PrecisionPolicy
        self.streak = 0             # consecutive guard skips
        self._pending = None        # a deferred verdict
        self._pre_num_update = None
        self._reset()

    def _reset(self):
        self.key = self.kind = self.state = self.guarded = None
        self.keys = {}
        self.zero = None                # ({name: dim or None}, replicas)

    @property
    def active(self):
        """True while the fused form holds the optimizer state."""
        return self.key is not None

    def configure(self, keys, params, replicas=None, zero_specs=None):
        from .ops.optimizer_ops import make_fused_apply, make_guarded_apply
        from .precision import policy_fingerprint
        opt = self.optimizer
        kind = opt.fused_kind()
        zero = None
        if zero_specs is not None and replicas is not None and \
                len(replicas) > 1:
            from .parallel.sharding import zero1_dim
            zero = ({n: zero1_dim(zero_specs.get(n)) for n in params},
                    list(replicas))
        key = (kind, tuple(keys.items()),
               tuple(sorted(opt.fused_mults(keys).items())),
               tuple(sorted(opt.fused_hyper().items())),
               tuple(tuple(p.shape) for p in params.values()),
               None if zero is None else
               (tuple(sorted(zero[0].items())), tuple(map(str, zero[1]))),
               policy_fingerprint(self.precision))
        if key == self.key:
            return
        self.flush()
        init_state, apply_fn = opt.make_fused_apply(keys)
        state = init_state(params)
        for i, name in keys.items():
            if i in self.updater.states:
                state[name] = fused_state_from_updater(
                    kind, self.updater.states[i], params[name])
        self.key, self.kind, self.keys, self.state = key, kind, \
            dict(keys), state
        if zero is None:
            self.guarded = make_guarded_apply(apply_fn, self.defer_verdict)
        else:
            dims, reps = zero
            mults = opt.fused_mults(keys)
            _, slice_apply = make_fused_apply(
                kind, {_zname(n, r): mults[n] for n, d in dims.items()
                       for r in range(len(reps)) if d is not None}
                | {n: mults[n] for n, d in dims.items() if d is None},
                **opt.fused_hyper())
            for n, d in dims.items():
                if d is not None:
                    state[n] = [_map_state(
                        lambda t, r=r, d=d: torch.chunk(t, len(reps), d)[r]
                        .to(reps[r], copy=True).contiguous(), state[n])
                        for r in range(len(reps))]
            self.guarded = _zero_guarded(
                make_guarded_apply(slice_apply, self.defer_verdict),
                dims, reps)
        self.zero = zero
        if replicas is not None and len(replicas) > 1:
            self._note_sharding(params, len(replicas))

    def _note_sharding(self, params, n):
        """The reference's ``sharding.*`` gauges for this update over ``n``
        replicas: the optimizer state a replica holds (a sharded state's
        slice, a replicated one whole), the bytes the weight update's
        collectives move a replica (ring model: reduce-scatter plus
        all-gather, or the all-reduce, 2B(n-1)/n a parameter) and the ZeRO
        stage."""
        from . import telemetry as _telemetry
        dims = self.zero[0] if self.zero is not None else {}
        state_bytes = 0
        for name, st in self.state.items():
            leaves = _state_leaves(st)
            total = sum(t.numel() * t.element_size() for t in leaves)
            state_bytes += total // n if dims.get(name) is not None \
                else total
        coll = sum(2 * p.numel() * p.element_size() * (n - 1) // n
                   for p in params.values())
        _telemetry.gauge("sharding.opt_state_bytes_per_device").set(
            state_bytes)
        _telemetry.gauge("sharding.collective_bytes_modeled").set(coll)
        _telemetry.gauge("sharding.collective_bytes_per_step").set(coll)
        _telemetry.gauge("sharding.zero_stage").set(
            1 if self.zero is not None else 0)

    def full_state(self, name):
        """``name``'s state whole (a ZeRO-1 state's slices gathered onto the
        first replica)."""
        st = self.state[name]
        d = self.zero[0].get(name) if self.zero is not None else None
        if d is None:
            return st
        first = self.zero[1][0]
        flat = [_state_leaves(s) for s in st]
        whole = [torch.cat([f[j].to(first) for f in flat], dim=d)
                 for j in range(len(flat[0]))]
        it = iter(whole)
        return _map_state(lambda t: next(it), st[0])

    def flush(self):
        """Mirror the state into the Updater (a pending verdict settled
        first), so the per-parameter path and state files continue from
        it."""
        self.resolve()
        if self.state is None:
            return
        for i, name in self.keys.items():
            self.updater.states[i] = fused_state_to_updater(
                self.kind, self.full_state(name))

    def drop(self, flush=True):
        """Leave the state to the Updater (``flush=False``: the Updater's
        states were replaced and win); the next ``configure`` re-seeds."""
        if flush:
            self.flush()
        else:
            self.resolve()
        self._reset()

    def begin(self):
        opt = self.optimizer
        self._pre_num_update = opt.num_update
        for i in self.keys:
            opt._update_count(i)
        t = float(opt._index_update_count[next(iter(self.keys))]) \
            if self.keys else 1.0
        rescale = float(opt.rescale_grad)
        scaler = getattr(self.precision, "loss_scaler", None)
        if scaler is not None:
            rescale *= scaler.unscale     # the loss was scaled by scale
        return opt.fused_base_lr(), float(opt.wd), rescale, t

    def finish(self, ok):
        verdict = (ok, list(self.keys), self._pre_num_update)
        if self.defer_verdict:
            # read at the next resolve(): reading it now would wait for
            # the device; the rewind lands before the next step's clocks
            self._pending = verdict
        else:
            self._apply(verdict, raise_on_limit=True)

    def resolve(self):
        """Apply a deferred verdict (never raises: the Trainer checks the
        limit at the top of its next step)."""
        if self._pending is not None:
            verdict, self._pending = self._pending, None
            self._apply(verdict, raise_on_limit=False)

    def _apply(self, verdict, raise_on_limit):
        from .ops.optimizer_ops import handle_guard_verdict
        ok, indices, pre_num_update = verdict
        ok = bool(ok)
        self.streak = handle_guard_verdict(
            ok, self.optimizer, indices, self.streak, pre_num_update,
            raise_on_limit=raise_on_limit,
            backfill_verdict=self.defer_verdict)
        scaler = getattr(self.precision, "loss_scaler", None)
        if scaler is not None:
            scaler.update(ok)
