"""The port's autograd tape against ``mxnet_tpu.autograd`` on the same numpy
inputs: ``grad_req`` write and add, ``retain_graph``, ``grad()``, head
gradients, nothing recorded outside ``record()``, the ``SoftmaxOutput``
head's implicit gradient, ``mark_variables`` and the switches.

Tolerance: gradients within 1e-6 absolute plus 1e-6 relative (the same
float32 arithmetic, summed in another order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = 1e-6


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


X = _rand((3, 4), 0)
W = _rand((2, 4), 1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=tol,
                               atol=tol)


def _both(fn):
    """``fn(mx, ctx_kwargs)`` in both packages; returns (port, jax)."""
    return fn(tmx, {"ctx": CPU}), fn(jmx, {})


def _loss(mx, x, w):
    """A small recorded function of both leaves: sum(tanh(x . w)^2)."""
    h = mx.nd.tanh(mx.nd.FullyConnected(x, w, no_bias=True, num_hidden=2,
                                        flatten=False))
    return (h * h).sum()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_replaces_and_add_accumulates(req):
    def run(mx, c):
        x, w = mx.nd.array(X, **c), mx.nd.array(W, **c)
        x.attach_grad(req)
        w.attach_grad(req)
        seen = []
        for scale in (1.0, 3.0):
            with mx.autograd.record():
                loss = _loss(mx, x * scale, w)
            loss.backward()
            seen.append((x.grad.copy(), w.grad.copy()))
        return seen
    port, ref = _both(run)
    for (tx, tw), (jx, jw) in zip(port, ref):
        _close(tx, jx)
        _close(tw, jw)
    if req == "write":
        assert not np.allclose(port[0][0].asnumpy(), port[1][0].asnumpy())


def test_torch_grad_buffers_stay_clear():
    """``.grad`` is MXNet's buffer, and the leaf's own torch ``.grad`` is
    that same buffer (one gradient home); ``backward`` writes it, so
    nothing accumulates behind the buffer's back over two backwards."""
    x = tmx.nd.array(X, ctx=CPU)
    x.attach_grad()
    for _ in range(2):
        with tmx.autograd.record():
            loss = (x * x).sum()
        loss.backward()
        assert x.data.grad is x.grad.data
    _close(x.grad, jmx.nd.array(2 * X))


def test_retain_graph():
    def run(mx, c):
        x = mx.nd.array(X, **c)
        x.attach_grad("add")
        with mx.autograd.record():
            loss = (x * x * x).sum()
        loss.backward(retain_graph=True)
        loss.backward(retain_graph=True)
        return x.grad
    port, ref = _both(run)
    _close(port, ref)
    _close(port, jmx.nd.array(6 * X * X))


def test_backward_after_the_graph_was_freed_raises():
    """``retain_graph=False`` frees torch's graph; the reference keeps its
    tape nodes reachable from the head and would run them again."""
    x = tmx.nd.array(X, ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        loss = (x * x * x).sum()
    loss.backward()
    with pytest.raises(tmx.MXNetError, match="retain_graph"):
        loss.backward()


def test_grad_returns_gradients_and_touches_no_buffer():
    def run(mx, c):
        x, w = mx.nd.array(X, **c), mx.nd.array(W, **c)
        x.attach_grad()
        w.attach_grad()
        with mx.autograd.record():
            loss = _loss(mx, x, w)
        gx, gw = mx.autograd.grad(loss, [x, w], retain_graph=True)
        return gx, gw, x.grad, w.grad
    port, ref = _both(run)
    for t, j in zip(port[:2], ref[:2]):
        _close(t, j)
    for t, j in zip(port[2:], ref[2:]):
        assert not t.asnumpy().any() and not j.asnumpy().any()


@pytest.mark.parametrize("head", ["ones", "given"])
def test_head_gradients(head):
    hg = _rand((3, 4), 5)

    def run(mx, c):
        x = mx.nd.array(X, **c)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.sigmoid(x) * 2.0
        y.backward(mx.nd.array(hg, **c) if head == "given" else None)
        return x.grad
    port, ref = _both(run)
    _close(port, ref)


def test_multiple_heads():
    def run(mx, c):
        x = mx.nd.array(X, **c)
        x.attach_grad()
        with mx.autograd.record():
            a, b = (x * x).sum(), mx.nd.exp(x).sum()
        mx.autograd.backward([a, b])
        return x.grad
    port, ref = _both(run)
    _close(port, ref)


def test_nothing_recorded_outside_record():
    def run(mx, c):
        x = mx.nd.array(X, **c)
        x.attach_grad()
        y = (x * x).sum()                 # outside record(): not taped
        y.backward()
        with mx.autograd.record():
            with mx.autograd.pause():
                z = (x * 3.0).sum()       # paused: not taped either
        z.backward()
        return x.grad
    port, ref = _both(run)
    assert not port.asnumpy().any() and not ref.asnumpy().any()


@pytest.mark.parametrize("params", [{}, {"normalization": "batch"},
                                    {"grad_scale": 2.0, "use_ignore": True,
                                     "ignore_label": 1.0}])
def test_softmax_output_head_ignores_the_head_gradient(params):
    label = np.array([0.0, 1.0, 3.0], np.float32)

    def run(mx, c):
        x, lbl = mx.nd.array(X, **c), mx.nd.array(label, **c)
        x.attach_grad()
        grads = []
        for hg in (None, mx.nd.array(_rand((3, 4), 6), **c)):
            with mx.autograd.record():
                p = mx.nd.SoftmaxOutput(x, lbl, **params)
            p.backward(hg)
            grads.append(x.grad.copy())
        return p, grads
    (tp, tg), (jp, jg) = _both(run)
    _close(tp, jp)
    for t, j in zip(tg, jg):
        _close(t, j)
    _close(tg[0], tg[1], 0)


def test_mark_variables_with_buffers_and_reqs():
    def run(mx, c):
        x, w = mx.nd.array(X, **c), mx.nd.array(W, **c)
        gx, gw = mx.nd.ones((3, 4), **c), mx.nd.zeros((2, 4), **c)
        mx.autograd.mark_variables([x, w], [gx, gw], ["add", "write"])
        with mx.autograd.record():
            loss = _loss(mx, x, w)
        loss.backward()
        return gx, gw, x.grad is gx
    (tx, tw, tsame), (jx, jw, jsame) = _both(run)
    _close(tx, jx)
    _close(tw, jw)
    assert tsame and jsame


def test_a_recorded_array_marked_becomes_a_leaf():
    def run(mx, c):
        x = mx.nd.array(X, **c)
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2.0
            y.attach_grad()
            loss = (y * y).sum()
        loss.backward()
        return x.grad, y.grad
    (tx, ty), (jx, jy) = _both(run)
    _close(ty, jy)
    _close(tx, jx)
    assert not tx.asnumpy().any()


def test_switches():
    for mx in (tmx, jmx):
        ag = mx.autograd
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.predict_mode():
                assert not ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_set_recording_records_nd_ops():
    x = tmx.nd.array(X, ctx=CPU)
    x.attach_grad()
    prev = tmx.autograd.set_recording(True)
    try:
        loss = (x * x).sum()
    finally:
        tmx.autograd.set_recording(prev)
    loss.backward()
    _close(x.grad, jmx.nd.array(2 * X))


def test_writes_to_a_marked_leaf():
    """``w[:] = ...``, ``_set_data`` and ``out=`` keep a marked array a
    leaf that requires grad, inside and outside ``record()``."""
    w = tmx.nd.array(W, ctx=CPU)
    w.attach_grad()
    with tmx.autograd.record():
        w[:] = w * 0.5
    assert w.data.is_leaf and w.data.requires_grad
    w._set_data(torch.ones(2, 4))
    assert w.data.is_leaf and w.data.requires_grad
    tmx.nd.sgd_update(w, tmx.nd.ones((2, 4), ctx=CPU), out=w, lr=0.5)
    assert w.data.is_leaf and w.data.requires_grad
    np.testing.assert_allclose(w.asnumpy(), 0.5)
    with tmx.autograd.record():
        loss = (w * w).sum()
    loss.backward()
    np.testing.assert_allclose(w.grad.asnumpy(), 1.0)
    d = w.detach()
    assert not d.data.requires_grad and d.grad is None


def test_views_record_where_the_reference_does_not():
    """``x.T``, ``x[key]`` and ``nd.moveaxis`` are torch ops here and are
    recorded inside ``record()``; the reference computes them outside its
    tape (no gradient reaches ``x`` through them).  The port's gradient
    through them equals the reference's through the registered ops that
    compute the same (``transpose``, ``slice_axis``)."""
    def run(mx, c, views):
        x = mx.nd.array(X, **c)
        x.attach_grad()
        with mx.autograd.record():
            if views:
                y = (x.T * 2.0).sum() + (x[1:3] ** 2).sum() + \
                    (mx.nd.moveaxis(x, 0, 1) * 3.0).sum()
            else:
                y = (mx.nd.transpose(x) * 2.0).sum() + \
                    (mx.nd.slice_axis(x, axis=0, begin=1, end=3) ** 2
                     ).sum() + (mx.nd.transpose(x) * 3.0).sum()
        y.backward()
        return x.grad
    _close(run(tmx, {"ctx": CPU}, True), run(jmx, {}, False))
    assert not run(jmx, {}, True).asnumpy().any()
