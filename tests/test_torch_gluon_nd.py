"""The port's Gluon on ``mx.nd`` against the JAX package's, in process, on
the same numpy inputs and weights: the faults C7-C10, every layer of
``gluon/nn/basic_layers.py`` eager and hybridized (deferred shapes
included), every loss, ``Parameter``/``ParameterDict``, ``SymbolBlock``,
``functionalize`` and ``mx.random``.

Tolerances: float32 on both sides, sums in another order: outputs and
gradients 1e-5 absolute plus 1e-5 relative (a FlashSelfAttention output,
an online softmax against the reference's plain one on the CPU: 1e-5 as
well); names, shapes, NaN positions and integer results exactly.
Dropout draws from the port's own generator (torch cannot replay
threefry), so it is held by distribution: the kept share within 0.02 of
``1 - p`` over 40,000 draws (about 8 standard deviations) and the kept
values scaled by exactly ``1 / (1 - p)``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import nn as tnn

CPU = tmx.cpu()
TOL = 1e-5


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _tnd(a, **kw):
    return tmx.nd.array(a, ctx=CPU, **kw)


def _close(got, want, tol=TOL):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _sync(theirs, ours, seed):
    """The same random values into both blocks' parameters, matched by
    name (gamma and running variances kept positive)."""
    rng = np.random.RandomState(seed)
    tp = ours.collect_params()
    for name, jp in theirs.collect_params().items():
        a = rng.uniform(-1, 1, jp.shape).astype(np.float32)
        if name.endswith(("_gamma", "_var")):
            a = np.abs(a) + 0.5
        jp.set_data(jmx.nd.array(a))
        tp[name].set_data(a)


# -- C7-C10 -------------------------------------------------------------------

def test_c7_cpu_and_gpu_are_contexts():
    """``mx.cpu()``/``mx.gpu(i)`` are Contexts with the reference's
    observable values, accepted wherever a device is."""
    for mx in (tmx, jmx):
        assert mx.cpu().device_type == "cpu"
        assert str(mx.cpu()) == "cpu(0)"
        assert str(mx.gpu(1)) == "gpu(1)"
        assert str(mx.nd.array(np.arange(3.0), ctx=mx.cpu()).context) \
            == "cpu(0)"
    assert isinstance(tmx.gpu(0), tmx.Context)
    assert tmx.context.resolve_device(tmx.cpu()) == torch.device("cpu")
    x = _tnd(np.arange(3.0))
    assert x.context == tmx.cpu() and x.as_in_context(tmx.cpu()) is x


def test_c7_with_cpu_scope_places_entry_points_on_the_host():
    """``with mx.cpu():`` enters the Context scope: ``current_context()``
    is ``cpu(0)`` (on a host without a card too), arrays, Gluon and the
    Module bind land on the host, as in the reference."""
    with jmx.cpu():
        want = str(jmx.current_context())
    with tmx.cpu():
        assert str(tmx.current_context()) == want == "cpu(0)"
        z = tmx.nd.zeros((2,))
        net = tnn.Dense(2, in_units=3)
        net.initialize()
        data = tmx.sym.Variable("data")
        sym = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
        mod = tmx.mod.Module(sym, data_names=["data"], label_names=None,
                             context=tmx.cpu())
        mod.bind(data_shapes=[("data", (4, 3))])
    assert z.data.device.type == "cpu"
    assert net.weight.data().data.device.type == "cpu"
    assert mod._device.type == "cpu"


def test_c8_sequential_chains_its_children():
    x = _rand((4, 3), 1)
    nets = []
    for nn in (jnn, tnn):
        net = nn.Sequential(prefix="seq_")
        with net.name_scope():
            net.add(nn.Dense(5, in_units=3, activation="relu"),
                    nn.Dense(2, in_units=5))
        nets.append(net)
    theirs, ours = nets
    theirs.initialize()
    ours.initialize(ctx=CPU)
    _sync(theirs, ours, 2)
    _close(ours(_tnd(x)), theirs(jmx.nd.array(x)))


@pytest.mark.parametrize("key", [slice(None, None, -1), slice(5, 1, -2),
                                 (slice(None), slice(None, None, -1)),
                                 (slice(1, None), slice(3, 0, -2)),
                                 slice(1, 5, -1)],
                         ids=["rev", "5:1:-2", "col_rev", "2d", "empty"])
def test_c9_negative_step_slices(key):
    """Negative-step slices read and write as the reference's."""
    a = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    if not isinstance(key, tuple):
        a = a[:, 0].copy()
    ours, theirs = _tnd(a), jmx.nd.array(a)
    np.testing.assert_array_equal(ours[key].asnumpy(),
                                  theirs[key].asnumpy())
    value = -1.0 - np.arange(theirs[key].size, dtype=np.float32) \
        .reshape(theirs[key].shape)
    ours[key] = value
    theirs[key] = jmx.nd.array(value)
    np.testing.assert_array_equal(ours.asnumpy(), theirs.asnumpy())


def test_c10_dense_takes_and_returns_ndarrays():
    x = _rand((4, 3), 3)
    theirs = jnn.Dense(5, in_units=3, prefix="cten_")
    ours = tnn.Dense(5, in_units=3, prefix="cten_")
    theirs.initialize()
    ours.initialize(ctx=CPU)
    _sync(theirs, ours, 4)
    got = ours(_tnd(x))
    assert isinstance(got, tmx.nd.NDArray)
    _close(got, theirs(jmx.nd.array(x)))
    params = ours.collect_params()
    assert isinstance(params, tmx.gluon.ParameterDict)
    assert isinstance(params["cten_weight"], tmx.gluon.Parameter)


# -- every layer, eager and hybridized -----------------------------------------

def _attention(nn, in_units, pre):
    return nn.FlashSelfAttention(8, 2, causal=True, in_units=in_units,
                                 prefix=pre)


#: name -> (factory over a Gluon nn module and a prefix, input shape,
#: integer input).  Each test gives its blocks a prefix of its own: the
#: reference names a hybridized block's CachedOp after the block and
#: reuses a compiled CachedOp of that name, so two tests' blocks of one
#: name would share one program there
LAYERS = {
    "dense": (lambda nn, pre: nn.Dense(6, activation="tanh", in_units=12,
                                  prefix=pre), (3, 3, 4), False),
    "dense_deferred": (lambda nn, pre: nn.Dense(6, flatten=False, prefix=pre),
                       (3, 2, 5), False),
    "dense_nobias": (lambda nn, pre: nn.Dense(4, use_bias=False, prefix=pre),
                     (3, 5), False),
    "activation": (lambda nn, pre: nn.Activation("softrelu", prefix=pre),
                   (3, 4), False),
    "dropout_eval": (lambda nn, pre: nn.Dropout(0.5, prefix=pre), (3, 4),
                     False),
    "batchnorm": (lambda nn, pre: nn.BatchNorm(prefix=pre), (4, 3, 5), False),
    "batchnorm_axis": (lambda nn, pre: nn.BatchNorm(axis=-1, scale=False,
                                               prefix=pre), (6, 3), False),
    "leakyrelu": (lambda nn, pre: nn.LeakyReLU(0.1, prefix=pre), (3, 4), False),
    "embedding": (lambda nn, pre: nn.Embedding(10, 4, prefix=pre), (3, 5),
                  True),
    "attention": (lambda nn, pre: _attention(nn, 8, pre), (2, 6, 8), False),
    "attention_deferred": (lambda nn, pre: _attention(nn, 0, pre), (2, 6, 8), False),
    "layernorm": (lambda nn, pre: nn.LayerNorm(prefix=pre), (3, 5), False),
    "layernorm_axis": (lambda nn, pre: nn.LayerNorm(axis=1, in_channels=4,
                                               prefix=pre), (2, 4, 3),
                       False),
    "gelu": (lambda nn, pre: nn.GELU(prefix=pre), (3, 4), False),
    "flatten": (lambda nn, pre: nn.Flatten(prefix=pre), (2, 3, 4), False),
    "hybridlambda": (lambda nn, pre: nn.HybridLambda("tanh", prefix=pre),
                     (3, 4), False),
    "hybridsequential": (lambda nn, pre: _hseq(nn, pre), (3, 4), False),
}


def _hseq(nn, pre="l_"):
    net = nn.HybridSequential(prefix=pre)
    with net.name_scope():
        net.add(nn.Dense(5, activation="relu"), nn.LayerNorm(),
                nn.Dense(3))
    return net


def _layer_pair(name, hybrid=False):
    make, shape, integer = LAYERS[name]
    pre = "%s%s_" % (name.replace("_", ""), "h" if hybrid else "e")
    theirs, ours = make(jnn, pre), make(tnn, pre)
    theirs.initialize()
    ours.initialize(ctx=CPU)
    if integer:
        x = np.random.RandomState(5).randint(0, 10, shape).astype(
            np.float32)
    else:
        x = _rand(shape, 5)
    # a first forward resolves deferred shapes on both sides
    theirs(jmx.nd.array(x))
    ours(_tnd(x))
    assert [(k, p.shape) for k, p in ours.collect_params().items()] == \
        [(k, p.shape) for k, p in theirs.collect_params().items()]
    _sync(theirs, ours, 6)
    return theirs, ours, x


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name, hybrid):
    """Forward (inference, then training under ``record``; Dropout's
    identity recorded in predict mode) and every parameter's gradient of
    ``sum(out)``; BatchNorm's moving statistics after the training
    forward (the aux write-back)."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu_torch import autograd as tag
    theirs, ours, x = _layer_pair(name, hybrid)
    if hybrid:
        ours.hybridize()
        theirs.hybridize()
    _close(ours(_tnd(x)), theirs(jmx.nd.array(x)))
    outs = []
    train = name != "dropout_eval"
    for mx, ag, net in ((jmx, jag, theirs), (tmx, tag, ours)):
        arr = mx.nd.array(x, ctx=mx.cpu())
        with ag.record(train_mode=train):
            y = net(arr)
        y.backward()
        outs.append(y)
    _close(outs[1], outs[0])
    tp = ours.collect_params()
    for k, jp in theirs.collect_params().items():
        if jp.grad_req != "null":
            _close(tp[k].grad(), jp.grad())
        else:
            _close(tp[k].data(), jp.data())


def test_dropout_draws_by_distribution_and_seed():
    """Training-mode dropout keeps about ``1 - p`` of the elements, scales
    them by ``1 / (1 - p)``, and ``mx.random.seed`` replays the mask; the
    reference's keeps the same share."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu_torch import autograd as tag
    x = np.ones((200, 200), np.float32)
    masks = []
    for _ in range(2):
        tmx.random.seed(11)
        with tag.record():
            masks.append(tnn.Dropout(0.3)(_tnd(x)).asnumpy())
    np.testing.assert_array_equal(masks[0], masks[1])
    with jag.record():
        ref = jnn.Dropout(0.3)(jmx.nd.array(x)).asnumpy()
    for m in (masks[0], ref):
        assert abs((m != 0).mean() - 0.7) < 0.02
        np.testing.assert_allclose(m[m != 0], 1 / 0.7, rtol=1e-6)


# -- losses ----------------------------------------------------------------------

def _loss_inputs(name):
    rng = np.random.RandomState(8)
    pred = rng.randn(4, 6).astype(np.float32)
    if name == "softmax_ce":
        return pred, rng.randint(0, 6, (4,)).astype(np.float32)
    if name == "softmax_ce_dense":
        lbl = rng.rand(4, 6).astype(np.float32)
        return pred, lbl / lbl.sum(-1, keepdims=True)
    if name == "kldiv":
        lbl = rng.rand(4, 6).astype(np.float32)
        return np.log(np.exp(pred) / np.exp(pred).sum(-1, keepdims=True)), \
            lbl / lbl.sum(-1, keepdims=True)
    if name in ("sigmoid_bce", "sigmoid_bce_prob"):
        lbl = rng.randint(0, 2, (4, 6)).astype(np.float32)
        if name == "sigmoid_bce_prob":
            pred = 1 / (1 + np.exp(-pred))
        return pred, lbl
    if name == "hinge":
        return pred, np.sign(rng.randn(4, 6)).astype(np.float32)
    if name == "ctc":
        lbl = np.array([[1, 2, 2, -1], [3, 1, -1, -1], [4, 4, 4, 2],
                        [-1, -1, -1, -1]], np.float32)
        return rng.randn(4, 9, 6).astype(np.float32), lbl
    return pred, rng.randn(4, 6).astype(np.float32)


#: name -> class name and keyword arguments
LOSSES = {
    "l2": ("L2Loss", {}), "l1": ("L1Loss", {"weight": 0.5}),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}),
    "sigmoid_bce_prob": ("SigmoidBCELoss", {"from_sigmoid": True}),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}),
    "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False}),
    "kldiv": ("KLDivLoss", {}), "huber": ("HuberLoss", {"rho": 0.7}),
    "hinge": ("HingeLoss", {"margin": 0.5}), "ctc": ("CTCLoss", {}),
}


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference(name, hybrid):
    """The loss per sample and its gradient w.r.t. ``pred``; with a
    ``sample_weight`` too for the losses that take one positionally."""
    cls, kw = LOSSES[name]
    # the reference's CTC computes outside its tape on NDArrays (its
    # gradient there is 0); it differentiates through the hybridized loss
    hold_grad = hybrid or name != "ctc"
    pred, label = _loss_inputs(name)
    results = []
    for mx in (jmx, tmx):
        loss_fn = getattr(mx.gluon.loss, cls)(**kw)
        if hybrid:
            loss_fn.hybridize()
        p = mx.nd.array(pred, ctx=mx.cpu())
        p.attach_grad()
        with mx.autograd.record():
            out = loss_fn(p, mx.nd.array(label, ctx=mx.cpu()))
        out.backward()
        results.append((out, p.grad))
    (want, want_g), (got, got_g) = results
    assert isinstance(got, tmx.nd.NDArray)
    _close(got, want)
    if hold_grad:
        _close(got_g, want_g)
    if name not in ("ctc",):
        sw = np.random.RandomState(9).rand(4, 1).astype(np.float32)
        outs = [getattr(mx.gluon.loss, cls)(**kw)(
            mx.nd.array(pred, ctx=mx.cpu()),
            mx.nd.array(label, ctx=mx.cpu()),
            mx.nd.array(sw, ctx=mx.cpu())) for mx in (jmx, tmx)]
        _close(outs[1], outs[0])


def test_ctc_lengths_and_layout_match_reference():
    pred, label = _loss_inputs("ctc")
    plen = np.array([9, 7, 9, 5], np.float32)
    llen = np.array([3, 2, 4, 0], np.float32)
    outs = []
    for mx in (jmx, tmx):
        loss_fn = mx.gluon.loss.CTCLoss(layout="TNC")
        outs.append(loss_fn(
            mx.nd.array(pred.transpose(1, 0, 2), ctx=mx.cpu()),
            mx.nd.array(label, ctx=mx.cpu()),
            pred_lengths=mx.nd.array(plen, ctx=mx.cpu()),
            label_lengths=mx.nd.array(llen, ctx=mx.cpu())))
    _close(outs[1], outs[0], 1e-4)


def test_softmax_ce_out_of_range_labels_on_ndarrays():
    """C2's law on the NDArray path: a label past the classes gives NaN, a
    negative one picks from the end, as the reference's ``pick``."""
    pred = _rand((3, 4), 0)
    label = np.array([3, 7, -1], np.float32)
    got = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        _tnd(pred), _tnd(label)).asnumpy()
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        jmx.nd.array(pred), jmx.nd.array(label)).asnumpy()
    np.testing.assert_array_equal(np.isnan(got), [False, True, False])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(np.nan_to_num(got), np.nan_to_num(want))


# -- Parameter and ParameterDict --------------------------------------------------

def _dense_pair(prefix, grad_req=None):
    theirs = jnn.Dense(3, in_units=4, prefix=prefix)
    ours = tnn.Dense(3, in_units=4, prefix=prefix)
    if grad_req is not None:
        # before initialize: the reference marks its arrays there, and
        # reads a later change of the attribute nowhere
        theirs.collect_params().setattr("grad_req", grad_req)
        ours.collect_params().setattr("grad_req", grad_req)
    theirs.initialize()
    ours.initialize(ctx=CPU)
    _sync(theirs, ours, 12)
    return theirs, ours


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_laws_match_reference(req):
    """``setattr("grad_req", req)`` before ``initialize``: two backwards
    write (the second gradient), add (their sum), or give no gradient; a
    Trainer step then moves only the parameters that have one."""
    x1, x2 = _rand((2, 4), 13), _rand((2, 4), 14)
    results = []
    for mx, net in zip((jmx, tmx), _dense_pair("req%s_" % req, req)):
        params = net.collect_params()
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
        for x in (x1, x2):
            with mx.autograd.record():
                loss = (net(mx.nd.array(x, ctx=mx.cpu())) ** 2).sum()
            loss.backward()
        grads = None if req == "null" else \
            [p.grad().asnumpy() for p in params.values()]
        trainer.step(1)
        results.append((grads, [p.data().asnumpy()
                                for p in params.values()]))
    (jg, jw), (tg, tw) = results
    if req == "null":
        with pytest.raises(RuntimeError):
            tmx.gluon.Parameter("x", grad_req="null", shape=(1,)).grad()
    else:
        for a, b in zip(tg, jg):
            _close(a, b)
    for a, b in zip(tw, jw):
        _close(a, b)


@pytest.mark.parametrize("req", ["write", "add"])
def test_block_called_twice_in_one_graph_gets_the_sum(req):
    """A block called twice in one recorded graph, one backward: its
    parameters get the sum of both calls' gradients (``write`` as
    ``add``), fed NDArrays or raw tensors, as in the reference; a second
    backward then writes its own gradient or adds it."""
    xs = [_rand((2, 4), seed) for seed in (16, 17, 18)]

    def run(mx, net, feed):
        grads = []
        for batch in (xs[:2], xs[2:]):
            with mx.autograd.record():
                loss = (net(feed(batch[0])) ** 2).sum()
                for x in batch[1:]:
                    loss = loss + (net(feed(x)) ** 2).sum()
            loss.backward()
            grads.append([p.grad().asnumpy()
                          for p in net.collect_params().values()])
        return grads

    theirs, ours = _dense_pair("twice%s_" % req, req)
    want = run(jmx, theirs, jmx.nd.array)
    got = {"nd": run(tmx, ours, _tnd)}
    ours.collect_params().zero_grad()
    got["raw"] = run(tmx, ours, torch.from_numpy)
    for feed, runs in got.items():
        for step, (g, w) in enumerate(zip(runs, want)):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                           err_msg="%s %d" % (feed, step))


def test_zero_grad_and_data_is_the_live_leaf():
    """``zero_grad`` clears the buffers; ``data()`` is one NDArray over the
    leaf the Trainer updates in place (read after 3 steps it equals the
    updated values), and ``cast``/``reset_ctx`` keep that tensor."""
    theirs, ours = _dense_pair("live_")
    w = ours.weight
    arr, leaf = w.data(), w.data().data
    trainers = [mx.gluon.Trainer(n.collect_params(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9})
                for mx, n in ((jmx, theirs), (tmx, ours))]
    x = _rand((2, 4), 15)
    for _ in range(3):
        for mx, net, tr in zip((jmx, tmx), (theirs, ours), trainers):
            with mx.autograd.record():
                loss = net(mx.nd.array(x, ctx=mx.cpu())).sum()
            loss.backward()
            tr.step(2)
    assert w.data() is arr and arr.data is leaf
    _close(arr, theirs.weight.data())
    np.testing.assert_array_equal(leaf.detach().numpy(), arr.asnumpy())
    ours.collect_params().zero_grad()
    assert not w.grad().asnumpy().any()
    w.cast("float64")
    w.reset_ctx(CPU)
    assert w.data().data is leaf and leaf.dtype == torch.float64


def test_parameter_dict_get_share_and_save_names(tmp_path):
    """``get`` with prefix and sharing, the deferred-shape merge, and
    ``save``/``load`` names read by the other package."""
    shared = tmx.gluon.ParameterDict("a_")
    p = shared.get("w", shape=(2, 0), allow_deferred_init=True)
    same = tmx.gluon.ParameterDict("a_", shared).get("w", shape=(0, 3))
    assert same is p and p.shape == (2, 3) and p.name == "a_w"
    theirs, ours = _dense_pair("saved_")
    path = str(tmp_path / "ours.params")
    ours.save_params(path)
    back = jnn.Dense(3, in_units=4, prefix="saved_")
    back.load_params(path)
    for a, b in zip(back.collect_params().values(),
                    ours.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    path2 = str(tmp_path / "theirs.params")
    theirs.collect_params().save(path2, strip_prefix="saved_")
    again = tnn.Dense(3, in_units=4, prefix="saved_")
    again.collect_params().load(path2, ctx=CPU, restore_prefix="saved_")
    for a, b in zip(again.collect_params().values(),
                    theirs.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    with pytest.raises(ValueError, match="missing"):
        tnn.LayerNorm(prefix="saved_").load_params(path, ctx=CPU)


def test_block_registers_leaves_with_torch():
    """An initialized Parameter's leaf is a torch parameter of its block
    (``.parameters()``, ``state_dict``); a deferred one joins at its first
    forward."""
    net = tnn.Dense(3, prefix="reg_")
    net.initialize(ctx=CPU)
    assert [t is net.bias.data().data for t in net.parameters()] == [True]
    net(_tnd(_rand((2, 5), 16)))
    leaves = {id(p.data().data) for p in net.collect_params().values()}
    assert {id(t) for t in net.parameters()} == leaves
    assert sorted(net.state_dict()) == ["bias", "weight"]


# -- SymbolBlock, functionalize, Symbol inputs ---------------------------------

def test_symbol_block_matches_reference():
    x = _rand((3, 4), 17)
    results = []
    for mx in (jmx, tmx):
        data = mx.sym.Variable("data")
        out = mx.sym.Activation(mx.sym.FullyConnected(
            data, num_hidden=5, name="fc"), act_type="tanh")
        blk = mx.gluon.SymbolBlock(out, data)
        rng = np.random.RandomState(18)
        for name in ("fc_weight", "fc_bias"):
            p = blk.collect_params()[name]
            shape = (5, 4) if name.endswith("weight") else (5,)
            p.set_data(mx.nd.array(rng.randn(*shape).astype(np.float32),
                                   ctx=mx.cpu()))
        results.append(blk(mx.nd.array(x, ctx=mx.cpu())))
    _close(results[1], results[0])


def test_symbolblock_infers_shapes_and_differentiates():
    data = tmx.sym.Variable("data")
    out = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
    blk = tmx.gluon.SymbolBlock(out, data)
    blk.initialize(ctx=CPU)
    x = _tnd(_rand((3, 4), 19))
    with tmx.autograd.record():
        y = blk(x)
    y.backward()
    w = blk.collect_params()["fc_weight"]
    assert w.shape == (2, 4)
    _close(w.grad(), np.tile(x.asnumpy().sum(0), (2, 1)))


def test_functionalize_matches_the_block():
    """``functionalize`` gives a pure function over torch tensors equal to
    the block, differentiable in the parameters passed to it."""
    from mxnet_tpu_torch.gluon.block import functionalize
    net = _hseq(tnn, "func_")
    net.initialize(ctx=CPU)
    x = _rand((3, 4), 20)
    want = net(_tnd(x)).asnumpy()
    apply_fn, params = functionalize(net, _tnd(x))
    assert apply_fn.param_names == list(net.collect_params())
    outs, aux = apply_fn(params, torch.from_numpy(x))
    np.testing.assert_allclose(outs[0].detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    leaves = [p.clone().requires_grad_() for p in params]
    apply_fn(leaves, torch.from_numpy(x))[0][0].sum().backward()
    assert all(t.grad is not None for t in leaves)


def test_random_module_seeds_per_device_generators():
    tmx.random.seed(4)
    a = tmx.random.uniform(0, 1, (5,), ctx=CPU).asnumpy()
    n = tmx.random.normal(0, 1, (3,), ctx=CPU).asnumpy()
    tmx.random.seed(4)
    np.testing.assert_array_equal(
        tmx.random.uniform(0, 1, (5,), ctx=CPU).asnumpy(), a)
    np.testing.assert_array_equal(
        tmx.random.normal(0, 1, (3,), ctx=CPU).asnumpy(), n)
    r = tmx.random.randint(2, 5, (100,), ctx=CPU).asnumpy()
    assert r.dtype == np.int32 and r.min() >= 2 and r.max() < 5
    assert tmx.rnd is tmx.random
