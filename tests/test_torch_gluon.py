"""The port's Gluon layers and losses against the JAX package's on the same
numpy inputs and weights: default names under Gluon's name scopes, the
``Dense`` and ``LayerNorm`` signatures, ``ctx=`` on ``initialize`` and
``load_params``, and ``SoftmaxCrossEntropyLoss`` on labels outside the
classes.

Tolerance: 1e-6 absolute plus 1e-6 relative on float32 results (the same
float32 arithmetic in both packages, summed in another order); names and
NaN positions equal.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-6


def _rand(shape, seed):
    return np.random.RandomState(seed).uniform(-2, 2, shape).astype(
        np.float32)


def _copy_weights(theirs, ours, seed):
    """The same random arrays into both layers, matched by Gluon name."""
    rng = np.random.RandomState(seed)
    for (jname, jp), (tname, tp) in zip(theirs.collect_params().items(),
                                        ours.collect_params().items()):
        assert jname == tname
        a = rng.uniform(-1, 1, jp.shape).astype(np.float32)
        jp.set_data(jmx.nd.array(a))
        tp.set_data(torch.from_numpy(a))


def test_softmax_ce_loss_out_of_range_labels_match_reference():
    """A label at or past the classes gives NaN and a negative one picks
    from the end, as the reference's ``pick`` (``take_along_axis`` in its
    default mode); nothing raises."""
    pred = _rand((3, 4), 0)
    label = np.array([3, 7, -1], np.float32)
    got = tloss.SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                          torch.from_numpy(label)).numpy()
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        jmx.nd.array(pred), jmx.nd.array(label)).asnumpy()
    np.testing.assert_array_equal(np.isnan(got), [False, True, False])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=TOL, atol=TOL)


def test_default_names_count_per_class():
    """Two default-named Dense layers added to a Sequential keep four
    distinct parameters, and initialize, Trainer and save_params see all
    four; inside a name scope the names equal Gluon's."""
    net = tnn.Sequential()
    net.add(tnn.Dense(8, in_units=4), tnn.Dense(2, in_units=8))
    names = list(net.collect_params())
    assert len(set(names)) == 4
    first = int(names[0][len("dense"):names[0].index("_")])
    assert names == ["dense%d_weight" % first, "dense%d_bias" % first,
                     "dense%d_weight" % (first + 1),
                     "dense%d_bias" % (first + 1)]
    net.initialize("one", ctx=tmx.cpu())
    assert all(bool((p.data().data == 1).all())
               for n, p in net.collect_params().items()
               if n.endswith("weight"))
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    assert trainer._names == names

    theirs, ours = jnn.Sequential(prefix="net_"), tnn.Sequential(
        prefix="net_")
    with theirs.name_scope():
        theirs.add(jnn.Dense(8, in_units=4), jnn.Dense(2, in_units=8))
    with ours.name_scope():
        ours.add(tnn.Dense(8, in_units=4), tnn.Dense(2, in_units=8))
    assert list(ours.collect_params()) == list(theirs.collect_params())
    assert list(ours.collect_params()) == [
        "net_dense0_weight", "net_dense0_bias", "net_dense1_weight",
        "net_dense1_bias"]


def test_save_and_load_params_keep_every_layer(tmp_path):
    """save_params writes all four parameters of two default-named layers
    under Gluon's names (the JAX package reads them), and load_params with
    ``ctx=`` puts them back."""
    theirs, ours = jnn.Sequential(prefix="net_"), tnn.Sequential(
        prefix="net_")
    with theirs.name_scope():
        theirs.add(jnn.Dense(8, in_units=4), jnn.Dense(2, in_units=8))
    with ours.name_scope():
        ours.add(tnn.Dense(8, in_units=4), tnn.Dense(2, in_units=8))
    theirs.initialize()
    ours.initialize(ctx=tmx.cpu())
    path = str(tmp_path / "net.params")
    ours.save_params(path)
    theirs.load_params(path)
    for (_, jp), (_, tp) in zip(theirs.collect_params().items(),
                                ours.collect_params().items()):
        np.testing.assert_array_equal(jp.data().asnumpy(),
                                      tp.data().asnumpy())
    again = tnn.Sequential(prefix="net_")
    with again.name_scope():
        again.add(tnn.Dense(8, in_units=4), tnn.Dense(2, in_units=8))
    again.load_params(path, ctx=tmx.cpu())
    for (_, a), (_, b) in zip(again.collect_params().items(),
                              ours.collect_params().items()):
        assert torch.equal(a.data().data, b.data().data)


@pytest.mark.parametrize("flatten", [True, False])
def test_dense_with_activation_matches_reference(flatten):
    """``Dense(8, "relu", in_units=4)`` in Gluon's argument order gives the
    reference's output on the same weights, flattening or not."""
    theirs = jnn.Dense(8, "relu", flatten=flatten, in_units=4,
                       prefix="fc_")
    ours = tnn.Dense(8, "relu", flatten=flatten, in_units=4, prefix="fc_")
    theirs.initialize()
    _copy_weights(theirs, ours, 1)
    x = _rand((2, 2, 2) if flatten else (3, 5, 4), 2)
    got = ours(torch.from_numpy(x)).numpy()
    want = theirs(jmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_layer_norm_signature_matches_reference():
    """``LayerNorm(epsilon, axis, center, scale, ..., in_channels)`` in
    Gluon's order, over a middle axis, against the reference."""
    theirs = jnn.LayerNorm(1e-3, 1, in_channels=5, prefix="ln_")
    ours = tnn.LayerNorm(1e-3, 1, in_channels=5, prefix="ln_")
    theirs.initialize()
    _copy_weights(theirs, ours, 3)
    x = _rand((2, 5, 3), 4)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                               theirs(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-5)
    frozen = tnn.LayerNorm(center=False, scale=False, in_channels=5)
    frozen.initialize(ctx=tmx.cpu())
    assert frozen.gamma.grad_req == frozen.beta.grad_req == "null"
    assert not frozen.gamma.data().data.requires_grad
    assert not frozen.beta.data().data.requires_grad


def test_per_parameter_initializers_and_deferred_shapes():
    """``weight_initializer``/``bias_initializer`` win over ``init``, each
    dispatched on the parameter's name as the reference's (so a "ones"
    bias initializer still gives a zero bias, as there); a zero input
    size defers the shape to the first forward, as in the reference:
    ``Dense(3)`` and ``LayerNorm()`` fed a 4 x 2 batch take 2 inputs, and
    give the reference's output on the same weights; ``device`` and
    ``ctx`` together are refused."""
    layer = tnn.Dense(3, weight_initializer="ones", bias_initializer="ones",
                      in_units=2)
    layer.initialize("zeros", device="cpu")
    ref = jnn.Dense(3, weight_initializer="ones", bias_initializer="ones",
                    in_units=2)
    ref.initialize("zeros")
    for ours, theirs in zip(layer.collect_params().values(),
                            ref.collect_params().values()):
        np.testing.assert_array_equal(ours.data().asnumpy(),
                                      theirs.data().asnumpy())
    x = _rand((4, 2), 6)
    for make in (lambda m: m.Dense(3), lambda m: m.LayerNorm()):
        ours, theirs = make(tnn), make(jnn)
        ours.initialize(ctx=tmx.cpu())
        theirs.initialize()
        shapes = [[p.shape for p in n.collect_params().values()]
                  for n in (ours, theirs)]
        assert shapes[0] == shapes[1] and 0 in shapes[0][0]
        ours(tmx.nd.array(x, ctx=tmx.cpu()))
        want = theirs(jmx.nd.array(x)).asnumpy()
        shapes = [[p.shape for p in n.collect_params().values()]
                  for n in (ours, theirs)]
        assert shapes[0] == shapes[1] and 0 not in shapes[0][0]
        for p, q in zip(ours.collect_params().values(),
                        theirs.collect_params().values()):
            p.set_data(q.data().asnumpy())
        got = ours(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="not both"):
        layer.initialize(device="cpu", ctx=tmx.cpu())


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.1}),
])
def test_trainer_skips_non_finite_gradients_like_reference(optimizer,
                                                          params):
    """Fault C4: a NaN input gives NaN gradients; the reference's Trainer
    leaves the parameters as they were, and so does the port's: every
    parameter bit for bit (after a finite step), both clocks rewound as
    the reference's are.  Then a finite step updates again, as the
    reference's does."""
    from mxnet_tpu_torch import autograd
    jnet, tnet, jtr, ttr = _c4_nets(optimizer, params)

    def step(x):
        with jmx.autograd.record():
            jl = jnet(jmx.nd.array(x)).sum()
        jl.backward()
        jtr.step(1)
        with autograd.record():
            tl = tnet(torch.from_numpy(x)).sum()
        tl.backward()
        ttr.step(1)

    step(np.array([[1.0, 2.0, 0.5]], np.float32))
    before = {n: p.data().data.detach().clone()
              for n, p in tnet.collect_params().items()}
    step(np.array([[1.0, np.nan, 0.0]], np.float32))
    jw = jnet.weight.data().asnumpy()
    assert np.isfinite(jw).all()
    for n, p in tnet.collect_params().items():
        assert torch.equal(p.data().data.detach(), before[n]), n
    np.testing.assert_allclose(tnet.weight.data().asnumpy(), jw,
                               rtol=TOL, atol=TOL)
    # the verdicts are read one step late, at the next step or here
    jtr._resolve_pending_verdict()
    ttr._resolve_pending_verdict()
    assert ttr._optimizer._index_update_count == \
        jtr._optimizer._index_update_count == {0: 1, 1: 1}
    assert ttr._optimizer.num_update == jtr._optimizer.num_update == 1
    assert ttr._consec_guard_skips == jtr._consec_guard_skips == 1
    step(np.array([[0.5, 1.0, 2.0]], np.float32))
    ttr._resolve_pending_verdict()
    assert ttr._consec_guard_skips == 0
    assert not torch.equal(tnet.weight.data().data.detach(),
                           before["cfour_weight"])
    np.testing.assert_allclose(tnet.weight.data().asnumpy(),
                               jnet.weight.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)


def _c4_nets(optimizer, params, prefix="cfour_"):
    """``Dense(2, in_units=3)`` in both packages with the same weight, and
    a Trainer for each."""
    w = _rand((2, 3), 5)
    jnet = jnn.Dense(2, in_units=3, prefix=prefix)
    tnet = tnn.Dense(2, in_units=3, prefix=prefix)
    jnet.initialize(jmx.init.Zero())
    tnet.initialize("zeros", ctx=tmx.cpu())
    jnet.weight.set_data(jmx.nd.array(w))
    tnet.weight.set_data(torch.from_numpy(w))
    return jnet, tnet, \
        jmx.gluon.Trainer(jnet.collect_params(), optimizer, dict(params)), \
        Trainer(tnet.collect_params(), optimizer, dict(params))


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.1}),
])
def test_trainer_skip_keeps_optimizer_state(optimizer, params):
    """A skipped step leaves the momentum or Adam's mean and variance bit
    for bit as they were."""
    from mxnet_tpu_torch import autograd
    _, net, _, tr = _c4_nets(optimizer, params, prefix="cfourstate_")

    def step(x):
        with autograd.record():
            l = net(torch.from_numpy(x)).sum()
        l.backward()
        tr.step(1)

    step(np.array([[1.0, 2.0, 0.5]], np.float32))
    state = {k: [t.clone() for t in (v if isinstance(v, tuple) else (v,))]
             for k, v in tr._fused.state.items()}
    assert any(bool(t.abs().max() > 0) for v in state.values() for t in v)
    step(np.array([[1.0, np.nan, 0.0]], np.float32))
    for k, want in state.items():
        got = tr._fused.state[k]
        for g, w in zip(got if isinstance(got, tuple) else (got,), want):
            assert torch.equal(g, w), k


def test_trainer_raises_after_the_skip_limit(monkeypatch):
    """``MXTPU_MAX_CONSECUTIVE_SKIPS`` consecutive skipped steps: the next
    ``step`` raises ``MXNetError`` (the verdict is read one step late)."""
    from mxnet_tpu_torch import autograd
    monkeypatch.setenv("MXTPU_MAX_CONSECUTIVE_SKIPS", "2")
    net = tnn.Dense(2, in_units=3, prefix="skiplimit_")
    net.initialize("ones", ctx=tmx.cpu())
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    x = torch.tensor([[1.0, float("inf"), 0.0]])

    def step():
        with autograd.record():
            l = net(x).sum()
        l.backward()
        tr.step(1)

    step()
    step()
    with pytest.raises(tmx.MXNetError, match="consecutive"):
        step()


def test_trainer_states_round_trip(tmp_path):
    """``save_states``/``load_states``: a second Trainer loaded from the
    file continues the first one's momentum bit for bit; the learning
    rate reads and sets."""
    from mxnet_tpu_torch import autograd

    def make(prefix):
        net = tnn.Dense(2, in_units=3, prefix=prefix)
        net.initialize("ones", ctx=tmx.cpu())
        return net, Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})

    def step(net, tr):
        with autograd.record():
            l = (net(torch.tensor([[1.0, 2.0, 3.0]])) ** 2).sum()
        l.backward()
        tr.step(1)

    a, ta = make("statesa_")
    step(a, ta)
    ta.save_states(str(tmp_path / "t.states"))
    b, tb = make("statesb_")
    for p, q in zip(b.collect_params().values(),
                    a.collect_params().values()):
        p.set_data(q.data())
    tb.load_states(str(tmp_path / "t.states"))
    step(a, ta)
    step(b, tb)
    for p, q in zip(a.collect_params().values(),
                    b.collect_params().values()):
        assert torch.equal(p.data().data, q.data().data)
    assert tb.learning_rate == 0.1
    tb.set_learning_rate(0.01)
    assert tb._optimizer.lr == 0.01
