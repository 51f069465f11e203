"""The port's GPT training path against the JAX package's, in process, on
the committed ``gpt2_tiny`` fixture weights.

The JAX side runs its Gluon loop imperatively (``autograd.record`` /
``backward`` / ``Trainer.step``); in this process its
``FlashSelfAttention`` takes the plain jnp attention (the Pallas kernels
are held against the port's in tests/test_torch_flash_attention.py).  The
port runs the same loop through its flash entry point, whose wrappers run
the kernels' plain versions on CPU tensors.

Tolerances (fp32 on both sides, sums in another order by XLA and torch):
logits 1e-4 abs (values of magnitude ~1, as tests/test_torch_gpt.py);
gradients 1e-6 abs plus 1e-4 relative; parameters after each Trainer step
1e-6 abs (SGD) and 2e-5 abs (Adam).  Adam's step is about lr = 1e-3
whatever the gradient's size, so where a gradient is near zero the two
packages' rounding noise moves the step by a visible fraction of lr (3 of
49,152 entries of one weight by 5e-6 at the first step), while a wrong
gradient would move it by about lr.  The key part of each qkv bias is left
out of the Adam comparison: its true gradient is exactly zero (adding a
constant to every key shifts a query's scores uniformly, which the softmax
ignores), so both packages hold only rounding noise there (about 1e-9),
which Adam turns into steps of about +-lr of either sign.  Packing laws
(``pack_sequences``, ``packed_positions``) hold exactly.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, initializer
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURE = os.path.join(FIXDIR, "gpt2_tiny.params")
LOGIT_TOL = 1e-4
#: gpt2_tiny's heads
HEADS = 4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARAM_TOL = {"sgd": 1e-6, "adam": 2e-5}
#: the Trainer runs: lr, momentum/betas defaults, wd > 0, clip_gradient
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
            "clip_gradient": 0.05},
    "adam": {"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.05},
}


def _fixture_tokens():
    spec = importlib.util.spec_from_file_location(
        "make_pretrained_fixture",
        os.path.join(REPO, "tools", "make_pretrained_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fixture_inputs()[1]


def _batches(n, seed=0):
    """``n`` (tokens [2, 16], next-token labels) pairs over the fixture's
    vocab of 256."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, 256, (2, 17)).astype(np.int32)
        out.append((t[:, :-1], t[:, 1:].astype(np.float32)))
    return out


def _packed():
    """Two packed rows of 24 tokens from documents of 5-13 tokens."""
    rng = np.random.RandomState(7)
    docs = [rng.randint(1, 256, n) for n in (9, 13, 5, 11, 7)]
    return tgpt.pack_sequences(docs, 24)


def _jax_net():
    """The JAX gpt2_tiny on the fixture.  The prefix is given, so the JAX
    package's per-process name counter does not move (other test files
    in the same worker build ``gptlm0_`` nets and expect that name)."""
    from mxnet_tpu.gluon.model_zoo import gpt
    net = gpt.gpt2_tiny(prefix="gptlm0_")
    net.load_params(FIXTURE)
    return net


def _port_net(**kw):
    return tgpt.gpt2_tiny(**kw).load_params(FIXTURE, device="cpu")


def _jax_logits(net, toks, segs=None):
    import mxnet_tpu as mx
    args = [mx.nd.array(toks, dtype="int32")]
    if segs is not None:
        args.append(mx.nd.array(segs, dtype="int32"))
    return net(*args).asnumpy()


def _port_names(net):
    """Gluon names without the model prefix, in collect_params order."""
    return [n.split("_", 1)[1] for n in net.collect_params()]


def _jax_step_grads(net, x, y, segs=None):
    """{name without prefix: grad} of the mean softmax-CE loss."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    args = [mx.nd.array(x, dtype="int32")]
    if segs is not None:
        args.append(mx.nd.array(segs, dtype="int32"))
    with jag.record():
        loss = loss_fn(net(*args), mx.nd.array(y)).mean()
    loss.backward()
    return float(loss.asnumpy()), {
        n.split("_", 1)[1]: p.grad().asnumpy()
        for n, p in net.collect_params().items()}


def _port_step_grads(net, x, y, segs=None):
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        out = net(torch.from_numpy(x),
                  None if segs is None else torch.from_numpy(segs))
        loss = loss_fn(out, torch.from_numpy(y)).mean()
    loss.backward()
    return loss.item(), {n.split("_", 1)[1]: p.grad().asnumpy()
                         for n, p in net.collect_params().items()}


# -- forward ----------------------------------------------------------------------

def test_forward_logits_match_fixture_and_jax():
    toks = _fixture_tokens()
    got = _port_net()(torch.from_numpy(toks))
    assert not got.requires_grad          # outside record(): no graph
    want = np.load(os.path.join(FIXDIR, "gpt2_tiny_logits.npy"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), _jax_logits(_jax_net(), toks),
                               rtol=0, atol=LOGIT_TOL)


def test_forward_rejects_too_long_input():
    net = _port_net()
    with pytest.raises(ValueError):
        net(torch.zeros(1, 129, dtype=torch.long))


@pytest.mark.parametrize("docs,seq_len", [
    ([np.arange(1, 6), np.arange(3, 12)], 16),
    ([np.arange(1, 10), np.arange(1, 10), np.arange(20, 23)], 12),
    ([np.arange(1, 40)], 16),                        # split long document
    ([np.arange(1, 17), np.arange(2, 5)], 16),       # exact fit
])
def test_pack_sequences_and_positions_match_jax(docs, seq_len):
    from mxnet_tpu.gluon.model_zoo import gpt
    want_t, want_s = gpt.pack_sequences(docs, seq_len)
    got_t, got_s = tgpt.pack_sequences(docs, seq_len)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_t.dtype == got_s.dtype == np.int32
    pos = tgpt.packed_positions(torch.from_numpy(got_s))
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(gpt.packed_positions(want_s)))


def test_packed_forward_matches_jax_and_standalone_documents():
    toks, segs = _packed()
    net = _port_net()
    got = net(torch.from_numpy(toks), torch.from_numpy(segs)).numpy()
    np.testing.assert_allclose(got, _jax_logits(_jax_net(), toks, segs),
                               rtol=0, atol=LOGIT_TOL)
    # each packed document's logits equal its logits alone
    for row in range(toks.shape[0]):
        for sid in set(segs[row]) - {0}:
            cols = np.nonzero(segs[row] == sid)[0]
            alone = net(torch.from_numpy(toks[row:row + 1, cols])).numpy()
            np.testing.assert_allclose(got[row, cols], alone[0], rtol=0,
                                       atol=LOGIT_TOL)


# -- gradients and the Trainer -------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_gradients_match_jax(packed):
    if packed:
        x, segs = _packed()
        y = np.roll(x, -1, axis=1).astype(np.float32)
    else:
        (x, y), segs = _batches(1)[0], None
    jloss, want = _jax_step_grads(_jax_net(), x, y, segs)
    net = _port_net()
    loss, got = _port_step_grads(net, x, y, segs)
    assert math.isclose(loss, jloss, rel_tol=1e-6)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_trainer_runs():
    """Parameters after each of 3 JAX Trainer steps, per optimizer."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon
    runs = {}
    for name, params in OPTIMIZERS.items():
        net = _jax_net()
        trainer = gluon.Trainer(net.collect_params(), name, dict(params))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        after = []
        for x, y in _batches(3, seed=1):
            with jag.record():
                loss = loss_fn(net(mx.nd.array(x, dtype="int32")),
                               mx.nd.array(y)).mean()
            loss.backward()
            trainer.step(x.shape[0])
            after.append({n.split("_", 1)[1]: p.data().asnumpy()
                          for n, p in net.collect_params().items()})
        runs[name] = after
    return runs


def _compared(name, param_name, shape):
    """Entries the Trainer comparison holds: all, except under Adam the key
    rows of a qkv bias (head-major ``[H, 3, D]``: part 1), whose gradient
    is rounding noise (see the module docstring)."""
    keep = np.ones(shape, bool)
    if name == "adam" and param_name.endswith("attn_qkv_bias"):
        keep.reshape(HEADS, 3, -1)[:, 1] = False
    return keep


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_steps_match_jax(name, jax_trainer_runs):
    net = _port_net()
    trainer = Trainer(net.collect_params(), name, dict(OPTIMIZERS[name]))
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    for step, (x, y) in enumerate(_batches(3, seed=1)):
        with autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)),
                           torch.from_numpy(y)).mean()
        loss.backward()
        trainer.step(x.shape[0])
        want = jax_trainer_runs[name][step]
        for n, p in zip(_port_names(net), net.collect_params().values()):
            keep = _compared(name, n, want[n].shape)
            np.testing.assert_allclose(
                p.data().asnumpy()[keep], want[n][keep], rtol=0,
                atol=PARAM_TOL[name], err_msg="%s step %d %s"
                % (name, step, n))


def test_step_uses_only_its_own_gradient():
    """MXNet's grad_req="write": each backward overwrites the gradient.
    torch's backward adds into ``.grad``, so a raw-tensor forward reads
    every "write" parameter through ``write_grads``, whose backward writes:
    step 2's update is exactly -lr * grad(batch 2 at the step-1 weights),
    not that plus batch 1's gradient.  As in the reference, the Trainer
    clears nothing: after a step ``p.grad()`` holds the last backward's
    gradient, and a step with no backward since applies it again."""
    (x1, y1), (x2, y2) = _batches(2, seed=2)
    lr = 0.5
    net = _port_net()
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": lr})
    loss_fn = tloss.SoftmaxCrossEntropyLoss()

    def backward(x, y):
        with autograd.record():
            loss_fn(net(torch.from_numpy(x)),
                    torch.from_numpy(y)).mean().backward()

    def values(n):
        return [p.data().data.detach().clone()
                for p in n.collect_params().values()]

    def twin_grads(weights, x, y):
        twin = _port_net()
        for p, w in zip(twin.collect_params().values(), weights):
            p.set_data(w)
        return _port_step_grads(twin, x, y)[1]

    _, first = _port_step_grads(_port_net(), x1, y1)
    backward(x1, y1)
    trainer.step(1)
    for n, p in zip(_port_names(net), net.collect_params().values()):
        np.testing.assert_array_equal(p.grad().asnumpy(), first[n],
                                      err_msg=n)
    before = values(net)
    fresh = twin_grads(before, x2, y2)
    backward(x2, y2)
    trainer.step(1)
    for n, p, b in zip(_port_names(net), net.collect_params().values(),
                       before):
        np.testing.assert_array_equal(p.grad().asnumpy(), fresh[n],
                                      err_msg=n)
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      (b - lr * torch.from_numpy(fresh[n]))
                                      .numpy(), err_msg=n)
    # a step with no backward since the last one reuses the gradient
    after = values(net)
    trainer.step(1)
    for n, p, a in zip(_port_names(net), net.collect_params().values(),
                       after):
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      (a - lr * torch.from_numpy(fresh[n]))
                                      .numpy(), err_msg=n)


def test_trainer_arguments():
    net = _port_net()
    # a dist kind builds (a world of one without a coordinator)
    dist = Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    assert dist._kvstore == "dist_sync"
    with pytest.raises(ValueError):
        Trainer(net.collect_params(), "nadam_unknown")
    with pytest.raises(ValueError):
        Trainer([torch.zeros(2)], "sgd")
    with pytest.raises(ValueError):
        Trainer(net.collect_params(), topt.SGD(), {"learning_rate": 1.0})
    # a bare list of parameters: named by position, updated all the same
    params = list(net.collect_params().values())
    trainer = Trainer(params, "sgd", {"learning_rate": 1.0})
    for p in params:
        p.grad()[:] = 1.0
    before = params[0].data().data.detach().clone()
    trainer.step(2)
    torch.testing.assert_close(params[0].data().data.detach(),
                               before - 0.5)


def test_optimizer_multipliers_resolve_as_jax():
    """lr_mult/wd_mult: index keys win over names; set_wd_mult zeroes
    decay for names ending in neither _weight nor _gamma."""
    from mxnet_tpu import optimizer as jopt
    names = {0: "a_weight", 1: "a_bias", 2: "ln_gamma", 3: "ln_beta",
             4: "b_weight"}
    ours = topt.create("sgd", param_idx2name=names, learning_rate=0.1,
                       wd=0.01)
    theirs = jopt.create("sgd", param_idx2name=names, learning_rate=0.1,
                         wd=0.01)
    for o in (ours, theirs):
        o.set_lr_mult({0: 2.0, "b_weight": 0.5})
        o.set_wd_mult({3: 3.0})
    for i in names:
        assert ours._get_lr(i) == theirs._get_lr(i)
        assert ours._get_wd(i) == theirs._get_wd(i)
    with pytest.raises(ValueError):
        topt.create("lamb")


def test_remat_matches_plain_forward_and_grads():
    """remat=True changes memory, not math (tests/test_gpt.py:247): loss
    and gradients equal the non-remat net's on shared weights, with and
    without dropout (checkpoint replays the same dropout mask)."""
    for dropout in (0.0, 0.1):
        nets = [tgpt.GPTLM(32, 2, 32, 4, max_len=16, dropout=dropout,
                           remat=r) for r in (False, True)]
        nets[0].initialize(initializer.Xavier(), device="cpu",
                           generator=torch.Generator().manual_seed(3))
        # torch's state_dict sees the registered leaves
        nets[1].initialize(device="cpu")
        nets[1].load_state_dict(nets[0].state_dict())
        toks = torch.from_numpy(
            np.random.RandomState(3).randint(0, 32, (2, 16)))
        results = []
        for net in nets:
            tmx.random.seed(5)              # dropout draws from it
            with autograd.record():
                loss = torch.log_softmax(net(toks), -1)[..., 0].mean()
            loss.backward()
            results.append((loss.item(), [p.grad().data.clone() for p in
                                          net.collect_params().values()]))
        assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
        for a, b in zip(results[0][1], results[1][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dropout_only_while_training():
    net = _port_net(dropout=0.5)
    toks = torch.from_numpy(_fixture_tokens())
    base = net(toks)
    torch.testing.assert_close(net(toks), base, rtol=0, atol=0)
    with autograd.record(train_mode=False):
        torch.testing.assert_close(net(toks), base, rtol=0, atol=0)
    with autograd.record():
        assert not torch.allclose(net(toks), base)


def test_saved_params_load_into_jax_net(tmp_path):
    net = _port_net()
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": 1e-2})
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    for x, y in _batches(2, seed=4):
        with autograd.record():
            loss_fn(net(torch.from_numpy(x)),
                    torch.from_numpy(y)).mean().backward()
        trainer.step(2)
    path = str(tmp_path / "trained.params")
    net.save_params(path)
    from mxnet_tpu.gluon.model_zoo import gpt
    jnet = gpt.gpt2_tiny(prefix="gptlm0_")
    jnet.load_params(path)
    toks = _fixture_tokens()
    got = net(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(_jax_logits(jnet, toks), got, rtol=0,
                               atol=LOGIT_TOL)
    # the file also round-trips into a fresh port net
    back = tgpt.gpt2_tiny().load_params(path, device="cpu")
    for p, q in zip(back.collect_params().values(),
                    net.collect_params().values()):
        assert torch.equal(p.data().data, q.data().data)


# -- initialization, losses, scopes ---------------------------------------------------

def test_initialize_defaults_to_the_card():
    net = tgpt.gpt2_tiny()
    if torch.cuda.is_available():
        net.initialize()
        assert net.wte.data().data.device.type == "cuda"
    else:
        with pytest.raises(MXNetError):
            net.initialize()


@pytest.mark.parametrize("load", ["file", "arrays"])
def test_loading_weights_defaults_to_the_card(load):
    """``load_params`` and ``load_jax_params`` place the net as
    ``initialize`` does: on the card by default, raising without one, and
    on the host only when asked."""
    def go(net, **kw):
        if load == "file":
            return net.load_params(FIXTURE, **kw)
        arrays = {n: p.data().asnumpy()
                  for n, p in _port_net().collect_params().items()}
        return tgpt.load_jax_params(net, arrays, **kw)
    assert go(tgpt.gpt2_tiny(), device="cpu").wte.data().data.device.type \
        == "cpu"
    if torch.cuda.is_available():
        assert go(tgpt.gpt2_tiny()).wte.data().data.device.type == "cuda"
    else:
        with pytest.raises(MXNetError):
            go(tgpt.gpt2_tiny())


def test_initialize_by_name_dispatch_and_distribution():
    """Gluon's name dispatch (bias/beta 0, gamma 1, weight by the
    initializer); Xavier's draws agree with JAX's by distribution: the
    same bound sqrt(3 / mean fan) and the uniform law's std bound / √3."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo import gpt
    net = tgpt.gpt2_tiny()
    net.initialize(initializer.Xavier(), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    jnet = gpt.gpt2_tiny(prefix="gptlm0_")
    jnet.initialize(mx.init.Xavier())
    jparams = {n.split("_", 1)[1]: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    for n, p in zip(_port_names(net), net.collect_params().values()):
        a = p.data().asnumpy()
        if n.endswith(("_bias", "_beta")):
            assert not a.any(), n
        elif n.endswith("_gamma"):
            assert (a == 1).all(), n
        else:
            bound = math.sqrt(3.0 / ((a.shape[0] + a.shape[1]) / 2.0))
            for x in (a, jparams[n]):
                assert np.abs(x).max() <= bound
                assert abs(x.std() / (bound / math.sqrt(3)) - 1) < 0.05, n
                assert abs(x.mean()) < 0.05 * bound, n
    again = tgpt.gpt2_tiny()
    again.initialize(initializer.Xavier(), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.wte.data().data, net.wte.data().data)


@pytest.mark.parametrize("init,check", [
    (initializer.Normal(0.5), lambda a: abs(a.std() - 0.5) < 0.05),
    (initializer.Uniform(0.3), lambda a: np.abs(a).max() <= 0.3
     and abs(a.std() - 0.3 / math.sqrt(3)) < 0.02),
    (initializer.Constant(0.25), lambda a: (a == 0.25).all()),
    ("zeros", lambda a: not a.any()),
    ("one", lambda a: (a == 1).all()),
    (None, lambda a: np.abs(a).max() <= 0.07),        # Gluon's Uniform()
], ids=["normal", "uniform", "constant", "zeros", "one", "default"])
def test_initializers(init, check):
    from mxnet_tpu_torch.gluon import nn
    layer = nn.Dense(64, in_units=48, prefix="fc_")
    layer.initialize(init, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    assert check(layer.weight.data().asnumpy())
    assert not layer.bias.data().asnumpy().any()


def test_initializer_rejects_unknown_names():
    with pytest.raises(ValueError):
        initializer.Xavier()("running_thing", torch.zeros(3, 3))
    with pytest.raises(ValueError):
        initializer.Xavier()("fc_weight", torch.zeros(3))
    with pytest.raises(ValueError):
        initializer.create("orthogonal_unknown")


@pytest.mark.parametrize("kw,label", [
    ({}, "sparse"),
    ({"weight": 0.5}, "sparse"),
    ({"from_logits": True}, "sparse"),
    ({"sparse_label": False}, "dense"),
    ({"batch_axis": 1}, "sparse"),
    ({}, "sample_weight"),
])
def test_softmax_ce_loss_matches_jax(kw, label):
    import mxnet_tpu as mx
    from mxnet_tpu import gluon
    rng = np.random.RandomState(6)
    pred = rng.randn(3, 4, 7).astype(np.float32)
    if kw.get("from_logits"):
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    if label == "dense":
        y = rng.rand(3, 4, 7).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
    else:
        y = rng.randint(0, 7, (3, 4)).astype(np.float32)
    args = [pred, y]
    if label == "sample_weight":
        args.append(rng.rand(3, 4, 1).astype(np.float32))
    want = gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        *(mx.nd.array(a) for a in args)).asnumpy()
    got = tloss.SoftmaxCELoss(**kw)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_autograd_scopes():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    with autograd.record(train_mode=False):
        assert not autograd.is_training()
    assert not autograd.is_recording() and not autograd.is_training()
