"""The port's Gluon on ``mx.nd`` training against the JAX package's, in
process: ``gpt2_tiny`` from ``tests/fixtures/gpt2_tiny.params`` against
``gpt2_tiny_logits.npy`` and train_gpt.py's loop (``mx.nd`` tokens, an
NDArray loss, ``loss.backward()``, ``Trainer(net.collect_params(), ...)``)
eager and hybridized; the same run fed raw tensors; the post-LN stack's
symbolic route (its pass report, B4's fused node, BatchNorm's aux
write-back); ``split_and_load``/``clip_global_norm``; the DataLoader and
samplers.

In this process the JAX package's FlashSelfAttention takes its plain jnp
attention, and the port's flash wrappers run their plain versions on CPU
tensors.  Tolerances (fp32 on both sides, sums in another order): logits
1e-4 abs (values of magnitude ~1, as tests/test_torch_gpt.py); losses
1e-5 relative; gradients 1e-6 abs plus 1e-4 relative; Adam parameters
2e-5 abs with the key third of each qkv bias left out (its true gradient
is 0, so both sides hold rounding noise there that Adam turns into steps
of about +-lr; tests/test_torch_gpt_train.py); the post-LN stack and the
utilities 1e-5; the NDArray-fed, raw-fed and hybridized port runs agree
to 1e-6 (the same torch ops in the same order).
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURE = os.path.join(FIXDIR, "gpt2_tiny.params")
CPU = tmx.cpu()
LOGIT_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
ADAM_TOL = 2e-5
PORT_TOL = 1e-6
TOL = 1e-5
HEADS = 4
LR = 1e-3


def _fixture_tokens():
    spec = importlib.util.spec_from_file_location(
        "make_pretrained_fixture",
        os.path.join(REPO, "tools", "make_pretrained_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fixture_inputs()[1]


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, 256, (2, 17))
        out.append((t[:, :-1], t[:, 1:].astype(np.float32)))
    return out


def _port_net():
    return tmx.gluon.model_zoo.gpt.gpt2_tiny().load_params(FIXTURE, ctx=CPU)


def _strip(name):
    return name.split("_", 1)[1]


def _train(mx, net, batches, feed="nd"):
    """train_gpt.py's loop: returns the losses and, after each step, the
    parameters and ``p.grad()`` by name without the model prefix."""
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1,
                                                    sparse_label=True)
    losses, after = [], []
    for xb, yb in batches:
        if feed == "nd":
            x = mx.nd.array(xb, dtype="int32", ctx=mx.cpu())
            y = mx.nd.array(yb.astype(np.float32), ctx=mx.cpu())
        else:
            x, y = torch.from_numpy(xb), torch.from_numpy(yb)
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(xb.shape[0])
        losses.append(float(loss.asnumpy()) if feed == "nd"
                      else loss.item())
        after.append({_strip(n): (p.data().asnumpy(), p.grad().asnumpy())
                      for n, p in net.collect_params().items()})
    return losses, after


@pytest.fixture(scope="module")
def jax_run():
    from mxnet_tpu.gluon.model_zoo import gpt
    net = gpt.gpt2_tiny(prefix="gptlm0_")
    net.load_params(FIXTURE)
    return _train(jmx, net, _batches(3))


# -- gpt2_tiny ----------------------------------------------------------------

@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_gpt2_tiny_fixture_logits_on_ndarrays(hybrid):
    net = _port_net()
    if hybrid:
        net.hybridize()
    assert len(net.collect_params()) == 28
    toks = _fixture_tokens()
    got = net(tmx.nd.array(toks, dtype="int32", ctx=CPU))
    assert isinstance(got, tmx.nd.NDArray)
    want = np.load(os.path.join(FIXDIR, "gpt2_tiny_logits.npy"))
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=LOGIT_TOL)
    if hybrid:
        # the stack reads tokens.shape: the traced route, no graph report
        assert net._cached_op.plan is None
        assert net._cached_graph_report is None


def test_gpt_loads_through_the_block_loader(tmp_path):
    """``GPTLM`` has no loader of its own: ``load_params`` is the Block's,
    which reads a file saved under another GPTLM's prefix, and honours
    ``allow_missing`` and ``ignore_extra``."""
    tgpt = tmx.gluon.model_zoo.gpt
    assert "load_params" not in vars(tgpt.GPTLM)
    net = _port_net()
    want = [p.data().asnumpy() for p in net.collect_params().values()]
    unstripped = str(tmp_path / "unstripped.params")
    net.collect_params().save(unstripped)
    arrays = tmx.nd.load(FIXTURE, ctx=CPU)
    files = {"extra": dict(arrays, extra_weight=tmx.nd.zeros((2,), ctx=CPU)),
             "missing": {k: v for k, v in arrays.items() if k != "lnf_beta"}}
    for name, d in files.items():
        tmx.nd.save(str(tmp_path / name), d)
    back = tgpt.gpt2_tiny().load_params(unstripped, ctx=CPU)
    assert back.prefix != net.prefix
    extra = tgpt.gpt2_tiny().load_params(str(tmp_path / "extra"), ctx=CPU,
                                         ignore_extra=True)
    for got in (back, extra):
        for p, w in zip(got.collect_params().values(), want):
            np.testing.assert_array_equal(p.data().asnumpy(), w)
    with pytest.raises(ValueError, match="not present"):
        tgpt.gpt2_tiny().load_params(str(tmp_path / "extra"), ctx=CPU)
    with pytest.raises(ValueError, match="missing"):
        tgpt.gpt2_tiny().load_params(str(tmp_path / "missing"), ctx=CPU)
    part = tgpt.gpt2_tiny().load_params(str(tmp_path / "missing"), ctx=CPU,
                                        allow_missing=True)
    assert part.ln_f.beta._data is None and part.wte.data() is not None


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_train_gpt_loop_matches_reference(hybrid, jax_run):
    """3 Adam steps of train_gpt.py's loop: losses, parameters and
    ``p.grad()`` after every step (the reference's Trainer leaves the last
    gradient in place, and so does the port's)."""
    net = _port_net()
    if hybrid:
        net.hybridize()
    losses, after = _train(tmx, net, _batches(3))
    want_losses, want_after = jax_run
    for step, (got, want) in enumerate(zip(after, want_after)):
        assert math.isclose(losses[step], want_losses[step], rel_tol=1e-5)
        assert sorted(got) == sorted(want)
        for name, (w, g) in got.items():
            keep = np.ones(w.shape, bool)
            if name.endswith("attn_qkv_bias"):
                keep.reshape(HEADS, 3, -1)[:, 1] = False
            np.testing.assert_allclose(w[keep], want[name][0][keep],
                                       rtol=0, atol=ADAM_TOL,
                                       err_msg="step %d %s" % (step, name))
            np.testing.assert_allclose(g, want[name][1], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg="step %d %s" % (step, name))


def test_ndarray_raw_and_hybrid_runs_agree():
    """One gradient home: the same run fed NDArrays, fed raw tensors
    (torch's backward, "write" parameters through write_grads) and
    hybridized gives the same losses, parameters and gradients."""
    runs = []
    for feed, hybrid in (("nd", False), ("raw", False), ("nd", True)):
        net = _port_net()
        if hybrid:
            net.hybridize()
        runs.append(_train(tmx, net, _batches(3, seed=2), feed))
    (l0, a0) = runs[0]
    for losses, after in runs[1:]:
        np.testing.assert_allclose(losses, l0, rtol=0, atol=PORT_TOL)
        for got, want in zip(after, a0):
            for name in want:
                for x, y in zip(got[name], want[name]):
                    np.testing.assert_allclose(x, y, rtol=0, atol=PORT_TOL,
                                               err_msg=name)


# -- the post-LN stack: the symbolic route -------------------------------------

def _post_ln_class(mx):
    class PostLN(mx.gluon.HybridBlock):
        """LayerNorm(x + fc2(gelu(fc1(x)))), in_units deferred."""

        def __init__(self, units, hidden, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc1 = mx.gluon.nn.Dense(hidden, flatten=False)
                self.fc2 = mx.gluon.nn.Dense(units, flatten=False)
                self.ln = mx.gluon.nn.LayerNorm()

        def hybrid_forward(self, F, x):
            h = self.fc2(F.Activation(self.fc1(x), act_type="gelu"))
            return self.ln(x + h)
    return PostLN


def _post_ln_stack(mx, prefix, layers=3):
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    cls = _post_ln_class(mx)
    with net.name_scope():
        for _ in range(layers):
            net.add(cls(8, 16))
    net.initialize(ctx=mx.cpu())
    return net


def test_post_ln_stack_report_and_route_match_reference():
    """Hybridized, the stack traces symbolically: the pass report's counts
    equal the reference's (3 LayerNorm-residual fusions), the rewritten
    graph's output and gradients equal the eager run's and the
    reference's."""
    x = np.random.RandomState(3).randn(4, 5, 8).astype(np.float32)
    theirs = _post_ln_stack(jmx, "postln_")
    ours = _post_ln_stack(tmx, "postln_")
    theirs(jmx.nd.array(x))
    eager_in = tmx.nd.array(x, ctx=CPU)
    ours(eager_in)
    rng = np.random.RandomState(4)
    for name, jp in theirs.collect_params().items():
        a = rng.uniform(-0.5, 0.5, jp.shape).astype(np.float32)
        jp.set_data(jmx.nd.array(a))
        ours.collect_params()[name].set_data(a)

    def run(mx, net):
        arr = mx.nd.array(x, ctx=mx.cpu())
        with mx.autograd.record():
            y = net(arr)
        y.backward()
        return y.asnumpy(), {n: p.grad().asnumpy()
                             for n, p in net.collect_params().items()}
    eager = run(tmx, ours)
    ours.hybridize()
    theirs.hybridize()
    hybrid, want = run(tmx, ours), run(jmx, theirs)
    got_r, want_r = ours._cached_graph_report, theirs._cached_graph_report
    assert got_r["rewrites"] == want_r["rewrites"]
    assert got_r["rewrites"]["layer_norm_residual"] == 3
    for k in ("nodes_before", "ops_before", "nodes_after", "ops_after"):
        assert got_r[k] == want_r[k], k
    assert ours._cached_op.plan is not None
    for other in (eager, want):
        np.testing.assert_allclose(hybrid[0], other[0], rtol=TOL, atol=TOL)
        for n in other[1]:
            np.testing.assert_allclose(hybrid[1][n], other[1][n], rtol=TOL,
                                       atol=TOL, err_msg=n)


def test_symbolic_route_writes_batchnorm_stats_back():
    """Dense -> BatchNorm hybridized traces symbolically; a training
    forward writes the moving statistics back into the aux parameters,
    as the reference's CachedOp does."""
    x = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    nets = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential(prefix="bnsym_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(3, in_units=4),
                    mx.gluon.nn.BatchNorm(in_channels=3))
        net.initialize(ctx=mx.cpu())
        nets.append(net)
    theirs, ours = nets
    for name, jp in theirs.collect_params().items():
        ours.collect_params()[name].set_data(jp.data().asnumpy())
    for mx, net in ((jmx, theirs), (tmx, ours)):
        net.hybridize()
        with mx.autograd.record():
            net(mx.nd.array(x, ctx=mx.cpu()))
    assert ours._cached_op.plan is not None
    for name, jp in theirs.collect_params().items():
        np.testing.assert_allclose(
            ours.collect_params()[name].data().asnumpy(),
            jp.data().asnumpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert ours.collect_params()["bnsym_batchnorm0_running_mean"] \
        .data().asnumpy().any()


def test_aux_write_back_after_a_grad_req_change():
    """Dense -> BatchNorm hybridized and called once in training; gamma is
    then frozen (``grad_req="null"``) and the block called again: the new
    moving statistics go to the moving statistics and gamma keeps its
    value, as the reference's CachedOp, built on the first call's
    parameter list, gives."""
    xs = [np.random.RandomState(s).randn(6, 4).astype(np.float32)
          for s in (6, 7)]
    nets = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential(prefix="bnfreeze_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(3, in_units=4),
                    mx.gluon.nn.BatchNorm(in_channels=3))
        net.initialize(ctx=mx.cpu())
        net.hybridize()
        nets.append(net)
    theirs, ours = nets
    for name, jp in theirs.collect_params().items():
        ours.collect_params()[name].set_data(jp.data().asnumpy())
    for mx, net in ((jmx, theirs), (tmx, ours)):
        for i, x in enumerate(xs):
            if i:
                net.collect_params()["bnfreeze_batchnorm0_gamma"] \
                    .grad_req = "null"
            with mx.autograd.record():
                net(mx.nd.array(x, ctx=mx.cpu()))
    assert ours._cached_op.plan is not None
    for name, jp in theirs.collect_params().items():
        np.testing.assert_allclose(
            ours.collect_params()[name].data().asnumpy(),
            jp.data().asnumpy(), rtol=TOL, atol=TOL, err_msg=name)


# -- utilities and data ---------------------------------------------------------

@pytest.mark.parametrize("even", [True, False])
def test_split_and_load_and_clip_global_norm(even):
    x = np.arange(30.0, dtype=np.float32).reshape(10 if not even else 6, -1)
    if not even:
        x = np.arange(30.0, dtype=np.float32).reshape(10, 3)
    outs = [mx.gluon.utils.split_and_load(x, [mx.cpu(0)] * 4 if not even
                                          else [mx.cpu(0)] * 3,
                                          even_split=even)
            for mx in (jmx, tmx)]
    assert [o.shape for o in outs[0]] == [o.shape for o in outs[1]]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    if even:
        with pytest.raises(ValueError):
            tmx.gluon.utils.split_data(tmx.nd.array(x[:5], ctx=CPU), 3)
    arrays = [np.random.RandomState(i).randn(3, 4).astype(np.float32)
              for i in range(3)]
    norms, clipped = [], []
    for mx in (jmx, tmx):
        arrs = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
        norms.append(mx.gluon.utils.clip_global_norm(arrs, 1.5))
        clipped.append([a.asnumpy() for a in arrs])
    assert math.isclose(norms[1], norms[0], rel_tol=1e-6)
    for a, b in zip(*clipped):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_reference(last_batch):
    """Sequential batches equal the reference's; a shuffled pass (numpy's
    generator, as the reference's) is pinned by ``np.random.seed``; the
    prefetching iterator gives the same batches as ``prefetch=0``."""
    data = np.arange(22.0, dtype=np.float32).reshape(11, 2)
    label = np.arange(11, dtype=np.int32)
    loaders = [mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(data, label), batch_size=3,
        last_batch=last_batch) for mx in (jmx, tmx)]
    n = len(loaders[1])         # rollover: the length counts the carry
    with tmx.cpu():
        got = [[b.asnumpy() for b in batch] for batch in loaders[1]]
        again = [[b.asnumpy() for b in batch] for batch in
                 tmx.gluon.data.DataLoader(
                     tmx.gluon.data.ArrayDataset(data, label),
                     batch_size=3, last_batch=last_batch, prefetch=0)]
    want = [[b.asnumpy() for b in batch] for batch in loaders[0]]
    assert len(got) == len(want) == n
    for g, a, w in zip(got, again, want):
        for x, y, z in zip(g, a, w):
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(y, z)
    orders = []
    for mx in (jmx, tmx, tmx):
        np.random.seed(7)
        orders.append(list(mx.gluon.data.RandomSampler(11)))
    assert orders[1] == orders[2] == orders[0]
    assert sorted(orders[1]) == list(range(11))


def test_dataloader_reraises_worker_errors_and_stacks_ndarrays():
    def bad(x):
        raise KeyError("sample")
    ds = tmx.gluon.data.SimpleDataset([1.0, 2.0]).transform(bad)
    with tmx.cpu():
        with pytest.raises(KeyError, match="sample"):
            list(tmx.gluon.data.DataLoader(ds, batch_size=1))
        nd_ds = tmx.gluon.data.SimpleDataset(
            [tmx.nd.array([float(i), 1.0]) for i in range(4)])
        batches = list(tmx.gluon.data.DataLoader(nd_ds, batch_size=2))
    np.testing.assert_array_equal(batches[1].asnumpy(),
                                  [[2.0, 1.0], [3.0, 1.0]])
