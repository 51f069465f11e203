"""Gluon over a context list in the port against the JAX package's.

- ``Parameter.initialize(ctx=[8 contexts])``: ``list_ctx`` names the
  contexts, ``list_data``/``list_grad`` hold the one leaf and its one
  summed gradient (the reference's ``[data()]``/``[grad()]``); duplicate
  contexts raise.
- ``split_and_load`` and ``shard_and_load`` against the reference's: the
  same slices, the same whole batch; an indivisible batch raises in both.
- 15 ``Trainer.step``s of a two-layer net from the same numpy-seeded
  weights: the reference feeds ``shard_and_load`` batches to its SPMD
  program over 8 virtual devices; the port runs both feeds
  (``shard_and_load``: one forward; ``split_and_load``: one forward a
  replica, the gradients summed into the one buffer).  Parameters within
  1e-5 of the reference's, with SGD and with Adam under ``MXTPU_ZERO=1``
  (state held as 8 slices where a dimension divides).
- ``Trainer(kvstore="dist_sync")`` in a world of one process updates on
  the store, as the reference's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

TOL = 1e-5
N_CTX = 8


def _jmx():
    import mxnet_tpu
    return mxnet_tpu


def _problem(n=128, d=10, k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    return X, (X @ W).argmax(1).astype(np.float32)


def _weights(seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((32, 10)) * 0.3).astype(np.float32),
            np.zeros(32, np.float32),
            (rng.standard_normal((2, 32)) * 0.3).astype(np.float32),
            np.zeros(2, np.float32)]


def _net(mx, ctx, prefix):
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, activation="relu", in_units=10))
        net.add(mx.gluon.nn.Dense(2, in_units=32))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    for p, w in zip(net.collect_params().values(), _weights()):
        if mx is tmx:
            p.set_data(mx.nd.array(w, ctx=ctx[0]))
        else:
            # the reference's own replication over the contexts' mesh
            from mxnet_tpu.gluon.parameter import _replicate_over
            p.set_data(mx.nd.array(w))
            p.data()._set_data(_replicate_over(ctx, p.data()._data))
    return net


def _train(mx, ctx, prefix, feed, opt="sgd", lr=0.5, steps=15):
    X, Y = _problem()
    net = _net(mx, ctx, prefix)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), opt,
                               {"learning_rate": lr})
    for _ in range(steps):
        if feed == "split":
            xs = mx.gluon.utils.split_and_load(X, ctx)
            ys = mx.gluon.utils.split_and_load(Y, ctx)
        else:
            xs = [mx.gluon.utils.shard_and_load(X, ctx)]
            ys = [mx.gluon.utils.shard_and_load(Y, ctx)]
        with mx.autograd.record():
            losses = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
        mx.autograd.backward(losses)
        trainer.step(X.shape[0])
    return [p.data().asnumpy() for p in net.collect_params().values()], \
        trainer


def test_initialize_on_a_context_list():
    ctx = [tmx.cpu(i) for i in range(N_CTX)]
    net = _net(tmx, ctx, "mctx_init_")
    for p in net.collect_params().values():
        assert p.list_ctx() == ctx
        assert len(p.list_data()) == 1 and p.list_data()[0] is p.data()
        assert len(p.list_grad()) == 1 and p.list_grad()[0] is p.grad()
        assert p.data(ctx[3]) is p.data()      # one device: the leaf
    p = tmx.gluon.Parameter("dup_weight", shape=(2, 2))
    with pytest.raises(tmx.base.MXNetError, match="duplicate"):
        p.initialize(ctx=[tmx.cpu(0), tmx.cpu(0)])


def test_split_and_shard_and_load_match_reference():
    jmx = _jmx()
    X, _ = _problem()
    jctx = [jmx.cpu(i) for i in range(N_CTX)]
    tctx = [tmx.cpu(i) for i in range(N_CTX)]
    js = jmx.gluon.utils.split_and_load(X, jctx)
    ts = tmx.gluon.utils.split_and_load(X, tctx)
    assert len(js) == len(ts) == N_CTX
    for j, t in zip(js, ts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    whole = tmx.gluon.utils.shard_and_load(X, tctx)
    np.testing.assert_array_equal(
        whole.asnumpy(), jmx.gluon.utils.shard_and_load(X, jctx).asnumpy())
    assert whole.context == tctx[0]
    for mx, ctx in ((jmx, jctx), (tmx, tctx)):
        with pytest.raises(ValueError, match="divisible"):
            mx.gluon.utils.shard_and_load(X[:60], ctx)


@pytest.mark.parametrize("feed", ["shard", "split"])
def test_trainer_steps_match_reference(feed):
    jmx = _jmx()
    want, _ = _train(jmx, [jmx.cpu(i) for i in range(N_CTX)],
                     "mctx_ref_%s_" % feed, "shard")
    got, _ = _train(tmx, [tmx.cpu(i) for i in range(N_CTX)],
                    "mctx_port_%s_" % feed, feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_zero1_trainer_matches_reference(monkeypatch):
    jmx = _jmx()
    monkeypatch.setenv("MXTPU_ZERO", "1")
    want, _ = _train(jmx, [jmx.cpu(i) for i in range(N_CTX)],
                     "mctx_zref_", "shard", opt="adam", lr=0.05)
    got, trainer = _train(tmx, [tmx.cpu(i) for i in range(N_CTX)],
                          "mctx_zport_", "shard", opt="adam", lr=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    dims, reps = trainer._fused.zero
    assert dims == {"0": 0, "1": 0, "2": 1, "3": None} and len(reps) == 8
    assert len(trainer._fused.state["0"]) == N_CTX


def test_dist_sync_trainer_in_a_world_of_one():
    ctx = [tmx.cpu(0)]
    net = _net(tmx, ctx, "mctx_dist_")
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1.0}, kvstore="dist_sync",
                                compression_params={"type": "2bit",
                                                    "threshold": 0.5})
    for p in net.collect_params().values():
        p.grad()[:] = 0.75
    before = [p.data().asnumpy().copy() for p in net.collect_params().values()]
    trainer.step(1)
    assert trainer._kv.type == "dist_sync" and trainer._update_on_kvstore
    assert trainer._kv.num_workers == 1
    for b, p in zip(before, net.collect_params().values()):
        # 0.75 quantizes to 0.5, the residual keeps 0.25
        np.testing.assert_allclose(p.data().asnumpy(), b - 0.5, rtol=1e-6)
