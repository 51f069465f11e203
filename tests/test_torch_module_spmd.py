"""``Module(context=[N devices])`` of the port against the JAX package's.

The reference runs one SPMD program over a dp mesh of 8 virtual CPU
devices; the port runs one replica a context (``executor.py``).  Both
must give one device's result on the whole batch:

- the reference's ``_mlp`` (``tests/test_module_spmd.py``), 3 epochs of
  ``Module.fit`` with ``kvstore="device"`` (SGD, momentum 0.9), from the
  same numpy-seeded weights: parameters within 2e-5 of the reference's
  8-device Module (and of the port's one-device Module);
- a small conv + ``BatchNorm`` net whose loss head normalizes by the batch
  (``"batch"``, ``"valid"``, ``"null"``): per-replica statistics or a
  per-replica normalization would be off by far more; parameters and
  BatchNorm's moving statistics within 2e-5 of the reference's;
- loss heads that fold the batch (``MakeLoss`` of a mean over all axes,
  of a sum over the batch axis): the outputs keep the reference's shape
  and the parameters stay within 2e-5 of the reference's 8-device Module
  and of the port's one-device Module; a ``monitor_all`` monitor sees
  each node's whole-batch outputs;
- a batch that does not divide and duplicate contexts raise
  ``MXNetError`` in both packages; ``grad_req="add"`` doubles; prediction
  keeps the whole batch; partition rules resolve the reference's specs;
- ZeRO-1 (``MXTPU_ZERO=1``): 10 fused steps equal ZeRO-0's (SGD with
  momentum and Adam; the same elementwise arithmetic on slices), match
  the reference's ZeRO-1 within 2e-5, hold the state as 8 slices (the
  indivisible bias whole), and the ``sharding.*`` gauges equal the
  reference's: the state a replica holds is 1/8 of the sharded leaves
  (``sharding.collective_bytes_per_step`` is the ring model here: there
  is no compiled program whose collectives the reference measures).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

TOL = 2e-5
N_CTX = 8


def _jmx():
    import mxnet_tpu
    return mxnet_tpu


def _problem(n=256, d=16, k=4, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    return X, (X @ W).argmax(1).astype(np.float32)


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _conv_bn(mx, normalization):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv1")
    net = mx.sym.BatchNorm(net, name="bn1", fix_gamma=False)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(1, 1), global_pool=True,
                         pool_type="avg")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax", use_ignore=True,
                                ignore_label=3,
                                normalization=normalization)


def _images(n=64, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3, 8, 8).astype(np.float32)
    Y = (X.mean(axis=(1, 2, 3)) * 40 % 4).astype(np.int64) % 4
    return X, Y.astype(np.float32)


def _weights(sym, shapes, seed=0):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    args, aux = {}, {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            args[name] = np.ones(s, np.float32)
        elif name.endswith(("_bias", "_beta")):
            args[name] = np.zeros(s, np.float32)
        else:
            args[name] = (rng.standard_normal(s) * 0.3).astype(np.float32)
    for name, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = np.ones(s, np.float32) if name.endswith("_var") \
            else np.zeros(s, np.float32)
    return args, aux


def _ctx(mx, n):
    return [mx.cpu(i) for i in range(n)] if n > 1 else mx.cpu(0)


def _fit(mx, n_ctx, sym_fn, X, Y, batch, epochs, kv="device",
         optimizer="sgd", opt_params=None):
    sym = sym_fn(mx)
    args, aux = _weights(sym, {"data": (batch,) + X.shape[1:],
                               "softmax_label": (batch,)})
    wrap = (lambda a: mx.nd.array(a)) if mx is not tmx else \
        (lambda a: tmx.nd.array(a, ctx=tmx.cpu()))
    mod = mx.mod.Module(sym, context=_ctx(mx, n_ctx))
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=batch),
            optimizer=optimizer, kvstore=kv,
            optimizer_params=opt_params or {"learning_rate": 0.5,
                                            "momentum": 0.9},
            arg_params={k: wrap(v) for k, v in args.items()},
            aux_params={k: wrap(v) for k, v in aux.items()},
            num_epoch=epochs)
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _close(got, want, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg="%s %s" % (what, k))


def test_mlp_context_list_matches_reference_and_one_device():
    X, Y = _problem()
    want, _ = _fit(_jmx(), N_CTX, _mlp, X, Y, 64, 3)
    got, _ = _fit(tmx, N_CTX, _mlp, X, Y, 64, 3)
    one, _ = _fit(tmx, 1, _mlp, X, Y, 64, 3)
    _close(got, want, "8 contexts vs reference")
    _close(got, one, "8 contexts vs one")


@pytest.mark.parametrize("normalization", ["batch", "valid", "null"])
def test_conv_bn_context_list_matches_reference(normalization):
    X, Y = _images()
    fn = lambda mx: _conv_bn(mx, normalization)  # noqa: E731
    want_a, want_x = _fit(_jmx(), N_CTX, fn, X, Y, 32, 2,
                          opt_params={"learning_rate": 0.1})
    got_a, got_x = _fit(tmx, N_CTX, fn, X, Y, 32, 2,
                        opt_params={"learning_rate": 0.1})
    _close(got_a, want_a, "params")
    _close(got_x, want_x, "moving statistics")


@pytest.mark.parametrize("passes", ["fuse,fold,cse,dce", "off"])
def test_sync_bn_keeps_each_replica_on_its_slice(monkeypatch, passes):
    """A training BatchNorm (fused into its convolution by the graph
    passes, or alone without them) sums its statistics across the
    replicas, and each replica convolves and normalizes its own slice:
    the replicas' path runs once a BatchNorm a step and matches one
    device."""
    from mxnet_tpu_torch.ops import fused, nn
    calls = []
    for mod, name in ((fused, "conv_bn_act_replicas"),
                      (nn, "batch_norm_replicas")):
        real = getattr(mod, name)

        def spy(datas, *a, _real=real, _name=name, **k):
            calls.append((_name, len(datas), tuple(datas[0].shape)))
            return _real(datas, *a, **k)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", passes)
    X, Y = _images()
    fn = lambda mx: _conv_bn(mx, "batch")  # noqa: E731
    got_a, got_x = _fit(tmx, N_CTX, fn, X, Y, 32, 1,
                        opt_params={"learning_rate": 0.1})
    want = "batch_norm_replicas" if passes == "off" else \
        "conv_bn_act_replicas"
    assert {c[0] for c in calls} == {want}
    assert len(calls) == len(X) // 32
    assert all(c[1] == N_CTX and c[2][0] == 32 // N_CTX for c in calls)
    one_a, one_x = _fit(tmx, 1, fn, X, Y, 32, 1,
                        opt_params={"learning_rate": 0.1})
    _close(got_a, one_a, "params, 8 contexts vs one")
    _close(got_x, one_x, "moving statistics, 8 contexts vs one")


def _folding_head(mx, head):
    data, label = mx.sym.Variable("data"), mx.sym.Variable("label")
    err = mx.sym.square(mx.sym.FullyConnected(data, num_hidden=4,
                                              name="fc1") - label)
    red = mx.sym.mean(err) if head == "mean" else mx.sym.sum(err, axis=0)
    return mx.sym.MakeLoss(red, name="loss")


def _fit_folding(mx, n_ctx, head, X, Y, batch=64):
    sym = _folding_head(mx, head)
    args, _ = _weights(sym, {"data": (batch,) + X.shape[1:],
                             "label": (batch,) + Y.shape[1:]})
    wrap = (lambda a: mx.nd.array(a)) if mx is not tmx else \
        (lambda a: tmx.nd.array(a, ctx=tmx.cpu()))
    mod = mx.mod.Module(sym, context=_ctx(mx, n_ctx), data_names=["data"],
                        label_names=["label"])
    it = mx.io.NDArrayIter(X, Y, batch_size=batch, label_name="label")
    mod.fit(it, optimizer="sgd", kvstore="device", eval_metric="loss",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: wrap(v) for k, v in args.items()}, num_epoch=2)
    it.reset()
    mod.forward(next(iter(it)), is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    a, _ = mod.get_params()
    return out, {k: v.asnumpy() for k, v in a.items()}


@pytest.mark.parametrize("head", ["mean", "sum0"])
def test_batch_folding_heads_match_reference_and_one_device(head):
    """A node that reduces over the batch runs whole: per replica, a mean
    would be 8 scalars (and 8 times the gradient) and a sum over axis 0
    eight rows where one device gives one."""
    X, _ = _problem(n=128)
    Y = np.random.RandomState(7).randn(128, 4).astype(np.float32)
    want_out, want = _fit_folding(_jmx(), N_CTX, head, X, Y)
    got_out, got = _fit_folding(tmx, N_CTX, head, X, Y)
    one_out, one = _fit_folding(tmx, 1, head, X, Y)
    assert got_out.shape == want_out.shape == one_out.shape == \
        (() if head == "mean" else (4,))
    np.testing.assert_allclose(got_out, want_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_out, one_out, rtol=TOL, atol=TOL)
    _close(got, want, "8 contexts vs reference")
    _close(got, one, "8 contexts vs one")


@pytest.mark.parametrize("passes", ["fuse,fold,cse,dce", "off"])
def test_monitor_all_taps_a_context_list(monkeypatch, passes):
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", passes)
    seen, sym = {}, _mlp(tmx)
    X, Y = _problem(n=64)
    for n in (N_CTX, 1):
        mod = tmx.mod.Module(sym, context=_ctx(tmx, n))
        it = tmx.io.NDArrayIter(X, Y, batch_size=64)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(tmx.init.Constant(0.1))
        seen[n] = {}
        mod._exec.set_monitor_callback(
            lambda name, arr, d=seen[n]: d.__setitem__(name, arr.asnumpy()),
            monitor_all=True)
        mod.forward(next(iter(it)), is_train=False)
    assert seen[N_CTX]["fc1_output"].shape == (64, 32)
    assert set(seen[N_CTX]) == set(seen[1])
    for k in seen[1]:
        np.testing.assert_allclose(seen[N_CTX][k], seen[1][k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def _bind(mx, ctx, batch=60, grad_req="write", **kw):
    mod = mx.mod.Module(_mlp(mx), context=ctx, **kw)
    X, Y = _problem(n=batch)
    it = mx.io.NDArrayIter(X, Y, batch_size=batch)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             grad_req=grad_req)
    return mod, it


def test_indivisible_batch_and_duplicate_contexts_raise():
    for mx in (_jmx(), tmx):
        with pytest.raises(mx.base.MXNetError, match="not divisible"):
            _bind(mx, [mx.cpu(i) for i in range(8)])
        with pytest.raises(mx.base.MXNetError, match="duplicate"):
            _bind(mx, [mx.cpu(0), mx.cpu(0)], batch=64)
    # gpu(i) must be distinct cards: the one funnel of a context list
    from mxnet_tpu_torch.parallel import dp_mesh_from_ctx
    with pytest.raises(tmx.base.MXNetError, match="duplicate"):
        dp_mesh_from_ctx([tmx.gpu(0), tmx.gpu(0)])


def test_grad_req_add_and_predict_keep_the_whole_batch():
    mod, it = _bind(tmx, [tmx.cpu(i) for i in range(8)], batch=64,
                    grad_req="add")
    mod.init_params(tmx.init.Xavier())
    batch = next(iter(it))
    mod.forward_backward(batch)
    g1 = mod._exec.grad_dict["fc1_weight"].asnumpy().copy()
    mod.forward_backward(batch)
    np.testing.assert_allclose(mod._exec.grad_dict["fc1_weight"].asnumpy(),
                               2 * g1, rtol=1e-5, atol=1e-6)
    X, _ = _problem()
    preds = mod.predict(tmx.io.NDArrayIter(X, None, batch_size=64))
    assert preds.shape == (256, 4)


def test_partition_rules_resolve_the_reference_specs():
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu_torch.parallel.sharding import P
    jmx = _jmx()
    specs = []
    for mx, p in ((jmx, JP), (tmx, P)):
        rules = [(r"fc\d_weight$", p("dp", None), 2),
                 (r"fc1_bias$", p("tp"), 1)]
        mod, _ = _bind(mx, [mx.cpu(i) for i in range(8)], batch=64,
                       partition_rules=rules)
        specs.append({n: tuple(mod._exec.param_spec(n))
                      for n in ("fc1_weight", "fc2_weight", "fc1_bias",
                                "data", "softmax_label")})
    assert specs[1] == specs[0]
    assert specs[1]["fc1_weight"] == ("dp", None)


def _fit_steps(mx, ctx, optimizer, opt_params, steps=10):
    X, Y = _problem()
    sym = _mlp(mx)
    args, aux = _weights(sym, {"data": (64, 16), "softmax_label": (64,)})
    wrap = (lambda a: mx.nd.array(a)) if mx is not tmx else \
        (lambda a: tmx.nd.array(a, ctx=tmx.cpu()))
    train = mx.io.NDArrayIter(X, Y, batch_size=64)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params(arg_params={k: wrap(v) for k, v in args.items()},
                    aux_params=aux)
    mod.init_optimizer(kvstore=None, optimizer=optimizer,
                       optimizer_params=opt_params)
    batches = list(train)
    for i in range(steps):
        mod.fit_step(batches[i % len(batches)])
    a, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in a.items()}


def _gauges(tel):
    g = tel.report()["gauges"]
    return {k: g.get(k) for k in ("sharding.opt_state_bytes_per_device",
                                  "sharding.collective_bytes_modeled",
                                  "sharding.zero_stage")}


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.05})])
def test_zero1_matches_zero0_and_the_reference(monkeypatch, optimizer,
                                               opt_params):
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as ttel
    jmx = _jmx()
    ctx = [tmx.cpu(i) for i in range(N_CTX)]
    _, zero0 = _fit_steps(tmx, ctx, optimizer, opt_params)
    monkeypatch.setenv("MXTPU_ZERO", "1")
    mod, zero1 = _fit_steps(tmx, ctx, optimizer, opt_params)
    tg = _gauges(ttel)
    _, want = _fit_steps(jmx, [jmx.cpu(i) for i in range(N_CTX)],
                         optimizer, opt_params)
    jg = _gauges(jtel)
    for k in zero0:
        np.testing.assert_array_equal(zero1[k], zero0[k], err_msg=k)
    _close(zero1, want, "ZeRO-1 vs reference")
    # the state as slices: fc1_weight (32, 16) 8 x (4, 16), fc2_weight
    # (4, 32) on its second dim, the (4,) bias whole
    st = mod._fused.state
    assert mod._fused.zero[0] == {"fc1_weight": 0, "fc1_bias": 0,
                                  "fc2_weight": 1, "fc2_bias": None}
    first = st["fc1_weight"][0]
    first = first if isinstance(first, torch.Tensor) else first[0]
    assert len(st["fc1_weight"]) == N_CTX and tuple(first.shape) == (4, 16)
    assert tg == jg and tg["sharding.zero_stage"] == 1
    # no compiled program to measure: the per-step gauge is the ring model
    assert ttel.report()["gauges"]["sharding.collective_bytes_per_step"] \
        == tg["sharding.collective_bytes_modeled"]
    full = sum(4 * int(np.prod(v.shape)) for v in zero1.values()) * \
        (2 if optimizer == "adam" else 1)
    assert tg["sharding.opt_state_bytes_per_device"] < full / 4


def test_dist_sync_rescale_counts_the_workers():
    """``init_optimizer``'s default ``rescale_grad``: ``1 / batch`` times
    the workers of a ``dist*_sync`` store (a world of one here)."""
    mod, _ = _bind(tmx, tmx.cpu(0), batch=64)
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(kvstore=tmx.kv.create("dist_sync"), optimizer="sgd")
    assert mod._optimizer.rescale_grad == pytest.approx(1.0 / 64)
    assert mod._kvstore.num_workers == 1 and mod._update_on_kvstore
