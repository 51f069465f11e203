"""The port's single-process ``mx.kv`` (``mxnet_tpu_torch/kvstore.py``) and
the Module's kvstore path (``model.py``, ``module/module.py``) against the
JAX package's.

- The store: ``create``'s names and errors, ``init``/``push`` of one value
  and of a list (summed)/``pull``, with and without ``set_optimizer``,
  against the reference's store on the same numpy values; the values
  agree within 1e-6 (the same float32 sums and SGD arithmetic).
- The torch meaning of ``pull`` (a law of the port, CHANGES.md): a copy
  into each output, never an alias of the store; a pulled array written
  afterwards leaves the store as it was.
- ``train_imagenet.py``'s path at a CPU size: the CIFAR form of
  ``symbols/resnet.py`` (``get_symbol(10, 8, "3,28,28")``, ResNet-8),
  batch 8, 2 batches, ``Module.fit(kvstore=kv.create("device"))`` with
  the example's SGD (momentum 0.9, wd 1e-4) in both packages from the same
  weights, which the JAX Module initializes (Xavier, as the example) and
  saves as a V2 ``.params`` file that the port reads.  Parameters and aux
  states after ``fit`` agree within 1e-4 abs and rel (convolution sums in
  another order, carried through two SGD steps and the BatchNorm
  statistics).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

import chip_smoke

TOL = 1e-6
FIT_TOL = 1e-4
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
       "rescale_grad": 0.5}


def _jmx():
    import mxnet_tpu
    return mxnet_tpu


def _nd(mx, a):
    if mx is tmx:
        return tmx.nd.array(a, ctx=tmx.cpu())
    return mx.nd.array(a)


@pytest.mark.parametrize("name", ["local", "device", "local_allreduce_device",
                                  "local_allreduce_cpu"])
def test_create_single_process_kinds(name):
    kv = tmx.kv.create(name)
    assert isinstance(kv, tmx.kvstore.KVStore)
    assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
    assert tmx.kvstore is tmx.kv
    kv.barrier()


def test_create_errors_match_reference():
    jmx = _jmx()
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError, match="unknown KVStore type bogus"):
            mx.kv.create("bogus")
        with pytest.raises(TypeError):
            mx.kv.create(3)


@pytest.mark.parametrize("name", ["dist_sync", "dist_async",
                                  "dist_device_sync", "dist_sync_device"])
def test_dist_kinds_raise(name, monkeypatch):
    """Without a coordinator each ``dist*`` kind is a world of one, as the
    reference's: rank 0, one worker, and its push and pull (two values
    summed into the store, no updater) pull what the reference's pull."""
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    pulled = []
    for mx in (_jmx(), tmx):
        kv = mx.kv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        kv.init("k", _nd(mx, np.ones(4, np.float32)))
        kv.push("k", [_nd(mx, np.full(4, 2.0, np.float32)),
                      _nd(mx, np.full(4, 0.5, np.float32))])
        out = _nd(mx, np.zeros(4, np.float32))
        kv.pull("k", out=out)
        kv.barrier()
        pulled.append(out.asnumpy())
    np.testing.assert_array_equal(pulled[1], pulled[0])


def test_s5_methods_raise():
    """``set_gradient_compression`` works (2-bit, as the reference's; its
    parity is ``tests/test_torch_gradient_compression.py``); only
    ``row_sparse_pull`` still refuses, naming the sparse slice (S6)."""
    kv = tmx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit"})
    assert kv._compressor.type == "2bit" and kv._compressor.threshold == 0.5
    with pytest.raises(tmx.MXNetError, match="S6"):
        kv.row_sparse_pull("w", out=_nd(tmx, np.zeros(3)), row_ids=None)


def _store_rounds(mx, with_optimizer):
    """init, then three rounds of a list push and a pull; returns every
    pulled value as numpy."""
    r = np.random.RandomState(0)
    w = {"w": r.randn(4, 3).astype(np.float32),
         3: r.randn(5).astype(np.float32)}
    kv = mx.kv.create("device")
    kv.init(list(w), [_nd(mx, v) for v in w.values()])
    if with_optimizer:
        kv.set_optimizer(mx.optimizer.create("sgd", **SGD))
    pulled = []
    for step in range(3):
        grads = [[_nd(mx, r.randn(*v.shape).astype(np.float32))
                  for _ in range(2)] for v in w.values()]
        kv.push(list(w), grads)
        outs = [[_nd(mx, np.zeros(v.shape, np.float32)) for _ in range(2)]
                for v in w.values()]
        kv.pull(list(w), out=outs)
        single = _nd(mx, np.zeros(w["w"].shape, np.float32))
        kv.pull("w", out=single)
        pulled += [o.asnumpy() for olist in outs for o in olist]
        pulled.append(single.asnumpy())
    return pulled


@pytest.mark.parametrize("with_optimizer", [False, True],
                         ids=["store", "update-on-kvstore"])
def test_init_push_pull_match_reference(with_optimizer):
    want = _store_rounds(_jmx(), with_optimizer)
    got = _store_rounds(tmx, with_optimizer)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_push_uninitialized_key_raises():
    for mx in (_jmx(), tmx):
        kv = mx.kv.create("local")
        with pytest.raises(mx.MXNetError, match="not initialized"):
            kv.push("missing", _nd(mx, np.zeros(2)))
        with pytest.raises(mx.MXNetError, match="not initialized"):
            kv.pull("missing", out=_nd(mx, np.zeros(2)))


@pytest.mark.parametrize("with_optimizer", [False, True],
                         ids=["store", "update-on-kvstore"])
def test_pull_copies_never_aliases(with_optimizer):
    """The port's law: ``pull`` copies into the output.  Writing the
    pulled array, or the pushed gradient, leaves the store as it was."""
    kv = tmx.kv.create("device")
    kv.init("w", _nd(tmx, np.ones((2, 3), np.float32)))
    if with_optimizer:
        kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.5))
    g = _nd(tmx, np.full((2, 3), 2.0, np.float32))
    kv.push("w", g)
    out = _nd(tmx, np.zeros((2, 3), np.float32))
    kv.pull("w", out=out)
    stored = kv._store["w"].data
    assert out.data.data_ptr() != stored.data_ptr()
    assert stored.data_ptr() != g.data.data_ptr()
    before = stored.clone()
    out[:] = 7.0
    g[:] = -5.0
    assert torch.equal(kv._store["w"].data, before)
    again = _nd(tmx, np.zeros((2, 3), np.float32))
    kv.pull("w", out=again)
    assert torch.equal(again.data, before)


def test_optimizer_states_round_trip(tmp_path):
    """Save the store's updater state, keep updating, reload it: the
    reloaded store repeats the same updates."""
    def store():
        kv = tmx.kv.create("local")
        kv.init("w", _nd(tmx, np.ones(4, np.float32)))
        kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
        return kv

    def step(kv, v):
        kv.push("w", _nd(tmx, np.full(4, v, np.float32)))
        out = _nd(tmx, np.zeros(4, np.float32))
        kv.pull("w", out=out)
        return out.asnumpy()

    kv = store()
    step(kv, 1.0)
    path = str(tmp_path / "kv.states")
    kv.save_optimizer_states(path)
    saved_w = kv._store["w"].data.clone()
    first = [step(kv, v) for v in (2.0, 3.0)]
    kv2 = store()
    kv2._store["w"]._assign(saved_w)
    kv2.load_optimizer_states(path)
    again = [step(kv2, v) for v in (2.0, 3.0)]
    for a, b in zip(again, first):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(tmx.MXNetError, match="no updater"):
        tmx.kv.create("local").save_optimizer_states(path)


def test_create_kvstore_decisions_match_reference():
    from mxnet_tpu import model as jmodel
    from mxnet_tpu_torch import model as tmodel
    small = {"w": np.zeros(10, np.float32)}
    big = {"w": np.zeros(1024 * 1024 * 16 + 1, np.float32)}
    for mx, model in ((_jmx(), jmodel), (tmx, tmodel)):
        arrays = {k: _nd(mx, v) for k, v in small.items()}
        assert model._create_kvstore(None, 1, arrays) == (None, False)
        assert model._create_kvstore("local", 1, arrays) == (None, False)
        kv = mx.kv.create("device")
        assert model._create_kvstore(kv, 1, arrays) == (kv, True)
        kv2, upd = model._create_kvstore("local", 2, arrays)
        assert kv2.type == "local" and upd
        with pytest.raises(TypeError):
            model._create_kvstore(3, 1, arrays)
    # above 16 Mi elements a "local" store aggregates only
    kv3, upd = tmodel._create_kvstore(
        "local", 2, {k: tmx.nd.array(v, ctx=tmx.cpu())
                     for k, v in big.items()})
    assert kv3.type == "local" and not upd


def test_update_params_through_a_store_without_updater():
    """``update_on_kvstore`` False: the store sums the gradients, they are
    pulled back into the gradient arrays and the Updater applies them."""
    from mxnet_tpu_torch import model as tmodel
    kv = tmx.kv.create("local")
    w = [[_nd(tmx, np.ones(3, np.float32)), _nd(tmx, np.ones(3, np.float32))]]
    g = [[_nd(tmx, np.full(3, 1.0, np.float32)),
          _nd(tmx, np.full(3, 2.0, np.float32))]]
    tmodel._initialize_kvstore(kv, w, {"p": w[0][0]}, ["p"], False)
    updater = tmx.optimizer.get_updater(
        tmx.optimizer.create("sgd", learning_rate=0.1))
    tmodel._update_params(w, g, updater, 2, kvstore=kv, param_names=["p"])
    for arr in g[0]:
        np.testing.assert_array_equal(arr.asnumpy(), 3.0)
    for arr in w[0]:
        np.testing.assert_allclose(arr.asnumpy(), 0.7, rtol=1e-6)


# -- train_imagenet.py's Module loop, ResNet-8 -------------------------------

RESNET8 = (10, 8, "3,28,28")
FIT_B, FIT_N = 8, 16


def _resnet8_setup(tmp_path):
    """The JAX Module's Xavier weights, written as V2 ``.params``; the
    batches; both symbols."""
    import importlib.util
    jmx = _jmx()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "image-classification",
        "symbols", "resnet.py")
    spec = importlib.util.spec_from_file_location("_resnet_kv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jsym = mod.get_symbol(*RESNET8)
    tsym = chip_smoke.resnet_symbol(tmx, *RESNET8)
    r = np.random.RandomState(3)
    x = r.uniform(-1, 1, (FIT_N, 3, 28, 28)).astype(np.float32)
    y = r.randint(0, 10, FIT_N).astype(np.float32)
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (FIT_B, 3, 28, 28))],
              label_shapes=[("softmax_label", (FIT_B,))])
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    args, auxs = jmod.get_params()
    # moving statistics away from 0/1, so the aux write-back shows
    auxs = {k: jmx.nd.array(v.asnumpy() + (0.1 if k.endswith("mean")
                                           else 0.5)) for k, v in auxs.items()}
    prefix = str(tmp_path / "resnet8")
    jmx.nd.save("%s-0000.params" % prefix,
                dict([("arg:" + k, v) for k, v in args.items()] +
                     [("aux:" + k, v) for k, v in auxs.items()]))
    return jsym, tsym, x, y, prefix


def _fit_resnet8(mx, sym, x, y, prefix, kv_name="device"):
    arg_params, aux_params = mx.model.load_params(prefix, 0)
    kw = {"context": mx.cpu()}
    mod = mx.mod.Module(sym, **kw)
    acc = mx.metric.Accuracy()
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=FIT_B), eval_metric=acc,
            kvstore=mx.kv.create(kv_name), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params=arg_params, aux_params=aux_params, num_epoch=1)
    args, auxs = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}, \
        {k: v.asnumpy() for k, v in auxs.items()}


def test_module_fit_resnet8_device_kvstore_matches_reference(tmp_path):
    jsym, tsym, x, y, prefix = _resnet8_setup(tmp_path)
    _, jargs, jauxs = _fit_resnet8(_jmx(), jsym, x, y, prefix)
    tmod, targs, tauxs = _fit_resnet8(tmx, tsym, x, y, prefix)
    assert tmod._update_on_kvstore and tmod._updater is None
    assert not tmod._fused.active
    from mxnet_tpu import graph as jgraph
    assert tmod.graph_report["rewrites"] == \
        jgraph.optimize(jsym)[1]["rewrites"]
    assert sorted(targs) == sorted(jargs) and sorted(tauxs) == sorted(jauxs)
    init_args, init_auxs = tmx.model.load_params(prefix, 0)
    for k in jargs:
        np.testing.assert_allclose(targs[k], jargs[k], rtol=FIT_TOL,
                                   atol=FIT_TOL, err_msg=k)
        if not k.startswith("bn_data_gamma"):   # fix_gamma: wd only
            assert not np.array_equal(targs[k], init_args[k].asnumpy()), k
    for k in jauxs:
        np.testing.assert_allclose(tauxs[k], jauxs[k], rtol=FIT_TOL,
                                   atol=FIT_TOL, err_msg=k)
        assert not np.array_equal(tauxs[k], init_auxs[k].asnumpy()), k


def test_module_kvstore_optimizer_states_go_through_the_store(tmp_path):
    _, tsym, x, y, prefix = _resnet8_setup(tmp_path)
    mod, _, _ = _fit_resnet8(tmx, tsym, x, y, prefix)
    path = str(tmp_path / "mod.states")
    mod.save_optimizer_states(path)
    states = mod._kvstore._updater.states
    assert set(states) == set(mod._param_names)
    # the reference's checksummed frame around the store's payload
    from mxnet_tpu_torch.checkpoint import _frame_state
    with open(path, "rb") as f:
        assert f.read() == _frame_state(mod._optimizer_states_bytes())
    saved = {k: v.clone() for k, v in states.items() if v is not None}
    for v in states.values():
        if v is not None:
            v.zero_()
    mod.load_optimizer_states(path)
    for k, v in saved.items():
        assert torch.equal(mod._kvstore._updater.states[k], v)
