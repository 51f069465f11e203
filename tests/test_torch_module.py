"""The port's ``mx.mod.Module`` against the JAX package's, and the laws of
the fused, guarded fit step.

Parity: both packages' ``Module.fit`` on the same symbol, weights (numpy,
seeded) and batches: ``tests/test_fused_step.py``'s MLP with distinct
lr/wd multipliers on its variables, and ``chip_smoke.build_gpt_sym`` at 2
layers x 64 units, 4 heads, seq 16, vocab 128; SGD, SGD with momentum and
Adam over 2 epochs (Adam at lr 1e-2 on the MLP, 1e-3 on the GPT, the
order of a transformer's: Adam divides each gradient element by its own
magnitude, so an element whose gradient is at float32 rounding noise in
both packages, as a few of the positional embedding's are, moves by
about lr either way; at 1e-2 one element of wpe's 1024 moved 1.9e-5).
Tolerances: every parameter within 1e-5 + 1e-4·|p| (the reference's own
fused/unfused tolerance; float32 sums in another order), every per-batch
metric value within a relative 1e-5.

Within the port (CPU, the same float32 ops in the same order): the fused
step equals the split path (``forward_backward`` + ``update``) exactly,
state moves between them both ways, a non-finite batch leaves every
parameter and optimizer state bit for bit as it was and rewinds the
clocks, and ``MXTPU_MAX_CONSECUTIVE_SKIPS`` consecutive skips raise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
import chip_smoke

PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
METRIC_RTOL = 1e-5

OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    "sgd_mom": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                        "wd": 0.01}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01}),
}
MULTS = {"fc1_weight": (0.5, 2.0), "fc1_bias": (1.5, 0.0),
         "fc2_weight": (2.0, 0.5), "fc2_bias": (0.7, 0.0)}
N, D, K, BATCH = 128, 10, 3, 32
L, U, H, T, V = 2, 64, 4, 16, 128
GPT_N, GPT_B = 8, 4
GPT_ADAM_LR = 1e-3


def _mlp_sym(mx):
    """test_fused_step's MLP, its multipliers on the variables."""
    def var(name):
        lm, wm = MULTS[name]
        return mx.sym.Variable(name, lr_mult=lm, wd_mult=wm)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, weight=var("fc1_weight"),
                                bias=var("fc1_bias"), num_hidden=16,
                                name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, weight=var("fc2_weight"),
                                bias=var("fc2_bias"), num_hidden=K,
                                name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _mlp_data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, D).astype(np.float32)
    w = rs.randn(D, K).astype(np.float32)
    return x, (x @ w).argmax(axis=1).astype(np.float32)


def _gpt_data(seed=1):
    toks = np.random.RandomState(seed).randint(0, V, (GPT_N, T + 1))
    return toks[:, :-1].astype(np.float32), toks[:, 1:].astype(np.float32)


def _init_params(sym, shapes, seed):
    """Seeded weights by name: normal(0, 0.02) (0.3 for the MLP's, as a
    uniform(0.1)-sized start), LayerNorm gamma 1 and beta 0 jittered."""
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(),
                           sym.infer_shape(**shapes)[0]):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            out[name] = (1 + 0.1 * r.randn(*shape)).astype(np.float32)
        elif name.endswith("_beta"):
            out[name] = (0.1 * r.randn(*shape)).astype(np.float32)
        else:
            scale = 0.3 if name.startswith("fc") else 0.02
            out[name] = (scale * r.randn(*shape)).astype(np.float32)
    return out


def _case(mx, model):
    """``(symbol, x, y, batch, weights, metric)`` of a parity case."""
    if model == "mlp":
        sym, (x, y), batch = _mlp_sym(mx), _mlp_data(), BATCH
        metric = mx.metric.Accuracy()
    else:
        sym = chip_smoke.build_gpt_sym(mx, L, U, H, T, V)
        (x, y), batch = _gpt_data(), GPT_B
        metric = mx.metric.Perplexity(None)
    shapes = {"data": (batch,) + x.shape[1:],
              "softmax_label": (batch,) + y.shape[1:]}
    return sym, x, y, batch, _init_params(sym, shapes, 0), metric


def _fit(mx, model, opt, num_epoch=2):
    """``Module.fit`` on the CPU; returns the parameters (numpy) and the
    metric after every batch."""
    sym, x, y, batch, weights, metric = _case(mx, model)
    name, params = OPTS[opt]
    if model == "gpt" and opt == "adam":
        params = dict(params, learning_rate=GPT_ADAM_LR)
    if mx is jmx:
        weights = {k: jmx.nd.array(v) for k, v in weights.items()}
    mod = mx.mod.Module(sym, context=mx.cpu())
    hist = []
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch), eval_metric=metric,
            optimizer=name, optimizer_params=dict(params),
            arg_params=weights, num_epoch=num_epoch,
            batch_end_callback=lambda p: hist.append(p.eval_metric.get()[1]))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, hist, \
        mod


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_module_fit_matches_reference(model, opt):
    ours, ours_hist, mod = _fit(tmx, model, opt)
    theirs, theirs_hist, _ = _fit(jmx, model, opt)
    assert mod._fused.active, "the fused step never ran"
    assert set(ours) == set(theirs)
    for name in theirs:
        np.testing.assert_allclose(ours[name], theirs[name],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg="%s (%s, %s)" % (name, model, opt))
    np.testing.assert_allclose(ours_hist, theirs_hist, rtol=METRIC_RTOL)


# -- laws of the fused step, within the port ---------------------------------

def _port_module(opt, grad_req="write"):
    sym, x, y, batch, weights, _ = _case(tmx, "mlp")
    it = tmx.io.NDArrayIter(x, y, batch_size=batch)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             grad_req=grad_req)
    mod.init_params(arg_params=weights)
    name, params = OPTS[opt]
    mod.init_optimizer(optimizer=name, optimizer_params=dict(params))
    return mod, list(it)


def _params_of(mod):
    return {k: v.data.clone() for k, v in mod._exec.arg_dict.items()
            if k in mod._param_names}


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_fused_equals_split(opt):
    """``fit_step`` (fused) and ``forward_backward`` + ``update`` (the
    Updater) give the same parameters bit for bit over 2 epochs."""
    fused, batches = _port_module(opt)
    split, _ = _port_module(opt)
    assert fused._fused_eligible()
    for _ in range(2):
        for b in batches:
            fused.fit_step(b)
            split.forward_backward(b)
            split.update()
    assert fused._fused.active and not split._fused.active
    _assert_equal(_params_of(fused), _params_of(split))


def test_fused_fallback_grad_req_add():
    """``grad_req='add'`` keeps the split path and still trains."""
    mod, batches = _port_module("sgd", grad_req="add")
    assert not mod._fused_eligible()
    before = _params_of(mod)
    for b in batches:
        mod.fit_step(b)
        for g in mod._exec.grad_dict.values():
            g[:] = 0
    assert not mod._fused.active
    after = _params_of(mod)
    assert any(not torch.equal(after[k], before[k]) for k in before)


def test_switch_to_split_path_keeps_momentum():
    """Fused steps then a split step (a monitor installed) continue from
    the fused momentum: the same parameters as split steps throughout;
    and back to fused from the Updater's state."""
    a, batches = _port_module("sgd_mom")
    b, _ = _port_module("sgd_mom")
    a.fit_step(batches[0])
    a.fit_step(batches[1])
    mon = tmx.Monitor(1, pattern="fc1.*")
    a.install_monitor(mon)
    assert not a._fused_eligible()
    mon.tic()
    a.fit_step(batches[2])
    assert mon.toc(), "the monitor saw no output"
    a._exec.set_monitor_callback(None)
    a.fit_step(batches[3])
    assert a._fused.active
    for batch in batches[:4]:
        b.forward_backward(batch)
        b.update()
    _assert_equal(_params_of(a), _params_of(b))


def test_fused_optimizer_state_roundtrip(tmp_path):
    """Momentum of fused steps survives save/load and seeds the next fused
    step of another module."""
    mod, batches = _port_module("sgd_mom")
    for b in batches:
        mod.fit_step(b)
    fname = str(tmp_path / "opt.states")
    mod.save_optimizer_states(fname)
    assert mod._updater.states
    mod2, _ = _port_module("sgd_mom")
    mod2.set_params(*mod.get_params())
    mod2.load_optimizer_states(fname)
    assert not mod2._fused.active
    mod2.fit_step(batches[0])
    mod.fit_step(batches[0])
    _assert_equal(_params_of(mod), _params_of(mod2))


def _fused_state(mod):
    return {n: tuple(s.clone() for s in st) if isinstance(st, tuple)
            else st.clone() for n, st in mod._fused.state.items()}


def test_non_finite_batch_is_skipped_and_the_limit_raises(monkeypatch):
    """A batch with a NaN input: every parameter and Adam state bit for
    bit as before, both clocks rewound, the streak counted; the limit's
    consecutive skip raises and a finite batch resets the streak."""
    monkeypatch.setenv("MXTPU_MAX_CONSECUTIVE_SKIPS", "2")
    mod, batches = _port_module("adam")
    mod.fit_step(batches[0])
    mod.fit_step(batches[1])
    opt = mod._optimizer
    params, state = _params_of(mod), _fused_state(mod)
    counts, num_update = dict(opt._index_update_count), opt.num_update
    bad = tmx.io.DataBatch([batches[2].data[0].copy()], batches[2].label)
    bad.data[0][0, 3] = float("nan")
    mod.fit_step(bad)
    _assert_equal(_params_of(mod), params)
    for n, st in state.items():
        for got, want in zip(mod._fused.state[n], st):
            assert torch.equal(got, want), n
    assert opt._index_update_count == counts and opt.num_update == num_update
    assert mod._consec_guard_skips == 1
    mod.fit_step(batches[2])
    assert mod._consec_guard_skips == 0
    assert not torch.equal(_params_of(mod)["fc1_weight"],
                           params["fc1_weight"])
    mod.fit_step(bad)
    with pytest.raises(tmx.MXNetError, match="consecutive"):
        mod.fit_step(bad)


def _gluon_run(opt, steps, fused, mults=None, change_at=None):
    """A small Dense net trained by the port's Trainer; ``change_at``
    sets lr_mult {0: 0.123} before that step (a rebuild of the fused
    update).  Returns the parameters and the Trainer."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, nn
    torch.manual_seed(0)
    tmx.random.seed(0)          # the initializers draw from mx.random
    tag = "gl_%s_%s_" % (opt, fused)
    l1 = nn.Dense(16, in_units=8, activation="relu", prefix=tag + "a_")
    l2 = nn.Dense(1, in_units=16, prefix=tag + "b_")
    params = dict(l1.collect_params())
    params.update(l2.collect_params())
    for layer in (l1, l2):
        layer.initialize(ctx=tmx.cpu())
    for i, p in enumerate(params.values()):
        if mults:
            p.lr_mult, p.wd_mult = mults[i]
    x, y = torch.randn(64, 8), torch.randn(64, 1)
    name, opt_params = OPTS[opt]
    trainer = Trainer(params, name, dict(opt_params))
    if not fused:
        trainer._fused_step = lambda live: False
    for k in range(steps):
        if k == change_at:
            trainer._optimizer.set_lr_mult({0: 0.123})
        with autograd.record():
            loss = ((l2(l1(x)) - y) ** 2).mean()
        loss.backward()
        trainer.step(batch_size=64)
    return [p.data().data.detach().clone() for p in params.values()], \
        trainer


def test_trainer_fused_rebuild_preserves_state():
    """A multiplier change rebuilds the Trainer's fused update; the
    momentum carries through the Updater: the same parameters as the
    per-parameter loop with the same change, bit for bit."""
    fused, trainer = _gluon_run("sgd_mom", 4, True, change_at=3)
    plain, _ = _gluon_run("sgd_mom", 4, False, change_at=3)
    assert trainer._fused.active and trainer._updaters.states
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
    reset, _ = _gluon_run("sgd_mom", 4, True)
    assert not all(torch.equal(a, b) for a, b in zip(fused, reset))


@pytest.mark.parametrize("opt", ["sgd_mom", "adam"])
def test_trainer_fused_equals_per_parameter(opt):
    """The Trainer's multi-tensor update equals its per-parameter loop bit
    for bit, with distinct multipliers."""
    mults = [(0.5, 2.0), (1.0, 0.0), (2.0, 0.5), (1.5, 0.0)]
    fused, _ = _gluon_run(opt, 5, True, mults)
    plain, _ = _gluon_run(opt, 5, False, mults)
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


# -- checkpoints and JSON ----------------------------------------------------

def _predict(mx, sym, args, x):
    exe = sym.simple_bind(mx.cpu(), grad_req="null", data=x.shape,
                          softmax_label=(x.shape[0],))
    for k, v in args.items():
        exe.arg_dict[k][:] = v.asnumpy() if hasattr(v, "asnumpy") else v
    return exe.forward(is_train=False, data=x)[0].asnumpy()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path):
    """``save_checkpoint`` in one package, ``load_checkpoint`` in the
    other: the same JSON, the same arrays, and the loaded symbol binds and
    gives the same outputs (1e-6)."""
    (w, r) = (tmx, jmx) if writer == "torch" else (jmx, tmx)
    sym = _mlp_sym(w)
    x, _ = _mlp_data()
    shapes = {"data": (BATCH, D), "softmax_label": (BATCH,)}
    args = {k: w.nd.array(v, ctx=w.cpu())
            for k, v in _init_params(sym, shapes, 3).items()}
    prefix = str(tmp_path / "mlp")
    w.model.save_checkpoint(prefix, 7, sym, args, {})
    sym2, args2, aux2 = r.model.load_checkpoint(prefix, 7)
    assert sym2.tojson() == sym.tojson() and aux2 == {}
    assert set(args2) == set(args)
    for k in args:
        np.testing.assert_array_equal(args2[k].asnumpy(), args[k].asnumpy())
    np.testing.assert_allclose(_predict(r, sym2, args2, x[:BATCH]),
                               _predict(w, sym, args, x[:BATCH]),
                               rtol=1e-6, atol=1e-6)


def test_loaded_symbol_keeps_hidden_attributes():
    """Fault C5: the JSON keeps ``__lr_mult__``/``__wd_mult__``/``__init__``
    and so does the loaded symbol (the reference's ``load_json`` strips
    them to ``lr_mult``, and its optimizer then ignores them)."""
    sym = _mlp_sym(tmx)
    loaded = tmx.sym.load_json(sym.tojson())
    assert loaded.attr_dict() == sym.attr_dict()
    assert loaded.attr_dict()["fc1_weight"]["__lr_mult__"] == "0.5"
    assert loaded.tojson() == sym.tojson()
    assert jmx.sym.load_json(sym.tojson()).tojson() == sym.tojson()


def test_module_checkpoint_round_trip(tmp_path):
    """``Module.save_checkpoint`` (with optimizer states) and
    ``Module.load`` continue training exactly where the module was."""
    mod, batches = _port_module("adam")
    for b in batches[:2]:
        mod.fit_step(b)
    prefix = str(tmp_path / "ck")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    mod2 = tmx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                               context=tmx.cpu())
    mod2.bind(data_shapes=[("data", (BATCH, D))],
              label_shapes=[("softmax_label", (BATCH,))])
    name, params = OPTS["adam"]
    mod2.init_optimizer(optimizer=name, optimizer_params=dict(params))
    assert mod2._updater.states
    # Adam's t is the optimizer's clock, not part of the state file
    mod2._optimizer._index_update_count = dict(
        mod._optimizer._index_update_count)
    mod.fit_step(batches[2])
    mod2.fit_step(batches[2])
    _assert_equal(_params_of(mod), _params_of(mod2))


def test_context_scope_and_default():
    """``Module(sym)`` binds on the scope's device; with no card and no
    scope there is no default device and it raises."""
    sym = _mlp_sym(tmx)
    with tmx.Context("cpu"):
        assert tmx.current_context() == tmx.cpu()
        mod = tmx.mod.Module(sym)
    mod.bind(data_shapes=[("data", (BATCH, D))],
             label_shapes=[("softmax_label", (BATCH,))])
    assert mod._exec.arg_dict["fc1_weight"].context == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError):
            tmx.mod.Module(sym)


# -- train_mnist.py's MLP ----------------------------------------------------

def test_port_trains_the_mnist_mlp():
    """``symbols/mlp.py`` (128-64-10) through the port's ``Module.fit`` on
    train_mnist.py's synthetic digits with its settings (1200 examples,
    2 epochs, batch 64, SGD lr 0.05, momentum 0.9, wd 1e-4, gaussian
    Xavier): train and validation accuracy above 0.95, the bar of
    ``tests/test_examples.py``."""
    torch.manual_seed(0)
    ty, tx = chip_smoke.synthetic_digits(1200, seed=0)
    vy, vx = chip_smoke.synthetic_digits(200, seed=1)
    train = tmx.io.NDArrayIter(tx[:, None], ty, 64, shuffle=True,
                               rng=np.random.RandomState(0))
    val = tmx.io.NDArrayIter(vx[:, None], vy, 64)
    mod = tmx.mod.Module(chip_smoke.mnist_mlp(tmx), context=tmx.cpu())
    metric = tmx.metric.Accuracy()
    mod.fit(train, eval_data=val, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            initializer=tmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2),
            num_epoch=2)
    assert mod._fused.active
    assert metric.get()[1] > 0.95          # the last epoch's Train-accuracy
    assert mod.score(val, "acc")[0][1] > 0.95


# -- the Module family: bucketing, sequential, python, FeedForward ------------

def _lin_data(n=64, d=10, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    return x, (x @ rs.randn(d, 2).astype(np.float32)).argmax(1).astype(
        np.float32)


def _weights(shapes, seed):
    rs = np.random.RandomState(seed)
    return {k: (0.3 * rs.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _close(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k].asnumpy(), theirs[k].asnumpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_bucketing_module_matches_reference():
    """Two sequence-length buckets sharing parameters
    (``tests/test_module.py``'s), the same weights and batches in both
    packages; the parameters after 6 steps."""
    def run(mx):
        def sym_gen(seq_len):
            data = mx.sym.Variable("data")
            net = mx.sym.FullyConnected(mx.sym.mean(data, axis=1),
                                        num_hidden=8, name="fc1")
            net = mx.sym.Activation(net, act_type="relu", name="r1")
            net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
            return mx.sym.SoftmaxOutput(net, name="softmax"), ("data",), \
                ("softmax_label",)
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                     context=mx.cpu())
        mod.bind(data_shapes=[mx.io.DataDesc("data", (16, 10, 4))],
                 label_shapes=[mx.io.DataDesc("softmax_label", (16,))])
        w = _weights({"fc1_weight": (8, 4), "fc1_bias": (8,),
                      "fc2_weight": (2, 8), "fc2_bias": (2,)}, 1)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
        rs = np.random.RandomState(0)
        for _ in range(3):
            for key in (10, 6):
                x = rs.randn(16, key, 4).astype(np.float32)
                y = (x.mean(axis=(1, 2)) > 0).astype(np.float32)
                mod.forward_backward(mx.io.DataBatch(
                    data=[mx.nd.array(x, ctx=mx.cpu())],
                    label=[mx.nd.array(y, ctx=mx.cpu())], bucket_key=key,
                    provide_data=[mx.io.DataDesc("data", (16, key, 4))],
                    provide_label=[mx.io.DataDesc("softmax_label", (16,))],
                    pad=0))
                mod.update()
        assert set(mod._buckets) == {10, 6}
        return mod.get_params()[0]
    _close(run(tmx), run(jmx))


def _seq(mx, python_loss):
    """SequentialModule: an FC-relu module, then an FC-softmax module or
    a softmax body and a PythonLossModule head."""
    seq = mx.mod.SequentialModule()
    body = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=16, name="s1fc"),
        act_type="relu", name="s1fc_act")
    if python_loss:
        body = mx.sym.softmax(mx.sym.FullyConnected(body, num_hidden=2,
                                                    name="s2fc"))
        seq.add(mx.mod.Module(body, label_names=None, context=mx.cpu()))
        seq.add(mx.mod.PythonLossModule(), take_labels=True,
                auto_wiring=True)
    else:
        head = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("s1fc_act"), num_hidden=2, name="s2fc"),
            name="softmax")
        seq.add(mx.mod.Module(body, label_names=None, context=mx.cpu()),
                auto_wiring=True)
        seq.add(mx.mod.Module(head, data_names=("s1fc_act",),
                              context=mx.cpu()), take_labels=True,
                auto_wiring=True)
    return seq


@pytest.mark.parametrize("python_loss", [False, True],
                         ids=["two_modules", "python_loss"])
def test_sequential_module_matches_reference(python_loss):
    """A chain trained by ``fit`` in both packages from the same weights:
    the parameters and the per-batch accuracy."""
    x, y = _lin_data()
    w = _weights({"s1fc_weight": (16, 10), "s1fc_bias": (16,),
                  "s2fc_weight": (2, 16), "s2fc_bias": (2,)}, 2)
    out = []
    for mx in (tmx, jmx):
        seq = _seq(mx, python_loss)
        hist = []
        seq.fit(mx.io.NDArrayIter(x, y, batch_size=32), optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in w.items()},
                num_epoch=3, eval_metric="acc",
                batch_end_callback=lambda p: hist.append(
                    p.eval_metric.get()[1]))
        params = {}
        for m in seq._modules:
            params.update(m.get_params()[0])
        out.append((params, hist))
    _close(out[0][0], out[1][0])
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=METRIC_RTOL)


def test_feedforward_matches_reference(tmp_path):
    """The legacy ``FeedForward``: ``create`` + ``predict`` from the same
    weights in both packages, then ``save`` and ``load``."""
    import warnings
    x, y = _lin_data(128, seed=1)
    w = _weights({"fc1_weight": (16, 10), "fc1_bias": (16,),
                  "fc2_weight": (K, 16), "fc2_bias": (K,)}, 3)
    preds = []
    for mx in (tmx, jmx):
        sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Activation(mx.sym.FullyConnected(
                mx.sym.Variable("data"), num_hidden=16, name="fc1"),
                act_type="relu"), num_hidden=K, name="fc2"), name="softmax")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            model = mx.model.FeedForward(
                sym, ctx=mx.cpu(), num_epoch=3, numpy_batch_size=32,
                learning_rate=0.5,
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in w.items()})
            np.random.seed(0)        # the training iterator's shuffle
            model.fit(x, y)
        preds.append(model.predict(x))
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-4, atol=1e-5)
    prefix = str(tmp_path / "ff")
    model.save(prefix, 5)            # the reference's checkpoint
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        loaded = tmx.model.FeedForward.load(prefix, 5, ctx=tmx.cpu())
    np.testing.assert_allclose(loaded.predict(x), preds[1], rtol=1e-5,
                               atol=1e-6)



def test_executor_arrays_reshape_and_forward_backward():
    """The executor's array views, ``output_dict``, ``forward_backward``
    (equal to forward + backward) and ``reshape`` (weights shared, new
    batch size), against the reference's on the same weights."""
    x, y = _mlp_data()
    w = _init_params(_mlp_sym(tmx), {"data": (BATCH, D),
                                     "softmax_label": (BATCH,)}, 4)
    got = []
    for mx in (tmx, jmx):
        exe = _mlp_sym(mx).simple_bind(mx.cpu(), grad_req="write",
                                       data=(BATCH, D),
                                       softmax_label=(BATCH,))
        for k, v in w.items():
            exe.arg_dict[k][:] = v
        assert [a.shape for a in exe.arg_arrays] == \
            [exe.arg_dict[n].shape for n in exe._arg_names]
        assert len(exe.grad_arrays) == len(exe.arg_arrays)
        assert exe.aux_arrays == []
        exe.forward_backward(data=x[:BATCH], softmax_label=y[:BATCH])
        assert list(exe.output_dict) == ["softmax_output"]
        small = exe.reshape(data=(8, D), softmax_label=(8,))
        assert small.arg_dict["fc1_weight"] is exe.arg_dict["fc1_weight"]
        out = small.forward(data=x[:8])[0].asnumpy()
        got.append(({k: g.asnumpy() for k, g in exe.grad_dict.items()
                     if k in w}, out))
    for k in w:
        np.testing.assert_allclose(got[0][0][k], got[1][0][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-5, atol=1e-6)


def test_module_reshape_predict_and_input_grads():
    """``Module.reshape`` keeps the parameters; ``predict`` concatenates
    the batches without their pad; ``inputs_need_grad`` gives the data's
    gradient (the split path)."""
    mod, batches = _port_module("sgd")
    mod.fit_step(batches[0])
    before = _params_of(mod)
    mod.reshape([("data", (16, D))], [("softmax_label", (16,))])
    _assert_equal(_params_of(mod), before)
    x, y = _mlp_data()
    out = mod.predict(tmx.io.NDArrayIter(x[:40], y[:40], batch_size=16))
    assert out.shape == (40, K)
    ig = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    ig.bind(data_shapes=[("data", (BATCH, D))],
            label_shapes=[("softmax_label", (BATCH,))],
            inputs_need_grad=True)
    ig.init_params(arg_params=_init_params(
        _mlp_sym(tmx), {"data": (BATCH, D), "softmax_label": (BATCH,)}, 0))
    ig.init_optimizer(optimizer="sgd")
    assert not ig._fused_eligible()
    ig.forward_backward(batches[0])
    g = ig.get_input_grads()[0]
    assert g.shape == (BATCH, D) and float(abs(g).sum().asscalar()) > 0


def test_fit_callbacks(tmp_path, caplog):
    """``fit`` with the callbacks of ``callback.py``: per-epoch checkpoints
    (``do_checkpoint``, ``module_checkpoint`` with optimizer states) that
    the reference loads, and the logging callbacks."""
    import logging
    caplog.set_level(logging.INFO)
    sym, x, y, batch, weights, _ = _case(tmx, "mlp")
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    prefix, mprefix = str(tmp_path / "do"), str(tmp_path / "mod")
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=weights, num_epoch=2,
            epoch_end_callback=[tmx.callback.do_checkpoint(prefix),
                                tmx.callback.module_checkpoint(
                                    mod, mprefix, period=2,
                                    save_optimizer_states=True)],
            batch_end_callback=[tmx.callback.Speedometer(batch, 2),
                                tmx.callback.log_train_metric(2),
                                tmx.callback.ProgressBar(4)])
    args, _ = mod.get_params()
    for pre in (prefix, mprefix):
        sym2, args2, _ = jmx.model.load_checkpoint(pre, 2)
        assert sym2.tojson() == sym.tojson()
        for k, v in args.items():
            np.testing.assert_array_equal(args2[k].asnumpy(), v.asnumpy())
    assert (tmp_path / "do-0001.params").exists()
    assert (tmp_path / "mod-0002.states").exists()
    assert not (tmp_path / "mod-0001.params").exists()
    text = caplog.text
    assert "samples/sec" in text and "Train-accuracy" in text
