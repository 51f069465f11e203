"""The port's optimizers, schedules and the fused, guarded multi-tensor
update against the JAX package's.

Every optimizer's ``update`` runs on the same numpy inputs in both
packages (``tests/test_optimizer.py``'s quadratic on a 3-vector, 60 steps,
and a (4, 5) weight with weight decay, clipping and a rescale, 5 steps):
weights and states within 1e-6 + 1e-5·|x| after every step (float32 in
both; a few ops round in another order).  SGLD's noise comes from torch's
generator, so its draws are held to their distribution instead.  The
schedules and the multiplier rules must give equal numbers.

The fused update (``ops.optimizer_ops.make_fused_apply``) equals the
per-parameter optimizers bit for bit on the CPU (the same float32 ops in
the same order), and the guard's skip leaves every tensor bit for bit.
A ``gpu``-marked test runs the guarded update on CUDA tensors against
the CPU (within 1e-6 relative: CUDA may contract a multiply-add).
"""
import math
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import optimizer_ops as oo

RTOL, ATOL = 1e-5, 1e-6


def _ref():
    """The JAX package, imported inside the tests that compare with it: the
    card's machine has no JAX and runs this file's ``gpu`` test."""
    import mxnet_tpu
    return mxnet_tpu

CASES = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.05}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("dcasgd", {"learning_rate": 0.05}),
    ("adam", {"learning_rate": 0.3}),
    ("rmsprop", {"learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 0.05, "centered": True,
                 "clip_weights": 2.5}),
    ("adagrad", {"learning_rate": 1.0}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-4}),
    ("adamax", {"learning_rate": 0.5}),
    ("nadam", {"learning_rate": 0.3}),
    ("ftrl", {"learning_rate": 2.0}),
    ("test", {"learning_rate": 0.1}),
]
EXTRA = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.5}


def _state_arrays(state, to_np):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [a for s in state for a in _state_arrays(s, to_np)]
    return [to_np(state)]


def _run(mx, name, kwargs, w0, grads):
    """Weights and states after each step of ``update`` on ``grads(w)``."""
    opt = mx.optimizer.create(name, **kwargs)
    if mx is not tmx:
        w = mx.nd.array(w0)
        to_np = lambda a: a.asnumpy()           # noqa: E731
        wrap = mx.nd.array
    else:
        w = torch.from_numpy(w0.copy())
        to_np = lambda a: a.detach().numpy().copy()  # noqa: E731
        wrap = torch.from_numpy
    state = opt.create_state(0, w)
    out = []
    for g in grads:
        grad = g(to_np(w))
        opt.update(0, w, wrap(grad), state)
        out.append([to_np(w)] + _state_arrays(state, to_np))
    return out


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "wd_clip"])
@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=["%s%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_update_matches_reference(name, kwargs, extra):
    jmx = _ref()
    kwargs = dict(kwargs, **(EXTRA if extra else {}))
    if extra:
        rs = np.random.RandomState(1)
        w0 = rs.randn(4, 5).astype(np.float32)
        grads = [lambda w, g=rs.randn(4, 5).astype(np.float32) * 3: g
                 for _ in range(5)]
    else:
        target = np.array([1.0, -2.0, 3.0], np.float32)
        w0 = np.zeros(3, np.float32)
        grads = [lambda w: (2.0 * (w - target)).astype(np.float32)] * 60
    ours = _run(tmx, name, kwargs, w0, grads)
    theirs = _run(jmx, name, kwargs, w0, grads)
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                       err_msg="%s step %d" % (name, step))


def test_sgd_multi_precision_matches_reference():
    """A float16 weight with a float32 master copy (``mp_sgd_mom_update``)."""
    jmx = _ref()
    rs = np.random.RandomState(2)
    w0 = rs.randn(6).astype(np.float16)
    g = rs.randn(6).astype(np.float16)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
          "multi_precision": True}
    topt, jopt = tmx.optimizer.create("sgd", **kw), \
        jmx.optimizer.create("sgd", **kw)
    tw, jw = torch.from_numpy(w0.copy()), jmx.nd.array(w0, dtype=np.float16)
    ts, js = topt.create_state(0, tw), jopt.create_state(0, jw)
    for _ in range(3):
        topt.update(0, tw, torch.from_numpy(g), ts)
        jopt.update(0, jw, jmx.nd.array(g, dtype=np.float16), js)
    assert tw.dtype == torch.float16 and ts[1].dtype == torch.float32
    np.testing.assert_allclose(ts[1].numpy(), js[1].asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tw.numpy(), jw.asnumpy())


def test_sgld_noise_has_the_reference_distribution():
    """``w - lr/2 (g + wd w)`` plus normal noise of variance lr, drawn from
    the given generator (its mean and std within 5 standard errors)."""
    n, lr = 200000, 0.04
    opt = tmx.optimizer.create("sgld", learning_rate=lr,
                               generator=torch.Generator().manual_seed(0))
    w = torch.ones(n)
    opt.update(0, w, torch.full((n,), 2.0), None)
    noise = w - (1.0 - lr / 2 * 2.0)
    se = math.sqrt(lr / n)
    assert abs(noise.mean().item()) < 5 * se
    assert abs(noise.std().item() - math.sqrt(lr)) < 5 * math.sqrt(lr / (2 * n))


def test_lr_schedulers_match_reference():
    jmx = _ref()
    for make in (lambda m: m.lr_scheduler.FactorScheduler(step=10,
                                                          factor=0.5),
                 lambda m: m.lr_scheduler.MultiFactorScheduler(
                     step=[5, 15, 40], factor=0.1),
                 lambda m: m.lr_scheduler.PolyScheduler(max_update=100,
                                                        base_lr=1.0)):
        ours, theirs = make(tmx), make(jmx)
        ours.base_lr = theirs.base_lr = 1.0
        assert [ours(t) for t in range(120)] == \
            [theirs(t) for t in range(120)]


def test_scheduler_drives_lr_through_num_update():
    """``lr_scheduler`` reads ``num_update``, which every update advances,
    as the reference's does."""
    jmx = _ref()

    def run(mx):
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = mx.optimizer.create("sgd", learning_rate=1.0,
                                  lr_scheduler=sched)
        lrs = []
        for _ in range(7):
            for i in range(2):
                lrs.append(opt._get_lr(i))
                opt._update_count(i)
        return lrs, opt.num_update, dict(opt._index_update_count)
    assert run(tmx) == run(jmx)


def test_mult_rules_match_reference():
    """Multipliers from the symbol's ``__lr_mult__``/``__wd_mult__``, by
    name and by index, and the default zero decay of non-weights."""
    jmx = _ref()

    def run(mx):
        data = mx.sym.Variable("data")
        w = mx.sym.Variable("fc_weight", lr_mult=0.5, wd_mult=3.0)
        b = mx.sym.Variable("fc_bias", lr_mult=2.0)
        net = mx.sym.FullyConnected(data, weight=w, bias=b, num_hidden=2,
                                    name="fc")
        g = mx.sym.Variable("ln_gamma")
        net = mx.sym.LayerNorm(net, gamma=g, name="ln")
        names = dict(enumerate(net.list_arguments()))
        opt = mx.optimizer.create("sgd", learning_rate=1.0, wd=1.0, sym=net,
                                  param_idx2name=names)
        opt.set_lr_mult({3: 7.0})
        opt.set_wd_mult({"ln_beta": 4.0})
        return [(opt._get_lr(i), opt._get_wd(i)) for i in names], \
            opt.fused_mults(names) if mx is tmx else None
    ours, fused = run(tmx)
    assert ours == run(jmx)[0]
    assert list(fused.values()) == ours


def test_updater_states_round_trip():
    """``get_states``/``set_states`` (with and without the optimizer)
    continue exactly where the Updater was; the pickle holds host
    tensors."""
    for dump in (False, True):
        opt = tmx.optimizer.create("adam", learning_rate=0.1)
        up = tmx.optimizer.get_updater(opt)
        w, g = torch.ones(4), torch.full((4,), 0.5)
        up(0, g, w)
        blob = up.get_states(dump_optimizer=dump)
        up2 = tmx.optimizer.get_updater(tmx.optimizer.create(
            "adam", learning_rate=0.7 if dump else 0.1))
        up2.set_states(blob)
        assert up2.optimizer.lr == 0.1
        # Adam's t is the optimizer's clock: carried by the dump only
        up2.optimizer._index_update_count = dict(opt._index_update_count)
        w2 = w.clone()
        up(0, g, w)
        up2(0, g, w2)
        assert torch.equal(w, w2)
    assert isinstance(pickle.loads(up.get_states())[0][0], torch.Tensor)


# -- the fused multi-tensor update and its guard ------------------------------

FUSED = [("sgd", {"learning_rate": 0.1, "wd": 0.01}),
         ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01,
                  "clip_gradient": 0.5}),
         ("adam", {"learning_rate": 0.01, "wd": 0.01})]


def _tree(seed, device="cpu"):
    rs = np.random.RandomState(seed)
    shapes = {"a_weight": (5, 4), "a_bias": (5,), "b_weight": (3, 5),
              "c_gamma": (3,)}
    return {n: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device)
            for n, s in shapes.items()}


def _fused_run(name, kwargs, steps, device="cpu", poison_at=None,
               defer=False):
    """The guarded fused update for ``steps`` steps on seeded gradients
    (``defer``: the form that selects on the device); returns the
    parameters, the state and the verdicts."""
    opt = tmx.optimizer.create(name, rescale_grad=0.25,
                               param_idx2name=dict(enumerate(_tree(0))),
                               **kwargs)
    opt.set_lr_mult({0: 0.5, "b_weight": 2.0})
    opt.set_wd_mult({1: 1.5})
    names = dict(enumerate(_tree(0)))
    init_state, apply_fn = opt.make_fused_apply(names)
    guarded = oo.make_guarded_apply(apply_fn, defer_verdict=defer)
    params = _tree(0, device)
    state = init_state(params)
    oks = []
    for k in range(steps):
        t = opt._update_count(0)
        grads = _tree(k + 1, device)
        poison = float("nan") if k == poison_at else 0.0
        ok = guarded(params, grads, state, opt.lr, opt.wd, opt.rescale_grad,
                     float(t), poison)
        oks.append(bool(ok))
    return params, state, oks


@pytest.mark.parametrize("defer", [False, True], ids=["now", "deferred"])
@pytest.mark.parametrize("name,kwargs", FUSED,
                         ids=["sgd", "sgd_mom", "adam"])
def test_fused_update_equals_per_parameter(name, kwargs, defer):
    """The multi-tensor update (in place after the check, or into
    temporaries and selected) and the optimizer's per-parameter
    ``update`` give the same tensors bit for bit."""
    params, state, oks = _fused_run(name, kwargs, 4, defer=defer)
    assert oks == [True] * 4
    opt = tmx.optimizer.create(name, rescale_grad=0.25,
                               param_idx2name=dict(enumerate(_tree(0))),
                               **kwargs)
    opt.set_lr_mult({0: 0.5, "b_weight": 2.0})
    opt.set_wd_mult({1: 1.5})
    ref = _tree(0)
    states = {i: opt.create_state(i, w) for i, w in enumerate(ref.values())}
    for k in range(4):
        grads = list(_tree(k + 1).values())
        for i, w in enumerate(ref.values()):
            opt.update(i, w, grads[i], states[i])
    for i, n in enumerate(ref):
        assert torch.equal(params[n], ref[n]), n
        want = states[i]
        got = state[n]
        if want is not None:
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b), n


@pytest.mark.parametrize("defer", [False, True], ids=["now", "deferred"])
@pytest.mark.parametrize("name,kwargs", FUSED,
                         ids=["sgd", "sgd_mom", "adam"])
def test_poisoned_step_leaves_every_tensor(name, kwargs, defer):
    """A NaN-poisoned step is a no-op bit for bit on the parameters and
    the state (the verdict False)."""
    clean = _fused_run(name, kwargs, 2, defer=defer)
    before = _fused_run(name, kwargs, 3, poison_at=2, defer=defer)
    assert before[2] == [True, True, False]
    for n in clean[0]:
        assert torch.equal(before[0][n], clean[0][n]), n
        for a, b in zip(_leaves(before[1][n]), _leaves(clean[1][n])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), n


def _leaves(st):
    return st if isinstance(st, tuple) else (st,)


def test_guard_select_keeps_bits():
    """The select keeps -0.0, NaN payloads and infinities of the old
    values on a skip, and takes the new values exactly otherwise."""
    old = torch.tensor([-0.0, float("inf"), 1.5, float("nan")])
    new = torch.tensor([float("nan"), 2.0, -0.0, 3.0])
    for ok in (False, True):
        a = old.clone()
        oo.select_([a], [new.clone()], torch.tensor(ok))
        want = new if ok else old
        assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    h = torch.tensor([1.0, -0.0], dtype=torch.bfloat16)
    oo.select_([h], [torch.tensor([float("nan"), 2.0],
                                  dtype=torch.bfloat16)], torch.tensor(False))
    assert torch.equal(h.view(torch.int16),
                       torch.tensor([1.0, -0.0], dtype=torch.bfloat16)
                       .view(torch.int16))


def test_all_finite():
    assert bool(oo.all_finite([torch.ones(3), torch.zeros(2, 2)]))
    for bad in (float("nan"), float("inf"), -float("inf")):
        assert not bool(oo.all_finite([torch.ones(3),
                                       torch.tensor([0.0, bad])]))
    assert bool(oo.all_finite([torch.tensor([3e38, -3e38])]))
    mixed = [torch.ones(3), torch.ones(2, dtype=torch.bfloat16),
             torch.ones(2, dtype=torch.float16)]
    assert bool(oo.all_finite(mixed))
    mixed[2][1] = float("inf")
    assert not bool(oo.all_finite(mixed))


@pytest.mark.gpu
@pytest.mark.parametrize("name,kwargs", FUSED,
                         ids=["sgd", "sgd_mom", "adam"])
def test_cuda_guarded_update_matches_cpu(name, kwargs):
    """The guarded multi-tensor update on CUDA tensors against the CPU,
    with a poisoned step in the middle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the update runs on CUDA tensors)")
    cpu = _fused_run(name, kwargs, 4, poison_at=2)
    for defer in (False, True):
        gpu = _fused_run(name, kwargs, 4, device="cuda", poison_at=2,
                         defer=defer)
        assert cpu[2] == gpu[2] == [True, True, False, True]
        for n in cpu[0]:
            np.testing.assert_allclose(gpu[0][n].cpu().numpy(),
                                       cpu[0][n].numpy(), rtol=1e-6,
                                       atol=1e-7)


# -- initializers ----------------------------------------------------------

def _init_both(init_of, name, shape, attrs=None):
    """``init(InitDesc(name, attrs), arr)`` in both packages (an NDArray
    each); the arrays as numpy."""
    jmx = _ref()
    ours = tmx.nd.zeros(shape, ctx=tmx.cpu())
    theirs = jmx.nd.zeros(shape)
    init_of(tmx)(tmx.init.InitDesc(name, attrs), ours)
    init_of(jmx)(jmx.init.InitDesc(name, attrs), theirs)
    return ours.asnumpy(), theirs.asnumpy()


@pytest.mark.parametrize("case", [
    (lambda m: m.init.Bilinear(), "up_weight", (2, 1, 4, 6)),
    (lambda m: m.init.LSTMBias(forget_bias=2.5), "lstm_bias", (16,)),
    (lambda m: m.init.Constant(0.25), "fc_weight", (3, 4)),
    (lambda m: m.init.One(), "fc_weight", (3, 4)),
    (lambda m: m.init.Uniform(), "x_upsampling", (1, 1, 4, 4)),
    (lambda m: m.init.Uniform(), "bn_moving_mean", (5,)),
    (lambda m: m.init.Uniform(), "bn_running_var", (5,)),
    (lambda m: m.init.Uniform(), "ln_gamma", (5,)),
    (lambda m: m.init.Uniform(), "ln_beta", (5,)),
    (lambda m: m.init.Uniform(), "fc_bias", (5,)),
], ids=["bilinear", "lstm_bias", "constant", "one", "upsampling",
        "moving_mean", "running_var", "gamma", "beta", "bias"])
def test_deterministic_initializers_match_reference(case):
    init_of, name, shape = case
    ours, theirs = _init_both(init_of, name, shape)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_init_attribute_picks_the_initializer():
    """A variable's ``__init__`` attribute (``dumps()``) wins over the
    global initializer, in both packages; an unknown name raises."""
    attrs = {"__init__": tmx.init.Constant(3.0).dumps()}
    ours, theirs = _init_both(lambda m: m.init.Uniform(), "w_weight",
                              (2, 2), attrs)
    np.testing.assert_array_equal(ours, np.full((2, 2), 3.0, np.float32))
    np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="Unknown initialization"):
        tmx.init.Uniform()("strange", torch.zeros(2))


def test_random_initializers_by_distribution():
    """Orthogonal (orthonormal rows times ``scale``), MSRAPrelu (std
    sqrt(2 / (1 + slope^2) / fan_in), within 3%) and Xavier (inside its
    bound), drawn from an explicit generator."""
    g = torch.Generator().manual_seed(0)
    w = torch.empty(16, 64)
    tmx.init.Orthogonal(scale=1.5)("q_weight", w, g)
    np.testing.assert_allclose((w @ w.T).numpy(), 2.25 * np.eye(16),
                               atol=1e-4)
    w = torch.empty(256, 512)
    tmx.init.MSRAPrelu(factor_type="in", slope=0.25)("p_weight", w, g)
    want = math.sqrt(2.0 / (1 + 0.25 ** 2) / 512)
    assert abs(w.std().item() / want - 1) < 0.03
    tmx.init.Xavier(magnitude=3)("x_weight", w, g)
    bound = math.sqrt(3.0 / ((256 + 512) / 2.0))
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound


def test_mixed_and_load(tmp_path):
    """``Mixed`` by pattern (no match raises); ``Load`` from a dict and
    from the reference's ``.params`` file, with a default and a shape
    check."""
    jmx = _ref()
    mixed = tmx.init.Mixed(["fc1_.*", ".*"], [tmx.init.Constant(1.0),
                                              tmx.init.Zero()])
    a, b = torch.empty(2), torch.empty(2)
    mixed("fc1_weight", a)
    mixed("fc2_weight", b)
    assert a.tolist() == [1.0, 1.0] and b.tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="did not match"):
        tmx.init.Mixed(["fc.*"], [tmx.init.Zero()])("x_weight", a)
    fname = str(tmp_path / "w.params")
    jmx.nd.save(fname, {"arg:fc_weight": jmx.nd.array(
        np.arange(6, dtype=np.float32).reshape(2, 3))})
    load = tmx.init.Load(fname, default_init=tmx.init.Constant(7.0))
    w, other = torch.zeros(2, 3), torch.zeros(4)
    load("fc_weight", w)
    load("fc2_weight", other)        # not in the file: the default's rule
    assert w.flatten().tolist() == list(range(6))
    assert other.tolist() == [7.0] * 4
    with pytest.raises(ValueError, match="Shape mismatch"):
        load("fc_weight", torch.zeros(3, 2))
