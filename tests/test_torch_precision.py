"""The port's precision policy against the JAX package's, and its loss
scaler on the Module's and the Trainer's fused steps.

The resolution laws, fingerprints and scaler dynamics must equal the
reference's exactly (host arithmetic; one policy gives one fingerprint in
both packages).  On the fused steps: a loss head scaled by S (a power of
two) with a static scaler of scale S trains bit for bit as the unscaled
run; a skipped (NaN) step backs the scaler off on the guard's verdict
and leaves the skip accounting as without a scaler; a policy change
rebuilds the fused step and keeps the momentum.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.precision import (LossScaler, PrecisionPolicy,
                                       policy_fingerprint)

POLICIES = [
    {},
    {"param_dtype": "bf16"},
    {"param_dtype": "bf16", "compute_dtype": "fp32"},
    {"compute_dtype": "bf16", "output_dtype": "float32"},
    {"param_dtype": "fp32", "kv_dtype": "int8",
     "overrides": {"blocks.*": {"param": "bf16"},
                   "blocks.3": {"compute": "fp16"}}},
]
NAMES = ["anything", "blocks.1", "blocks.3", "embed"]


@pytest.mark.parametrize("kw", POLICIES)
def test_resolution_and_fingerprint_match_reference(kw):
    from mxnet_tpu import precision as jprec
    ours, theirs = PrecisionPolicy(**kw), jprec.PrecisionPolicy(**kw)
    for name in NAMES:
        assert tuple(ours.resolve(name)) == tuple(theirs.resolve(name))
    assert ours.fingerprint() == theirs.fingerprint()


def test_spellings_and_errors():
    a = PrecisionPolicy(param_dtype="float32", compute_dtype=np.float32)
    b = PrecisionPolicy(param_dtype="fp32", compute_dtype=torch.float32)
    assert a.resolve("x") == b.resolve("x") == ("fp32", "fp32", "fp32")
    assert a.fingerprint() == b.fingerprint()
    assert policy_fingerprint(None) == ""
    with pytest.raises(ValueError, match="unsupported param dtype"):
        PrecisionPolicy(param_dtype="int7")
    with pytest.raises(ValueError, match="unknown override fields"):
        PrecisionPolicy(overrides={"x": {"storage": "bf16"}})
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        PrecisionPolicy(kv_dtype="int3")


def test_loss_scaler_matches_reference():
    """The same verdict sequence gives the same scales, streaks and
    overflow counts; the fingerprint ignores the moving scale."""
    from mxnet_tpu import precision as jprec
    verdicts = [False, True, True, True, True, False, True, True] + \
        [False] * 20 + [True] * 7
    for kw in ({"init_scale": 16.0, "growth_interval": 3},
               {"init_scale": 4.0, "dynamic": False}):
        ours, theirs = LossScaler(**kw), jprec.LossScaler(**kw)
        for v in verdicts:
            assert ours.update(v) == theirs.update(v)
            assert (ours.good_steps, ours.overflows) == \
                (theirs.good_steps, theirs.overflows)
    pol = PrecisionPolicy(loss_scaler=LossScaler(init_scale=4.0))
    fp = pol.fingerprint()
    pol.loss_scaler.update(False)
    assert pol.loss_scaler.scale == 2.0 and pol.fingerprint() == fp


def test_cast_params_by_layer():
    pol = PrecisionPolicy(overrides={"blocks.*": {"param": "bf16"}})
    tree = {"w": torch.ones(2), "layers": [torch.ones(3), torch.ones(1)]}
    got = pol.cast_params(tree, "blocks.0")
    assert got["w"].dtype == torch.bfloat16
    assert [t.dtype for t in got["layers"]] == [torch.bfloat16] * 2
    assert pol.cast_params(tree, "embed")["w"].dtype == torch.float32


# -- the fused steps -----------------------------------------------------------

def _module(grad_scale=1.0, policy=None):
    data = tmx.sym.Variable("data")
    net = tmx.sym.Activation(tmx.sym.FullyConnected(
        data, num_hidden=16, name="fc1"), act_type="relu")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        net, num_hidden=3, name="fc2"), name="softmax",
        grad_scale=grad_scale)
    rs = np.random.RandomState(0)
    x = rs.randn(64, 10).astype(np.float32)
    y = (x @ rs.randn(10, 3).astype(np.float32)).argmax(1).astype(
        np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=32)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    torch.manual_seed(7)
    mod.init_params(tmx.init.Uniform(0.1))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    if policy is not None:
        mod.set_precision(policy)
    return mod, list(it)


def _params(mod):
    return {k: v.data.clone() for k, v in mod._exec.arg_dict.items()
            if k in mod._param_names}


def test_module_loss_scaling_identity():
    S = 8.0
    ref, batches = _module()
    scaled, _ = _module(grad_scale=S, policy=PrecisionPolicy(
        loss_scaler=LossScaler(init_scale=S, dynamic=False)))
    for _ in range(3):
        for b in batches:
            ref.fit_step(b)
            scaled.fit_step(b)
    a, b = _params(ref), _params(scaled)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_module_scaler_rides_guard_verdict():
    """A NaN batch: skipped as without a scaler (clock rewound, streak
    1), the scale backed off on that verdict, then grown back after the
    interval of clean steps."""
    pol = PrecisionPolicy(loss_scaler=LossScaler(init_scale=16.0,
                                                 growth_interval=4))
    mod, batches = _module(policy=pol)
    mod.fit_step(batches[0])
    updates = mod._optimizer.num_update
    bad = tmx.io.DataBatch([batches[0].data[0].copy()], batches[0].label)
    bad.data[0][1, 2] = float("nan")
    before = _params(mod)
    mod.fit_step(bad)
    assert mod._optimizer.num_update == updates
    assert pol.loss_scaler.scale == 8.0 and pol.loss_scaler.overflows == 1
    assert mod._consec_guard_skips == 1
    after = _params(mod)
    assert all(torch.equal(after[k], before[k]) for k in before)
    for _ in range(4):
        mod.fit_step(batches[0])
    assert mod._consec_guard_skips == 0 and pol.loss_scaler.scale == 16.0


def test_module_policy_rekeys_and_keeps_momentum():
    """A policy change rebuilds the fused step (its key carries the
    fingerprint) and the momentum carries over: the same parameters as a
    module that never changed policy (no scaler: the same arithmetic)."""
    a, batches = _module()
    b, _ = _module()
    a.fit_step(batches[0])
    b.fit_step(batches[0])
    assert a._fused.key[-1] == ""
    pol = PrecisionPolicy(param_dtype="fp32", kv_dtype="int8")
    a.set_precision(pol)
    a.fit_step(batches[1])
    b.fit_step(batches[1])
    assert a._fused.key[-1] == pol.fingerprint()
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _gluon(policy, scale_loss, steps, nan_at=None):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, nn
    torch.manual_seed(3)
    tmx.random.seed(3)          # the initializers draw from mx.random
    l1 = nn.Dense(16, in_units=8, activation="relu", prefix="prec_a_")
    l2 = nn.Dense(1, in_units=16, prefix="prec_b_")
    params = dict(l1.collect_params())
    params.update(l2.collect_params())
    for layer in (l1, l2):
        layer.initialize(ctx=tmx.cpu())
    x, y = torch.randn(64, 8), torch.randn(64, 1)
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05,
                                      "momentum": 0.9})
    if policy is not None:
        trainer.set_precision(policy)
    for k in range(steps):
        xin = x.clone()
        if k == nan_at:
            xin[0, 0] = float("nan")
        with autograd.record():
            loss = ((l2(l1(xin)) - y) ** 2).mean()
            if scale_loss:
                loss = policy.loss_scaler.scale_loss(loss)
        loss.backward()
        trainer.step(batch_size=64)
    return [p.data().data.detach().clone() for p in params.values()], \
        trainer


def test_trainer_loss_scaling_identity_and_rekey():
    S = 32.0
    ref, t0 = _gluon(None, False, 4)
    pol = PrecisionPolicy(loss_scaler=LossScaler(init_scale=S,
                                                 dynamic=False))
    scaled, t1 = _gluon(pol, True, 4)
    assert t0._fused.key[-1] == "" and \
        t1._fused.key[-1] == pol.fingerprint()
    for a, b in zip(ref, scaled):
        assert torch.equal(a, b)


def test_trainer_scaler_consumes_late_verdict():
    """The Trainer reads the verdict one step late: the backoff lands
    when it does, and the streak counts as without a scaler."""
    pol = PrecisionPolicy(loss_scaler=LossScaler(init_scale=16.0))
    _, trainer = _gluon(pol, False, 2, nan_at=1)
    assert pol.loss_scaler.overflows == 0        # not yet read
    trainer._resolve_pending_verdict()
    assert pol.loss_scaler.overflows == 1 and pol.loss_scaler.scale == 8.0
    assert trainer._consec_guard_skips == 1
