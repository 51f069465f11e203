"""The port's metrics and data iterators against the JAX package's.

Metrics: every registered metric on ``tests/test_metric_io.py``'s inputs
and on seeded random ones, in both packages (the same numpy arithmetic:
equal within a relative 1e-6).  The metrics that reduce in torch
(Accuracy, Perplexity, CrossEntropy, MAE, MSE, RMSE, Loss), handed torch
tensors as they are handed a device's, against the reference's numpy
metric: within a relative 1e-5 (float32 sums in another order over up to
8192 terms).

Iterators: ``NDArrayIter`` (pad, discard, roll-over, a shuffle from a
seeded generator against the reference's from numpy's global one, dict
inputs), ``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and
``MNISTIter`` on idx files the test writes: the same batches, pads and
descriptors, exactly.
"""
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

DEVICE_RTOL = 1e-5


def _arrays(mx, *xs):
    if mx is jmx:
        return [jmx.nd.array(x) for x in xs]
    return [tmx.nd.array(x, ctx=tmx.cpu()) for x in xs]


def _probs(rs, shape):
    p = rs.rand(*shape).astype(np.float32) + 0.05
    return p / p.sum(-1, keepdims=True)


def _metric_cases():
    rs = np.random.RandomState(0)
    cls = _probs(rs, (64, 10))
    lab = rs.randint(0, 10, 64).astype(np.float32)
    lm = _probs(rs, (4, 16, 50))
    lm_lab = rs.randint(0, 50, (4, 16)).astype(np.float32)
    lm_lab[0, :3] = 7
    reg = rs.randn(32, 1).astype(np.float32)
    reg_lab = rs.randn(32).astype(np.float32)
    two = _probs(rs, (40, 2))
    two_lab = rs.randint(0, 2, 40).astype(np.float32)
    return [
        ("acc", {}, np.array([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]],
                             np.float32), np.array([1, 0, 0], np.float32)),
        ("acc", {}, cls, lab),
        ("top_k_accuracy", {"top_k": 2},
         np.array([[0.5, 0.3, 0.2], [0.1, 0.2, 0.7]], np.float32),
         np.array([1, 0], np.float32)),
        ("top_k_accuracy", {"top_k": 3}, cls, lab),
        ("f1", {}, np.array([[0.1, 0.9], [0.9, 0.1], [0.2, 0.8],
                             [0.7, 0.3]], np.float32),
         np.array([1, 0, 0, 1], np.float32)),
        ("f1", {}, two, two_lab),
        ("mae", {}, np.array([[1.0], [2.0], [3.0]], np.float32),
         np.array([2.0, 2.0, 2.0], np.float32)),
        ("mse", {}, reg, reg_lab),
        ("rmse", {}, reg, reg_lab),
        ("mae", {}, reg, reg_lab),
        ("ce", {}, np.array([[0.5, 0.5], [0.9, 0.1]], np.float32),
         np.array([0, 0], np.float32)),
        ("ce", {}, cls, lab),
        ("perplexity", {"ignore_label": None}, lm, lm_lab),
        ("perplexity", {"ignore_label": 7}, lm, lm_lab),
        ("pearsonr", {}, reg, reg_lab),
        ("loss", {}, reg, reg_lab),
        ("torch", {}, reg, reg_lab),
        ("caffe", {}, reg, reg_lab),
    ]


CASES = _metric_cases()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_metric_matches_reference(i):
    name, kwargs, pred, label = CASES[i]
    got = []
    for mx in (tmx, jmx):
        m = mx.metric.create(name, **kwargs)
        p, l = _arrays(mx, pred, label)
        m.update([l], [p])
        m.update([l], [p])
        got.append(m.get())
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-6)


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[0] in (
    "acc", "ce", "perplexity", "mae", "mse", "rmse", "loss")])
def test_device_reduction_matches_numpy(i):
    """A metric handed bare torch tensors (as on the card) and one handed
    numpy arrays, against the reference's numpy metric on the same
    inputs; the accumulators are Python numbers."""
    name, kwargs, pred, label = CASES[i]
    ref = jmx.metric.create(name, **kwargs)
    ref.update(*[[a] for a in _arrays(jmx, label, pred)])
    for lab, prd in ((torch.from_numpy(label), torch.from_numpy(pred)),
                     (label, pred)):
        m = tmx.metric.create(name, **kwargs)
        m.update([lab], [prd])
        assert isinstance(m.sum_metric, (int, float))
        assert m.num_inst == ref.num_inst
        np.testing.assert_allclose(m.get()[1], ref.get()[1],
                                   rtol=DEVICE_RTOL)


def test_composite_custom_and_np():
    """A composite of accuracy, cross-entropy (a numpy float32 value,
    which the reference's composite fails to list) and a callable, and
    ``metric.np``: the values of the reference's metrics one by one."""
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum())

    pred = np.array([[0.9, 0.1], [0.3, 0.7]], np.float32)
    label = np.array([1, 1], np.float32)
    comp = tmx.metric.create(["acc", "ce", feval])
    assert isinstance(comp, tmx.metric.CompositeEvalMetric)
    p, l = _arrays(tmx, pred, label)
    comp.update([l], [p])
    names, values = comp.get()
    want = []
    for m in ("acc", "ce", feval):
        jm = jmx.metric.create(m)
        jm.update(*[[a] for a in _arrays(jmx, label, pred)])
        want.append(jm.get())
    assert names == [n for n, _ in want]
    np.testing.assert_allclose(values, [v for _, v in want], rtol=1e-6)
    ours, theirs = tmx.metric.np(feval, name="custom_abs"), \
        jmx.metric.np(feval, name="custom_abs")
    ours.update([l], [p])
    theirs.update(*[[a] for a in _arrays(jmx, label, pred)])
    assert ours.get() == theirs.get()


# -- iterators ---------------------------------------------------------------

def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)


def _descs(it):
    return [(d.name, tuple(d.shape)) for d in it.provide_data], \
        [(d.name, tuple(d.shape)) for d in it.provide_label]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarrayiter_matches_reference(handle):
    x = np.arange(40).reshape(10, 4).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    its = [mx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
           for mx in (tmx, jmx)]
    assert _descs(its[0]) == _descs(its[1])
    for _ in range(3):          # epochs: roll-over carries the cursor
        _same(_batches(its[0]), _batches(its[1]))
        for it in its:
            it.reset()
    b = next(iter(its[0]))
    assert b.data[0].context == torch.device("cpu")


def test_ndarrayiter_shuffle_and_dict():
    """A shuffle from ``rng`` equals the reference's from numpy's global
    generator seeded alike; dict inputs keep their names."""
    x = np.arange(24).reshape(12, 2).astype(np.float32)
    y = np.arange(12).astype(np.float32)
    ours = tmx.io.NDArrayIter({"data": x}, {"softmax_label": y},
                              batch_size=3, shuffle=True,
                              rng=np.random.RandomState(5))
    np.random.seed(5)
    theirs = jmx.io.NDArrayIter({"data": x}, {"softmax_label": y},
                                batch_size=3, shuffle=True)
    assert _descs(ours) == _descs(theirs)
    _same(_batches(ours), _batches(theirs))


def test_resize_and_prefetching_iters():
    x = np.arange(16).reshape(8, 2).astype(np.float32)
    y = np.arange(8).astype(np.float32)
    for make in (lambda mx: mx.io.ResizeIter(
                     mx.io.NDArrayIter(x, y, batch_size=3), 7),
                 lambda mx: mx.io.PrefetchingIter(
                     mx.io.NDArrayIter(x, y, batch_size=2))):
        ours, theirs = make(tmx), make(jmx)
        assert _descs(ours) == _descs(theirs)
        _same(_batches(ours), _batches(theirs))
        ours.reset()
        theirs.reset()
        _same(_batches(ours), _batches(theirs))


def test_csv_iter(tmp_path):
    data_path, label_path = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    x = np.random.RandomState(3).rand(7, 6).astype(np.float32)
    np.savetxt(data_path, x, delimiter=",")
    np.savetxt(label_path, np.arange(7).astype(np.float32), delimiter=",")
    for kw in ({"round_batch": True}, {"round_batch": False}):
        got = [_batches(mx.io.CSVIter(data_csv=data_path,
                                      data_shape=(2, 3),
                                      label_csv=label_path, batch_size=2,
                                      **kw))
               for mx in (tmx, jmx)]
        _same(*got)


def test_mnist_iter(tmp_path):
    """idx files written here (the format ``iter_mnist.cc`` parses), read
    flat and as images, shuffled by seed and not."""
    rs = np.random.RandomState(4)
    imgs = (rs.rand(10, 28, 28) * 255).astype(np.uint8)
    lbls = rs.randint(0, 10, 10).astype(np.uint8)
    img_path = str(tmp_path / "train-images-idx3-ubyte")
    lbl_path = str(tmp_path / "train-labels-idx1-ubyte")
    with open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 10, 28, 28))
        f.write(imgs.tobytes())
    with open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, 10))
        f.write(lbls.tobytes())
    for kw in ({"shuffle": False}, {"shuffle": True, "seed": 3},
               {"shuffle": False, "flat": True}):
        got = [mx.io.MNISTIter(image=img_path, label=lbl_path,
                               batch_size=4, **kw) for mx in (tmx, jmx)]
        assert _descs(got[0]) == _descs(got[1])
        _same(_batches(got[0]), _batches(got[1]))
    with pytest.raises(tmx.MXNetError):
        tmx.io.MNISTIter(image=str(tmp_path / "missing"), label=lbl_path)
