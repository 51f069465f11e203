"""The port's 2-bit gradient compression
(``mxnet_tpu_torch/gradient_compression.py``) against the JAX package's.

The same numpy-seeded gradients go through both packages' compressors:
the packed bytes, the decoded values and the error-feedback residuals are
equal exactly, step after step (the arithmetic is one fp32 add, two
compares and a subtraction per element).  The wire is 16 times smaller
than fp32.  The KVStore's compressed push on one process replaces the
merged gradient by its quantized image in both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gradient_compression as tgc

SIZES = [1, 3, 4, 5, 17, 1000, 4099]


def _grads(size, steps, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(size).astype(np.float32) * 0.6
            for _ in range(steps)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("threshold", [0.5, 0.1])
def test_codes_bytes_and_residuals_equal_reference(size, threshold):
    import jax.numpy as jnp
    from mxnet_tpu import gradient_compression as jgc
    jc = jgc.TwoBitCompression(threshold)
    tc = tgc.TwoBitCompression(threshold)
    for g in _grads(size, 4, size):
        jp = np.asarray(jc.compress("k", jnp.asarray(g)))
        tp = tc.compress("k", torch.from_numpy(g)).numpy()
        assert tp.dtype == np.uint8 and tp.shape == (-(-size // 4),)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc._residuals["k"].numpy(),
                                      np.asarray(jc._residuals["k"]))
        np.testing.assert_array_equal(
            tc.decompress(torch.from_numpy(tp), (size,),
                          torch.float32).numpy(),
            np.asarray(jc.decompress(jnp.asarray(jp), (size,),
                                     jnp.float32)))
    # the wire: 16 times fewer bytes than the fp32 gradient (rounded up)
    assert tp.nbytes * 16 >= g.nbytes > (tp.nbytes - 1) * 16


def test_step_and_decode_functions_equal_reference():
    import jax.numpy as jnp
    from mxnet_tpu import gradient_compression as jgc
    g = _grads(1001, 1, 7)[0]
    r = _grads(1001, 1, 8)[0] * 0.3
    jp, jr = jgc._compress_step(jnp.asarray(g), jnp.asarray(r),
                                jnp.float32(0.5))
    tp, tr = tgc._compress_step(torch.from_numpy(g), torch.from_numpy(r),
                                0.5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    rows = np.stack([np.asarray(jp), np.asarray(jp)[::-1]])
    np.testing.assert_array_equal(
        tgc._decode(torch.from_numpy(rows), 0.5, 1001).numpy(),
        np.asarray(jgc._decode(jnp.asarray(rows), jnp.float32(0.5), 1001)))


def test_create_compressor_and_errors_match_reference():
    from mxnet_tpu import gradient_compression as jgc
    for gc in (jgc, tgc):
        assert gc.create_compressor({"type": "none"}) is None
        assert gc.create_compressor(None) is None
        c = gc.create_compressor({"type": "2bit", "threshold": 0.25})
        assert c.type == "2bit" and c.threshold == 0.25
        with pytest.raises(ValueError):
            gc.create_compressor({"type": "1bit"})
        with pytest.raises(ValueError):
            gc.TwoBitCompression(0.0)


def test_reset_state_drops_residuals():
    c = tgc.TwoBitCompression(0.5)
    c.compress("k", torch.ones(8))
    assert c._residuals
    c.reset_state()
    assert not c._residuals


def test_local_store_quantized_push_equals_reference():
    """``set_gradient_compression`` on a one-process store: three pushes
    of two devices' values, each merged then quantized with the residual
    carried, pulled back equal to the reference's."""
    import mxnet_tpu as jmx
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((4, 5)).astype(np.float32)
    pulled = []
    for mx, mk in ((jmx, lambda a: jmx.nd.array(a)),
                   (tmx, lambda a: tmx.nd.array(a, ctx=tmx.cpu()))):
        kv = mx.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.4})
        kv.init("w", mk(w0))
        r = np.random.default_rng(4)
        got = []
        for _ in range(3):
            kv.push("w", [mk(r.standard_normal((4, 5)).astype(np.float32)
                             * 0.3) for _ in range(2)])
            out = mk(np.zeros((4, 5), np.float32))
            kv.pull("w", out=out)
            got.append(out.asnumpy())
        pulled.append(got)
        # the same params again keep the live compressor (and residuals)
        comp = kv._compressor
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.4})
        assert kv._compressor is comp
    for want, got in zip(*pulled):
        np.testing.assert_array_equal(got, want)
