"""The port's GPT model half and decode math against the JAX package's, in
process (all plain jnp on the JAX side), on the committed ``gpt2_tiny``
fixture weights.

Tolerances: weights cross exactly (0 abs); logits 1e-4 abs and K/V caches
1e-5 abs, fp32 on both sides with sums taken in another order by XLA and
PyTorch (values of magnitude ~1).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ndarray import (load_ndarray_file, load_ndarray_list,
                                     save_ndarray_list)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURE = os.path.join(FIXDIR, "gpt2_tiny.params")
LOGIT_TOL = 1e-4
KV_TOL = 1e-5
HEADS = 4


def _fixture_tokens():
    spec = importlib.util.spec_from_file_location(
        "make_pretrained_fixture",
        os.path.join(REPO, "tools", "make_pretrained_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fixture_inputs()[1]


def _jax_net():
    from mxnet_tpu.gluon.model_zoo import gpt
    net = gpt.gpt2_tiny()
    net.load_params(FIXTURE)
    return net


def _port_net():
    return tgpt.gpt2_tiny().load_params(FIXTURE, device="cpu")


def _jax_arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# -- parameters ---------------------------------------------------------------

def test_v2_reader_matches_jax_reader():
    from mxnet_tpu.ndarray.serialization import load_ndarray_list as jload
    with open(FIXTURE, "rb") as f:
        data = f.read()
    ours, our_names = load_ndarray_list(data)
    theirs, their_names = jload(data)
    assert our_names == their_names and len(ours) == 28
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_v2_writer_round_trips_through_jax_reader(tmp_path):
    from mxnet_tpu.ndarray.serialization import load_ndarray_list as jload
    arrays, names = load_ndarray_file(FIXTURE)
    path = str(tmp_path / "copy.params")
    save_ndarray_list(path, arrays, names)
    with open(path, "rb") as f:
        back, back_names = jload(f.read())
    assert back_names == names
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)


def test_load_jax_params_matches_jax_loader():
    """Prefixed names from the JAX net's collect_params() and un-prefixed
    names from the .params file land on the same tensors.  Each package
    numbers its GPTLMs per process (``gptlm0_``, ``gptlm1_``, ...), so the
    two nets' names are matched without the model prefix."""
    jarrays = _jax_arrays(_jax_net())
    assert all(k.startswith("gptlm") for k in jarrays)
    from_jax = tgpt.load_jax_params(tgpt.gpt2_tiny(), jarrays, device="cpu")
    from_file = _port_net()
    ours = from_jax.collect_params()
    assert [k.split("_", 1)[1] for k in ours] == \
        [k.split("_", 1)[1] for k in jarrays]
    for p, q, want in zip(ours.values(),
                          from_file.collect_params().values(),
                          jarrays.values()):
        assert tuple(p.shape) == want.shape
        np.testing.assert_array_equal(p.data().asnumpy(), want)
        np.testing.assert_array_equal(q.data().asnumpy(), want)


@pytest.mark.parametrize("edit", ["missing", "extra", "shape", "twice"])
def test_load_jax_params_rejects_mismatch(edit):
    arrays, names = load_ndarray_file(FIXTURE)
    given = dict(zip(names, arrays))
    if edit == "missing":
        given.pop("wte_weight")
    elif edit == "extra":
        given["h_gptblock9_ln1_gamma"] = np.ones(128, np.float32)
    elif edit == "shape":
        given["wte_weight"] = given["wte_weight"][:-1]
    else:
        given["gptlm0_wte_weight"] = given["wte_weight"]
    with pytest.raises(ValueError):
        tgpt.load_jax_params(tgpt.gpt2_tiny(), given, device="cpu")


@pytest.mark.parametrize("factory", ["gpt2_tiny", "gpt2_small",
                                     "gpt2_medium"])
def test_model_configs_match_jax_parameter_layout(factory):
    from mxnet_tpu.gluon.model_zoo import gpt
    want = [(k.split("_", 1)[1], tuple(p.shape))
            for k, p in getattr(gpt, factory)().collect_params().items()]
    with torch.device("meta"):
        net = getattr(tgpt, factory)()
    got = [(k.split("_", 1)[1], tuple(p.shape))
           for k, p in net.collect_params().items()]
    assert got == want
    if factory == "gpt2_small":
        assert net._vocab == 50304 and len(net.blocks) == 12


def test_moe_config_is_not_ported():
    with pytest.raises(NotImplementedError):
        tgpt.gpt2_tiny_moe()


# -- decode math --------------------------------------------------------------

def _jax_decode_params(kv_heads=None):
    from mxnet_tpu.gluon.model_zoo import gpt
    return gpt.decode_params(_jax_net(), kv_heads=kv_heads)


@pytest.mark.parametrize("kv_heads", [None, 4, 2, 1])
def test_decode_params_match_jax(kv_heads):
    want = _jax_decode_params(kv_heads)
    got = tgpt.decode_params(_port_net(), kv_heads=kv_heads)
    assert sorted(got) == sorted(want)
    for k in ("wte", "wpe", "lnf_g", "lnf_b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for lg, lw in zip(got["layers"], want["layers"]):
        assert sorted(lg) == sorted(lw)
        for k in lw:
            np.testing.assert_allclose(lg[k].numpy(), np.asarray(lw[k]),
                                       rtol=0, atol=1e-7, err_msg=k)


def test_decode_params_rejects_non_divisor():
    with pytest.raises(ValueError):
        tgpt.decode_params(_port_net(), kv_heads=3)


def test_prefill_matches_jax():
    import jax.numpy as jnp
    from mxnet_tpu.gluon.model_zoo import gpt
    toks = _fixture_tokens()[:, :20]
    jlog, jcaches = gpt._prefill(_jax_decode_params(), jnp.asarray(toks),
                                 24, HEADS)
    p = tgpt.decode_params(_port_net())
    log, caches = tgpt._prefill(p, torch.from_numpy(toks).long(), 24,
                                HEADS)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
    for (k, v), (jk, jv) in zip(caches, jcaches):
        assert tuple(k.shape) == jk.shape == (2, HEADS, 24, 32)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0,
                                   atol=KV_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=KV_TOL)


def test_dense_logits_match_committed_fixture_logits():
    """The teacher-forced dense forward (the chip run's oracle) reproduces
    the logits the JAX GPTLM forward committed for these weights."""
    toks = torch.from_numpy(_fixture_tokens()).long()
    got = tgpt.dense_logits(tgpt.decode_params(_port_net()), toks, HEADS)
    want = np.load(os.path.join(FIXDIR, "gpt2_tiny_logits.npy"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def _paged_rows(p, toks, kv_heads, dtype, neighbour):
    """Slot 0 prefills 6 prompt tokens then decodes the rest teacher-forced;
    slot 1 is inactive, or (``neighbour``) decodes a sequence of its own
    in its own pages.  Returns slot 0's logits rows and first token."""
    page, n_pages, prompt = 4, 9, 6
    pools = [(torch.zeros(n_pages, page, kv_heads, 32, dtype=dtype),
              torch.zeros(n_pages, page, kv_heads, 32, dtype=dtype))
             for _ in p["layers"]]
    bt = torch.tensor([[3, 5, 1, 7], [2, 4, 6, 8]], dtype=torch.int32)
    padded = torch.cat([toks[:prompt], torch.zeros(4, dtype=torch.long)])
    log0, first, pools = tgpt.paged_prefill(p, padded, prompt, bt[0],
                                            pools, HEADS)
    rows = [log0]
    for t in range(prompt, len(toks)):
        log, _, pools = tgpt.paged_decode_step(
            p, torch.stack([toks[t], toks[t - prompt]]),
            torch.tensor([t, t - prompt]), torch.tensor([True, neighbour]),
            pools, bt, HEADS)
        rows.append(log[0])
    return torch.stack(rows), first


@pytest.mark.parametrize("kv_heads,dtype,tol", [
    (4, torch.float32, LOGIT_TOL), (2, torch.float32, LOGIT_TOL),
    # bf16 pools against the fp32 dense forward: K/V rounded to 8 bits
    (4, torch.bfloat16, 5e-2)])
def test_paged_programs_match_dense_and_ignore_occupancy(kv_heads, dtype,
                                                         tol):
    """paged_prefill + paged_decode_step reproduce the dense forward at
    every position, and a neighbour slot joining changes nothing."""
    p = tgpt.decode_params(_port_net(), kv_heads=kv_heads)
    toks = torch.from_numpy(_fixture_tokens()[0, :14]).long()
    alone, first = _paged_rows(p, toks, kv_heads, dtype, False)
    shared, _ = _paged_rows(p, toks, kv_heads, dtype, True)
    np.testing.assert_array_equal(alone.numpy(), shared.numpy())
    dense = tgpt.dense_logits(p, toks[None], HEADS)[0, 5:]
    np.testing.assert_allclose(alone.numpy(), dense.numpy(), rtol=0,
                               atol=tol)
    assert int(first) == int(alone[0].argmax())


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "layernorm", "attention"])
def test_layers_match_gluon_names_and_math(kind):
    """Parameter names and shapes equal Gluon's, and Dense, LayerNorm and
    causal FlashSelfAttention give Gluon's outputs on the same weights
    (1e-5 abs, fp32; in this process the JAX layer attends through its
    plain jnp path, the port's through the flash kernels' plain
    versions)."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn
    rng = np.random.RandomState(3)
    if kind == "dense":
        theirs = jnn.Dense(5, flatten=False, in_units=3, prefix="fc1_")
        ours = tnn.Dense(5, flatten=False, in_units=3, prefix="fc1_")
    elif kind == "layernorm":
        theirs = jnn.LayerNorm(in_channels=3, prefix="ln1_")
        ours = tnn.LayerNorm(in_channels=3, prefix="ln1_")
    else:
        theirs = jnn.FlashSelfAttention(8, 2, causal=True, in_units=8,
                                        prefix="attn_")
        ours = tnn.FlashSelfAttention(8, 2, causal=True, in_units=8,
                                      prefix="attn_")
    theirs.initialize()
    want = {k: tuple(p.shape) for k, p in theirs.collect_params().items()}
    got = {k: tuple(p.shape) for k, p in ours.collect_params().items()}
    assert list(got.items()) == list(want.items())
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in want.items()}
    for k, p in theirs.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    with torch.no_grad():
        for k, p in ours.collect_params().items():
            p.set_data(torch.from_numpy(arrays[k]))
        x = rng.randn(2, 4, 8 if kind == "attention" else 3) \
            .astype(np.float32)
        got_y = ours(torch.from_numpy(x)).numpy()
    want_y = theirs(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-5)
