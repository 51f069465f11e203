"""The graph rewrite pipeline of the port against the JAX package's laws
(``tests/test_graph_passes.py``), on the transformer-style graphs the port
has ops for.

- Pipeline on equals pipeline off, in eval and in training with every
  gradient (rtol 1e-6 fp32, as the reference's laws: the fused regions
  compute the same arithmetic; B4's plain version sums in another order
  than the unfused LayerNorm, within that tolerance); each pass alone;
  idempotence; the input symbol left untouched.
- DCE removes only unreachable nodes; fold evaluates parameter-free
  subgraphs and refuses ops with ``takes_train`` or ``needs_rng``; the
  fold size cap (a value of exactly the cap folds); CSE merges; the fused
  batch_dot and dense ops are bit-identical to the unfused ones.
- The pass report's ``rewrites``, ``nodes_before`` and ``nodes_after`` equal
  the reference's exactly on the same symbol built in both packages.
- ``MXTPU_GRAPH_PASSES`` selects and disables passes; a pass that raises
  leaves the bind on the unrewritten graph, logged.
"""
import contextlib
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import graph as G
from mxnet_tpu_torch.graph.graph import Graph
from mxnet_tpu_torch.graph.passes import run_pass

TOL = 1e-6


@contextlib.contextmanager
def pipeline_env(value):
    """MXTPU_GRAPH_PASSES override ('' = default pipeline, 'off' =
    disabled, 'fuse,dce' = explicit)."""
    prev = os.environ.get("MXTPU_GRAPH_PASSES")
    os.environ["MXTPU_GRAPH_PASSES"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MXTPU_GRAPH_PASSES", None)
        else:
            os.environ["MXTPU_GRAPH_PASSES"] = prev


def random_transformer_graph(mx, seed):
    """``tests/test_graph_passes.py``'s ``random_transformer_graph``, built
    with ``mx`` (this package or the JAX one): a randomized post-LN stack
    with LN(x + h) epilogues, dense + gelu, a symbolic (foldable) position
    chain and batch_dot."""
    r = np.random.RandomState(100 + seed)
    T, C = 6, 8
    x = mx.sym.Variable("data")
    pos = mx.sym.Reshape(mx.sym._arange(start=0, stop=T,
                                        name="pos%d" % seed),
                         shape=(1, T, 1))
    h = mx.sym.broadcast_add(x, pos * 0.01)
    for i in range(r.randint(1, 3)):
        a = mx.sym.FullyConnected(h, num_hidden=C, flatten=False,
                                  name="att%d_%d" % (seed, i))
        if r.randint(2):
            s = mx.sym.batch_dot(a, a, transpose_b=True,
                                 name="bd%d_%d" % (seed, i))
            a = mx.sym.batch_dot(mx.sym.softmax(s, axis=-1), a,
                                 name="bo%d_%d" % (seed, i))
        h = mx.sym.LayerNorm(h + a, name="ln%d_%d" % (seed, i))
        f = mx.sym.FullyConnected(h, num_hidden=2 * C, flatten=False,
                                  name="f1%d_%d" % (seed, i))
        f = mx.sym.Activation(f, act_type="gelu",
                              name="g%d_%d" % (seed, i))
        f = mx.sym.FullyConnected(f, num_hidden=C, flatten=False,
                                  name="f2%d_%d" % (seed, i))
        h = mx.sym.LayerNorm(h + f, name="lf%d_%d" % (seed, i))
    h = mx.sym.FullyConnected(h, num_hidden=4, name="head%d" % seed)
    return mx.sym.SoftmaxOutput(h, name="softmax"), \
        {"data": (2, T, C), "softmax_label": (2,)}


def _bind_and_run(sym, shapes, passes, seed, train):
    """Bind on the CPU under the given pipeline config, seed the
    parameters, run forward (and backward when ``train``); returns
    ``(outs, grads, exe)``."""
    with pipeline_env(passes):
        exe = sym.simple_bind(mx.cpu(), grad_req="write" if train
                              else "null", **shapes)
    r = np.random.RandomState(seed)
    feeds = {}
    for name, arr in sorted(exe.arg_dict.items()):
        if name == "data":
            feeds[name] = r.randn(*arr.shape).astype(np.float32)
        elif name.endswith("label"):
            feeds[name] = r.randint(0, 3, arr.shape).astype(np.float32)
        else:
            arr[:] = r.randn(*arr.shape).astype(np.float32) * 0.2
    outs = [o.asnumpy().copy() for o in exe.forward(is_train=train,
                                                    **feeds)]
    grads = {}
    if train:
        exe.backward()
        grads = {k: v.asnumpy().copy() for k, v in exe.grad_dict.items()}
    return outs, grads, exe


def assert_equivalent(sym, shapes, passes="", seed=0, train=False):
    o_off, g_off, _ = _bind_and_run(sym, shapes, "off", seed, train)
    o_on, g_on, exe = _bind_and_run(sym, shapes, passes, seed, train)
    for a, b in zip(o_off, o_on):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert set(g_off) == set(g_on)
    for k in g_off:
        np.testing.assert_allclose(g_off[k], g_on[k], rtol=TOL, atol=TOL,
                                   err_msg="grad %s" % k)
    return exe


# -- whole-pipeline laws -------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transformer_graph_equivalent(seed, train):
    sym, shapes = random_transformer_graph(mx, seed)
    exe = assert_equivalent(sym, shapes, seed=seed, train=train)
    assert exe._graph_report["rewrites"]["layer_norm_residual"] >= 2


@pytest.mark.parametrize("passname", ["fuse", "fold", "cse", "dce"])
def test_each_pass_alone_is_equivalent(passname):
    sym, shapes = random_transformer_graph(mx, 0)
    assert_equivalent(sym, shapes, passes=passname, seed=0, train=True)


def test_pipeline_idempotent():
    sym, _ = random_transformer_graph(mx, 1)
    once, rep1 = G.optimize(sym)
    twice, rep2 = G.optimize(once)
    assert rep1["rewrites"]
    assert not rep2["rewrites"], rep2
    assert rep2["nodes_after"] == rep1["nodes_after"]
    assert twice is once  # no rewrites: the same symbol handed back


def test_pipeline_leaves_original_symbol_untouched():
    sym, shapes = random_transformer_graph(mx, 0)
    before = [(n.name, None if n.op is None else n.op.name)
              for n in sym._topo_nodes()]
    G.optimize(sym)
    after = [(n.name, None if n.op is None else n.op.name)
             for n in sym._topo_nodes()]
    assert before == after
    with pipeline_env("off"):
        exe = sym.simple_bind(mx.cpu(), grad_req="null", **shapes)
    exe.forward(is_train=False, data=np.zeros(shapes["data"], np.float32))


@pytest.mark.parametrize("build", ["transformer-0", "transformer-1",
                                   "transformer-2", "gpt"])
def test_report_equals_reference(build):
    """The same symbol built in both packages: the reports' rewrites and
    node counts are equal, pass by pass.  The JAX side of "gpt" is
    ``graph_probe.build_gpt_sym`` itself, the port's chip_smoke's copy."""
    import mxnet_tpu
    from mxnet_tpu import graph as JG
    from tools.perf_probe import graph_probe
    import chip_smoke

    def make(pkg):
        if build == "gpt" and pkg is mxnet_tpu:
            return graph_probe.build_gpt_sym(layers=2, units=64, heads=4,
                                             seq=16, vocab=128)[0]
        if build == "gpt":
            return chip_smoke.build_gpt_sym(pkg, layers=2, units=64,
                                            heads=4, seq=16, vocab=128)
        return random_transformer_graph(pkg, int(build[-1]))[0]
    want_sym, got_sym = make(mxnet_tpu), make(mx)
    assert got_sym.list_arguments() == want_sym.list_arguments()
    _, want = JG.optimize(want_sym)
    _, got = G.optimize(got_sym)
    for key in ("rewrites", "nodes_before", "nodes_after", "ops_before",
                "ops_after", "pipeline"):
        assert got[key] == want[key], key
    assert [{k: v for k, v in p.items() if k != "ms"}
            for p in got["passes"]] == \
        [{k: v for k, v in p.items() if k != "ms"} for p in want["passes"]]


def test_reference_graph_copy_is_faithful():
    """The graph function above equals the reference test's own, node for
    node."""
    import mxnet_tpu
    from test_graph_passes import random_transformer_graph as ref_graph
    from mxnet_tpu.name import NameManager
    for seed in (0, 1, 2):
        with NameManager():     # fresh counters: auto-names equal too
            a, sa = ref_graph(seed)
        with NameManager():
            b, sb = random_transformer_graph(mxnet_tpu, seed)
        assert sa == sb
        assert a.tojson() == b.tojson()


# -- per-pass unit laws ---------------------------------------------------------------

def test_dce_removes_only_unreachable():
    a = mx.sym.Variable("a")
    live = mx.sym.Activation(a, act_type="relu", name="live")
    dead = mx.sym.Activation(a, act_type="tanh", name="dead")
    g = Graph.from_symbol(live)
    g.nodes.append(dead._outputs[0][0])
    out, stats = run_pass("dce", g)
    assert stats["removed"] == 1
    names = {n.name for n in out.nodes}
    assert "live" in names and "dead" not in names
    out2, stats2 = run_pass("dce", out)
    assert stats2["removed"] == 0 and len(out2.nodes) == len(out.nodes)


def test_fold_evaluates_param_free_subgraph():
    T = 5
    q = mx.sym.Reshape(mx.sym._arange(start=0, stop=T), shape=(T, 1))
    k = mx.sym.Reshape(mx.sym._arange(start=0, stop=T), shape=(1, T))
    mask = (mx.sym.broadcast_greater_equal(q, k) - 1.0) * 1e9
    x = mx.sym.Variable("x")
    out = mx.sym.broadcast_add(x, mask)
    opt, report = G.optimize(out, passes=("fold", "dce"))
    ops = [n.op.name for n in opt._topo_nodes() if not n.is_var]
    assert "_graph_constant" in ops and "_arange" not in ops
    assert report["rewrites"]["constants"] == 1
    xin = np.random.RandomState(0).randn(T, T).astype(np.float32)
    with pipeline_env("off"):
        ref = out.bind(mx.cpu(), args={"x": mx.nd.array(xin, mx.cpu())},
                       grad_req="null").forward()[0].asnumpy()
        got = opt.bind(mx.cpu(), args={"x": mx.nd.array(xin, mx.cpu())},
                       grad_req="null").forward()[0].asnumpy()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(
        got, xin + (np.tril(np.ones((T, T), np.float32)) - 1) * 1e9)


def _register_test_ops():
    """Two parameter-free test ops: one that draws random numbers and one
    that behaves differently in training (as the reference's ``_random_*``
    and ``Dropout`` do)."""
    from mxnet_tpu_torch.ops.registry import _OP_REGISTRY, register_op
    if "_test_rng_source" not in _OP_REGISTRY:
        register_op("_test_rng_source", arg_names=(), needs_rng=True,
                    param_defaults={"shape": (3, 3)})(
            lambda shape=(3, 3), _device=None: torch.zeros(shape,
                                                           device=_device))
        register_op("_test_train_only", takes_train=True)(
            lambda data, _train=False: data * (2.0 if _train else 1.0))


def test_fold_skips_rng_and_train_dependent_ops():
    _register_test_ops()
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.symbol.symbol import _apply_op
    u = _apply_op(get_op("_test_rng_source"), None, [], {})
    t = _apply_op(get_op("_test_train_only"), None,
                  [mx.sym._arange(start=0, stop=9)], {})
    out = mx.sym.broadcast_add(u, mx.sym.Reshape(t, shape=(3, 3))) + 1.0
    opt, report = G.optimize(out, passes=("fold", "dce"))
    ops = [n.op.name for n in opt._topo_nodes() if not n.is_var]
    assert "_test_rng_source" in ops and "_test_train_only" in ops
    # the arange under the train-dependent op folds; nothing after it does
    assert report["rewrites"].get("constants", 0) == 1
    assert "_arange" not in ops and "_plus_scalar" in ops
    # and the executor runs the random op (it draws from the device's
    # generator, mx.random): zeros + arange + 1 in inference
    with pipeline_env("off"):
        got = out.simple_bind(mx.cpu(), grad_req="null").forward()[0]
    np.testing.assert_array_equal(
        got.asnumpy(), np.arange(9, dtype=np.float32).reshape(3, 3) + 1)


@pytest.mark.parametrize("cap,folds", [(8, False), (256, True)])
def test_fold_respects_size_cap(cap, folds, monkeypatch):
    """64 float32 values are 256 bytes: over an 8-byte cap they stay, at a
    cap of exactly 256 they fold (``nbytes > cap`` refuses)."""
    monkeypatch.setenv("MXTPU_GRAPH_FOLD_MAX_BYTES", str(cap))
    big = mx.sym._arange(start=0, stop=64)
    out = mx.sym.broadcast_add(mx.sym.Variable("x"), big)
    opt, _ = G.optimize(out, passes=("fold", "dce"))
    ops = [n.op.name for n in opt._topo_nodes() if not n.is_var]
    assert ("_graph_constant" in ops) == folds
    assert ("_arange" in ops) == (not folds)


def test_cse_merges_identical_subexpressions():
    x = mx.sym.Variable("x")
    a = mx.sym.Activation(x, act_type="tanh", name="s1")
    b = mx.sym.Activation(x, act_type="tanh", name="s2")
    out = a * b
    opt, report = G.optimize(out, passes=("cse", "dce"))
    ops = [n.op.name for n in opt._topo_nodes() if not n.is_var]
    assert ops.count("Activation") == 1
    assert report["rewrites"]["merged"] == 1
    xin = np.random.RandomState(0).randn(2, 2).astype(np.float32)
    got = opt.bind(mx.cpu(), args={"x": mx.nd.array(xin, mx.cpu())},
                   grad_req="null").forward()[0].asnumpy()
    np.testing.assert_allclose(got, np.tanh(xin) ** 2, rtol=1e-6)


def test_cse_never_merges_rng_ops():
    _register_test_ops()
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.symbol.symbol import _apply_op
    d1 = _apply_op(get_op("_test_rng_source"), "d1", [], {})
    d2 = _apply_op(get_op("_test_rng_source"), "d2", [], {})
    opt, report = G.optimize(d1 + d2, passes=("cse", "dce"))
    ops = [n.op.name for n in opt._topo_nodes() if not n.is_var]
    assert ops.count("_test_rng_source") == 2
    assert report["rewrites"].get("merged", 0) == 0


def test_cse_merges_equal_folded_constants():
    """Two blocks' causal biases fold to equal literals, which CSE merges
    into one node: the executor places one device tensor."""
    def bias(name):
        q = mx.sym.Reshape(mx.sym._arange(start=0, stop=4,
                                          name="%s_q" % name), shape=(4, 1))
        k = mx.sym.Reshape(mx.sym._arange(start=0, stop=4,
                                          name="%s_k" % name), shape=(1, 4))
        return (mx.sym.broadcast_greater_equal(q, k) - 1.0) * 1e9
    x = mx.sym.Variable("x")
    out = mx.sym.broadcast_add(mx.sym.broadcast_add(x, bias("a")), bias("b"))
    opt, report = G.optimize(out)
    consts = [n for n in opt._topo_nodes()
              if not n.is_var and n.op.name == "_graph_constant"]
    assert report["rewrites"]["constants"] == 2
    assert report["rewrites"]["merged"] >= 1 and len(consts) == 1


def test_fused_batch_dot_bit_exact():
    r = np.random.RandomState(0)
    a = r.randn(2, 3, 4).astype(np.float32)
    b = r.randn(2, 5, 4).astype(np.float32)
    la, lb = mx.sym.Variable("a"), mx.sym.Variable("b")
    out = mx.sym.batch_dot(la, lb, transpose_b=True)
    args = {"a": mx.nd.array(a, mx.cpu()), "b": mx.nd.array(b, mx.cpu())}
    with pipeline_env("off"):
        ref = out.bind(mx.cpu(), args=args, grad_req="null") \
            .forward()[0].asnumpy()
    opt, report = G.optimize(out, passes=("fuse", "dce"))
    assert report["rewrites"]["batch_dot"] == 1
    with pipeline_env("off"):
        got = opt.bind(mx.cpu(), args=args, grad_req="null") \
            .forward()[0].asnumpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("act", ["gelu", "relu", None])
def test_fused_dense_bit_exact(act):
    """FullyConnected (-> Activation) and ``_fused_dense_act`` call the same
    ``F.linear``: equal to the last bit, forward and gradients."""
    x = mx.sym.Variable("data")
    y = mx.sym.FullyConnected(x, num_hidden=6, flatten=False, name="fc")
    if act:
        y = mx.sym.Activation(y, act_type=act, name="act")
    y = mx.sym.LayerNorm(y, name="ln")
    o_off, g_off, _ = _bind_and_run(y, {"data": (2, 3, 5)}, "off", 3, True)
    o_on, g_on, exe = _bind_and_run(y, {"data": (2, 3, 5)}, "fuse,dce", 3,
                                    True)
    assert exe._graph_report["rewrites"]["dense_act" if act
                                         else "dense_bare"] == 1
    np.testing.assert_array_equal(o_off[0], o_on[0])
    for k in g_off:
        np.testing.assert_array_equal(g_off[k], g_on[k], err_msg=k)


def test_fused_region_node_attrs_name_constituents():
    x = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
    y = mx.sym.LayerNorm(x + h, name="ln")
    opt, _ = G.optimize(y, passes=("fuse",))
    node = [n for n in opt._topo_nodes() if not n.is_var
            and n.op.name == "_fused_layer_norm_residual"][0]
    assert node.attrs["__fused_ops__"] == "elemwise_add+LayerNorm"
    assert node.name == "ln"  # tail name: output names preserved
    assert [i.name for i, _ in node.inputs] == ["data", "fc", "ln_gamma",
                                                "ln_beta"]


def test_residual_feeding_two_consumers_is_not_fused():
    """Pre-LN wiring: the sum feeds the LayerNorm AND the next residual,
    so the match's single-consumer rule leaves it alone."""
    x = mx.sym.Variable("data")
    s = x + mx.sym.FullyConnected(x, num_hidden=4, flatten=False, name="fc")
    out = mx.sym.LayerNorm(s, name="ln") + s
    _, report = G.optimize(out)
    assert "layer_norm_residual" not in report["rewrites"]


# -- configuration ----------------------------------------------------------------------

def test_env_selects_passes_and_off_disables():
    sym, shapes = random_transformer_graph(mx, 0)
    with pipeline_env("dce"):
        assert G.pipeline_config() == ("dce",)
        exe = sym.simple_bind(mx.cpu(), grad_req="null", **shapes)
        assert [p["name"] for p in exe._graph_report["passes"]] == ["dce"]
    with pipeline_env("off"):
        assert G.pipeline_config() == () and not G.enabled()
        exe = sym.simple_bind(mx.cpu(), grad_req="null", **shapes)
        assert exe._graph_report is None
    with pipeline_env("fuse,nonsense,dce"):
        assert G.pipeline_config() == ("fuse", "dce")
    assert G.last_report() is not None


def test_pass_failure_falls_back_to_the_unrewritten_graph(monkeypatch,
                                                          caplog):
    from mxnet_tpu_torch.graph import passes

    def broken(graph):
        raise RuntimeError("broken pass")
    monkeypatch.setitem(passes._PASSES, "fuse", broken)
    sym, shapes = random_transformer_graph(mx, 0)
    with pipeline_env(""), caplog.at_level(logging.WARNING):
        exe = sym.simple_bind(mx.cpu(), grad_req="null", **shapes)
    assert exe._opt_symbol is sym and exe._graph_report is None
    assert "broken pass" in caplog.text
    out = exe.forward(data=np.ones(shapes["data"], np.float32))[0]
    assert out.shape == (2, 4)
