"""Inventory lints for the port: its fault sites, metric names and typed
verdicts against the reference's documents and modules.

- Every fault site the port checks is a row of ROBUSTNESS.md §4, every
  metric it registers a row of OBSERVABILITY.md with the same type, every
  ``VERDICT_*`` it defines a row of SERVING.md's verdict table (the
  reference's tables, read and never edited; their parsers are the
  reference lints' own).
- Every such name in the reference modules this slice ports (the host
  planes and the serving package) exists in the port.
- Every name the port uses is exercised by a ``tests/test_torch_*.py``
  file (this lint's own text does not count).
"""
import ast
import os

import pytest

import test_fault_inventory as fault_lint
import test_metrics_inventory as metrics_lint
import test_verdict_inventory as verdict_lint

pytestmark = pytest.mark.telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mxnet_tpu_torch")

#: names of the reference's XLA mechanics, which the port drops
#: (CHANGES.md): the per-program cost attribution from XLA's cost analysis
XLA_ONLY = {"serving.cost.<>.<>", "xla.cost.<>_per_step", "xla.memory.<>"}
#: the reference's mesh and ZeRO gauges (ported with the data-parallel
#: slice: checked like every other name)
MULTI_DEVICE = {"sharding.collective_bytes_modeled",
                "sharding.collective_bytes_per_step",
                "sharding.opt_state_bytes_per_device", "sharding.zero_stage"}

#: the reference modules whose port this slice made or wired: every name
#: they carry must exist in the port
SLICE = ["fault.py", "elastic.py", "telemetry.py", "profiler.py",
         "watchdog.py", "checkpoint.py", "serving/engine.py",
         "serving/scheduler.py", "serving/prefix_cache.py",
         "serving/slo.py", "serving/kv_cache.py", "serving/replica.py",
         "serving/router.py", "serving/rpc.py",
         # the training planes and the stream
         "config.py", "recordio.py", "stream/__init__.py",
         "stream/manifest.py", "stream/assignment.py", "stream/loader.py",
         "stream/fit.py", "gluon/data/dataloader.py", "module/module.py",
         "module/base_module.py", "gluon/trainer.py", "kvstore.py",
         "executor.py", "callback.py", "model.py", "monitor.py",
         # the image and detection data plane and the contrib ops
         "_native.py", "io.py", "image/__init__.py", "image/image.py",
         "image/detection.py", "gluon/data/dataset.py", "ops/contrib.py",
         "ops/tensor.py",
         # the RNN family
         "ops/rnn.py", "ops/nn.py", "initializer.py", "rnn/__init__.py",
         "rnn/rnn_cell.py", "rnn/io.py", "rnn/rnn.py",
         "gluon/rnn/__init__.py", "gluon/rnn/rnn_cell.py",
         "gluon/rnn/rnn_layer.py", "module/bucketing_module.py",
         # the operator registry's tail and mx.operator
         "operator.py", "ops/random_ops.py", "ops/rcnn.py", "ops/tail.py",
         # the data-parallel plane
         "optimizer.py", "gradient_compression.py", "parallel/__init__.py",
         "parallel/mesh.py", "parallel/collectives.py",
         "parallel/_shard_map.py", "parallel/sharding.py",
         "parallel/data_parallel.py"]


def _port_files():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _sites(paths):
    out = set()
    for p in paths:
        out.update(m.group(1) for m in fault_lint._CALL_RE.finditer(_read(p)))
    return out


def _metrics(paths):
    """{normalized name: {kind}} registered in ``paths`` (each package's
    telemetry.py registers through its bare helpers)."""
    out = {}
    for p in paths:
        src = _read(p)
        rex = metrics_lint._BARE_RE if p.endswith("telemetry.py") \
            else metrics_lint._CALL_RE
        for m in rex.finditer(src):
            out.setdefault(metrics_lint._norm(m.group(2)), set()).add(
                m.group(1))
        for kind, irex in metrics_lint._INDIRECT_RES:
            for m in irex.finditer(src):
                out.setdefault(metrics_lint._norm(m.group(1)), set()).add(
                    kind)
    return out


def _verdicts(paths):
    out = set()
    for p in paths:
        out.update(m.group(1) for m in verdict_lint._DEF_RE.finditer(_read(p)))
    return out


PORT_FILES = list(_port_files())
REF_SLICE = [os.path.join(REPO, "mxnet_tpu", f) for f in SLICE]
PORT_SLICE = [os.path.join(PORT, f) for f in SLICE]


def _law_sources():
    """The source of every reference law a ``tests/test_torch_*.py`` file
    runs on the port (``port_law_module``), from the reference's file."""
    import test_torch_checkpoint
    import test_torch_fleet
    import test_torch_stream
    import test_torch_stream_fit
    import test_torch_telemetry
    import test_torch_training_planes
    laws = {"test_serving_rpc.py": test_torch_fleet.RPC_LAWS,
            "test_stream.py": test_torch_stream.LAWS,
            "test_stream_fit.py": test_torch_stream_fit.LAWS}
    for mod in (test_torch_checkpoint, test_torch_telemetry,
                test_torch_training_planes):
        for fname, names in mod.LAWS.items():
            laws.setdefault(fname, []).extend(names)
    out = []
    for fname, names in laws.items():
        tree = ast.parse(_read(os.path.join(REPO, "tests", fname)))
        src = _read(os.path.join(REPO, "tests", fname)).splitlines()
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name in names:
                out.append("\n".join(src[node.lineno - 1:node.end_lineno]))
    return out


def _corpus():
    """Text of every ``tests/test_torch_*.py`` but this one, and of the
    reference laws they run on the port."""
    tests = os.path.join(REPO, "tests")
    return [_read(os.path.join(tests, f)) for f in sorted(os.listdir(tests))
            if f.startswith("test_torch_") and f.endswith(".py")
            and f != os.path.basename(__file__)] + _law_sources()


def test_slice_files_exist_in_the_port():
    missing = [f for f in PORT_SLICE if not os.path.exists(f)]
    assert not missing
    assert os.path.exists(os.path.join(PORT, "serving", "worker.py"))


def test_slice_sites_and_metrics_are_wired():
    """The training planes' fault sites and metrics are in the port."""
    sites, metrics = _sites(PORT_FILES), _metrics(PORT_FILES)
    for site in ("grad.nan", "step.slow", "worker.stall", "worker.lost",
                 "kv.hang", "data.stall", "data.slow", "data.prefetch",
                 "io.shard.torn", "io.decode.error", "io.decode.slow"):
        assert site in sites, site
    for name in ("kv.push_keys", "kv.pull_keys", "kv.world_changes",
                 "data.batches", "io.records", "io.bytes", "io.torn_records",
                 "io.shards_open", "io.epoch_prefetch",
                 "sharding.fallbacks") + tuple(sorted(MULTI_DEVICE)):
        assert any(metrics_lint._matches(name, n) for n in metrics), name


def test_scans_are_alive():
    assert len(_sites(PORT_FILES)) >= 20
    assert len(_metrics(PORT_FILES)) >= 80
    assert len(_verdicts(PORT_FILES)) >= 10


@pytest.mark.parametrize("kind", ["sites", "metrics", "verdicts"])
def test_every_port_name_is_documented(kind):
    if kind == "sites":
        doc = fault_lint.sites_in_doc()
        bad = sorted(_sites(PORT_FILES) - doc)
    elif kind == "metrics":
        doc = metrics_lint.metrics_in_doc()
        bad = sorted(n for n in _metrics(PORT_FILES)
                     if not any(metrics_lint._matches(n, d) for d in doc))
    else:
        bad = sorted(_verdicts(PORT_FILES) - set(verdict_lint.
                                                  verdicts_in_doc()))
    assert not bad, "%s the port uses that the reference's tables " \
        "do not document: %s" % (kind, bad)


def test_port_metric_types_match_the_documents():
    doc = metrics_lint.metrics_in_doc()
    wrong = []
    for name, kinds in _metrics(PORT_FILES).items():
        for d, typ in doc.items():
            if metrics_lint._matches(name, d) and \
                    not any(k in typ for k in kinds):
                wrong.append((name, sorted(kinds), typ.strip()))
    assert not wrong


@pytest.mark.parametrize("kind", ["sites", "metrics", "verdicts"])
def test_every_slice_name_of_the_reference_exists_in_the_port(kind):
    scan = {"sites": _sites, "metrics": _metrics, "verdicts": _verdicts}[kind]
    ref, port = scan(REF_SLICE), scan(PORT_SLICE)
    if kind == "metrics":
        missing = sorted(n for n in ref if n not in XLA_ONLY
                         and
                         not any(metrics_lint._matches(n, p)
                                 for p in port))
    else:
        missing = sorted(set(ref) - set(port))
    assert not missing, "%s of the reference's slice modules missing " \
        "from the port: %s" % (kind, missing)


@pytest.mark.parametrize("kind", ["sites", "metrics", "verdicts"])
def test_every_port_name_is_exercised_by_a_port_test(kind):
    corpus = _corpus()
    if kind == "sites":
        names = _sites(PORT_FILES)
    elif kind == "verdicts":
        names = _verdicts(PORT_FILES)
    else:
        # a parameterized family counts through its literal prefix
        names = {n.split("<>")[0].rstrip(".") for n in _metrics(PORT_FILES)}
    unexercised = sorted(n for n in names
                         if not any(n in text for text in corpus))
    assert not unexercised, "%s no tests/test_torch_*.py file " \
        "exercises: %s" % (kind, unexercised)
