"""The harness on the CPU: discovery by name, the contract's names and
keys, the import boundary, refusal without a card, and traffic that the
seed alone decides."""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run, spec
from portbench.generators import closed_loop, dense_batches, packed_documents
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "mxnet_tpu"}
REPO = spec.ROOT


def top_level_imports(path):
    """Top-level names of every module a file imports (relative imports
    name their own package)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def sources(sub=""):
    base = os.path.join(spec.PACKAGE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def banned(names):
    return sorted(n for n in names if n in BANNED)


def test_whole_word_boundary_tells_the_port_from_the_jax_package():
    assert banned({"mxnet_tpu_torch", "torch", "numpy"}) == []
    assert banned({"mxnet_tpu", "jax"}) == ["jax", "mxnet_tpu"]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        assert banned(top_level_imports(path)) == [], path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = top_level_imports(path)
        assert "mxnet_tpu_torch" not in names, path
        assert banned(names) == [], path
        assert names <= {"torch", "math", "contextlib", "__future__"}, path


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxnet_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "mxnet_tpu_torch_fake", sys)
    assert run.forbidden_modules() == ["mxnet_tpu.fake"]


def test_benchmark_json_follows_the_contract():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + \
        [w["name"] for w in bench["workloads"]] + \
        [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]] + \
            [w["config"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        for k in c["reduced"]:
            assert NAME.match(k), k
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # every cell that reports it reports what it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in bench["workloads"]:
        cell = spec.Cell(REPO, bench, w["name"])
        reported = [m["name"] for m in cell.end_to_end()]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer()
    assert len(json.dumps(bench)) < 64 * 1024


def _unchanged(pkg):
    """Every file the benchmark had is byte for byte as it was in the
    copy at ``pkg``."""
    for path in sources():
        rel = os.path.relpath(path, spec.PACKAGE)
        if rel.startswith("tests"):
            continue
        with open(path, "rb") as a, open(os.path.join(pkg, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_a_new_config_cell_mix_and_metric_are_files_and_entries(tmp_path):
    """A later PR adds a configuration, a cell, a mix and a per-layer
    metric as new files and new BENCHMARK.json entries: the harness
    finds them, and no file that was there changes."""
    root = tiny.make_root(tmp_path)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "metrics", "tiny_tokens.train.py"),
              "w") as f:
        f.write("def read(t):\n    return t.get('steps')\n")
    bench = spec.load(root)
    bench["per_layer"].append({
        "name": "tiny_tokens.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "trainer",
        "moves": "train_step_ms", "workloads": ["tiny.train_dense"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = tiny.cell(root, "tiny.train_dense")
    assert cell.config["n_embd"] == tiny.TINY_CONFIG["n_embd"]
    assert cell.traffic == tiny.TINY_TRAFFIC["tiny_dense"]
    assert "tiny_tokens.train" in [m["name"] for m in cell.per_layer()]
    assert cell.metric_reader("tiny_tokens.train")({"steps": 3}) == 3
    _unchanged(pkg)


#: forms of traffic the benchmark does not have, as a later PR would add
#: them: a training pool drawn another way, and an open loop of requests
#: that arrive at a fixed rate whether or not the last ones finished
NEW_FORMS = {
    "tiny_shifted": ("tiny.train_dense", {"batch": 4, "seq_len": 32,
                                          "pool": 4}, """
import torch


def batches(mix, cfg, seed, device):
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    x = torch.randint(0, cfg["vocab_size"],
                      (mix["pool"], mix["batch"], mix["seq_len"] + 1),
                      generator=g, device=device)
    return [(x[i, :, :-1], x[i, :, 1:], None) for i in range(mix["pool"])]
"""),
    "tiny_open": ("tiny.serve_decode", {"rate": 40.0, "prompt": 10,
                                        "output": 6, "warmup_s": 0.2}, """
import numpy as np


class Requests:
    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(seed % 2 ** 63)

    def _due(self, now):
        out, gap = [], 1.0 / self.mix["rate"]
        while self.t0 + self.sent * gap <= now:
            prompt = self.rng.integers(0, self.vocab, self.mix["prompt"],
                                       dtype=np.int32)
            out.append((self.sent, prompt, self.mix["output"],
                        self.t0 + self.sent * gap))
            self.sent += 1
        return out

    def start(self, now):
        self.t0, self.sent = now, 0
        return self._due(now)

    def after_step(self, now, finished):
        return self._due(now)
"""),
}


@pytest.mark.parametrize("kind", sorted(NEW_FORMS))
def test_a_new_form_of_traffic_is_a_file_and_entries(tmp_path, kind):
    """A mix of a form the benchmark does not have is a generator file,
    a mix file, a cell file and entries: a whole run drives the program
    with it and comes out correct, and no file that was there changes."""
    like, mix, source = NEW_FORMS[kind]
    root = tiny.make_root(tmp_path)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "generators", kind + ".py"), "w") as f:
        f.write(source)
    with open(os.path.join(pkg, "traffic", kind + ".json"), "w") as f:
        json.dump(dict(mix, kind=kind), f)
    name = "tiny." + kind
    with open(os.path.join(pkg, "workloads", like + ".json")) as f:
        cell_file = f.read()
    with open(os.path.join(pkg, "workloads", name + ".json"), "w") as f:
        f.write(cell_file)
    bench = spec.load(root)
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": kind, "chips": 1,
                               "why": "a new form of traffic"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = tiny.cell(root, name)
    assert cell.generator().__file__.endswith(
        os.path.join("generators", kind + ".py"))
    res = run.execute(cell, 2 ** 31 + 21, 0.6, False, torch.device("cpu"))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}
    _unchanged(pkg)


def _result_keys(traced):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    return keys + (["breakdown"] if traced else []) + ["setup", "checks"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_keys(tmp_path, traced):
    root = tiny.make_root(tmp_path)
    cell = tiny.cell(root, "tiny.train_dense")
    res = run.execute(cell, 2 ** 31 + 9, 0.5, traced, torch.device("cpu"))
    assert list(res) == _result_keys(traced)
    json.dumps(res)
    assert res["correct"] is True
    names = set(res["metrics"])
    if traced:
        assert names <= {m["name"] for m in cell.per_layer()}
        assert "train_mfu" in names
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {m["name"] for m in cell.end_to_end()}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert isinstance(res["setup"]["built"], bool)
    assert list(res["setup"]["parts"]) == ["start", "model", "traffic",
                                           "warmup"]


def test_a_run_without_a_card_refuses_to_measure():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "gpt2_medium.train_dense", "--seed", "7",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_with_only_the_benchmark_refuses(tmp_path):
    root = tmp_path / "only"
    root.mkdir()
    import shutil
    shutil.copytree(spec.PACKAGE, root / "portbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "gpt2_medium.train_dense", "--seed", "7",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _mix(name):
    with open(os.path.join(spec.PACKAGE, "traffic", name + ".json")) as f:
        return json.load(f)


def test_dense_batches_depend_on_the_seed_alone():
    mix = dict(_mix("train_dense"), batch=2, seq_len=16, pool=3)
    cfg = {"vocab_size": 50257}
    a = dense_batches.batches(mix, cfg, 2 ** 31 + 5, "cpu")
    b = dense_batches.batches(mix, cfg, 2 ** 31 + 5, "cpu")
    c = dense_batches.batches(mix, cfg, 2 ** 31 + 6, "cpu")
    for (x, y, _), (x2, y2, _) in zip(a, b):
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert torch.equal(x[:, 1:], y[:, :-1])
    assert not torch.equal(a[0][0], c[0][0])
    # the rows of the first steps all differ
    rows = {tuple(r.tolist()) for x, _, _ in a for r in x}
    assert len(rows) == 2 * 3


def test_packed_documents_keep_their_lengths_across_seeds():
    mix = _mix("train_packed")
    one = packed_documents.documents(mix, 50257, 1)
    two = packed_documents.documents(mix, 50257, 2)
    assert sorted(map(len, one)) == sorted(map(len, two))
    assert [len(d) for d in one] != [len(d) for d in two]
    assert all(16 <= len(d) <= 1024 for d in one)
    small = dict(mix, batch=2, seq_len=128, pool=2,
                 doc_len=dict(mix["doc_len"], median=30, max=128))
    a = packed_documents.batches(small, {"vocab_size": 50257}, 3, "cpu")
    b = packed_documents.batches(small, {"vocab_size": 50257}, 3, "cpu")
    for (x, y, s), (x2, y2, s2) in zip(a, b):
        assert torch.equal(x, x2) and torch.equal(s, s2)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 123456789012])
def test_closed_loop_is_the_seeds_and_keeps_within_the_context(seed):
    mix = _mix("serve_decode")
    a = closed_loop.Requests(mix, 50257, seed)
    b = closed_loop.Requests(mix, 50257, seed)
    for c in (0, 17, mix["clients"] - 1):
        for j in (0, 1, mix["per_client"] + 2):
            pa, oa = a.request(c, j)
            pb, ob = b.request(c, j)
            assert np.array_equal(pa, pb) and oa == ob
    firsts = [a.request(c, 0) for c in range(mix["clients"])]
    for prompt, out in firsts:
        assert len(prompt) + out <= mix["max_total"] and out >= 1
    # pre-aged: the first wave's remaining outputs spread out
    outs = sorted(o for _, o in firsts)
    assert outs[0] < 0.2 * mix["output_len"]["median"] < outs[-1]
    for c in range(mix["clients"]):
        for j in range(1, mix["per_client"]):
            p, o = a.request(c, j)
            assert mix["prompt_len"]["min"] <= len(p) <= \
                mix["prompt_len"]["max"]
            assert 1 <= o and len(p) + o <= mix["max_total"]


def test_closed_loop_deals_the_same_lengths_to_every_seed():
    """Only the tokens are the seed's: the schedule of lengths, which
    decides when requests finish together, is every seed's."""
    mix = _mix("serve_decode")
    a = closed_loop.Requests(mix, 50257, 1)
    b = closed_loop.Requests(mix, 50257, 2)
    assert a.pairs == b.pairs and a.age == b.age
    for c, j in ((0, 0), (5, 3)):
        (pa, oa), (pb, ob) = a.request(c, j), b.request(c, j)
        assert len(pa) == len(pb) and oa == ob
        assert not np.array_equal(pa, pb)
