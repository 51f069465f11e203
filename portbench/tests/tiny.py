"""A copy of the benchmark with tiny cells beside the real ones, for CPU
tests: the same drivers, metrics and limits at sizes a CPU runs in
seconds, computed in fp32."""
from __future__ import annotations

import json
import os
import shutil

from portbench import spec

TINY_CONFIG = {"name": "tiny", "source": "test", "n_layer": 2, "n_embd": 64,
               "n_head": 4, "n_ctx": 64, "n_positions": 64,
               "vocab_size": 200, "activation_function": "gelu_new",
               "layer_norm_epsilon": 1e-05, "tie_word_embeddings": True,
               "optimizer": {"lr": 3e-4, "beta1": 0.9, "beta2": 0.999,
                             "epsilon": 1e-8}}

TINY_TRAFFIC = {
    "tiny_dense": {"kind": "dense_batches", "batch": 4, "seq_len": 32,
                   "pool": 4},
    "tiny_packed": {"kind": "packed_documents", "batch": 4, "seq_len": 64,
                    "pool": 4, "over": 1.5,
                    "doc_len": {"median": 12, "sigma": 1.0, "min": 2,
                                "max": 64}},
    "tiny_serve": {"kind": "closed_loop", "clients": 4, "per_client": 4,
                   "max_total": 64,
                   "prompt_len": {"median": 12, "sigma": 0.3, "min": 6,
                                  "max": 20},
                   "output_len": {"median": 16, "sigma": 0.3, "min": 8,
                                  "max": 30},
                   "preage": True, "warmup_s": 0.2}}

#: tiny cell -> (real cell whose settings and limits it takes, traffic)
TINY_CELLS = {"tiny.train_dense": ("gpt2_medium.train_dense", "tiny_dense"),
              "tiny.train_packed": ("gpt2_small.train_packed",
                                    "tiny_packed"),
              "tiny.serve_decode": ("gpt2_medium.serve_decode",
                                    "tiny_serve")}


def make_root(tmp):
    """A benchmark root under ``tmp`` holding the real benchmark and the
    tiny cells; returns its path."""
    root = os.path.join(str(tmp), "bench")
    pkg = os.path.join(root, "portbench")
    shutil.copytree(spec.PACKAGE, pkg, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = spec.load()
    with open(os.path.join(pkg, "configs", "tiny.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for name, mix in TINY_TRAFFIC.items():
        with open(os.path.join(pkg, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for name, (real, traffic) in TINY_CELLS.items():
        with open(os.path.join(pkg, "workloads", real + ".json")) as f:
            cell = json.load(f)
        cell["trace_steps"] = 2
        cell["rows_per_pass"] = 2
        # fp32 on the CPU: bf16 autocast there is slow and its rounding
        # is not the card's
        cell["precision"] = "fp32"
        if "engine" in cell:
            cell["engine"].update(num_slots=4, page_size=8, max_seq_len=64,
                                  max_prefill_len=64)
            cell["sample"] = {"tokens": 300, "max_requests": 64}
        with open(os.path.join(pkg, "workloads", name + ".json"), "w") as f:
            json.dump(cell, f)
        real_entry = next(w for w in bench["workloads"] if w["name"] == real)
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
        assert real_entry
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


def cell(root, name):
    return spec.Cell(root, spec.load(root), name)
