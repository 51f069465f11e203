"""Everything a run needs, found by name.

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics.  Each has files of its own under ``portbench/``:

- ``configs/<config>.json`` (the ``file`` its entry names);
- ``workloads/<cell>.json``: the cell's driver, precision, engine or loop
  settings and the limits of its correctness numbers;
- ``traffic/<traffic>.json``: the mix's parameters;
- ``generators/<kind>.py``: the form of traffic the mix's ``kind``
  names, which makes the batches or requests from those parameters;
- ``drivers/<driver>.py``: the entry into the program;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A new cell, configuration, mix, form of traffic or metric is new files
and new entries; no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)


class Cell:
    """One workload of the benchmark, with its files read."""

    def __init__(self, root, bench, name):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                           % (name, sorted(entries)))
        self.root, self.bench, self.name = root, bench, name
        self.entry = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(root, configs[self.entry["config"]]["file"])
        pkg = os.path.relpath(PACKAGE, ROOT)
        self.spec = _json(root, os.path.join(pkg, "workloads",
                                             name + ".json"))
        self.traffic = _json(root, os.path.join(
            pkg, "traffic", self.entry["traffic"] + ".json"))

    @property
    def chips(self):
        return self.entry["chips"]

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it,
        and those without a list that move one of its end-to-end
        metrics."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out

    def driver(self):
        return importlib.import_module(
            "%s.drivers.%s" % (os.path.basename(PACKAGE), self.spec["driver"]))

    def generator(self):
        """The module of the traffic's form, ``generators/<kind>.py``."""
        return self._module("generators", self.traffic["kind"])

    def metric_reader(self, name):
        """``read(trace_context) -> value or None`` of metric ``name``."""
        return self._module("metrics", name).read

    def _module(self, folder, name):
        """``<folder>/<name>.py`` of this root's benchmark, loaded from its
        file, so that a file added beside the others is found."""
        path = os.path.join(self.root, os.path.relpath(PACKAGE, ROOT),
                            folder, name + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_%s_%s" % (folder, re.sub(r"[^A-Za-z0-9_]", "_", name)),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _json(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def load(root=ROOT):
    """``BENCHMARK.json`` of ``root``."""
    return _json(root, "BENCHMARK.json")
