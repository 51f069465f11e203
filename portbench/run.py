"""Run one cell of the port's benchmark on the card and print its result.

From the root of a checkout::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run builds the cell's inputs and weights from ``--seed``, warms up
every shape it uses (set-up), measures for ``--seconds``, then checks
what the timed path produced against the plain reference.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from a profiled slice of the
window), ``device``, with ``--trace 1`` ``breakdown``, ``setup``
(whether this run built or compiled anything, which only the first run
in a checkout should, and its set-up split into parts), and last
``checks``: each number compared with its limit, which also close
standard error.

It measures only ``mxnet_tpu_torch`` on an NVIDIA card: without a card,
with fewer cards than the cell asks for, or without the program beside
it, it prints no result and exits with 2.  If the JAX package or JAX is
loaded once the window has closed, it names them on standard error and
exits with 3.  Build and kernel caches stay in fixed directories inside
the checkout (``.portbench_cache/`` and the program's own
``mxnet_tpu_torch/_build/``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

from . import compare, spec

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "mxnet_tpu")
PROGRAM = "mxnet_tpu_torch"


def process_age_s():
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """The run's clock: set-up ends when the window opens.

    ``parts`` splits the set-up: ``start`` (process start to the run's
    first line: the interpreter, torch and the harness), then each part
    a driver ends with :meth:`mark` (``model``, ``traffic``), and
    ``warmup``, which the window's opening ends."""

    def __init__(self, device):
        import torch
        self.torch, self.device = torch, device
        self.age0, self.t0 = process_age_s(), time.perf_counter()
        self.setup_s = None
        self.parts, self._last = {"start": self.age0}, self.t0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def mark(self, part):
        """End the set-up's part ``part`` now."""
        t = time.perf_counter()
        self.parts[part] = t - self._last
        self._last = t
        return t

    def window_open(self):
        t = self.mark("warmup")
        self.setup_s = self.age0 + (t - self.t0)
        return t

    def memory_peak(self):
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))


def forbidden_modules():
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def build_entries():
    """Directories two levels deep in the program's build directory and
    the benchmark's caches: a run that adds one built or compiled
    something."""
    found = importlib.util.find_spec(PROGRAM)
    bases = [os.path.join(spec.ROOT, ".portbench_cache")]
    if found is not None and found.origin:
        bases.append(os.path.join(os.path.dirname(found.origin), "_build"))
    out = set()
    for base in bases:
        for d, subs, _ in os.walk(base):
            depth = os.path.relpath(d, base).count(os.sep)
            out.update(os.path.join(d, x) for x in subs)
            if depth >= 1:
                subs[:] = []
    return out


def card(device):
    """``device`` of the result: the card, its count and power limit."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
        out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def set_precision():
    """Float32 products in float32: every configuration states TF32 off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def execute(cell, seed, seconds, traced, device):
    """Run ``cell`` on ``device`` and return the result object."""
    clock = Clock(device)
    built = build_entries()
    set_precision()
    out = cell.driver().run(cell, seed, seconds, traced, device, clock)
    built = bool(build_entries() - built)
    metrics = {}
    if traced:
        tctx = out["trace"]
        for m in cell.per_layer():
            value = cell.metric_reader(m["name"])(tctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            value = (clock.setup_s if m["name"] == "setup_s"
                     else out["e2e"][m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": compare.passes(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        tl = tctx["timeline"]
        dev["busy_s"], dev["window_s"] = tl.busy_s, tl.window_s
        result["breakdown"] = {"device_ops": tl.top_device_ops(10),
                               "idle_gaps": tl.idle_gaps(10)}
    # recorded apart: the first run in a checkout builds the kernels
    result["setup"] = {"built": built, "parts": clock.parts}
    result["checks"] = out["checks"]
    return result


def _cache_dirs(root):
    """Fixed cache directories inside the checkout, for every compiler
    the program may start."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    # the engine's flight ring holds a whole window of steps
    os.environ["MXTPU_FLIGHT_RECORDER_STEPS"] = "16384"
    os.environ["USE_FLAX"] = "0"


def refuse(msg):
    print("portbench: %s; no result" % msg, file=sys.stderr)
    return 2


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec.ROOT
    try:
        cell = spec.Cell(root, spec.load(root), args.workload)
    except (OSError, KeyError, ValueError) as e:
        return refuse("cannot read the cell: %s" % e)
    found = importlib.util.find_spec(PROGRAM)
    if found is None or not os.path.abspath(found.origin).startswith(root):
        return refuse("the program %s is not in this checkout" % PROGRAM)
    _cache_dirs(root)
    import torch
    if not torch.cuda.is_available():
        return refuse("no CUDA card")
    if torch.cuda.device_count() < cell.chips:
        return refuse("the cell needs %d cards, %d seen"
                      % (cell.chips, torch.cuda.device_count()))
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print("portbench: modules outside the program under test were "
              "loaded: %s; no result" % ", ".join(loaded), file=sys.stderr)
        return 3
    print("setup %s" % json.dumps(result["setup"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
