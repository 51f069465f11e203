"""Readings the limits of ``correct`` are set from, on the card at a cell's
own size, many seeds in one process (the benchmark's runs do not run
this)::

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control] [--faults] [--seconds 12]

One JSON line per seed on standard output:

- ``program``: the compared numbers of the program against the plain
  reference (the lower readings);
- ``control`` (``--control``): the same numbers of the reference in the
  next precision below the configuration's, put in the program's place:
  fp8 matmuls for a bfloat16 training cell, TF32 for a float32 serving
  cell (the upper readings);
- ``half_batch`` (``--faults``, training): the reference trained on half
  of each batch, the mean taken over the rest.

A serving seed runs the cell's traffic for ``--seconds`` and reads the
sample a run would.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import compare, spec
from .run import Clock, _cache_dirs, set_precision


def train_seed(cell, seed, device, control, faults):
    from .drivers import train
    prog, batches, readings = train.program_first_steps(cell, seed, device)
    del prog
    train.free()
    ref = train.reference_steps(cell, seed, batches, device)
    out = {"program": compare.training_numbers(readings, ref),
           "losses": readings["losses"], "ref_losses": ref["losses"]}
    if control:
        ctl = train.reference_steps(cell, seed, batches, device,
                                    precision="fp8")
        out["control"] = compare.training_numbers(ctl, ref)
    if faults:
        half = train.reference_steps(cell, seed, batches, device,
                                     rows=batches[0][0].shape[0] // 2)
        out["half_batch"] = compare.training_numbers(half, ref)
    return out


def serve_seed(cell, seed, device, control, seconds):
    from .drivers import serve
    res, sample = serve.serve(cell, seed, seconds, False, device,
                              Clock(device))
    out = {"program": {"logit_gap": serve.reference_gaps(
        cell, seed, sample, device)},
        "sample_requests": len(sample),
        "sample_tokens": sum(len(s) for _, s in sample),
        "e2e": res["e2e"]}
    if control:
        out["control"] = {"logit_gap": serve.reference_gaps(
            cell, seed, sample, device, control="tf32")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.ROOT, spec.load(), args.workload)
    _cache_dirs(spec.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    set_precision()
    for s in args.seeds.split(","):
        t = time.time()
        seed = int(s)
        if cell.spec["driver"] == "train":
            out = train_seed(cell, seed, device, args.control, args.faults)
        else:
            out = serve_seed(cell, seed, device, args.control, args.seconds)
        out.update(workload=cell.name, seed=seed,
                   seconds=round(time.time() - t, 1))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
