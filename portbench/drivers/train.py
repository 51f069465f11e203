"""Training cells: the port's Gluon loop.

One step is the loop of ``example/language-model/train_gpt.py`` on the
port: ``autograd.record()`` -> the model under ``torch.autocast``
(bfloat16 when the cell says so) -> ``SoftmaxCrossEntropyLoss`` ->
``mean()`` -> ``backward()`` -> ``Trainer.step(B)`` with Adam.

Set-up builds the model from the seed's weights, the Trainer and the
cell's pool of batches, and drives that one object through its first
steps on the first batches of the pool: those steps warm every shape the
window uses and give the readings the reference is compared with (each
step's loss, the first gradient as Adam holds it after one step, and the
change of every weight over the first steps).  The window then cycles
through the pool until ``seconds`` have passed and ends on a step
boundary.  After the window the program's state is freed and the plain
reference follows the same first steps from the same weights and
batches.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from .. import compare, port, trace, work
from ..reference import gpt2
from ..weights import make_weights


def make_batches(cell, seed, device):
    """The cell's pool of batches, from the generator its mix names."""
    gen = cell.generator()
    if not hasattr(gen, "batches"):
        raise ValueError("a training cell cannot run traffic of kind %r"
                         % cell.traffic["kind"])
    return gen.batches(cell.traffic, cell.config, seed, device)


class Program:
    """The program's training object: model, Trainer, loss and step."""

    def __init__(self, cell, weights, device):
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.gluon import Trainer
        from mxnet_tpu_torch.gluon import loss as gloss
        opt = cell.config["optimizer"]
        self.net = port.build_gpt(cell.config, weights, device)
        self.trainer = Trainer(
            self.net.collect_params(), "adam",
            {"learning_rate": opt["lr"], "beta1": opt["beta1"],
             "beta2": opt["beta2"], "epsilon": opt["epsilon"]})
        self.loss_fn = gloss.SoftmaxCrossEntropyLoss(axis=-1,
                                                     sparse_label=True)
        self.autograd = autograd
        self.autocast = cell.spec["precision"] == "bf16_autocast"
        self.device = device

    def step(self, batch, ranges=False):
        """One optimizer step on ``batch``; returns the loss (on the
        device).  ``ranges`` opens the harness's host ranges."""
        x, y, seg = batch
        rng = (torch.profiler.record_function if ranges
               else contextlib.nullcontext)
        with rng("portbench.forward"):
            with self.autograd.record():
                with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                    enabled=self.autocast):
                    out = self.net(x) if seg is None else self.net(x, seg)
                    loss = self.loss_fn(out, y.float()).mean()
        with rng("portbench.backward"):
            loss.backward()
        with rng("portbench.trainer_step"):
            self.trainer.step(x.shape[0])
        return loss.detach()

    def leaf_names(self):
        """Reference name of each Trainer index."""
        names = {id(p): n for p, n in port.gpt_leaves(self.net)}
        return [names[id(p)] for p in self.trainer._params]

    def adam_grad_norms(self, beta1):
        """The first step's gradient norm of every leaf as Adam holds it:
        after one step its first moment is ``(1 - beta1) g``."""
        state = self.trainer._fused.state or {}
        out = {}
        for i, name in enumerate(self.leaf_names()):
            # a leaf Adam never saw was handed no gradient
            st = state.get(str(i))
            out[name] = 0.0 if st is None else \
                float(st[0].float().norm()) / (1 - beta1)
        return out

    def delta_norms(self, init):
        return {n: float((p.data()._data.detach().float() - init[n]).norm())
                for p, n in port.gpt_leaves(self.net)}


def program_first_steps(cell, seed, device, mark=lambda part: None):
    """Set-up: the program's object, the batches, and the readings of its
    first steps.  Returns ``(program, batches, readings)``; ``mark(part)``
    ends the set-up's parts ``model`` and ``traffic``."""
    cfg, spec = cell.config, cell.spec
    weights = make_weights(cfg, seed, device)
    init = {n: t.detach().clone() for n, t in weights.items()}
    prog = Program(cell, weights, device)
    del weights
    mark("model")
    batches = make_batches(cell, seed, device)
    mark("traffic")
    if len(batches) <= spec["first_steps"]:
        raise ValueError("the pool of %d batches must outnumber the %d "
                         "first steps" % (len(batches), spec["first_steps"]))
    losses = []
    grads = None
    for i in range(spec["first_steps"]):
        losses.append(float(prog.step(batches[i])))
        if i == 0:
            grads = prog.adam_grad_norms(cfg["optimizer"]["beta1"])
    readings = {"losses": losses, "grad_norms": grads,
                "delta_norms": prog.delta_norms(init)}
    del init
    return prog, batches, readings


def reference_steps(cell, seed, batches, device, precision="fp32", rows=None):
    """The plain reference's readings over the same first steps."""
    spec = cell.spec
    w = make_weights(cell.config, seed, device)
    first = batches[:spec["first_steps"]]
    return gpt2.train(w, cell.config, first, cell.config["optimizer"],
                      precision=precision, rows_per_pass=spec["rows_per_pass"],
                      rows=rows)


def free():
    """Return the memory of objects already dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed, seconds, traced, device, clock):
    """One measured run of a training cell; see :mod:`portbench.run`."""
    prog, batches, readings = program_first_steps(cell, seed, device,
                                                  clock.mark)
    first = cell.spec["first_steps"]
    n_pool = len(batches)
    sync = clock.sync
    sync()
    t_open = clock.window_open()
    n_trace = cell.spec["trace_steps"]
    steps, prof, attn_calls = 0, None, []
    # the traced run's step time is taken outside the profiled slice
    timed_s, timed_steps, part_t, part_steps = 0.0, 0, t_open, 0
    while True:
        if traced and prof is None and \
                time.perf_counter() - t_open >= seconds / 3.0:
            sync()
            timed_s += time.perf_counter() - part_t
            timed_steps += steps - part_steps
            prof, attn_calls = _profiled_steps(
                prog, batches, first + steps, n_trace, sync)
            steps += n_trace
            part_t, part_steps = time.perf_counter(), steps
        prog.step(batches[(first + steps) % n_pool])
        steps += 1
        if time.perf_counter() - t_open >= seconds:
            break
    if traced and prof is None:
        raise RuntimeError("the window closed before its profiled slice")
    sync()
    t_close = time.perf_counter()
    out = {"attempted": steps, "failed": 0,
           "memory_peak_bytes": clock.memory_peak()}
    if traced:
        timed_s += t_close - part_t
        timed_steps += steps - part_steps
        out["trace"] = _trace_context(cell, prof, attn_calls, batches,
                                      timed_s / timed_steps)
    else:
        out["e2e"] = {"train_step_ms": (t_close - t_open) / steps * 1e3}
    del prog
    free()
    ref = reference_steps(cell, seed, batches, device)
    out["checks"] = compare.training(readings, ref, cell.spec["limits"])
    return out


def _profiled_steps(prog, batches, start, n, sync):
    """``n`` steps under the profiler with the harness's ranges open:
    around the forward, backward and Trainer.step, and around every call
    of the attention op (whose shapes are noted)."""
    from torch.profiler import profile
    calls = []

    def note(args, kwargs):
        q, k = args[0], args[1]
        seg = args[3] if len(args) > 3 else kwargs.get("segments")
        calls.append((tuple(q.shape), tuple(k.shape), q.element_size(),
                      None if seg is None else seg))

    with port.ranged(port.attention_op(), "fn", "portbench.attention", note):
        with profile(activities=trace.activities(prog.device)) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                sync()
                for i in range(n):
                    prog.step(batches[(start + i) % len(batches)],
                              ranges=True)
                sync()
    return prof, calls


def _trace_context(cell, prof, calls, batches, step_s):
    """What the per-layer readers of a training cell read."""
    cfg = cell.config
    tl = trace.Timeline.from_profile(prof)
    n = cell.spec["trace_steps"]
    attn_flops = attn_bytes = 0
    seg_pairs = {}
    for qs, ks, item, seg in calls:
        b, h, tq, d = qs
        if seg is None:
            pairs = b * h * work.causal_pairs(tq)
        else:
            # every layer of a step sees the same ids
            key = seg.data_ptr()
            if key not in seg_pairs:
                seg_pairs[key] = sum(work.packed_pairs(r)
                                     for r in seg.cpu().tolist())
            pairs = h * seg_pairs[key]
        attn_flops += pairs * 12 * d
        attn_bytes += work.attention_call_bytes(b, h, tq, ks[2], d, item,
                                                seg is not None)
    # model FLOPs of the mean step of the pool
    flops = []
    for x, _, seg in batches:
        if seg is None:
            tokens = x.numel()
            pairs = x.shape[0] * work.causal_pairs(x.shape[1])
        else:
            rows = seg.cpu().tolist()
            tokens = sum(1 for r in rows for s in r if s)
            pairs = sum(work.packed_pairs(r) for r in rows)
        flops.append(work.train_step_flops(cfg, tokens, pairs))
    dtype = "bfloat16" if cell.spec["precision"] == "bf16_autocast" \
        else "float32"
    return {"timeline": tl, "steps": n, "step_s": step_s,
            "flops_per_step": sum(flops) / len(flops),
            "peak_flops": work.PEAK_FLOPS[dtype],
            "attn_flops": attn_flops, "attn_bytes": attn_bytes,
            "attn_calls": len(calls)}
