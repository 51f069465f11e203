"""Serving cells: the port's ``ServingEngine`` under the requests of the
cell's traffic.

The benchmark is the engine's only caller.  The mix's generator
(``generators/<kind>.py``, such as the closed loop) says which requests
to submit at the start and after every ``engine.step()``; after every
step the harness reads each request's tokens and stamps what arrived
with its own clock, as a streaming client would see them.  Set-up builds
the model from the seed's weights and the engine, sends the first
requests (whose prefills are set-up the traffic needs) and steps for the
mix's ``warmup_s``; then the window opens and runs until the first step
that returns ``seconds`` later.

Metrics of the window: the output tokens that reached clients in it over
its length, the 95th percentile of submit-to-first-token of every
request whose first token arrived in it, and the 95th percentile of
every gap between consecutive tokens of a request whose later token
arrived in it.

Correctness: once the window has closed, a sample drawn from the seed of
the requests that finished, the longest among them, is run through the
plain reference's full-context forward over prompt and served tokens;
at every served position, the gap by which the served token's logit lies
below the reference's best is read, and the widest gap is held to its
limit.  Greedy decoding only: the served token should be the best.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from .. import port, trace, work
from ..reference import gpt2
from ..weights import make_weights


class _Live:
    """A request in flight and what its client has seen of it."""
    __slots__ = ("req", "submit_t", "seen", "last_t", "prompt_len")

    def __init__(self, req, submit_t, prompt_len):
        self.req, self.submit_t, self.prompt_len = req, submit_t, prompt_len
        self.seen, self.last_t = 0, submit_t


class Loop:
    """The traffic's clients and what they saw.

    ``source`` is the ``Requests`` object of the mix's generator: it
    names the first requests (``start``) and, after every engine step,
    the requests that become due (``after_step``, told which requests
    finished), each as ``(key, prompt, max_new, due)``.  A request's
    first-token time runs from ``due``, or from its submission where
    ``due`` is None.  A key that is sent again once its request finished
    names the same client.
    """

    def __init__(self, engine, source, cfg):
        self.engine, self.source, self.cfg = engine, source, cfg
        self.live = {}
        self.in_window = False
        self.tokens = 0
        self.ttft, self.gaps, self.occupancy = [], [], []
        self.attempted = self.failed = 0
        self.finished = []          # (prompt, served tokens)
        self.flops = 0.0            # needed FLOPs of what was served
        self.count_flops = False

    def submit(self, items):
        for key, prompt, max_new, due in items:
            req = self.engine.submit(prompt, max_new)
            t = time.perf_counter() if due is None else due
            self.live[key] = _Live(req, t, len(prompt))
            self.attempted += 1

    def start(self):
        self.submit(self.source.start(time.perf_counter()))

    def step(self):
        """One engine step, then every client reads what it got."""
        self.engine.step()
        now = time.perf_counter()
        win, resident, done = self.in_window, 0, []
        for key, live in self.live.items():
            req = live.req
            n = len(req.tokens)
            new = n - live.seen
            if new > 0:
                resident += 1
                if self.count_flops:
                    self._note_flops(live, new)
                if win:
                    self.tokens += new
                    if live.seen == 0:
                        self.ttft.append(now - live.submit_t)
                    else:
                        self.gaps.append(now - live.last_t)
                    self.gaps.extend([0.0] * (new - 1))
                live.seen, live.last_t = n, now
            if req.done:
                if req.verdict == "completed":
                    self.finished.append((req.prompt, list(req.tokens)))
                else:
                    self.failed += 1
                done.append(key)
        if win:
            self.occupancy.append(resident / self.engine.num_slots)
        if done:
            again = self.source.after_step(now, done)
            sent = {item[0] for item in again}
            for key in done:
                if key not in sent:
                    del self.live[key]
            self.submit(again)
        return now

    def _note_flops(self, live, new):
        cfg, context = self.cfg, live.prompt_len + live.seen
        if live.seen == 0:
            self.flops += work.prefill_flops(cfg, live.prompt_len)
            context, new = context + 1, new - 1
        if new:
            self.flops += work.decode_flops(cfg, context, new)


def _last_step():
    from mxnet_tpu_torch import telemetry
    recs = telemetry.flight_records()
    return recs[-1]["step"] if recs else -1


def run(cell, seed, seconds, traced, device, clock):
    """One measured run of a serving cell; see :mod:`portbench.run`."""
    out, sample = serve(cell, seed, seconds, traced, device, clock)
    gap = reference_gaps(cell, seed, sample, device)
    out["checks"] = {"logit_gap": {"value": gap,
                                   "limit": cell.spec["limits"]["logit_gap"]}}
    return out


def serve(cell, seed, seconds, traced, device, clock):
    """Set-up, the window and the sample: ``(result parts, sample)``, with
    the program's state freed."""
    from mxnet_tpu_torch.serving import ServingEngine
    cfg, spec, mix = cell.config, cell.spec, cell.traffic
    net = port.build_gpt(cfg, make_weights(cfg, seed, device), device)
    engine = ServingEngine(net, device=device, **spec["engine"])
    clock.mark("model")
    gen = cell.generator()
    if not hasattr(gen, "Requests"):
        raise ValueError("a serving cell cannot run traffic of kind %r"
                         % mix["kind"])
    loop = Loop(engine, gen.Requests(mix, cfg["vocab_size"], seed), cfg)
    loop.start()
    t = clock.mark("traffic")
    while time.perf_counter() - t < mix["warmup_s"]:
        loop.step()
    clock.sync()
    t_open = clock.window_open()
    loop.in_window = True
    marks = [_last_step()] if traced else None
    prof = calls = None
    timed_s, part_t = 0.0, t_open
    loop.count_flops = traced
    while True:
        if traced and prof is None and \
                time.perf_counter() - t_open >= seconds / 3.0:
            timed_s += time.perf_counter() - part_t
            marks.append(_last_step())
            loop.count_flops = False
            prof, calls = _profiled_steps(loop, spec["trace_steps"],
                                          clock.sync)
            loop.count_flops = True
            marks.append(_last_step())
            part_t = time.perf_counter()
        now = loop.step()
        if now - t_open >= seconds:
            break
    if traced and prof is None:
        raise RuntimeError("the window closed before its profiled slice")
    t_close = now
    out = {"attempted": loop.attempted, "failed": loop.failed,
           "memory_peak_bytes": clock.memory_peak()}
    window = t_close - t_open
    if traced:
        timed_s += t_close - part_t
        marks.append(_last_step())
        out["trace"] = _trace_context(loop, prof, calls, marks, timed_s)
    else:
        out["e2e"] = {
            "serve_tokens_per_s": loop.tokens / window,
            "serve_ttft_p95_ms": _p95(loop.ttft) * 1e3,
            "serve_itl_p95_ms": _p95(loop.gaps) * 1e3}
    sample = draw_sample(loop.finished, seed, spec["sample"])
    del engine, net, loop
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out, sample


def _p95(xs):
    """The 95th percentile (the inclusive method of ``statistics``)."""
    if len(xs) < 2:
        return float("nan")
    return statistics.quantiles(xs, n=20, method="inclusive")[-1]


def draw_sample(finished, seed, cfg):
    """The longest finished request and others drawn from the seed, until
    ``tokens`` served tokens are in the sample or ``max_requests``
    requests."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in np.random.default_rng([int(seed) % 2 ** 63, 6])
            .permutation(len(finished)) if i != longest]
    picked, served = [longest], len(finished[longest][1])
    for i in rest:
        if served >= cfg["tokens"] or len(picked) >= cfg["max_requests"]:
            break
        picked.append(i)
        served += len(finished[i][1])
    return [finished[i] for i in picked]


def served_rows(w, cfg, prompt, served, device, precision):
    """The reference's logits ``[n, V]`` at the positions of the served
    tokens ``served`` after ``prompt``."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    toks = torch.from_numpy(seq).to(device)
    logits = gpt2.token_logits(w, cfg, toks, precision)
    return logits[len(prompt) - 1:]


def reference_gaps(cell, seed, sample, device, control=None):
    """The widest gap, over the sample's served tokens, between the
    reference's best logit and the served token's.  ``control`` (a
    precision of :mod:`portbench.reference.gpt2`): read instead the gap
    of the token that the reference in that precision puts first at
    each position."""
    if not sample:
        return float("nan")
    w = make_weights(cell.config, seed, device)
    worst = 0.0
    for prompt, served in sample:
        rows = served_rows(w, cell.config, prompt, served, device, "fp32")
        if control is None:
            tok = torch.as_tensor(served, device=device).long()
        else:
            tok = served_rows(w, cell.config, prompt, served, device,
                              control).argmax(-1)
        gap = (rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0])
        worst = max(worst, float(gap.max()))
    return worst


def _profiled_steps(loop, n, sync):
    """``n`` engine steps under the profiler, with the harness's ranges
    around the engine step, prefill, decode step, paged attention (whose
    operands are noted) and the clients' reading."""
    from torch.profiler import profile
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    calls = []

    def note(args, kwargs):
        q, kp, bt, ctx = args[0], args[1], args[3], args[4]
        calls.append((q.shape[1], q.element_size(), kp.shape[2],
                      kp.shape[3], kp.element_size(), bt.numel(),
                      ctx.clone()))

    engine = loop.engine
    with port.ranged(gpt, "paged_attention", "portbench.paged_attention",
                     note), \
            port.ranged(gpt, "paged_decode_step", "portbench.decode_step"), \
            port.ranged(gpt, "paged_prefill", "portbench.prefill"), \
            port.ranged(engine, "step", "portbench.engine_step"):
        with profile(activities=trace.activities(engine.device)) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                sync()
                for _ in range(n):
                    loop.step()
                sync()
    return prof, calls


def _trace_context(loop, prof, calls, marks, timed_s):
    """What the per-layer readers of a serving cell read."""
    from mxnet_tpu_torch import telemetry
    s0, s1, s2, s3 = marks
    recs = [r for r in telemetry.flight_records()
            if s0 < r["step"] <= s1 or s2 < r["step"] <= s3]
    paged_bytes = 0
    for h, q_item, kv_heads, d, kv_item, table, ctx in calls:
        paged_bytes += work.paged_attention_bytes(
            ctx.cpu().tolist(), kv_heads, d, kv_item, h, q_item, table)
    return {"timeline": trace.Timeline.from_profile(prof),
            "steps": len(calls),
            "decode_dispatch_s": [r["dispatch_s"] for r in recs
                                  if r["where"] == "serve_step"],
            "prefill_s": [r["dispatch_s"] + r["sync_s"] for r in recs
                          if r["where"] == "serve_prefill"],
            "occupancy": loop.occupancy,
            "flops": loop.flops, "timed_s": timed_s,
            "peak_flops": work.PEAK_FLOPS["float32"],
            "paged_bytes": paged_bytes, "paged_calls": len(calls)}
