#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card and
check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``); fails with no
   CUDA card.
2. Builds every kernel from ``mxnet_tpu_torch/csrc/`` (``nvcc``, one
   process per source, all at once) and prints the ``-Xptxas -v`` lines,
   the redesigned kernels' registers and spills, the HGMMA count of each
   instance of B1's, B2's, B3's and B7's bf16 tensor-core kernels in the
   built library (``cuobjdump --dump-sass``; fails if one has none, or if
   B2, B3, B7 bf16, the fp32 q template (B1, B2 fp32) or the fp32 dk/dv
   template (B3, B7 fp32) spills at D 64), and the FFMA and LDS.128 counts
   of each fp32 template instance.
3. Kernel phase, at gpt2_small's widths (H=12, D=64, page 16, 8 slots,
   ragged contexts including 0, a partial last page and one near 512),
   for K_kv in {12, 4}; each case is held against its plain PyTorch
   version on the same inputs, then timed beside the plain version, its
   bound and a library yardstick:
   - ``paged_attention`` (B5) with fp32, bf16 and int8 pools (int8 with
     per-page scales);
   - ``paged_attention_multi`` (B6) at G = 5 query positions (spec_k 4)
     with fp32, bf16 and int8 pools, per-position contexts running to
     509 + 4 with 0 rows (an empty slot, rows past a slot's drafts);
   - B6 at G = 1 against B5 on the same inputs;
   each with its grid (blocks, runs of pages a slot) and, beside a call's
   time, its device time (``torch.profiler``: the split kernel and the
   merge).
   Flash kernel phase: ``flash_fwd`` (B1), ``flash_bwd_dq`` (B2),
   ``flash_bwd_dkv`` (B3) and ``flash_bwd_fused`` (B7), fp32 and bf16, at
   B = 8, H = 12, D = 64 for gpt2_small's training shape (T = 1024,
   causal), bench.py's T = 2048, a packed batch (segments from
   ``pack_sequences`` of random-length documents) and cross-attention at
   Tq = 1000, Tk = 777; each against its plain version, then timed beside
   it, SDPA (forward; its autograd backward beside B2, B3 and B7) and the
   bound; then B2 and B3 as one pair, as the training path calls them,
   and B7 alone, each beside SDPA's backward in device time.  Fused
   LayerNorm-residual phase: ``layer_norm_residual`` (B4) at the symbolic
   phase's rows (8192 x 768)
   in fp32 and bf16, and at (3, 130) and (1000, 1024); y, mean and rstd
   held element by element against the plain version, then timed beside
   it, ``x + r`` then ``F.layer_norm``, and the bound.
4. Slice phase: ``gpt2_small`` at full width with seeded random weights
   (numpy, normal std 0.02) put in through ``load_jax_params``, serving 16
   greedy requests (prompts 8-128 tokens, 64 new tokens each) through
   ``ServingEngine`` with 8 slots, so slots join and leave.  Checks every
   request finished, kernel launches == n_layers x decode steps, and every
   emitted logits row against the teacher-forced dense recompute.  Then a
   ``torch.profiler`` window over steady decode steps (as after the spec
   n-gram run and each int8 kernel run).
5. Spec phase: the same engine and prompts with ``spec_k=4``, (a) with the
   default n-gram drafter (every request finishes, multi-position launches
   == n_layers x decode steps and no single-position launch, every logits
   row against the dense recompute, no page left marked speculative) and
   (b) with an oracle drafter that proposes each request's continuation
   from the slice phase's stream (fewer decode steps, the same tokens up
   to a near tie).
6. Int8 phase: ``kv_dtype="int8"``, spec off and then spec_k 4, on the same
   prompts; each run is repeated with the plain versions bound in place of
   the kernels, and the emitted logits rows are compared up to each
   request's first near-tie divergence.
7. Training phase: full-width ``gpt2_small`` with the same seeded weights
   trained by the Gluon loop of ``example/language-model/train_gpt.py``
   (``Trainer`` Adam at lr 3e-4, ``SoftmaxCrossEntropyLoss``,
   ``autograd.record``, ``backward``, ``step(8)``) on a fixed batch of
   8 x 1024 random tokens, with every step launching B1, B2 and B3 12
   times each and B7 never:
   - 10 steps: the loss falls; tokens/s, step p50, peak memory;
   - the first 3 steps again with the plain versions bound in: losses and
     parameters within tolerance; then a ``torch.profiler`` window of 3
     steps;
   - 10 steps under ``MXTPU_FLASH_BWD=fused`` (B7 12 a step, B2/B3 none):
     losses within tolerance of the split run's; a profile window;
   - 3 steps on a packed batch, held against its plain rerun;
   - 5 steps under bf16 autocast: the kernels get bf16 q/k/v and the loss
     falls; the first 3 steps again with the plain versions bound in,
     losses within ``BF16_LOSS_TOL``; a profile window with the flash
     kernels' share of the device's busy time;
   - 5 steps under bf16 autocast and ``MXTPU_FLASH_BWD=fused`` (B7 gets
     bf16 and runs on the tensor cores): the loss falls, losses within
     ``BF16_LOSS_TOL`` of the bf16 split run's and of a plain rerun of the
     first 3 steps; a profile window.
8. Symbolic phase: ``tools/perf_probe/graph_probe.py``'s post-LN
   transformer rebuilt with the port's ``mx.sym`` at gpt2_small's widths
   (12 x 768, 12 heads, vocab 50304), T = 1024, B = 8, seeded weights,
   bound by ``simple_bind`` with no ctx (the card).  Checks the pass report
   (24 LayerNorm-residual fusions, a folded constant, CSE merges), 24 B4
   launches in every forward and none in a backward; inference and a
   training step (grad_req write), each held against a rerun with B4's
   plain version bound in and against a bind with the pipeline off;
   forward and step p50, peak memory, a profiled forward.
9. Rtc phase: the two user kernels of the imperative path, CUDA C++ source
   strings compiled at run time by ``mx.rtc.CudaRtc`` (``nvcc``; the first
   build timed, then a second ``CudaRtc`` of the same source finding it
   built): ``sgd_update`` (``out = w - lr (rescale g + wd w)``, the
   hyperparameters a device tensor) on the imperative cell's parameter
   shapes and a ragged length, and ``row_l2norm`` (a block a row, a tree
   sum in shared memory) on 8192 x 3072 and (3, 130); each against its
   plain version, then timed beside it, its bound and
   ``torch.linalg.vector_norm`` (the norm) or the ``nd.sgd_update`` op
   (the update, which no single PyTorch call computes).
10. Imperative phase: the symbolic cell's model, weights and batch written
   with ``mx.nd`` (``gpt_nd``), every one of its 148 parameters marked by
   ``attach_grad``; 5 steps of ``autograd.record()`` forward,
   ``backward()`` and a CudaRtc ``sgd_update`` per parameter.  Checks the
   first step's gradients against a passes-off ``simple_bind``, exactly
   148 x 5 kernel launches, a falling loss, and losses and parameters
   against a rerun with ``nd.sgd_update(w, g, out=w)``; step p50, peak
   memory, a profiled window.
11. Module phase: the symbolic cell's model, widths and seeded weights
   through the user's entry point, ``mx.mod.Module(sym,
   context=mx.gpu(0)).fit`` on an ``NDArrayIter`` of 6 batches of 8 x
   1024 seeded tokens, Adam at 3e-4, ``metric.Perplexity``.  Checks the
   fused step on every batch, 24 B4 launches in every fit step, a falling
   perplexity, the Adam parameters after 3 steps against a rerun through
   the split path (``forward_backward`` + ``update`` through the Updater;
   ``MOD_PARAM_TOL``), the gradients as SGD momentum from the same weights
   against the split path after 3 steps and against a rerun with B4's
   plain version after 1 (``SYM_GRAD_TOL``), and the metric reduced on
   the device against the predictions copied to the host; fit step p50,
   peak memory, a step timed with each metric, a profiled window (busy
   share, kernels and optimizer-update launches a step), and the device
   time of each form of the guarded Adam update.  Then
   ``train_mnist.py``'s MLP (``symbols/mlp.py``) through ``Module.fit`` on
   its synthetic digits with its settings: train
   and validation accuracy above 0.95, and a batch with a NaN pixel
   skipped (parameters, momentum and clocks bit for bit as before).
12. Gluon ``mx.nd`` phase: the training phase's seeded ``gpt2_small``
   written to a ``.params`` file and read back by ``load_params`` into a
   fresh ``gluon.model_zoo.gpt.gpt2_small`` (``ctx=mx.gpu(0)``), trained
   by ``example/language-model/train_gpt.py``'s own loop on the training
   phase's batch as ``mx.nd.array(xb, dtype="int32")`` and float32 labels
   (``Trainer(net.collect_params(), "adam", ...)``,
   ``SoftmaxCrossEntropyLoss``, ``record``, ``loss.backward()``,
   ``trainer.step(8)``): ``net(x)`` and the loss are NDArrays and
   ``collect_params()`` a ParameterDict of 148 Parameters; every step
   launches B1, B2 and B3 12 times each through
   ``_contrib_flash_attention``, B7 never:
   - 5 steps eager: the loss falls and the losses are within
     ``GLUON_LOSS_TOL`` of the training phase's first 5; the first 3
     again with the plain versions bound in (losses and parameters read
     through ``Parameter.data()``, and the first step's gradients read
     through ``Parameter.grad()`` at ``SYM_GRAD_TOL`` of each tensor's
     max |g|); a profile window;
   - 5 steps ``hybridize()``d (the traced route) from the same weights:
     losses within ``GLUON_LOSS_TOL`` of eager's; a profile window;
   - 3 steps under ``MXTPU_FLASH_BWD=fused``: B7 12 a step, B2/B3 none;
   - step p50, tokens/s, peak memory, busy share and kernels a step beside
     the training phase's;
   - a ``HybridSequential`` of 12 user HybridBlocks ``LayerNorm(x +
     fc2(gelu(fc1(x))))`` at 768/3072, ``in_units`` deferred, on 8192 x
     768 rows, hybridized through the symbolic route: 12
     LayerNorm-residual fusions, 12 B4 launches a forward and none in a
     backward, output and gradients against the stack eager and against
     a rerun with B4's plain version, then a Trainer SGD step;
   - C7 on the card: inside ``with mx.cpu():`` ``nd.zeros`` lives on the
     host and ``current_context()`` is ``cpu(0)``.
13. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
   {...}}``.  Any failed check raises before that line (exit code 1).

Float32 matmuls run in full fp32 (TF32 off) so the logits checks compare
like with like.
"""
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32
#: FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

#: kernel phase shapes (gpt2_small serving at the slice phase's config)
HEADS, HEAD_DIM, PAGE, SLOTS, MAX_SEQ = 12, 64, 16, 8, 512
MAX_PAGES = MAX_SEQ // PAGE
NUM_PAGES = SLOTS * MAX_PAGES + 1
CONTEXTS = [0, 7, 16, 130, 257, 333, 448, 509]
#: speculative decoding: draft tokens per step, and the engine's pages per
#: slot with the draft slack (ceil((512 + 4) / 16) = 33)
SPEC_K = 4
SPEC_PAGES = -(-(MAX_SEQ + SPEC_K) // PAGE)
#: drafts verified per slot in the B6 cases: row i of slot s has context
#: CONTEXTS[s] + i for i <= DRAFTS[s] and 0 past it (slot 0 is empty)
DRAFTS = [4, 4, 0, 2, 4, 1, 3, 4]
#: kernel vs plain version, max abs error on outputs of unit scale: both
#: compute in fp32 from the same values (bf16 pools: the same bf16 values
#: reach both sides; int8: the same codes times the same fp32 scales); the
#: sums are taken in another order
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4, torch.int8: 1e-5}
#: B6 at G = 1 against B5: one kernel template, so equal
G1_TOL = 1e-6
#: emitted logits (std ~0.5) vs the dense recompute, fp32 end to end with
#: another summation order in every matmul and in attention
LOGITS_TOL = 1e-3
#: int8 engine, kernels vs plain versions bound in: the K/V the two runs
#: quantize differ in their last fp32 bits (attention sums in another
#: order), so a value on a rounding boundary can take the neighbouring code
#: (one step is 1/127 of its row's absmax) in one run; the logits then move
#: by a small fraction of that step
INT8_LOGITS_TOL = 1e-2

#: bytes of distinct inputs the kernel timings rotate over
L2_FLUSH_BYTES = 100 * 2 ** 20

N_REQUESTS, MAX_NEW, PROMPT_MIN, PROMPT_MAX = 16, 64, 8, 128
#: GPT-2's real vocabulary (gpt2_small pads it to 50304)
VOCAB = 50257

#: training phase: the Gluon loop of example/language-model/train_gpt.py
#: (Adam at lr 3e-4) on a fixed batch of B x T tokens
TRAIN_B, TRAIN_T, TRAIN_LR = 8, 1024, 3e-4
TRAIN_STEPS, PLAIN_STEPS, BF16_STEPS = 10, 3, 5
#: kernels vs plain versions bound in, over the first PLAIN_STEPS steps:
#: the attention outputs differ in their last fp32 bits (B1's online
#: softmax sums in another order), so the losses (about 10.9) and the
#: parameters move apart by rounding only.  An Adam update is about
#: lr = 3e-4 per step whatever the gradient's size, so an update of the
#: opposite sign in one run would show as about 6e-4, above the parameter
#: tolerance; a gradient that is wrong anywhere moves every step's loss
TRAIN_LOSS_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-4
#: fused vs split backward over TRAIN_STEPS steps: B7 sums dq by atomics
#: in no fixed order, and the rounding differences compound over the steps
FUSED_LOSS_TOL = 1e-3
#: bf16 autocast, kernels vs plain versions bound in, over the first
#: PLAIN_STEPS steps.  Both sides round each attention output and gradient
#: to bf16, so an element whose fp32 values straddle a rounding boundary
#: lands one bf16 step (2^-8 of it) apart, and the bf16 GEMMs after it
#: carry that on; two bf16 runs of the same kernels on one H100 model
#: moved apart by up to 4e-4 in their losses by step 3 (10.7331 and
#: 10.7335).  A wrong gradient moves the loss by a share of its fall of
#: 0.27-0.33 a step.  The bf16 fused run is held to the same tolerance
#: against the bf16 split run: B7 rounds the same bf16 outputs and adds dq
#: by atomics in no fixed order.  The parameters are reported, not held:
#: Adam's early updates are about lr in size whatever the gradient's, so a
#: gradient near 0 whose sign the rounding flips moves its weight by 2 lr =
#: 6e-4 in either run, and among 124M weights some do
BF16_LOSS_TOL = 2e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    """``name, power.limit`` of card 0 as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps, warmup=5):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, warmup=3):
    """Device time of ``fn`` a call: the time of the CUDA kernels it
    launches, summed by ``torch.profiler`` over ``reps`` calls, without
    the host's launch overhead (which sets the wall time of a call whose
    kernels take tens of microseconds).  When every window comes back
    without device events, the CUDA-event time of a call (:func:`time_ms`,
    an upper bound of the device time) is returned instead, and said."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a window now and then comes back without its device events (three
    # in a row once, for SDPA's bf16 backward on packed rows); profile it
    # again rather than report 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    ms = time_ms(fn, reps=reps, warmup=0)
    print("device time: 5 profile windows came back without device "
          "events; the CUDA-event time %.4f ms a call stands in" % ms)
    return ms


# -- kernel phase ---------------------------------------------------------------

def kernel_inputs(n_kv, dtype, seed, dev, n_q=None):
    """``(q, k_pages, v_pages, block_tables, context_lens), scale kwargs``
    at the kernel phase's shapes: B5 (``n_q`` None) over CONTEXTS and 32
    pages per slot, or B6 with ``n_q`` positions per slot over the spec
    engine's 33.  Each slot owns distinct pages; page 0 (scratch) holds
    values so large that a read of it would show."""
    rng = np.random.default_rng(seed)
    max_pages = MAX_PAGES if n_q is None else SPEC_PAGES
    num_pages = SLOTS * max_pages + 1
    if n_q is None:
        q = rng.standard_normal((SLOTS, HEADS, HEAD_DIM), np.float32)
        ctx = np.asarray(CONTEXTS, np.int32)
    else:
        q = rng.standard_normal((SLOTS, n_q, HEADS, HEAD_DIM), np.float32)
        ctx = np.zeros((SLOTS, n_q), np.int32)
        for s, c in enumerate(CONTEXTS):
            if c:
                ctx[s, :min(DRAFTS[s], n_q - 1) + 1] = \
                    c + np.arange(min(DRAFTS[s], n_q - 1) + 1)
    shape = (num_pages, PAGE, n_kv, HEAD_DIM)
    kw = {}
    if dtype == torch.int8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (num_pages, n_kv)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (num_pages, n_kv)).astype(np.float32)
        kp[0] = vp[0] = 127
        ks[0] = vs[0] = 1e2
        kw = {"k_scales": torch.from_numpy(ks).to(dev),
              "v_scales": torch.from_numpy(vs).to(dev)}
    else:
        kp = rng.standard_normal(shape, np.float32)
        vp = rng.standard_normal(shape, np.float32)
        kp[0] = vp[0] = 1e4
    perm = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((SLOTS, max_pages), np.int32)
    used = 0
    for s in range(SLOTS):
        n = -(-int(ctx.reshape(SLOTS, -1)[s].max()) // PAGE)
        bt[s, :n] = perm[used:used + n]
        used += n
    t = [torch.from_numpy(a).to(dev) for a in (q, kp, vp, bt, ctx)]
    if dtype != torch.int8:
        t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return t, kw


def kernel_bound(args, kw):
    """Least time (ms) and what bounds it, from this call's inputs: for
    each slot the K/V rows below its largest context read once (int8: one
    byte a value plus the pages' scale rows), q, the tables and the
    contexts read once and the output written once, over HBM; against
    4·Σctx·H·D fp32 flops (every query position over its own context)
    over the fp32 peak."""
    q, kp, _, bt, ctx = args
    n_kv = kp.shape[2]
    ctx = ctx.reshape(ctx.shape[0], -1).long().cpu()
    per_slot = ctx.max(1).values
    kv = int(per_slot.sum()) * n_kv * HEAD_DIM * 2 * kp.element_size()
    if kw:
        kv += int((-(-per_slot // PAGE)).sum()) * n_kv * 4 * 2
    qo = 2 * q.numel() * 4
    tables = (bt.numel() + ctx.numel()) * 4
    t_bytes = (kv + qo + tables) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * int(ctx.sum()) * HEADS * HEAD_DIM / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_yardstick(args, kw):
    """One ``scaled_dot_product_attention`` call over the same K/V gathered
    contiguous (dequantized, for int8 pools) with a per-position mask
    ``[S, 1, G, T]``; the gather, dequantization and head broadcast are
    set-up, outside the timed call.  bf16 pools pair with a bf16 query."""
    import torch.nn.functional as F
    q, kp, vp, bt, ctx = args
    n_kv = kp.shape[2]
    g = HEADS // n_kv
    t_max = bt.shape[1] * PAGE
    if kw:
        kp = kp.float() * kw["k_scales"][:, None, :, None]
        vp = vp.float() * kw["v_scales"][:, None, :, None]

    def gather(pool):
        seq = pool[bt.long()].reshape(SLOTS, t_max, n_kv, HEAD_DIM)
        return seq.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()

    k, v = gather(kp), gather(vp)
    ctx = ctx.reshape(SLOTS, -1).long()
    mask = (torch.arange(t_max, device=q.device)[None, None, :]
            < ctx[:, :, None])[:, None]
    qq = q.reshape(SLOTS, -1, HEADS, HEAD_DIM).transpose(1, 2) \
        .contiguous().to(kp.dtype)
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def kernel_case(name, kernel, plain, n_kv, dtype, dev, n_q=None, seed=0):
    """Hold one kernel case against its plain version, then time it beside
    the plain version, the library yardstick and its bound."""
    args, kw = kernel_inputs(n_kv, dtype, seed, dev, n_q)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    check(bool(torch.isfinite(got).all()),
          "%s output not finite (%s)" % (kernel.__name__, name))
    err = (got - want).abs().max().item()
    tol = KERNEL_TOL[dtype]
    print("kernel %s %s: max abs err %.3g (tol %g)"
          % (kernel.__name__, name, err, tol))
    check(err <= tol, "%s %s disagrees with its plain version: %.3g > %g"
          % (kernel.__name__, name, err, tol))
    zero_rows = args[4] == 0
    check(zero_rows.any() and not got[zero_rows].any(),
          "ctx == 0 rows are not zero")
    # timing: rotate over copies of the inputs, 100 MB in all (the L2
    # holds 50 MB), so each launch finds its pages cold, as a decode step
    # walking 12 layers' pools does
    pools_bytes = 2 * args[1].numel() * args[1].element_size()
    copies = [(args, kw)] + [
        kernel_inputs(n_kv, dtype, 100 + i, dev, n_q)
        for i in range(max(1, -(-L2_FLUSH_BYTES // pools_bytes)))]
    it = iter(range(10 ** 9))

    def rotate(fn):
        def call():
            a, k = copies[next(it) % len(copies)]
            return fn(*a, **k)
        return call
    ms = time_ms(rotate(kernel), reps=300)
    dev_ms = device_ms(rotate(kernel), reps=50)
    plain_ms = time_ms(rotate(plain), reps=30)
    libs = [sdpa_yardstick(a, k) for a, k in copies]
    lib_ms = time_ms(lambda: libs[next(it) % len(libs)](), reps=100)
    lib_dev_ms = device_ms(lambda: libs[next(it) % len(libs)](), reps=50)
    bound_ms, bound_by = kernel_bound(args, kw)
    grid = paged_grid(args)
    print("  grid %d blocks (K_kv %d x S %d x %d splits of %d pages); "
          "a call %.4f ms, device %.4f ms; plain %.4f ms; sdpa %.4f ms "
          "(device %.4f); bound %.4f ms (%s)"
          % (grid["blocks"], args[1].shape[2], SLOTS, grid["splits"],
             grid["pages_per_split"], ms, dev_ms, plain_ms, lib_ms,
             lib_dev_ms, bound_ms, bound_by))
    return {"case": name, "max_abs_err": err, "tol": tol, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "grid": grid}


def paged_grid(args):
    """The split kernel's grid for these inputs: the wrapper's plan."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    q, kp, _, bt, _ = args
    n_q = q.shape[1] if q.dim() == 4 else 1
    pps, n_split = pa.split_plan(q.shape[0], kp.shape[2], bt.shape[1],
                                 q.shape[-2], q.shape[-1], kp.shape[1], n_q)
    return {"blocks": kp.shape[2] * q.shape[0] * n_split,
            "splits": n_split, "pages_per_split": pps}


def kernel_phase(dev):
    """Every kernel case; returns ``{entry: [case, ...]}`` keyed by the
    kernel entries of the final JSON line."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    cases = {"paged_attention": [], "paged_attention[int8]": [],
             "paged_attention_multi": [], "paged_attention_multi[int8]": []}
    seed = 0
    for n_kv in (12, 4):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            name = "K_kv=%d %s" % (n_kv, str(dtype).split(".")[1])
            suffix = "[int8]" if dtype == torch.int8 else ""
            cases["paged_attention" + suffix].append(kernel_case(
                name, pa.paged_attention, pa.paged_attention_reference,
                n_kv, dtype, dev, seed=seed))
            cases["paged_attention_multi" + suffix].append(kernel_case(
                "G=%d %s" % (SPEC_K + 1, name), pa.paged_attention_multi,
                pa.paged_attention_multi_reference, n_kv, dtype, dev,
                n_q=SPEC_K + 1, seed=seed + 1))
            # B6 at one position is B5: the same template
            (q, kp, vp, bt, ctx), kw = kernel_inputs(n_kv, dtype, seed + 2,
                                                     dev)
            single = pa.paged_attention(q, kp, vp, bt, ctx, **kw)
            multi = pa.paged_attention_multi(
                q[:, None].contiguous(), kp, vp, bt,
                ctx[:, None].contiguous(), **kw)[:, 0]
            torch.cuda.synchronize()
            err = (single - multi).abs().max().item()
            print("kernel paged_attention_multi G=1 vs paged_attention %s: "
                  "max abs diff %.3g (tol %g)" % (name, err, G1_TOL))
            check(err <= G1_TOL, "B6 at G = 1 differs from B5 (%s): %.3g"
                  % (name, err))
            cases["paged_attention_multi" + suffix][-1]["g1_vs_b5_err"] = err
            seed += 3
    return cases


# -- flash-attention kernel phase -------------------------------------------------

def flash_inputs(case, dtype, seed, dev):
    """``(q, k, v, do, seg)`` for one flash case: normal(0, 1) values made
    in numpy; ``seg`` is ``[B, T]`` int32 ids from ``pack_sequences`` of
    random-length documents (packed case) or None."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    rng = np.random.default_rng(seed)
    b, tq, tk = case["b"], case["tq"], case["tk"]

    def normal(t):
        a = rng.standard_normal((b, HEADS, t, HEAD_DIM), np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)
    q, k, v, do = normal(tq), normal(tk), normal(tk), normal(tq)
    seg = None
    if case["packed"]:
        docs = []
        while len(docs) < 4 * b or \
                len(gpt.pack_sequences(docs, tq)[1]) <= b:
            docs.append(np.zeros(int(rng.integers(1, tq // 3)), np.int32))
        seg = torch.from_numpy(gpt.pack_sequences(docs, tq)[1][:b]).to(dev)
    return q, k, v, do, seg


def flash_pairs(case, seg, dev):
    """(query, key) pairs the masks leave visible, summed over B·H: the
    work this run's data needs."""
    tq, tk = case["tq"], case["tk"]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=dev)
    if case["causal"]:
        mask = mask.tril()
    if seg is None:
        per_row = int(mask.sum()) * case["b"]
    else:
        per_row = int((mask[None] & (seg[:, :, None] == seg[:, None, :]))
                      .sum())
    return per_row * HEADS


#: fp32 FLOP/s outside the tensor cores and bf16 FLOP/s on them (H100 SXM
#: data sheet, dense)
FLASH_PEAK = {torch.float32: FP32_FLOPS_PER_S, torch.bfloat16: 989e12}
#: T x T x D products per visible (query, key) pair: B1 S and P·V; B2 S,
#: dP and dS·K; B3 S, dP, Pᵀ·dO and dSᵀ·Q; B7 the five distinct ones
FLASH_MATMULS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4,
                 "flash_bwd_fused": 5}
#: kernel vs plain version, element by element: ``|kernel - plain| <= atol
#: + rtol * |plain|`` for every element of every output, as ``(atol,
#: rtol)`` by the output's dtype (lse is fp32 in every case).  Both sides
#: compute in fp32 from the same values and differ only in the order of
#: their sums (B7's dq by atomics in no fixed order), a few fp32 steps of
#: the summands (at most 1.8e-6 on values of unit scale on an H100).  A
#: bf16 output rounds those fp32 values to bf16, so the two may land one
#: bf16 step apart, and a bf16 step is at most 2^-7 of the value; two
#: steps, or an error not proportional to the value, fail
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2 ** -7)}


def flash_bound(name, case, dtype, seg, pairs):
    """Least time (ms) and what bounds it: the kernel's products over the
    visible pairs at the dtype's peak, against each input read once and
    each output written once over HBM."""
    b, tq, tk = case["b"], case["tq"], case["tk"]
    el = torch.tensor([], dtype=dtype).element_size()
    q_b = b * HEADS * tq * HEAD_DIM * el
    kv_b = 2 * b * HEADS * tk * HEAD_DIM * el
    rows = b * HEADS * tq * 4                       # one fp32 per query row
    seg_b = 0 if seg is None else b * (tq + tk) * 4
    if name == "flash_fwd":
        n_bytes = q_b + kv_b + seg_b + q_b + rows   # out, lse
    else:
        n_bytes = 2 * q_b + kv_b + 2 * rows + seg_b  # q, do, lse, delta in
        n_bytes += {"flash_bwd_dq": q_b, "flash_bwd_dkv": kv_b,
                    "flash_bwd_fused": q_b + kv_b}[name]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLASH_MATMULS[name] * 2 * HEAD_DIM * pairs \
        / FLASH_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_case(label, case, dtype, dev, seed):
    """B1, B2, B3 and B7 on one case, each held against its plain version
    on the same inputs (the backward kernels all get the plain forward's
    lse and delta), then timed beside the plain version, SDPA and the
    bound.  Returns ``{kernel name: case record}``."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v, do, seg = flash_inputs(case, dtype, seed, dev)
    causal = case["causal"]
    kw = {"causal": causal, "segment_ids": seg}
    fwd_args = (q, k, v)
    out_ref, lse = fa.flash_fwd_reference(*fwd_args, **kw)
    delta = (do.float() * out_ref.float()).sum(-1)
    bwd_args = (q, k, v, do, lse, delta)
    runs = {"flash_fwd": (fa.flash_fwd, fa.flash_fwd_reference, fwd_args),
            "flash_bwd_dq": (fa.flash_bwd_dq, fa.flash_bwd_dq_reference,
                             bwd_args),
            "flash_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference,
                              bwd_args),
            "flash_bwd_fused": (fa.flash_bwd_fused,
                                fa.flash_bwd_fused_reference, bwd_args)}
    # the library yardstick: SDPA forward, and its autograd backward (dq,
    # dk and dv together) beside B2 + B3 and beside B7
    mask = None
    if seg is not None:
        mask = (torch.ones(case["tq"], case["tk"], dtype=torch.bool,
                           device=dev).tril()[None]
                & (seg[:, :, None] == seg[:, None, :]))[:, None]
    sdpa_kw = ({"attn_mask": mask} if mask is not None
               else {"is_causal": causal})
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
    sdpa_calls = {"fwd": lambda: F.scaled_dot_product_attention(
                      q, k, v, **sdpa_kw),
                  "bwd": lambda: torch.autograd.grad(
                      sdpa_out, (qg, kg, vg), do, retain_graph=True)}
    sdpa = {d: time_ms(fn, reps=10) for d, fn in sdpa_calls.items()}
    # their device times too: SDPA's bf16 backward at T 1024 causal, a
    # call's time through autograd, read 0.18 to 0.34 ms in three calls on
    # one H100 model at the same shapes
    sdpa_dev = {d: device_ms(fn, reps=5, warmup=1)
                for d, fn in sdpa_calls.items()}
    pairs = flash_pairs(case, seg, dev)
    out = {}
    for name, (kernel, plain, args) in runs.items():
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, worst = 0.0, 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  "%s %s: output %s %r, plain %s %r" % (
                      name, label, g.dtype, tuple(g.shape), w.dtype,
                      tuple(w.shape)))
            check(bool(torch.isfinite(g).all()),
                  "%s output not finite (%s)" % (name, label))
            check(bool(w.any()), "%s: the plain version gave zeros (%s)"
                  % (name, label))
            atol, rtol = FLASH_TOL[g.dtype]
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            worst = max(worst, (diff / (atol + rtol * w.float().abs()))
                        .max().item())
        print("kernel %s %s: max abs err %.3g; worst element at %.3g of "
              "atol + rtol x |plain| %r (limit 1)"
              % (name, label, err, worst, FLASH_TOL[dtype]))
        check(worst <= 1.0, "%s %s disagrees with its plain version: an "
              "element at %.3g of atol + rtol x |plain|"
              % (name, label, worst))
        ms = time_ms(lambda: kernel(*args, **kw), reps=10, warmup=2)
        dev_ms = device_ms(lambda: kernel(*args, **kw), reps=5, warmup=1)
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
        lib = "fwd" if name == "flash_fwd" else "bwd"
        bound_ms, bound_by = flash_bound(name, case, dtype, seg, pairs)
        print("  time %.4f ms (device %.4f), plain %.4f ms, sdpa %s %.4f "
              "ms (device %.4f), bound %.4f ms (%s); in device time %.2fx "
              "the bound, %.2fx sdpa"
              % (ms, dev_ms, plain_ms, "forward" if name == "flash_fwd" else
                 "backward (dq, dk, dv)", sdpa[lib], sdpa_dev[lib], bound_ms,
                 bound_by, dev_ms / bound_ms, dev_ms / sdpa_dev[lib]))
        out[name] = {"case": label, "max_abs_err": err,
                     "max_err_of_tol": worst, "tol": FLASH_TOL[dtype],
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": sdpa[lib],
                     "library_device_ms": sdpa_dev[lib],
                     "bound_ms": bound_ms, "bound_by": bound_by}

    # the split backward as the training path calls it, B2 then B3, beside
    # SDPA's backward: the one PyTorch call that computes dq, dk and dv
    def pair():
        fa.flash_bwd_dq(*bwd_args, **kw)
        fa.flash_bwd_dkv(*bwd_args, **kw)
    pair_ms = time_ms(pair, reps=10, warmup=2)
    pair_dev = device_ms(pair, reps=5, warmup=1)
    print("  B2 + B3 %s: a pair %.4f ms (device %.4f), sdpa backward %.4f "
          "ms (device %.4f): %.2fx a call, %.2fx in device time"
          % (label, pair_ms, pair_dev, sdpa["bwd"], sdpa_dev["bwd"],
             pair_ms / sdpa["bwd"], pair_dev / sdpa_dev["bwd"]))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name].update({"pair_ms": pair_ms, "pair_device_ms": pair_dev,
                          "pair_vs_library": pair_ms / sdpa["bwd"],
                          "pair_vs_library_device":
                              pair_dev / sdpa_dev["bwd"]})
    fused = out["flash_bwd_fused"]
    fused["vs_library_device"] = fused["device_ms"] / sdpa_dev["bwd"]
    print("  B7 %s: %.4f ms a call (device %.4f), sdpa backward %.4f ms "
          "(device %.4f): %.2fx a call, %.2fx in device time"
          % (label, fused["ms"], fused["device_ms"], sdpa["bwd"],
             sdpa_dev["bwd"], fused["ms"] / sdpa["bwd"],
             fused["vs_library_device"]))
    del sdpa_out, qg, kg, vg
    return out


#: the flash cases: gpt2_small's training shape, bench.py's T = 2048, a
#: packed batch and an odd cross-attention shape
FLASH_CASES = [
    ("T=1024 causal", {"b": 8, "tq": 1024, "tk": 1024, "causal": True,
                       "packed": False}),
    ("T=2048 causal", {"b": 8, "tq": 2048, "tk": 2048, "causal": True,
                       "packed": False}),
    ("T=1024 causal packed", {"b": 8, "tq": 1024, "tk": 1024,
                              "causal": True, "packed": True}),
    ("Tq=1000 Tk=777 cross", {"b": 8, "tq": 1000, "tk": 777,
                              "causal": False, "packed": False}),
]


def flash_kernel_phase(dev):
    """Every flash case in fp32 and bf16; returns ``{kernel name: [case
    record, ...]}`` with the fp32 training-shape case first."""
    cases = {name: [] for name in FLASH_MATMULS}
    seed = 1000
    for dtype in (torch.float32, torch.bfloat16):
        for label, case in FLASH_CASES:
            recs = flash_case("%s %s" % (label, str(dtype).split(".")[1]),
                              case, dtype, dev, seed)
            for name, rec in recs.items():
                cases[name].append(rec)
            seed += 1
    return cases


# -- serving phases ---------------------------------------------------------

def seeded_gpt2_small(seed, dev):
    """gpt2_small on ``dev`` with random weights from a numpy seed:
    matrices and biases normal(0, 0.02), LayerNorm gamma 1 and beta 0."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    net = gpt.gpt2_small()
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, p in net.collect_params().items():
        if name.endswith("_gamma"):
            a = np.ones(tuple(p.shape), np.float32)
        elif name.endswith("_beta"):
            a = np.zeros(tuple(p.shape), np.float32)
        else:
            a = rng.standard_normal(tuple(p.shape), np.float32) * 0.02
        arrays[name] = a
    return gpt.load_jax_params(net, arrays, dev)


def make_engine(net, dev, **kw):
    from mxnet_tpu_torch.serving import ServingEngine
    return ServingEngine(net, num_slots=SLOTS, page_size=PAGE,
                         max_prefill_len=PROMPT_MAX, max_seq_len=MAX_SEQ,
                         record_logits=True, device=dev, **kw)


def serve(engine, prompts, label, card):
    """Submit every prompt at once and drive ``engine.step`` until idle,
    with both launch counts set to 0 just before and read just after.
    Checks every request finished, the path's launch law and page
    conservation; returns ``(stats, requests)``."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    n_layers = len(engine._kv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches.clear()
    t_start = time.perf_counter()
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    decode_step_s = []
    while not engine.sched.idle:
        prefills = engine.prefills
        t = time.perf_counter()
        engine.step()                  # ends in a host copy: synchronised
        if engine.prefills == prefills:
            decode_step_s.append(time.perf_counter() - t)
        check(engine.alloc.speculative_pages == 0,
              "a page stayed marked speculative after a step")
    wall = time.perf_counter() - t_start
    single = pa.launches["paged_attention"]
    multi = pa.launches["paged_attention_multi"]
    peak = torch.cuda.max_memory_allocated()
    done = sum(r.done and len(r.tokens) == MAX_NEW for r in reqs)
    print("%s: %d/%d requests served, %d decode steps, %d prefills, %d "
          "paged_attention and %d paged_attention_multi launches"
          % (label, done, N_REQUESTS, engine.decode_steps, engine.prefills,
             single, multi))
    check(done == N_REQUESTS, "%s: only %d of %d requests finished"
          % (label, done, N_REQUESTS))
    # the torch meaning of one program per decode step
    launched, idle = (multi, single) if engine.spec_k else (single, multi)
    check(engine.decode_steps > 0 and
          launched == n_layers * engine.decode_steps and idle == 0,
          "%s: launches %d (and %d of the other kernel) != %d layers x %d "
          "decode steps" % (label, launched, idle, n_layers,
                            engine.decode_steps))
    engine.alloc.assert_conservation()
    check(engine.alloc.used_pages == 0, "%s: pages leaked" % label)
    tokens = sum(len(r.tokens) for r in reqs)
    p50 = statistics.median(decode_step_s) * 1e3
    print("%s [%s]: %d tokens in %.3f s = %.1f tokens/s; decode step p50 "
          "%.3f ms over %d steps; peak device memory %.1f MiB"
          % (label, card, tokens, wall, tokens / wall, p50,
             len(decode_step_s), peak / 2 ** 20))
    stats = {"launches": launched, "decode_steps": engine.decode_steps,
             "tokens_per_s": tokens / wall, "decode_step_p50_ms": p50,
             "peak_mib": peak / 2 ** 20,
             "kv_bytes_per_token": engine.kv_bytes_per_token}
    if engine.spec_k:
        stats.update(drafted=engine.spec_draft_tokens,
                     accepted=engine.spec_accepted,
                     rejected=engine.spec_rejected)
        print("%s: %d tokens drafted, %d accepted, %d rejected"
              % (label, engine.spec_draft_tokens, engine.spec_accepted,
                 engine.spec_rejected))
    return stats, reqs


def check_against_dense(net, reqs, dev, label):
    """Every emitted logits row against a teacher-forced dense forward over
    prompt + emitted tokens, from the same weights, sharing no code with
    the paged path below the layer math; an emitted token that is not the
    dense argmax must be a near tie.  Returns the max abs error."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    oracle = gpt.params_to(gpt.decode_params(net), dev)
    worst, near_ties = 0.0, 0
    for req in reqs:
        seq = np.concatenate([req.prompt, req.tokens[:-1]])
        with torch.no_grad():
            dense = gpt.dense_logits(
                oracle, torch.from_numpy(seq).long().to(dev)[None],
                net.num_heads)[0, req.prompt.size - 1:].cpu().numpy()
        got = np.stack(req.logits_trace)
        check(got.shape == dense.shape == (MAX_NEW, net._vocab),
              "logits trace shape %r" % (got.shape,))
        check(bool(np.isfinite(got).all()), "non-finite logits")
        worst = max(worst, float(np.abs(got - dense).max()))
        for row, tok in zip(dense, req.tokens):
            if int(row.argmax()) != tok:
                top2 = np.sort(row)[-2:]
                check(top2[1] - top2[0] <= 2 * LOGITS_TOL,
                      "%s: emitted token is not the dense argmax" % label)
                near_ties += 1
    print("%s: emitted logits vs dense recompute: max abs err %.3g (tol %g),"
          " %d near-tie tokens" % (label, worst, LOGITS_TOL, near_ties))
    check(worst <= LOGITS_TOL, "%s: logits disagree with the dense "
          "recompute" % label)
    return worst


def compare_streams(reqs, ref_reqs, tol, label):
    """Logits rows of two runs of the same prompts, up to each request's
    first differing token, which must be a near tie of the reference row.
    Returns ``(max abs diff, requests that diverged)``."""
    worst, diverged = 0.0, 0
    for r, ref in zip(reqs, ref_reqs):
        for t, (row, ref_row) in enumerate(zip(r.logits_trace,
                                               ref.logits_trace)):
            worst = max(worst, float(np.abs(row - ref_row).max()))
            if r.tokens[t] != ref.tokens[t]:
                top2 = np.sort(ref_row)[-2:]
                check(top2[1] - top2[0] <= 2 * tol,
                      "%s: request %d diverges at token %d without a near "
                      "tie" % (label, r.rid, t))
                diverged += 1
                break
    print("%s: logits max abs diff %.3g (tol %g) up to the first "
          "divergence; %d of %d requests diverged at a near tie"
          % (label, worst, tol, diverged, len(reqs)))
    check(worst <= tol, "%s: logits differ by %.3g > %g" % (label, worst,
                                                          tol))
    return worst, diverged


def slice_phase(dev, card):
    t0 = time.perf_counter()
    # the engine copies the weights it serves onto the card itself; the
    # net that holds them stays on the host, so the serving phases' peak
    # memory counts the engine's copy only
    net = seeded_gpt2_small(seed=0, dev="cpu")
    engine = make_engine(net, dev)
    print("slice: gpt2_small %d x %d, %d heads, vocab %d on %s, set-up "
          "%.1f s" % (len(net.blocks), net._units, net.num_heads, net._vocab,
                      dev, time.perf_counter() - t0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1,
                                     size=N_REQUESTS)]
    served, reqs = serve(engine, prompts, "slice", card)
    served["logits_max_abs_err"] = check_against_dense(net, reqs, dev,
                                                       "slice")
    return served, engine, prompts, net, reqs


def profile_phase(engine, prompts, card, label="profile", steps=10):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` decode steps with every slot resident (after the checked run,
    so its launches are not counted there).  Prints the device's busy share
    of the window and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:engine.num_slots]:
        engine.submit(p, MAX_NEW)
    engine.step()                      # admit and prefill every slot
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            engine.step()
        wall_us = (time.perf_counter() - t) * 1e6
    out = profile_summary(prof, wall_us, steps, "%s [%s]: decode step"
                          % (label, card))
    engine.run_until_idle()
    return out


def profile_summary(prof, wall_us, steps, label):
    """Device busy share of a profiled window of ``steps`` steps that took
    ``wall_us`` on the host clock, kernels per step and the kernels with
    the most device time; printed and returned."""
    from torch.autograd import DeviceType
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out = {"steps": steps, "step_ms": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "device_busy_share": busy_us / wall_us,
           "kernels_per_step": sum(e.count for e in kernels) / steps,
           "top": [{"name": e.key[:60], "per_step": e.count / steps,
                    "ms_per_step": e.self_device_time_total / steps / 1e3}
                   for e in kernels[:8]]}
    print("%s %.3f ms, device busy %.3f ms (%.1f%%), %.0f kernels per step"
          % (label, out["step_ms"], out["device_busy_ms_per_step"],
             100 * out["device_busy_share"], out["kernels_per_step"]))
    for k in out["top"]:
        print("  %8.3f ms/step  %5.1f/step  %s"
              % (k["ms_per_step"], k["per_step"], k["name"]))
    return out


def spec_phase(net, prompts, off, off_reqs, dev, card):
    """spec_k 4 with (a) the n-gram drafter and (b) an oracle drafter that
    proposes each request's continuation from the spec-off stream."""
    out = {}
    eng = make_engine(net, dev, spec_k=SPEC_K)
    ngram, reqs = serve(eng, prompts, "spec (n-gram)", card)
    ngram["logits_max_abs_err"] = check_against_dense(net, reqs, dev,
                                                      "spec (n-gram)")
    ngram["profile"] = profile_phase(eng, prompts, card,
                                     "profile spec (n-gram)")
    del eng
    out["ngram"] = ngram
    streams = [list(r.prompt) + list(r.tokens) for r in off_reqs]

    def oracle(ctx, k):
        ctx = list(ctx)
        for seq in streams:
            if len(ctx) <= len(seq) and seq[:len(ctx)] == ctx:
                return seq[len(ctx):len(ctx) + k]
        return []
    orc, reqs = serve(make_engine(net, dev, spec_k=SPEC_K,
                                  spec_drafter=oracle), prompts,
                      "spec (oracle)", card)
    check(orc["decode_steps"] < off["decode_steps"],
          "oracle drafts did not cut decode steps: %d vs %d spec-off"
          % (orc["decode_steps"], off["decode_steps"]))
    orc["logits_vs_spec_off"], orc["diverged"] = compare_streams(
        reqs, off_reqs, LOGITS_TOL, "spec (oracle) vs spec-off")
    print("spec (oracle): %d decode steps vs %d spec-off"
          % (orc["decode_steps"], off["decode_steps"]))
    out["oracle"] = orc
    return out


def int8_phase(net, prompts, off_reqs, dev, card):
    """int8 pages, spec off and spec_k 4: each run with the kernels and
    again with the plain versions bound in their place."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.ops import paged_attention as pa
    out = {}
    for label, spec_k in (("int8", 0), ("int8 spec", SPEC_K)):
        eng = make_engine(net, dev, kv_dtype="int8", spec_k=spec_k)
        stats, reqs = serve(eng, prompts, label, card)
        stats["profile"] = profile_phase(eng, prompts, card,
                                         "profile " + label)
        kernels = (gpt.paged_attention, gpt.paged_attention_multi)
        gpt.paged_attention = pa.paged_attention_reference
        gpt.paged_attention_multi = pa.paged_attention_multi_reference
        try:
            plain = make_engine(net, dev, kv_dtype="int8", spec_k=spec_k)
            plain_reqs = [plain.submit(p, MAX_NEW) for p in prompts]
            plain.run_until_idle()
        finally:
            gpt.paged_attention, gpt.paged_attention_multi = kernels
        stats["logits_vs_plain"], stats["diverged_vs_plain"] = \
            compare_streams(reqs, plain_reqs, INT8_LOGITS_TOL,
                            "%s kernels vs plain" % label)
        agree = [next((t for t, (a, b) in enumerate(zip(r.tokens, f.tokens))
                       if a != b), MAX_NEW) / MAX_NEW
                 for r, f in zip(reqs, off_reqs)]
        stats["fp32_agreement"] = statistics.mean(agree)
        stats["fp32_identical_requests"] = sum(a == 1.0 for a in agree)
        print("%s: greedy agreement with the fp32 stream %.3f (mean "
              "matched prefix), %d of %d requests identical; kv bytes per "
              "token %.1f" % (label, stats["fp32_agreement"],
                              stats["fp32_identical_requests"], N_REQUESTS,
                              eng.kv_bytes_per_token))
        out["spec" if spec_k else "plain"] = stats
        del eng, plain
    return out


# -- training phases --------------------------------------------------------------

#: names of the four flash kernel wrappers, in launch-count order
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_fused")


def flash_counts(reset=False):
    """``(B1, B2, B3, B7)`` launch counts from ``ops.flash_attention.launches``
    (binding plain versions or a spy into the module does not touch them);
    ``reset`` sets them to 0."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    if reset:
        fa.launches.clear()
    return tuple(fa.launches[n] for n in FLASH_KERNELS)


@contextlib.contextmanager
def plain_flash():
    """Binds the flash kernels' plain versions into
    ``ops.flash_attention`` for the body (the autograd Function looks the
    wrappers up there at every call), and the kernels back after."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    saved = [getattr(fa, n) for n in FLASH_KERNELS]
    for n in FLASH_KERNELS:
        setattr(fa, n, getattr(fa, n + "_reference"))
    try:
        yield
    finally:
        for n, f in zip(FLASH_KERNELS, saved):
            setattr(fa, n, f)


@contextlib.contextmanager
def dtype_spy():
    """Records, for the body, the dtypes of q that reach ``flash_fwd``
    (B1) and ``flash_bwd_fused`` (B7): yields ``{name: set of dtypes}``."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    seen = {"flash_fwd": set(), "flash_bwd_fused": set()}
    saved = {n: getattr(fa, n) for n in seen}

    def spy(name):
        def call(q, *args, **kw):
            seen[name].add(q.dtype)
            return saved[name](q, *args, **kw)
        return call
    for n in seen:
        setattr(fa, n, spy(n))
    try:
        yield seen
    finally:
        for n, f in saved.items():
            setattr(fa, n, f)


@contextlib.contextmanager
def env(name, value):
    """Environment variable ``name`` set to ``value`` for the body."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def flash_bwd_env(impl):
    """``MXTPU_FLASH_BWD=impl`` for the body."""
    return env("MXTPU_FLASH_BWD", impl)


def train_batch(dev, seed, packed):
    """``(x, y, segments)``: a fixed ``[TRAIN_B, TRAIN_T]`` batch of random
    tokens with next-token labels, or (``packed``) rows packed by
    ``pack_sequences`` from random-length documents of random tokens, with
    the labels shifted left along the row and the segment ids."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    rng = np.random.default_rng(seed)
    if not packed:
        toks = rng.integers(0, VOCAB, (TRAIN_B, TRAIN_T + 1))
        x, y, seg = toks[:, :-1], toks[:, 1:], None
    else:
        docs = []
        while len(docs) < 4 * TRAIN_B or \
                len(gpt.pack_sequences(docs, TRAIN_T)[0]) <= TRAIN_B:
            docs.append(rng.integers(0, VOCAB, int(rng.integers(16, 600))))
        x, seg = (a[:TRAIN_B] for a in gpt.pack_sequences(docs, TRAIN_T))
        y = np.roll(x, -1, axis=1)
        seg = torch.from_numpy(seg).to(dev)
    return (torch.from_numpy(np.asarray(x)).long().to(dev),
            torch.from_numpy(np.asarray(y).astype(np.float32)).to(dev), seg)


def train_step(net, trainer, loss_fn, batch, autocast=False):
    """One step of the Gluon loop of ``train_gpt.py``: forward and loss
    under ``autograd.record``, ``backward``, ``trainer.step(B)``.  Returns
    the loss (a host float, so the step has ended on the card)."""
    from mxnet_tpu_torch import autograd
    x, y, seg = batch
    with autograd.record():
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            loss = loss_fn(net(x, seg), y).mean()
    loss.backward()
    trainer.step(x.shape[0])
    return loss.item()


def reset_params(net, init):
    """Write ``init`` into the net's parameters in place (the tensors the
    Trainer updates stay the same)."""
    for p, v in zip(net.collect_params().values(), init):
        p.set_data(v)


def param_copies(net):
    """Copies of the net's parameter tensors, in ``collect_params`` order."""
    return [p.data().data.detach().clone()
            for p in net.collect_params().values()]


def train_run(net, init, batch, steps, label, card, want, autocast=False,
              keep_after=None, step_fn=train_step, keep_grads=False):
    """``steps`` steps (``step_fn``, by default :func:`train_step`) from
    the weights ``init`` with a fresh Adam Trainer, the flash launch counts
    set to 0 before each step and read after it; every step must launch
    ``want`` (B1, B2, B3, B7).  Returns the run's stats (losses, launches,
    tokens/s, step p50, peak memory; with ``keep_grads``, ``"grads"``:
    copies of the first step's gradients by name, which the Trainer leaves
    in ``p.grad()``) and, with ``keep_after``, copies of the parameters
    after that many steps."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as gloss
    reset_params(net, init)
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": TRAIN_LR})
    loss_fn = gloss.SoftmaxCrossEntropyLoss(axis=-1, sparse_label=True)
    # the peak is this run's: earlier phases' garbage is collected first
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, totals, kept, grads = [], [], [0, 0, 0, 0], None, None
    for step in range(steps):
        flash_counts(reset=True)
        t = time.perf_counter()
        losses.append(step_fn(net, trainer, loss_fn, batch, autocast))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        got = flash_counts()
        check(got == want, "%s step %d: flash launches (B1, B2, B3, B7) %r,"
              " want %r" % (label, step, got, want))
        totals = [a + b for a, b in zip(totals, got)]
        check(math.isfinite(losses[-1]), "%s: loss not finite at step %d"
              % (label, step))
        if keep_after == step + 1:
            kept = param_copies(net)
        if keep_grads and step == 0:
            grads = {n: p.grad().data.detach().clone()
                     for n, p in net.collect_params().items()}
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[1:] or step_s
    n_tok = int(np.prod(batch[0].shape))
    stats = {"losses": losses, "launches": dict(zip(FLASH_KERNELS, totals)),
             "tokens_per_s": n_tok * len(steady) / sum(steady),
             "step_p50_ms": statistics.median(steady) * 1e3,
             "first_step_ms": step_s[0] * 1e3, "peak_mib": peak / 2 ** 20}
    if keep_grads:
        stats["grads"] = grads
    print("%s [%s]: losses %s; %.1f tokens/s, step p50 %.1f ms (first "
          "step %.1f ms), peak device memory %.1f MiB; flash launches %s"
          % (label, card, " ".join("%.4f" % v for v in losses),
             stats["tokens_per_s"], stats["step_p50_ms"],
             stats["first_step_ms"], stats["peak_mib"], stats["launches"]))
    return stats, kept


def compare_to_plain(net, init, batch, kernel_stats, kept, label, card,
                     autocast=False, loss_tol=TRAIN_LOSS_TOL,
                     param_tol=TRAIN_PARAM_TOL):
    """Rerun the first ``PLAIN_STEPS`` steps with the plain versions bound
    in and hold losses and (unless ``param_tol`` is None) parameters
    against the kernel run's."""
    with plain_flash():
        plain, plain_kept = train_run(net, init, batch, PLAIN_STEPS,
                                      label + " (plain versions)", card,
                                      (0, 0, 0, 0), autocast=autocast,
                                      keep_after=PLAIN_STEPS)
    loss_err = max(abs(a - b) for a, b in
                   zip(kernel_stats["losses"], plain["losses"]))
    param_err = max((a - b).abs().max().item()
                    for a, b in zip(kept, plain_kept))
    print("%s: kernels vs plain versions over %d steps: loss max abs diff "
          "%.3g (tol %g), parameters max abs diff %.3g (tol %s)"
          % (label, PLAIN_STEPS, loss_err, loss_tol, param_err,
             "not held" if param_tol is None else "%g" % param_tol))
    check(loss_err <= loss_tol, "%s: losses differ from the plain "
          "rerun by %.3g" % (label, loss_err))
    check(param_tol is None or param_err <= param_tol, "%s: parameters "
          "differ from the plain rerun by %.3g" % (label, param_err))
    return {"loss_vs_plain": loss_err, "params_vs_plain": param_err,
            "plain": plain}


def train_profile(net, init, batch, card, label, steps=3, autocast=False,
                  step_fn=train_step):
    """``torch.profiler`` over ``steps`` steady training steps (after one
    unprofiled step; not part of any checked run)."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as gloss
    reset_params(net, init)
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": TRAIN_LR})
    loss_fn = gloss.SoftmaxCrossEntropyLoss(axis=-1, sparse_label=True)
    step_fn(net, trainer, loss_fn, batch, autocast)
    torch.cuda.synchronize()
    # a window that comes back without device events (device_ms) is
    # profiled again; after 3 such, the shares read "nan"
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                step_fn(net, trainer, loss_fn, batch, autocast)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        out = profile_summary(prof, wall_us, steps, "profile train %s [%s]: "
                              "step" % (label, card))
        if out["device_busy_ms_per_step"] > 0:
            break
    from torch.autograd import DeviceType
    flash_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "flash_" in e.key)
    out["flash_ms_per_step"] = flash_us / steps / 1e3
    out["flash_share_of_busy"] = (
        out["flash_ms_per_step"] / out["device_busy_ms_per_step"]
        if out["device_busy_ms_per_step"] > 0 else float("nan"))
    print("  flash kernels %.3f ms a step, %.1f%% of the device's busy time"
          % (out["flash_ms_per_step"], 100 * out["flash_share_of_busy"]))
    return out


def train_phase(dev, card):
    """gpt2_small at full width trained through the Gluon loop on a fixed
    batch: split backward (B1 + B2 + B3), its plain-version rerun, a
    profile window, the fused backward (B1 + B7), a packed batch against
    its plain rerun, and bf16 autocast with the split and with the fused
    backward."""
    t0 = time.perf_counter()
    net = seeded_gpt2_small(seed=0, dev=dev)
    init = param_copies(net)
    n_layers = len(net.blocks)
    print("train: gpt2_small %d x %d, %d heads, vocab %d on %s, batch %d x "
          "%d, Adam lr %g, set-up %.1f s"
          % (n_layers, net._units, net.num_heads, net._vocab, dev, TRAIN_B,
             TRAIN_T, TRAIN_LR, time.perf_counter() - t0))
    batch = train_batch(dev, seed=3, packed=False)
    split_want = (n_layers, n_layers, n_layers, 0)
    fused_want = (n_layers, 0, 0, n_layers)
    out = {}

    with flash_bwd_env("split"):
        split, kept = train_run(net, init, batch, TRAIN_STEPS,
                                "train split", card, split_want,
                                keep_after=PLAIN_STEPS)
        check(split["losses"][-1] < split["losses"][0],
              "train split: the loss did not fall: %r" % split["losses"])
        split.update(compare_to_plain(net, init, batch, split, kept,
                                      "train split", card))
        split["profile"] = train_profile(net, init, batch, card, "split")
    out["split"] = split
    del kept

    with flash_bwd_env("fused"):
        fused, _ = train_run(net, init, batch, TRAIN_STEPS, "train fused",
                             card, fused_want)
        fused["profile"] = train_profile(net, init, batch, card, "fused")
    fused["losses_vs_split"] = max(
        abs(a - b) for a, b in zip(fused["losses"], split["losses"]))
    print("train fused: losses max abs diff from the split run %.3g (tol "
          "%g)" % (fused["losses_vs_split"], FUSED_LOSS_TOL))
    check(fused["losses_vs_split"] <= FUSED_LOSS_TOL,
          "train fused: losses differ from the split run by %.3g"
          % fused["losses_vs_split"])
    out["fused"] = fused

    packed_batch = train_batch(dev, seed=4, packed=True)
    with flash_bwd_env("split"):
        packed, kept = train_run(net, init, packed_batch, PLAIN_STEPS,
                                 "train packed", card, split_want,
                                 keep_after=PLAIN_STEPS)
        packed.update(compare_to_plain(net, init, packed_batch, packed,
                                       kept, "train packed", card))
    out["packed"] = packed
    del kept

    with flash_bwd_env("split"), dtype_spy() as seen:
        bf16, kept = train_run(net, init, batch, BF16_STEPS,
                               "train bf16 autocast", card, split_want,
                               autocast=True, keep_after=PLAIN_STEPS)
    print("train bf16 autocast: the flash kernels got q/k/v in %s"
          % sorted(str(d) for d in seen["flash_fwd"]))
    check(seen == {"flash_fwd": {torch.bfloat16}, "flash_bwd_fused": set()},
          "bf16 autocast: the flash kernels got %r" % seen)
    check(bf16["losses"][-1] < bf16["losses"][0],
          "bf16 autocast: the loss did not fall: %r" % bf16["losses"])
    with flash_bwd_env("split"):
        bf16.update(compare_to_plain(net, init, batch, bf16, kept,
                                     "train bf16 autocast", card,
                                     autocast=True, loss_tol=BF16_LOSS_TOL,
                                     param_tol=None))
        del kept
        bf16["profile"] = train_profile(net, init, batch, card, "bf16",
                                        autocast=True)

    # B7 bf16 on the tensor cores, on the training path
    with flash_bwd_env("fused"):
        with dtype_spy() as seen:
            bf16_fused, kept = train_run(
                net, init, batch, BF16_STEPS, "train bf16 autocast fused",
                card, fused_want, autocast=True, keep_after=PLAIN_STEPS)
        check(seen == {"flash_fwd": {torch.bfloat16},
                       "flash_bwd_fused": {torch.bfloat16}},
              "bf16 autocast fused: the flash kernels got %r" % seen)
        check(bf16_fused["losses"][-1] < bf16_fused["losses"][0],
              "bf16 autocast fused: the loss did not fall: %r"
              % bf16_fused["losses"])
        bf16_fused["losses_vs_split"] = max(
            abs(a - b) for a, b in zip(bf16_fused["losses"], bf16["losses"]))
        print("train bf16 autocast fused: losses max abs diff from the bf16 "
              "split run %.3g (tol %g)"
              % (bf16_fused["losses_vs_split"], BF16_LOSS_TOL))
        check(bf16_fused["losses_vs_split"] <= BF16_LOSS_TOL,
              "bf16 autocast fused: losses differ from the bf16 split run "
              "by %.3g" % bf16_fused["losses_vs_split"])
        bf16_fused.update(compare_to_plain(
            net, init, batch, bf16_fused, kept, "train bf16 autocast fused",
            card, autocast=True, loss_tol=BF16_LOSS_TOL, param_tol=None))
        del kept
        bf16_fused["profile"] = train_profile(
            net, init, batch, card, "bf16 fused", autocast=True)
    out["bf16_fused"] = bf16_fused
    out["bf16"] = bf16
    return out


# -- fused LayerNorm-residual kernel phase ----------------------------------------

#: B4 cases: the symbolic phase's rows (B·T = 8192 rows of D = 768) in fp32
#: and bf16, the ragged (3, 130) of the JAX package's own check (the generic path: D
#: not a multiple of 4) and (1000, 1024) (rows not a multiple of the
#: block's 8, the widest vector case)
LN_CASES = [("R=8192 D=768 fp32", 8192, 768, torch.float32),
            ("R=8192 D=768 bf16", 8192, 768, torch.bfloat16),
            ("R=3 D=130 fp32", 3, 130, torch.float32),
            ("R=1000 D=1024 fp32", 1000, 1024, torch.float32)]
LN_EPS = 1e-5
#: flops an element: the add, the two sums, the centring, the square, the
#: scale by rstd and gamma, the shift by beta
LN_FLOPS_PER_ELEMENT = 8


def ln_bound(rows, d, dtype):
    """Least time (ms) and what bounds it: x and r read once, y written
    once (in the dtype), gamma and beta read once and mean and rstd
    written once (fp32), over HBM; against the fp32 flops over the fp32
    peak (the kernel computes in fp32 whatever the dtype)."""
    el = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 3 * rows * d * el + 2 * d * 4 + 2 * rows * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = LN_FLOPS_PER_ELEMENT * rows * d / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ln_inputs(rows, d, dtype, seed, dev):
    """``(x, r, gamma, beta)``: normal(0, 1) rows in ``dtype``, fp32
    gamma and beta, made in numpy."""
    rng = np.random.default_rng(seed)
    x, r = (torch.from_numpy(rng.standard_normal((rows, d), np.float32))
            .to(dev).to(dtype) for _ in range(2))
    g, b = (torch.from_numpy(rng.standard_normal(d, np.float32)).to(dev)
            for _ in range(2))
    return x, r, g, b


def ln_case(label, rows, d, dtype, dev, seed):
    """B4 on one case held against its plain version, every element of y,
    mean and rstd; then timed beside the plain version, the library
    yardstick (``x + r`` then ``F.layer_norm``: two launches, since no
    single PyTorch call adds the residual) and the bound."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import layer_norm as ln
    args = ln_inputs(rows, d, dtype, seed, dev)
    got = ln.layer_norm_residual(*args, LN_EPS)
    torch.cuda.synchronize()
    want = ln.layer_norm_residual_reference(*args, LN_EPS)
    err, worst = 0.0, 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              "layer_norm_residual %s: output %s %r, plain %s %r"
              % (label, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape)))
        check(bool(torch.isfinite(g).all()),
              "layer_norm_residual output not finite (%s)" % label)
        atol, rtol = FLASH_TOL[g.dtype]
        diff = (g.float() - w.float()).abs()
        err = max(err, diff.max().item())
        worst = max(worst, (diff / (atol + rtol * w.float().abs()))
                    .max().item())
    print("kernel layer_norm_residual %s: max abs err %.3g; worst element "
          "at %.3g of atol + rtol x |plain| %r (limit 1)"
          % (label, err, worst, FLASH_TOL[dtype]))
    check(worst <= 1.0, "layer_norm_residual %s disagrees with its plain "
          "version: an element at %.3g of atol + rtol x |plain|"
          % (label, worst))
    # timing: rotate over copies of the inputs, 100 MB in all where the
    # case is that large (the L2 holds 50 MB), as the graph's LayerNorms
    # meet rows another kernel wrote a while before
    n_copies = min(8, max(1, -(-L2_FLUSH_BYTES // (
        2 * args[0].numel() * args[0].element_size()))))
    copies = [args] + [ln_inputs(rows, d, dtype, seed + 100 + i, dev)
                       for i in range(n_copies - 1)]
    it = iter(range(10 ** 9))

    def rotate(fn):
        def call():
            return fn(*copies[next(it) % len(copies)], LN_EPS)
        return call

    # F.layer_norm takes gamma and beta in the rows' dtype: cast outside
    # the timed calls
    lib_args = [(x, r, g.to(x.dtype), b.to(x.dtype)) for x, r, g, b in copies]

    def library(*_):
        x, r, g, b = lib_args[next(it) % len(lib_args)]
        return F.layer_norm(x + r, (d,), g, b, LN_EPS)
    fns = {"ms": rotate(ln.layer_norm_residual),
           "plain_ms": rotate(ln.layer_norm_residual_reference),
           "library_ms": library}
    # the time of a call in a loop of calls (CUDA events), as for every
    # other kernel, which the host's launch path sets at these sizes; and,
    # beside it, the device time (the profiler's kernel times)
    rec = {"case": label, "max_abs_err": err, "max_err_of_tol": worst,
           "tol": FLASH_TOL[dtype]}
    for key, fn in fns.items():
        rec[key] = time_ms(fn, reps=200)
        rec[key.replace("ms", "device_ms")] = device_ms(fn, reps=100)
    rec["bound_ms"], rec["bound_by"] = ln_bound(rows, d, dtype)
    print("  a call %.4f ms, plain %.4f ms, x + r then F.layer_norm %.4f ms, "
          "bound %.4f ms (%s); device time %.4f, %.4f, %.4f ms"
          % (rec["ms"], rec["plain_ms"], rec["library_ms"], rec["bound_ms"],
             rec["bound_by"], rec["device_ms"], rec["plain_device_ms"],
             rec["library_device_ms"]))
    return rec


def ln_kernel_phase(dev):
    """Every B4 case, the symbolic phase's fp32 shape first."""
    return [ln_case(label, rows, d, dtype, dev, 2000 + i)
            for i, (label, rows, d, dtype) in enumerate(LN_CASES)]


# -- symbolic phases ------------------------------------------------------------

def build_gpt_sym(mx, layers, units, heads, seq, vocab):
    """The post-LN transformer of ``tools/perf_probe/graph_probe.py``'s
    ``build_gpt_sym``, built with ``mx`` (this package, or the JAX one in
    the parity tests): a symbolic causal bias in every block (arange ->
    reshape -> compare -> scale, which fold and CSE collapse), batched
    heads through ``batch_dot``, ``LayerNorm(x + sublayer)`` twice a block
    (the fuse pass's B4 pattern), an FC -> gelu FFN and a ``SoftmaxOutput``
    head over ``[B, seq]`` token ids."""
    d = units // heads

    def causal_bias(name):
        q = mx.sym.Reshape(mx.sym._arange(start=0, stop=seq,
                                          name="%s_qpos" % name),
                           shape=(seq, 1))
        k = mx.sym.Reshape(mx.sym._arange(start=0, stop=seq,
                                          name="%s_kpos" % name),
                           shape=(1, seq))
        keep = mx.sym.broadcast_greater_equal(q, k)  # 1 where visible
        return (keep - 1.0) * 1e9  # 0 visible, -1e9 masked

    def block(x, name):
        qkv = mx.sym.FullyConnected(x, num_hidden=3 * units, flatten=False,
                                    name="%s_qkv" % name)
        qkv = mx.sym.Reshape(qkv, shape=(-1, seq, 3, heads, d))
        qkv = mx.sym.transpose(qkv, axes=(2, 0, 3, 1, 4))
        q = mx.sym.Reshape(mx.sym.slice_axis(qkv, axis=0, begin=0, end=1),
                           shape=(-1, seq, d))
        k = mx.sym.Reshape(mx.sym.slice_axis(qkv, axis=0, begin=1, end=2),
                           shape=(-1, seq, d))
        v = mx.sym.Reshape(mx.sym.slice_axis(qkv, axis=0, begin=2, end=3),
                           shape=(-1, seq, d))
        scores = mx.sym.batch_dot(q, k, transpose_b=True) * (d ** -0.5)
        scores = mx.sym.broadcast_add(scores, causal_bias(name))
        att = mx.sym.batch_dot(mx.sym.softmax(scores, axis=-1), v)
        att = mx.sym.Reshape(att, shape=(-1, heads, seq, d))
        att = mx.sym.Reshape(mx.sym.transpose(att, axes=(0, 2, 1, 3)),
                             shape=(-1, seq, units))
        att = mx.sym.FullyConnected(att, num_hidden=units, flatten=False,
                                    name="%s_proj" % name)
        x = mx.sym.LayerNorm(x + att, name="%s_ln1" % name)
        h = mx.sym.FullyConnected(x, num_hidden=4 * units, flatten=False,
                                  name="%s_fc1" % name)
        h = mx.sym.Activation(h, act_type="gelu", name="%s_gelu" % name)
        h = mx.sym.FullyConnected(h, num_hidden=units, flatten=False,
                                  name="%s_fc2" % name)
        return mx.sym.LayerNorm(x + h, name="%s_ln2" % name)

    tokens = mx.sym.Variable("data")
    h = mx.sym.Embedding(tokens, input_dim=vocab, output_dim=units,
                         name="wte")
    pos = mx.sym._arange(start=0, stop=seq, name="pos_ids")
    h = mx.sym.broadcast_add(
        h, mx.sym.expand_dims(
            mx.sym.Embedding(pos, input_dim=seq, output_dim=units,
                             name="wpe"), axis=0))
    for i in range(layers):
        h = block(h, "h%d" % i)
    h = mx.sym.FullyConnected(h, num_hidden=vocab, flatten=False,
                              name="lm_head")
    return mx.sym.SoftmaxOutput(h, preserve_shape=True, name="softmax")


#: the symbolic cell: graph_probe's post-LN transformer at gpt2_small's
#: published widths (12 x 768, 12 heads, FFN 3072, vocab padded to 50304),
#: T = 1024, B = 8 (the training phase's batch), fp32 with TF32 off
SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_VOCAB = 12, 768, 12, 50304
SYM_B, SYM_T = 8, 1024
SYM_FWD_REPS, SYM_STEP_REPS, SYM_PROFILE_STEPS = 5, 3, 3
#: kernels vs plain version bound in, and pipeline off vs on: B4 and its
#: plain version (and the unfused LayerNorm) sum in another order, so the
#: probabilities (of order 1/50304) move by rounding only.  Held as log-
#: probabilities, max |log p - log p_ref|: a relative limit on every
#: probability, which an absolute one near 1/50304 is not
SYM_LOGP_TOL = 1e-4
#: gradients: max |g - g_ref| over the tensor, relative to max |g_ref|
#: (element-wise relative errors are meaningless at entries near 0); the
#: rounding differences pass through 12 layers of backward
SYM_GRAD_TOL = 1e-4


@contextlib.contextmanager
def plain_ln():
    """B4's plain version bound into ``ops.layer_norm`` for the body (the
    autograd Function looks the wrapper up there at every call)."""
    from mxnet_tpu_torch.ops import layer_norm as ln
    kernel = ln.layer_norm_residual
    ln.layer_norm_residual = ln.layer_norm_residual_reference
    try:
        yield
    finally:
        ln.layer_norm_residual = kernel


def sym_params(sym, shapes, seed, dev):
    """Seeded weights by argument name on ``dev``: normal(0, 0.02), the
    LayerNorms' gamma 1 and beta 0 (gpt2_small's init) jittered by
    normal(0, 0.1), so a fault in B4's gamma or beta shows end to end."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(),
                           sym.infer_shape(**shapes)[0]):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            a = 1 + 0.1 * rng.standard_normal(shape, np.float32)
        elif name.endswith("_beta"):
            a = 0.1 * rng.standard_normal(shape, np.float32)
        else:
            a = rng.standard_normal(shape, np.float32) * 0.02
        out[name] = torch.from_numpy(a).to(dev)
    return out


def sym_bind(sym, shapes, params, grad_req, passes=""):
    """``simple_bind`` with no ``ctx`` (the default device, the card) under
    ``MXTPU_GRAPH_PASSES=passes``, and the weights copied in by name."""
    with env("MXTPU_GRAPH_PASSES", passes):
        exe = sym.simple_bind(grad_req=grad_req, **shapes)
    exe.copy_params_from(params)
    return exe


def ln_count(reset=False):
    """B4's launch count; ``reset`` sets it to 0 first."""
    from mxnet_tpu_torch.ops import layer_norm as ln
    if reset:
        ln.launches.clear()
    return ln.launches["layer_norm_residual"]


def sym_forward(exe, train, want_launches, label):
    """One forward with B4's count set to 0 before and read after; the
    outputs checked finite, of the head's shape, rows summing to 1.
    Returns the probabilities and the count read."""
    ln_count(reset=True)
    probs = exe.forward(is_train=train)[0].data
    torch.cuda.synchronize()
    got = ln_count()
    check(got == want_launches, "%s: %d B4 launches in a forward, want %d"
          % (label, got, want_launches))
    check(tuple(probs.shape) == (SYM_B, SYM_T, SYM_VOCAB),
          "%s: output shape %r" % (label, tuple(probs.shape)))
    check(bool(torch.isfinite(probs).all()), "%s: non-finite output" % label)
    row_err = (probs.sum(-1) - 1).abs().max().item()
    check(row_err <= 1e-4, "%s: probability rows sum to 1 +- %.3g"
          % (label, row_err))
    return probs, got


def prob_errs(got, want):
    """``(max |p - p_ref|, max |log p - log p_ref|)``."""
    return ((got - want).abs().max().item(),
            (got.log() - want.log()).abs().max().item())


def sym_grads(exe):
    return {n: g.data.clone() for n, g in exe.grad_dict.items()}


def grad_rel_err(got, want):
    """max over the parameters of max |g - g_ref| / max |g_ref|."""
    worst = 0.0
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale > 0:
            worst = max(worst, (got[name] - w).abs().max().item() / scale)
    return worst


def sym_step(exe, label, n_layers_ln):
    """One training step (forward with the graph kept, backward): B4 2L
    times in the forward and never in the backward.  Returns the step's
    count read."""
    _, n = sym_forward(exe, True, n_layers_ln, label + " forward")
    ln_count(reset=True)
    exe.backward()
    torch.cuda.synchronize()
    back = ln_count()
    check(back == 0, "%s: B4 launched in the backward" % label)
    return n + back


def symbolic_phase(dev, card):
    """The symbolic path at full width: ``mx.sym`` builds the graph,
    ``simple_bind`` (no ctx: the card) runs the graph passes, the
    ``Executor`` runs inference and a training step, each held against a
    rerun with B4's plain version bound in and one with the pipeline
    off; forward and step p50, peak memory and a profiled forward."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    n_ln = 2 * SYM_LAYERS
    t0 = time.perf_counter()
    sym = build_gpt_sym(mx, SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_T,
                        SYM_VOCAB)
    shapes = {"data": (SYM_B, SYM_T), "softmax_label": (SYM_B, SYM_T)}
    params = sym_params(sym, shapes, 0, dev)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (SYM_B, SYM_T + 1))
    feeds = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    t1 = time.perf_counter()
    exe = sym_bind(sym, shapes, params, "null")
    bind_s = time.perf_counter() - t1
    check(exe.arg_dict["data"].context == dev,
          "simple_bind without ctx placed the arguments on %s"
          % exe.arg_dict["data"].context)
    for k, v in feeds.items():
        exe.arg_dict[k][:] = v
    rep = exe._graph_report
    rw = rep["rewrites"]
    print("symbolic: post-LN gpt %d x %d, %d heads, vocab %d, B %d x T %d "
          "on %s; graph passes %d -> %d nodes, rewrites %s in %.1f ms; bind "
          "%.1f s, set-up %.1f s"
          % (SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_VOCAB, SYM_B, SYM_T, dev,
             rep["nodes_before"], rep["nodes_after"], rw, rep["total_ms"],
             bind_s, time.perf_counter() - t0))
    check(rw.get("layer_norm_residual") == n_ln,
          "fuse: %r LayerNorm-residual rewrites, want %d"
          % (rw.get("layer_norm_residual"), n_ln))
    check(rw.get("constants", 0) >= 1, "fold: no constant folded")
    check(rw.get("merged", 0) > 0, "cse: nothing merged")
    out = {"report": {k: rep[k] for k in ("nodes_before", "nodes_after",
                                          "rewrites", "total_ms")},
           "bind_s": bind_s}

    # inference: the checked forward, then the timed ones.  ``launches``
    # sums B4's count over every main-path forward, each read between a
    # reset just before it and a read just after it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs, launches = sym_forward(exe, False, n_ln, "symbolic inference")
    probs = probs.clone()
    fwd_s = []
    for _ in range(SYM_FWD_REPS):
        t = time.perf_counter()
        launches += sym_forward(exe, False, n_ln, "symbolic inference")[1]
        fwd_s.append(time.perf_counter() - t)
    out["forward_p50_ms"] = statistics.median(fwd_s) * 1e3
    out["forward_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    with plain_ln():
        plain, _ = sym_forward(exe, False, 0, "symbolic inference (plain B4)")
    out["probs_vs_plain"], out["logp_vs_plain"] = prob_errs(probs, plain)
    del plain
    exe_off = sym_bind(sym, shapes, params, "null", passes="off")
    for k, v in feeds.items():
        exe_off.arg_dict[k][:] = v
    check(exe_off._graph_report is None, "pipeline off still rewrote")
    off, _ = sym_forward(exe_off, False, 0, "symbolic inference (passes off)")
    out["probs_vs_passes_off"], out["logp_vs_passes_off"] = \
        prob_errs(probs, off)
    del off, exe_off
    print("symbolic inference [%s]: %d B4 launches a forward; forward p50 "
          "%.2f ms over %d, peak device memory %.1f MiB; max |p - p_ref| "
          "vs plain B4 %.3g, vs passes off %.3g; max |log p - log p_ref| "
          "%.3g, %.3g (tol %g)"
          % (card, n_ln, out["forward_p50_ms"], SYM_FWD_REPS,
             out["forward_peak_mib"], out["probs_vs_plain"],
             out["probs_vs_passes_off"], out["logp_vs_plain"],
             out["logp_vs_passes_off"], SYM_LOGP_TOL))
    check(out["logp_vs_plain"] <= SYM_LOGP_TOL,
          "inference differs from the plain-B4 rerun")
    check(out["logp_vs_passes_off"] <= SYM_LOGP_TOL,
          "inference differs from the pipeline-off bind")
    ln_count(reset=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(SYM_PROFILE_STEPS):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    n = ln_count()
    check(n == n_ln * SYM_PROFILE_STEPS, "profiled window: %d B4 launches "
          "in %d forwards" % (n, SYM_PROFILE_STEPS))
    launches += n
    out["profile"] = profile_summary(
        prof, wall_us, SYM_PROFILE_STEPS, "profile symbolic [%s]: forward"
        % card)
    del exe, probs

    # training: grad_req write, one checked step, the timed ones, then the
    # plain-B4 and pipeline-off reruns of the step
    exe = sym_bind(sym, shapes, params, "write")
    for k, v in feeds.items():
        exe.arg_dict[k][:] = v
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches += sym_step(exe, "symbolic train", n_ln)
    grads = sym_grads(exe)
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "symbolic train: non-finite gradients")
    step_s = []
    for _ in range(SYM_STEP_REPS):
        t = time.perf_counter()
        launches += sym_step(exe, "symbolic train", n_ln)
        step_s.append(time.perf_counter() - t)
    out["train_step_p50_ms"] = statistics.median(step_s) * 1e3
    out["train_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["grads_repeat"] = grad_rel_err(sym_grads(exe), grads)
    with plain_ln():
        exe.forward(is_train=True)
        exe.backward()
    out["grads_vs_plain"] = grad_rel_err(sym_grads(exe), grads)
    del exe
    exe_off = sym_bind(sym, shapes, params, "write", passes="off")
    for k, v in feeds.items():
        exe_off.arg_dict[k][:] = v
    ln_count(reset=True)
    exe_off.forward(is_train=True)
    exe_off.backward()
    check(ln_count() == 0, "pipeline off launched B4")
    out["grads_vs_passes_off"] = grad_rel_err(sym_grads(exe_off), grads)
    del exe_off, grads
    print("symbolic train [%s]: %d B4 launches a forward, 0 in the "
          "backward; step p50 %.2f ms over %d, peak device memory %.1f MiB;"
          " gradients (max |diff| / max |g| over the parameters) repeat "
          "%.3g, vs plain B4 %.3g, vs passes off %.3g (tol %g)"
          % (card, n_ln, out["train_step_p50_ms"], SYM_STEP_REPS,
             out["train_peak_mib"], out["grads_repeat"],
             out["grads_vs_plain"], out["grads_vs_passes_off"],
             SYM_GRAD_TOL))
    check(out["grads_vs_plain"] <= SYM_GRAD_TOL,
          "training gradients differ from the plain-B4 rerun")
    check(out["grads_vs_passes_off"] <= SYM_GRAD_TOL,
          "training gradients differ from the pipeline-off bind")
    out["launches"] = launches
    print("symbolic: %d B4 launches counted over the phase's %d inference "
          "and %d training forwards" % (launches, 1 + SYM_FWD_REPS
                                        + SYM_PROFILE_STEPS,
                                        1 + SYM_STEP_REPS))
    return out


# -- the Module path: mx.mod.Module.fit ---------------------------------------

def synthetic_digits(n, seed=0):
    """``example/image-classification/train_mnist.py``'s synthetic digit
    set (a copy: the port does not import the example): class k is k + 1
    bright bars at distinct rows plus noise.  Returns ``(labels, images
    [n, 28, 28])``, float32."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.uniform(0, 0.15, (n, 28, 28)).astype(np.float32)
    for i, cls in enumerate(y):
        for r in (np.arange(cls + 1) * 28) // 10:
            x[i, r:r + 2, 4:24] += 0.8
    return y.astype(np.float32), np.clip(x, 0, 1)


def mnist_mlp(mx, num_classes=10):
    """``symbols/mlp.py`` of the example (128-64-10, relu), built with
    ``mx``."""
    data = mx.sym.Flatten(data=mx.sym.Variable("data"))
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    act1 = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=64)
    act2 = mx.sym.Activation(data=fc2, name="relu2", act_type="relu")
    fc3 = mx.sym.FullyConnected(data=act2, name="fc3",
                                num_hidden=num_classes)
    return mx.sym.SoftmaxOutput(data=fc3, name="softmax")


#: the Module cell: the symbolic cell's model, widths and seeded weights
#: through ``mx.mod.Module.fit``: 6 batches of B 8 x T 1024 seeded random
#: tokens, Adam at 3e-4 (train_gpt.py's), fp32 with TF32 off.  The tokens
#: follow Zipf's law over the vocabulary (p(rank r) ~ 1 / (r + 1), as a
#: text's unigrams do): with uniform tokens the only thing 5 updates can
#: learn is a narrower logit spread, about 2% of perplexity, against about
#: 1% of batch-to-batch noise between two 8192-token batches
MOD_BATCHES, MOD_LR, MOD_SPLIT_STEPS, MOD_PROFILE_STEPS = 6, 3e-4, 3, 3
#: the gradients of the fused step against the split path's
#: (forward_backward + update through the Updater) over 3 steps, and
#: against a rerun of the first step with B4's plain version: both runs
#: with SGD at MOD_SGD_LR and momentum 0.9 from the same weights, whose
#: momentum after n steps is -lr times the momentum-weighted sum of the
#: n gradients (rescale_grad and any loss scale included), held per tensor
#: at SYM_GRAD_TOL of its max |m_ref| as the symbolic phase holds
#: gradients.  The lr keeps 3 steps' weight changes small (so the later
#: gradients are taken at nearly the same weights on both sides); the
#: comparison does not depend on it
MOD_SGD_LR = 1e-5
#: the fused Adam's parameters against the split path's after the same 3
#: steps of the fit: both run the same update arithmetic on gradients
#: equal up to rounding (a repeat differs by 4.5e-8 of max |g|), but Adam
#: moves every element by about lr whatever its gradient's size, so an
#: element whose gradient lies within that rounding of zero moves by up to
#: lr (3e-4) either way.  Held: in every tensor, the share of elements off
#: by more than MOD_PARAM_TOL of the tensor's max |p| is at most
#: MOD_NOISE_SHARE (a fault in the update moves nearly every element; the
#: gradients themselves are held by the SGD check above).  Left out: the
#: key third of each block's qkv bias, whose true gradient is zero (a key
#: bias adds the same q . b_k to every score of a query row, which the
#: softmax removes), so all of it is such noise (ROADMAP.md queue C,
#: properties of the reference)
MOD_PARAM_TOL, MOD_NOISE_SHARE = 1e-4, 1e-3
#: timed calls of each form of the guarded Adam update on the GPT's
#: parameters
MOD_GUARD_REPS = 10
#: train_mnist.py's MLP run (its settings) and the bar of
#: tests/test_examples.py
MNIST_EXAMPLES, MNIST_EPOCHS, MNIST_BATCH, MNIST_ACC = 1200, 2, 64, 0.95
#: kernels of the optimizer update in a profile: the multi-tensor kernels
#: and the norm reduction of the guard
UPDATE_KERNELS = ("multi_tensor", "foreach", "lpnorm")


def param_diff(got, want, units):
    """``(share, err, name)`` of the worst tensor: the share of its
    elements off by more than MOD_PARAM_TOL of its max |p_ref|, and its
    max |p - p_ref| / max |p_ref|; the key third of each qkv bias
    (``units`` wide) left out."""
    worst = (0.0, 0.0, "")
    for n, w in want.items():
        diff = (got[n] - w).abs() / w.abs().max()
        if n.endswith("_qkv_bias"):
            diff[units:2 * units] = 0
        share = (diff > MOD_PARAM_TOL).float().mean().item()
        worst = max(worst, (share, diff.max().item(), n))
    return worst


def mod_params(mod):
    """The bound parameters of ``mod`` (device clones)."""
    return {n: mod._exec.arg_dict[n].data.clone() for n in mod._param_names}


def mod_momentum(mod):
    """The momentum of every parameter by name, from the fused state or
    the Updater's (the fused state is flushed into the Updater first)."""
    mod._fused.flush()
    return {n: mod._updater.states[i]
            for i, n in enumerate(mod._param_names)}


def module_gpt_run(mx, sym, params, batches, dev, steps, split=False,
                   sgd=False):
    """A fresh Module on ``dev`` with ``params``, Adam at MOD_LR (``sgd``:
    SGD at MOD_SGD_LR with momentum 0.9), through ``steps`` batches: fused
    ``fit_step`` or the split pair."""
    mod = mx.mod.Module(sym, context=dev)
    mod.bind(data_shapes=[("data", (SYM_B, SYM_T))],
             label_shapes=[("softmax_label", (SYM_B, SYM_T))])
    mod.init_params(arg_params=params)
    if sgd:
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": MOD_SGD_LR, "momentum": 0.9})
    else:
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": MOD_LR})
    for b in batches[:steps]:
        if split:
            mod.forward_backward(b)
            mod.update()
        else:
            mod.fit_step(b)
    torch.cuda.synchronize()
    check(mod._fused.active != split, "module rerun: the %s path did not "
          "run" % ("split" if split else "fused"))
    return mod


def module_phase(dev, card):
    """``mx.mod.Module.fit`` on the card: the symbolic cell's GPT at full
    width (24 B4 launches a fit step), then train_mnist.py's MLP and a
    skipped NaN batch.  Returns the phase's numbers and B4's count."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import optimizer_ops
    n_ln = 2 * SYM_LAYERS
    sym = build_gpt_sym(mx, SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_T,
                        SYM_VOCAB)
    shapes = {"data": (SYM_B, SYM_T), "softmax_label": (SYM_B, SYM_T)}
    params = sym_params(sym, shapes, 0, dev)
    zipf = 1.0 / np.arange(1, VOCAB + 1)
    toks = np.random.default_rng(5).choice(
        VOCAB, (MOD_BATCHES * SYM_B, SYM_T + 1), p=zipf / zipf.sum())
    train = mx.io.NDArrayIter(toks[:, :-1].astype(np.float32),
                              toks[:, 1:].astype(np.float32),
                              batch_size=SYM_B)
    batches = list(train)
    train.reset()
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    steps, snaps = [], {}
    fit_step = mod.fit_step

    def timed_fit_step(batch):
        # host clock around a synced step; B4's count read around it
        torch.cuda.synchronize()
        ln_count(reset=True)
        t = time.perf_counter()
        fit_step(batch)
        torch.cuda.synchronize()
        # the split path's update() drops the fused step
        steps.append({"s": time.perf_counter() - t,
                      "fused": mod._fused.active, "b4": ln_count()})
        if len(steps) in (1, MOD_SPLIT_STEPS):
            snaps[len(steps)] = mod_params(mod)

    mod.fit_step = timed_fit_step
    ppl = []
    metric = mx.metric.Perplexity(None)

    def per_batch(param):
        # the batch's own perplexity from the running sums
        m = param.eval_metric
        prev = ppl[-1][1:] if ppl else (0.0, 0)
        ppl.append((math.exp((m.sum_metric - prev[0])
                             / (m.num_inst - prev[1])),
                    m.sum_metric, m.num_inst))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(train, optimizer="adam",
            optimizer_params={"learning_rate": MOD_LR}, eval_metric=metric,
            num_epoch=1, arg_params=params, batch_end_callback=per_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"fit_s": fit_s,
           "step_ms": [st["s"] * 1e3 for st in steps],
           "fit_step_p50_ms": statistics.median(st["s"] for st in steps)
           * 1e3,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "perplexity": [p[0] for p in ppl],
           "launches": sum(st["b4"] for st in steps)}
    check(len(steps) == MOD_BATCHES and all(st["fused"] for st in steps),
          "module: fit took the fused step on %d of %d batches"
          % (sum(st["fused"] for st in steps), MOD_BATCHES))
    check([st["b4"] for st in steps] == [n_ln] * MOD_BATCHES,
          "module: B4 launches per fit step %r, want %d each"
          % ([st["b4"] for st in steps], n_ln))
    check(all(math.isfinite(p) for p in out["perplexity"]),
          "module: non-finite perplexity %r" % out["perplexity"])
    check(out["perplexity"][-1] < out["perplexity"][0],
          "module: perplexity did not fall: %r" % out["perplexity"])
    print("module [%s]: Module.fit on the post-LN gpt %d x %d, vocab %d, "
          "B %d x T %d, %d batches, Adam %g: fit step p50 %.2f ms (steps "
          "%s ms), fit %.1f s, peak device memory %.1f MiB; %d B4 launches "
          "(%d a step); perplexity by batch %s"
          % (card, SYM_LAYERS, SYM_UNITS, SYM_VOCAB, SYM_B, SYM_T,
             MOD_BATCHES, MOD_LR, out["fit_step_p50_ms"],
             ", ".join("%.1f" % x for x in out["step_ms"]), fit_s,
             out["peak_mib"], out["launches"], n_ln,
             ", ".join("%.1f" % x for x in out["perplexity"])))

    # the metric on the device against the predictions copied to the host
    # (the reference's numpy metrics read host arrays): one step with its
    # metric update each way, then both ways on the same outputs
    last = batches[-1]

    def host_outputs():
        return [o.data.cpu() for o in mod.get_outputs()]

    def preds(where):
        return host_outputs() if where == "host" else mod.get_outputs()

    for where in ("device", "host"):
        m = mx.metric.Perplexity(None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit_step(last)
        m.update(last.label, preds(where))
        torch.cuda.synchronize()
        out["step_with_%s_metric_ms" % where] = \
            (time.perf_counter() - t) * 1e3
    for where in ("device", "host"):
        m = mx.metric.Perplexity(None)
        m.update(last.label, preds(where))
        out["metric_%s" % where] = m.get()[1]
    print("module [%s]: a fit step with its Perplexity update %.2f ms with "
          "the metric reduced on the device, %.2f ms with the [%d, %d, %d] "
          "predictions copied to the host first; perplexity %.6f vs %.6f "
          "on the same outputs"
          % (card, out["step_with_device_metric_ms"],
             out["step_with_host_metric_ms"], SYM_B, SYM_T, SYM_VOCAB,
             out["metric_device"], out["metric_host"]))
    check(abs(out["metric_device"] / out["metric_host"] - 1) < 1e-5,
          "module: device and host perplexity differ")

    # a profiled window of fused steps (the main path: B4 counted)
    ln_count(reset=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[:MOD_PROFILE_STEPS]:
            fit_step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    n = ln_count()
    check(n == n_ln * MOD_PROFILE_STEPS, "module profile: %d B4 launches "
          "in %d steps" % (n, MOD_PROFILE_STEPS))
    out["launches"] += n
    out["profile"] = profile_summary(prof, wall_us, MOD_PROFILE_STEPS,
                                     "profile module [%s]: fit step" % card)
    from torch.autograd import DeviceType
    upd = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and any(k in e.key for k in UPDATE_KERNELS)]
    out["update_launches_per_step"] = sum(e.count for e in upd) \
        / MOD_PROFILE_STEPS
    out["update_ms_per_step"] = sum(e.self_device_time_total for e in upd) \
        / MOD_PROFILE_STEPS / 1e3
    print("profile module [%s]: the optimizer update %.1f launches a step "
          "(multi-tensor kernels and the guard's norm), %.3f ms of device "
          "time a step, for %d parameters"
          % (card, out["update_launches_per_step"],
             out["update_ms_per_step"], len(mod._param_names)))

    # the two forms of the guarded Adam update on these parameters: the
    # Module's (check, then update in place) and the Trainer's (update
    # into temporaries, then a select on the device)
    gen = torch.Generator(device=dev).manual_seed(7)
    wts = {n: mod._exec.arg_dict[n].data.clone() for n in mod._param_names}
    grads = {n: torch.randn(w.shape, generator=gen, device=dev) * 1e-3
             for n, w in wts.items()}
    del mod, prof
    init_state, apply_fn = optimizer_ops.make_fused_apply("adam", {})
    for form, defer in (("check_then_update", False), ("select", True)):
        guarded = optimizer_ops.make_guarded_apply(apply_fn, defer)
        state = init_state(wts)
        out["guard_%s_ms" % form] = device_ms(
            lambda: guarded(wts, grads, state, MOD_LR, 0.0, 1.0, 1.0),
            MOD_GUARD_REPS)
        del state
    n_params = len(wts)
    del wts, grads
    torch.cuda.empty_cache()
    print("module [%s]: the guarded Adam update over the %d parameters, "
          "device time a call: %.3f ms checked then applied in place (the "
          "Module's), %.3f ms into temporaries and selected (the "
          "Trainer's)" % (card, n_params,
                          out["guard_check_then_update_ms"],
                          out["guard_select_ms"]))

    # the fused Adam against the split path from the same weights
    split = module_gpt_run(mx, sym, params, batches, dev, MOD_SPLIT_STEPS,
                           split=True)
    out["share_vs_split"], out["params_vs_split"], split_at = param_diff(
        mod_params(split), snaps[MOD_SPLIT_STEPS], SYM_UNITS)
    del split, snaps
    # the gradients: SGD momentum, fused against split and plain B4
    fused = mod_momentum(module_gpt_run(mx, sym, params, batches, dev,
                                        MOD_SPLIT_STEPS, sgd=True))
    out["grads_vs_split"] = grad_rel_err(mod_momentum(module_gpt_run(
        mx, sym, params, batches, dev, MOD_SPLIT_STEPS, split=True,
        sgd=True)), fused)
    del fused
    first = mod_momentum(module_gpt_run(mx, sym, params, batches, dev, 1,
                                        sgd=True))
    with plain_ln():
        out["grads_vs_plain_b4"] = grad_rel_err(mod_momentum(
            module_gpt_run(mx, sym, params, batches, dev, 1, sgd=True)),
            first)
    del first
    torch.cuda.empty_cache()
    print("module [%s]: SGD momentum (the gradients times -lr) after %d "
          "fused steps vs the split path: max |m - m_ref| %.3g of max "
          "|m_ref|; after 1 vs plain B4: %.3g (limit SYM_GRAD_TOL %g).  "
          "Adam parameters after %d fused steps vs the split path: at most "
          "%.3g of a tensor's elements (%s) off by more than %g of its max "
          "|p|, the worst by %.3g (qkv bias key thirds left out; share "
          "limit %g)"
          % (card, MOD_SPLIT_STEPS, out["grads_vs_split"],
             out["grads_vs_plain_b4"], SYM_GRAD_TOL, MOD_SPLIT_STEPS,
             out["share_vs_split"], split_at, MOD_PARAM_TOL,
             out["params_vs_split"], MOD_NOISE_SHARE))
    check(out["grads_vs_split"] <= SYM_GRAD_TOL,
          "module: fused gradients differ from the split path's")
    check(out["grads_vs_plain_b4"] <= SYM_GRAD_TOL,
          "module: the first step's gradients differ from plain B4's")
    check(out["share_vs_split"] <= MOD_NOISE_SHARE,
          "module: fused Adam steps differ from the split path")
    out["mnist"] = mnist_module_run(mx, card)
    return out


def mnist_module_run(mx, card):
    """train_mnist.py's MLP through ``Module.fit`` on the card with the
    example's settings; then one batch with a NaN pixel, which the guard
    must skip."""
    torch.manual_seed(0)
    ty, tx = synthetic_digits(MNIST_EXAMPLES, seed=0)
    vy, vx = synthetic_digits(MNIST_EXAMPLES // 6, seed=1)
    train = mx.io.NDArrayIter(tx[:, None], ty, MNIST_BATCH, shuffle=True,
                              rng=np.random.RandomState(0))
    val = mx.io.NDArrayIter(vx[:, None], vy, MNIST_BATCH)
    mod = mx.mod.Module(mnist_mlp(mx), context=mx.gpu(0))
    acc = mx.metric.Accuracy()
    t = time.perf_counter()
    mod.fit(train, eval_data=val, eval_metric=acc, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            num_epoch=MNIST_EPOCHS)
    torch.cuda.synchronize()
    out = {"fit_s": time.perf_counter() - t, "train_acc": acc.get()[1],
           "val_acc": mod.score(val, "acc")[0][1],
           "fused": mod._fused.active}
    check(out["fused"], "mnist: the fused step never ran")
    check(out["train_acc"] > MNIST_ACC and out["val_acc"] > MNIST_ACC,
          "mnist: accuracy train %.4f, validation %.4f (want > %g)"
          % (out["train_acc"], out["val_acc"], MNIST_ACC))
    train.reset()
    batch = next(iter(train))
    bad = mx.io.DataBatch([batch.data[0].copy()], batch.label)
    bad.data[0][0, 0, 14, 14] = float("nan")
    before = mod_params(mod)
    state = {n: st.clone() for n, st in mod._fused.state.items()}
    opt = mod._optimizer
    clocks = (dict(opt._index_update_count), opt.num_update)
    mod.fit_step(bad)
    torch.cuda.synchronize()
    after = mod_params(mod)
    out["nan_batch_skipped"] = (
        all(torch.equal(after[n], before[n]) for n in before)
        and all(torch.equal(mod._fused.state[n], st)
                for n, st in state.items())
        and (dict(opt._index_update_count), opt.num_update) == clocks
        and mod._consec_guard_skips == 1)
    print("mnist [%s]: train_mnist.py's MLP through Module.fit, %d "
          "examples, %d epochs, batch %d: train accuracy %.4f, validation "
          "%.4f in %.1f s; a NaN-pixel batch skipped (parameters, momentum "
          "and clocks as before): %s"
          % (card, MNIST_EXAMPLES, MNIST_EPOCHS, MNIST_BATCH,
             out["train_acc"], out["val_acc"], out["fit_s"],
             out["nan_batch_skipped"]))
    check(out["nan_batch_skipped"], "mnist: the NaN batch was not skipped")
    return out


# -- imperative path: mx.nd + autograd, and mx.rtc user kernels -------------

#: the user kernels of the imperative path, as a user of ``mx.rtc.CudaRtc``
#: writes them (the input pointers, then the output pointer, then the
#: output's element count), each beside a plain PyTorch version
SGD_UPDATE_SRC = r"""
// out = w - lr * (rescale * g + wd * w), with hp = [lr, wd, rescale] on
// the card, so a new learning rate compiles nothing
__global__ void kernel(const float* w, const float* g, const float* hp,
                       float* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = w[i] - hp[0] * (hp[2] * g[i] + hp[1] * w[i]);
}
"""

ROW_L2NORM_SRC = r"""
// out[r] = sqrt(sum_j x[r, j]^2): one block of 256 threads a row, a tree
// sum in static shared memory; cols = [row length] on the card
__global__ void kernel(const float* x, const long long* cols, float* out,
                       long long n) {
  __shared__ float part[256];
  const long long d = cols[0];
  const float* row = x + blockIdx.x * d;
  float s = 0.f;
  for (long long j = threadIdx.x; j < d; j += blockDim.x) {
    float v = row[j];
    s += v * v;
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) part[threadIdx.x] += part[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0 && blockIdx.x < n) out[blockIdx.x] = sqrtf(part[0]);
}
"""


def sgd_update_plain(w, g, hp):
    """The plain version of ``SGD_UPDATE_SRC``."""
    return w - hp[0] * (hp[2] * g + hp[1] * w)


def row_l2norm_plain(x, cols):
    """The plain version of ``ROW_L2NORM_SRC``."""
    return torch.sqrt((x * x).sum(dim=1))


def sgd_update_kernel(mx):
    """The ``sgd_update`` user kernel (default geometry and output)."""
    return mx.rtc.CudaRtc("sgd_update", SGD_UPDATE_SRC)


def row_l2norm_kernel(mx, rows):
    """The ``row_l2norm`` user kernel over ``rows`` rows: a block a row,
    one output a row."""
    return mx.rtc.CudaRtc("row_l2norm", ROW_L2NORM_SRC, out_shape=(rows,),
                          grid=(rows, 1, 1), block=(256, 1, 1))


def gpt_nd(mx, params, data, label, layers, units, heads, seq, vocab):
    """The imperative twin of :func:`build_gpt_sym`: the same ops in the
    same order through ``mx.nd`` (this package, or the JAX one in the
    parity tests), on ``params`` (name -> NDArray, the symbol's argument
    names), ``data`` token ids and ``label`` ``[B, seq]``.  Returns the
    ``SoftmaxOutput`` probabilities ``[B, seq, vocab]``."""
    nd = mx.nd
    d = units // heads
    ctx = data.context

    def causal_bias():
        q = nd.Reshape(nd.arange(0, seq, ctx=ctx), shape=(seq, 1))
        k = nd.Reshape(nd.arange(0, seq, ctx=ctx), shape=(1, seq))
        keep = nd.broadcast_greater_equal(q, k)     # 1 where visible
        return (keep - 1.0) * 1e9                   # 0 visible, -1e9 masked

    def dense(x, name, n):
        return nd.FullyConnected(x, params[name + "_weight"],
                                 params[name + "_bias"], num_hidden=n,
                                 flatten=False)

    def layer_norm(x, name):
        return nd.LayerNorm(x, params[name + "_gamma"],
                            params[name + "_beta"])

    def block(x, name):
        qkv = nd.Reshape(dense(x, name + "_qkv", 3 * units),
                         shape=(-1, seq, 3, heads, d))
        qkv = nd.transpose(qkv, axes=(2, 0, 3, 1, 4))
        q, k, v = (nd.Reshape(nd.slice_axis(qkv, axis=0, begin=i,
                                            end=i + 1), shape=(-1, seq, d))
                   for i in range(3))
        scores = nd.batch_dot(q, k, transpose_b=True) * (d ** -0.5)
        scores = nd.broadcast_add(scores, causal_bias())
        att = nd.batch_dot(nd.softmax(scores, axis=-1), v)
        att = nd.Reshape(att, shape=(-1, heads, seq, d))
        att = nd.Reshape(nd.transpose(att, axes=(0, 2, 1, 3)),
                         shape=(-1, seq, units))
        x = layer_norm(x + dense(att, name + "_proj", units), name + "_ln1")
        h = nd.Activation(dense(x, name + "_fc1", 4 * units),
                          act_type="gelu")
        return layer_norm(x + dense(h, name + "_fc2", units), name + "_ln2")

    h = nd.Embedding(data, params["wte_weight"], input_dim=vocab,
                     output_dim=units)
    pos = nd.arange(0, seq, ctx=ctx)
    h = nd.broadcast_add(h, nd.expand_dims(
        nd.Embedding(pos, params["wpe_weight"], input_dim=seq,
                     output_dim=units), axis=0))
    for i in range(layers):
        h = block(h, "h%d" % i)
    return nd.SoftmaxOutput(dense(h, "lm_head", vocab), label,
                            preserve_shape=True)


def nd_loss(mx, probs, label, vocab):
    """Mean cross-entropy of ``probs`` at ``label``, a host float."""
    picked = mx.nd.log(probs) * mx.nd.one_hot(label, depth=vocab)
    return float(-picked.sum().asscalar() / label.size)


def imperative_step(mx, params, data, label, dims, update):
    """One step of the imperative loop: the forward under
    ``autograd.record()``, ``backward()``, then ``update(name, w)`` for
    every parameter.  Returns the probabilities."""
    with mx.autograd.record():
        probs = gpt_nd(mx, params, data, label, *dims)
    probs.backward()
    for name, w in params.items():
        update(name, w)
    return probs


#: rtc kernel phase: sgd_update on the imperative cell's parameter shapes
#: (wte first, the entry's main case) and a ragged length; row_l2norm on
#: rows of the FFN's width and on a ragged tiny case
RTC_SGD_CASES = [(50304, 768), (768, 3072), (768,), (1000003,)]
RTC_NORM_CASES = [(8192, 3072), (3, 130)]
#: sgd_update's hyperparameters in the kernel cases: [lr, wd, rescale]
RTC_HP = [0.1, 0.01, 1.0 / 8192]
#: kernel vs plain version, fp32: max |out - plain| <= RTC_TOL * max |plain|
#: (the same arithmetic in another order: a fused multiply-add in the
#: update, the tree against torch's sum in the norm)
RTC_TOL = 1e-6
#: sgd_update held by what it changed: max |(out - w) - (plain - w)| over
#: max |plain - w|.  Rounding the output to fp32 costs up to an ulp of w,
#: and one ulp of the largest weight (|w| about 5.3 at wte) over the
#: largest change (about 5.6e-3) is 8.5e-5; the limit allows two such
#: ulps.  Leaving out a fiftieth of the gradient term (at most 7.3e-5 at
#: wte) shows as 2.6e-4
RTC_UPDATE_TOL = 2e-4


def update_err(out, plain, w):
    """max |(out - w) - (plain - w)| / max |plain - w|: an update held by
    what it changed, not by the weights it leaves (0 where neither
    changed anything)."""
    want = plain - w
    num = ((out - w) - want).abs().max().item()
    den = want.abs().max().item()
    return num / den if den else num


def rtc_bound(name, shape):
    """Least time (ms) and what bounds it, fp32: ``sgd_update`` reads w
    and g and writes the output (12 B an element) and does three
    multiplies, an add and a subtract; ``row_l2norm`` reads x (4 B an
    element), writes a value a row and does a multiply and an add an
    element.  Bytes over HBM against flops over the fp32 peak."""
    n = math.prod(shape)
    if name == "sgd_update":
        n_bytes, flops = 12 * n, 5 * n
    else:
        n_bytes, flops = 4 * (n + shape[0]), 2 * n
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rtc_case(mx, kernel, plain, make, name, shape, dev, seed, library=None,
             op=None, update=False):
    """One user kernel on one case: held against its plain version, then
    timed (a call, CUDA events) beside it, its device time, the bound and,
    where there is one, the library call, itself held against the plain
    version on copies of the inputs (``op``: the ``nd`` op that computes
    the same function, timed beside them).  ``update``: the output is a new
    value of the first input, so what changed is held too, within
    ``RTC_UPDATE_TOL``."""
    args = make(shape, seed)
    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          "rtc %s %r: output %s %r, plain %s %r" % (
              name, shape, got.dtype, tuple(got.shape), want.dtype,
              tuple(want.shape)))
    check(bool(torch.isfinite(got).all()), "rtc %s %r: non-finite output"
          % (name, shape))
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print("kernel rtc[%s] %r: max abs err %.3g, %.3g of max |plain| (limit "
          "%g)" % (name, shape, err, err / scale, RTC_TOL))
    check(err <= RTC_TOL * scale, "rtc %s %r disagrees with its plain "
          "version: max abs err %.3g, max |plain| %.3g" % (name, shape, err,
                                                           scale))
    rec = {"kernel": name, "case": "x".join(map(str, shape)),
           "max_abs_err": err, "max_abs_plain": scale, "tol": RTC_TOL,
           "library_ms": None}
    if update:
        rec["update_err"] = update_err(got, want, args[0])
        print("  what it changed: max |(out - w) - (plain - w)| %.3g of max "
              "|plain - w| (limit %g)" % (rec["update_err"], RTC_UPDATE_TOL))
        check(rec["update_err"] <= RTC_UPDATE_TOL, "rtc %s %r: the update "
              "differs from its plain version's" % (name, shape))
    if library is not None:
        lib = library(*[a.clone() for a in args])
        torch.cuda.synchronize()
        rec["library_max_abs_err"] = (lib - want).abs().max().item()
        msg = "  library call vs plain: max abs err %.3g (limit %.3g)" % (
            rec["library_max_abs_err"], RTC_TOL * scale)
        if update:
            rec["library_update_err"] = update_err(lib, want, args[0])
            msg += ", what it changed %.3g (limit %g)" % (
                rec["library_update_err"], RTC_UPDATE_TOL)
        print(msg)
        check(rec["library_max_abs_err"] <= RTC_TOL * scale and
              rec.get("library_update_err", 0.0) <= RTC_UPDATE_TOL,
              "rtc %s %r: the library call disagrees with the plain version"
              % (name, shape))
    # rotate over copies of the inputs, 100 MB in all where the case is
    # smaller, so the timed calls do not find them in the L2
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [args] + [make(shape, seed + 100 + i) for i in range(
        min(8, max(1, -(-L2_FLUSH_BYTES // size))) - 1)]
    it = iter(range(10 ** 9))

    def rotate(fn):
        def call():
            return fn(*copies[next(it) % len(copies)])
        return call
    fns = {"ms": rotate(kernel), "plain_ms": rotate(plain)}
    if library is not None:
        fns["library_ms"] = rotate(library)
    if op is not None:
        fns["op_ms"] = rotate(op)
    for key, fn in fns.items():
        rec[key] = time_ms(fn, reps=100)
        rec[key.replace("ms", "device_ms")] = device_ms(fn, reps=50)
    rec["bound_ms"], rec["bound_by"] = rtc_bound(name, shape)
    print("  a call %.4f ms (device %.4f), plain %.4f ms (device %.4f), %s "
          "bound %.4f ms (%s)" % (
              rec["ms"], rec["device_ms"], rec["plain_ms"],
              rec["plain_device_ms"],
              "".join("%s %.4f ms (device %.4f), " % (
                  k, rec[k], rec[k.replace("ms", "device_ms")])
                  for k in ("library_ms", "op_ms") if k in fns),
              rec["bound_ms"], rec["bound_by"]))
    return rec


def rtc_kernel_phase(dev):
    """Both user kernels: compile time (the first build, then a second
    ``CudaRtc`` of the same source finding it built), then every case held
    against its plain version and timed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    out = {"build_s": {}, "cases": []}
    for name, make_kernel in (("sgd_update", sgd_update_kernel),
                              ("row_l2norm", lambda m: row_l2norm_kernel(m,
                                                                        1))):
        k = make_kernel(mx)
        # time a real compile: drop a build an earlier run left
        shutil.rmtree(_build.source_dir(name, k.launcher_source()),
                      ignore_errors=True)
        first = k.build()
        again = make_kernel(mx).build()
        out["build_s"][name] = {"first": first, "cached": again}
        print("rtc %s: nvcc build %.2f s, a second CudaRtc of the same "
              "source %.4f s" % (name, first, again))
        for line in k.ptxas_report():
            print("  " + line)
    sgd = sgd_update_kernel(mx)
    hp = torch.tensor(RTC_HP, device=dev)
    rescale = RTC_HP[2]

    def make_sgd(shape, seed):
        rng = np.random.default_rng(seed)
        w, g = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(dev) for _ in range(2))
        return w, g, hp

    def nd_op(w, g, hp_):
        return mx.nd.sgd_update(mx.nd.NDArray(w), mx.nd.NDArray(g),
                                lr=RTC_HP[0], wd=RTC_HP[1],
                                rescale_grad=rescale).data

    def fused_sgd(w, g, hp_):
        # torch's fused SGD kernel (SGD(fused=True)) in one call, in place:
        # w - lr rescale (g + wd / rescale w) is the same update
        torch._fused_sgd_([w], [g], [], weight_decay=RTC_HP[1] / rescale,
                          momentum=0.0, lr=RTC_HP[0] * rescale,
                          dampening=0.0, nesterov=False, maximize=False,
                          is_first_step=False)
        return w
    for i, shape in enumerate(RTC_SGD_CASES):
        out["cases"].append(rtc_case(mx, sgd, sgd_update_plain, make_sgd,
                                     "sgd_update", shape, dev, 3000 + i,
                                     library=fused_sgd, op=nd_op,
                                     update=True))
    for i, (rows, d) in enumerate(RTC_NORM_CASES):
        norm = row_l2norm_kernel(mx, rows)
        cols = torch.tensor([d], dtype=torch.int64, device=dev)

        def make_norm(shape, seed):
            rng = np.random.default_rng(seed)
            return (torch.from_numpy(rng.standard_normal(shape, np.float32))
                    .to(dev), cols)
        out["cases"].append(rtc_case(
            mx, norm, row_l2norm_plain, make_norm, "row_l2norm", (rows, d),
            dev, 3100 + i,
            library=lambda x, c: torch.linalg.vector_norm(x, dim=1)))
    return out


#: the imperative cell: the symbolic cell's model, weights and batch (12 x
#: 768, 12 heads, FFN 3072, vocab 50304, T 1024, B 8, fp32 with TF32 off,
#: LayerNorm gamma/beta jittered, tokens of seed 3) trained by the
#: imperative loop with a CudaRtc sgd_update per parameter
IMP_STEPS, IMP_PROFILE_STEPS = 5, 3
#: plain SGD on the mean cross-entropy (rescale 1 / (B T)), lr 0.1 and
#: weight decay 1e-4: on the H100 this cell's loss fell at every one of 8
#: steps at lr 0.05 and 0.1, and rose at some step at 0.2, 0.3 and 0.5
IMP_LR, IMP_WD = 0.1, 1e-4
#: kernel run vs the nd.sgd_update rerun: the update rounds alike but for
#: a fused multiply-add, so losses and parameters move apart by rounding
IMP_LOSS_RTOL = 1e-4
#: the same runs held by what they changed: for each parameter, max
#: |(w_kernel - w_0) - (w_plain - w_0)| over max |w_plain - w_0| after the
#: run (on the H100 the worst tensor reads 3.6e-4: the runs' 1.2e-7 gap,
#: an ulp of a weight near 1, over a change of 3.3e-4; a hundredth of an
#: update left out reads 1e-2), and each step's loss change from the
#: first step against the rerun's, over the rerun's whole fall (about
#: 0.17; the H100 reads 0)
IMP_UPDATE_TOL = 1e-3
IMP_LOSS_FALL_TOL = 1e-4


def imperative_run(mx, init, data, label, dims, update, label_, card,
                   first_grads=None):
    """``IMP_STEPS`` steps of the imperative loop from the weights
    ``init`` (name -> tensor), every parameter marked by ``attach_grad``.
    Returns the losses, the step times, the peak memory, the final
    weights and, with ``first_grads``, the first step's gradients (taken
    before its update) in that dict."""
    params = {n: mx.nd.NDArray(t.clone()) for n, t in init.items()}
    for w in params.values():
        w.attach_grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []

    def grab(name, w):
        if first_grads is not None and not losses:
            first_grads[name] = w.grad.data.clone()
        update(name, w)
    for step in range(IMP_STEPS):
        t = time.perf_counter()
        probs = imperative_step(mx, params, data, label, dims, grab)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(nd_loss(mx, probs, label, dims[-1]))
        del probs
        check(math.isfinite(losses[-1]), "%s: loss not finite at step %d"
              % (label_, step))
    stats = {"losses": losses,
             "step_p50_ms": statistics.median(step_s[1:]) * 1e3,
             "first_step_ms": step_s[0] * 1e3,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    print("%s [%s]: losses %s; step p50 %.2f ms (first %.2f ms), peak "
          "device memory %.1f MiB" % (
              label_, card, " ".join("%.5f" % v for v in losses),
              stats["step_p50_ms"], stats["first_step_ms"],
              stats["peak_mib"]))
    return stats, {n: w.data.detach().clone() for n, w in params.items()},\
        params


def imperative_phase(dev, card):
    """The imperative path at full width: ``mx.nd`` forward under
    ``autograd.record()``, ``backward()``, a CudaRtc ``sgd_update`` per
    parameter; held against a passes-off executor's gradients and a rerun
    with ``nd.sgd_update``; step p50, peak memory, a profiled window."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    dims = (SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_T, SYM_VOCAB)
    sym = build_gpt_sym(mx, *dims)
    shapes = {"data": (SYM_B, SYM_T), "softmax_label": (SYM_B, SYM_T)}
    init = sym_params(sym, shapes, 0, dev)
    check(len(init) == 12 * SYM_LAYERS + 4, "%d parameters, want %d"
          % (len(init), 12 * SYM_LAYERS + 4))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (SYM_B, SYM_T + 1))
    feeds = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    # (a) the reference gradients: a passes-off bind on the same weights
    exe = sym_bind(sym, shapes, init, "write", passes="off")
    for k, v in feeds.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward()
    want = {n: g for n, g in sym_grads(exe).items() if n in init}
    del exe
    torch.cuda.empty_cache()
    data = mx.nd.array(feeds["data"], ctx=dev)
    label = mx.nd.array(feeds["softmax_label"], ctx=dev)
    rescale = 1.0 / (SYM_B * SYM_T)
    sgd = sgd_update_kernel(mx)
    sgd.build()
    hp = torch.tensor([IMP_LR, IMP_WD, rescale], device=dev)

    def kernel_update(name, w):
        w[:] = sgd(w, w.grad, hp)

    def plain_update(name, w):
        mx.nd.sgd_update(w, w.grad, out=w, lr=IMP_LR, wd=IMP_WD,
                         rescale_grad=rescale)
    print("imperative: post-LN gpt %d x %d, %d heads, vocab %d, B %d x T %d"
          " on %s; %d parameters marked; SGD lr %g, wd %g, rescale 1/%d"
          % (SYM_LAYERS, SYM_UNITS, SYM_HEADS, SYM_VOCAB, SYM_B, SYM_T, dev,
             len(init), IMP_LR, IMP_WD, SYM_B * SYM_T))
    from mxnet_tpu_torch import rtc
    rtc.launches.clear()
    grads = {}
    run, final, params = imperative_run(mx, init, data, label, dims,
                                        kernel_update, "imperative (rtc "
                                        "sgd_update)", card, grads)
    launches = rtc.launches["sgd_update"]
    out = {"kernel": run, "launches": launches}
    check(launches == len(init) * IMP_STEPS, "%d rtc sgd_update launches "
          "in %d steps, want %d" % (launches, IMP_STEPS,
                                    len(init) * IMP_STEPS))
    out["grads_vs_passes_off"] = grad_rel_err(grads, want)
    del grads, want
    print("imperative: first-step gradients vs the passes-off executor "
          "%.3g (max |diff| / max |g| over the parameters, tol %g); %d rtc "
          "sgd_update launches" % (out["grads_vs_passes_off"], SYM_GRAD_TOL,
                                   launches))
    check(out["grads_vs_passes_off"] <= SYM_GRAD_TOL, "imperative "
          "gradients differ from the passes-off executor's")
    losses = run["losses"]
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "imperative: the loss does not fall: %r" % (losses,))
    # a profiled window of steady steps, not part of the counted run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(IMP_PROFILE_STEPS):
            imperative_step(mx, params, data, label, dims, kernel_update)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    out["profile"] = profile_summary(prof, wall_us, IMP_PROFILE_STEPS,
                                     "profile imperative [%s]: step" % card)
    del params, prof
    torch.cuda.empty_cache()
    # (b) the rerun with the nd.sgd_update op in place of the kernel
    rtc.launches.clear()
    plain, plain_final, plain_params = imperative_run(
        mx, init, data, label, dims, plain_update,
        "imperative (nd.sgd_update)", card)
    del plain_params
    check(rtc.launches["sgd_update"] == 0, "the nd.sgd_update rerun "
          "launched the rtc kernel")
    out["plain"] = plain
    out["loss_vs_plain"] = max(abs(a - b) / abs(b) for a, b in
                               zip(losses, plain["losses"]))
    out["params_vs_plain"] = max((final[n] - plain_final[n]).abs().max()
                                 .item() for n in final)
    upd = {n: update_err(final[n], plain_final[n], init[n]) for n in final}
    out["update_vs_plain_at"] = max(upd, key=upd.get)
    out["update_vs_plain"] = upd[out["update_vs_plain_at"]]
    base, plain_base = losses[0], plain["losses"][0]
    out["loss_fall_vs_plain"] = max(
        abs((a - base) - (b - plain_base))
        for a, b in zip(losses, plain["losses"])) / abs(
            plain["losses"][-1] - plain_base)
    print("imperative: rtc kernel vs nd.sgd_update over %d steps: losses "
          "within %.3g relative (tol %g), parameters within %.3g (tol %g)"
          % (IMP_STEPS, out["loss_vs_plain"], IMP_LOSS_RTOL,
             out["params_vs_plain"], TRAIN_PARAM_TOL))
    check(out["loss_vs_plain"] <= IMP_LOSS_RTOL, "imperative losses differ "
          "from the nd.sgd_update rerun")
    check(out["params_vs_plain"] <= TRAIN_PARAM_TOL, "imperative parameters"
          " differ from the nd.sgd_update rerun")
    print("imperative: what the runs changed: parameters within %.3g of the "
          "largest change a tensor (at %s; tol %g), loss changes within %.3g "
          "of the fall (tol %g)" % (
              out["update_vs_plain"], out["update_vs_plain_at"],
              IMP_UPDATE_TOL, out["loss_fall_vs_plain"], IMP_LOSS_FALL_TOL))
    check(out["update_vs_plain"] <= IMP_UPDATE_TOL, "imperative updates "
          "differ from the nd.sgd_update rerun's")
    check(out["loss_fall_vs_plain"] <= IMP_LOSS_FALL_TOL, "imperative loss "
          "changes differ from the nd.sgd_update rerun's")
    return out


#: the bf16 tensor-core kernels (B1, B2, B3, B7), four instances each (D
#: and DV padded to 64 or 128), by a piece of their mangled names
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc_kernel", "flash_bwd_fused_tc_kernel")
#: the fp32 CUDA-core dk/dv template (B3 and B7 fp32) and q template (B1
#: and B2 fp32); their D, DV <= 64 instances hold 8 keys (8 q rows) a
#: thread and one column group (KR 8 / QR 8, CG 1)
KV_F32_KERNEL = "flash_bwd_kv_f32_kernel"
Q_F32_KERNEL = "flash_q_f32_kernel"
F32_KERNELS = (KV_F32_KERNEL, Q_F32_KERNEL)
F32_D64 = "ILi8ELi1E"
#: the kernels the port redesigned for the card
NEW_KERNELS = TC_KERNELS + F32_KERNELS + ("paged_split_kernel",
                                          "paged_merge_kernel")


# -- the Gluon mx.nd phase: train_gpt.py's own loop ----------------------------

#: steps of train_gpt.py's loop on NDArrays: eager and hybridized, then
#: the fused backward
GLUON_STEPS, GLUON_FUSED_STEPS = 5, 3
#: the NDArray-fed loop against the training phase's raw-tensor loop from
#: the same weights and batch, and hybridized against eager: the same torch
#: ops and kernels in the same order, except that the embedding's gradient
#: adds its rows by atomics (index_add_) in no fixed order, so the runs
#: move apart by rounding only, as a rerun with the plain versions does
GLUON_LOSS_TOL = TRAIN_LOSS_TOL
#: the post-LN stack: 12 user blocks LayerNorm(x + fc2(gelu(fc1(x)))) at
#: gpt2_small's widths on the symbolic phase's 8192 rows
POSTLN_LAYERS, POSTLN_UNITS, POSTLN_HIDDEN, POSTLN_ROWS = 12, 768, 3072, 8192
#: its outputs (unit scale after each LayerNorm) fused vs unfused and B4
#: vs its plain version: the statistics sum in another order
POSTLN_OUT_TOL = 1e-4


def gluon_nd_step(net, trainer, loss_fn, batch, autocast=False):
    """One step of ``train_gpt.py``'s loop as it stands, on the NDArrays
    ``batch`` (tokens, labels, unused): ``with autograd.record(): loss =
    loss_fn(net(x), y).mean()``, ``loss.backward()``,
    ``trainer.step(x.shape[0])``.  Returns the loss as a host float."""
    import mxnet_tpu_torch as mx
    x, y, _ = batch
    with mx.autograd.record():
        loss = loss_fn(net(x), y).mean()
    loss.backward()
    trainer.step(x.shape[0])
    check(isinstance(loss, mx.nd.NDArray), "gluon nd: the loss is a %s"
          % type(loss).__name__)
    return float(loss.asnumpy())


def post_ln_block(mx):
    """A user HybridBlock ``LayerNorm(x + fc2(gelu(fc1(x))))`` whose Dense
    layers take their input size at the first forward."""
    class PostLN(mx.gluon.HybridBlock):
        def __init__(self, units, hidden, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc1 = mx.gluon.nn.Dense(hidden, flatten=False)
                self.fc2 = mx.gluon.nn.Dense(units, flatten=False)
                self.ln = mx.gluon.nn.LayerNorm()

        def hybrid_forward(self, F, x):
            h = self.fc2(F.Activation(self.fc1(x), act_type="gelu"))
            return self.ln(x + h)
    return PostLN


def post_ln_pass(mx, net, x, head, want_b4, label):
    """One recorded forward and a backward with head gradient ``head``:
    ``want_b4`` B4 launches in the forward, none in the backward.  Returns
    the output and the gradients by name."""
    from mxnet_tpu_torch import autograd
    ln_count(reset=True)
    with autograd.record():
        out = net(x)
    torch.cuda.synchronize()
    fwd = ln_count()
    check(fwd == want_b4, "%s: %d B4 launches in a forward, want %d"
          % (label, fwd, want_b4))
    ln_count(reset=True)
    out.backward(head)
    torch.cuda.synchronize()
    check(ln_count() == 0, "%s: B4 launched in the backward" % label)
    check(isinstance(out, mx.nd.NDArray) and
          tuple(out.shape) == (POSTLN_ROWS, POSTLN_UNITS) and
          bool(torch.isfinite(out.data).all()),
          "%s: output %r" % (label, out))
    return out.data.detach().clone(), {
        n: p.grad().data.clone() for n, p in net.collect_params().items()}


def post_ln_phase(mx, dev, card):
    """The post-LN stack hybridized through the symbolic route: 12
    LayerNorm-residual fusions in the pass report, 12 B4 launches in each
    forward and none in a backward; output and gradients against the same
    stack eager (no fusion) and against a rerun with B4's plain version;
    then one Trainer SGD step.  Returns the phase's numbers."""
    from mxnet_tpu_torch import gluon
    gc.collect()
    torch.cuda.empty_cache()
    mx.random.seed(5)
    cls = post_ln_block(mx)
    net = gluon.nn.HybridSequential(prefix="postln_")
    with net.name_scope():
        for _ in range(POSTLN_LAYERS):
            net.add(cls(POSTLN_UNITS, POSTLN_HIDDEN))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rng = np.random.default_rng(6)
    x = mx.nd.array(rng.standard_normal((POSTLN_ROWS, POSTLN_UNITS),
                                        np.float32))
    head = mx.nd.array(rng.standard_normal((POSTLN_ROWS, POSTLN_UNITS),
                                           np.float32))
    # eager: the first forward resolves the deferred in_units; no fusion
    eager = post_ln_pass(mx, net, x, head, 0, "post-LN eager")
    net.hybridize()
    t = time.perf_counter()
    hybrid = post_ln_pass(mx, net, x, head, POSTLN_LAYERS,
                          "post-LN hybridized")
    first_s = time.perf_counter() - t
    launches = POSTLN_LAYERS
    report = net._cached_graph_report
    check(net._cached_op.plan is not None and report is not None,
          "post-LN: the stack did not take the symbolic route")
    fusions = report["rewrites"].get("layer_norm_residual", 0)
    check(fusions == POSTLN_LAYERS, "post-LN: %d LayerNorm-residual "
          "fusions, want %d" % (fusions, POSTLN_LAYERS))
    with plain_ln():
        plain = post_ln_pass(mx, net, x, head, 0, "post-LN plain B4")
    errs = {}
    for name, other in (("eager", eager), ("plain", plain)):
        out_err = (hybrid[0] - other[0]).abs().max().item()
        grad_err = grad_rel_err(hybrid[1], other[1])
        errs[name] = {"out": out_err, "grad": grad_err}
        check(out_err <= POSTLN_OUT_TOL, "post-LN: output differs from the "
              "%s run by %.3g" % (name, out_err))
        check(grad_err <= SYM_GRAD_TOL, "post-LN: gradients differ from "
              "the %s run by %.3g" % (name, grad_err))
    fwd_ms, out = [], None
    for _ in range(3):
        out = None                   # one recorded graph alive at a time
        ln_count(reset=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mx.autograd.record():
            out = net(x)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t) * 1e3)
        check(ln_count() == POSTLN_LAYERS, "post-LN: %d B4 launches in a "
              "timed forward" % ln_count())
        launches += POSTLN_LAYERS
    out.backward(head)
    before = param_copies(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    trainer.step(1)
    moved = sum(bool((a != b).any())
                for a, b in zip(param_copies(net), before))
    check(moved == len(before) and all(bool(torch.isfinite(a).all())
                                       for a in param_copies(net)),
          "post-LN: the SGD step moved %d of %d parameters" %
          (moved, len(before)))
    print("gluon nd post-LN [%s]: %d x HybridBlock LayerNorm(x + fc2(gelu("
          "fc1(x)))) at %d/%d on %d rows, hybridized: %d LayerNorm-residual "
          "fusions (report %s), %d B4 launches a forward and 0 in a "
          "backward; vs eager: output %.3g, gradients %.3g; vs plain B4: "
          "output %.3g, gradients %.3g (tol %g, %g); first hybridized pass "
          "%.1f ms, recorded forward p50 %.2f ms (device memory allocated "
          "%.0f MiB, reserved %.0f MiB); the SGD step moved all %d "
          "parameters" % (card, POSTLN_LAYERS, POSTLN_UNITS, POSTLN_HIDDEN,
                          POSTLN_ROWS, fusions, report["rewrites"],
                          POSTLN_LAYERS, errs["eager"]["out"],
                          errs["eager"]["grad"], errs["plain"]["out"],
                          errs["plain"]["grad"], POSTLN_OUT_TOL,
                          SYM_GRAD_TOL, first_s * 1e3,
                          statistics.median(fwd_ms),
                          torch.cuda.memory_allocated() / 2 ** 20,
                          torch.cuda.memory_reserved() / 2 ** 20, moved))
    return {"fusions": fusions, "report": report["rewrites"], "errs": errs,
            "fwd_p50_ms": statistics.median(fwd_ms), "launches": launches}


def gluon_nd_phase(dev, card, train):
    """gpt2_small trained by train_gpt.py's own Gluon loop on NDArrays:
    eager, its plain-version rerun, hybridized, the fused backward, two
    profile windows; the post-LN stack on the symbolic route; C7 on the
    card.  ``train``: the training phase's numbers, set beside these."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=REPO, prefix=".chip_smoke_")
    try:
        path = os.path.join(tmp, "gpt2_small_seed0.params")
        seeded_gpt2_small(seed=0, dev=dev).save_params(path)
        net = gpt.gpt2_small()
        net.load_params(path, ctx=mx.gpu(0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    params = net.collect_params()
    # wte, wpe, lnf gamma and beta, and 12 a block: 148 for gpt2_small
    check(isinstance(params, mx.gluon.ParameterDict) and
          len(params) == 4 + 12 * len(net.blocks) and all(isinstance(p, mx.gluon.Parameter)
                  for p in params.values()),
          "gluon nd: collect_params() is a %s of %d" %
          (type(params).__name__, len(params)))
    init = param_copies(net)
    xt, yt, _ = train_batch(dev, seed=3, packed=False)
    xb, yb = xt.cpu().numpy(), yt.cpu().numpy()
    x = mx.nd.array(xb, dtype="int32")
    y = mx.nd.array(yb.astype(np.float32))
    batch = (x, y, None)
    with torch.no_grad():
        out = net(x)
    check(isinstance(out, mx.nd.NDArray) and tuple(out.shape) ==
          (TRAIN_B, TRAIN_T, net._vocab), "gluon nd: net(x) gave %r" % out)
    del out
    n_layers = len(net.blocks)
    split_want = (n_layers, n_layers, n_layers, 0)
    fused_want = (n_layers, 0, 0, n_layers)
    print("gluon nd: gpt2_small %d x %d loaded by load_params from a "
          ".params file (%d Parameters), batch %d x %d on %s, set-up %.1f s"
          % (n_layers, net._units, len(params), TRAIN_B, TRAIN_T,
             x.context, time.perf_counter() - t0))
    out = {}
    with flash_bwd_env("split"):
        eager, kept = train_run(net, init, batch, GLUON_STEPS,
                                "gluon nd eager", card, split_want,
                                keep_after=PLAIN_STEPS, step_fn=gluon_nd_step,
                                keep_grads=True)
        check(eager["losses"][-1] < eager["losses"][0],
              "gluon nd eager: the loss did not fall: %r" % eager["losses"])
        ref = train["split"]["losses"][:GLUON_STEPS]
        eager["losses_vs_train"] = max(abs(a - b) for a, b in
                                       zip(eager["losses"], ref))
        check(eager["losses_vs_train"] <= GLUON_LOSS_TOL,
              "gluon nd eager: losses differ from the training phase's by "
              "%.3g" % eager["losses_vs_train"])
        with plain_flash():
            plain, plain_kept = train_run(
                net, init, batch, PLAIN_STEPS, "gluon nd eager (plain "
                "versions)", card, (0, 0, 0, 0), keep_after=PLAIN_STEPS,
                step_fn=gluon_nd_step, keep_grads=True)
        # Adam's first updates are about lr * sign(g) whatever the
        # gradient's size: the gradients themselves are held too
        eager["grads_vs_plain"] = grad_rel_err(eager.pop("grads"),
                                               plain.pop("grads"))
        eager["loss_vs_plain"] = max(abs(a - b) for a, b in
                                     zip(eager["losses"], plain["losses"]))
        eager["params_vs_plain"] = max((a - b).abs().max().item()
                                       for a, b in zip(kept, plain_kept))
        del kept, plain_kept
        check(eager["loss_vs_plain"] <= TRAIN_LOSS_TOL and
              eager["params_vs_plain"] <= TRAIN_PARAM_TOL and
              eager["grads_vs_plain"] <= SYM_GRAD_TOL,
              "gluon nd eager vs plain versions: losses %.3g, parameters "
              "%.3g, first step's gradients %.3g of max |g|"
              % (eager["loss_vs_plain"], eager["params_vs_plain"],
                 eager["grads_vs_plain"]))
        eager["profile"] = train_profile(net, init, batch, card,
                                         "gluon nd eager",
                                         step_fn=gluon_nd_step)
        net.hybridize()
        hybrid, _ = train_run(net, init, batch, GLUON_STEPS,
                              "gluon nd hybridized", card, split_want,
                              step_fn=gluon_nd_step)
        check(net._cached_op is not None and net._cached_op.plan is None,
              "gluon nd: the hybridized stack did not take the traced "
              "route")
        hybrid["losses_vs_eager"] = max(abs(a - b) for a, b in
                                        zip(hybrid["losses"],
                                            eager["losses"]))
        check(hybrid["losses_vs_eager"] <= GLUON_LOSS_TOL,
              "gluon nd hybridized: losses differ from eager by %.3g"
              % hybrid["losses_vs_eager"])
        hybrid["profile"] = train_profile(net, init, batch, card,
                                          "gluon nd hybridized",
                                          step_fn=gluon_nd_step)
        net.hybridize(False)
    with flash_bwd_env("fused"):
        fused, _ = train_run(net, init, batch, GLUON_FUSED_STEPS,
                             "gluon nd fused", card, fused_want,
                             step_fn=gluon_nd_step)
    fused["losses_vs_split"] = max(abs(a - b) for a, b in
                                   zip(fused["losses"], eager["losses"]))
    check(fused["losses_vs_split"] <= FUSED_LOSS_TOL,
          "gluon nd fused: losses differ from the split run by %.3g"
          % fused["losses_vs_split"])
    print("gluon nd: eager vs the training phase's losses %.3g, vs plain "
          "versions: losses %.3g, parameters %.3g, first step's gradients "
          "%.3g of max |g| (tol %g, %g, %g); hybridized vs eager %.3g; "
          "fused vs split %.3g (tol %g)"
          % (eager["losses_vs_train"], eager["loss_vs_plain"],
             eager["params_vs_plain"], eager["grads_vs_plain"],
             TRAIN_LOSS_TOL, TRAIN_PARAM_TOL, SYM_GRAD_TOL,
             hybrid["losses_vs_eager"], fused["losses_vs_split"],
             FUSED_LOSS_TOL))
    t7 = train["split"]
    for label, run in (("eager", eager), ("hybridized", hybrid)):
        print("gluon nd %s vs the training phase (raw tensors) [%s]: step "
              "p50 %.2f vs %.2f ms, %.1f vs %.1f tokens/s, peak %.1f vs %.1f "
              "MiB, device busy %.1f%% vs %.1f%%, %.0f vs %.0f kernels a step"
              % (label, card, run["step_p50_ms"], t7["step_p50_ms"],
                 run["tokens_per_s"], t7["tokens_per_s"], run["peak_mib"],
                 t7["peak_mib"], 100 * run["profile"]["device_busy_share"],
                 100 * t7["profile"]["device_busy_share"],
                 run["profile"]["kernels_per_step"],
                 t7["profile"]["kernels_per_step"]))
    out.update(eager=eager, hybrid=hybrid, fused=fused,
               plain=plain["losses"])
    del net, init
    torch.cuda.empty_cache()
    out["post_ln"] = post_ln_phase(mx, dev, card)
    with mx.cpu():
        z = mx.nd.zeros((2,))
        where = str(mx.current_context())
    check(z.data.device.type == "cpu" and where == "cpu(0)",
          "C7: inside `with mx.cpu():` nd.zeros lives on %s and the "
          "context is %s" % (z.data.device, where))
    print("gluon nd: C7 on the card: inside `with mx.cpu():` nd.zeros is "
          "on %s, current_context() %s" % (z.data.device, where))
    return out


def build_evidence(build):
    """The redesigned kernels' registers and spills (``-Xptxas -v``), the
    tensor-core instructions of B1's, B2's, B3's and B7's bf16 kernels in
    the built library (``cuobjdump --dump-sass``), and the FFMA and
    16-byte shared-load (LDS.128) instructions of each fp32 template
    instance: fails if one of the four instances of any bf16 kernel holds
    no HGMMA, or if a B2, B3 or B7 bf16 instance or an fp32 q (B1, B2) or
    dk/dv (B3, B7) instance at D = DV = 64 (the training path's) spills."""
    spills = {}
    for lib in ("flash_attention", "paged_attention"):
        for fn, info in sorted(build.ptxas_kernels(lib).items()):
            if any(k in fn for k in NEW_KERNELS):
                print("ptxas %s: %d registers, spill stores %d B, spill "
                      "loads %d B" % (fn, info.get("registers", -1),
                                      info.get("spill_stores", -1),
                                      info.get("spill_loads", -1)))
                spills[fn] = (info.get("spill_stores", -1),
                              info.get("spill_loads", -1))
    for name in TC_KERNELS[1:]:
        d64 = [fn for fn in spills if name in fn and "ILi64ELi64E" in fn]
        check(len(d64) == 1 and spills[d64[0]] == (0, 0),
              "%s at D 64: spills %r" % (name, {f: spills[f] for f in d64}))
    for name in F32_KERNELS:
        d64 = [fn for fn in spills if name in fn and F32_D64 in fn]
        check(len(d64) == 2 and all(spills[f] == (0, 0) for f in d64),
              "%s at D 64: spills %r" % (name, {f: spills[f] for f in d64}))
    ffma = build.sass_counts("flash_attention", "FFMA")
    lds = build.sass_counts("flash_attention", r"LDS\.128")
    for fn in sorted(f for f in ffma if any(k in f for k in F32_KERNELS)):
        print("sass %s: %d FFMA, %d LDS.128 (%.1f FFMA a 16-byte shared "
              "load)" % (fn, ffma[fn], lds.get(fn, 0),
                         ffma[fn] / max(lds.get(fn, 0), 1)))
    hgmma = {fn: n for fn, n in
             build.sass_counts("flash_attention", "HGMMA").items()
             if any(k in fn for k in TC_KERNELS)}
    for fn, n in sorted(hgmma.items()):
        print("sass %s: %d HGMMA instructions" % (fn, n))
    for name in TC_KERNELS:
        got = {fn: n for fn, n in hgmma.items() if name in fn}
        check(len(got) == 4 and all(got.values()),
              "%s: a bf16 tensor-core instance holds no HGMMA: %r"
              % (name, got))
    return hgmma


def kernel_entry(name, replaces, cases, launches, main,
                 source="mxnet_tpu_torch/csrc/paged_attention.cu"):
    """One entry of the ``{"kernels": [...]}`` line: the main case's
    numbers and every case."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "device_ms": main.get("device_ms"), "cases": cases}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    t = time.perf_counter()
    built = _build.build()
    print("build: %s in %.1f s" % (sorted(built), time.perf_counter() - t))
    for name in _build.KERNEL_SOURCES:
        for line in _build.ptxas_report(name):
            print("  " + line)
    build_evidence(_build)

    cases = kernel_phase(dev)
    flash = flash_kernel_phase(dev)
    ln_cases = ln_kernel_phase(dev)
    served, engine, prompts, net, off_reqs = slice_phase(dev, card)
    served["profile"] = profile_phase(engine, prompts, card)
    del engine
    spec = spec_phase(net, prompts, served, off_reqs, dev, card)
    int8 = int8_phase(net, prompts, off_reqs, dev, card)
    del net
    torch.cuda.empty_cache()
    train = train_phase(dev, card)
    torch.cuda.empty_cache()
    symbolic = symbolic_phase(dev, card)
    torch.cuda.empty_cache()
    rtc_cases = rtc_kernel_phase(dev)
    imperative = imperative_phase(dev, card)
    torch.cuda.empty_cache()
    module = module_phase(dev, card)
    torch.cuda.empty_cache()
    gluon_nd = gluon_nd_phase(dev, card, train)

    b5 = "mxnet_tpu/ops/pallas/paged_attention.py:73"
    b6 = "mxnet_tpu/ops/pallas/paged_attention.py:231"
    fa_src = "mxnet_tpu_torch/csrc/flash_attention.cu"
    fa_ref = "mxnet_tpu/ops/pallas/flash_attention.py:%d"
    # the main case of each entry is its path's configuration: K_kv = 12,
    # fp32 or int8 pools (B6 at G = 5); flash at gpt2_small's fp32
    # training shape (T = 1024, causal).  Flash launches: B1-B3 from the
    # split training run, B7 from the fused ones (fp32 and bf16)
    flash_launches = dict(train["split"]["launches"])
    flash_launches["flash_bwd_fused"] = sum(
        train[run]["launches"]["flash_bwd_fused"]
        for run in ("fused", "bf16_fused"))
    # and the Gluon mx.nd phase's: eager and hybridized (split), fused
    for run in ("eager", "hybrid", "fused"):
        for name, n in gluon_nd[run]["launches"].items():
            flash_launches[name] += n
    kernels = [
        kernel_entry("paged_attention", b5, cases["paged_attention"],
                     served["launches"], cases["paged_attention"][0]),
        kernel_entry("paged_attention[int8]", b5,
                     cases["paged_attention[int8]"],
                     int8["plain"]["launches"],
                     cases["paged_attention[int8]"][0]),
        kernel_entry("paged_attention_multi", b6,
                     cases["paged_attention_multi"],
                     spec["ngram"]["launches"] + spec["oracle"]["launches"],
                     cases["paged_attention_multi"][0]),
        kernel_entry("paged_attention_multi[int8]", b6,
                     cases["paged_attention_multi[int8]"],
                     int8["spec"]["launches"],
                     cases["paged_attention_multi[int8]"][0])]
    for name, line in (("flash_fwd", 69), ("flash_bwd_dq", 268),
                       ("flash_bwd_dkv", 313), ("flash_bwd_fused", 366)):
        check(flash_launches[name] > 0, "%s never launched on its path"
              % name)
        kernels.append(kernel_entry(name, fa_ref % line, flash[name],
                                    flash_launches[name], flash[name][0],
                                    source=fa_src))
    check(symbolic["launches"] > 0 and module["launches"] > 0 and
          gluon_nd["post_ln"]["launches"] > 0,
          "layer_norm_residual never launched on its path")
    kernels.append(kernel_entry(
        "layer_norm_residual", "mxnet_tpu/ops/pallas/layer_norm.py:56",
        ln_cases, symbolic["launches"] + module["launches"] +
        gluon_nd["post_ln"]["launches"], ln_cases[0],
        source="mxnet_tpu_torch/csrc/layer_norm.cu"))
    # B8: the user's sgd_update, launched by the imperative path; its
    # cases are both user kernels'.  library_ms is torch's fused SGD call;
    # op_ms, beside it, is the nd.sgd_update op's
    check(imperative["launches"] > 0, "rtc sgd_update never launched on "
          "its path")
    entry = kernel_entry("rtc[sgd_update]", "mxnet_tpu/rtc.py:151",
                         rtc_cases["cases"], imperative["launches"],
                         rtc_cases["cases"][0], source="chip_smoke.py")
    entry["op_ms"] = rtc_cases["cases"][0]["op_ms"]
    entry["build_s"] = rtc_cases["build_s"]
    kernels.append(entry)
    print(json.dumps({"slice": served, "spec": spec, "int8": int8,
                      "train": train, "symbolic": symbolic,
                      "imperative": imperative, "module": module,
                      "gluon_nd": gluon_nd}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
