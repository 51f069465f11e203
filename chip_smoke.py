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
7. Serving slice S1b, on the same gpt2_small (8 slots, page 16, max_seq_len
   512): 16 requests, each a shared 96-token system prompt (6 full pages,
   cached first by one request of the system prompt alone) plus a distinct
   8-32-token suffix, 64 new tokens; every odd request sampled
   (temperature 0.8, top-k 50, top-p 0.95, seeds 0-7), the rest greedy.
   (a) Prefix cache on: every request a hit; greedy requests against the
   dense recompute and against a prefix-off run (up to a near tie); every
   sampled request's tokens identical when it runs again alone; B5 launches
   = n_layers a decode step; pages conserved; the prefill tokens the cache
   saved; ``sample_tokens`` against argmax on ``[8, 50304]``; one prefill
   on a miss against on a hit.  (b) The same at spec_k 4: B6 only, greedy
   streams against (a)'s, sampled ones the same alone.  (c) The same on
   int8 pages: every request the same alone; agreement with a prefix-off
   int8 run reported.  (d) The planes on (a)'s engine: deadlines that
   expire one resident (``expired_decode``) and the queue's tail
   (``expired_queue``), one ``cancel``, a ``poll`` loop whose tokens equal
   the request's, ``swap_params`` to the same weights and to a NaN tree
   (rolled back) mid-run with every resident decoding bit for bit as in
   (a), then ``start_drain``: every accepted request completes and a later
   submit comes back ``draining``.
7b. Fleet phase (slice S4a): the same gpt2_small's weights published as
   epoch 1 of a ``CheckpointManager`` prefix; the unchanged
   ``tools/launch.py --serve -n 3`` runs three ``python -m
   mxnet_tpu_torch.serving.worker`` processes on cuda:0 (8 slots, page 16,
   ``max_prefill_len`` 128, ``max_seq_len`` 512), each hot-swapping the
   epoch in through its ``CheckpointSubscriber`` (canary on the card)
   before it publishes its port file.  A ``Router`` over ``fleet_proxies``
   here serves 24 requests (prompts 8-128 tokens, 64 new tokens, every odd
   one sampled at temperature 0.8, top-k 50, top-p 0.95, every even one
   streamed by cursor ``poll``) while slot 1, armed with
   ``serve.replica.sigkill:1`` (``MXTPU_FAULT_SLOTS=1``,
   ``MXTPU_FAULT_ATTEMPTS=0``), dies a real SIGKILL and the launcher's
   replacement is adopted.  Checks: one terminal verdict per request, one
   journaled ``complete`` per rid and a journaled failover retry; every
   stream equal token for token to an in-process ``ServingEngine`` on the
   same weights (a difference is reported with its position and logit
   gap); streamed tokens delivered exactly once; the replacement reports 0
   foreground kernel builds over its health RPC; each live worker's
   request events (``telemetry_pull``) count exactly the tokens of the
   requests it served; ``Router.drain`` exits every worker 80 after its
   page audit; every worker's exit line names cuda:0 with paged kernel
   launches = 12 x its decode steps.  Prints tokens/s, request latency
   p50/p99, kill to first re-decoded token, the ``rpc.call`` p50/p99, a
   worker's decode step p50 (its ``serve_step`` flight records) and each
   worker's peak device memory.
8. Training phase: full-width ``gpt2_small`` with the same seeded weights
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
9. Symbolic phase: ``tools/perf_probe/graph_probe.py``'s post-LN
   transformer rebuilt with the port's ``mx.sym`` at gpt2_small's widths
   (12 x 768, 12 heads, vocab 50304), T = 1024, B = 8, seeded weights,
   bound by ``simple_bind`` with no ctx (the card).  Checks the pass report
   (24 LayerNorm-residual fusions, a folded constant, CSE merges), 24 B4
   launches in every forward and none in a backward; inference and a
   training step (grad_req write), each held against a rerun with B4's
   plain version bound in and against a bind with the pipeline off;
   forward and step p50, peak memory, a profiled forward.
10. Rtc phase: the two user kernels of the imperative path, CUDA C++ source
   strings compiled at run time by ``mx.rtc.CudaRtc`` (``nvcc``; the first
   build timed, then a second ``CudaRtc`` of the same source finding it
   built): ``sgd_update`` (``out = w - lr (rescale g + wd w)``, the
   hyperparameters a device tensor) on the imperative cell's parameter
   shapes and a ragged length, and ``row_l2norm`` (a block a row, a tree
   sum in shared memory) on 8192 x 3072 and (3, 130); each against its
   plain version, then timed beside it, its bound and
   ``torch.linalg.vector_norm`` (the norm) or the ``nd.sgd_update`` op
   (the update, which no single PyTorch call computes).
11. Imperative phase: the symbolic cell's model, weights and batch written
   with ``mx.nd`` (``gpt_nd``), every one of its 148 parameters marked by
   ``attach_grad``; 5 steps of ``autograd.record()`` forward,
   ``backward()`` and a CudaRtc ``sgd_update`` per parameter.  Checks the
   first step's gradients against a passes-off ``simple_bind``, exactly
   148 x 5 kernel launches, a falling loss, and losses and parameters
   against a rerun with ``nd.sgd_update(w, g, out=w)``; step p50, peak
   memory, a profiled window.
12. Module phase: the symbolic cell's model, widths and seeded weights
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
13. Gluon ``mx.nd`` phase: the training phase's seeded ``gpt2_small``
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
14. ResNet phase: ``example/image-classification/train_imagenet.py
   --benchmark 1`` through the port (copies of ``symbols/resnet.py``'s
   ``get_symbol`` and ``common/data.py``'s ``SyntheticDataIter``):
   ResNet-50 v2 at 3 x 224 x 224, 1000 classes, batch 128, trained by
   ``Module(context=mx.gpu(0)).fit`` with ``kvstore=mx.kv.create(
   "device")`` and the example's settings (SGD lr 0.1, momentum 0.9, wd
   1e-4, its lr schedule, Xavier gaussian/in/2, ``accuracy``, a
   ``Speedometer``) on the replayed batch for 12 batches.  Checks the pass
   report (33 ``conv_bn_act``, 1 ``dense_bare``, 437 -> 371 nodes, the
   reference's), the update on the store (forward_backward, then push
   and pull per key), every array on the card, a falling loss on the
   batch; fit step p50, images/s, peak memory, a profiled window (busy
   share, device time by kernel group).  Then fused against unfused
   (``MXTPU_GRAPH_PASSES=off``) binds of the trained weights: a training
   and an eval forward each, their logits held at ``RESNET_FUSED_TOL``.
15. Vision phase: the Gluon zoo's ``squeezenet1_1(classes=10)`` on
   ``tests/fixtures/squeezenet_tiny.params`` against its committed
   logits (the fixture test's tolerance); ``resnet50_v1`` (1000
   classes) at batch 64 x 3 x 224 x 224, eager against hybridized
   (``VISION_HYBRID_TOL``), the CachedOp's 53 ``conv_bn_act`` fusions
   (the reference's count), forward images/s, and 3 ``Trainer`` SGD steps
   (step p50, peak memory).  Neither phase launches a kernel of the port:
   convolution is cuDNN's, through ``F.conv2d``.
16. Training-planes phase (slice S4b): crash-safe training on the card.
   (a) A RecordIO shard set (3 shards x 16 records, each an int32 id and
   1025 seeded tokens) written by ``ShardSetWriter``, read by
   ``StreamLoader(mode="epoch", last_batch="discard")`` at B 8, trains
   the Module phase's symbolic GPT through ``Module(context=mx.gpu(0)).
   fit(loader)`` for 3 epochs (Adam 3e-4) with ``module_checkpoint(...,
   save_optimizer_states=True, keep_last=2)``, ``MXTPU_ASYNC_CKPT=1``,
   the watchdog armed and a heartbeat file.  Checks 24 B4 launches a fit
   step, the cursor in every manifest (epoch mode, 48 consumed), epochs 2
   and 3 left by retention, epoch 3's ``.states`` loaded by a fresh
   Module and a copy with one byte flipped refused, one flight record and
   one ``fit_step`` phase sample a step, the heartbeat's step, the
   ``StepStatsMonitor`` lines, and a ``grad.nan`` step skipped bit for
   bit; prints the fit step p50 beside the Module phase's, ``save()``'s
   return against ``flush_async()``, and the loader's records/s.
   (b) Kill and resume: the same fit for 4 epochs in a worker under the
   unchanged ``tools/launch.py -n 1 --max-restarts 1 --aot-cache-dir
   off``, resuming from ``CheckpointManager.latest()`` (parameters,
   checksummed states, the manifest's cursor, ``begin_epoch``); the
   worker dies of ``worker.lost`` (attempt 0 only) after the third batch
   of epoch 3.  Checks exit 77 and the restart, the resume from epoch 2,
   every counted epoch training each record once (by id), 0 kernel builds
   in the worker, and the final parameters against an uninterrupted run
   here at ``MOD_PARAM_TOL``; prints the kill to the first resumed step.
   (c) The elastic train-to-serve loop (``tests/test_stream_e2e.py`` at
   gpt2_small's width): two Gluon trainers (Trainer SGD, B 4 x T 1024)
   on a follow-mode stream under ``tools/launch.py -n 2 --elastic
   --evict-after 1 --readmit-after 99 --max-restarts 4``, publishing a
   cursor generation and a checkpoint every 2 batches; slot 1 dies one
   batch into generation 2.  This process serves: a ``ServingReplica``
   (8 slots, page 16) hot-swapping every publication, the writer that
   appends 2 shards and seals, and an unchanged re-publication.  Checks
   the membership arc, exactly-once effective coverage, >= 2 swaps that
   pass the canary, bit-identical greedy tokens across the unchanged
   publication, every worker on cuda:0 with B1-B3 12 launches a step and
   no kernel build, and B5 12 launches a decode step; prints the
   publications, swap pause, kill to first resumed step and a worker's
   peak memory.
17. Image-plane phase (slice S4c).  Prints one line probing the
   machine's image libraries (``jpeglib.h``, ``ldconfig``'s libjpeg, PIL,
   ``nvjpeg.h``, CPUs) and builds the native library, which must take the
   decoder the probe calls for (libjpeg where ``jpeglib.h`` compiles,
   else nvJPEG), held against the libjpeg decode of
   ``tests/fixtures/jpeg_decode.npz`` (exactly, or within
   ``NVJPEG_MAX_DIFF`` levels with at most ``NVJPEG_OVER2_SHARE`` of the
   values past 2).  (a) 1536 seeded 256 x 256 images packed by
   ``recordio.pack_img`` (JPEG q95) and read by ``ImageRecordIter`` at
   ``train_imagenet.py``'s settings (``common/data.py``: 3 x 224 x 224,
   batch 128, 4 threads, random crop and mirror, ``--rgb-mean``), which
   must take the native path: images/s decoding alone and into the card.
   (b) The ResNet phase's symbol and ``Module.fit`` for one epoch of 12
   batches from that iterator: finite losses, the fit step p50 beside the
   ResNet phase's in this run, fit's wait for each batch, data-bound or
   not.  (c) ``example/ssd/train.py --data-train synthetic`` at its
   defaults: the shapes ``.rec`` through ``ImageDetRecordIter`` (native,
   mirror), the SSD symbol (``ssd_symbol``) on a Module on the card, 150
   steps of batch 8 at 64 x 64: the example's gate (anchor accuracy above
   0.75), the step p50, finite outputs and kept detections, then a
   profiled window with ``MultiBoxTarget`` and ``MultiBoxDetection``'s
   host and device ms a step.
18. RNN phase (slice S6b), fp32 with TF32 off.  (a) The ``RNN`` op at
   the LM cell's widths (T 40, N 32, input 200, H 200, 2 layers):
   ``lstm``, ``gru``, ``rnn_tanh`` and ``rnn_relu`` one way and ``lstm``
   both ways, forward and backward, held against the same op on the CPU
   and against ``torch._VF.<mode>`` (cuDNN) on the same packed weights
   (which checks the layout and gate order), each with a call's time,
   its device time and its kernel launches beside cuDNN's times.  (b)
   ``example/rnn/lstm_bucketing.py`` at its defaults (hidden and embed
   200, 2 layers, batch 32, buckets 10-40, Adam lr 0.01, wd 1e-5,
   ``kvstore="device"``, 2000 synthetic sentences, vocab 200) through
   ``BucketingModule.fit`` for 5 epochs (the example's 25 cut to 5) from
   numpy-seeded weights: each epoch's perplexity within 2% of the JAX
   package's CPU run (``LM_REF_PPL``), the buckets sharing one set of
   parameters and one optimizer state, the step p50 a bucket, peak
   memory, one profiled step at bucket 40; then the trained fused cell
   against its ``unfuse()``d stack at bucket 40.  (c) A Gluon LM
   (Embedding, ``gluon.rnn.LSTM(200, 2 layers)``, Dense, hybridized)
   trained 20 steps through ``Trainer`` at bptt 35, batch 32: the losses
   finite and falling, then two ``LSTMCell``s unrolled 35 steps equal to
   the layer on its weights.
19. Operators phase (slice S7), fp32 with TF32 off.  (a) AlexNet
   (``symbols/alexnet.py``) through ``train_imagenet.py``'s Module loop at
   its defaults (3 x 224 x 224, 1000 classes, batch 128, ``kv.create(
   "device")``, SGD 0.1 / 0.9 / wd 1e-4, numpy Xavier weights): the first
   3 fit steps (Dropout at 0) each held against the same step on the CPU
   from the card's state, then 12 batches of the example (fit step p50,
   images/s, peak memory), a profile window and LRN's forward and
   backward device ms a step.  (b) ``example/recommenders/matrix_fact.py``
   and ``example/numpy-ops/custom_softmax.py`` at their defaults, each
   epoch's RMSE and accuracy against the JAX package's CPU run
   (``MF_REF_RMSE``, ``CS_REF_ACC``), the example's 0.8 gate, the
   ``Custom`` op's host ms a call beside the step p50.  (c) Every case of
   ``tests/torch_op_cases.py`` (each of the 135 operators of the slice) on
   CUDA tensors against the same call on the CPU, forward and gradients;
   every sampler by its moments over 10^6 draws, its device and seed
   repeatability.  (d) Proposal at Faster R-CNN's test-time RPN (6000 /
   300 / 0.7 over a 38 x 63 map) and the R-FCN res5 deformable 3 x 3
   convolution (512 channels, dilate 2) at full size, each against the
   CPU, with a call's time and its device time.
20. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
   {...}}``.  Any failed check raises before that line (exit code 1).

Float32 matmuls run in full fp32 (TF32 off) so the logits checks compare
like with like.
"""
import contextlib
import gc
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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


def serve(engine, prompts, label, card, samplings=None):
    """Submit every prompt at once (``samplings``: one SamplingParams or
    None per prompt) and drive ``engine.step`` until idle, with both launch
    counts set to 0 just before and read just after.  Checks every request
    finished, the path's launch law and page conservation (no page held
    past the prefix cache's own); returns ``(stats, requests)``."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    n_layers = len(engine._kv)
    samplings = samplings or [None] * len(prompts)
    prefill_tokens0 = engine.prefill_tokens
    steps0 = engine.decode_steps
    spec0 = (engine.spec_draft_tokens, engine.spec_accepted,
             engine.spec_rejected)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches.clear()
    t_start = time.perf_counter()
    reqs = [engine.submit(p, MAX_NEW, sampling=sp)
            for p, sp in zip(prompts, samplings)]
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
    steps = engine.decode_steps - steps0
    single = pa.launches["paged_attention"]
    multi = pa.launches["paged_attention_multi"]
    peak = torch.cuda.max_memory_allocated()
    done = sum(r.done and len(r.tokens) == MAX_NEW for r in reqs)
    print("%s: %d/%d requests served, %d decode steps, %d prefills, %d "
          "paged_attention and %d paged_attention_multi launches"
          % (label, done, N_REQUESTS, steps, engine.prefills, single,
             multi))
    check(done == N_REQUESTS, "%s: only %d of %d requests finished"
          % (label, done, N_REQUESTS))
    # the torch meaning of one program per decode step
    launched, idle = (multi, single) if engine.spec_k else (single, multi)
    check(steps > 0 and launched == n_layers * steps and idle == 0,
          "%s: launches %d (and %d of the other kernel) != %d layers x %d "
          "decode steps" % (label, launched, idle, n_layers, steps))
    engine.alloc.assert_conservation()
    cached = 0 if engine._prefix is None else engine._prefix.cached_pages
    check(engine.alloc.used_pages == cached, "%s: pages leaked" % label)
    tokens = sum(len(r.tokens) for r in reqs)
    p50 = statistics.median(decode_step_s) * 1e3
    print("%s [%s]: %d tokens in %.3f s = %.1f tokens/s; decode step p50 "
          "%.3f ms over %d steps; peak device memory %.1f MiB"
          % (label, card, tokens, wall, tokens / wall, p50,
             len(decode_step_s), peak / 2 ** 20))
    stats = {"launches": launched, "decode_steps": steps,
             "tokens_per_s": tokens / wall, "decode_step_p50_ms": p50,
             "peak_mib": peak / 2 ** 20,
             "kv_bytes_per_token": engine.kv_bytes_per_token,
             "launches_per_decode_step": launched / steps,
             "prefill_tokens": engine.prefill_tokens - prefill_tokens0,
             "prefix_hits": sum(r.prefix_len > 0 for r in reqs)}
    if engine.spec_k:
        drafted, accepted, rejected = (
            n - n0 for n, n0 in zip((engine.spec_draft_tokens,
                                     engine.spec_accepted,
                                     engine.spec_rejected), spec0))
        stats.update(drafted=drafted, accepted=accepted, rejected=rejected)
        print("%s: %d tokens drafted, %d accepted, %d rejected"
              % (label, drafted, accepted, rejected))
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


def agreement(reqs, ref_reqs):
    """The mean share of each request's tokens before its first difference
    from the same request's in ``ref_reqs``, and the requests identical."""
    agree = [next((t for t, (a, b) in enumerate(zip(r.tokens, f.tokens))
                   if a != b), MAX_NEW) / MAX_NEW
             for r, f in zip(reqs, ref_reqs)]
    return statistics.mean(agree), sum(a == 1.0 for a in agree)


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
        stats["fp32_agreement"], stats["fp32_identical_requests"] = \
            agreement(reqs, off_reqs)
        print("%s: greedy agreement with the fp32 stream %.3f (mean "
              "matched prefix), %d of %d requests identical; kv bytes per "
              "token %.1f" % (label, stats["fp32_agreement"],
                              stats["fp32_identical_requests"], N_REQUESTS,
                              eng.kv_bytes_per_token))
        out["spec" if spec_k else "plain"] = stats
        del eng, plain
    return out


# -- serving slice S1b: sampling, the prefix cache and the planes -------------

#: the mixed cell's traffic: a system prompt of 6 full pages shared by every
#: request, a distinct suffix each, every odd request sampled (seeds 0-7)
SYSTEM_LEN, SUFFIX_MIN, SUFFIX_MAX = 96, 8, 32
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
#: planes run, seconds from submit: one resident's deadline passes within a
#: few decode steps; the queue tail's before any of the first residents can
#: finish its 64 tokens
PLANES_RESIDENT_DEADLINE_S, PLANES_QUEUED_DEADLINE_S = 0.1, 0.15
#: planes run: the decode step after which to cancel a resident, swap to the
#: same weights, swap to a NaN tree, and start the drain
PLANES_CANCEL, PLANES_SWAP, PLANES_NAN_SWAP, PLANES_DRAIN = 4, 8, 12, 16


def mixed_traffic(seed=2):
    """The mixed cell's 16 prompts, each one's SamplingParams (None:
    greedy), and the system prompt they share."""
    from mxnet_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(seed)
    system = rng.integers(0, VOCAB, SYSTEM_LEN).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, VOCAB, int(n))
                               .astype(np.int32)])
               for n in rng.integers(SUFFIX_MIN, SUFFIX_MAX + 1,
                                     N_REQUESTS)]
    samplings = [None if i % 2 == 0 else SamplingParams(seed=i // 2,
                                                        **SAMPLED)
                 for i in range(N_REQUESTS)]
    return prompts, samplings, system


def warm_prefix(engine, system):
    """Cache the system prompt's pages, as a deployment serving it holds
    them: one request of the system prompt alone for one token (a prefill,
    no decode step)."""
    engine.generate([system], 1)
    check(engine._prefix.cached_pages == SYSTEM_LEN // PAGE,
          "the system prompt cached %d pages, not %d"
          % (engine._prefix.cached_pages, SYSTEM_LEN // PAGE))


def greedy_only(reqs, samplings):
    return [r for r, sp in zip(reqs, samplings) if sp is None]


def check_alone(engine, prompts, samplings, reqs, label, greedy=False):
    """Each sampled request (each request, with ``greedy``) again, alone on
    ``engine``: the same tokens as in the full batch.  The cache is reset
    to the system prompt's pages before each rerun, so that the rerun hits
    the same prefix (its own pages, cached by the batch run, would give it
    a longer one)."""
    n = 0
    for p, sp, r in zip(prompts, samplings, reqs):
        if sp is None and not greedy:
            continue
        engine.drop_prefix_cache()
        warm_prefix(engine, p[:SYSTEM_LEN])
        alone = engine.submit(p, MAX_NEW, sampling=sp)
        engine.run_until_idle()
        check(alone.prefix_len == r.prefix_len and alone.tokens == r.tokens,
              "%s: request %d (%s) gave other tokens alone"
              % (label, r.rid, sp))
        n += 1
    # sampling is not vacuous: the sampled tokens are not all the argmax
    # of their own logits rows
    argmax = [int(np.argmax(row)) == t for r, sp in zip(reqs, samplings)
              if sp is not None for row, t in zip(r.logits_trace, r.tokens)]
    share = sum(argmax) / len(argmax)
    check(share < 1.0, "%s: every sampled token was the argmax" % label)
    print("%s: %d requests rerun alone gave the same tokens; %.3f of "
          "sampled tokens were their row's argmax" % (label, n, share))
    return {"alone_identical": n, "sampled_argmax_share": share}


def sampling_cost(vocab, dev, card):
    """What ``sample_tokens`` (temperature, per-slot top-k and top-p: one
    sort of the batch's logits, the noise, the draw) adds to a decode step
    over the greedy argmax, at the cell's shape ``[8, vocab]``."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    g = torch.Generator().manual_seed(5)
    logits = (torch.randn(SLOTS, vocab, generator=g) * 3).to(dev)
    temps = torch.full((SLOTS,), SAMPLED["temperature"], device=dev)
    top_ks = torch.full((SLOTS,), SAMPLED["top_k"], dtype=torch.int64,
                        device=dev)
    top_ps = torch.full((SLOTS,), SAMPLED["top_p"], device=dev)
    keys = torch.stack([torch.full((SLOTS,), gpt.sampling_key(0)),
                        torch.arange(SLOTS)], 1).to(dev)

    def sample():
        return gpt.sample_tokens(logits, temps, top_ks, top_ps, keys)

    def greedy():
        return logits.argmax(-1)
    out = {"sample_ms": time_ms(sample, 50),
           "sample_device_ms": device_ms(sample, 20),
           "argmax_ms": time_ms(greedy, 50),
           "argmax_device_ms": device_ms(greedy, 20)}
    out["added_device_ms"] = out["sample_device_ms"] - out["argmax_device_ms"]
    print("sampling [%s]: sample_tokens on [%d, %d] %.4f ms a call (device "
          "%.4f) against argmax %.4f (device %.4f): %.4f ms of device time "
          "added to a decode step"
          % (card, SLOTS, vocab, out["sample_ms"], out["sample_device_ms"],
             out["argmax_ms"], out["argmax_device_ms"],
             out["added_device_ms"]))
    return out


def prefill_savings(engine, prompt, card):
    """One admission's prefill on a miss (dense, the whole prompt) against
    on a hit (the suffix past the cached system prompt), each writing only
    the scratch page: the logits agree, and the hit's time is the saving's
    measure."""
    path, _, _ = engine._prefix.match(prompt)
    n_pre = len(path) * PAGE
    check(n_pre == SYSTEM_LEN, "prefill timing: %d prefix tokens cached, "
          "not %d" % (n_pre, SYSTEM_LEN))
    row = np.zeros(engine.max_pages_per_seq, np.int32)
    row[:len(path)] = [n.page for n in path]

    def miss():
        return engine._prefill(prompt, prompt.size, np.zeros_like(row))

    def hit():
        return engine._prefill(prompt[n_pre:], prompt.size, row,
                               prefix_len=n_pre)
    err = float((miss()[0] - hit()[0]).abs().max())
    check(err <= LOGITS_TOL, "prefix hit's logits differ from the miss's by "
          "%.3g" % err)
    out = {"prompt_tokens": int(prompt.size),
           "hit_prefill_tokens": int(prompt.size) - n_pre,
           "miss_ms": time_ms(miss, 20), "hit_ms": time_ms(hit, 20),
           "hit_vs_miss_logits_err": err}
    print("prefill [%s]: a %d-token prompt %.3f ms on a miss, %.3f ms on a "
          "hit (%d tokens past the cached %d); logits %.3g apart"
          % (card, prompt.size, out["miss_ms"], out["hit_ms"],
             out["hit_prefill_tokens"], n_pre, err))
    return out


def mixed_phase(net, dev, card):
    """(a) The mixed cell, prefix cache on and warm: 16 requests, half
    sampled; greedy requests held against the dense recompute and against
    a prefix-off run of the same traffic, sampled ones against their reruns
    alone; then the cost of sampling and what a hit saves a prefill."""
    prompts, samplings, system = mixed_traffic()
    eng = make_engine(net, dev)
    warm_prefix(eng, system)
    stats, reqs = serve(eng, prompts, "mixed", card, samplings)
    check(stats["prefix_hits"] == N_REQUESTS and
          all(r.prefix_len == SYSTEM_LEN for r in reqs),
          "mixed: not every request hit the cached system prompt")
    greedy = greedy_only(reqs, samplings)
    stats["logits_max_abs_err"] = check_against_dense(net, greedy, dev,
                                                      "mixed greedy")
    off = make_engine(net, dev, prefix_cache=False)
    off_stats, off_reqs = serve(off, prompts, "mixed prefix-off", card,
                                samplings)
    del off
    stats["logits_vs_prefix_off"], stats["diverged_vs_prefix_off"] = \
        compare_streams(greedy, greedy_only(off_reqs, samplings),
                        LOGITS_TOL, "mixed greedy vs prefix-off")
    stats["sampled_same_as_prefix_off"] = sum(
        a.tokens == b.tokens for a, b, sp in zip(reqs, off_reqs, samplings)
        if sp is not None)
    stats["prefix_off"] = off_stats
    stats["prefill_tokens_saved"] = (off_stats["prefill_tokens"]
                                     - stats["prefill_tokens"])
    check(stats["prefill_tokens_saved"] == N_REQUESTS * SYSTEM_LEN,
          "mixed: the cache saved %d prefill tokens, not %d"
          % (stats["prefill_tokens_saved"], N_REQUESTS * SYSTEM_LEN))
    print("mixed: %d of %d prefill tokens saved by the cache; %d of %d "
          "sampled streams also identical with the cache off"
          % (stats["prefill_tokens_saved"], off_stats["prefill_tokens"],
             stats["sampled_same_as_prefix_off"], N_REQUESTS // 2))
    stats.update(check_alone(eng, prompts, samplings, reqs, "mixed"))
    stats["sampling"] = sampling_cost(net._vocab, dev, card)
    stats["prefill"] = prefill_savings(eng, prompts[0], card)
    return stats, eng, prompts, samplings, reqs


def spec_mixed_phase(net, prompts, samplings, mixed_reqs, dev, card):
    """(b) The mixed cell at spec_k 4 (B6 only): greedy streams those of
    the spec-off run up to a near tie, sampled streams the same alone as in
    the batch."""
    eng = make_engine(net, dev, spec_k=SPEC_K)
    warm_prefix(eng, prompts[0][:SYSTEM_LEN])
    stats, reqs = serve(eng, prompts, "mixed spec", card, samplings)
    stats["logits_vs_spec_off"], stats["diverged_vs_spec_off"] = \
        compare_streams(greedy_only(reqs, samplings),
                        greedy_only(mixed_reqs, samplings), LOGITS_TOL,
                        "mixed spec greedy vs spec-off")
    stats.update(check_alone(eng, prompts, samplings, reqs, "mixed spec"))
    return stats


def int8_mixed_phase(net, prompts, samplings, dev, card):
    """(c) The mixed cell on int8 pages: every request, greedy or sampled,
    gives the same tokens alone as in the batch.  A prefix hit's suffix
    attends over the prefix's int8 codes, where a prefix-off prefill
    attends over the exact K/V (the reference's quantized streams are
    pinned to themselves, not to another prefill order), so the greedy
    streams' agreement with a prefix-off int8 run is reported."""
    eng = make_engine(net, dev, kv_dtype="int8")
    warm_prefix(eng, prompts[0][:SYSTEM_LEN])
    stats, reqs = serve(eng, prompts, "mixed int8", card, samplings)
    off = make_engine(net, dev, kv_dtype="int8", prefix_cache=False)
    _, off_reqs = serve(off, prompts, "mixed int8 prefix-off", card,
                        samplings)
    del off
    greedy, greedy_off = (greedy_only(reqs, samplings),
                          greedy_only(off_reqs, samplings))
    stats["prefix_off_agreement"], stats["prefix_off_identical"] = \
        agreement(greedy, greedy_off)
    stats["logits_vs_prefix_off_first_token"] = max(
        float(np.abs(r.logits_trace[0] - f.logits_trace[0]).max())
        for r, f in zip(greedy, greedy_off))
    print("mixed int8: greedy agreement with the prefix-off int8 run %.3f "
          "(mean matched prefix), %d of %d identical; first-token logits "
          "%.3g apart" % (stats["prefix_off_agreement"],
                          stats["prefix_off_identical"], len(greedy),
                          stats["logits_vs_prefix_off_first_token"]))
    stats.update(check_alone(eng, prompts, samplings, reqs, "mixed int8",
                             greedy=True))
    return stats


def planes_phase(engine, net, prompts, samplings, mixed_reqs, card):
    """(d) The planes on the mixed cell's engine (cache warm): deadlines
    that expire one resident and the queue's tail, a cancel, a cursor-
    polled stream, ``swap_params`` to the same weights and to a NaN tree
    mid-run, then the drain.  Residents decode bit-identically to the mixed
    run through both swaps."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import paged_attention as pa
    n_layers = len(engine._kv)
    steps0, swaps0 = engine.decode_steps, engine.swaps
    pa.launches.clear()
    reqs = []
    for i, (p, sp) in enumerate(zip(prompts, samplings)):
        deadline = (PLANES_RESIDENT_DEADLINE_S if i == 2 else
                    PLANES_QUEUED_DEADLINE_S if i >= 12 else None)
        reqs.append(engine.submit(p, MAX_NEW, deadline_s=deadline,
                                  sampling=sp))
    streamed, polled, cursor = reqs[0], [], 0
    out, refused, at_swap, step = {}, None, [], 0
    while not engine.sched.idle:
        engine.step()
        step += 1
        reply = engine.poll(streamed.trace, cursor=cursor)
        polled += reply["tokens"]
        cursor = reply["cursor"]
        if step == PLANES_CANCEL:
            check(engine.cancel(reqs[5].trace)["verdict"] == "cancelled",
                  "planes: cancel gave no cancelled verdict")
        elif step == PLANES_SWAP:
            at_swap = list(engine.sched.running)
            same = engine.params_from_net(net)
            t = time.perf_counter()
            engine.swap_params(same, epoch=1)
            torch.cuda.synchronize()
            out["swap_pause_ms"] = (time.perf_counter() - t) * 1e3
        elif step == PLANES_NAN_SWAP:
            bad = engine.params_from_net(net)
            bad["layers"][0]["fc1_w"][0, 0] = float("nan")
            t = time.perf_counter()
            try:
                engine.swap_params(bad, epoch=2)
                check(False, "planes: a NaN tree was installed")
            except MXNetError as e:
                check("canary" in str(e), "planes: the NaN swap raised %r"
                      % e)
            torch.cuda.synchronize()
            out["rollback_pause_ms"] = (time.perf_counter() - t) * 1e3
        elif step == PLANES_DRAIN:
            engine.start_drain()
            refused = engine.submit(prompts[1], MAX_NEW)
    tail = engine.poll(streamed.trace, cursor=cursor)
    polled += tail["tokens"]
    steps = engine.decode_steps - steps0
    launched = pa.launches["paged_attention"]
    check(launched == n_layers * steps and
          pa.launches["paged_attention_multi"] == 0,
          "planes: %d launches for %d decode steps" % (launched, steps))
    verdicts = [r.verdict for r in reqs]
    check(verdicts[2] == "expired_decode" and
          0 < len(reqs[2].tokens) < MAX_NEW,
          "planes: the resident deadline gave %s after %d tokens"
          % (verdicts[2], len(reqs[2].tokens)))
    check(all(v == "expired_queue" for v in verdicts[12:]) and
          not any(r.tokens for r in reqs[12:]),
          "planes: the queued deadlines gave %s" % verdicts[12:])
    check(verdicts[5] == "cancelled" and 0 < len(reqs[5].tokens) < MAX_NEW,
          "planes: the cancel gave %s" % verdicts[5])
    kept = [i for i in range(N_REQUESTS) if i not in (2, 5) and i < 12]
    check(all(verdicts[i] == "completed" and
              len(reqs[i].tokens) == MAX_NEW for i in kept),
          "planes: an accepted request did not complete: %s" % verdicts)
    check(polled == streamed.tokens and tail["more"] is False and
          tail["verdict"] == "completed",
          "planes: the polled stream differs from the request's tokens")
    check(refused is not None and refused.state == "shed" and
          refused.verdict == "draining",
          "planes: a submit while draining was not refused")
    check(engine.swaps == swaps0 + 1 and engine.swap_rollbacks == 1,
          "planes: swaps %d, rollbacks %d" % (engine.swaps - swaps0,
                                              engine.swap_rollbacks))
    # every resident at the swap decoded bit for bit as in the mixed run,
    # as far as it went (one may expire after the swap)
    for r in at_swap:
        ref = mixed_reqs[r.rid - reqs[0].rid]
        check(r.tokens == ref.tokens[:len(r.tokens)] and all(
            a.tobytes() == b.tobytes()
            for a, b in zip(r.logits_trace, ref.logits_trace)),
            "planes: request %d decoded otherwise across the swaps" % r.rid)
    engine.alloc.assert_conservation()
    check(engine.alloc.used_pages == engine._prefix.cached_pages,
          "planes: pages leaked")
    out.update(launches=launched, decode_steps=steps,
               verdicts={v: verdicts.count(v) for v in set(verdicts)},
               bit_identical_across_swaps=len(at_swap),
               polled_tokens=len(polled), snapshot=engine.snapshot())
    print("planes [%s]: %s; %d residents bit-identical across a same-weights "
          "swap (pause %.3f ms) and a NaN rollback (%.3f ms); %d tokens "
          "polled; drain refused a submit; %d launches for %d decode steps"
          % (card, out["verdicts"], len(at_swap), out["swap_pause_ms"],
             out["rollback_pause_ms"], len(polled), launched, steps))
    return out


def serving_slice_phase(net, dev, card):
    """Slice S1b's phases (a)-(d) on the slice phase's gpt2_small."""
    mixed, eng, prompts, samplings, reqs = mixed_phase(net, dev, card)
    out = {"mixed": mixed,
           "planes": planes_phase(eng, net, prompts, samplings, reqs, card)}
    del eng
    out["spec"] = spec_mixed_phase(net, prompts, samplings, reqs, dev, card)
    out["int8"] = int8_mixed_phase(net, prompts, samplings, dev, card)
    return out


# -- the serving fleet (slice S4a) ---------------------------------------------

#: the fleet phase: three worker processes under the unchanged
#: ``tools/launch.py --serve``, each serving gpt2_small on card 0 with the
#: serving phases' engine shape; slot 1's first incarnation dies a real
#: SIGKILL at its first decode step (``serve.replica.sigkill:1``)
FLEET = dict(slots=3, kill_slot=1, requests=24, max_new=64,
             prompt_min=PROMPT_MIN, prompt_max=PROMPT_MAX, vocab=VOCAB,
             num_slots=SLOTS, page_size=PAGE, max_prefill_len=PROMPT_MAX,
             max_seq_len=MAX_SEQ, device="cuda:0", seed=5,
             boot_timeout=300.0, serve_timeout=300.0)
#: the name the worker's model takes (the first GPTLM of its process)
FLEET_PREFIX = "gptlm0_"


def fleet_traffic(cfg):
    """The fleet's requests: prompts of ``prompt_min``-``prompt_max``
    tokens, every odd one sampled (temperature 0.8, top-k 50, top-p 0.95,
    its own seed), and which ones the client streams (every even one)."""
    from mxnet_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(cfg["seed"])
    prompts = [rng.integers(0, cfg["vocab"], int(n)).astype(np.int32)
               for n in rng.integers(cfg["prompt_min"],
                                     cfg["prompt_max"] + 1,
                                     cfg["requests"])]
    samplings = [None if i % 2 == 0 else
                 SamplingParams(seed=100 + i, **SAMPLED)
                 for i in range(cfg["requests"])]
    streamed = [i % 2 == 0 for i in range(cfg["requests"])]
    return prompts, samplings, streamed


def fleet_worker_args(net, cfg, prefix):
    """The worker's command line for ``net``'s architecture."""
    return ["--device", cfg["device"], "--vocab", str(net._vocab),
            "--n-layer", str(len(net.blocks)),
            "--d-model", str(net._units), "--n-head", str(net.num_heads),
            "--max-len", str(net._max_len),
            "--num-slots", str(cfg["num_slots"]),
            "--page-size", str(cfg["page_size"]),
            "--max-prefill-len", str(cfg["max_prefill_len"]),
            "--max-seq-len", str(cfg["max_seq_len"]),
            "--checkpoint-prefix", prefix,
            "--max-seconds", str(int(cfg["boot_timeout"]
                                     + 2 * cfg["serve_timeout"]))]


def publish_checkpoint(net, prefix):
    """Publish ``net``'s weights as epoch 1 under the names of the
    workers' model (a trainer's publication to its serving fleet)."""
    from mxnet_tpu_torch import CheckpointManager
    arrays = {}
    for name, p in net.collect_params().items():
        rest = name.split("_", 1)[1]          # drop this net's gptlmN_
        arrays[FLEET_PREFIX + rest] = p.data().asnumpy()
    CheckpointManager(prefix).save(1, arrays, None)


EXIT_MARK = "serve_worker: exit "


def exit_lines(log_path):
    """Every worker's ``serve_worker: exit {...}`` document in the
    launcher's log.  The workers and the launcher share that log, so a
    document may follow another process's text on its line: each is
    found by its mark and decoded up to its own end."""
    out, decoder = [], json.JSONDecoder()
    with open(log_path, errors="replace") as f:
        for line in f:
            at = line.find(EXIT_MARK)
            while at >= 0:
                doc, end = decoder.raw_decode(line, at + len(EXIT_MARK))
                out.append(doc)
                at = line.find(EXIT_MARK, end)
    return out


def pull_all(proxy):
    """Every request event and flight record a worker still holds, by
    telemetry pulls from the start until it declares no more."""
    events, steps, cursor = [], [], None
    for _ in range(64):
        reply = proxy.pull_telemetry(cursor=cursor, timeout_s=10.0)
        events += reply["line"].get("req_events", [])
        steps += reply["line"].get("last_steps", [])
        cursor = reply["cursor"]
        if not reply.get("more"):
            break
    return events, steps


def first_difference(got, want):
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return j
    return min(len(got), len(want))


def stop_launcher(launcher, run_dir, timeout=120):
    """The operator's stop: ``serve-stop`` makes the launcher drain every
    live worker over the drain RPC; anything left is killed."""
    with open(os.path.join(run_dir, "serve-stop"), "w") as f:
        f.write("stop\n")
    try:
        return launcher.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(launcher.pid, 9)
        launcher.wait(timeout=30)
        return None


def fleet_phase(net, dev, card, cfg=None, workdir=None):
    """Slice S4a: the out-of-process fleet.  ``net``'s weights are
    published as epoch 1 of a ``CheckpointManager`` prefix; three
    ``python -m mxnet_tpu_torch.serving.worker`` processes under
    ``tools/launch.py --serve -n 3`` hot-swap them in at boot; a Router
    over ``fleet_proxies`` in this process serves the traffic of
    :func:`fleet_traffic` while slot 1 dies by SIGKILL and the launcher's
    replacement is adopted.  Checks exactly-once verdicts and a journaled
    failover, every stream equal to an in-process ``ServingEngine``'s on
    the same weights, exactly-once streaming, a warm replacement, request
    events whose token counts equal the tokens delivered, drains exiting
    80 with their pages conserved, and every worker's exit line (device,
    paged kernel launches = n_layers x decode steps)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving.rpc import port_file_path, wait_port_file
    cfg = dict(FLEET, **(cfg or {}))
    n_layers = len(net.blocks)
    on_card = cfg["device"].startswith("cuda")
    work = tempfile.mkdtemp(prefix="fleet-", dir=workdir)
    run_dir = os.path.join(work, "run")
    os.makedirs(run_dir)
    prefix = os.path.join(work, "ckpt", "gpt")
    os.makedirs(os.path.dirname(prefix))
    publish_checkpoint(net, prefix)
    prompts, samplings, streamed = fleet_traffic(cfg)
    slots = list(range(cfg["slots"]))

    env = dict(os.environ)
    env.update({"MXTPU_FAULT": "serve.replica.sigkill:1",
                "MXTPU_FAULT_SLOTS": str(cfg["kill_slot"]),
                "MXTPU_FAULT_ATTEMPTS": "0",
                "PYTHONPATH": os.pathsep.join(
                    [REPO] + [p for p in [env.get("PYTHONPATH")] if p])})
    log_path = os.path.join(work, "launch.log")
    # every process is bounded: the launcher by timeout -k, each worker
    # by its --max-seconds
    limit = cfg["boot_timeout"] + 2 * cfg["serve_timeout"] + 120
    cmd = ["timeout", "-k", "10", str(int(limit)), sys.executable,
           os.path.join(REPO, "tools", "launch.py"),
           "--serve", "-n", str(cfg["slots"]), "--run-dir", run_dir,
           "--max-restarts", "2", "--restart-backoff", "0.2",
           "--telemetry-interval", "1", "--",
           sys.executable, "-m", "mxnet_tpu_torch.serving.worker"] + \
        fleet_worker_args(net, cfg, prefix)
    telemetry.reset()
    t_boot = time.perf_counter()
    with open(log_path, "w") as log:
        launcher = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
    try:
        out = fleet_serve(cfg, run_dir, slots, prompts, samplings,
                          streamed, t_boot, launcher, card)
        # every worker drains over the Router: exit 80 once its pages are
        # all back (the replica's audit), then the launcher respawns the
        # slot; the replacements are stopped by the operator's serve-stop
        drained = out.pop("_router").drain()
        out["drains"] = [[str(r), int(rc)] for r, rc in drained]
        for slot in slots:
            wait_port_file(port_file_path(run_dir, slot),
                           timeout=cfg["boot_timeout"],
                           min_attempt=out["_attempts"][slot] + 1)
    finally:
        rc = stop_launcher(launcher, run_dir)
    out.pop("_attempts")
    check(rc == 0, "tools/launch.py --serve exited %s" % rc)
    check(len(drained) == cfg["slots"] and
          all(code == 80 for _, code in drained),
          "fleet drain: %s" % drained)
    with open(os.path.join(run_dir, "membership.json")) as f:
        transitions = json.load(f)["transitions"]
    drains = [t for t in transitions if t["event"] == "drain"]
    check(sorted(t["slot"] for t in drains) == slots and
          all(t["rc"] == 80 for t in drains),
          "the launcher saw these drains: %s" % drains)
    kills = [t for t in transitions if t["event"] == "failure"]
    check([(t["slot"], t["rc"]) for t in kills] == [(cfg["kill_slot"], -9)],
          "failures other than the drill: %s" % kills)
    exits = exit_lines(log_path)
    for doc in exits:
        check(doc["device"] == cfg["device"],
              "worker on %s, not %s" % (doc["device"], cfg["device"]))
        check(doc["paged_attention_launches"] ==
              (n_layers * doc["decode_steps"] if on_card else 0),
              "worker slot %s attempt %s: %d paged launches for %d decode "
              "steps" % (doc["slot"], doc["attempt"],
                         doc["paged_attention_launches"],
                         doc["decode_steps"]))
    check(sum(d["rc"] == 80 for d in exits) >= cfg["slots"],
          "fewer than %d workers exited 80: %s" % (cfg["slots"], exits))
    out["exits"] = exits
    out["launches"] = sum(d["paged_attention_launches"] for d in exits)
    out["decode_steps"] = sum(d["decode_steps"] for d in exits)
    out["wall_s"] = round(time.perf_counter() - t_boot, 3)
    print("fleet: %d workers exited (%s), %d decode steps, %d paged "
          "launches, %.1f s in all; %s"
          % (len(exits), sorted(d["rc"] for d in exits),
             out["decode_steps"], out["launches"], out["wall_s"], card))
    shutil.rmtree(work, ignore_errors=True)
    return out


def fleet_serve(cfg, run_dir, slots, prompts, samplings, streamed, t_boot,
                launcher, card):
    """The Router's part of :func:`fleet_phase`, up to the drain."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import Router
    from mxnet_tpu_torch.serving.rpc import fleet_proxies
    proxies = fleet_proxies(run_dir, slots, timeout=cfg["boot_timeout"])
    print("fleet: %d workers up in %.1f s" % (len(proxies),
                                             time.perf_counter() - t_boot))
    replaced = []

    def spawn():
        # the launcher respawns the dead slot: adopt its successor
        for p in proxies:
            if not p.alive and p not in replaced:
                replaced.append(p)
                fresh = p.successor(timeout=cfg["boot_timeout"])
                proxies.append(fresh)
                return fresh
        raise RuntimeError("spawn() called with no dead proxy")

    journal = os.path.join(run_dir, "router-journal.jsonl")
    rt = Router(list(proxies), spawn=spawn, max_retries=2,
                journal_path=journal)
    t0 = time.perf_counter()
    rrs = [rt.submit(p, cfg["max_new"], sampling=s)
           for p, s in zip(prompts, samplings)]
    got = {i: [] for i, s in enumerate(streamed) if s}
    cursors = dict.fromkeys(got, 0)
    done_t = {}
    deadline = time.time() + cfg["serve_timeout"]
    while len(done_t) < len(rrs) and time.time() < deadline:
        check(launcher.poll() is None, "the launcher exited %s"
              % launcher.returncode)
        rt.step()
        for i in got:
            reply = rt.poll(rrs[i].rid, cursors[i])
            if reply is not None and reply["tokens"]:
                check(reply["cursor"] == cursors[i] + len(reply["tokens"]),
                      "poll cursor of request %d jumped" % i)
                got[i] += reply["tokens"]
                cursors[i] = reply["cursor"]
        now = time.perf_counter()
        for i, rr in enumerate(rrs):
            if rr.done and i not in done_t:
                done_t[i] = now - t0
    wall = time.perf_counter() - t0
    states = [(rr.state, rr.verdict, rr.replica_id) for rr in rrs]
    check(all(rr.state == "completed" for rr in rrs),
          "fleet requests not all completed: %s" % states)
    for i in got:                      # the rest of each stream
        while True:
            reply = rt.poll(rrs[i].rid, cursors[i])
            got[i] += reply["tokens"]
            cursors[i] = reply["cursor"]
            if not reply["more"]:
                break
        check(got[i] == rrs[i].tokens,
              "streamed request %d: %d tokens polled, %d completed, first "
              "difference at %d" % (i, len(got[i]), len(rrs[i].tokens),
                                    first_difference(got[i],
                                                     rrs[i].tokens)))
    check(rt.failovers == 1, "%d failovers (the drill kills one replica)"
          % rt.failovers)
    check(replaced and replaced[0].replica_id == "slot%d" % cfg["kill_slot"],
          "the failed-over replica: %s"
          % [p.replica_id for p in replaced])
    completes, retries = {}, []
    with open(journal) as f:
        for line in f:
            doc = json.loads(line)
            if doc["event"] == "complete":
                completes[doc["rid"]] = completes.get(doc["rid"], 0) + 1
            elif doc["event"] == "retry":
                retries.append(doc)
    check(sorted(completes) == sorted(rr.rid for rr in rrs) and
          all(n == 1 for n in completes.values()),
          "journal complete lines per rid: %s" % completes)
    check(retries and all(d.get("from_replica") == "slot%d"
                          % cfg["kill_slot"] for d in retries),
          "journaled failover retries: %s" % retries)
    victims = [rr for rr in rrs if rr.retries > 0]

    live = [p for p in proxies if p.alive]
    successor = proxies[-1]
    health = {p.replica_id: p.health() for p in live}
    h = health[successor.replica_id]
    check(h.get("reachable") and h["remote"].get("serve_compiles") == 0 and
          h["remote"]["health"]["device"]["kernel_builds"] == 0,
          "the replacement built kernels in the foreground: %s"
          % h.get("remote"))
    check(h["remote"]["health"]["engine"]["decode_steps"] > 0,
          "the replacement never served")
    # request events pulled over RPC: each worker's token events for a
    # trace equal the tokens its request delivered
    by_trace = {rr.trace: rr for rr in rrs}
    step_ms, first_redecode = [], None
    for p in live:
        events, steps = pull_all(p)
        counts = {}
        for e in events:
            if e["event"] == "token":
                counts[e["trace"]] = counts.get(e["trace"], 0) + 1
            elif e["event"] == "tokens":
                for tr in e["args"].get("traces") or ():
                    counts[tr] = counts.get(tr, 0) + 1
        check(sum(counts.values()) ==
              telemetry.count_token_events(events),
              "token-event accounting differs from count_token_events")
        for tr, n in counts.items():
            rr = by_trace.get(tr)
            check(rr is not None and rr.replica_id == p.replica_id and
                  n == len(rr.tokens),
                  "worker %s: %d token events for trace %s (%s tokens "
                  "delivered by %s)" % (p.replica_id, n, tr,
                                        None if rr is None else
                                        len(rr.tokens),
                                        None if rr is None else
                                        rr.replica_id))
        mine = [rr for rr in rrs if rr.replica_id == p.replica_id]
        check(sorted(counts) == sorted(rr.trace for rr in mine),
              "worker %s's events cover %d traces, it served %d"
              % (p.replica_id, len(counts), len(mine)))
        step_ms += [1e3 * (s["dispatch_s"] + (s["sync_s"] or 0.0))
                    for s in steps if s["where"] == "serve_step"]
        for e in events:
            if e["event"] == "token" and e["trace"] in \
                    {rr.trace for rr in victims}:
                t = e["t"]
                first_redecode = t if first_redecode is None else \
                    min(first_redecode, t)
    with open(os.path.join(run_dir, "membership.json")) as f:
        kill_t = [t["time"] for t in json.load(f)["transitions"]
                  if t["event"] == "failure"]
    tokens = sum(len(rr.tokens) for rr in rrs)
    lat = sorted(done_t.values())
    attempts = {}
    for s in slots:
        q = next(q for q in live
                 if q.replica_id.split("+")[0] == "slot%d" % s)
        attempts[s] = int(q.incarnation[1])
    rpc = telemetry.histogram("rpc.call")
    out = {
        "requests": len(rrs), "tokens": tokens, "wall_s": round(wall, 3),
        "tokens_per_s": round(tokens / wall, 1),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 4),
        "latency_p99_s": round(float(np.percentile(lat, 99)), 4),
        "kill_to_first_redecoded_token_s": (
            None if first_redecode is None or not kill_t
            else round(first_redecode - kill_t[0], 4)),
        "rpc_call_p50_ms": round(1e3 * rpc.percentile(0.5), 4),
        "rpc_call_p99_ms": round(1e3 * rpc.percentile(0.99), 4),
        "rpc_calls": telemetry.counter("rpc.calls").value,
        "worker_decode_step_p50_ms": (
            round(float(np.median(step_ms)), 4) if step_ms else None),
        "suspicions": telemetry.counter("rpc.suspicions").value,
        "victims": len(victims), "failovers": rt.failovers,
        "retries": len(retries), "streamed": len(got),
        "peak_memory_mib": {
            rid: round(doc["remote"]["health"]["device"]
                       .get("peak_memory_bytes", 0) / 2 ** 20, 1)
            for rid, doc in health.items()},
        "tokens_by_replica": {p.replica_id: sum(
            len(rr.tokens) for rr in rrs if rr.replica_id == p.replica_id)
            for p in live},
        "_router": rt,
        "_attempts": attempts,
        "tokens_list": [list(rr.tokens) for rr in rrs],
    }
    print("fleet: %d requests (%d streamed, %d failed over), %d tokens in "
          "%.3f s: %.1f tokens/s, latency p50 %.4f s p99 %.4f s, kill -> "
          "first re-decoded token %s s, rpc.call p50 %.4f ms p99 %.4f ms "
          "(%d calls, %d suspicions), worker decode step p50 %s ms, peak "
          "memory %s MiB; %s"
          % (len(rrs), len(got), len(victims), tokens, wall,
             out["tokens_per_s"], out["latency_p50_s"],
             out["latency_p99_s"], out["kill_to_first_redecoded_token_s"],
             out["rpc_call_p50_ms"], out["rpc_call_p99_ms"],
             out["rpc_calls"], out["suspicions"],
             out["worker_decode_step_p50_ms"], out["peak_memory_mib"],
             card))
    return out


def fleet_reference(net, dev, cfg, out, card):
    """Every fleet stream against an in-process ``ServingEngine`` on the
    same weights and requests: token for token.  A difference is
    reported with its first position and the logit gap there."""
    from mxnet_tpu_torch.serving import ServingEngine
    cfg = dict(FLEET, **(cfg or {}))
    prompts, samplings, _ = fleet_traffic(cfg)
    eng = ServingEngine(net, num_slots=cfg["num_slots"],
                        page_size=cfg["page_size"],
                        max_prefill_len=cfg["max_prefill_len"],
                        max_seq_len=cfg["max_seq_len"], record_logits=True,
                        device=dev)
    reqs = [eng.submit(p, cfg["max_new"], sampling=s)
            for p, s in zip(prompts, samplings)]
    eng.run_until_idle()
    bad = []
    for i, (r, toks) in enumerate(zip(reqs, out["tokens_list"])):
        if list(r.tokens) != toks:
            j = first_difference(toks, r.tokens)
            row = r.logits_trace[j] if j < len(r.logits_trace) else None
            gap = None if row is None or j >= len(toks) else \
                float(row[r.tokens[j]] - row[toks[j]])
            bad.append((i, j, gap))
    print("fleet: %d of %d streams equal to the in-process engine's%s; %s"
          % (len(reqs) - len(bad), len(reqs),
             "" if not bad else " (request, first position, logit gap: "
             "%s)" % bad, card))
    check(not bad, "fleet streams differ from the in-process engine's: %s"
          % bad)
    return len(reqs) - len(bad)


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


# -- the ResNet path: train_imagenet.py through Module.fit and a KVStore ----

def resnet_unit(mx, data, num_filter, stride, dim_match, name,
                bottle_neck=True, bn_mom=0.9):
    """``example/image-classification/symbols/resnet.py``'s
    ``residual_unit`` (a copy: the port does not import the example), the
    pre-activation (v2) block, built with ``mx``."""
    def bn(x, suffix):
        return mx.sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5,
                                momentum=bn_mom, name=name + suffix)

    def relu(x, suffix):
        return mx.sym.Activation(data=x, act_type="relu", name=name + suffix)

    def conv(x, nf, kernel, stride_, pad, suffix):
        return mx.sym.Convolution(data=x, num_filter=nf, kernel=kernel,
                                  stride=stride_, pad=pad, no_bias=True,
                                  name=name + suffix)

    act1 = relu(bn(data, "_bn1"), "_relu1")
    if bottle_neck:
        conv1 = conv(act1, num_filter // 4, (1, 1), (1, 1), (0, 0), "_conv1")
        act2 = relu(bn(conv1, "_bn2"), "_relu2")
        conv2 = conv(act2, num_filter // 4, (3, 3), stride, (1, 1),
                     "_conv2")
        act3 = relu(bn(conv2, "_bn3"), "_relu3")
        body = conv(act3, num_filter, (1, 1), (1, 1), (0, 0), "_conv3")
    else:
        conv1 = conv(act1, num_filter, (3, 3), stride, (1, 1), "_conv1")
        act2 = relu(bn(conv1, "_bn2"), "_relu2")
        body = conv(act2, num_filter, (3, 3), (1, 1), (1, 1), "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = mx.sym.Convolution(data=act1, num_filter=num_filter,
                                      kernel=(1, 1), stride=stride,
                                      no_bias=True, name=name + "_sc")
    return body + shortcut


def resnet_symbol(mx, num_classes, num_layers, image_shape):
    """``symbols/resnet.py``'s ``get_symbol`` (a copy, built with ``mx``):
    ImageNet depths 18-269 and the CIFAR 6n+2 form (height <= 28)."""
    image_shape = [int(x) for x in image_shape.split(",")]
    nchannel, height, _ = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit, bottle_neck = [(num_layers - 2) // 9], True
            filter_list = [16, 64, 128, 256]
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit, bottle_neck = [(num_layers - 2) // 6], False
            filter_list = [16, 16, 32, 64]
        else:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = per_unit * num_stages
    else:
        bottle_neck = num_layers >= 50
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
            else [64, 64, 128, 256, 512]
        num_stages = 4
        units = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                 101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                 200: [3, 24, 36, 3], 269: [3, 30, 48, 8]}[num_layers]
    data = mx.sym.identity(data=mx.sym.Variable(name="data"), name="id")
    body = mx.sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                            momentum=0.9, name="bn_data")
    if height <= 32:
        body = mx.sym.Convolution(data=body, num_filter=filter_list[0],
                                  kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                  no_bias=True, name="conv0")
    else:
        body = mx.sym.Convolution(data=body, num_filter=filter_list[0],
                                  kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                  no_bias=True, name="conv0")
        body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                momentum=0.9, name="bn0")
        body = mx.sym.Activation(data=body, act_type="relu", name="relu0")
        body = mx.sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = resnet_unit(mx, body, filter_list[i + 1], stride, False,
                           "stage%d_unit%d" % (i + 1, 1), bottle_neck)
        for j in range(units[i] - 1):
            body = resnet_unit(mx, body, filter_list[i + 1], (1, 1), True,
                               "stage%d_unit%d" % (i + 1, j + 2),
                               bottle_neck)
    bn1 = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                           momentum=0.9, name="bn1")
    relu1 = mx.sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = mx.sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="pool1")
    fc1 = mx.sym.FullyConnected(data=mx.sym.Flatten(data=pool1),
                                num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(data=fc1, name="softmax")


def synthetic_data_iter(mx, num_classes, data_shape, max_iter):
    """``common/data.py``'s ``SyntheticDataIter`` (a copy): one fixed batch
    from ``RandomState(0)`` (labels, then uniform(-1, 1) pixels), replayed
    ``max_iter`` times; the host arrays go to the device at each step."""
    rng = np.random.RandomState(0)
    label = rng.randint(0, num_classes, [data_shape[0]])
    data = rng.uniform(-1, 1, data_shape).astype(np.float32)
    host = mx.cpu()
    batch = mx.io.DataBatch(
        data=[mx.nd.array(data, ctx=host)],
        label=[mx.nd.array(label.astype(np.float32), ctx=host)], pad=0,
        provide_data=[mx.io.DataDesc("data", data_shape)],
        provide_label=[mx.io.DataDesc("softmax_label", (data_shape[0],))])

    class SyntheticDataIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(data_shape[0])
            self.cur_iter = 0
            self.provide_data = batch.provide_data
            self.provide_label = batch.provide_label

        def next(self):
            self.cur_iter += 1
            if self.cur_iter > max_iter:
                raise StopIteration
            return batch

        def reset(self):
            self.cur_iter = 0

    return SyntheticDataIter()


#: the ResNet cell: train_imagenet.py --benchmark 1 with the example's
#: defaults (resnet 50, 3 x 224 x 224, 1000 classes, batch 128, --kv-store
#: device, SGD lr 0.1 momentum 0.9 wd 1e-4, Xavier gaussian/in/2,
#: accuracy, a Speedometer), fp32 with TF32 off, for RESNET_BATCHES
#: replays of SyntheticDataIter's one batch
RESNET_LAYERS, RESNET_SHAPE, RESNET_CLASSES = 50, "3,224,224", 1000
RESNET_B, RESNET_BATCHES, RESNET_PROFILE_STEPS = 128, 12, 3
#: train_imagenet.py's --num-examples and --lr-step-epochs 30,60
IMAGENET_EXAMPLES, LR_STEP_EPOCHS = 1281167, (30, 60)
#: the JAX package's pass report on the same symbol (tests/
#: test_torch_conv.py holds the port's report equal to it on the CPU)
RESNET_REPORT = {"nodes_before": 437, "nodes_after": 371,
                 "rewrites": {"conv_bn_act": 33, "dense_bare": 1,
                              "removed": 66}}
#: fused against unfused (MXTPU_GRAPH_PASSES=off) binds of the trained
#: weights on the replayed batch, compared on the logits (``fc1``'s
#: output: the softmax saturates in eval, where moving statistics 15
#: updates old normalize): max |a - b| over max |b|.  The training region
#: is the same convolution and BatchNorm calls in both; the eval fold
#: scales the weights before each of the 33 fused convolutions (fp32,
#: TF32 off) where BatchNorm scaled after it, a rounding difference (the
#: Gluon resnet50_v1's eager against hybridized logits: 7.9e-7 of their
#: max on an NVIDIA H100); a wrong fold or moving statistic moves logits
#: by a share of themselves
RESNET_FUSED_TOL = 1e-4


def imagenet_lr_scheduler(mx):
    """fit.py's ``_get_lr_scheduler`` at train_imagenet.py's defaults: lr
    times 0.1 at epochs 30 and 60 (steps of 10009 batches)."""
    epoch_size = IMAGENET_EXAMPLES // RESNET_B
    return mx.lr_scheduler.MultiFactorScheduler(
        step=[epoch_size * e for e in LR_STEP_EPOCHS], factor=0.1)


def replay_loss(mx, mod, label):
    """The cross entropy of the Module's last training outputs (the
    softmax probabilities) against ``label``, on the device."""
    prob = mod.get_outputs()[0].data
    y = label.data.to(prob.device).long()
    return float(-torch.log(prob[torch.arange(prob.shape[0],
                                              device=prob.device), y]
                            .clamp_min(1e-30)).mean())


def kernel_launches():
    """The launch counts of every kernel of the port (B1-B3, B7, B4, B5,
    B6 and the CudaRtc user kernels), summed."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import paged_attention as pa
    return sum(flash_counts()) + ln_count() + sum(pa.launches.values()) + \
        sum(rtc.launches.values())


def reset_kernel_launches():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import paged_attention as pa
    flash_counts(reset=True)
    ln_count(reset=True)
    pa.launches.clear()
    rtc.launches.clear()


def resnet_phase(dev, card):
    """``train_imagenet.py --benchmark 1``'s path through the port:
    ``symbols/resnet.py``'s ResNet-50 v2 (``resnet_symbol``) trained by
    ``Module.fit`` with ``mx.kv.create("device")`` (the fit step: forward,
    backward, then push and pull per key) on ``SyntheticDataIter``'s
    replayed batch; then fused against unfused binds on the card."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    shape = (RESNET_B,) + tuple(int(x) for x in RESNET_SHAPE.split(","))
    sym = resnet_symbol(mx, RESNET_CLASSES, RESNET_LAYERS, RESNET_SHAPE)
    _, report = mx.graph.optimize(sym)
    out = {"report": {k: report[k] for k in RESNET_REPORT}}
    print("resnet [%s]: symbols/resnet.py get_symbol(%d, %d, %s): pass "
          "report %d -> %d nodes, rewrites %s (%.1f ms)"
          % (card, RESNET_CLASSES, RESNET_LAYERS, RESNET_SHAPE,
             report["nodes_before"], report["nodes_after"],
             report["rewrites"], report["total_ms"]))
    check(out["report"] == RESNET_REPORT, "resnet: pass report %r, the "
          "reference's is %r" % (out["report"], RESNET_REPORT))

    train = synthetic_data_iter(mx, RESNET_CLASSES, shape, RESNET_BATCHES)
    batch = next(iter(train))
    train.reset()
    kv = mx.kv.create("device")
    # fit.py calls mx.tpu(); the card's context is mx.gpu(0)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    steps, losses = [], []
    fit_step = mod.fit_step

    def timed_fit_step(data_batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit_step(data_batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)

    def per_batch(param):
        losses.append(replay_loss(mx, mod, batch.label[0]))

    mod.fit_step = timed_fit_step
    metric = mx.metric.create(["accuracy"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=1, eval_metric=metric, kvstore=kv,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "wd": 1e-4,
                              "momentum": 0.9,
                              "lr_scheduler": imagenet_lr_scheduler(mx)},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=[mx.callback.Speedometer(RESNET_B, 4),
                                per_batch],
            allow_missing=True)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["kernel_launches"] = kernel_launches()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    on_card = all(a.data.device.type == dev.type
                  for a in list(mod._exec.arg_dict.values()) +
                  list(mod._exec.aux_dict.values()))
    check(on_card, "resnet: an executor array is not on %s" % dev)
    check(mod._update_on_kvstore and not mod._fused.active and
          mod._kvstore is kv, "resnet: fit did not update on the kvstore")
    check(all(kv._store[n].data.device.type == dev.type
              for n in mod._param_names),
          "resnet: the store's weights are not on %s" % dev)
    steady = steps[1:]
    out.update({
        "step_ms": [x * 1e3 for x in steps],
        "fit_step_p50_ms": statistics.median(steady) * 1e3,
        "images_per_s": RESNET_B / statistics.median(steady),
        "loss": losses,
        "graph_report": mod.graph_report["rewrites"]})
    acc = mx.metric.Accuracy()
    acc.update(batch.label, mod.get_outputs())
    out["accuracy"] = acc.get()[1]
    print("resnet [%s]: Module(context=mx.gpu(0)).fit with kv.create("
          "'device'), batch %d x %s, %d batches: fit step p50 %.2f ms "
          "(steps %s ms), %.1f images/s, fit %.1f s, peak device memory "
          "%.1f MiB; loss on the replayed batch by step %s; accuracy on it "
          "at the last step %.4f; kernels of the port launched: %d"
          % (card, RESNET_B, RESNET_SHAPE, RESNET_BATCHES,
             out["fit_step_p50_ms"],
             ", ".join("%.1f" % x for x in out["step_ms"]),
             out["images_per_s"], out["fit_s"], out["peak_mib"],
             ", ".join("%.4f" % x for x in losses), out["accuracy"],
             out["kernel_launches"]))
    check(len(steps) == RESNET_BATCHES and len(losses) == RESNET_BATCHES,
          "resnet: %d fit steps" % len(steps))
    check(all(math.isfinite(x) for x in losses),
          "resnet: non-finite loss %r" % losses)
    check(losses[-1] < losses[0], "resnet: the loss did not fall: %r"
          % losses)

    # a profiled window of fit steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(RESNET_PROFILE_STEPS):
            fit_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    out["profile"] = profile_summary(prof, wall_us, RESNET_PROFILE_STEPS,
                                     "profile resnet [%s]: fit step" % card)
    out["profile"]["groups"] = resnet_time_groups(prof, RESNET_PROFILE_STEPS)
    print("profile resnet [%s]: device ms a step by group: %s"
          % (card, ", ".join("%s %.3f" % kv_ for kv_ in
                             out["profile"]["groups"].items())))
    arg_params, aux_params = mod.get_params()
    del mod, prof, kv
    gc.collect()
    torch.cuda.empty_cache()

    # fused (the pipeline on) against unfused (off), same weights, batch
    logits_sym = sym.get_internals()["fc1_output"]
    logits = {}
    for passes in ("", "off"):
        exe = sym_bind(logits_sym, {"data": shape},
                       {n: a.data for n, a in arg_params.items()
                        if n in logits_sym.list_arguments()}, "null", passes)
        exe.copy_params_from({}, {n: a.data for n, a in aux_params.items()})
        rewrites = (exe._graph_report or {}).get("rewrites", {})
        want = 0 if passes else RESNET_REPORT["rewrites"]["conv_bn_act"]
        check(rewrites.get("conv_bn_act", 0) == want,
              "resnet: %r bind fused %r" % (passes, rewrites))
        for train_ in (True, False):
            o = exe.forward(is_train=train_, data=batch.data[0])[0].data
            check(o.device.type == dev.type and tuple(o.shape) ==
                  (RESNET_B, RESNET_CLASSES) and bool(torch.isfinite(o).all()),
                  "resnet: a %s forward gave %s on %s"
                  % ("training" if train_ else "eval", tuple(o.shape),
                     o.device))
            logits[(passes, train_)] = o.clone()
        del exe
    for train_, mode in ((True, "train"), (False, "eval")):
        a, b = logits[("", train_)], logits[("off", train_)]
        out["fused_vs_unfused_%s" % mode] = float((a - b).abs().max()
                                                  / b.abs().max())
        out["max_logit_%s" % mode] = float(b.abs().max())
    out["fused_train_bit_equal"] = bool(torch.equal(logits[("", True)],
                                                    logits[("off", True)]))
    del logits
    torch.cuda.empty_cache()
    print("resnet [%s]: fused (%d conv_bn_act) vs unfused binds of the "
          "trained weights on the batch, max |logit - ref| of max |ref|: "
          "training forward %.3g (bit-equal: %s; max |logit| %.4g), eval "
          "forward (the fold) %.3g (max |logit| %.4g); limit "
          "RESNET_FUSED_TOL %g"
          % (card, RESNET_REPORT["rewrites"]["conv_bn_act"],
             out["fused_vs_unfused_train"], out["fused_train_bit_equal"],
             out["max_logit_train"], out["fused_vs_unfused_eval"],
             out["max_logit_eval"], RESNET_FUSED_TOL))
    check(out["fused_vs_unfused_train"] <= RESNET_FUSED_TOL and
          out["fused_vs_unfused_eval"] <= RESNET_FUSED_TOL,
          "resnet: fused and unfused forwards differ")
    return out


#: device-time groups of a ResNet step, by kernel name (first match)
RESNET_GROUPS = (("conv (cuDNN, GEMM)", ("conv", "cudnn", "gemm", "sm90",
                                         "sm80", "xmma", "implicit",
                                         "winograd", "fft", "dgrad",
                                         "wgrad")),
                 ("batch statistics (reductions)", ("reduce", "norm",
                                                    "welford", "var_mean")),
                 ("copies", ("copy", "memcpy", "memset", "fill")),
                 ("pooling", ("pool",)),
                 ("elementwise", ("elementwise", "vectorized", "foreach",
                                  "unrolled")))


def resnet_time_groups(prof, steps):
    """Device ms a step of a profiled window, by ``RESNET_GROUPS``
    (kernels named by none of them are "other")."""
    from torch.autograd import DeviceType
    groups = {name: 0.0 for name, _ in RESNET_GROUPS}
    groups["other"] = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key.lower()
        name = next((n for n, words in RESNET_GROUPS
                     if any(w in key for w in words)), "other")
        groups[name] += e.self_device_time_total / steps / 1e3
    return groups


#: the vision cell: the Gluon zoo's resnet50_v1 (1000 classes) hybridized
#: at batch 64 x 3 x 224 x 224, fp32, Xavier weights from mx.random.seed
#: 0; VISION_FWD_REPS timed forwards; VISION_STEPS Trainer SGD steps
VISION_B, VISION_SIZE, VISION_FWD_REPS, VISION_STEPS = 64, 224, 5, 3
#: resnet50_v1's conv -> BatchNorm (-> relu) fusions in the hybridized
#: CachedOp: the JAX package's count for the same block (tests/
#: test_torch_vision_resnet.py holds the port's equal to it on the CPU)
RESNET50_V1_FUSIONS = 53
#: eager against hybridized logits (eval): max |a - b| over max |b|.  The
#: eager block normalizes after each convolution, the CachedOp's fold
#: before it (fp32, TF32 off); a wrong fold is off by a share of the
#: logits themselves
VISION_HYBRID_TOL = 1e-4
#: tools/make_pretrained_fixture.py's input (a copy of fixture_inputs)
#: and test_pretrained_fixture.py's tolerance for the SqueezeNet logits
FIXTURE_SEED, FIXTURE_RTOL, FIXTURE_ATOL = 1234, 1e-4, 1e-5


def vision_phase(dev, card):
    """The Gluon vision zoo on the card: the SqueezeNet fixture, then
    ``resnet50_v1`` hybridized (eager against hybridized, the fusion
    count, forward images/s) and a few ``Trainer`` SGD steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    out = {}
    img = np.random.RandomState(FIXTURE_SEED).randn(4, 3, 64, 64) \
        .astype(np.float32)
    net = vision.squeezenet1_1(classes=10)
    net.load_params(os.path.join(REPO, "tests", "fixtures",
                                 "squeezenet_tiny.params"), ctx=mx.gpu(0))
    x = mx.nd.array(img, ctx=mx.gpu(0))
    logits = net(x)
    check(logits.data.device.type == dev.type, "vision: squeezenet logits "
          "on %s" % logits.data.device)
    expect = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "squeezenet_tiny_logits.npy"))
    got = logits.asnumpy()
    out["squeezenet_max_abs_err"] = float(np.abs(got - expect).max())
    ok = np.allclose(got, expect, rtol=FIXTURE_RTOL, atol=FIXTURE_ATOL)
    print("vision [%s]: squeezenet1_1(classes=10) on the committed fixture: "
          "max |logit - expected| %.3g (rtol %g, atol %g): %s"
          % (card, out["squeezenet_max_abs_err"], FIXTURE_RTOL,
             FIXTURE_ATOL, ok))
    check(ok, "vision: squeezenet fixture logits differ")
    del net, x, logits

    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    xb = np.random.RandomState(1).uniform(
        -1, 1, (VISION_B, 3, VISION_SIZE, VISION_SIZE)).astype(np.float32)
    yb = np.random.RandomState(2).randint(0, 1000, VISION_B) \
        .astype(np.float32)
    x = mx.nd.array(xb, ctx=mx.gpu(0))
    y = mx.nd.array(yb, ctx=mx.gpu(0))
    eager = net(x).data.clone()
    net.hybridize()
    hybrid = net(x).data
    check(hybrid.device.type == dev.type and tuple(hybrid.shape) ==
          (VISION_B, 1000) and bool(torch.isfinite(hybrid).all()),
          "vision: resnet50_v1 gave %s on %s" % (tuple(hybrid.shape),
                                                 hybrid.device))
    out["hybrid_vs_eager"] = float((hybrid - eager).abs().max()
                                   / eager.abs().max())
    report = net._cached_graph_report
    out["conv_bn_act"] = report["rewrites"].get("conv_bn_act", 0)
    del eager, hybrid
    fwd = []
    for _ in range(VISION_FWD_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        net(x)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t)
    out["forward_p50_ms"] = statistics.median(fwd) * 1e3
    out["forward_images_per_s"] = VISION_B / statistics.median(fwd)
    print("vision [%s]: resnet50_v1 hybridized at batch %d x 3 x %d x %d: "
          "%d conv_bn_act fusions (%d nodes -> %d), eager vs hybridized "
          "logits %.3g of max |logit| (limit %g); forward p50 %.2f ms, "
          "%.1f images/s"
          % (card, VISION_B, VISION_SIZE, VISION_SIZE, out["conv_bn_act"],
             report["nodes_before"],
             report["nodes_after"], out["hybrid_vs_eager"],
             VISION_HYBRID_TOL, out["forward_p50_ms"],
             out["forward_images_per_s"]))
    check(out["conv_bn_act"] == RESNET50_V1_FUSIONS,
          "vision: %d fusions, the reference's count is %d"
          % (out["conv_bn_act"], RESNET50_V1_FUSIONS))
    check(out["hybrid_vs_eager"] <= VISION_HYBRID_TOL,
          "vision: hybridized logits differ from eager")

    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for _ in range(VISION_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(gluon_nd_step(net, trainer, loss_fn, (x, y, None)))
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
    out.update({"step_ms": [s_ * 1e3 for s_ in steps],
                "step_p50_ms": statistics.median(steps) * 1e3,
                "train_images_per_s": VISION_B / statistics.median(steps),
                "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "loss": losses})
    on_card = all(p.data().data.device.type == dev.type
                  for p in net.collect_params().values())
    print("vision [%s]: %d Trainer SGD steps (lr 0.1, momentum 0.9, wd "
          "1e-4) of the hybridized resnet50_v1: step p50 %.2f ms (steps %s "
          "ms), %.1f images/s, peak device memory %.1f MiB, loss %s"
          % (card, VISION_STEPS, out["step_p50_ms"],
             ", ".join("%.1f" % s_ for s_ in out["step_ms"]),
             out["train_images_per_s"], out["peak_mib"],
             ", ".join("%.4f" % v for v in losses)))
    check(on_card, "vision: a parameter is not on %s" % dev)
    check(all(math.isfinite(v) for v in losses),
          "vision: non-finite loss %r" % losses)
    del net, trainer, x, y
    gc.collect()
    torch.cuda.empty_cache()
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


#: the training-planes phase (slice S4b): the Module phase's symbolic GPT
#: at full width, fed a RecordIO shard set of ``shards`` x ``records``
#: records (an int32 id and ``seq`` + 1 seeded tokens each) through
#: ``StreamLoader`` at batch ``batch``; Adam at MOD_LR.  (a) fits
#: ``epochs`` epochs in this process; (b) runs ``resume_epochs`` under
#: ``tools/launch.py`` with ``worker.lost`` armed after batch
#: ``kill_after`` of the fit's epoch index ``kill_epoch`` (the third)
PLANES = dict(shards=3, records=16, batch=SYM_B, epochs=3, resume_epochs=4,
              kill_epoch=2, kill_after=3, layers=SYM_LAYERS,
              units=SYM_UNITS, heads=SYM_HEADS, seq=SYM_T, vocab=SYM_VOCAB,
              seed=11, lr=MOD_LR, device="cuda:0", timeout=600)
#: (b) at a size the CPU runs in seconds (tests/test_torch_training_planes)
RESUME_CPU = dict(layers=1, units=32, heads=2, seq=16, vocab=64,
                  device="cpu", timeout=240)
#: (c) the elastic train-to-serve loop (tests/test_stream_e2e.py at full
#: width): gpt2_small trained by the Gluon loop (Trainer SGD) at B 4 x T
#: 1024 from a follow-mode stream of 3 shards x 16 records, 2 more
#: appended and the stream sealed once the first publication lands; a
#: generation every ``gen_batches`` batches; slot 1 dies one batch into
#: generation 2.  The replica: 8 slots, page 16, greedy probes of
#: ``probe_len`` tokens
ELASTIC = dict(layers=12, units=768, heads=12, vocab=50304, seq=1024,
               batch=4, shards=3, records=16, appended=2, gen_batches=2,
               lr=0.02, seed=13, slots=8, page=16, probe_len=16,
               probe_new=8, max_seq=64, device="cuda:0", timeout=900)
#: (c) on the CPU (the slow test in tests/test_torch_training_planes.py)
ELASTIC_CPU = dict(layers=1, units=16, heads=2, vocab=16, seq=8, batch=4,
                   records=24, max_seq=16, probe_len=5, probe_new=4,
                   device="cpu", timeout=420)
#: the serving net's names (both trainers and the replica build with it)
ELASTIC_PREFIX = "cts_"
LAUNCH = os.path.join(REPO, "tools", "launch.py")


def token_record(rid, toks):
    """One stream record: the int32 id, then the tokens."""
    return np.concatenate([[rid], toks]).astype(np.int32).tobytes()


def write_token_shards(mx, root, shards, records, n_tokens, vocab, rng,
                       first_id=0, seal=False):
    """Append ``shards`` RecordIO shards of ``records`` records each
    (ids from ``first_id``) through the port's ``ShardSetWriter``; returns
    the next id."""
    w = mx.stream.ShardSetWriter(root)
    rid = first_id
    for _ in range(shards):
        recs = []
        for _ in range(records):
            recs.append(token_record(rid, rng.integers(0, vocab, n_tokens)))
            rid += 1
        w.write_recordio_shard(recs)
    if seal:
        w.seal()
    return rid


def decode_lm(raw):
    """A record as the Module's ``(data, softmax_label)``: the tokens but
    the last, and the tokens but the first (float32, as NDArrayIter feeds
    the symbolic GPT)."""
    arr = np.frombuffer(raw, np.int32)
    return arr[1:-1].astype(np.float32), arr[2:].astype(np.float32)


def decode_lm_id(raw):
    """:func:`decode_lm` and the record's id."""
    arr = np.frombuffer(raw, np.int32)
    return (arr[1:-1].astype(np.float32), arr[2:].astype(np.float32),
            np.float32(arr[0]))


def id_train_iter(mx, loader):
    """``StreamTrainIter`` over ``loader`` whose batches carry their
    record ids in ``DataBatch.index`` (decode with :func:`decode_lm_id`)."""
    from mxnet_tpu_torch.stream.fit import StreamTrainIter

    class IdTrainIter(StreamTrainIter):
        def _to_batch(self, batch):
            if isinstance(batch, mx.io.DataBatch):
                return batch
            data, label, ids = batch
            return mx.io.DataBatch(
                data=[data], label=[label], pad=0,
                index=[int(i) for i in ids.asnumpy()])

    return IdTrainIter(loader)


def planes_sym(mx, cfg):
    """The symbolic GPT of ``cfg``'s widths and its input shapes."""
    sym = build_gpt_sym(mx, cfg["layers"], cfg["units"], cfg["heads"],
                        cfg["seq"], cfg["vocab"])
    shapes = {"data": (cfg["batch"], cfg["seq"]),
              "softmax_label": (cfg["batch"], cfg["seq"])}
    return sym, shapes


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the body (cuBLAS with a fixed
    workspace; the embeddings' backward, an ``index_add_``, without
    atomics), so that two runs of the same steps give the same bits;
    yields the list of warnings torch raised for ops it has no
    deterministic version of."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)


def stream_fit(mx, cfg, out, dev, on_batch=None, log=None):
    """``Module.fit`` over the shard set under ``out``/ss for
    ``resume_epochs`` epochs, resuming from ``CheckpointManager.latest()``
    of ``out``/ckpt/gpt when there is one: its parameters and checksummed
    ``.states`` (``Module.load``), its manifest's stream cursor and
    ``begin_epoch``, with the optimizer's clocks continued
    (``begin_num_update``).  Batches carry their ids; ``on_batch(param)``
    runs after each.  Runs under :func:`deterministic`, so a resumed run
    can be held bit for bit against an uninterrupted one.  Returns
    ``(module, resumed epoch or 0, nondeterminism warnings)``."""
    prefix = os.path.join(out, "ckpt", "gpt")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mgr = mx.CheckpointManager(prefix, ctx=dev)
    latest = mgr.latest()
    per_epoch = cfg["shards"] * cfg["records"] // cfg["batch"]
    ctx = mx.Context(dev)
    if latest:
        cursor = mgr.manifest_info(latest)["stream_cursor"]
        mod = mx.mod.Module.load(prefix, latest, load_optimizer_states=True,
                                 context=ctx)
        params = None
        total = sum(b - a for a, b in cursor["spans"])
        if cursor["consumed"] == total:
            # the epoch the checkpoint closed was consumed whole: the
            # next epoch starts fresh
            epoch, resume = cursor["epoch"] + 1, None
        else:
            epoch, resume = cursor["epoch"], [cursor]
    else:
        sym, shapes = planes_sym(mx, cfg)
        params = sym_params(sym, shapes, cfg["seed"], dev)
        mod = mx.mod.Module(sym, context=ctx)
        epoch, resume = 0, None
    loader = mx.stream.StreamLoader(
        os.path.join(out, "ss"), cfg["batch"], decode_fn=decode_lm_id,
        mode="epoch", epoch=epoch, last_batch="discard", rank=0,
        world_size=1, seed=cfg["seed"], resume=resume)

    def batch_end(param):
        if log is not None:
            log.write(json.dumps({
                "epoch": param.epoch, "nbatch": param.nbatch,
                "ids": param.locals["data_batch"].index,
                "t": time.time()}) + "\n")
            log.flush()
        if on_batch is not None:
            on_batch(param)

    with ctx, loader, deterministic() as caught:  # batches land on ``dev``
        mod.fit(id_train_iter(mx, loader), optimizer="adam",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "begin_num_update":
                                      (latest or 0) * per_epoch},
                eval_metric=mx.metric.Perplexity(None),
                num_epoch=cfg["resume_epochs"], begin_epoch=latest or 0,
                arg_params=params, batch_end_callback=batch_end,
                epoch_end_callback=mx.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True, keep_last=2))
    return mod, latest or 0, sorted({str(w.message)[:160] for w in caught
                                     if "determinis" in str(w.message)})


RESUME_SCRIPT = """import json, sys
sys.path.insert(0, %(repo)r)
import chip_smoke
chip_smoke.resume_worker(json.loads(%(cfg)r), %(out)r)
"""
RESUME_MARK = "resume_worker: exit "


def resume_worker(cfg, out):
    """The kill-and-resume worker (one launcher attempt): :func:`stream_fit`
    with ``worker.lost`` armed from the environment
    (``MXTPU_FAULT_ATTEMPTS`` scopes it) after batch ``kill_after`` of
    epoch index ``kill_epoch``; logs its trained ids and resume point and
    prints one exit line (device, steps, B4 launches, kernel builds)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, elastic, fault, telemetry
    dev = torch.device(cfg["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attempt = elastic.membership()["attempt"]
    log = open(os.path.join(out, "steps-a%d.jsonl" % attempt), "w")

    def on_batch(param):
        if param.epoch == cfg["kill_epoch"] and \
                param.nbatch == cfg["kill_after"] - 1:
            # the previous epoch's queued write lands first, so the
            # resume point is the same in every run
            checkpoint.flush_async()
            os.environ["MXTPU_FAULT"] = "worker.lost:1"
            fault.configure()            # the env spec, attempt-scoped
            if fault.is_active("worker.lost"):
                with open(os.path.join(out, "kill.json"), "w") as f:
                    json.dump({"t": time.time()}, f)

    ln_count(reset=True)
    mod, resumed, nondet = stream_fit(mx, cfg, out, dev, on_batch, log)
    log.close()
    doc = {"device": str(dev), "attempt": attempt, "resumed_from": resumed,
           "nondeterministic": nondet,
           "steps": mod._steps_taken, "b4_launches": ln_count(),
           "kernel_builds": int(telemetry.xla_compile_events())}
    if dev.type == "cuda":
        doc["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    sys.stderr.write(RESUME_MARK + json.dumps(doc) + "\n")
    sys.stderr.flush()


def marked_lines(log_path, mark):
    """Every ``<mark>{...}`` document in a shared log (see
    :func:`exit_lines`)."""
    out, decoder = [], json.JSONDecoder()
    with open(log_path, errors="replace") as f:
        for line in f:
            at = line.find(mark)
            while at >= 0:
                doc, end = decoder.raw_decode(line, at + len(mark))
                out.append(doc)
                at = line.find(mark, end)
    return out


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def planes_fit_phase(dev, card, module_p50_ms, work):
    """(a) ``Module(context=mx.gpu(0)).fit(StreamLoader)`` for ``epochs``
    epochs with ``module_checkpoint(..., keep_last=2)``, async checkpoints,
    the watchdog armed and a heartbeat file; then the state checks and a
    ``grad.nan`` step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch import fault, profiler, telemetry, watchdog
    cfg = PLANES
    n_ln = 2 * cfg["layers"]
    per_epoch = cfg["shards"] * cfg["records"] // cfg["batch"]
    root = os.path.join(work, "ss")
    write_token_shards(mx, root, cfg["shards"], cfg["records"],
                       cfg["seq"] + 1, cfg["vocab"],
                       np.random.default_rng(cfg["seed"]))
    sym, shapes = planes_sym(mx, cfg)
    params = sym_params(sym, shapes, cfg["seed"], dev)
    prefix = os.path.join(work, "ckpt", "gpt")
    os.makedirs(os.path.dirname(prefix))
    loader = mx.stream.StreamLoader(root, cfg["batch"], decode_fn=decode_lm,
                                    mode="epoch", last_batch="discard",
                                    rank=0, world_size=1, seed=cfg["seed"])
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    steps, saves, flushes = [], [], []
    fit_step, save = mod.fit_step, mod.save_checkpoint
    flush = ckpt.flush_async

    def timed_fit_step(batch):
        torch.cuda.synchronize()
        ln_count(reset=True)
        t = time.perf_counter()
        fit_step(batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t, ln_count()))

    def timed_save(*a, **kw):
        t = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - t)

    def timed_flush(*a, **kw):
        t = time.perf_counter()
        flush(*a, **kw)
        flushes.append(time.perf_counter() - t)

    lines = []

    class _Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    monitor_log = logging.getLogger("chip_smoke.planes")
    monitor_log.addHandler(_Lines())
    monitor_log.setLevel(logging.INFO)
    mod.fit_step, mod.save_checkpoint = timed_fit_step, timed_save
    with env("MXTPU_HEARTBEAT_DIR", os.path.join(work, "hb")):
        hb = watchdog.start_heartbeat(rank=0, interval=0.2)
    telemetry.reset()
    profiler.reset_step_stats()
    ckpt.flush_async = timed_flush
    t0 = time.perf_counter()
    try:
        with env("MXTPU_ASYNC_CKPT", "1"), \
                env("MXTPU_STALL_TIMEOUT", str(cfg["timeout"])), loader:
            mod.fit(loader, optimizer="adam",
                    optimizer_params={"learning_rate": cfg["lr"]},
                    eval_metric=mx.metric.Perplexity(None),
                    num_epoch=cfg["epochs"], arg_params=params,
                    batch_end_callback=mx.monitor.StepStatsMonitor(
                        interval=per_epoch, logger=monitor_log),
                    epoch_end_callback=mx.callback.module_checkpoint(
                        mod, prefix, save_optimizer_states=True,
                        keep_last=2))
            armed = watchdog.armed()
    finally:
        ckpt.flush_async = flush
        mod.fit_step, mod.save_checkpoint = fit_step, save
    fit_s = time.perf_counter() - t0
    n_steps = cfg["epochs"] * per_epoch
    out = {"fit_s": fit_s, "steps": len(steps),
           "fit_step_p50_ms": statistics.median(s for s, _ in steps) * 1e3,
           "module_phase_fit_step_p50_ms": module_p50_ms,
           "save_return_s": saves,
           # the last flush is fit's exit drain of the final epoch's write
           "exit_flush_s": flushes[-1],
           "launches": sum(n for _, n in steps)}
    check(len(steps) == n_steps and all(n == n_ln for _, n in steps),
          "planes (a): B4 launches per fit step %r, want %d x %d"
          % ([n for _, n in steps], n_steps, n_ln))
    check(not armed, "planes (a): the watchdog stayed armed after fit")
    mgr = mx.CheckpointManager(prefix, ctx=dev)
    check(mgr.complete_epochs() == [cfg["epochs"] - 1, cfg["epochs"]],
          "planes (a): retention left epochs %r" % mgr.complete_epochs())
    total = cfg["shards"] * cfg["records"]
    for e in mgr.complete_epochs():
        cur = mgr.manifest_info(e)["stream_cursor"]
        check(cur["mode"] == "epoch" and cur["consumed"] == total and
              cur["epoch"] == e - 1,
              "planes (a): epoch %d's cursor %r" % (e, cur))
    # a fresh Module loads the last epoch's checksummed states...
    mod2 = mx.mod.Module(sym, context=mx.gpu(0))
    mod2.bind(data_shapes=[("data", shapes["data"])],
              label_shapes=[("softmax_label", shapes["softmax_label"])])
    mod2.init_params(arg_params=mod.get_params()[0])
    mod2.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": cfg["lr"]})
    states = mgr.states_path(cfg["epochs"])
    mod2.load_optimizer_states(states)
    mod._fused.flush()
    want, got = mod._updater.states, mod2._updater.states
    same = sorted(want) == sorted(got) and all(
        torch.equal(a.cpu(), b.cpu())
        for i in want for a, b in zip(want[i], got[i]))
    check(same, "planes (a): the loaded optimizer states differ")
    # ...and refuses a copy with one byte flipped
    bad = os.path.join(work, "flipped.states")
    shutil.copyfile(states, bad)
    with open(bad, "r+b") as f:
        f.seek(os.path.getsize(bad) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))
    try:
        mod2.load_optimizer_states(bad)
        refused = False
    except mx.MXNetError:
        refused = True
    check(refused, "planes (a): a corrupt states file was loaded")
    del mod2
    rep = telemetry.report()["phases"]
    records = [r for r in telemetry.flight_records()
               if r["where"] == "fit_step"]
    out["phases"] = {k: rep[k]["count"]
                     for k in ("fit_step.dispatch", "fit_step.sync")}
    check(out["phases"] == {"fit_step.dispatch": n_steps,
                            "fit_step.sync": n_steps} and
          len(records) == n_steps,
          "planes (a): %r phase samples and %d flight records for %d "
          "steps" % (out["phases"], len(records), n_steps))
    for _ in range(50):
        with open(hb) as f:
            beat = json.load(f)
        if beat["step"] == n_steps:
            break
        time.sleep(0.1)
    watchdog.stop_heartbeat()
    check(beat["step"] == n_steps, "planes (a): heartbeat step %r, %d "
          "steps taken" % (beat, n_steps))
    for line in lines:
        print("planes (a) [%s]: StepStatsMonitor: %s" % (card, line))
    check(sum(x.startswith("step[") for x in lines) == cfg["epochs"],
          "planes (a): StepStatsMonitor lines %r" % lines)
    # one step armed with grad.nan: skipped, bit for bit
    probe = mx.stream.StreamLoader(root, cfg["batch"], decode_fn=decode_lm,
                                   last_batch="discard", rank=0,
                                   world_size=1, prefetch=0)
    with probe:
        data, label = next(iter(probe))
    batch = mx.io.DataBatch(data=[data], label=[label])
    before = mod_params(mod)
    state = {i: [t.clone() for t in s] for i, s in
             mod_momentum_states(mod).items()}
    skipped = profiler.step_stats()["skipped_steps"]
    fault.configure("grad.nan:1")
    fit_step(batch)
    fault.reset()
    after = mod_params(mod)
    same = all(torch.equal(before[n], after[n]) for n in before) and all(
        torch.equal(a, b) for i, s in mod_momentum_states(mod).items()
        for a, b in zip(s, state[i]))
    check(same and profiler.step_stats()["skipped_steps"] == skipped + 1,
          "planes (a): the grad.nan step was not skipped bit for bit")
    # the loader alone: records/s delivered to the card
    rate = mx.stream.StreamLoader(root, cfg["batch"], decode_fn=decode_lm,
                                  last_batch="discard", rank=0,
                                  world_size=1)
    with rate:
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = sum(b[0].shape[0] for b in rate)
        torch.cuda.synchronize()
        out["loader_records_per_s"] = n / (time.perf_counter() - t)
    del mod
    torch.cuda.empty_cache()
    print("planes (a) [%s]: Module.fit over a StreamLoader (%d shards x %d "
          "records, B %d), %d epochs, Adam %g, async checkpoints with "
          "keep_last 2: fit step p50 %.2f ms (the Module phase's %.2f ms), "
          "fit %.1f s; save() returned in %s s, fit's exit flush_async() "
          "took %.3f s; "
          "the loader alone %.1f records/s to the card; %d B4 launches (%d "
          "a step); retention kept %r; heartbeat step %d; grad.nan step "
          "skipped bit for bit"
          % (card, cfg["shards"], cfg["records"], cfg["batch"],
             cfg["epochs"], cfg["lr"], out["fit_step_p50_ms"],
             module_p50_ms or float("nan"), fit_s,
             ", ".join("%.3f" % s for s in saves), flushes[-1],
             out["loader_records_per_s"], out["launches"], n_ln,
             mgr.complete_epochs(), beat["step"]))
    return out


def mod_momentum_states(mod):
    """The Updater's states by index as flat tuples of host tensors (the
    fused state flushed into it first)."""
    mod._fused.flush()
    out = {}
    for i, s in mod._updater.states.items():
        leaves = s if isinstance(s, (list, tuple)) else (s,)
        out[i] = tuple(t.detach().cpu() for t in leaves if t is not None)
    return out


def resume_phase(dev, card, cfg=None, workdir=None):
    """(b) Kill and resume: :func:`resume_worker` under the unchanged
    ``tools/launch.py -n 1 --max-restarts 1 --aot-cache-dir off`` dies of
    ``worker.lost`` (attempt 0 only) in its third epoch; the restart
    resumes from the last complete checkpoint.  Checks the exit 77 and the
    restart, the resume point, every counted epoch training each record
    once, and the final parameters against an uninterrupted run in this
    process."""
    import mxnet_tpu_torch as mx
    cfg = dict(PLANES, **(cfg or {}))
    n_ln = 2 * cfg["layers"]
    total = cfg["shards"] * cfg["records"]
    per_epoch = total // cfg["batch"]
    work = tempfile.mkdtemp(prefix="resume-", dir=workdir)
    out_dir = os.path.join(work, "out")
    base_dir = os.path.join(work, "base")
    for d in (out_dir, base_dir):
        write_token_shards(mx, os.path.join(d, "ss"), cfg["shards"],
                           cfg["records"], cfg["seq"] + 1, cfg["vocab"],
                           np.random.default_rng(cfg["seed"]))
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(RESUME_SCRIPT % {"repo": REPO, "cfg": json.dumps(cfg),
                                 "out": out_dir})
    env_ = dict(os.environ)
    env_.update({"MXTPU_ASYNC_CKPT": "1", "MXTPU_FAULT_ATTEMPTS": "0",
                 "PYTHONPATH": os.pathsep.join(
                     [REPO] + [p for p in [env_.get("PYTHONPATH")] if p])})
    env_.pop("MXTPU_FAULT", None)
    log_path = os.path.join(work, "launch.log")
    cmd = ["timeout", "-k", "10", str(cfg["timeout"]), sys.executable,
           LAUNCH, "-n", "1", "--max-restarts", "1", "--aot-cache-dir",
           "off", "--run-dir", os.path.join(work, "run"), "--",
           sys.executable, script]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, env=env_, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    with open(log_path, errors="replace") as f:
        text = f.read()
    check(rc == 0, "resume: tools/launch.py exited %d:\n%s"
          % (rc, text[-3000:]))
    check("exit code 77" in text and
          "restarting job from checkpoints" in text,
          "resume: the launcher saw no worker.lost restart:\n%s"
          % text[-3000:])
    exits = marked_lines(log_path, RESUME_MARK)
    check(len(exits) == 1 and exits[0]["attempt"] == 1,
          "resume: exit lines %r" % exits)
    doc = exits[0]
    check(doc["resumed_from"] == 2, "resume: the second attempt resumed "
          "from epoch %r, not 2" % doc["resumed_from"])
    check(doc["device"] == cfg["device"] and doc["kernel_builds"] == 0,
          "resume: worker on %s with %d kernel builds"
          % (doc["device"], doc["kernel_builds"]))
    on_card = cfg["device"].startswith("cuda")
    check(doc["b4_launches"] == (n_ln * doc["steps"] if on_card else 0),
          "resume: %d B4 launches in %d steps" % (doc["b4_launches"],
                                                 doc["steps"]))
    first, second = (read_jsonl(os.path.join(out_dir, "steps-a%d.jsonl"
                                             % a)) for a in (0, 1))
    # the counted history: attempt 0's epochs before the resume point,
    # attempt 1's from it; each epoch trains every record once
    counted = [r for r in first if r["epoch"] < doc["resumed_from"]] + \
        second
    by_epoch = {}
    for r in counted:
        by_epoch.setdefault(r["epoch"], []).extend(r["ids"])
    check(sorted(by_epoch) == list(range(cfg["resume_epochs"])) and all(
        sorted(ids) == list(range(total)) for ids in by_epoch.values()),
        "resume: counted epochs do not train each record once: %r"
        % {e: len(ids) for e, ids in by_epoch.items()})
    killed = [r for r in first if r["epoch"] == cfg["kill_epoch"]]
    check(len(killed) == cfg["kill_after"],
          "resume: attempt 0 trained %d batches of epoch %d"
          % (len(killed), cfg["kill_epoch"]))
    with open(os.path.join(out_dir, "kill.json")) as f:
        kill_t = json.load(f)["t"]
    resume_s = second[0]["t"] - kill_t
    # the uninterrupted run, in this process
    mod, _, nondet = stream_fit(mx, cfg, base_dir, dev)
    want = mod_params(mod)
    del mod
    _, got, _ = mx.CheckpointManager(os.path.join(out_dir, "ckpt", "gpt"),
                                     ctx=dev).load(cfg["resume_epochs"])
    diff = max((got[n].data - w).abs().max().item() / w.abs().max().item()
               for n, w in want.items())
    check(diff <= MOD_PARAM_TOL, "resume: final parameters off by %.3g of "
          "max |p| from the uninterrupted run (ops torch ran without a "
          "deterministic version: %r, %r)"
          % (diff, nondet, doc["nondeterministic"]))
    if on_card:
        torch.cuda.empty_cache()
    print("resume [%s]: tools/launch.py -n 1 --max-restarts 1: worker.lost "
          "after batch %d of epoch %d, exit 77, restart resumed from epoch "
          "%d; kill to first resumed step %.3f s (launcher command %.1f "
          "s); %d counted epochs each trained every record once; final "
          "parameters vs the uninterrupted run: max |diff| %.3g of max "
          "|p| (limit MOD_PARAM_TOL %g; both runs in torch's deterministic "
          "mode, ops without a deterministic version: %r); worker on %s, "
          "%d kernel builds, %d B4 launches in %d steps"
          % (card, cfg["kill_after"], cfg["kill_epoch"] + 1,
             doc["resumed_from"], resume_s, wall, len(by_epoch), diff,
             MOD_PARAM_TOL, sorted(set(nondet) | set(
                 doc["nondeterministic"])), doc["device"],
             doc["kernel_builds"],
             doc["b4_launches"], doc["steps"]))
    shutil.rmtree(work, ignore_errors=True)
    return {"resumed_from": doc["resumed_from"], "max_param_diff": diff,
            "kill_to_resume_s": resume_s, "wall_s": wall,
            "worker": doc, "launches": doc["b4_launches"]}


ELASTIC_SCRIPT = """import json, sys
sys.path.insert(0, %(repo)r)
import chip_smoke
chip_smoke.elastic_worker(json.loads(%(cfg)r), %(out)r)
"""
ELASTIC_MARK = "elastic_worker: exit "


def seeded_gpt(mx, cfg, dev):
    """A GPTLM of ``cfg``'s widths named ``ELASTIC_PREFIX`` with seeded
    weights (matrices normal(0, 0.02), LayerNorm gamma 1, beta 0) on
    ``dev``."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    net = gpt.get_gpt(cfg["layers"], cfg["units"], cfg["heads"],
                      vocab_size=cfg["vocab"], max_len=cfg["seq"] + 8,
                      prefix=ELASTIC_PREFIX)
    rng = np.random.default_rng(cfg["seed"])
    arrays = {}
    for name, p in net.collect_params().items():
        if name.endswith("_gamma"):
            arrays[name] = np.ones(tuple(p.shape), np.float32)
        elif name.endswith("_beta"):
            arrays[name] = np.zeros(tuple(p.shape), np.float32)
        else:
            arrays[name] = rng.standard_normal(
                tuple(p.shape), np.float32) * 0.02
    return gpt.load_jax_params(net, arrays, dev)


def elastic_worker(cfg, out):
    """``tests/test_stream_e2e.py``'s WORKER on the port: resume from the
    newest complete cursor generation and its paired checkpoint, train
    ``gpt2_small``'s Gluon loop on a follow-mode stream, publish a
    generation every ``gen_batches`` batches (every rank's cursor, then
    rank 0's checkpoint, flushed), die of ``worker.lost`` where the
    environment arms it, and print one exit line."""
    import datetime
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, elastic, fault, gluon, telemetry
    from mxnet_tpu_torch.checkpoint import flush_async
    dev = torch.device(cfg["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem = elastic.membership()
    rank, world = mem["rank"], mem["world_size"]
    slot, attempt = mem["slot"], mem["attempt"]
    net = seeded_gpt(mx, cfg, dev)
    prefix = os.path.join(out, "ck", "model")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mgr = mx.CheckpointManager(prefix, ctx=dev)
    cs = mx.stream.CursorStore(os.path.join(out, "ck"))
    g, _ = cs.load_latest()
    ck = mgr.latest()
    start_gen = min(g or 0, ck or 0)
    cursors = cs.load(start_gen) if start_gen > 0 else None
    if start_gen > 0:
        _, args, _ = mgr.load(start_gen)
        params = net.collect_params()
        for name, val in args.items():
            params[name].set_data(val)
    with open(os.path.join(out, "resume-a%d-r%d.json" % (attempt, rank)),
              "w") as f:
        json.dump({"gen": start_gen, "world": world, "slot": slot}, f)
    store = None
    if world > 1:
        host, port = os.environ["MXTPU_COORDINATOR"].rsplit(":", 1)
        store = torch.distributed.TCPStore(
            host, int(port), world, rank == 0,
            timeout=datetime.timedelta(seconds=cfg["timeout"]))

    def barrier(name):
        # the script's own barrier: a counter on the TCPStore
        if store is None:
            return
        key = "%s-a%d" % (name, attempt)
        store.add(key, 1)
        while store.add(key, 0) < world:
            time.sleep(0.01)

    def decode(raw):
        arr = np.frombuffer(raw, np.int32)
        return arr[1:], arr[0]

    ld = mx.stream.StreamLoader(
        mx.stream.load_shard_set(os.path.join(out, "ss")), cfg["batch"],
        decode_fn=decode, mode="follow", prefetch=0, poll_secs=0.1,
        resume=cursors)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"]})
    ce = gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)
    seq = cfg["seq"]
    flash_counts(reset=True)
    bucket, steps, first_t = [], 0, None

    def status(gen):
        doc = {"gen": gen, "ids": list(bucket), "steps": steps,
               "flash": list(flash_counts()[:3]), "device": str(dev),
               "slot": slot, "attempt": attempt, "rank": rank,
               "kernel_builds": int(telemetry.xla_compile_events())}
        if dev.type == "cuda":
            doc["peak_memory_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))
        return doc

    def publish(gen):
        cs.save(gen, ld.cursor())
        with open(os.path.join(out, "ids-a%d-r%d-g%03d.json"
                               % (attempt, rank, gen)), "w") as f:
            json.dump(status(gen), f)
        del bucket[:]
        if rank == 0:
            mgr.save(gen, {p.name: p.data().copy()
                           for p in net.collect_params().values()}, {},
                     stream_cursor=ld.cursor())
            flush_async()

    gen, batch_n = start_gen, 0
    scope = mx.Context(dev)          # batches land on ``dev``
    scope.__enter__()
    for toks, ids in iter(ld):
        with autograd.record():
            logits = net(toks.slice_axis(axis=1, begin=0, end=seq))
            labels = toks.slice_axis(axis=1, begin=1, end=seq + 1)
            loss = ce(logits, labels).mean()
        loss.backward()
        trainer.step(toks.shape[0])
        steps += 1
        if first_t is None:
            float(loss.asnumpy())
            first_t = time.time()
            with open(os.path.join(out, "first-a%d-r%d.json"
                                   % (attempt, rank)), "w") as f:
                json.dump({"t": first_t}, f)
        bucket.extend(int(i) for i in ids.asnumpy().ravel())
        batch_n += 1
        if batch_n == cfg["gen_batches"] + 1:
            # one batch into generation 2: the environment scopes the
            # drill to slot 1's first attempt
            os.environ["MXTPU_FAULT"] = "worker.lost:1"
            fault.configure()
            if fault.is_active("worker.lost"):
                with open(os.path.join(out, "kill.json"), "w") as f:
                    json.dump({"t": time.time(), "slot": slot}, f)
            fault.exit_if("worker.lost")
        if batch_n % cfg["gen_batches"] == 0:
            gen += 1
            barrier("gen-%d-pre" % gen)
            publish(gen)
            barrier("gen-%d-post" % gen)
    with open(os.path.join(out, "ids-a%d-r%d-gend.json" % (attempt, rank)),
              "w") as f:
        json.dump(dict(status("end"), gen="end"), f)
    del bucket[:]
    barrier("final")
    if rank == 0:
        mgr.save(gen + 1, {p.name: p.data().copy()
                           for p in net.collect_params().values()}, {},
                 stream_cursor=ld.cursor())
        flush_async()
        with open(os.path.join(out, "done-r0.json"), "w") as f:
            json.dump({"attempt": attempt, "world": world,
                       "final_gen": gen + 1}, f)
    ld.close()
    scope.__exit__(None, None, None)
    sys.stderr.write(ELASTIC_MARK + json.dumps(status("exit")) + "\n")
    sys.stderr.flush()


def elastic_phase(dev, card, cfg=None, workdir=None):
    """(c) The elastic train-to-serve loop: two :func:`elastic_worker`
    processes under the unchanged ``tools/launch.py -n 2 --elastic
    --evict-after 1 --readmit-after 99 --max-restarts 4 --aot-cache-dir
    off`` on ``cfg["device"]``, while this process plays
    ``tests/stream_e2e_driver.py``: a ``ServingReplica`` on the trainers'
    prefix hot-swapping every publication between greedy decode steps,
    the stream writer (2 shards appended and the stream sealed once the
    first publication lands), and a re-publication of the final weights.
    Checks the membership arc, exactly-once effective coverage, >= 2
    canary-verified swaps, bit-identical greedy tokens across the
    unchanged publication, the workers' device and flash launches, and
    B5 at n_layers launches a decode step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import (CheckpointSubscriber,
                                         ServingEngine, ServingReplica)
    cfg = dict(ELASTIC, **(cfg or {}))
    on_card = cfg["device"].startswith("cuda")
    work = tempfile.mkdtemp(prefix="elastic-", dir=workdir)
    out = os.path.join(work, "out")
    os.makedirs(out)
    rng = np.random.default_rng(cfg["seed"])
    next_id = write_token_shards(mx, os.path.join(out, "ss"),
                                 cfg["shards"], cfg["records"],
                                 cfg["seq"] + 1, cfg["vocab"], rng)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(ELASTIC_SCRIPT % {"repo": REPO, "cfg": json.dumps(cfg),
                                  "out": out})
    env_ = dict(os.environ)
    env_.update({"MXTPU_ASYNC_CKPT": "1", "MXTPU_FAULT_SLOTS": "1",
                 "MXTPU_FAULT_ATTEMPTS": "0",
                 "PYTHONPATH": os.pathsep.join(
                     [REPO] + [p for p in [env_.get("PYTHONPATH")] if p])})
    env_.pop("MXTPU_FAULT", None)
    run_dir = os.path.join(work, "run")
    log_path = os.path.join(work, "launch.log")
    cmd = ["timeout", "-k", "10", str(cfg["timeout"]), sys.executable,
           LAUNCH, "-n", "2", "--elastic", "--evict-after", "1",
           "--readmit-after", "99", "--max-restarts", "4",
           "--restart-backoff", "0.01", "--aot-cache-dir", "off",
           "--run-dir", run_dir, "--", sys.executable, script]
    # the serving plane: one replica on the trainers' prefix for the run
    prefix = os.path.join(out, "ck", "model")
    srv = seeded_gpt(mx, dict(cfg, seed=cfg["seed"] + 1), dev)
    eng = ServingEngine(srv, num_slots=cfg["slots"], page_size=cfg["page"],
                        max_prefill_len=cfg["max_seq"],
                        max_seq_len=cfg["max_seq"], device=dev)
    sub = CheckpointSubscriber(prefix, srv)
    rep = ServingReplica(eng, replica_id="cts", subscriber=sub,
                         swap_poll_steps=1)
    probe = np.random.default_rng(1).integers(
        0, cfg["vocab"], cfg["probe_len"]).astype(np.int32)
    pa.launches.clear()
    steps0 = eng.decode_steps
    applied, pauses, served, appended = [], [], 0, False
    done_path = os.path.join(out, "done-r0.json")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        launcher = subprocess.Popen(cmd, env=env_, cwd=REPO, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
    try:
        while time.perf_counter() - t0 < cfg["timeout"]:
            t = time.perf_counter()
            e = rep.maybe_swap()
            if e is not None:
                applied.append(e)
                pauses.append(time.perf_counter() - t)
            if sub.applied_epoch is not None and served < 8:
                r = rep.submit(probe, 2)
                while not r.done:
                    rep.step()
                check(r.verdict == "completed", "elastic: a probe ended "
                      "%s" % r.verdict)
                served += 1
            if not appended and mx.CheckpointManager(prefix,
                                                     ctx=dev).latest():
                next_id = write_token_shards(
                    mx, os.path.join(out, "ss"), cfg["appended"],
                    cfg["records"], cfg["seq"] + 1, cfg["vocab"], rng,
                    first_id=next_id, seal=True)
                appended = True
            if os.path.exists(done_path) or launcher.poll() is not None:
                break
            time.sleep(0.1)
        rc = launcher.wait(timeout=cfg["timeout"])
    finally:
        if launcher.poll() is None:
            os.killpg(launcher.pid, 9)
            launcher.wait(timeout=30)
    wall = time.perf_counter() - t0
    with open(log_path, errors="replace") as f:
        text = f.read()
    check(rc == 0, "elastic: tools/launch.py exited %s:\n%s"
          % (rc, text[-4000:]))
    check(appended and os.path.exists(done_path),
          "elastic: the stream never grew or the job never finished")
    with open(done_path) as f:
        done = json.load(f)
    # the serving side catches up to the final publication, then the
    # unchanged re-publication is invisible to greedy decode
    for _ in range(50):
        t = time.perf_counter()
        e = rep.maybe_swap()
        if e is not None:
            applied.append(e)
            pauses.append(time.perf_counter() - t)
        if sub.applied_epoch == done["final_gen"]:
            break
        time.sleep(0.1)
    mgr = mx.CheckpointManager(prefix, ctx=dev)
    check(sub.applied_epoch == done["final_gen"] == mgr.latest(),
          "elastic: applied %s, final %s, latest %s"
          % (sub.applied_epoch, done["final_gen"], mgr.latest()))
    before = eng.generate([probe], cfg["probe_new"])
    _, args, _ = mgr.load(done["final_gen"])
    mgr.save(done["final_gen"] + 1, {k: v.asnumpy() for k, v in
                                     args.items()}, {}, mode="sync")
    t = time.perf_counter()
    e = rep.maybe_swap()
    pauses.append(time.perf_counter() - t)
    applied.append(e)
    after = eng.generate([probe], cfg["probe_new"])
    check(e == done["final_gen"] + 1 and after == before,
          "elastic: the unchanged re-publication moved greedy tokens: %r "
          "vs %r" % (after, before))
    check(len(applied) >= 2 and eng.swaps >= 2 and served >= 1,
          "elastic: %d swaps applied (%d by the engine), %d served"
          % (len(applied), eng.swaps, served))
    decode_steps = eng.decode_steps - steps0
    b5 = pa.launches["paged_attention"]
    check(b5 == (cfg["layers"] * decode_steps if on_card else 0),
          "elastic: %d B5 launches in %d decode steps" % (b5, decode_steps))
    # the membership arc: slot 1's failure and eviction, then complete
    with open(os.path.join(run_dir, "membership.json")) as f:
        trans = json.load(f)["transitions"]
    events = [(t_["event"], t_.get("slot")) for t_ in trans]
    check(("failure", 1) in events and ("evict", 1) in events and
          trans[-1]["event"] == "complete" and
          trans[-1]["world_size"] == 1 and done["world"] == 1,
          "elastic: membership arc %r" % events)
    # exactly-once effective coverage by id-set union
    total = next_id
    resumes = {}
    for name in os.listdir(out):
        if name.startswith("resume-a"):
            a = int(name.split("-")[1][1:])
            with open(os.path.join(out, name)) as f:
                resumes[a] = json.load(f)["gen"]
    attempts = sorted(resumes)
    check(len(attempts) >= 2 and resumes[attempts[0]] == 0 and
          resumes[attempts[-1]] >= 1,
          "elastic: resumes by attempt %r" % resumes)
    effective, docs = [], []
    for a in attempts:
        nxt = [b for b in attempts if b > a]
        cutoff = resumes[nxt[0]] if nxt else None
        for name in os.listdir(out):
            if not name.startswith("ids-a%d-" % a):
                continue
            with open(os.path.join(out, name)) as f:
                doc = json.load(f)
            docs.append(doc)
            if cutoff is None or (doc["gen"] != "end" and
                                  doc["gen"] <= cutoff):
                effective.extend(doc["ids"])
    check(sorted(effective) == list(range(total)),
          "elastic: effective coverage is not exactly once: %d trained, "
          "%d unique, %d records" % (len(effective), len(set(effective)),
                                     total))
    # every worker's status: the device, no kernel build, B1-B3 12 a step
    n_l = cfg["layers"]
    exits = marked_lines(log_path, ELASTIC_MARK)
    for doc in docs + exits:
        check(doc["device"] == cfg["device"] and
              doc["kernel_builds"] == 0 and
              doc["flash"] == ([n_l * doc["steps"]] * 3 if on_card
                               else [0, 0, 0]),
              "elastic: worker status %r" % {k: doc[k] for k in (
                  "slot", "attempt", "device", "steps", "flash",
                  "kernel_builds")})
    check(len(exits) == 1 and exits[0]["attempt"] == attempts[-1],
          "elastic: exit lines %r" % exits)
    with open(os.path.join(out, "kill.json")) as f:
        kill_t = json.load(f)["t"]
    with open(os.path.join(out, "first-a%d-r0.json" % attempts[-1])) as f:
        resume_s = json.load(f)["t"] - kill_t
    peaks = [d.get("peak_memory_bytes", 0) for d in docs + exits]
    gens = len([n for n in os.listdir(os.path.dirname(prefix))
                if n.endswith(".manifest.json")])
    print("elastic [%s]: tools/launch.py -n 2 --elastic: slot 1 lost one "
          "batch into generation 2, evicted, job complete at world 1 "
          "(attempts %r, resumed from generations %r); %d records trained "
          "exactly once; %d generations published (the re-publication "
          "included), %d swapped in (epochs %r), swap "
          "pause p50 %.1f ms (max %.1f), %d probes served, greedy tokens "
          "identical across the unchanged re-publication; kill to first "
          "resumed step %.3f s; peak memory a worker %.1f MiB; B5 %d "
          "launches in %d decode steps; launcher command %.1f s"
          % (card, attempts, [resumes[a] for a in attempts], total, gens,
             len(applied), applied, statistics.median(pauses) * 1e3,
             max(pauses) * 1e3, served, resume_s, max(peaks) / 2 ** 20,
             b5, decode_steps, wall))
    del eng, rep, sub, srv
    shutil.rmtree(work, ignore_errors=True)
    return {"attempts": attempts, "swaps": len(applied),
            "swap_pause_ms": [p * 1e3 for p in pauses],
            "kill_to_resume_s": resume_s, "records": total,
            "peak_mib_worker": max(peaks) / 2 ** 20,
            "publications_on_disk": gens, "launches": b5,
            "decode_steps": decode_steps,
            "flash_launches": flash_by_worker(docs + exits),
            "wall_s": wall}


def flash_by_worker(docs):
    """B1, B2, B3 launches summed over the worker processes: each
    process's status documents are cumulative, so its newest counts."""
    last = {}
    for d in docs:
        key = (d["attempt"], d["rank"])
        if key not in last or d["steps"] >= last[key]["steps"]:
            last[key] = d
    return [sum(d["flash"][k] for d in last.values()) for k in range(3)]


def training_planes_phase(dev, card, module_p50_ms):
    """Slice S4b: (a) :func:`planes_fit_phase`, (b) :func:`resume_phase`,
    (c) :func:`elastic_phase`."""
    work = tempfile.mkdtemp(prefix="planes-")
    try:
        out = {"fit": planes_fit_phase(dev, card, module_p50_ms, work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["resume"] = resume_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["elastic"] = elastic_phase(dev, card)
    return out


# -- slice S4c: the image and detection data plane ---------------------------

#: the classification .rec of the image-plane phase: IMG_RECORDS seeded
#: IMG_SIZE x IMG_SIZE images (upsampled noise plus grain, JPEG quality
#: IMG_QUALITY), one epoch of RESNET_BATCHES batches of RESNET_B
IMG_RECORDS, IMG_SIZE, IMG_QUALITY = 1536, 256, 95
#: common/data.py's get_rec_iter at train_imagenet.py's defaults
#: (--data-nthreads 4, --rgb-mean, --random-crop 1, --random-mirror 1)
IMG_THREADS, RGB_MEAN = 4, (123.68, 116.779, 103.939)
#: the nvJPEG build against the libjpeg decode of tests/fixtures/
#: jpeg_decode.npz: its chroma upsampling and colour conversion are
#: libjpeg's (csrc/ycc_rgb.h, bit-exact on libjpeg's own planes), so the
#: planes differ by the IDCT's rounding, one level at most (the grey
#: image's largest difference on an NVIDIA H100); the conversion scales a
#: chroma difference by up to 1.772, so an RGB value may move by 3.  A
#: wrong upsampling filter moves 4:2:0 images by up to 19 levels and
#: about half of their values by more than 2
NVJPEG_MAX_DIFF, NVJPEG_OVER2_SHARE = 3, 1e-3
#: example/ssd/train.py's defaults: batch 8, image 64, 150 steps, SGD lr
#: 0.02 momentum 0.9 wd 1e-4, Xavier magnitude 2, --data-train synthetic
#: (32 x batch records); its gate on the anchor-classification accuracy
SSD_B, SSD_SIZE, SSD_STEPS, SSD_LR, SSD_CLASSES = 8, 64, 150, 0.02, 2
SSD_ACC_GATE, SSD_PROFILE_STEPS = 0.75, 5


def ssd_conv_act(mx, data, name, num_filter, kernel=(3, 3), pad=(1, 1),
                 stride=(1, 1)):
    c = mx.sym.Convolution(data=data, kernel=kernel, pad=pad,
                           stride=stride, num_filter=num_filter,
                           name=name)
    b = mx.sym.BatchNorm(data=c, name=name + "_bn")
    return mx.sym.Activation(data=b, act_type="relu", name=name + "_relu")


def ssd_multibox_layer(mx, from_layers, num_classes, sizes, ratios):
    """``example/ssd/train.py``'s ``multibox_layer`` (a copy): per-scale
    class and location heads and the anchors."""
    cls_preds = []
    loc_preds = []
    anchors = []
    for i, layer in enumerate(from_layers):
        size = sizes[i]
        ratio = ratios[i]
        num_anchors = len(size) + len(ratio) - 1
        loc = mx.sym.Convolution(data=layer, kernel=(3, 3), pad=(1, 1),
                                 num_filter=num_anchors * 4,
                                 name="loc_pred_%d" % i)
        loc = mx.sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(mx.sym.Flatten(loc))
        cls = mx.sym.Convolution(data=layer, kernel=(3, 3), pad=(1, 1),
                                 num_filter=num_anchors * (num_classes + 1),
                                 name="cls_pred_%d" % i)
        cls = mx.sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(mx.sym.Reshape(
            mx.sym.Flatten(cls), shape=(0, -1, num_classes + 1)))
        anc = mx.sym.contrib.MultiBoxPrior(
            layer, sizes=tuple(size), ratios=tuple(ratio), clip=True,
            name="anchors_%d" % i)
        anchors.append(anc)
    loc_preds = mx.sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    cls_preds = mx.sym.Concat(*cls_preds, dim=1, name="multibox_cls_pred")
    cls_preds = mx.sym.transpose(cls_preds, axes=(0, 2, 1))
    anchors = mx.sym.Concat(*anchors, dim=1, name="multibox_anchors")
    return [loc_preds, cls_preds, anchors]


def ssd_symbol(mx, num_classes=2, mode="train"):
    """``example/ssd/train.py``'s ``get_ssd_symbol`` (a copy; tests/
    test_torch_ssd.py holds it equal to the example's): a 5-conv backbone,
    heads on 3 scales, MultiBoxTarget and the losses, and the
    MultiBoxDetection head that training evaluates every step."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    b1 = ssd_conv_act(mx, data, "conv1", 16)
    p1 = mx.sym.Pooling(b1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    b2 = ssd_conv_act(mx, p1, "conv2", 32)
    p2 = mx.sym.Pooling(b2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    b3 = ssd_conv_act(mx, p2, "conv3", 64)
    p3 = mx.sym.Pooling(b3, pool_type="max", kernel=(2, 2), stride=(2, 2))
    b4 = ssd_conv_act(mx, p3, "conv4", 64)
    p4 = mx.sym.Pooling(b4, pool_type="max", kernel=(2, 2), stride=(2, 2))
    b5 = ssd_conv_act(mx, p4, "conv5", 64)

    sizes = [[0.2, 0.27], [0.37, 0.45], [0.54, 0.62]]
    ratios = [[1.0, 2.0, 0.5]] * 3
    loc_preds, cls_preds, anchors = ssd_multibox_layer(
        mx, [b3, b4, b5], num_classes, sizes, ratios)

    if mode == "train":
        tmp = mx.sym.contrib.MultiBoxTarget(
            anchors, label, cls_preds, overlap_threshold=0.5,
            ignore_label=-1, negative_mining_ratio=3,
            minimum_negative_samples=0, negative_mining_thresh=0.5,
            variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
        loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
        cls_prob = mx.sym.SoftmaxOutput(
            data=cls_preds, label=cls_target,
            ignore_label=-1, use_ignore=True,
            multi_output=True, normalization="valid",
            name="cls_prob")
        loc_diff = loc_target_mask * (loc_preds - loc_target)
        loc_loss_ = mx.sym.smooth_l1(data=loc_diff, scalar=1.0,
                                     name="loc_loss_")
        loc_loss = mx.sym.MakeLoss(loc_loss_, grad_scale=1.0,
                                   normalization="valid",
                                   name="loc_loss")
        cls_label = mx.sym.MakeLoss(data=cls_target, grad_scale=0,
                                    name="cls_label")
        det = mx.sym.contrib.MultiBoxDetection(
            cls_prob, loc_preds, anchors,
            name="detection", nms_threshold=0.45, force_suppress=False,
            variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)
        det = mx.sym.MakeLoss(data=det, grad_scale=0, name="det_out")
        return mx.sym.Group([cls_prob, loc_loss, cls_label, det])
    cls_prob = mx.sym.softmax(data=cls_preds, axis=1)
    return mx.sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchors, name="detection",
        nms_threshold=0.45, variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)


def ssd_synthetic_batch(batch_size, size=64, max_obj=2, seed=0):
    """``example/ssd/train.py``'s ``synthetic_batch`` (a copy): images
    with 1-2 bright rectangles, labels ``[cls, x1, y1, x2, y2]`` padded
    with -1."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 0.1, (batch_size, 3, size, size)).astype(np.float32)
    y = np.full((batch_size, max_obj, 5), -1.0, np.float32)
    for b in range(batch_size):
        for k in range(rng.randint(1, max_obj + 1)):
            w = rng.uniform(0.25, 0.5)
            h = rng.uniform(0.25, 0.5)
            x1 = rng.uniform(0, 1 - w)
            y1 = rng.uniform(0, 1 - h)
            cls = rng.randint(0, 2)
            px = slice(int(x1 * size), int((x1 + w) * size))
            py = slice(int(y1 * size), int((y1 + h) * size))
            val = 0.9 if cls else 0.5
            x[b, :, py, px] = val
            y[b, k] = [cls, x1, y1, x1 + w, y1 + h]
    return x, y


def write_shapes_rec(mx, path, n=256, size=64, max_obj=2, seed=0):
    """``example/ssd/train.py``'s ``write_shapes_rec`` (a copy): the
    shapes dataset as a detection ``.rec`` (labels ``[2, 5, obj...]``),
    encoded by ``recordio.pack_img``."""
    recordio = mx.recordio
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.uniform(0, 25, (size, size, 3))
        objs = []
        for _ in range(rng.randint(1, max_obj + 1)):
            bw, bh = rng.uniform(0.25, 0.5, 2)
            x1 = rng.uniform(0, 1 - bw)
            y1 = rng.uniform(0, 1 - bh)
            cls = rng.randint(0, 2)
            val = 230 if cls else 128
            img[int(y1 * size):int((y1 + bh) * size),
                int(x1 * size):int((x1 + bw) * size)] = val
            objs.append([float(cls), x1, y1, x1 + bw, y1 + bh])
        flat = np.asarray([2.0, 5.0] + [v for o in objs for v in o],
                          np.float32)
        w.write(recordio.pack_img(
            recordio.IRHeader(len(flat), flat, i, 0),
            img.astype(np.uint8)[:, :, ::-1], quality=95))
    w.close()


def anchor_accuracy(mod):
    """``train.py``'s logged anchor-classification accuracy: argmax of
    ``cls_prob`` against ``cls_target`` where the target is not ignored."""
    cls_prob = mod.get_outputs()[0].asnumpy()
    cls_target = mod.get_outputs()[2].asnumpy()
    mask = cls_target >= 0
    pred = cls_prob.argmax(axis=1)
    return float((pred[mask] == cls_target[mask]).mean()) if mask.any() \
        else 0.0


def image_probe():
    """The image libraries of this machine, printed on one line, and the
    decoder the native library is meant to take here: libjpeg where
    ``jpeglib.h`` compiles, else nvJPEG where the CUDA toolkit has it."""
    from mxnet_tpu_torch import _native
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    ld = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                        timeout=60).stdout
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    probe = {"jpeglib.h": os.path.exists("/usr/include/jpeglib.h"),
             "jpeglib.h compiles": _native._has_jpeglib(),
             "ldconfig libjpeg": sorted({line.split()[0]
                                         for line in ld.splitlines()
                                         if "libjpeg" in line}),
             "PIL": pil,
             "nvjpeg.h": os.path.exists(os.path.join(cuda, "include",
                                                     "nvjpeg.h")),
             "cpu_count": os.cpu_count()}
    print("image plane probe: %s" % json.dumps(probe))
    want = "libjpeg" if probe["jpeglib.h compiles"] else \
        "nvjpeg" if probe["nvjpeg.h"] else None
    return probe, want


def decoder_check(want, card):
    """Builds and loads the native library, fails unless it took the
    decoder ``want``, and holds its decode of the committed fixture
    against the libjpeg decode saved with it."""
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.image.image import _native_decode
    import PIL
    t = time.perf_counter()
    lib = _native.get_lib()
    build_s = time.perf_counter() - t
    print("image plane [%s]: native library %s, decoder %s (meant: %s), "
          "built and loaded in %.1f s; packer: recordio.pack_img through "
          "PIL %s" % (card, _native.loaded_path(), _native.decoder(), want,
                      build_s, PIL.__version__))
    check(lib is not None and _native.decoder() == want,
          "image plane: the native library took decoder %r, not %r: %s"
          % (_native.decoder(), want, _native.build_error()))
    z = np.load(os.path.join(REPO, "tests", "fixtures", "jpeg_decode.npz"))
    fixture = {}
    for name in sorted({k.split("/")[0] for k in z.files}):
        ref = z[name + "/pixels"]
        got = _native_decode(lib, z[name + "/jpeg"].tobytes())
        check(got is not None and got.shape == ref.shape,
              "image plane: %s decoded to %r" % (
                  name, None if got is None else got.shape))
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        fixture[name] = {"max": int(d.max()), "mean": float(d.mean()),
                         "over2": float((d > 2).mean())}
    print("image plane [%s]: %s decode of tests/fixtures/jpeg_decode.npz "
          "against libjpeg's (max |diff|, mean, share > 2): %s"
          % (card, want, "; ".join(
              "%s %d %.4f %.2e" % (n, f["max"], f["mean"], f["over2"])
              for n, f in fixture.items())))
    if want == "libjpeg":
        check(all(f["max"] == 0 for f in fixture.values()),
              "image plane: the libjpeg build differs from the fixture")
    else:
        check(all(f["max"] <= NVJPEG_MAX_DIFF and
                  f["over2"] <= NVJPEG_OVER2_SHARE
                  for f in fixture.values()),
              "image plane: the nvJPEG decode is off the fixture beyond "
              "%d levels or %g of the values past 2"
              % (NVJPEG_MAX_DIFF, NVJPEG_OVER2_SHARE))
    return {"decoder": _native.decoder(), "library": _native.loaded_path(),
            "build_s": build_s, "fixture": fixture}


def natural_image(seed, size):
    """A seeded size x size RGB image: upsampled low-resolution noise plus
    a little grain (JPEG compresses it as it does a photograph)."""
    rng = np.random.RandomState(seed)
    low = rng.uniform(0, 255, (size // 16 + 2, size // 16 + 2, 3))
    pos = np.linspace(0, low.shape[0] - 1.001, size)
    i0 = pos.astype(int)
    f = pos - i0
    rows = low[i0] * (1 - f)[:, None, None] + low[i0 + 1] * f[:, None, None]
    img = rows[:, i0] * (1 - f)[None, :, None] + \
        rows[:, i0 + 1] * f[None, :, None]
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pack_classification_rec(mx, path):
    """IMG_RECORDS seeded images packed by ``recordio.pack_img`` (labels
    ``i % 1000``) on a thread per core; returns (seconds, bytes)."""
    from concurrent.futures import ThreadPoolExecutor
    rec = mx.recordio

    def one(i):
        return rec.pack_img(rec.IRHeader(0, float(i % RESNET_CLASSES), i, 0),
                            natural_image(i, IMG_SIZE), quality=IMG_QUALITY)
    t = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        records = list(pool.map(one, range(IMG_RECORDS)))
    w = rec.MXRecordIO(path, "w")
    for r in records:
        w.write(r)
    w.close()
    return time.perf_counter() - t, sum(len(r) for r in records)


def imagenet_rec_iter(mx, path):
    """``common/data.py``'s ``get_rec_iter`` at train_imagenet.py's
    defaults, on ``path``."""
    it = mx.io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, 224, 224), batch_size=RESNET_B,
        preprocess_threads=IMG_THREADS, shuffle=True, rand_crop=True,
        rand_mirror=True, mean_r=RGB_MEAN[0], mean_g=RGB_MEAN[1],
        mean_b=RGB_MEAN[2])
    check(it.decode_path == "native" and it._lib is not None,
          "image plane: ImageRecordIter took the %s path, not the native "
          "one" % it.decode_path)
    return it


def rec_decode_phase(mx, path, card):
    """Packs the classification ``.rec``, then times ``ImageRecordIter``
    over it: decode alone (the pipeline's batches into host memory) and as
    ``fit`` takes it (each batch copied to the card)."""
    pack_s, nbytes = pack_classification_rec(mx, path)
    print("image plane [%s]: packed %d images %dx%d (JPEG q%d, %.1f MiB) "
          "into %s in %.1f s" % (card, IMG_RECORDS, IMG_SIZE, IMG_SIZE,
                                 IMG_QUALITY, nbytes / 2 ** 20,
                                 os.path.basename(path), pack_s))
    it = imagenet_rec_iter(mx, path)
    check(it.num_samples == IMG_RECORDS, "image plane: %d records read"
          % it.num_samples)
    decode = []
    for _ in range(2):
        t = time.perf_counter()
        n = 0
        while it.iter_next():
            n += RESNET_B - it.getpad()
        decode.append(n / (time.perf_counter() - t))
        it.reset()
    t = time.perf_counter()
    n = 0
    for b in it:
        x = b.data[0].data
        if n == 0:
            first = (x, b.label[0].data)
        n += RESNET_B
    torch.cuda.synchronize()
    to_card = n / (time.perf_counter() - t)
    it.reset()
    x, lab = first
    check(x.device.type == "cuda" and tuple(x.shape) ==
          (RESNET_B, 3, 224, 224) and bool(torch.isfinite(x).all()) and
          float(x.min()) >= -RGB_MEAN[0] - 1e-3 and
          float(x.max()) <= 255 - RGB_MEAN[2] + 1e-3 and
          float(x.std()) > 10 and
          bool(((lab >= 0) & (lab < RESNET_CLASSES)).all()),
          "image plane: a bad batch from ImageRecordIter")
    check(it.num_decode_errors == 0, "image plane: %d records failed to "
          "decode" % it.num_decode_errors)
    print("image plane [%s]: ImageRecordIter (native, %d threads, batch "
          "%d, 3x224x224, rand_crop, rand_mirror, --rgb-mean): decode "
          "alone %s images/s; batches copied to the card %.1f images/s"
          % (card, IMG_THREADS, RESNET_B,
             " / ".join("%.1f" % r for r in decode), to_card))
    return {"pack_s": pack_s, "rec_mib": nbytes / 2 ** 20,
            "decode_images_per_s": decode, "to_card_images_per_s": to_card}


def resnet_rec_phase(mx, path, synthetic_p50_ms, card):
    """The ResNet phase's symbol and ``Module.fit`` (kv ``device``, the
    example's SGD settings) for one epoch of RESNET_BATCHES batches fed
    by ``ImageRecordIter`` from the ``.rec``: the fit step beside the
    synthetic run's, and the time ``fit`` waits for each batch."""
    sym = resnet_symbol(mx, RESNET_CLASSES, RESNET_LAYERS, RESNET_SHAPE)
    it = imagenet_rec_iter(mx, path)
    kv = mx.kv.create("device")
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    steps, losses, waits, labels = [], [], [], []
    fit_step, next_batch = mod.fit_step, it.next

    def timed_fit_step(data_batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit_step(data_batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        labels.append(data_batch.label[0])

    def timed_next():
        t = time.perf_counter()
        try:
            return next_batch()
        finally:
            waits.append(time.perf_counter() - t)

    def per_batch(param):
        losses.append(replay_loss(mx, mod, labels[-1]))

    mod.fit_step = timed_fit_step
    it.next = timed_next
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=mx.metric.create(["accuracy"]),
            kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "wd": 1e-4,
                              "momentum": 0.9,
                              "lr_scheduler": imagenet_lr_scheduler(mx)},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=[mx.callback.Speedometer(RESNET_B, 4),
                                per_batch],
            allow_missing=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(len(steps) == RESNET_BATCHES and len(losses) == RESNET_BATCHES,
          "resnet .rec: %d fit steps" % len(steps))
    check(all(math.isfinite(x) for x in losses),
          "resnet .rec: non-finite loss %r" % losses)
    check(mod._update_on_kvstore and mod._kvstore is kv,
          "resnet .rec: fit did not update on the kvstore")
    # waits[0] is the first batch (the pipeline starting), the last one
    # the end of the epoch
    batch_waits = waits[1:RESNET_BATCHES]
    p50 = statistics.median(steps[1:]) * 1e3
    wait_p50 = statistics.median(batch_waits) * 1e3
    out = {"fit_step_p50_ms": p50, "synthetic_fit_step_p50_ms":
           synthetic_p50_ms, "step_ms": [x * 1e3 for x in steps],
           "wait_ms": [x * 1e3 for x in waits], "wait_p50_ms": wait_p50,
           "images_per_s": RESNET_B / ((p50 + wait_p50) / 1e3),
           "fit_s": fit_s, "loss": losses,
           "data_bound": wait_p50 > 0.1 * p50}
    print("resnet .rec [%s]: Module.fit from ImageRecordIter, %d batches "
          "of %d: fit step p50 %.2f ms beside the synthetic phase's %.2f "
          "ms (this run); fit waits %.2f ms p50 for a batch (waits %s ms); "
          "%.1f images/s end to end; loss by step %s; %s"
          % (card, RESNET_BATCHES, RESNET_B, p50, synthetic_p50_ms,
             wait_p50, ", ".join("%.1f" % (x * 1e3) for x in waits),
             out["images_per_s"], ", ".join("%.4f" % x for x in losses),
             "data-bound: fit waits more than a tenth of a step for data"
             if out["data_bound"] else "not data-bound: the pipeline "
             "keeps ahead of the step"))
    del mod, kv
    return out


def timed_ops(names, record):
    """Wraps the registry ops ``names`` (each OpDef's ``fn``, which the
    executor calls) in a ``record_function`` range that appends (name,
    host seconds, start event, end event) to ``record``; returns a
    function that restores them."""
    from mxnet_tpu_torch.ops import get_op
    saved = []
    for name in names:
        op = get_op(name)
        saved.append((op, op.fn))

        def wrapped(*args, _fn=op.fn, _name=name, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            with torch.profiler.record_function(_name):
                out = _fn(*args, **kw)
            end.record()
            record.append((_name, time.perf_counter() - t, start, end))
            return out
        op.fn = wrapped

    def restore():
        for op, fn in saved:
            op.fn = fn
    return restore


def ssd_phase(dev, card, work):
    """``example/ssd/train.py --data-train synthetic`` through the port:
    the shapes ``.rec`` read by ``ImageDetRecordIter`` (native, box-aware
    mirror), the SSD symbol bound by a Module on the card and trained by
    the script's loop at its defaults, with its accuracy gate; then a
    profiled window with the MultiBox ops timed."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    path = os.path.join(work, "shapes.rec")
    t = time.perf_counter()
    write_shapes_rec(mx, path, n=32 * SSD_B, size=SSD_SIZE)
    pack_s = time.perf_counter() - t
    it = mx.io.ImageDetRecordIter(
        path_imgrec=path, data_shape=(3, SSD_SIZE, SSD_SIZE),
        batch_size=SSD_B, shuffle=True, seed=0, rand_mirror=True,
        std_r=255.0, std_g=255.0, std_b=255.0)
    check(it.decode_path == "native" and it._lib is not None,
          "ssd: ImageDetRecordIter is not on the native path")
    label_shape = (SSD_B, it.max_objects, it.object_width)
    print("ssd [%s]: rec-mode: %d samples packed in %.1f s, label shape %s"
          % (card, it.num_samples, pack_s, label_shape))
    net = ssd_symbol(mx, SSD_CLASSES, mode="train")
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (SSD_B, 3, SSD_SIZE, SSD_SIZE))],
             label_shapes=[("label", label_shape)])
    mod.init_params(mx.init.Xavier(magnitude=2))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": SSD_LR,
                                         "momentum": 0.9, "wd": 1e-4})

    def next_batch():
        try:
            return next(it)
        except StopIteration:
            it.reset()
            return next(it)

    def step(batch):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    steps, accs = [], []
    for i in range(SSD_STEPS):
        batch = next_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        if i % 10 == 0:
            accs.append(anchor_accuracy(mod))
    outs = [o.data for o in mod.get_outputs()]
    det = outs[3]
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "ssd: a non-finite output")
    num_anchors = outs[0].shape[2]
    check(tuple(det.shape) == (SSD_B, num_anchors, 6) and
          bool((det[:, :, 0] >= 0).any()),
          "ssd: detections %s with none kept" % (tuple(det.shape),))
    p50 = statistics.median(steps[1:]) * 1e3
    out = {"anchors": num_anchors, "step_p50_ms": p50,
           "accuracy_by_10_steps": accs, "pack_s": pack_s,
           "detections_kept": float((det[:, :, 0] >= 0).sum(1)
                                    .float().mean())}
    print("ssd [%s]: %d steps of batch %d at %d x %d (%d anchors), lr %g: "
          "step p50 %.2f ms; anchor-cls accuracy every 10 steps %s; %.1f "
          "detections kept per image" % (
              card, SSD_STEPS, SSD_B, SSD_SIZE, SSD_SIZE, num_anchors,
              SSD_LR, p50, ", ".join("%.3f" % a for a in accs),
              out["detections_kept"]))
    check(accs[-1] > SSD_ACC_GATE, "ssd: anchor classification failed to "
          "learn (%.3f, gate %g)" % (accs[-1], SSD_ACC_GATE))

    # a profiled window, the MultiBox ops timed on the host clock and by
    # CUDA events around each call
    record = []
    names = ("_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection")
    restore = timed_ops(names, record)
    try:
        batches = [next_batch() for _ in range(SSD_PROFILE_STEPS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for b in batches:
                step(b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    finally:
        restore()
    summary = profile_summary(prof, wall_us, SSD_PROFILE_STEPS,
                              "profile ssd [%s]: step" % card)
    ranges = {e.key: e for e in prof.key_averages() if e.key in names}
    ops = {}
    for name in names:
        calls = [r for r in record if r[0] == name]
        ev = ranges.get(name)
        ops[name] = {
            "calls_per_step": len(calls) / SSD_PROFILE_STEPS,
            "host_ms_per_step": sum(r[1] for r in calls) * 1e3
            / SSD_PROFILE_STEPS,
            "device_span_ms_per_step": sum(r[2].elapsed_time(r[3])
                                           for r in calls)
            / SSD_PROFILE_STEPS,
            "profiler_device_ms_per_step": (ev.device_time_total / 1e3
                                            / SSD_PROFILE_STEPS)
            if ev is not None else None}
    step_ms = summary["step_ms"]
    share = sum(o["host_ms_per_step"] for o in ops.values()) / step_ms
    out.update({"profile": summary, "multibox": ops,
                "multibox_host_share": share})
    print("ssd [%s]: a step of %.3f ms (profiled): %s; the two ops hold "
          "%.1f%% of the step on the host clock" % (
              card, step_ms, "; ".join(
                  "%s %.0f call(s), host %.3f ms, device span %.3f ms, "
                  "profiler device %s ms" % (
                      n[len("_contrib_"):], o["calls_per_step"],
                      o["host_ms_per_step"], o["device_span_ms_per_step"],
                      "n/a" if o["profiler_device_ms_per_step"] is None
                      else "%.3f" % o["profiler_device_ms_per_step"])
                  for n, o in ops.items()), 100 * share))
    del mod
    return out


def image_plane_phase(dev, card, resnet):
    """Slice S4c: the probe and the decoder, ``ImageRecordIter`` over a
    packed ``.rec``, ResNet-50 trained from it, and SSD from
    ``ImageDetRecordIter``."""
    import mxnet_tpu_torch as mx
    probe, want = image_probe()
    out = {"probe": probe}
    out["decode"] = decoder_check(want, card)
    work = tempfile.mkdtemp(prefix="image-plane-")
    try:
        path = os.path.join(work, "train.rec")
        out["rec"] = rec_decode_phase(mx, path, card)
        out["resnet_rec"] = resnet_rec_phase(
            mx, path, resnet["fit_step_p50_ms"], card)
        gc.collect()
        torch.cuda.empty_cache()
        out["ssd"] = ssd_phase(dev, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- slice S6b: the RNN family -------------------------------------------------

#: the ``RNN`` op alone at the LM cell's widths (T 40, N 32, input 200,
#: H 200, 2 layers, fp32): (mode, bidirectional)
RNN_OP = dict(T=40, N=32, I=200, H=200, L=2)
RNN_OP_CASES = [("lstm", False), ("gru", False), ("rnn_tanh", False),
                ("rnn_relu", False), ("lstm", True)]
#: the op on the card against the same op on the CPU, and cuDNN's call
#: against the op: each side sums its matmuls in another order in fp32
#: (TF32 off), and the recurrence carries the rounding over 40 steps
#: through saturating gates, so outputs in (-1, 1) move apart by about
#: 1e-6; a gradient is held relative to the largest of its kind (the
#: weight gradients sum 1280 step terms).  A wrong gate, bias or
#: direction moves them by 1e-2 or more
RNN_OP_TOL = 1e-4
#: example/rnn/lstm_bucketing.py's defaults; the one cut is 5 epochs, not
#: its 25
LM = dict(num_hidden=200, num_embed=200, num_layers=2, batch_size=32,
          buckets=(10, 20, 30, 40), lr=0.01, wd=1e-5, n_sent=2000,
          vocab=200, kv_store="device")
LM_EPOCHS = 5
LM_SEED = 0
#: each epoch's train perplexity of the JAX package's Module on the CPU at
#: LM, LM_EPOCHS and LM_SEED (the same corpus, batches and initial
#: weights), from ``python tests/test_torch_lstm_bucketing.py reference``
#: (JAX_PLATFORMS=cpu; 305 steps)
LM_REF_PPL = [193.8232754492532, 20.42333936256808, 4.431177993844558,
              3.774152681844519, 3.623459863314133]
#: the port's epoch perplexities within 2% of those: the two runs start
#: from the same weights on the same batches and differ in the rounding of
#: every fp32 sum, which Adam's 305 steps carry on
LM_PPL_TOL = 0.02
#: the trained FusedRNNCell against its unfused SequentialRNNCell on the
#: same weights at bucket 40 (softmax probabilities, about 1/200 each):
#: two fp32 evaluations of one function in another order
LM_UNFUSE_TOL = 1e-5
#: the Gluon LM: Embedding(200 -> 200), gluon.rnn.LSTM(200, 2 layers),
#: Dense(200), hybridized, at bptt 35 and batch 32, Adam at lr 0.01
GLUON_LM = dict(vocab=200, embed=200, hidden=200, layers=2, bptt=35,
                batch=32, steps=20, lr=0.01)
#: two LSTMCells unrolled 35 steps against the fused layer on the same
#: weights (outputs in (-1, 1))
GLUON_UNROLL_TOL = 1e-5


def synthetic_corpus(n_sent=2000, vocab=200, seed=0):
    """Markov-chain sentences: token t+1 = (2*t + noise) mod vocab."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(n_sent):
        L = rng.randint(5, 40)
        s = [rng.randint(1, vocab)]
        for _ in range(L - 1):
            s.append((2 * s[-1] + rng.randint(0, 3)) % (vocab - 1) + 1)
        sents.append(s)
    return sents, vocab


def lm_sym_gen(mx, cell, vocab_size, args):
    """``lstm_bucketing.py``'s ``sym_gen`` over ``cell`` (``args``: its
    ``num_embed`` and ``num_hidden``), for either package's ``mx``."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=vocab_size,
                                 output_dim=args.num_embed, name="embed")
        cell.reset()
        outputs, states = cell.unroll(seq_len, inputs=embed,
                                      merge_outputs=True, layout="NTC")
        pred = mx.sym.Reshape(outputs, shape=(-1, args.num_hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                     name="pred")
        label_r = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label_r,
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lm_init_params(cfg, seed):
    """The LM's initial weights from a numpy seed, as the example's
    ``Xavier(factor_type="in", magnitude=2.34)`` draws them: each weight
    (the fused vector gate by gate, as the ``FusedRNN`` initializer fills
    it) uniform in +-sqrt(2.34 / fan_in), the biases 0 but the LSTM's
    i2h forget-gate bias at 1."""
    rng = np.random.RandomState(seed)
    V, E, H = cfg["vocab"], cfg["num_embed"], cfg["num_hidden"]

    def xavier(rows, fan_in):
        s = math.sqrt(2.34 / fan_in)
        return rng.uniform(-s, s, (rows, fan_in)).astype(np.float32)

    pieces = []
    for layer in range(cfg["num_layers"]):
        n_in = E if layer == 0 else H
        pieces.append(np.concatenate([xavier(H, n_in) for _ in range(4)]))
        pieces.append(np.concatenate([xavier(H, H) for _ in range(4)]))
        b_i2h = np.zeros(4 * H, np.float32)
        b_i2h[H:2 * H] = 1.0
        pieces += [b_i2h, np.zeros(4 * H, np.float32)]
    return {"embed_weight": xavier(V, E),
            "lstm_parameters": np.concatenate([p.ravel() for p in pieces]),
            "pred_weight": xavier(V, H),
            "pred_bias": np.zeros(V, np.float32)}


def lm_fit(mx, cfg, epochs, seed, ctx, sync=None):
    """``lstm_bucketing.py``'s training through either package's
    ``BucketingModule.fit``, from :func:`lm_init_params`' weights, with
    ``random`` and ``np.random`` seeded before the iterator draws its
    order: ``(module, iterator, cell, {"perplexity": [...],
    "step_s": {bucket: [...]}})``.  ``sync`` (the card's synchronize)
    runs before each step's time is read."""
    import random
    from types import SimpleNamespace
    args = SimpleNamespace(**cfg)
    sentences, vocab_size = synthetic_corpus(cfg["n_sent"], cfg["vocab"])
    random.seed(seed)
    np.random.seed(seed)
    data_train = mx.rnn.BucketSentenceIter(
        sentences, cfg["batch_size"], buckets=list(cfg["buckets"]),
        invalid_label=0)
    cell = mx.rnn.FusedRNNCell(cfg["num_hidden"],
                               num_layers=cfg["num_layers"], mode="lstm",
                               prefix="lstm_")
    model = mx.mod.BucketingModule(
        sym_gen=lm_sym_gen(mx, cell, vocab_size, args),
        default_bucket_key=data_train.default_bucket_key, context=ctx)
    metric = mx.metric.Perplexity(0)
    out = {"perplexity": [], "step_s": {}}
    last = [time.perf_counter()]

    def batch_end(param):
        if sync is not None:
            sync()
        now = time.perf_counter()
        key = param.locals["data_batch"].bucket_key
        out["step_s"].setdefault(key, []).append(now - last[0])
        last[0] = now

    def epoch_end(epoch, sym=None, arg=None, aux=None):
        out["perplexity"].append(dict(metric.get_name_value())
                                 ["perplexity"])
        last[0] = time.perf_counter()

    arg_params = {k: mx.nd.array(v, ctx=mx.cpu())
                  for k, v in lm_init_params(cfg, seed).items()}
    model.fit(
        train_data=data_train, eval_metric=metric,
        kvstore=cfg["kv_store"], optimizer="adam",
        optimizer_params={"learning_rate": cfg["lr"], "wd": cfg["wd"]},
        initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
        arg_params=arg_params, num_epoch=epochs,
        batch_end_callback=batch_end, epoch_end_callback=epoch_end)
    return model, data_train, cell, out


def rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def rnn_op_inputs(mode, bi, dev, seed):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    c = RNN_OP
    D = 2 if bi else 1
    g = torch.Generator().manual_seed(seed)
    size = rnn_param_size(c["L"], c["I"], c["H"], bi, mode)
    x = torch.rand(c["T"], c["N"], c["I"], generator=g) * 2 - 1
    p = (torch.rand(size, generator=g) * 2 - 1) / math.sqrt(c["H"])
    h0 = torch.rand(c["L"] * D, c["N"], c["H"], generator=g) - 0.5
    c0 = torch.rand(c["L"] * D, c["N"], c["H"], generator=g) - 0.5
    ins = [x, p, h0] + ([c0] if mode == "lstm" else [])
    cts = [torch.rand(c["T"], c["N"], D * c["H"], generator=g) - 0.5,
           torch.rand(c["L"] * D, c["N"], c["H"], generator=g) - 0.5,
           torch.rand(c["L"] * D, c["N"], c["H"], generator=g) - 0.5]
    return ([t.to(dev).requires_grad_() for t in ins],
            [t.to(dev) for t in cts[:3 if mode == "lstm" else 2]])


def rnn_op_call(mode, bi):
    from mxnet_tpu_torch.ops import get_op
    op = get_op("RNN")
    c = RNN_OP

    def call(ins):
        return op(*ins, state_size=c["H"], num_layers=c["L"],
                  bidirectional=bi, mode=mode, state_outputs=True,
                  _train=True)
    return call


def cudnn_call(mode, bi):
    """``torch._VF.<mode>`` (cuDNN on the card) on the op's packed
    weights, viewed as the per-layer lists it takes: the yardstick."""
    from mxnet_tpu_torch.ops.rnn import _unpack
    c = RNN_OP
    fn = {"lstm": torch._VF.lstm, "gru": torch._VF.gru,
          "rnn_tanh": torch._VF.rnn_tanh, "rnn_relu": torch._VF.rnn_relu
          }[mode]

    def call(ins):
        x, p, h0 = ins[:3]
        weights = [t for layer in _unpack(p, c["L"], c["I"], c["H"], bi,
                                          mode)
                   for d in layer for t in d]
        hx = (h0, ins[3]) if mode == "lstm" else h0
        with warnings.catch_warnings():
            # cuDNN copies the per-layer views into one buffer at every
            # call (its warning says so); the copy is part of its time
            warnings.simplefilter("ignore", UserWarning)
            out = fn(x, hx, weights, True, c["L"], 0.0, True, bi, False)
        return tuple(out)
    return call


def fwd_bwd(call, ins, cts):
    outs = call(ins)
    grads = torch.autograd.grad(outs, ins, cts)
    return list(outs), list(grads)


def call_launches(fn):
    """Device kernels one call of ``fn`` launches (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def rnn_op_case(mode, bi, dev, card):
    """The op on the card against the op on the CPU and against cuDNN's
    call, forward and backward, then timed beside cuDNN."""
    label = "%s%s" % (mode, " bidirectional" if bi else "")
    call, lib = rnn_op_call(mode, bi), cudnn_call(mode, bi)
    ins, cts = rnn_op_inputs(mode, bi, dev, seed=0)
    cpu_ins = [t.detach().cpu().requires_grad_() for t in ins]
    outs, grads = fwd_bwd(call, ins, cts)
    c_outs, c_grads = fwd_bwd(call, cpu_ins, [t.cpu() for t in cts])
    l_outs, l_grads = fwd_bwd(lib, ins, cts)
    err_cpu = max(rel_err(a.cpu(), b) for a, b in
                  zip(outs + grads, c_outs + c_grads))
    err_lib = max(rel_err(a, b) for a, b in
                  zip(outs + grads, l_outs + l_grads))
    check(err_cpu <= RNN_OP_TOL and err_lib <= RNN_OP_TOL,
          "RNN %s: card vs CPU %.3g, vs cuDNN %.3g (tolerance %g)"
          % (label, err_cpu, err_lib, RNN_OP_TOL))

    def fwd():
        with torch.no_grad():
            call(ins)

    def both():
        fwd_bwd(call, ins, cts)

    def lib_fwd():
        with torch.no_grad():
            lib(ins)

    def lib_both():
        fwd_bwd(lib, ins, cts)

    out = {"case": label, "err_vs_cpu": err_cpu, "err_vs_cudnn": err_lib,
           "fwd_ms": time_ms(fwd, reps=10, warmup=2),
           "fwd_device_ms": device_ms(fwd, reps=3),
           "fwd_launches": call_launches(fwd),
           "fwd_bwd_ms": time_ms(both, reps=10, warmup=2),
           "fwd_bwd_device_ms": device_ms(both, reps=3),
           "fwd_bwd_launches": call_launches(both),
           "cudnn_fwd_ms": time_ms(lib_fwd, reps=10, warmup=2),
           "cudnn_fwd_device_ms": device_ms(lib_fwd, reps=3),
           "cudnn_fwd_bwd_ms": time_ms(lib_both, reps=10, warmup=2),
           "cudnn_fwd_bwd_device_ms": device_ms(lib_both, reps=3)}
    print("RNN op %-21s fwd %.3f ms (device %.3f ms, %d launches), fwd+bwd "
          "%.3f ms (device %.3f ms, %d launches); cuDNN fwd %.3f ms "
          "(device %.3f ms), fwd+bwd %.3f ms (device %.3f ms); err vs CPU "
          "%.2g, vs cuDNN %.2g  [%s]"
          % (label, out["fwd_ms"], out["fwd_device_ms"],
             out["fwd_launches"], out["fwd_bwd_ms"],
             out["fwd_bwd_device_ms"], out["fwd_bwd_launches"],
             out["cudnn_fwd_ms"], out["cudnn_fwd_device_ms"],
             out["cudnn_fwd_bwd_ms"], out["cudnn_fwd_bwd_device_ms"],
             err_cpu, err_lib, card))
    return out


def lm_phase(mx, dev, card):
    """``lstm_bucketing.py`` through ``BucketingModule.fit`` on the card:
    the epoch perplexities against the reference's, the step p50 a
    bucket, peak memory, one profiled step at bucket 40, then the trained
    fused cell against its unfused stack at bucket 40."""
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model, data_train, cell, run = lm_fit(mx, LM, LM_EPOCHS, LM_SEED, None,
                                          sync=torch.cuda.synchronize)
    fit_s = time.perf_counter() - t
    ppl = run["perplexity"]
    p50 = {k: 1e3 * statistics.median(v)
           for k, v in sorted(run["step_s"].items())}
    steps = sum(len(v) for v in run["step_s"].values())
    print("lstm_bucketing on the card: %d epochs, %d steps in %.1f s; "
          "perplexity %s; step p50 %s; peak memory %.1f MiB  [%s]"
          % (LM_EPOCHS, steps, fit_s, ["%.4f" % p for p in ppl],
             {k: "%.2f ms" % v for k, v in p50.items()},
             torch.cuda.max_memory_allocated(dev) / 2 ** 20, card))
    check(len(ppl) == LM_EPOCHS and all(math.isfinite(p) for p in ppl),
          "lstm_bucketing perplexities %r" % ppl)
    check(LM_REF_PPL is not None and len(LM_REF_PPL) == LM_EPOCHS,
          "no reference perplexities")
    gaps = [abs(p - r) / r for p, r in zip(ppl, LM_REF_PPL)]
    print("  against the reference's CPU run %s: relative gaps %s"
          % (["%.4f" % r for r in LM_REF_PPL], ["%.2g" % g for g in gaps]))
    check(max(gaps) <= LM_PPL_TOL, "lstm_bucketing perplexity %r vs the "
          "reference %r (tolerance %g)" % (ppl, LM_REF_PPL, LM_PPL_TOL))
    # every bucket's module shares the default bucket's host parameters
    # and its optimizer state (its Updater)
    mods = list(model._buckets.values())
    check(len(mods) == len(LM["buckets"]) and
          all(m._arg_params is mods[0]._arg_params and
              m._updater is mods[0]._updater for m in mods),
          "a bucket trains its own parameters or optimizer state")

    data_train.reset()
    batch = next(b for b in data_train if b.bucket_key == 40)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.forward_backward(batch)
        model.update()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    profiled = profile_summary(prof, wall_us, 1,
                               "lstm_bucketing step at bucket 40")

    # the trained fused cell against its unfused stack, inference at 40
    from types import SimpleNamespace
    args, _ = model.get_params()
    args = {k: v.asnumpy() for k, v in args.items()}
    fused = lm_sym_gen(mx, cell, LM["vocab"],
                       SimpleNamespace(**LM))(40)[0]
    stack = cell.unfuse()
    unfused = lm_sym_gen(mx, stack, LM["vocab"],
                         SimpleNamespace(**LM))(40)[0]
    shapes = {"data": (LM["batch_size"], 40),
              "softmax_label": (LM["batch_size"], 40)}
    probs = []
    for sym, params in ((fused, args),
                        (unfused, stack.pack_weights(
                            cell.unpack_weights(args)))):
        exe = sym.simple_bind(dev, grad_req="null", **shapes)
        exe.copy_params_from({k: v for k, v in params.items()
                              if k in exe.arg_dict})
        probs.append(exe.forward(is_train=False, data=batch.data[0],
                                 softmax_label=batch.label[0])[0].data)
    unfuse_err = float((probs[0] - probs[1]).abs().max())
    print("  fused vs unfused at bucket 40: max abs err %.3g (tolerance "
          "%g)" % (unfuse_err, LM_UNFUSE_TOL))
    check(unfuse_err <= LM_UNFUSE_TOL, "fused vs unfused %.3g"
          % unfuse_err)
    return {"perplexity": ppl, "reference_perplexity": LM_REF_PPL,
            "ppl_gaps": gaps, "steps": steps, "fit_s": fit_s,
            "step_p50_ms": p50,
            "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
            "profile": profiled, "unfuse_err": unfuse_err}


def gluon_lm_batches(cfg):
    """The synthetic corpus as one token stream, cut into ``(bptt,
    batch)`` input and next-token target pairs (time major)."""
    sents, _ = synthetic_corpus(vocab=cfg["vocab"])
    stream = np.concatenate([np.asarray(s, np.float32) for s in sents])
    T, N = cfg["bptt"], cfg["batch"]
    cols = (len(stream) - 1) // N
    data = stream[:cols * N].reshape(N, cols).T
    target = stream[1:cols * N + 1].reshape(N, cols).T
    return [(data[i:i + T], target[i:i + T])
            for i in range(0, cols - T + 1, T)]


def gluon_lm(mx, cfg, ctx):
    """Embedding, gluon.rnn.LSTM and Dense as one hybridized block."""
    from mxnet_tpu_torch import gluon

    class LM_(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(cfg["vocab"], cfg["embed"])
                self.rnn = gluon.rnn.LSTM(cfg["hidden"],
                                          num_layers=cfg["layers"],
                                          input_size=cfg["embed"])
                self.decoder = gluon.nn.Dense(cfg["vocab"], flatten=False,
                                              in_units=cfg["hidden"])

        def forward(self, x, states):
            emb = self.embed(x)
            out, states = self.rnn(emb, states)
            return self.decoder(out), states

    net = LM_(prefix="glm_")
    net.initialize(mx.init.Uniform(0.1), ctx=ctx)
    return net


def gluon_lm_phase(mx, dev, card):
    """The Gluon LM trained 20 steps through ``Trainer`` (states detached
    between steps), then two LSTMCells unrolled 35 steps against the
    layer on its weights."""
    from mxnet_tpu_torch import gluon
    cfg = GLUON_LM
    ctx = mx.Context(dev)
    mx.random.seed(LM_SEED)
    net = gluon_lm(mx, cfg, ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": cfg["lr"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    batches = gluon_lm_batches(cfg)
    states = net.rnn.begin_state(cfg["batch"], ctx=ctx)
    losses, step_s = [], []
    for i in range(cfg["steps"]):
        x, y = batches[i % len(batches)]
        x, y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        states = [s.detach() for s in states]
        t = time.perf_counter()
        with mx.autograd.record():
            out, states = net(x, states)
            loss = loss_fn(out.reshape((-1, cfg["vocab"])),
                           y.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        step_s.append(time.perf_counter() - t)
    p50 = 1e3 * statistics.median(step_s[1:])
    print("gluon LSTM LM: %d steps, step p50 %.2f ms, losses %s  [%s]"
          % (cfg["steps"], p50, ["%.4f" % v for v in losses], card))
    check(all(math.isfinite(v) for v in losses) and
          losses[-1] < losses[0], "gluon LSTM losses %r" % losses)

    # two LSTMCells on the layer's weights, unrolled bptt steps
    H, E = cfg["hidden"], cfg["embed"]
    packed = net.rnn.parameters.data().data.detach()
    from mxnet_tpu_torch.ops.rnn import _unpack
    layers = _unpack(packed, cfg["layers"], E, H, False, "lstm")
    stack = gluon.rnn.SequentialRNNCell(prefix="gcells_")
    with stack.name_scope():
        for i in range(cfg["layers"]):
            stack.add(gluon.rnn.LSTMCell(H, input_size=E if i == 0 else H))
    stack.initialize(ctx=ctx)
    for cell, ((W, R, bW, bR),) in zip(stack, layers):
        cell.i2h_weight.set_data(mx.nd.NDArray(W.clone()))
        cell.h2h_weight.set_data(mx.nd.NDArray(R.clone()))
        cell.i2h_bias.set_data(mx.nd.NDArray(bW.clone()))
        cell.h2h_bias.set_data(mx.nd.NDArray(bR.clone()))
    emb = net.embed(mx.nd.array(batches[0][0], ctx=ctx))
    begin = net.rnn.begin_state(cfg["batch"], ctx=ctx)
    want, _ = net.rnn(emb, begin)
    got, _ = stack.unroll(cfg["bptt"], emb, layout="TNC",
                          merge_outputs=True)
    unroll_err = float((got.data - want.data).abs().max())
    print("  two LSTMCells unrolled %d steps vs the layer: max abs err "
          "%.3g (tolerance %g)" % (cfg["bptt"], unroll_err,
                                   GLUON_UNROLL_TOL))
    check(unroll_err <= GLUON_UNROLL_TOL, "cell unroll vs layer %.3g"
          % unroll_err)
    return {"losses": losses, "step_p50_ms": p50, "unroll_err": unroll_err}


def rnn_phase(dev, card):
    """Slice S6b: the ``RNN`` op's cases, ``lstm_bucketing.py`` through
    ``BucketingModule``, and the Gluon LSTM LM; TF32 off (fp32)."""
    import mxnet_tpu_torch as mx
    ops = [rnn_op_case(mode, bi, dev, card) for mode, bi in RNN_OP_CASES]
    lm = lm_phase(mx, dev, card)
    gl = gluon_lm_phase(mx, dev, card)
    return {"op": ops, "lm": lm, "gluon": gl}


# -- slice S7: the rest of the operator registry ----------------------------

def alexnet_symbol(mx, num_classes=1000, p=0.5):
    """``symbols/alexnet.py``'s ``get_symbol`` (a copy; ``p`` is the two
    ``Dropout`` layers' probability, 0.5 in the example)."""
    data = mx.sym.Variable(name="data")
    conv1 = mx.sym.Convolution(name="conv1", data=data, kernel=(11, 11),
                               stride=(4, 4), num_filter=96)
    relu1 = mx.sym.Activation(data=conv1, act_type="relu")
    lrn1 = mx.sym.LRN(data=relu1, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
    pool1 = mx.sym.Pooling(data=lrn1, pool_type="max", kernel=(3, 3),
                           stride=(2, 2))
    conv2 = mx.sym.Convolution(name="conv2", data=pool1, kernel=(5, 5),
                               pad=(2, 2), num_filter=256)
    relu2 = mx.sym.Activation(data=conv2, act_type="relu")
    lrn2 = mx.sym.LRN(data=relu2, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
    pool2 = mx.sym.Pooling(data=lrn2, kernel=(3, 3), stride=(2, 2),
                           pool_type="max")
    conv3 = mx.sym.Convolution(name="conv3", data=pool2, kernel=(3, 3),
                               pad=(1, 1), num_filter=384)
    relu3 = mx.sym.Activation(data=conv3, act_type="relu")
    conv4 = mx.sym.Convolution(name="conv4", data=relu3, kernel=(3, 3),
                               pad=(1, 1), num_filter=384)
    relu4 = mx.sym.Activation(data=conv4, act_type="relu")
    conv5 = mx.sym.Convolution(name="conv5", data=relu4, kernel=(3, 3),
                               pad=(1, 1), num_filter=256)
    relu5 = mx.sym.Activation(data=conv5, act_type="relu")
    pool3 = mx.sym.Pooling(data=relu5, kernel=(3, 3), stride=(2, 2),
                           pool_type="max")
    flatten = mx.sym.Flatten(data=pool3)
    fc1 = mx.sym.FullyConnected(name="fc1", data=flatten, num_hidden=4096)
    relu6 = mx.sym.Activation(data=fc1, act_type="relu")
    dropout1 = mx.sym.Dropout(data=relu6, p=p)
    fc2 = mx.sym.FullyConnected(name="fc2", data=dropout1, num_hidden=4096)
    relu7 = mx.sym.Activation(data=fc2, act_type="relu")
    dropout2 = mx.sym.Dropout(data=relu7, p=p)
    fc3 = mx.sym.FullyConnected(name="fc3", data=dropout2,
                                num_hidden=num_classes)
    return mx.sym.SoftmaxOutput(data=fc3, name="softmax")


#: the AlexNet cell: train_imagenet.py --network alexnet at the example's
#: defaults (3 x 224 x 224, 1000 classes, batch 128, --kv-store device, SGD
#: lr 0.1 momentum 0.9 wd 1e-4 with fit.py's step schedule), fp32 with TF32
#: off, for ALEX_BATCHES replays of SyntheticDataIter's batch
ALEX_CLASSES, ALEX_SHAPE, ALEX_B, ALEX_BATCHES = 1000, "3,224,224", 128, 12
ALEX_PROFILE_STEPS = 3
#: each of the first ALEX_HOLD_STEPS fit steps on the card against the
#: same step on the port's CPU from the card's state before it (weights,
#: momentum and clocks; Dropout at p 0: the two devices' generators
#: differ).  The replayed batch's loss within ALEX_LOSS_TOL relative: the
#: two forwards sum the convolution windows and the 9216-wide fc1 in other
#: orders in fp32 (TF32 off).  Every weight and momentum after the step
#: within ALEX_STATE_TOL of its tensor's largest entry: of a layer's
#: millions of pre-activations a few lie within rounding of zero and take
#: the other side of the ReLU on the other device, and each such flip
#: moves the gradients by one sample's term, a share of a tensor's
#: largest entry (6.7e-3 at most, in fc2's bias and conv2's weight at the
#: first step, on an NVIDIA H100 80GB HBM3 at 700 W); a wrong op, layout
#: or update moves a tensor by the whole of itself.  (Run freely from one
#: start instead, the two runs part by a third of a weight's range within
#: three steps: lr 0.1 throws AlexNet, which has no normalization, into a
#: regime where any difference grows.)
ALEX_HOLD_STEPS, ALEX_LOSS_TOL, ALEX_STATE_TOL = 3, 1e-5, 2e-2


def xavier_params(shapes, seed, magnitude=2.0):
    """``mx.init.Xavier(rnd_type="gaussian", factor_type="in",
    magnitude)`` drawn with numpy: each weight normal with std
    ``sqrt(magnitude / fan_in)``, every bias 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            out[name] = (rng.randn(*shape) * math.sqrt(magnitude / fan_in)) \
                .astype(np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def alexnet_fit(mx, ctx, p, batches, params, sync=None):
    """``train_imagenet.py --network alexnet``'s ``Module.fit`` on ``ctx``
    from ``params`` (numpy) over ``batches`` replays of the synthetic
    batch: ``(module, batch, losses, step seconds)``."""
    shape = (ALEX_B,) + tuple(int(x) for x in ALEX_SHAPE.split(","))
    train = synthetic_data_iter(mx, ALEX_CLASSES, shape, batches)
    batch = next(iter(train))
    train.reset()
    mod = mx.mod.Module(alexnet_symbol(mx, ALEX_CLASSES, p), context=ctx)
    steps, losses = [], []
    fit_step = mod.fit_step

    def timed(data_batch):
        if sync is not None:
            sync()
        t = time.perf_counter()
        fit_step(data_batch)
        if sync is not None:
            sync()
        steps.append(time.perf_counter() - t)

    mod.fit_step = timed
    mod.fit(train, num_epoch=1, eval_metric=mx.metric.create(["accuracy"]),
            kvstore=mx.kv.create("device"), optimizer="sgd",
            optimizer_params=alexnet_sgd(mx),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in params.items()},
            batch_end_callback=lambda _: losses.append(
                replay_loss(mx, mod, batch.label[0])))
    mod.fit_step = fit_step
    return mod, batch, losses, steps


def alexnet_sgd(mx):
    """train_imagenet.py's optimizer settings (fit.py's step schedule)."""
    return {"learning_rate": 0.1, "wd": 1e-4, "momentum": 0.9,
            "lr_scheduler": imagenet_lr_scheduler(mx)}


def alexnet_module(mx, ctx, params):
    """AlexNet (Dropout at 0) bound, initialized from ``params`` and
    ready to step on ``ctx``, updating on a ``device`` KVStore as
    ``fit`` would."""
    shape = (ALEX_B,) + tuple(int(x) for x in ALEX_SHAPE.split(","))
    mod = mx.mod.Module(alexnet_symbol(mx, ALEX_CLASSES, 0.0), context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (ALEX_B,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(kvstore=mx.kv.create("device"), optimizer="sgd",
                       optimizer_params=alexnet_sgd(mx))
    return mod


def module_state(mod):
    """A kvstore-updated Module's weights and optimizer states, on the
    host: ``({name: tensor}, {name: state})``."""
    kv = mod._kvstore

    def host(st):
        if isinstance(st, (tuple, list)):
            return type(st)(host(x) for x in st)
        return None if st is None else st.detach().cpu().clone()

    return ({n: kv._store[n].data.detach().cpu().clone()
             for n in mod._param_names},
            {k: host(v) for k, v in kv._updater.states.items()})


def set_module_state(mod, weights, states):
    """Put :func:`module_state`'s weights and states into ``mod``'s store
    and executor (a state moves to its weight's device at its next
    update)."""
    kv = mod._kvstore
    with torch.no_grad():
        for n, w in weights.items():
            kv._store[n].data.copy_(w)
            mod._exec.arg_dict[n].data.copy_(w)
    kv._updater.states = dict(states)


def state_rel_err(a, b):
    """Max over tensors (and state parts) of max |a - b| / max |b|."""
    if isinstance(b, (tuple, list)):
        return max([state_rel_err(x, y) for x, y in zip(a, b)] or [0.0])
    if b is None:
        return 0.0
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def worst_tensor(got, want):
    """``(name, error)`` of the tensor of ``want`` that ``got`` misses
    most (:func:`state_rel_err`)."""
    return max(((k, state_rel_err(got[k], want[k])) for k in want),
               key=lambda kv: kv[1], default=("", 0.0))


def alexnet_shapes(mx):
    shape = (ALEX_B,) + tuple(int(x) for x in ALEX_SHAPE.split(","))
    sym = alexnet_symbol(mx, ALEX_CLASSES)
    arg, _, _ = sym.infer_shape(data=shape, softmax_label=(ALEX_B,))
    return {n: tuple(s) for n, s in zip(sym.list_arguments(), arg)
            if n not in ("data", "softmax_label")}


def lrn_device_ms(dev):
    """AlexNet's two LRN layers at the fit step's shapes, forward and
    backward, each in device time a step (a profile window)."""
    from mxnet_tpu_torch.ops import get_op
    lrn = get_op("LRN")
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand(s, device=dev, generator=g).requires_grad_(True)
          for s in ((ALEX_B, 96, 54, 54), (ALEX_B, 256, 27, 27))]
    kw = dict(alpha=0.0001, beta=0.75, knorm=2, nsize=5)
    outs = [lrn(x, **kw) for x in xs]
    cts = [torch.rand_like(o) for o in outs]

    def fwd():
        with torch.no_grad():
            for x in xs:
                lrn(x, **kw)

    def bwd():
        torch.autograd.grad(outs, xs, cts, retain_graph=True)

    return {"forward_ms": device_ms(fwd, reps=5),
            "backward_ms": device_ms(bwd, reps=5)}


def alexnet_phase(mx, dev, card):
    """AlexNet through ``Module.fit`` on the card: the first steps held
    against the port's CPU run (Dropout at 0), then the example's run of
    ALEX_BATCHES steps with its Dropout, a profile window, LRN's time."""
    from torch.profiler import ProfilerActivity, profile
    params = xavier_params(alexnet_shapes(mx), seed=0)
    out = {"params": int(sum(int(np.prod(v.shape)) for v in params.values()))}
    # the held steps: each step on the card and on the CPU from the card's
    # state before it, Dropout at p 0
    shape = (ALEX_B,) + tuple(int(x) for x in ALEX_SHAPE.split(","))
    batch = next(iter(synthetic_data_iter(mx, ALEX_CLASSES, shape, 1)))
    card_mod = alexnet_module(mx, mx.gpu(0), params)
    cpu_mod = alexnet_module(mx, mx.cpu(), params)
    held = []
    for _ in range(ALEX_HOLD_STEPS):
        set_module_state(cpu_mod, *module_state(card_mod))
        t = time.perf_counter()
        cpu_mod.fit_step(batch)
        cpu_s = time.perf_counter() - t
        card_mod.fit_step(batch)
        torch.cuda.synchronize()
        lc = replay_loss(mx, card_mod, batch.label[0])
        lp = replay_loss(mx, cpu_mod, batch.label[0])
        (wc, sc), (wp, sp) = module_state(card_mod), module_state(cpu_mod)
        held.append({"loss_card": lc, "loss_cpu": lp,
                     "loss_err": abs(lc - lp) / max(abs(lp), 1e-30),
                     "weight": worst_tensor(wc, wp),
                     "momentum": worst_tensor(sc, sp),
                     "cpu_step_s": cpu_s})
    del card_mod, cpu_mod
    gc.collect()
    torch.cuda.empty_cache()
    out["held"] = held
    print("alexnet [%s]: %d parameters; %d fit steps at Dropout 0, each on "
          "the card and on the port's CPU from the card's state before it: "
          "losses %s vs %s, relative gaps %s (ALEX_LOSS_TOL %g); the worst "
          "weight and momentum after each step, max |card - cpu| of its "
          "max |cpu|: %s (ALEX_STATE_TOL %g)"
          % (card, out["params"], ALEX_HOLD_STEPS,
             ["%.6f" % h["loss_card"] for h in held],
             ["%.6f" % h["loss_cpu"] for h in held],
             ["%.3g" % h["loss_err"] for h in held], ALEX_LOSS_TOL,
             ["%s %.3g, %s %.3g" % (h["weight"] + h["momentum"])
              for h in held], ALEX_STATE_TOL))
    check(all(math.isfinite(h["loss_card"]) and math.isfinite(h["loss_cpu"])
              for h in held), "alexnet: non-finite held loss")
    check(all(h["loss_err"] <= ALEX_LOSS_TOL for h in held),
          "alexnet: a card step's loss left the CPU's")
    check(all(h["weight"][1] <= ALEX_STATE_TOL and
              h["momentum"][1] <= ALEX_STATE_TOL for h in held),
          "alexnet: a card step's update left the CPU's")

    # the example's run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod, batch, losses, steps = alexnet_fit(
        mx, mx.gpu(0), 0.5, ALEX_BATCHES, params, torch.cuda.synchronize)
    out["fit_s"] = time.perf_counter() - t0
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    check(all(a.data.device.type == dev.type
              for a in mod._exec.arg_dict.values()),
          "alexnet: an executor array is not on %s" % dev)
    check(mod._update_on_kvstore, "alexnet: fit did not update on the store")
    steady = steps[1:]
    out.update({"step_ms": [x * 1e3 for x in steps],
                "fit_step_p50_ms": statistics.median(steady) * 1e3,
                "images_per_s": ALEX_B / statistics.median(steady),
                "loss": losses})
    print("alexnet [%s]: Module(context=mx.gpu(0)).fit, kv 'device', batch "
          "%d x %s, %d batches: fit step p50 %.2f ms (steps %s ms), %.1f "
          "images/s, fit %.1f s, peak device memory %.1f MiB; loss on the "
          "replayed batch by step %s"
          % (card, ALEX_B, ALEX_SHAPE, ALEX_BATCHES, out["fit_step_p50_ms"],
             ", ".join("%.1f" % x for x in out["step_ms"]),
             out["images_per_s"], out["fit_s"], out["peak_mib"],
             ", ".join("%.4f" % x for x in losses)))
    # lr 0.1 diverges (the replayed batch's loss reaches NaN within the
    # 12 steps on the card): the held steps above check the values
    check(len(steps) == ALEX_BATCHES and len(losses) == ALEX_BATCHES and
          all(math.isfinite(x) for x in losses[:ALEX_HOLD_STEPS]),
          "alexnet: %d steps, losses %r" % (len(steps), losses))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ALEX_PROFILE_STEPS):
            mod.fit_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    out["profile"] = profile_summary(prof, wall_us, ALEX_PROFILE_STEPS,
                                     "profile alexnet [%s]: fit step" % card)
    del mod, prof
    gc.collect()
    torch.cuda.empty_cache()
    out["lrn"] = lrn_device_ms(dev)
    lrn_ms = out["lrn"]["forward_ms"] + out["lrn"]["backward_ms"]
    print("alexnet [%s]: LRN (both layers) %.3f ms forward + %.3f ms "
          "backward of device time a step, %.1f%% of the step's device time"
          % (card, out["lrn"]["forward_ms"], out["lrn"]["backward_ms"],
             100 * lrn_ms / max(out["profile"]["device_busy_ms_per_step"],
                                1e-9)))
    return out


#: matrix_fact.py's defaults
MF = dict(num_users=200, num_items=150, factor=8, batch=128, lr=0.1,
          epochs=10, n=6000, n_train=5000, seed=0)
#: each epoch's training and validation RMSE of the JAX package's Module
#: on the CPU at MF from mf_params' weights, from ``python
#: tests/test_torch_alexnet.py reference`` (JAX_PLATFORMS=cpu; 400 steps)
MF_REF_RMSE = {
    "train": [1.3425443172454834, 1.1193815469741821, 0.8744744062423706,
              0.7501404285430908, 0.674379289150238, 0.6019981503486633,
              0.5598129034042358, 0.5652643442153931, 0.6037545800209045,
              0.6519193649291992],
    "val": [1.3438916206359863, 1.1898196935653687, 1.021957278251648,
            0.9198399782180786, 0.838800311088562, 0.6951230764389038,
            0.6385830640792847, 0.6348639726638794, 0.647753119468689,
            0.7349401712417603]}
#: the port's epoch RMSEs within 0.5% of those: the same weights, batches
#: and Adam steps in another summation order (fp32)
MF_RMSE_TOL = 0.005
#: custom_softmax.py's defaults (60 steps: 15 epochs of 4 batches of 32)
CS = dict(steps=60, batch=32, lr=0.5, seed=0)
#: each epoch's training accuracy and the final score of the JAX
#: package's Module on the CPU at CS (same data, order and weights), from
#: the same command
CS_REF_ACC = {
    "acc": [0.3359375, 0.3984375, 0.4921875, 0.609375, 0.734375, 0.796875,
            0.828125, 0.84375, 0.8515625, 0.84375, 0.8359375, 0.84375,
            0.8515625, 0.8515625, 0.8671875],
    "score": 0.8671875}
#: the example's own gate
CS_GATE = 0.8
#: the port's epoch accuracies within one sample in 128 of the
#: reference's (a prediction at the decision boundary may flip on
#: rounding)
CS_ACC_TOL = 1.0 / 128


def mf_symbol(mx, num_users, num_items, factor):
    """``example/recommenders/matrix_fact.py``'s ``build_symbol`` (a
    copy)."""
    user = mx.sym.Variable("user")
    item = mx.sym.Variable("item")
    score = mx.sym.Variable("score_label")
    u = mx.sym.Embedding(user, input_dim=num_users, output_dim=factor,
                         name="user_embed")
    i = mx.sym.Embedding(item, input_dim=num_items, output_dim=factor,
                         name="item_embed")
    pred = mx.sym.sum(u * i, axis=1)
    return mx.sym.LinearRegressionOutput(pred, score, name="lro")


def mf_ratings(num_users, num_items, factor, n, rng):
    """``matrix_fact.py``'s ``synthetic_ratings`` (a copy)."""
    U = rng.randn(num_users, factor).astype(np.float32) * 0.7
    V = rng.randn(num_items, factor).astype(np.float32) * 0.7
    users = rng.randint(0, num_users, n)
    items = rng.randint(0, num_items, n)
    scores = (U[users] * V[items]).sum(1) + 0.05 * rng.randn(n)
    return (users.astype(np.float32), items.astype(np.float32),
            scores.astype(np.float32))


def mf_params(cfg):
    """The example's ``mx.init.Normal(0.1)`` drawn with numpy."""
    rng = np.random.RandomState(cfg["seed"] + 1)
    return {"user_embed_weight": (rng.randn(cfg["num_users"], cfg["factor"])
                                  * 0.1).astype(np.float32),
            "item_embed_weight": (rng.randn(cfg["num_items"], cfg["factor"])
                                  * 0.1).astype(np.float32)}


def mf_fit(mx, cfg, ctx, sync=None):
    """``matrix_fact.py``'s training through either package's
    ``Module.fit`` (Adam, RMSE, validation each epoch) from
    :func:`mf_params`: ``{"train": [...], "val": [...], "step_s":
    [...]}``, each epoch's RMSE."""
    np.random.seed(cfg["seed"])   # NDArrayIter shuffles with np.random
    mx.random.seed(cfg["seed"])
    rng = np.random.RandomState(cfg["seed"])
    users, items, scores = mf_ratings(cfg["num_users"], cfg["num_items"],
                                      cfg["factor"], cfg["n"], rng)
    k = cfg["n_train"]
    train = mx.io.NDArrayIter({"user": users[:k], "item": items[:k]},
                              {"score_label": scores[:k]}, cfg["batch"],
                              shuffle=True)
    val = mx.io.NDArrayIter({"user": users[k:], "item": items[k:]},
                            {"score_label": scores[k:]}, cfg["batch"])
    mod = mx.mod.Module(mf_symbol(mx, cfg["num_users"], cfg["num_items"],
                                  cfg["factor"]),
                        data_names=["user", "item"],
                        label_names=["score_label"], context=ctx)
    metric = mx.metric.RMSE()
    out = {"train": [], "val": [], "step_s": []}
    last = [time.perf_counter()]

    def batch_end(_):
        if sync is not None:
            sync()
        now = time.perf_counter()
        out["step_s"].append(now - last[0])
        last[0] = now

    def epoch_end(*_):
        out["train"].append(float(dict(metric.get_name_value())["rmse"]))

    def eval_end(param):
        out["val"].append(float(dict(param.eval_metric.get_name_value())
                                ["rmse"]))
        last[0] = time.perf_counter()

    mod.fit(train, eval_data=val, num_epoch=cfg["epochs"], optimizer="adam",
            optimizer_params={"learning_rate": cfg["lr"]},
            initializer=mx.init.Normal(0.1), eval_metric=metric,
            arg_params={n: mx.nd.array(v, ctx=mx.cpu())
                        for n, v in mf_params(cfg).items()},
            batch_end_callback=batch_end, epoch_end_callback=epoch_end,
            eval_end_callback=eval_end)
    return out


def register_numpy_softmax(mx):
    """``example/numpy-ops/custom_softmax.py``'s ``NumpySoftmax`` op
    registered as ``numpy_softmax`` in ``mx`` (a copy)."""
    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0].asnumpy().copy()
            y = in_data[1].asnumpy().astype(int)
            p[np.arange(y.shape[0]), y] -= 1.0
            self.assign(in_grad[0], req[0], p / y.shape[0])

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


def cs_fit(mx, cfg, ctx, sync=None):
    """``custom_softmax.py``'s training through either package's
    ``Module.fit`` (the op registered by :func:`register_numpy_softmax`),
    the iterator's order and the initial weights from numpy seeds:
    ``{"acc": [...], "score": x, "step_s": [...]}``."""
    register_numpy_softmax(mx)
    rng = np.random.RandomState(cfg["seed"])
    W = rng.randn(8, 3).astype(np.float32)
    X = rng.randn(cfg["batch"] * 4, 8).astype(np.float32)
    Y = (X @ W).argmax(axis=1).astype(np.float32)
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    fc = mx.sym.FullyConnected(data, name="fc", num_hidden=3)
    net = mx.sym.Custom(fc, label, op_type="numpy_softmax", name="softmax")
    np.random.seed(cfg["seed"])
    train = mx.io.NDArrayIter(X, Y, cfg["batch"], shuffle=True,
                              label_name="softmax_label")
    init = np.random.RandomState(cfg["seed"] + 1)
    params = {"fc_weight": init.uniform(-0.07, 0.07, (3, 8))
              .astype(np.float32), "fc_bias": np.zeros(3, np.float32)}
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["softmax_label"], context=ctx)
    metric = mx.metric.Accuracy()
    out = {"acc": [], "step_s": []}
    last = [time.perf_counter()]

    def batch_end(_):
        if sync is not None:
            sync()
        now = time.perf_counter()
        out["step_s"].append(now - last[0])
        last[0] = now

    mod.fit(train, num_epoch=max(1, cfg["steps"] // 4), optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"]},
            eval_metric=metric,
            arg_params={n: mx.nd.array(v, ctx=mx.cpu())
                        for n, v in params.items()},
            batch_end_callback=batch_end,
            epoch_end_callback=lambda *_: out["acc"].append(
                float(metric.get()[1])))
    out["score"] = float(dict(mod.score(train, mx.metric.Accuracy()))
                         ["accuracy"])
    return out


def examples_phase(mx, dev, card):
    """matrix_fact.py and custom_softmax.py through ``Module.fit`` on the
    card, each against the reference's CPU run kept in this file."""
    t = time.perf_counter()
    mf = mf_fit(mx, MF, mx.gpu(0), sync=torch.cuda.synchronize)
    mf["fit_s"] = time.perf_counter() - t
    mf["step_p50_ms"] = statistics.median(mf.pop("step_s")) * 1e3
    check(MF_REF_RMSE is not None, "no reference RMSEs")
    gaps = [abs(a - b) / b for key in ("train", "val")
            for a, b in zip(mf[key], MF_REF_RMSE[key])]
    mf["max_gap"] = max(gaps)
    print("matrix_fact [%s]: %d epochs in %.1f s, step p50 %.3f ms; train "
          "RMSE %s, validation %s; against the reference's CPU run "
          "(train %s, validation %s): max relative gap %.3g (tolerance %g)"
          % (card, MF["epochs"], mf["fit_s"], mf["step_p50_ms"],
             ["%.4f" % x for x in mf["train"]],
             ["%.4f" % x for x in mf["val"]],
             ["%.4f" % x for x in MF_REF_RMSE["train"]],
             ["%.4f" % x for x in MF_REF_RMSE["val"]], mf["max_gap"],
             MF_RMSE_TOL))
    check(len(mf["train"]) == len(mf["val"]) == MF["epochs"] and
          max(gaps) <= MF_RMSE_TOL, "matrix_fact: RMSE %r vs %r"
          % (mf, MF_REF_RMSE))

    # custom_softmax.py, the Custom op's host time a call beside the step
    from mxnet_tpu_torch import operator as op_mod
    fn = op_mod._CustomFunction
    host = {"s": 0.0, "calls": 0}
    raw = (fn.forward, fn.backward)

    def timed(f):
        def run(*args):
            t = time.perf_counter()
            try:
                return f(*args)
            finally:
                host["s"] += time.perf_counter() - t
                host["calls"] += 1
        return staticmethod(run)

    fn.forward, fn.backward = timed(raw[0]), timed(raw[1])
    try:
        t = time.perf_counter()
        cs = cs_fit(mx, CS, mx.gpu(0), sync=torch.cuda.synchronize)
        cs["fit_s"] = time.perf_counter() - t
    finally:
        fn.forward, fn.backward = staticmethod(raw[0]), staticmethod(raw[1])
    cs["step_p50_ms"] = statistics.median(cs.pop("step_s")) * 1e3
    cs["custom_host_ms_per_call"] = 1e3 * host["s"] / max(host["calls"], 1)
    cs["custom_calls"] = host["calls"]
    check(CS_REF_ACC is not None, "no reference accuracies")
    cs["max_gap"] = max(abs(a - b) for a, b in
                        zip(cs["acc"] + [cs["score"]],
                            CS_REF_ACC["acc"] + [CS_REF_ACC["score"]]))
    print("custom_softmax [%s]: %d epochs in %.1f s, step p50 %.3f ms, the "
          "Custom op %.3f ms of host time a call (forward or backward, %d "
          "calls); accuracy by epoch %s, final %.4f (gate > %g); the "
          "reference's CPU run %s, final %.4f: max gap %.4f (tolerance %.4f)"
          % (card, len(cs["acc"]), cs["fit_s"], cs["step_p50_ms"],
             cs["custom_host_ms_per_call"], cs["custom_calls"],
             ["%.4f" % x for x in cs["acc"]], cs["score"], CS_GATE,
             ["%.4f" % x for x in CS_REF_ACC["acc"]], CS_REF_ACC["score"],
             cs["max_gap"], CS_ACC_TOL))
    check(cs["score"] > CS_GATE, "custom_softmax: accuracy %.4f"
          % cs["score"])
    check(cs["max_gap"] <= CS_ACC_TOL, "custom_softmax: accuracies %r vs "
          "the reference's %r" % (cs, CS_REF_ACC))
    check(cs["custom_calls"] > 0, "custom_softmax: the Custom op never ran")
    return {"matrix_fact": mf, "custom_softmax": cs}


#: the sweep of this slice's operators on the card: each case of
#: ``tests/torch_op_cases.py`` on CUDA tensors against the same call on
#: the CPU, forward and, for float inputs, the gradients under one seeded
#: head gradient; values within SWEEP_TOL and gradients (and linalg, and
#: the full-size cases) within SWEEP_GRAD_TOL, relative to the larger of 1
#: and the largest value (two fp32 evaluations in other orders); index and
#: integer outputs exactly
SWEEP_TOL, SWEEP_GRAD_TOL = 1e-5, 1e-4
#: draws of each sampler on the card: its mean and variance within 6
#: standard errors of the distribution's
SAMPLER_DRAWS = 10 ** 6
#: Faster R-CNN's RPN at test time (py-faster-rcnn's test config, the
#: reference op's defaults but the scales): a 600 x 1000 image, its
#: 38 x 63 stride-16 map, 9 anchors
RPN_FULL = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                threshold=0.7, rpn_min_size=16, scales=(8.0, 16.0, 32.0),
                ratios=(0.5, 1.0, 2.0), feature_stride=16,
                output_score=True)
RPN_MAP, RPN_IM = (38, 63), (600.0, 1000.0, 1.0)
#: Deformable ConvNets' R-FCN res5 deformable 3 x 3 convolution (512 ->
#: 512 channels, dilate 2, pad 2) on that 38 x 63 map
DCN_FULL = dict(kernel=(3, 3), num_filter=512, pad=(2, 2), dilate=(2, 2))


def op_cases():
    """The path to ``tests/torch_op_cases.py`` (numpy only)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_op_cases
    return torch_op_cases


def sweep_rel_err(got, want):
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if got.numel() == 0:
        return 0.0
    diff = (got - want).abs()
    diff = torch.where(torch.isnan(got) & torch.isnan(want),
                       torch.zeros_like(diff), diff)
    diff = torch.where(torch.isnan(diff), torch.full_like(diff, math.inf),
                       diff)
    scale = max(1.0, float(want[torch.isfinite(want)].abs().max())
                if bool(torch.isfinite(want).any()) else 1.0)
    return float(diff.max()) / scale


def sweep_run(name, arrays, params, fixed, dev, cts=None, seed=0):
    """One call of op ``name`` on ``dev``: ``(outputs, gradients, head
    gradients)``; the head gradients are drawn for float outputs when
    not given."""
    from mxnet_tpu_torch.ops import get_op
    ts, grad_in = [], []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.array(a)).to(dev)
        if t.is_floating_point() and i not in fixed:
            t.requires_grad_(True)
            grad_in.append(t)
        ts.append(t)
    op = get_op(name)
    kw = dict(params)
    if op.takes_device:
        kw["_device"] = dev
    with torch.set_grad_enabled(bool(grad_in)):
        out = op(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if cts is None:
        rng = np.random.RandomState(seed + 1)
        cts = [rng.uniform(-1, 1, tuple(o.shape)).astype(np.float32)
               if o.is_floating_point() else None for o in outs]
    used = [(o, torch.from_numpy(c).to(o.dtype).to(dev))
            for o, c in zip(outs, cts) if c is not None and o.requires_grad]
    grads = []
    if used and grad_in:
        grads = torch.autograd.grad([o for o, _ in used], grad_in,
                                    [c for _, c in used], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(grad_in, grads)]
    return [o.detach() for o in outs], grads, cts


def sweep_case(cid, name, arrays, params, fixed, dev, tol, grad_tol):
    """``name`` on the card against the CPU; returns the case's largest
    error and fails on a disagreement or an output off the card."""
    c_outs, c_grads, cts = sweep_run(name, arrays, params, fixed, "cpu")
    g_outs, g_grads, _ = sweep_run(name, arrays, params, fixed, dev, cts)
    check(all(t.device.type == dev.type for t in g_outs + list(g_grads)),
          "sweep %s: a result is not on %s" % (cid, dev))
    err = 0.0
    for i, (g, c) in enumerate(zip(g_outs, c_outs)):
        check(g.shape == c.shape and g.dtype == c.dtype,
              "sweep %s output %d: %s %s vs %s %s"
              % (cid, i, tuple(g.shape), g.dtype, tuple(c.shape), c.dtype))
        if c.is_floating_point():
            e = sweep_rel_err(g, c)
            check(e <= tol, "sweep %s output %d: error %.3g > %g"
                  % (cid, i, e, tol))
            err = max(err, e)
        else:
            check(torch.equal(g.cpu(), c), "sweep %s output %d differs"
                  % (cid, i))
    check(len(g_grads) == len(c_grads), "sweep %s: gradients" % cid)
    for i, (g, c) in enumerate(zip(g_grads, c_grads)):
        e = sweep_rel_err(g, c)
        check(e <= grad_tol, "sweep %s gradient %d: error %.3g > %g"
              % (cid, i, e, grad_tol))
        err = max(err, e)
    return err


def proposal_holds(cid, got, want):
    """Proposal's kept set on the card equals the CPU's: each row's batch
    index and score exactly, its corners to fp32 rounding."""
    check(torch.equal(got[0][:, 0].cpu(), want[0][:, 0]),
          "%s: batch column differs" % cid)
    check(torch.allclose(got[0][:, 1:].cpu(), want[0][:, 1:], rtol=1e-6,
                         atol=1e-4), "%s: the kept boxes differ" % cid)
    if len(got) > 1:
        check(torch.equal(got[1].cpu(), want[1]),
              "%s: the kept scores differ" % cid)


def sampler_sweep(dev, cases):
    """Every sampler on the card by its moments over SAMPLER_DRAWS draws,
    its dtype, device and seed repeatability."""
    from mxnet_tpu_torch import random as rnd
    from mxnet_tpu_torch.ops import get_op
    worst = 0.0

    def hold(x, mean, var, what):
        x = x.double()
        n = x.numel()
        se_mean = math.sqrt(var / n)
        se_var = math.sqrt(max(float(((x - x.mean()) ** 4).mean())
                               - var ** 2, 1e-12) / n)
        z = max(abs(float(x.mean()) - mean) / se_mean,
                abs(float(x.var(unbiased=False)) - var) / se_var)
        check(z <= 6, "sampler %s: moments %.6g, %.6g vs %.6g, %.6g"
              % (what, float(x.mean()), float(x.var()), mean, var))
        return z

    for cid, name, params, mean, var, _ in cases.SAMPLER_CASES:
        op = get_op(name)
        draws = []
        for _ in range(2):
            rnd.seed(7)
            draws.append(op(_device=dev, shape=(SAMPLER_DRAWS,), **params))
        x = draws[0]
        check(x.device.type == dev.type and x.dtype == torch.float32 and
              tuple(x.shape) == (SAMPLER_DRAWS,),
              "sampler %s: %s %s %s" % (cid, x.device, x.dtype, x.shape))
        check(torch.equal(draws[0], draws[1]), "sampler %s: the same seed "
              "drew other values" % cid)
        worst = max(worst, hold(x, mean, var, cid))
    for name, pars, moments, _ in cases.PER_ROW_CASES:
        args = [torch.from_numpy(p).to(dev) for p in pars]
        x = get_op(name)(*args, shape=(SAMPLER_DRAWS // 2,))
        check(x.device.type == dev.type and
              tuple(x.shape) == (2, SAMPLER_DRAWS // 2),
              "sampler %s: %s %s" % (name, x.device, x.shape))
        for row in range(2):
            mean, var = moments(*[float(p[row]) for p in pars])
            worst = max(worst, hold(x[row], mean, var,
                                    "%s row %d" % (name, row)))
    probs = torch.from_numpy(cases.MULTINOMIAL_PROBS).to(dev)
    ids, logp = get_op("sample_multinomial")(
        probs, shape=(SAMPLER_DRAWS // 2,), get_prob=True)
    check(ids.dtype == torch.int32 and ids.device.type == dev.type,
          "sample_multinomial: %s %s" % (ids.dtype, ids.device))
    n = ids.shape[1]
    for row in range(2):
        for k in range(probs.shape[1]):
            p = float(probs[row, k])
            se = math.sqrt(max(p * (1 - p), 1e-12) / n)
            z = abs(float((ids[row] == k).double().mean()) - p) / se
            check(z <= 6, "sample_multinomial row %d class %d: %.6f vs %.6f"
                  % (row, k, float((ids[row] == k).double().mean()), p))
            worst = max(worst, z)
    return worst


def op_sweep_phase(dev, card):
    """Every case of ``tests/torch_op_cases.py`` (each of the 135 names of
    this slice) on the card against the CPU, the samplers by their
    moments, ``Custom`` on CUDA tensors."""
    from mxnet_tpu_torch.ops import list_ops
    import mxnet_tpu_torch as mx
    cases = op_cases()
    check(set(cases.S7_OPS) <= set(list_ops()) and
          set(cases.S7_OPS) == cases.covered_ops(),
          "sweep: the cases do not cover the slice's operators")
    t0 = time.perf_counter()
    swept, worst = set(), {"forward_or_grad": 0.0}
    tables = cases.TENSOR_CASES + cases.NN_CASES + cases.TAIL_CASES + \
        cases.RCNN_CASES
    for cid, name, spec, params, fixed in tables:
        arrays = cases.make_inputs(spec, seed=len(cid))
        la = name.lstrip("_").startswith("linalg")
        e = sweep_case(cid, name, arrays, params, fixed, dev,
                       SWEEP_GRAD_TOL if la else SWEEP_TOL, SWEEP_GRAD_TOL)
        worst["forward_or_grad"] = max(worst["forward_or_grad"], e)
        swept.add(name)
    for cid, name, arrays, params in cases.PROPOSAL_CASES:
        c_outs, _, _ = sweep_run(name, arrays, params, (0, 1, 2), "cpu")
        g_outs, _, _ = sweep_run(name, arrays, params, (0, 1, 2), dev)
        check(all(o.device.type == dev.type for o in g_outs),
              "sweep %s: a result is not on %s" % (cid, dev))
        proposal_holds(cid, g_outs, c_outs)
        swept.add(name)
    worst["sampler_z"] = sampler_sweep(dev, cases)
    swept |= {c[1] for c in cases.SAMPLER_CASES}
    swept |= {c[0] for c in cases.PER_ROW_CASES} | {"sample_multinomial"}
    # Custom: custom_softmax.py's op on CUDA tensors against the CPU
    register_numpy_softmax(mx)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 3).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    e = sweep_case("Custom", "Custom", [x, y], {"op_type": "numpy_softmax"},
                   (1,), dev, SWEEP_TOL, SWEEP_GRAD_TOL)
    worst["forward_or_grad"] = max(worst["forward_or_grad"], e)
    swept.add("Custom")
    missing = sorted(set(cases.S7_OPS) - swept)
    out = {"names": len(swept & set(cases.S7_OPS)),
           "cases": len(tables) + len(cases.PROPOSAL_CASES) +
           len(cases.SAMPLER_CASES) + len(cases.PER_ROW_CASES) + 2,
           "worst": worst, "sweep_s": time.perf_counter() - t0}
    print("operators [%s]: %d of the slice's %d names swept on the card "
          "against the CPU in %d cases (%.1f s): largest error %.3g "
          "(tolerances %g / %g), samplers' largest moment gap %.2f standard "
          "errors over %d draws"
          % (card, out["names"], len(cases.S7_OPS), out["cases"],
             out["sweep_s"], worst["forward_or_grad"], SWEEP_TOL,
             SWEEP_GRAD_TOL, worst["sampler_z"], SAMPLER_DRAWS))
    check(not missing, "sweep: names not run on the card: %s" % missing)
    return out


def rcnn_full_phase(dev, card):
    """Proposal at Faster R-CNN's test-time RPN settings and the R-FCN
    deformable convolution, each at full size on the card against the
    port's CPU run of the same call, with its times."""
    from mxnet_tpu_torch.ops import get_op
    rng = np.random.RandomState(0)
    H, W = RPN_MAP
    A = len(RPN_FULL["scales"]) * len(RPN_FULL["ratios"])
    logits = rng.randn(1, 2, A, H, W).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    cls_prob = (e / e.sum(1, keepdims=True)).reshape(1, 2 * A, H, W)
    bbox = (rng.randn(1, 4 * A, H, W) * 0.2).astype(np.float32)
    im_info = np.array([RPN_IM], np.float32)
    arrays = [cls_prob, bbox, im_info]
    prop = get_op("Proposal")
    c_outs, _, _ = sweep_run("Proposal", arrays, RPN_FULL, (0, 1, 2), "cpu")
    ins = [torch.from_numpy(a).to(dev) for a in arrays]
    g_outs = list(prop(*ins, **RPN_FULL))
    proposal_holds("Proposal full size", g_outs, c_outs)
    kept = int(torch.unique(g_outs[0], dim=0).shape[0])

    def call():
        prop(*ins, **RPN_FULL)

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    out = {"proposal": {"call_ms": wall_ms(call, 5),
                        "device_ms": device_ms(call, reps=3),
                        "kept": kept}}
    print("proposal [%s]: 1 x %d x %d x %d map, pre-NMS %d, post %d, NMS "
          "%.1f: %d distinct boxes kept (the CPU's set); %.3f ms a call, "
          "%.3f ms of device time"
          % (card, 2 * A, H, W, RPN_FULL["rpn_pre_nms_top_n"],
             RPN_FULL["rpn_post_nms_top_n"], RPN_FULL["threshold"], kept,
             out["proposal"]["call_ms"], out["proposal"]["device_ms"]))

    # DeformableConvolution at the res5 shape
    C = DCN_FULL["num_filter"]
    K = DCN_FULL["kernel"][0]
    data = rng.randn(1, C, H, W).astype(np.float32)
    offset = rng.uniform(-2, 2, (1, 2 * K * K, H, W)).astype(np.float32)
    weight = (rng.randn(C, C, K, K) * math.sqrt(2.0 / (C * K * K)))         .astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    arrays = [data, offset, weight, bias]
    err = sweep_case("DeformableConvolution full size",
                     "DeformableConvolution", arrays, DCN_FULL, (), dev,
                     SWEEP_GRAD_TOL, SWEEP_GRAD_TOL)
    dcn = get_op("DeformableConvolution")
    ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]

    def fwd():
        with torch.no_grad():
            dcn(*ts, **DCN_FULL)

    def fwd_bwd():
        o = dcn(*ts, **DCN_FULL)
        torch.autograd.grad(o, ts, torch.ones_like(o))

    out["deformable_conv"] = {
        "max_err": err, "forward_ms": wall_ms(fwd, 5),
        "forward_device_ms": device_ms(fwd, reps=3),
        "fwd_bwd_ms": wall_ms(fwd_bwd, 3),
        "fwd_bwd_device_ms": device_ms(fwd_bwd, reps=2)}
    d = out["deformable_conv"]
    print("deformable conv [%s]: 1 x %d x %d x %d, 3 x 3, dilate 2, %d "
          "filters: against the CPU max error %.3g (tolerance %g); forward "
          "%.3f ms a call (%.3f ms device), forward + backward %.3f ms "
          "(%.3f ms device)"
          % (card, C, H, W, C, err, SWEEP_GRAD_TOL, d["forward_ms"],
             d["forward_device_ms"], d["fwd_bwd_ms"],
             d["fwd_bwd_device_ms"]))
    return out


def operators_phase(dev, card):
    """Slice S7: AlexNet through train_imagenet.py's Module loop,
    matrix_fact.py and custom_softmax.py, the sweep of the slice's
    operators, and Proposal and the deformable convolution at full
    size."""
    import mxnet_tpu_torch as mx
    t = time.perf_counter()
    out = {"alexnet": alexnet_phase(mx, dev, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out.update(examples_phase(mx, dev, card))
    out["sweep"] = op_sweep_phase(dev, card)
    out["rcnn"] = rcnn_full_phase(dev, card)
    out["phase_s"] = time.perf_counter() - t
    print("operators phase [%s]: %.1f s" % (card, out["phase_s"]))
    return out


#: the data-parallel cell: two dist_sync workers under tools/launch.py -n 2
#: sharing card 0 over gloo (NCCL refuses two ranks on one card).  ResNet-50
#: at train_imagenet.py's defaults (batch 128 a worker, SGD 0.1 / 0.9 / wd
#: 1e-4, fp32 with TF32 off), each rank its own seeded batches; the same
#: with 2-bit compression (--gc-type 2bit --gc-threshold 0.5); gpt2_small
#: by the Gluon Trainer (B 8 x T 1024 a worker, Adam 3e-4); then
#: tools/bandwidth/measure.py's measure_kvstore("dist_sync", 64 MB, 10
#: arrays) over the two gloo workers and over NCCL at world size 1
DP = dict(device="cuda:0", layers=RESNET_LAYERS, shape=RESNET_SHAPE,
          classes=RESNET_CLASSES, batch=RESNET_B, batches=8, replay=3,
          gc_steps=3, gc_threshold=0.5, lr=0.1, momentum=0.9, wd=1e-4,
          profile_steps=2, gpt_steps=3, gpt=True, gpt_b=TRAIN_B,
          gpt_t=TRAIN_T, vocab=VOCAB, bw_mb=64.0, bw_arrays=10,
          bw_iters=10, bw_warmup=2, timeout=600, seed=0)
#: the same phase on the host at a small size (a rehearsal: tools/launch.py
#: --cpu-fake-devices, gloo on CPU tensors)
DP_CPU = dict(device="cpu", layers=8, shape="3,28,28", classes=10, batch=8,
              batches=3, replay=2, gc_steps=2, profile_steps=0, gpt_steps=2,
              gpt_net=dict(layers=2, units=32, heads=2, vocab=64, seq=16),
              gpt_b=2, gpt_t=16, vocab=64, bw_mb=0.4, bw_arrays=4,
              bw_iters=2, bw_warmup=1, timeout=300)
#: the ResNet workers against the in-process replay (one process, both
#: ranks' batches through one batch-128 Module, gradients summed,
#: rescale_grad 1 / 256, one SGD update a step), as max |w - w_replay| of
#: max |w_replay| over every parameter, after each of the first steps
DP_REPLAY_TOL = 1e-5
DP_SCRIPT = """import json, sys
sys.path.insert(0, %(repo)r)
import chip_smoke
chip_smoke.dp_worker(json.loads(%(cfg)r), %(mode)r)
"""
DP_MARK = "dp_worker: exit "


def dp_resnet(mx, cfg):
    """``(symbol, data shape, init args, init aux)``: symbols/resnet.py's
    ResNet with train_imagenet.py's Xavier (gaussian, in, 2) drawn with
    numpy from ``cfg["seed"]``, BatchNorm gamma 1, moving variance 1."""
    shape = (cfg["batch"],) + tuple(int(x) for x in cfg["shape"].split(","))
    sym = resnet_symbol(mx, cfg["classes"], cfg["layers"], cfg["shape"])
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=shape, softmax_label=(cfg["batch"],))
    shapes = {n: s for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    args = xavier_params(shapes, cfg["seed"])
    for n in args:
        if n.endswith("_gamma"):
            args[n][:] = 1.0
    aux = {n: (np.ones if n.endswith("_var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, shape, args, aux


def dp_batch(mx, cfg, shape, rank, step, dev):
    """Rank ``rank``'s batch ``step``: pixels normal(0, 1) and labels drawn
    on ``dev`` from the seed ``1000 rank + step`` (any process can draw any
    rank's batch)."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    g = torch.Generator(device=dev).manual_seed(1000 * rank + step)
    data = torch.randn(shape, generator=g, device=dev)
    label = torch.randint(0, cfg["classes"], (shape[0],), generator=g,
                          device=dev).float()
    return mx.io.DataBatch(
        data=[NDArray(data, dev)], label=[NDArray(label, dev)], pad=0,
        provide_data=[mx.io.DataDesc("data", shape)],
        provide_label=[mx.io.DataDesc("softmax_label", (shape[0],))])


def dp_iter(mx, cfg, shape, rank, n, dev):
    batches = [dp_batch(mx, cfg, shape, rank, s, dev) for s in range(n)]

    class RankIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(shape[0])
            self.i = 0
            self.provide_data = batches[0].provide_data
            self.provide_label = batches[0].provide_label

        def next(self):
            if self.i >= len(batches):
                raise StopIteration
            self.i += 1
            return batches[self.i - 1]

        def reset(self):
            self.i = 0

    return RankIter()


def digest(tensors):
    """A bitwise digest a tensor (computed on its device): the sum of its
    32-bit words weighted by their position mod 65521, plus one."""
    out = []
    for t in tensors:
        w = t.detach().contiguous().reshape(-1).view(torch.int32).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append(int((w * pos).sum()))
    return out


def dp_fit(mx, cfg, sym, shape, args, aux, rank, dev, n, kv, keep=0,
           profile_steps=0):
    """``Module.fit`` of ResNet on this rank's ``n`` batches through ``kv``:
    the step times, a digest of the weights and the store's optimizer state
    after each step, copies of the weights after the first ``keep`` steps,
    then ``profile_steps`` more fit steps under torch.profiler."""
    mod = mx.mod.Module(sym, context=mx.Context(dev))
    steps, digests, kept = [], [], []
    fit_step = mod.fit_step

    def timed(batch):
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        t = time.perf_counter()
        fit_step(batch)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        steps.append(time.perf_counter() - t)

    def after(param):
        ws = [mod._exec.arg_dict[k].data for k in mod._param_names]
        st = kv._updater.states
        moms = [st[k] for k in sorted(st, key=str) if st[k] is not None]
        digests.append(digest(ws + moms))
        if len(kept) < keep:
            kept.append({k: mod._exec.arg_dict[k].data.clone()
                         for k in mod._param_names})

    mod.fit_step = timed
    train = dp_iter(mx, cfg, shape, rank, n, dev)
    wrap = lambda a: mx.nd.array(a, ctx=mx.Context(dev))  # noqa: E731
    kv.stats.update(allreduce_calls=0, wire_bytes=0, allreduce_s=0.0)
    mod.fit(train, num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"], "wd": cfg["wd"],
                              "momentum": cfg["momentum"]},
            arg_params={k: wrap(v) for k, v in args.items()},
            aux_params={k: wrap(v) for k, v in aux.items()},
            batch_end_callback=[after])
    stats = dict(kv.stats)
    out = {"step_ms": [x * 1e3 for x in steps], "digests": digests,
           "allreduce_ms_per_step": stats["allreduce_s"] * 1e3 / n,
           "wire_bytes_per_step": stats["wire_bytes"] / n,
           "allreduce_calls": stats["allreduce_calls"],
           "rescale_grad": mod._optimizer.rescale_grad,
           "update_on_kvstore": bool(mod._update_on_kvstore)}
    import hashlib
    h = hashlib.sha256()
    for k in mod._param_names:
        h.update(mod._exec.arg_dict[k].data.detach().cpu().numpy()
                 .tobytes())
    out["final_sha256"] = h.hexdigest()
    if profile_steps and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        batch = dp_batch(mx, cfg, shape, rank, n, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(profile_steps):
                fit_step(batch)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t) * 1e6
        out["profile"] = profile_summary(
            prof, wall_us, profile_steps,
            "dp profile rank %d: dist_sync fit step" % rank)
        out["profile"].pop("top")
    return mod, out, kept


def dp_replay(mx, cfg, sym, shape, args, aux, dev, steps, threshold=None):
    """The in-process replay: one batch-``B`` Module, rank 0's and rank 1's
    batch of each step through ``forward_backward``, their gradients (each
    through its own plain ``TwoBitCompression`` with residuals, when a
    threshold is given) summed, ``rescale_grad`` 1 / 2B, one SGD update.
    Returns the weights after each step."""
    from mxnet_tpu_torch.gradient_compression import TwoBitCompression
    mod = mx.mod.Module(sym, context=mx.Context(dev))
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    wrap = lambda a: mx.nd.array(a, ctx=mx.Context(dev))  # noqa: E731
    mod.init_params(arg_params={k: wrap(v) for k, v in args.items()},
                    aux_params={k: wrap(v) for k, v in aux.items()})
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
        "learning_rate": cfg["lr"], "wd": cfg["wd"],
        "momentum": cfg["momentum"], "rescale_grad": 1.0 / (2 * shape[0])})
    comps = [TwoBitCompression(threshold) for _ in range(2)] \
        if threshold is not None else None
    names = mod._param_names
    out = []
    for step in range(steps):
        total = None
        for r in range(2):
            mod.forward_backward(dp_batch(mx, cfg, shape, r, step, dev))
            g = {n: mod._exec.grad_dict[n].data.clone() for n in names}
            if comps is not None:
                g = {n: comps[r].quantize_local(n, v) for n, v in g.items()}
            total = g if total is None else \
                {n: total[n] + g[n] for n in names}
        for n in names:
            mod._exec.grad_dict[n]._set_data(total[n])
        mod.update()
        out.append({n: mod._exec.arg_dict[n].data.clone() for n in names})
    del mod
    return out


def replay_errs(kept, replay):
    """max |w - w_replay| / max |w_replay| over every parameter, a step."""
    errs = []
    for got, want in zip(kept, replay):
        num = max(float((got[n] - want[n]).abs().max()) for n in want)
        den = max(float(want[n].abs().max()) for n in want)
        errs.append(num / den)
    return errs


def dp_bandwidth(mx, cfg, dev):
    """``measure_kvstore("dist_sync", size_mb, num_arrays)`` of
    tools/bandwidth/measure.py on the port: the best push + pull round
    trip of every key of one batch, and the store's all-reduce alone."""
    kv = mx.kv.create("dist_sync")
    ctx = mx.Context(dev)
    per = max(1, int(cfg["bw_mb"] * 1e6 / cfg["bw_arrays"] / 4))
    keys = [str(i) for i in range(cfg["bw_arrays"])]
    vals = [mx.nd.ones((per,), ctx=ctx) for _ in keys]
    outs = [mx.nd.zeros((per,), ctx=ctx) for _ in keys]
    for k, v in zip(keys, vals):
        kv.init(k, v)
    total = 4 * per * len(keys)
    times, ar = [], []
    for i in range(cfg["bw_warmup"] + cfg["bw_iters"]):
        s0 = kv.stats["allreduce_s"]
        t0 = time.perf_counter()
        kv.push(keys, [[v] for v in vals])
        kv.pull(keys, [[o] for o in outs])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i >= cfg["bw_warmup"]:
            times.append(time.perf_counter() - t0)
            ar.append(kv.stats["allreduce_s"] - s0)
    want = float(kv.num_workers)
    check(all(bool((o.data == want).all()) for o in outs),
          "dp bandwidth: the pulled sums are not %g" % want)
    from mxnet_tpu_torch.base import dist_backend
    t = min(times)
    return {"workers": kv.num_workers, "backend": dist_backend(),
            "num_keys": len(keys), "total_mb": total / 1e6, "time_s": t,
            "GBps": total / t / 1e9,
            "per_key_GBps": total / len(keys) / t / 1e9,
            "allreduce_GBps": total / min(ar) / 1e9}


def dp_worker(cfg, mode):
    """One rank of the data-parallel phase (``mode`` "dist": the two gloo
    workers; "nccl": bandwidth at world size 1).  Prints one exit line."""
    import mxnet_tpu_torch as mx
    dev = torch.device(cfg["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the replay holds bitwise determinism of the gradients
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    doc = {"mode": mode}
    if mode == "nccl":
        doc["bw"] = dp_bandwidth(mx, cfg, dev)
        doc["rank"] = 0
        sys.stderr.write(DP_MARK + json.dumps(doc) + "\n")
        return
    sym, shape, args, aux = dp_resnet(mx, cfg)
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    doc["rank"], doc["num_workers"] = rank, kv.num_workers
    mod, doc["resnet"], kept = dp_fit(
        mx, cfg, sym, shape, args, aux, rank, dev, cfg["batches"], kv,
        keep=cfg["replay"] if rank == 0 else 0,
        profile_steps=cfg["profile_steps"])
    del mod
    kv2 = mx.kv.create("dist_sync")
    kv2.set_gradient_compression({"type": "2bit",
                                  "threshold": cfg["gc_threshold"]})
    mod, doc["gc"], kept_gc = dp_fit(
        mx, cfg, sym, shape, args, aux, rank, dev, cfg["gc_steps"], kv2,
        keep=cfg["gc_steps"] if rank == 0 else 0)
    del mod
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        t = time.perf_counter()
        doc["resnet"]["replay_errs"] = replay_errs(kept, dp_replay(
            mx, cfg, sym, shape, args, aux, dev, cfg["replay"]))
        doc["gc"]["replay_errs"] = replay_errs(kept_gc, dp_replay(
            mx, cfg, sym, shape, args, aux, dev, cfg["gc_steps"],
            cfg["gc_threshold"]))
        doc["replay_s"] = time.perf_counter() - t
    del kept, kept_gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kv.barrier()
    if cfg["gpt"]:
        doc["gpt"] = dp_gpt(mx, cfg, rank, dev)
    doc["bw"] = dp_bandwidth(mx, cfg, dev)
    sys.stderr.write(DP_MARK + json.dumps(doc) + "\n")
    sys.stderr.flush()


def dp_gpt(mx, cfg, rank, dev):
    """gpt2_small (or ``cfg["gpt_net"]``'s widths) by the Gluon Trainer with
    ``kvstore="dist_sync"``: this rank's batch, Adam 3e-4, a digest of the
    parameters after each step, and the flash launches."""
    from mxnet_tpu_torch.gluon import loss as gloss
    if "gpt_net" in cfg:
        net = seeded_gpt(mx, dict(cfg["gpt_net"], seed=0), dev)
    else:
        net = seeded_gpt2_small(0, dev)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": TRAIN_LR},
                               kvstore="dist_sync")
    loss_fn = gloss.SoftmaxCrossEntropyLoss(axis=-1, sparse_label=True)
    toks = np.random.default_rng(10 + rank).integers(
        0, cfg["vocab"], (cfg["gpt_b"], cfg["gpt_t"] + 1))
    batch = (torch.from_numpy(toks[:, :-1]).long().to(dev),
             torch.from_numpy(toks[:, 1:].astype(np.float32)).to(dev), None)
    flash_counts(reset=True)
    losses, digests, steps = [], [], []
    for _ in range(cfg["gpt_steps"]):
        t = time.perf_counter()
        losses.append(train_step(net, trainer, loss_fn, batch))
        steps.append(time.perf_counter() - t)
        digests.append(digest([p.data().data
                               for p in net.collect_params().values()]))
    return {"losses": losses, "digests": digests, "flash":
            list(flash_counts()), "layers": len(net.blocks),
            "step_ms": [x * 1e3 for x in steps],
            "update_on_kvstore": bool(trainer._update_on_kvstore),
            "wire_bytes_per_step": trainer._kv.stats["wire_bytes"] /
            cfg["gpt_steps"],
            "allreduce_ms_per_step": trainer._kv.stats["allreduce_s"] *
            1e3 / cfg["gpt_steps"]}


def dp_launch(cfg, mode, n, work, env_extra):
    """``tools/launch.py -n n --launcher local`` of :func:`dp_worker` under
    ``timeout``; returns the workers' exit documents.  A worker that fails
    fails the phase."""
    script = os.path.join(work, "dp_worker.py")
    with open(script, "w") as f:
        f.write(DP_SCRIPT % {"repo": REPO, "cfg": json.dumps(cfg),
                             "mode": mode})
    env_ = dict(os.environ)
    env_.update(env_extra)
    env_["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    for k in ("MXTPU_COORDINATOR", "MXTPU_FAULT"):
        env_.pop(k, None)
    log_path = os.path.join(work, "dp-%s.log" % mode)
    cmd = ["timeout", "-k", "10", str(cfg["timeout"]), sys.executable,
           LAUNCH, "-n", str(n), "--launcher", "local", "--aot-cache-dir",
           "off"] + (["--cpu-fake-devices"] if cfg["device"] == "cpu"
                     else []) + ["--", sys.executable, script]
    t = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.call(cmd, env=env_, stdout=log,
                             stderr=subprocess.STDOUT)
    took = time.perf_counter() - t
    docs = sorted(marked_lines(log_path, DP_MARK), key=lambda d: d["rank"])
    if rc != 0 or len(docs) != n:
        with open(log_path, errors="replace") as f:
            sys.stderr.write(f.read()[-6000:])
    check(rc == 0, "dp %s: the launcher exited %d" % (mode, rc))
    check(len(docs) == n, "dp %s: %d exit lines of %d workers"
          % (mode, len(docs), n))
    return docs, took


def dp_phase(dev, card, cfg=None, workdir=None):
    """The data-parallel phase: two :func:`dp_worker` processes under the
    unchanged ``tools/launch.py -n 2 --launcher local`` on card 0 with
    ``MXTPU_DIST_BACKEND=gloo`` (ResNet-50 by ``Module.fit`` with
    ``kv.create("dist_sync")``, the same with 2-bit compression, gpt2_small
    by the Gluon Trainer, the kvstore bandwidth), then one NCCL worker at
    world size 1 (the bandwidth).  Holds the workers bitwise equal at every
    step, rank 0's replays within ``DP_REPLAY_TOL``, 16 times fewer bytes
    compressed, and B1-B3 at one launch a layer a step in each worker."""
    cfg = dict(DP, **(cfg or {}))
    on_card = dev.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="dp-", dir=workdir)
    t0 = time.perf_counter()
    docs, took = dp_launch(cfg, "dist", 2, work,
                           {"MXTPU_DIST_BACKEND": "gloo",
                            "MXTPU_FLASH_BWD": "split"})
    nccl, took_nccl = dp_launch(cfg, "nccl", 1, work,
                                {"MXTPU_DIST_BACKEND": "" if on_card
                                 else "gloo"})
    shutil.rmtree(work, ignore_errors=True)
    r0, r1 = docs
    out = {"launch_s": took, "nccl_launch_s": took_nccl}
    check(r0["num_workers"] == r1["num_workers"] == 2,
          "dp: the workers saw %r workers" % [d["num_workers"] for d in docs])
    for part, n in (("resnet", cfg["batches"]), ("gc", cfg["gc_steps"])):
        a, b = r0[part], r1[part]
        check(len(a["digests"]) == len(b["digests"]) == n,
              "dp %s: %d/%d digests of %d steps"
              % (part, len(a["digests"]), len(b["digests"]), n))
        equal = [x == y for x, y in zip(a["digests"], b["digests"])]
        check(all(equal) and a["final_sha256"] == b["final_sha256"],
              "dp %s: the workers differ at steps %r"
              % (part, [i for i, e in enumerate(equal) if not e]))
        check(a["update_on_kvstore"] and b["update_on_kvstore"],
              "dp %s: fit did not update on the dist store" % part)
        check(abs(a["rescale_grad"] - 1.0 / (2 * cfg["batch"])) < 1e-12,
              "dp %s: rescale_grad %r" % (part, a["rescale_grad"]))
        errs = a["replay_errs"]
        check(len(errs) >= 1 and max(errs) <= DP_REPLAY_TOL,
              "dp %s: workers vs the in-process replay %r (limit %g)"
              % (part, errs, DP_REPLAY_TOL))
        p50 = [statistics.median(d[part]["step_ms"][1:] or
                                 d[part]["step_ms"]) for d in docs]
        out[part] = {
            "steps": n, "bitwise_equal_steps": sum(equal),
            "replay_errs": errs, "fit_step_p50_ms": p50,
            "images_per_s_pair": 2 * cfg["batch"] / (max(p50) / 1e3),
            "allreduce_ms_per_step": [d[part]["allreduce_ms_per_step"]
                                      for d in docs],
            "wire_bytes_per_step": a["wire_bytes_per_step"],
            "step_ms": [d[part]["step_ms"] for d in docs]}
        if "profile" in a:
            out[part]["device_busy_share"] = [
                d[part]["profile"]["device_busy_share"] for d in docs]
    ratio = out["resnet"]["wire_bytes_per_step"] / \
        out["gc"]["wire_bytes_per_step"]
    out["gc"]["wire_ratio"] = ratio
    check(ratio > 15.9, "dp gc: the compressed wire is only %.3f times "
          "smaller" % ratio)
    print("dp resnet [%s]: %d x %d x %s ResNet-%d by Module.fit with "
          "kv.create('dist_sync'), 2 workers on one card over gloo: fit "
          "step p50 %s ms, %.1f images/s of the pair, kv.allreduce %s ms "
          "and %.1f MB a step a worker, device busy %s; bitwise equal at "
          "%d of %d steps; replay err %s (limit %g)"
          % (card, 2, cfg["batch"], cfg["shape"], cfg["layers"],
             ["%.1f" % x for x in out["resnet"]["fit_step_p50_ms"]],
             out["resnet"]["images_per_s_pair"],
             ["%.1f" % x for x in out["resnet"]["allreduce_ms_per_step"]],
             out["resnet"]["wire_bytes_per_step"] / 1e6,
             ["%.3f" % x for x in out["resnet"].get("device_busy_share",
                                                    [])],
             out["resnet"]["bitwise_equal_steps"], cfg["batches"],
             ["%.3g" % x for x in out["resnet"]["replay_errs"]],
             DP_REPLAY_TOL))
    print("dp gc [%s]: 2-bit threshold %g, %d steps: fit step p50 %s ms, "
          "%.3f MB a step on the wire a worker (%.2f times fewer than "
          "fp32); bitwise equal at %d of %d steps; replay err %s (limit %g)"
          % (card, cfg["gc_threshold"], cfg["gc_steps"],
             ["%.1f" % x for x in out["gc"]["fit_step_p50_ms"]],
             out["gc"]["wire_bytes_per_step"] / 1e6, ratio,
             out["gc"]["bitwise_equal_steps"], cfg["gc_steps"],
             ["%.3g" % x for x in out["gc"]["replay_errs"]], DP_REPLAY_TOL))
    if cfg["gpt"]:
        a, b = r0["gpt"], r1["gpt"]
        equal = [x == y for x, y in zip(a["digests"], b["digests"])]
        check(len(equal) == cfg["gpt_steps"] and all(equal),
              "dp gpt: the workers differ after steps %r"
              % [i for i, e in enumerate(equal) if not e])
        check(a["update_on_kvstore"], "dp gpt: the Trainer did not update "
              "on the dist store")
        want = [a["layers"] * cfg["gpt_steps"]] * 3 + [0]
        for d in docs:
            check(not on_card or d["gpt"]["flash"] == want,
                  "dp gpt rank %d: flash launches %r, want %r"
                  % (d["rank"], d["gpt"]["flash"], want))
            check(all(math.isfinite(x) for x in d["gpt"]["losses"]),
                  "dp gpt: non-finite loss %r" % d["gpt"]["losses"])
        out["gpt"] = {
            "steps": cfg["gpt_steps"], "bitwise_equal_steps": sum(equal),
            "losses": [d["gpt"]["losses"] for d in docs],
            "flash": [d["gpt"]["flash"] for d in docs],
            "step_ms": [d["gpt"]["step_ms"] for d in docs],
            "wire_bytes_per_step": a["wire_bytes_per_step"],
            "allreduce_ms_per_step": [d["gpt"]["allreduce_ms_per_step"]
                                      for d in docs]}
        print("dp gpt [%s]: gpt2_small %d layers by Trainer(kvstore="
              "'dist_sync'), 2 workers x B %d x T %d, Adam %g: steps %s ms, "
              "losses %s, bitwise equal after %d of %d steps, kv.allreduce "
              "%s ms and %.1f MB a step; B1/B2/B3/B7 launches %s a worker"
              % (card, a["layers"], cfg["gpt_b"], cfg["gpt_t"], TRAIN_LR,
                 [["%.0f" % x for x in d["gpt"]["step_ms"]] for d in docs],
                 [["%.4f" % x for x in d["gpt"]["losses"]] for d in docs],
                 sum(equal), cfg["gpt_steps"],
                 ["%.0f" % x for x in out["gpt"]["allreduce_ms_per_step"]],
                 a["wire_bytes_per_step"] / 1e6, out["gpt"]["flash"]))
    out["bandwidth"] = {"gloo_world2": [d["bw"] for d in docs],
                        "nccl_world1": nccl[0]["bw"]}
    for label, bw in (("gloo, 2 workers on one card", r0["bw"]),
                      ("%s, world 1" % nccl[0]["bw"]["backend"],
                       nccl[0]["bw"])):
        print("dp bandwidth [%s]: measure_kvstore('dist_sync', %g MB, %d "
              "arrays) %s: push+pull %.3f GB/s (%.3f GB/s a key), the "
              "all-reduce alone %.3f GB/s"
              % (card, cfg["bw_mb"], cfg["bw_arrays"], label, bw["GBps"],
                 bw["per_key_GBps"], bw["allreduce_GBps"]))
    out["flash_launches"] = [sum(d["gpt"]["flash"][i] for d in docs)
                             if cfg["gpt"] else 0 for i in range(4)]
    out["phase_s"] = time.perf_counter() - t0
    print("dp [%s]: phase %.1f s (launches %.1f s and %.1f s)"
          % (card, out["phase_s"], took, took_nccl))
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
    s1b = serving_slice_phase(net, dev, card)
    fleet = fleet_phase(net, dev, card)
    fleet["streams_equal"] = fleet_reference(net, dev, None, fleet, card)
    fleet.pop("tokens_list")
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
    gc.collect()
    torch.cuda.empty_cache()
    resnet = resnet_phase(dev, card)
    vision_ = vision_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    planes = training_planes_phase(dev, card, module["fit_step_p50_ms"])
    images = image_plane_phase(dev, card, resnet)
    gc.collect()
    torch.cuda.empty_cache()
    rnn = rnn_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    operators = operators_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    dp = dp_phase(dev, card)

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
    # and the elastic trainers' (slice S4b, each worker's status files)
    for name, n in zip(FLASH_KERNELS, planes["elastic"]["flash_launches"]):
        flash_launches[name] += n
    # and the data-parallel gpt2_small workers' (slice S5a, exit lines)
    for name, n in zip(FLASH_KERNELS, dp["flash_launches"]):
        flash_launches[name] += n
    # the paged kernels' launches: the greedy slice runs and slice S1b's
    # mixed, planes and spec runs (fp32), the int8 ones (int8 pools), and
    # the fleet workers' (each worker's exit line)
    check(fleet["launches"] > 0, "paged_attention never launched in the "
          "fleet's workers")
    kernels = [
        kernel_entry("paged_attention", b5, cases["paged_attention"],
                     served["launches"] + s1b["mixed"]["launches"] +
                     s1b["planes"]["launches"] + fleet["launches"] +
                     planes["elastic"]["launches"],
                     cases["paged_attention"][0]),
        kernel_entry("paged_attention[int8]", b5,
                     cases["paged_attention[int8]"],
                     int8["plain"]["launches"] + s1b["int8"]["launches"],
                     cases["paged_attention[int8]"][0]),
        kernel_entry("paged_attention_multi", b6,
                     cases["paged_attention_multi"],
                     spec["ngram"]["launches"] + spec["oracle"]["launches"]
                     + s1b["spec"]["launches"],
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
          gluon_nd["post_ln"]["launches"] > 0 and
          planes["fit"]["launches"] > 0 and planes["resume"]["launches"] > 0,
          "layer_norm_residual never launched on its path")
    kernels.append(kernel_entry(
        "layer_norm_residual", "mxnet_tpu/ops/pallas/layer_norm.py:56",
        ln_cases, symbolic["launches"] + module["launches"] +
        gluon_nd["post_ln"]["launches"] + planes["fit"]["launches"] +
        planes["resume"]["launches"], ln_cases[0],
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
                      "serving_s1b": s1b, "fleet": fleet, "train": train,
                      "symbolic": symbolic,
                      "imperative": imperative, "module": module,
                      "gluon_nd": gluon_nd, "resnet": resnet,
                      "vision": vision_, "planes": planes,
                      "images": images, "rnn": rnn,
                      "operators": operators, "data_parallel": dp}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
