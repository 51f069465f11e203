"""Environment-flag configuration (counterpart of ``mxnet_tpu/config.py``).

The single registry of every environment knob this package reads: each
flag has a typed default and a docstring, reference-era ``MXNET_*`` names
stay readable where a counterpart exists, and the knobs with no
counterpart are listed with where their concern went (``ABSORBED``: the
MXNet ones, ``REFERENCE_ONLY``: the JAX package's own).

Usage::

    from mxnet_tpu_torch import config
    config.flag("MXTPU_FLASH_BWD")           # resolved value
    config.describe()                        # table of all flags

Flags are read from the environment at call time (not import time), so
tests and launchers can set them per process.  Each module still reads
its own knobs where it uses them; ``tests/test_torch_config.py`` holds
every name the package reads to a row here.
"""
from __future__ import annotations

import os
from collections import OrderedDict, namedtuple

__all__ = ["flag", "describe", "FLAGS", "ABSORBED", "REFERENCE_ONLY"]

_Flag = namedtuple("_Flag", ["name", "default", "type", "doc", "aliases"])

#: every environment knob the package reads, in one place
FLAGS = OrderedDict()


def _register(name, default, type_, doc, aliases=()):
    FLAGS[name] = _Flag(name, default, type_, doc, tuple(aliases))


# -- identity (tools/launch.py exports these to every worker) ---------------
_register("MXTPU_COORDINATOR", "", str,
          "host:port of the job's coordinator, set by tools/launch.py; "
          "the port's multi-process scripts give it to "
          "torch.distributed (replaces ps-lite's DMLC_PS_ROOT_URI).")
_register("MXTPU_NUM_WORKERS", 1, int,
          "number of worker processes in the job (replaces "
          "DMLC_NUM_WORKER).")
_register("MXTPU_WORKER_RANK", 0, int,
          "this process's rank (replaces DMLC_WORKER_ID).")
_register("MXTPU_WORKER_SLOT", 0, int,
          "the launch-stable worker slot elastic eviction tracks "
          "(defaults to the rank).")
_register("MXTPU_RESTART_ATTEMPT", 0, int,
          "the launcher's attempt number of this worker.")
_register("MXTPU_PREV_WORLD_SIZE", "", str,
          "the previous attempt's world size ('' on the first); "
          "elastic.py counts a world change from it.")
# -- kernels and graph --------------------------------------------------------
_register("MXTPU_FLASH_BWD", "split", str,
          "flash-attention backward: 'split' = the dq kernel (B2) and the "
          "dk/dv kernel (B3), 'fused' = one pass (B7).")
_register("MXTPU_LN_PALLAS", 1, int,
          "0 keeps LayerNorm(x + r) as torch ops instead of the fused "
          "LayerNorm-residual kernel (B4); the reference's name.")
_register("MXTPU_GRAPH_PASSES", "", str,
          "comma-separated graph passes in run order; empty is the "
          "default pipeline, 0/off/none/false disables rewriting.")
_register("MXTPU_GRAPH_FOLD_MAX_BYTES", 1 << 22, int,
          "largest constant the fold pass materializes.")
# -- training -----------------------------------------------------------------
_register("MXTPU_MAX_CONSECUTIVE_SKIPS", 100, int,
          "divergence guard: consecutive non-finite steps before the "
          "training loop raises.")
_register("MXTPU_DATA_PREFETCH", 2, int,
          "DataLoader/StreamLoader prefetch depth (0 disables the "
          "background prefetcher).")
_register("MXTPU_DATA_SEED", 0, int,
          "seed of the epoch permutation (elastic.shard_for_epoch, "
          "stream.assignment).")
_register("MXTPU_STREAM_WORKERS", 2, int,
          "StreamLoader decode workers.")
_register("MXTPU_STREAM_WORKER_MODE", "thread", str,
          "StreamLoader decode workers: 'thread' or 'process' (fork).")
_register("MXTPU_STREAM_QUEUE_DEPTH", 4, int,
          "StreamLoader bounded result-queue depth.")
_register("MXTPU_STREAM_CHUNK_RECORDS", 64, int,
          "records a decode task reads.")
_register("MXTPU_STREAM_POLL_SECS", 0.2, float,
          "follow-mode manifest poll interval while the writer is "
          "behind.")
_register("MXTPU_STREAM_EPOCH_PREFETCH", 1, int,
          "1 starts decoding the next epoch's first chunks while the "
          "current epoch drains.")
_register("MXTPU_COLLECTIVE_TIMEOUT", 0.0, float,
          "deadline of one kvstore barrier/all-reduce guard (0: the "
          "stall timeout).")
# -- the data-parallel plane --------------------------------------------------
_register("MXTPU_CONNECT_TIMEOUT", 60.0, float,
          "seconds of one window in which a worker waits for the "
          "coordinator at bring-up (base.maybe_init_distributed).")
_register("MXTPU_CONNECT_RETRIES", 2, int,
          "further connect windows before bring-up raises MXNetError "
          "naming the coordinator.")
_register("MXTPU_DIST_BACKEND", "", str,
          "torch.distributed backend: empty follows the device (nccl for "
          "CUDA tensors, gloo for host tensors); 'gloo' sends CUDA "
          "tensors over gloo too (ranks sharing one card).")
_register("MXTPU_ZERO", 0, int,
          "1 shards the fused update's optimizer state 1/N over the "
          "replicas of a context list (ZeRO-1); 0 replicates it.")
# -- image data plane ---------------------------------------------------------
_register("MXNET_CPU_WORKER_NTHREADS", 1, int,
          "host-side worker threads for the Python image pipeline "
          "(image/image.py); the native pipeline uses "
          "preprocess_threads from ImageRecordIter instead.",
          aliases=("MXTPU_CPU_WORKER_NTHREADS",))
_register("MXTPU_NATIVE_IO", 1, int,
          "use the native decode pipeline (_native.py) for "
          "ImageRecordIter when the library builds; 0 forces the Python "
          "path (ImageDetRecordIter, which has none, then raises).")
_register("MXTPU_BUILD_NATIVE", 1, int,
          "build the native library into _build/native at first use; 0 "
          "builds nothing (a library already built is still loaded).")
# -- checkpoints --------------------------------------------------------------
_register("MXTPU_ASYNC_CKPT", "", str,
          "1 hands checkpoint writes to the background writer thread "
          "(the snapshot copies device tensors to pinned host memory).")
_register("MXTPU_ASYNC_CKPT_DEPTH", 2, int,
          "queued async checkpoint writes before save() blocks.")
# -- hang defense -------------------------------------------------------------
_register("MXTPU_STALL_TIMEOUT", 0.0, float,
          "seconds a progress lease may go unrenewed before the watchdog "
          "dumps stacks and exits 75 (0 disables).")
_register("MXTPU_STARTUP_GRACE", 0.0, float,
          "deadline of the first renewal (kernel builds included); 0 "
          "derives it from the stall timeout.")
_register("MXTPU_HEARTBEAT_DIR", "", str,
          "directory of the per-rank heartbeat files (tools/launch.py "
          "exports it).")
_register("MXTPU_HEARTBEAT_INTERVAL", 1.0, float,
          "seconds between heartbeat writes.")
# -- fault injection ----------------------------------------------------------
_register("MXTPU_FAULT", "", str,
          "fault-site spec 'site:rate[:count],...' (fault.py).")
_register("MXTPU_FAULT_SEED", 0, int,
          "seed of probabilistic fault sites.")
_register("MXTPU_FAULT_SLOTS", "", str,
          "comma-separated worker slots the fault spec applies to.")
_register("MXTPU_FAULT_ATTEMPTS", "", str,
          "comma-separated restart attempts the fault spec applies to.")
_register("MXTPU_FAULT_STALL_SECS", 3600.0, float,
          "how long a stall site sleeps.")
_register("MXTPU_FAULT_DELAY_SECS", 0.05, float,
          "how long a delay site sleeps.")
# -- telemetry and profiling --------------------------------------------------
_register("MXTPU_TELEMETRY", "", str,
          "'jsonl:<path>[:<interval>]' starts the telemetry emitter.")
_register("MXTPU_TELEMETRY_OFF", 0, int,
          "1 turns the metric registry off.")
_register("MXTPU_FLIGHT_RECORDER_STEPS", 64, int,
          "flight-recorder ring size (steps).")
_register("MXTPU_REQUEST_TRACE_EVENTS", 8192, int,
          "request-event ring size.")
_register("MXTPU_TELEMETRY_PULL_EVENTS", 2048, int,
          "events a telemetry pull returns at most.")
_register("MXTPU_POSTMORTEM_DIR", "", str,
          "where crash postmortems and stall stacks are written.")
_register("MXNET_PROFILER_AUTOSTART", 0, int,
          "start the chrome-trace profiler at import (profiler.py).",
          aliases=("MXTPU_PROFILER_AUTOSTART",))
# -- serving ------------------------------------------------------------------
_register("MXTPU_SERVE_PREFIX_CACHE", 1, int,
          "0 turns the engine's prefix cache off.")
_register("MXTPU_SERVE_DEADLINE_S", 0.0, float,
          "default request deadline (0: none).")
_register("MXTPU_SERVE_ABANDON_S", 0.0, float,
          "an unpolled stream is abandoned after this many seconds.")
_register("MXTPU_SERVE_STREAM_TTL_S", 0.0, float,
          "a finished stream's buffer lives this long unpolled.")
_register("MXTPU_SERVE_STREAM_CHUNK", 0, int,
          "tokens a poll returns at most (0: all).")
_register("MXTPU_SERVE_TEMPERATURE", "", str,
          "default sampling temperature (unset: greedy).")
_register("MXTPU_SERVE_TOP_K", 0, int, "default top-k (0: off).")
_register("MXTPU_SERVE_TOP_P", 0.0, float, "default top-p (0: off).")
_register("MXTPU_SERVE_SEED", 0, int, "default sampling seed.")
_register("MXTPU_SERVE_SLO_P99_S", 0.0, float,
          "queue-wait p99 target of SLO shedding (0: off).")
_register("MXTPU_SERVE_SLO_RELEASE", 0.5, float,
          "shedding releases below this share of the target.")
_register("MXTPU_SERVE_SLO_WINDOW_S", 10.0, float,
          "SLO controller's sliding window.")
_register("MXTPU_SERVE_JOURNAL", "", str,
          "path of the Router's request journal.")
_register("MXTPU_SERVE_PORT_FILE", "", str,
          "where a serving worker publishes its RPC port "
          "(tools/launch.py --serve exports it).")
_register("MXTPU_RPC_TIMEOUT_S", 2.0, float, "one RPC's timeout.")
_register("MXTPU_RPC_RETRIES", 2, int, "retries of an idempotent RPC.")
_register("MXTPU_RPC_BACKOFF_S", 0.05, float, "first retry backoff.")
_register("MXTPU_RPC_BACKOFF_MAX_S", 1.0, float, "largest retry backoff.")
_register("MXTPU_RPC_HEARTBEAT_S", 0.5, float, "proxy heartbeat period.")
_register("MXTPU_RPC_SUSPECT_AFTER", 2.0, float,
          "missed heartbeats before a replica is suspected.")
_register("MXTPU_RPC_DEAD_AFTER_S", 10.0, float,
          "seconds of silence before a suspected replica is dead.")
_register("MXTPU_RPC_BREAKER_THRESHOLD", 3, int,
          "consecutive failures that trip a proxy's breaker.")
_register("MXTPU_RPC_BREAKER_COOLDOWN_S", 1.0, float,
          "breaker open time before its half-open probe.")
_register("MXTPU_RPC_ALLOW_INJECT", 0, int,
          "1 lets the RPC plane accept fault-injection requests.")

#: reference (MXNet) knobs with no counterpart here, and where the
#: concern went (docs/how_to/env_var.md names; listed so migrating users
#: can grep).
ABSORBED = {
    "MXNET_GPU_WORKER_NTHREADS": "one CUDA stream; kernels queue on it",
    "MXNET_GPU_COPY_NTHREADS": "copies queue on the device's stream",
    "MXNET_CPU_PRIORITY_NTHREADS": "no priority queue; eager launches",
    "MXNET_CPU_NNPACK_NTHREADS": "no NNPACK; torch's CPU kernels",
    "MXNET_EXEC_ENABLE_INPLACE": "the fused step updates in place",
    "NNVM_EXEC_MATCH_RANGE": "torch's caching allocator",
    "MXNET_EXEC_NUM_TEMP": "torch's caching allocator",
    "MXNET_GPU_MEM_POOL_RESERVE": "torch's caching allocator",
    "MXNET_ENGINE_TYPE": "no dependency engine; stream order",
    "MXNET_EXEC_BULK_EXEC_INFERENCE": "the executor's plan runs eagerly",
    "MXNET_EXEC_BULK_EXEC_TRAIN": "the executor's plan runs eagerly",
    "MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN": "the plan runs eagerly",
    "MXNET_KVSTORE_REDUCTION_NTHREADS": "one bucketed torch.distributed "
                                        "all-reduce a push",
    "MXNET_KVSTORE_BIGARRAY_BOUND": "no key is split: one bucket a push",
    "MXNET_ENABLE_GPU_P2P": "NCCL picks NVLink or PCIe itself",
    "MXNET_BACKWARD_DO_MIRROR": "torch.utils.checkpoint",
    "MXNET_CUDNN_AUTOTUNE_DEFAULT": "torch.backends.cudnn.benchmark",
    "MXNET_PROFILER_MODE": "profiler.py records all scopes",
}

#: the JAX package's registered knobs this package does not read, and
#: why: XLA or Pallas mechanics with no counterpart, or a module of a
#: later slice
REFERENCE_ONLY = {
    "MXTPU_ATTENTION_IMPL": "no choice to make: a CUDA tensor launches "
                            "the flash kernel, a CPU tensor runs its "
                            "plain version",
    "MXTPU_FLASH_BWD_DQ_BYTES": "the fused backward (B7) adds dq by fp32 "
                                "atomics and keeps no dq-partial buffer",
    "MXTPU_CHECKPOINT_FORMAT": "the port writes the V2 binary .params "
                               "format only",
    "MXTPU_AOT_CACHE_DIR": "no persisted compiled artifact: the kernels "
                           "are built once into ops/_build",
    "BENCH_BATCH": "bench.py (the JAX package's benchmark) is not ported",
    "BENCH_STEPS": "bench.py is not ported",
    "BENCH_WARMUP": "bench.py is not ported",
    "BENCH_IMAGE": "bench.py is not ported",
    "BENCH_DTYPE": "bench.py is not ported",
    "BENCH_MODE": "bench.py is not ported",
    "BENCH_COST_ANALYSIS": "bench.py is not ported",
    "BENCH_NETWORK": "bench.py is not ported",
    "BENCH_PROFILE": "bench.py is not ported",
    "BENCH_INIT_TIMEOUT": "bench.py is not ported",
    "BENCH_PIPE_THREADS": "bench.py is not ported",
    "BENCH_PIPE_IMAGES": "bench.py is not ported",
    "BENCH_PIPE_EPOCHS": "bench.py is not ported",
}


def flag(name):
    """Resolve a registered flag: environment (primary name, then
    aliases), else default.  Raises KeyError for unregistered names so
    stray env reads don't creep back in."""
    spec = FLAGS[name]
    for key in (spec.name,) + spec.aliases:
        raw = os.environ.get(key)
        if raw is not None:
            return spec.type(raw)
    return spec.default


def describe():
    """Human-readable table of all flags (value <- source)."""
    lines = []
    for spec in FLAGS.values():
        val = flag(spec.name)
        src = "env" if any(k in os.environ
                           for k in (spec.name,) + spec.aliases) \
            else "default"
        lines.append("%-32s %-10r (%s)  %s"
                     % (spec.name, val, src, spec.doc))
    lines.append("")
    lines.append("Reference knobs absorbed by the PyTorch design:")
    for k, why in ABSORBED.items():
        lines.append("  %-40s -> %s" % (k, why))
    lines.append("")
    lines.append("JAX-package knobs this package does not read:")
    for k, why in REFERENCE_ONLY.items():
        lines.append("  %-40s -> %s" % (k, why))
    return "\n".join(lines)
