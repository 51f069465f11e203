"""The port's ``dist*`` KVStores on ``torch.distributed`` (gloo on the
host) against the JAX package's semantics.

- Two port workers under the unchanged ``tools/launch.py -n 2 --launcher
  local --cpu-fake-devices`` (this file run as a script, ``worker OUT``):
  ``rank``/``num_workers``; a push of ones and twos from the two ranks
  pulls 3.0 everywhere (the reference's ``tests/nightly``-style sum); an
  optimizer on the store leaves both workers' weights bitwise equal; the
  2-bit compressed push (two rounds, residuals carried) pulls exactly the
  sum of the two ranks' codes decoded, as the reference's
  ``_compress_step`` computes them on the same values; ``barrier``
  returns; the store counts the bytes it sent (16 times fewer
  compressed).
- Bring-up laws without a second worker (a world of one without a
  coordinator: ``tests/test_torch_kvstore.py``): rank 0 whose
  coordinator port is taken exits 76; a worker whose coordinator never
  answers raises ``MXNetError`` naming it; under NCCL the ranks of one
  host take its cards in rank order, and two ranks on one card raise
  ``MXNetError`` naming ``MXTPU_DIST_BACKEND``; the flag takes '' or
  'gloo' only.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(REPO, "tools", "launch.py")
THRESHOLD = 0.5
SIZE = 1001


def _grad(rank, step):
    rng = np.random.default_rng(100 * rank + step)
    return (rng.standard_normal(SIZE) * 0.7).astype(np.float32)


def worker(out):
    import mxnet_tpu_torch as mx
    kv = mx.kv.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    cpu = mx.cpu()
    doc = {"rank": rank, "num_workers": n}
    # a plain sum: ones from rank 0, twos from rank 1
    kv.init("3", mx.nd.ones((2, 3), ctx=cpu))
    kv.push("3", mx.nd.array(np.full((2, 3), rank + 1, np.float32),
                             ctx=cpu))
    out3 = mx.nd.zeros((2, 3), ctx=cpu)
    kv.pull("3", out=out3)
    doc["sum"] = out3.asnumpy().tolist()
    plain_bytes = kv.stats["wire_bytes"]
    # an optimizer on the store: every worker updates on the same sum
    kv2 = mx.kv.create("dist_sync")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9, rescale_grad=0.5))
    w0 = np.random.default_rng(7).standard_normal((4, 5)).astype(np.float32)
    kv2.init("w", mx.nd.array(w0, ctx=cpu))
    for step in range(3):
        g = np.random.default_rng(10 * rank + step).standard_normal(
            (4, 5)).astype(np.float32)
        kv2.push("w", [mx.nd.array(g, ctx=cpu)])
    w = mx.nd.zeros((4, 5), ctx=cpu)
    kv2.pull("w", out=w)
    doc["w"] = w.asnumpy().tobytes().hex()
    # the compressed push, residuals carried over two rounds
    kv.set_gradient_compression({"type": "2bit", "threshold": THRESHOLD})
    kv.init("g", mx.nd.zeros((SIZE,), ctx=cpu))
    got = []
    for step in range(2):
        before = kv.stats["wire_bytes"]
        kv.push("g", mx.nd.array(_grad(rank, step), ctx=cpu))
        doc["compressed_bytes"] = kv.stats["wire_bytes"] - before
        o = mx.nd.zeros((SIZE,), ctx=cpu)
        kv.pull("g", out=o)
        got.append(o.asnumpy().tolist())
    doc["compressed"] = got
    doc["plain_bytes"] = plain_bytes
    kv.barrier()
    doc["barrier"] = True
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(doc, f)


def _launch(tmp_path, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MXTPU_COORDINATOR", None)
    r = subprocess.run(
        [sys.executable, LAUNCH, "-n", "2", "--launcher", "local",
         "--cpu-fake-devices", "--", sys.executable,
         os.path.abspath(__file__), "worker", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return [json.load(open(tmp_path / ("rank%d.json" % i)))
            for i in range(2)]


def _reference_compressed():
    """The two ranks' pushes through the reference's ``_compress_step``
    (residuals carried), decoded and summed."""
    import jax.numpy as jnp
    from mxnet_tpu import gradient_compression as jgc
    res = [jnp.zeros(SIZE, jnp.float32) for _ in range(2)]
    sums = []
    for step in range(2):
        total = np.zeros(SIZE, np.float32)
        for rank in range(2):
            packed, res[rank] = jgc._compress_step(
                jnp.asarray(_grad(rank, step)), res[rank],
                jnp.float32(THRESHOLD))
            total = total + np.asarray(jgc._decode(
                packed, jnp.float32(THRESHOLD), SIZE))
        sums.append(total)
    return sums


def test_two_workers_push_pull_compress_barrier(tmp_path):
    """The one multi-process case of tier 1 (about 5 s)."""
    docs = _launch(tmp_path)
    assert [d["rank"] for d in docs] == [0, 1]
    assert all(d["num_workers"] == 2 and d["barrier"] for d in docs)
    for d in docs:
        np.testing.assert_array_equal(np.asarray(d["sum"]),
                                      np.full((2, 3), 3.0, np.float32))
    # the updater ran on the same sum in both workers: bitwise equal
    assert docs[0]["w"] == docs[1]["w"]
    want = _reference_compressed()
    for d in docs:
        for got, w in zip(d["compressed"], want):
            np.testing.assert_array_equal(np.asarray(got, np.float32), w)
    # the wire: one all-reduce of 6 fp32 values, then ceil(1001 / 4)
    # packed bytes a push (16 times fewer than its 4004 fp32 bytes)
    assert docs[0]["plain_bytes"] == 6 * 4
    assert docs[0]["compressed_bytes"] == -(-SIZE // 4)


def _env(port, rank, world=2, **extra):
    env = dict(os.environ, PYTHONPATH=REPO,
               MXTPU_COORDINATOR="127.0.0.1:%d" % port,
               MXTPU_NUM_WORKERS=str(world), MXTPU_WORKER_RANK=str(rank))
    env.update(extra)
    return env


_CREATE = "import mxnet_tpu_torch as mx; mx.kv.create('dist_sync')"


def test_rank0_on_a_taken_port_exits_76():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        r = subprocess.run([sys.executable, "-c", _CREATE],
                           env=_env(port, 0), capture_output=True,
                           text=True, timeout=60)
    assert r.returncode == 76, r.stderr[-2000:]
    assert "already bound" in r.stderr


def test_worker_with_a_dead_coordinator_raises_naming_it():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]      # closed: nobody listens there
    r = subprocess.run([sys.executable, "-c", _CREATE],
                       env=_env(port, 1, MXTPU_CONNECT_TIMEOUT="0.5",
                                MXTPU_CONNECT_RETRIES="0"),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0
    assert "MXNetError" in r.stderr and "127.0.0.1:%d" % port in r.stderr


def test_two_ranks_on_one_card_under_nccl_raise(monkeypatch):
    from mxnet_tpu_torch import base
    from mxnet_tpu_torch.base import MXNetError
    store = torch.distributed.HashStore()
    monkeypatch.setattr(base, "_card_id", lambda: "host/GPU-same")
    store.set("mxtpu/card/1", "host/GPU-same")
    with pytest.raises(MXNetError, match="MXTPU_DIST_BACKEND=gloo"):
        base._check_distinct_cards(store, "cpu:gloo,cuda:nccl", 0, 2)
    # gloo carries both ranks' CUDA tensors: no check
    base._check_distinct_cards(store, "gloo", 0, 2)


def _bring_up_cards(monkeypatch, n_cards, num=2):
    """Each of ``num`` ranks of one host (threads sharing one store) runs
    bring-up's card step with ``n_cards`` cards mocked; returns {rank:
    card or the error}."""
    import threading
    from mxnet_tpu_torch import base
    local = threading.local()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: setattr(local, "dev", i))
    monkeypatch.setattr(base, "_card_id", lambda: "host/GPU-%d"
                        % getattr(local, "dev", 0))
    store, out = torch.distributed.HashStore(), {}

    def rank(r):
        try:
            base._check_distinct_cards(store, "cpu:gloo,cuda:nccl", r, num)
            out[r] = base._card_id()
        except base.MXNetError as e:
            out[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(num)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out


def test_ranks_of_one_host_take_distinct_cards_under_nccl(monkeypatch):
    assert _bring_up_cards(monkeypatch, 2) == {0: "host/GPU-0",
                                               1: "host/GPU-1"}
    # more ranks than cards: the last ranks share, and bring-up raises
    out = _bring_up_cards(monkeypatch, 1)
    assert all(isinstance(e, Exception) and "MXTPU_DIST_BACKEND=gloo"
               in str(e) for e in out.values()) and len(out) == 2


def test_backend_follows_the_device_and_the_flag(monkeypatch):
    from mxnet_tpu_torch import base
    monkeypatch.delenv("MXTPU_DIST_BACKEND", raising=False)
    want = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    assert base._choose_backend() == want
    monkeypatch.setenv("MXTPU_DIST_BACKEND", "gloo")
    assert base._choose_backend() == "gloo"
    for bad in ("mpi", "nccl"):
        monkeypatch.setenv("MXTPU_DIST_BACKEND", bad)
        with pytest.raises(base.MXNetError):
            base._choose_backend()


def test_row_sparse_pull_names_s6():
    import mxnet_tpu_torch as tmx
    kv = tmx.kv.create("local")
    with pytest.raises(tmx.base.MXNetError, match="S6"):
        kv.row_sparse_pull("w", out=tmx.nd.zeros((3,), ctx=tmx.cpu()),
                           row_ids=None)


if __name__ == "__main__" and len(sys.argv) > 2 and \
        sys.argv[1] == "worker":
    worker(sys.argv[2])
