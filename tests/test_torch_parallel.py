"""The port's ``parallel`` package (``mxnet_tpu_torch/parallel/``) against
the JAX package's.

- The spec functions (``match_partition_rules``, ``zero1_spec``,
  ``zero1_partition``, ``_validate_spec``, ``batch_spec``) on the names,
  shapes and mesh sizes of the reference's ``tests/test_parallel.py``
  sharding section: the port's specs equal the reference's, entry for
  entry.  Mesh construction (``make_mesh``, ``full_mesh``,
  ``device_mesh_shape``) gives the reference's axis sizes and errors.
- The collectives and ``shard_map`` in one spawned 4-rank gloo group (this
  file run as a script, ``worker RANK WORLD PORT OUT``) against the
  reference's ``shard_map`` over 4 virtual devices: sums of integers in
  float32, so the results are equal exactly.  The same group runs
  ``make_train_step`` on the small regression problem of the reference's
  ``test_data_parallel_step_matches_single_device`` (marked slow: four
  processes; ``-m slow`` runs it).
- ``make_train_step`` in one process (a world of one rank) against the
  reference's over a dp=8 mesh, 3 steps: loss and weights within 1e-6.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel.sharding import P as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_TOL = 1e-6
WORLD = 4


def _jpar():
    from mxnet_tpu import parallel
    return parallel


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _meshes(jpar, **sizes):
    import jax
    n = int(np.prod(list(sizes.values())))
    return (jpar.make_mesh(devices=jax.devices()[:n], **sizes),
            tpar.make_mesh(devices=list(range(n)), **sizes))


def _same(jspec, tspec):
    return tuple(jspec) == tuple(tspec)


# -- the spec functions ------------------------------------------------------

RULES = [(r"dense.*weight$", ("tp", None), 2),
         (r"embedding.*weight$", (None, "tp"), 2),
         (r"(gamma|beta)$", (), 1)]
PARAMS = {"block0_dense_weight": (16, 8), "block0_dense_bias": (16,),
          "embedding_weight": (32, 8), "norm_gamma": (8,), "t_scalar": (),
          "odd_dense_weight": (15, 8)}


def test_match_partition_rules_equals_reference():
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    jpar = _jpar()
    jm, tm = _meshes(jpar, dp=4, tp=2)
    jspecs = jpar.match_partition_rules(
        [(r, JP(*s), n) for r, s, n in RULES],
        {k: jnp.zeros(s) for k, s in PARAMS.items()}, mesh=jm)
    tspecs = tpar.match_partition_rules(
        [(r, TP(*s), n) for r, s, n in RULES],
        {k: torch.zeros(s) for k, s in PARAMS.items()}, mesh=tm)
    assert set(jspecs) == set(tspecs)
    for k in PARAMS:
        assert _same(jspecs[k], tspecs[k]), (k, jspecs[k], tspecs[k])
    assert tuple(tspecs["block0_dense_weight"]) == ("tp", None)
    assert tuple(tspecs["odd_dense_weight"]) == ()


@pytest.mark.parametrize("shape,mesh,base", [
    ((32, 16), {"dp": 8}, None), ((4, 32), {"dp": 8}, None),
    ((4,), {"dp": 8}, None), ((16, 8), {"dp": 4, "tp": 2}, ("tp", None)),
    ((16, 3), {"dp": 4, "tp": 2}, ("tp", None)),
    ((3, 5, 8), {"dp": 8}, None), ((7,), {"tp": 2}, None),
    ((64, 768), {"dp": 2}, None)])
def test_zero1_spec_equals_reference(shape, mesh, base):
    from jax.sharding import PartitionSpec as JP
    jpar = _jpar()
    jm, tm = _meshes(jpar, **mesh)
    want = jpar.zero1_spec(shape, jm,
                           base=JP(*base) if base is not None else None)
    got = tpar.zero1_spec(shape, tm,
                          base=TP(*base) if base is not None else None)
    assert _same(want, got), (want, got)


def test_zero1_partition_and_fallback_counter_equal_reference():
    import jax.numpy as jnp
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as ttel
    jpar = _jpar()
    jm, tm = _meshes(jpar, dp=8)
    shapes = {"w": (32, 16), "tiny": (3,), "fc2_weight": (4, 32)}
    counts = []
    for tel, par, mesh, mk in ((jtel, jpar, jm, jnp.zeros),
                               (ttel, tpar, tm, torch.zeros)):
        before = tel.report()["counters"].get("sharding.fallbacks", 0)
        specs = par.zero1_partition({k: mk(s) for k, s in shapes.items()},
                                    mesh)
        counts.append(tel.report()["counters"]["sharding.fallbacks"] -
                      before)
        if par is jpar:
            want = specs
    for k in shapes:
        assert _same(want[k], specs[k]), k
    assert counts[0] == counts[1] == 1


@pytest.mark.parametrize("spec,shape,mesh", [
    (("dp",), (3,), {"dp": 8}), (("dp", None), (16, 4), {"dp": 8}),
    (("tp", None), (16, 4), {"dp": 8}), ((("dp", "tp"),), (16,),
                                         {"dp": 4, "tp": 2}),
    ((None, "tp"), (4, 6), {"dp": 4, "tp": 2}), ((None, None), (4, 4),
                                                 {"dp": 8})])
def test_validate_spec_equals_reference(spec, shape, mesh):
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu.parallel import sharding as jshd
    from mxnet_tpu_torch.parallel import sharding as tshd
    jm, tm = _meshes(_jpar(), **mesh)
    assert _same(jshd._validate_spec(JP(*spec), shape, jm, name="v"),
                 tshd._validate_spec(TP(*spec), shape, tm, name="v"))


@pytest.mark.parametrize("ndim", [1, 2, 4])
def test_batch_spec_equals_reference(ndim):
    assert _same(_jpar().sharding.batch_spec(ndim),
                 tpar.sharding.batch_spec(ndim))


def test_mesh_construction_equals_reference():
    jpar = _jpar()
    import jax
    devs = jax.devices()[:8]
    for kw in ({"dp": 4, "tp": 2}, {"dp": 8}):
        assert dict(jpar.make_mesh(devices=devs, **kw).shape) == \
            dict(tpar.make_mesh(devices=range(8), **kw).shape)
    assert dict(jpar.make_mesh({"dp": -1, "tp": 2}, devices=devs).shape) \
        == dict(tpar.make_mesh({"dp": -1, "tp": 2},
                               devices=range(8)).shape)
    assert dict(jpar.mesh.full_mesh(devs, tp=2, pp=2).shape) == \
        dict(tpar.full_mesh(list(range(8)), tp=2, pp=2).shape)
    for par, d in ((jpar, devs), (tpar, list(range(8)))):
        with pytest.raises(ValueError):
            par.make_mesh(devices=d, dp=3, tp=2)
    assert tpar.device_mesh_shape(8, dp=-1, tp=2) == \
        jpar.mesh.device_mesh_shape(8, dp=-1, tp=2)
    # a job of one process: the default mesh is its one rank
    assert dict(tpar.make_mesh().shape) == {"dp": 1}


def test_dp_mesh_from_ctx_rejects_duplicates_and_names_s5b():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    m = tpar.dp_mesh_from_ctx([mx.cpu(i) for i in range(4)])
    assert dict(m.shape) == {"dp": 4}
    with pytest.raises(MXNetError, match="duplicate"):
        tpar.dp_mesh_from_ctx([mx.cpu(0), mx.cpu(0)])
    with pytest.raises(AttributeError, match="S5b"):
        tpar.ring_attention_fn


# -- one process: make_train_step ------------------------------------------

DIM, BATCH = 8, 16


def _problem():
    return ({"w": _rand(30, DIM, DIM), "b": np.zeros(DIM, np.float32)},
            {"x": _rand(31, BATCH, DIM), "y": _rand(32, BATCH, DIM)})


def _torch_loss(p, batch, rng):
    pred = batch["x"] @ p["w"] + p["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _reference_steps(steps=3):
    import jax
    import jax.numpy as jnp
    jpar = _jpar()
    params, batch = _problem()

    def loss_fn(p, b, rng):
        pred = b["x"] @ p["w"] + p["b"]
        return ((pred - b["y"]) ** 2).mean()
    init, step = jpar.make_train_step(
        loss_fn, jpar.make_mesh(devices=jax.devices()[:8], dp=8),
        donate=False)
    p, s = init({k: jnp.asarray(v) for k, v in params.items()})
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def _port_steps(mesh, steps=3):
    params, batch = _problem()
    init, step = tpar.make_train_step(_torch_loss, mesh, donate=False)
    p, s = init(params)
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, None)
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in p.items()}


def test_make_train_step_matches_reference():
    want_l, want_p = _reference_steps()
    got_l, got_p = _port_steps(tpar.make_mesh())
    np.testing.assert_allclose(got_l, want_l, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, err_msg=k)
    trainer = tpar.DataParallelTrainer(_torch_loss, tpar.make_mesh(),
                                       _problem()[0])
    assert float(trainer.step({k: torch.from_numpy(v) for k, v in
                               _problem()[1].items()}, None)) == \
        pytest.approx(got_l[0], rel=1e-6)


# -- a 4-rank gloo group ----------------------------------------------------

X = np.arange(8, dtype=np.float32)


def _collective_results(mesh):
    from mxnet_tpu_torch.parallel._shard_map import shard_map
    x = torch.from_numpy(X)
    x2 = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    out = {}
    out["allreduce"] = shard_map(lambda v: tpar.allreduce(v, "dp"), mesh,
                                 TP("dp"), TP("dp"))(x)
    out["allgather"] = shard_map(lambda v: tpar.allgather(v, "dp"), mesh,
                                 TP("dp"), TP(None))(x)
    out["reduce_scatter"] = shard_map(
        lambda v: tpar.reduce_scatter(v, "dp"), mesh, TP(None),
        TP("dp"))(x)
    out["ring_permute"] = shard_map(lambda v: tpar.ring_permute(v, "dp", 1),
                                    mesh, TP("dp"), TP("dp"))(x)
    out["broadcast_from"] = shard_map(
        lambda v: tpar.broadcast_from(v, "dp", 3), mesh, TP("dp"),
        TP("dp"))(x)
    out["alltoall"] = shard_map(
        lambda v: tpar.alltoall(v, "dp", 1, 0), mesh, TP("dp", None),
        TP("dp", None))(x2)
    out["axis_index"] = shard_map(
        lambda v: v * 0 + tpar.axis_index("dp") + 10 * tpar.axis_size("dp"),
        mesh, TP("dp"), TP("dp"))(x)
    return {k: v.numpy() for k, v in out.items()}


def _reference_collectives():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    jpar = _jpar()
    from mxnet_tpu.parallel._shard_map import shard_map
    mesh = jpar.make_mesh(devices=jax.devices()[:WORLD], dp=WORLD)
    x = jnp.asarray(X)
    x2 = jnp.arange(16, dtype=jnp.float32).reshape(4, 4)
    out = {
        "allreduce": shard_map(lambda v: jpar.allreduce(v, "dp"), mesh,
                               JP("dp"), JP("dp"))(x),
        "allgather": shard_map(lambda v: jpar.allgather(v, "dp"), mesh,
                               JP("dp"), JP(None))(x),
        "reduce_scatter": shard_map(lambda v: jpar.reduce_scatter(v, "dp"),
                                    mesh, JP(None), JP("dp"))(x),
        "ring_permute": shard_map(lambda v: jpar.ring_permute(v, "dp", 1),
                                  mesh, JP("dp"), JP("dp"))(x),
        "broadcast_from": shard_map(
            lambda v: jpar.collectives.broadcast_from(v, "dp", 3), mesh,
            JP("dp"), JP("dp"))(x),
        "alltoall": shard_map(lambda v: jpar.alltoall(v, "dp", 1, 0), mesh,
                              JP("dp", None), JP("dp", None))(x2),
        "axis_index": shard_map(
            lambda v: v * 0 + jpar.axis_index("dp") +
            10 * jpar.axis_size("dp"), mesh, JP("dp"), JP("dp"))(x),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank, world, port, out):
    """One rank of the group: the collectives and the train step, written
    to ``out`` by rank 0."""
    os.environ.update({"MXTPU_COORDINATOR": "127.0.0.1:%d" % port,
                       "MXTPU_NUM_WORKERS": str(world),
                       "MXTPU_WORKER_RANK": str(rank)})
    mesh = tpar.make_mesh()
    res = _collective_results(mesh)
    losses, params = _port_steps(mesh)
    res.update({"train_loss": np.asarray(losses), "train_w": params["w"],
                "train_b": params["b"]})
    if rank == 0:
        np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.slow
def test_collectives_and_train_step_in_a_gloo_group(tmp_path):
    out = str(tmp_path / "group.npz")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "worker", str(r), str(WORLD), str(port), out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-3000:]
    got = dict(np.load(out))
    want = _reference_collectives()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    want_l, want_p = _reference_steps()
    np.testing.assert_allclose(got["train_loss"], want_l, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    np.testing.assert_allclose(got["train_w"], want_p["w"], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    np.testing.assert_allclose(got["train_b"], want_p["b"], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)


if __name__ == "__main__" and len(sys.argv) > 1 and \
        sys.argv[1] == "worker":
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
           sys.argv[5])
