"""The plain reference against the port at a tiny size on the CPU: the
same weights and inputs give the same logits, losses, gradients and
updates.  This test imports both; the reference imports neither the port
nor JAX (``test_portbench_harness.py`` checks that)."""
import importlib

import numpy as np
import pytest
import torch

from portbench import compare, port
from portbench.drivers import serve, train
from portbench.reference import gpt2
from portbench.weights import make_weights

CFG = {"n_layer": 2, "n_embd": 64, "n_head": 4, "n_ctx": 64,
       "vocab_size": 200,
       "optimizer": {"lr": 3e-4, "beta1": 0.9, "beta2": 0.999,
                     "epsilon": 1e-8}}
CPU = torch.device("cpu")


def segments(b, t, seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(1, 5, (b, t)), axis=1)
    seg[:, -3:] = 0                                  # padding at the end
    return torch.from_numpy(seg.astype(np.int32))


@pytest.mark.parametrize("packed", [False, True])
def test_logits_equal_the_ports(packed):
    w = make_weights(CFG, 11, CPU)
    net = port.build_gpt(CFG, w, CPU)
    x = torch.randint(0, CFG["vocab_size"], (3, 40),
                      generator=torch.Generator().manual_seed(1))
    seg = segments(3, 40, 2) if packed else None
    with torch.no_grad():
        got = net(x) if seg is None else net(x, seg)
        want = gpt2.forward(w, CFG, x, seg)
    assert want.shape[-1] == gpt2.pad_vocab(CFG["vocab_size"])
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_packed_positions_restart_at_each_document():
    seg = torch.tensor([[1, 1, 2, 2, 2, 3, 0, 0]])
    assert gpt2.positions(seg, 8, "cpu").tolist() == \
        [[0, 1, 0, 1, 2, 0, 0, 1]]


class _Cell:
    def __init__(self, packed):
        self.config = CFG
        self.spec = {"precision": "fp32", "first_steps": 3,
                     "rows_per_pass": 2}
        self.traffic = (
            {"kind": "packed_documents", "batch": 4, "seq_len": 32,
             "pool": 4, "over": 1.5,
             "doc_len": {"median": 8, "sigma": 1.0, "min": 2, "max": 32}}
            if packed else
            {"kind": "dense_batches", "batch": 4, "seq_len": 32, "pool": 4})

    def generator(self):
        return importlib.import_module("portbench.generators."
                                       + self.traffic["kind"])


@pytest.mark.parametrize("packed", [False, True])
def test_training_steps_equal_the_ports(packed):
    """Three Adam steps of the port's Gluon loop in fp32 against the
    reference's: losses, the first gradient as Adam holds it, and every
    weight's change."""
    cell = _Cell(packed)
    _, batches, got = train.program_first_steps(cell, 5, CPU)
    want = train.reference_steps(cell, 5, batches, CPU)
    for a, b in zip(got["losses"], want["losses"]):
        assert a == pytest.approx(b, abs=1e-5)
    nums = compare.training_numbers(got, want)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["delta_gap"] < 1e-3


def test_reference_passes_split_into_rows_add_up():
    """The reference's gradient over a batch does not depend on how many
    rows go through at once."""
    cell = _Cell(False)
    batches = train.make_batches(cell, 3, CPU)
    w = make_weights(CFG, 3, CPU)
    one = gpt2.train(w, CFG, batches[:2], CFG["optimizer"], rows_per_pass=4)
    split = gpt2.train(w, CFG, batches[:2], CFG["optimizer"],
                       rows_per_pass=1)
    assert one["losses"] == pytest.approx(split["losses"], abs=1e-6)
    for n in one["grad_norms"]:
        assert one["grad_norms"][n] == pytest.approx(split["grad_norms"][n],
                                                     rel=1e-5, abs=1e-9)


def test_served_tokens_are_the_references_best():
    """The port's engine serves greedy tokens whose logits the reference
    puts first (to rounding) at every position."""
    from mxnet_tpu_torch.serving import ServingEngine
    w = make_weights(CFG, 21, CPU)
    net = port.build_gpt(CFG, w, CPU)
    eng = ServingEngine(net, num_slots=3, page_size=8, max_seq_len=64,
                        max_prefill_len=40, device=CPU)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 200, n).astype(np.int32), 12)
            for n in (5, 17, 33)]
    eng.run_until_idle()
    sample = [(r.prompt, list(r.tokens)) for r in reqs]

    class C:
        config = CFG
    assert serve.reference_gaps(C, 21, sample, CPU) < 1e-4
    # a token altered where it is produced shows
    bad = [(p, [t[0], (t[1] + 1) % 256] + t[2:]) for p, t in sample]
    assert serve.reference_gaps(C, 21, bad, CPU) > 1e-3
