"""The controls on the card, at the cells' widths and a depth and batch a
test run holds: the sound program stays within every limit, and the
control, the reference one precision below the configuration's put in
the program's place, breaks at least one.  The cells' own limits were
set at the cells' own sizes; at this size the numbers read otherwise, so
the limits here were set the same way from readings at this size (the
sound program's largest and the control's smallest on the card, PERF.md
section 2).  Run on the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \\
        portbench/tests/test_portbench_control.py
"""
import json
import os

import pytest
import torch

from portbench import compare, run, spec
from portbench.drivers import serve, train

LAYERS = 6
ROWS = 4
SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)

#: limits at LAYERS layers and ROWS rows a batch, from 8 seeds on the
#: card: the sound program's largest reading and the control's smallest.
#: Where the control does not read above the program at this size
#: (``delta_gap``; the packed cell's ``loss_gap``), the limit holds the
#: sound program with room and the control fails another number.
LIMITS = {
    # sound 1.47e-4, 1.31e-3, 6.03e-3; control 9.12e-4, 5.16e-3, 5.84e-3
    "gpt2_medium.train_dense": {"loss_gap": 4e-4, "grad_gap": 3e-3,
                                "delta_gap": 1e-2},
    # sound 3.48e-3, 1.62e-3, 2.08e-2; control 3.64e-3, 6.22e-3, 5.62e-3
    "gpt2_small.train_packed": {"loss_gap": 7e-3, "grad_gap": 3.5e-3,
                                "delta_gap": 0.04},
}
#: sound 0 on 4 seeds, control 9.75e-4 or more: the cell's own limit
SERVE_LIMIT = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run.set_precision()
    return torch.device("cuda", 0)


def reduced_cell(name, **traffic):
    cell = spec.Cell(spec.ROOT, spec.load(), name)
    cell.config = dict(cell.config, n_layer=LAYERS)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def train_readings(name, seed, device):
    """``(sound, control)``: the compared numbers of the program and of
    the fp8 reference, each against the fp32 reference."""
    cell = reduced_cell(name, batch=ROWS, pool=4)
    prog, batches, got = train.program_first_steps(cell, seed, device)
    del prog
    train.free()
    ref = train.reference_steps(cell, seed, batches, device)
    ctl = train.reference_steps(cell, seed, batches, device,
                                precision="fp8")
    return (compare.training_numbers(got, ref),
            compare.training_numbers(ctl, ref))


def serve_readings(seed, device, seconds=4.0):
    """``(sound, control, served tokens)`` of the serving cell at 32
    clients and slots: the widest logit gap of the program's served
    tokens and of the TF32 reference's best tokens."""
    cell = reduced_cell("gpt2_medium.serve_decode", clients=32,
                        warmup_s=0.5)
    cell.spec = json.loads(json.dumps(cell.spec))
    cell.spec["engine"]["num_slots"] = 32
    _, sample = serve.serve(cell, seed, seconds, False, device,
                            run.Clock(device))
    return (serve.reference_gaps(cell, seed, sample, device),
            serve.reference_gaps(cell, seed, sample, device,
                                 control="tf32"),
            sum(len(s) for _, s in sample))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_fp8_control_breaks_a_training_limit(cuda, name):
    limits = LIMITS[name]
    for seed in SEEDS:
        sound, control = train_readings(name, seed, cuda)
        assert compare.passes(compare.held(sound, limits)), sound
        assert not compare.passes(compare.held(control, limits)), control


@pytest.mark.gpu
def test_tf32_control_breaks_the_serving_limit(cuda):
    for seed in SEEDS:
        sound, control, tokens = serve_readings(seed, cuda)
        assert tokens >= 200
        assert sound <= SERVE_LIMIT
        assert control > SERVE_LIMIT


def test_the_control_test_reads_the_cells_files():
    # at import time nothing touches the card: the markers decide
    names = {w["name"] for w in spec.load()["workloads"]}
    assert set(LIMITS) | {"gpt2_medium.serve_decode"} <= names
    assert os.path.exists(os.path.join(spec.PACKAGE, "reference",
                                       "gpt2.py"))
