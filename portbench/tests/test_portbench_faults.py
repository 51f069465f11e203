"""A run with the timed path broken underneath must come out not correct.

Each test drives a whole tiny run on the CPU (the harness's look for a
card skipped, the cell's real limits) with one fault planted in the
program, and reads ``correct``; the same run unbroken reads True."""
import pytest
import torch

from portbench import run
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


def result(root, name):
    return run.execute(tiny.cell(root, name), SEED, 0.6, False, CPU)


@pytest.mark.parametrize("name", ["tiny.train_dense", "tiny.train_packed",
                                  "tiny.serve_decode"])
def test_a_sound_run_is_correct(root, name):
    res = result(root, name)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("name", ["tiny.train_dense", "tiny.train_packed"])
def test_a_step_that_leaves_the_state_unchanged_fails(root, name,
                                                      monkeypatch):
    from mxnet_tpu_torch.gluon import Trainer
    monkeypatch.setattr(Trainer, "step", lambda self, *a, **k: None)
    res = result(root, name)
    assert res["correct"] is False
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["tiny.train_dense", "tiny.train_packed"])
def test_half_the_batch_left_out_fails(root, name, monkeypatch):
    from mxnet_tpu_torch.gluon import loss as gloss
    orig = gloss.SoftmaxCrossEntropyLoss.hybrid_forward

    def half(self, F, pred, label, *args, **kwargs):
        n = pred.shape[0] // 2
        return orig(self, F, pred[:n], label[:n], *args, **kwargs)

    monkeypatch.setattr(gloss.SoftmaxCrossEntropyLoss, "hybrid_forward",
                        half)
    res = result(root, name)
    assert res["correct"] is False, res["checks"]


def test_a_token_altered_where_it_is_produced_fails(root, monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    orig = gpt.paged_decode_step

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        return (out[0], (out[1] + 1) % out[0].shape[-1]) + tuple(out[2:])

    monkeypatch.setattr(gpt, "paged_decode_step", altered)
    res = result(root, "tiny.serve_decode")
    assert res["correct"] is False


def test_a_cache_that_keeps_no_keys_fails(root, monkeypatch):
    """The decode state left unchanged: no K/V reaches the pages."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    monkeypatch.setattr(gpt, "_scatter_kv", lambda *a, **k: {})
    res = result(root, "tiny.serve_decode")
    assert res["correct"] is False
