"""``correct`` at a size that a CPU test holds, driven through the harness's
own run with the look for a card skipped: the program is correct; the
control in its place (the reference one precision step down: fp8 sparse-UNet
operands, TF32 dense layers) is not; and each fault that a cell can have
turns it false: an answer altered where it is produced (serving: a box
moved; training: the backward's weight gradient with its taps reversed, or
its input gradient scaled), a step that returns its state unchanged
(training). Half a batch left out and the
exchange between chips do not apply: every cell runs one sample on one
card."""
import pytest
import torch

from benchmark import calibrate
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.train"])
def test_program_is_correct(root, cell):
    res = tiny.run(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.train"])
def test_control_is_not_correct(root, cell):
    with calibrate.control():
        res = tiny.run(root, cell)
    assert not res["correct"], res["checks"]


def test_altered_answer_is_not_correct(root, monkeypatch):
    from fullysparsefusion_tpu_torch.models.fsf import FSF

    served = FSF.get_bboxes

    def altered(self, result, batch_size):
        det = served(self, result, batch_size)
        return det._replace(boxes=det.boxes + torch.tensor([0.5] + [0.0] * (det.boxes.shape[-1] - 1)))

    monkeypatch.setattr(FSF, "get_bboxes", altered)
    res = tiny.run(root, "tiny.stream")
    assert not res["correct"], res["checks"]


def test_unchanged_state_is_not_correct(root, monkeypatch):
    from fullysparsefusion_tpu_torch.parallel import train

    monkeypatch.setattr(train, "optimizer_step", lambda opt, step: torch.zeros(()))
    res = tiny.run(root, "tiny.train")
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_leaf_gap"]["value"] > 0.99


@pytest.mark.parametrize("kind", ["dw_taps_reversed", "dfeats_scaled"])
def test_altered_gradient_is_not_correct(root, kind):
    with calibrate.fault(kind):
        res = tiny.run(root, "tiny.train")
    assert not res["correct"], res["checks"]
    assert res["checks"]["grad_diff_gap"]["value"] > res["checks"]["grad_diff_gap"]["limit"]


def test_plain_path_is_correct(root):
    """The witness's plain arithmetic in the program's place (calibrate.py
    --program-path plain) reads the reference's numbers exactly."""
    with calibrate.program_path("plain"):
        res = tiny.run(root, "tiny.train")
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
