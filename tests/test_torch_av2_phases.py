"""The tiny AV2-shaped FSF's phases and output shapes against the JAX package
on the CPU: tests of ``test_torch_av2.py``'s fixture, at its tolerances. A
file of at most five tests, so that xdist's ``--dist loadfile`` (files with
more tests first) queues it behind ``tests/test_train.py``, the run's
longest file.
"""
import pytest

from test_torch_av2 import BF16_CHAIN_TOL, parity
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import PHASES, _check


@pytest.mark.parametrize("phase", list(PHASES))
def test_av2_phase_matches_jax(parity, phase):
    ref, got = PHASES[phase](parity["jout"]), PHASES[phase](parity["out"])
    assert set(ref) == set(got)
    for name in ref:
        _check(name, ref[name], got[name], BF16_CHAIN_TOL)


def test_av2_shapes(parity):
    """26 classes and code size 8 through every head; 7 cameras in the
    lookup; the VFE sees 4 + 6 input channels."""
    out, model = parity["out"], parity["model"]
    assert out["seg_out"]["seg_logits"].shape[1] == 27
    for head in (out["frustum"]["out"], out["fsd"], out["final"]):
        assert head["cls_logits"].shape[1] == 26 and head["reg_preds"].shape[1] == 8
    vfe = model.seg_core.DynamicScatterVFE_0.DynamicVFELayer_0.Dense_0
    assert vfe.in_features == 10
    assert parity["det"].boxes.shape[-1] == 7          # no velocity columns
