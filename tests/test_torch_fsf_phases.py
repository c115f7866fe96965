"""The tiny FSF's phases and decode against the JAX package on the CPU: tests
of ``test_torch_fsf.py``'s fixture, at its tolerances. A file of at most
five tests, so that xdist's ``--dist loadfile`` (files with more tests
first) queues it behind ``tests/test_train.py``, the run's longest file.
"""
import pytest

from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import BF16_CHAIN_TOL, PHASES, _check, parity


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_matches_jax(parity, phase):
    ref = PHASES[phase](parity["jout"])
    got = PHASES[phase](parity["out"])
    assert set(ref) == set(got)
    for name in ref:
        _check(name, ref[name], got[name], BF16_CHAIN_TOL)


def test_get_bboxes_matches_jax(parity):
    jdet, det = parity["jdet"], parity["det"]
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(jdet, f), getattr(det, f), BF16_CHAIN_TOL)
