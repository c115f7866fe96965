"""SyncBN on two gloo ranks against one layer on the concatenated rows (port
only): a test of ``test_torch_ddp_port.py``, at its tolerances. A file of at
most five tests, so that xdist's ``--dist loadfile`` (files with more tests
first) queues it behind ``tests/test_train.py``, the run's longest file.
"""
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.models.layers import MaskedBatchNorm
from test_torch_ddp_port import BN_CASES, BN_SUM_TOL, BN_TOL, two_ranks
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", BN_CASES)
def test_sync_batchnorm_two_ranks_equal_one_layer_on_the_concatenated_rows(two_ranks, case):
    (xs, valids, cot), ranks = two_ranks["bn"][case]
    m = MaskedBatchNorm(xs[0].shape[1]).train()
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, m.weight.numel()))
        m.bias.copy_(torch.linspace(-0.2, 0.2, m.bias.numel()))
    x = torch.as_tensor(np.concatenate(xs)).requires_grad_(True)
    y = m(x, torch.as_tensor(np.concatenate(valids)))
    y.backward(torch.as_tensor(np.concatenate(cot)))
    split = np.cumsum([len(a) for a in xs])[:-1]
    for name, ref in (("y", y), ("dx", x.grad)):
        got = np.concatenate([r[name] for r in ranks])
        np.testing.assert_allclose(got, ref.detach().numpy(), rtol=BN_TOL, atol=BN_TOL,
                                   err_msg=name)
    assert len(np.split(x.grad.numpy(), split)[1]) == len(xs[1])
    # parameter gradients: the mean over ranks of each rank's; the one layer's is their sum
    for name, ref in (("dweight", m.weight.grad), ("dbias", m.bias.grad)):
        for r in ranks:
            np.testing.assert_allclose(2 * r[name], ref.numpy(), rtol=BN_SUM_TOL,
                                       atol=BN_SUM_TOL, err_msg=name)
    for name in ("running_mean", "running_var"):
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
        np.testing.assert_allclose(ranks[0][name], getattr(m, name).numpy(), rtol=BN_TOL,
                                   atol=BN_TOL, err_msg=name)
