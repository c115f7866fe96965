"""Whole-model export of FSF (``cli/export_model.py``) on the CPU, against the
JAX package's ``tools/export_model.py``: the cases and tolerances of
``test_torch_export_fsd.py`` (its docstring), on the tiny FSF with its
cameras, ``(PointBatch, CameraData) -> (cls_logits, reg_preds, centers)``
of the last refinement stage."""
import pytest

from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_export_fsd import (check_cli, check_fresh_process, check_jax_weights,
                                   check_ops_in_graph, check_second_seed, export_case)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return export_case("fsf", tmp_path_factory)


def test_cli_export_check_passes(exported):
    check_cli(exported)


def test_fresh_process_serves_the_artifact_without_model_code(exported, tmp_path):
    check_fresh_process(exported, tmp_path)


def test_artifact_with_jax_weights_matches_jax(exported):
    check_jax_weights(exported)


def test_artifact_with_a_second_seed_matches_that_model(exported):
    check_second_seed(exported)


def test_artifact_calls_the_fsf_ops(exported):
    check_ops_in_graph(exported)
