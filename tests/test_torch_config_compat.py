"""The port's ``config_compat.py`` against the JAX package's on the CPU, on
the reconstructed reference configs under ``tests/torch_reference_configs``
(the reference's own files are not in the repository): the raw mmcv-style
dicts equal, the interpreted ``FSFConfig`` equal field for field
(``dataclasses.asdict``) and equal to the port's ``nusc_fsf_config()`` /
``av2_fsf_config()``; ``_base_`` lists and ``_delete_`` merge as the JAX
package merges them. Everything is exact: both sides are the same Python.
"""
import dataclasses
import os

import pytest

from fullysparsefusion_tpu import config_compat as J
from fullysparsefusion_tpu_torch import config_compat as T
from fullysparsefusion_tpu_torch.config import av2_fsf_config, nusc_fsf_config
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_reference_configs")
FILES = {
    "nuscenes": (os.path.join(CONFIGS, "nuScenes", "FSF_nuScenes_config.py"), nusc_fsf_config),
    "av2": (os.path.join(CONFIGS, "Argoverse2", "FSF_AV2_config.py"), av2_fsf_config),
}


def _raw_has_no_velocity(path):
    """The AV2 heads replaced the base's through ``_delete_``: no velocity
    loss and no ``_delete_`` key left behind."""
    m = T.load_reference_config(path)["model"]
    heads = (m["bbox_head"], m["frustum_obj_head"], m["refined_obj_head"][0])
    return all("loss_vel" not in h and "_delete_" not in h for h in heads)


@pytest.mark.parametrize("name", list(FILES))
def test_load_reference_config_matches_jax(name):
    path, _ = FILES[name]
    raw = T.load_reference_config(path)
    assert raw == J.load_reference_config(path)
    assert raw["model"]["type"] == "FSF"
    # the _base_ chain pulled the runtime and the dataloader config
    assert raw["load_from"] is None and raw["data"]["test"]["test_mode"] is True
    assert raw["data"]["samples_per_gpu"] == 1


@pytest.mark.parametrize("name", list(FILES))
def test_load_fsf_config_matches_jax_and_the_port_config(name):
    path, port_config = FILES[name]
    cfg = T.load_fsf_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J.load_fsf_config(path))
    assert cfg == port_config()
    caps = dataclasses.replace(cfg.caps, points=4096)
    assert T.load_fsf_config(path, caps).caps == caps
    if name == "nuscenes":
        # what tests/test_config_compat.py asserts of the reference's file
        f = cfg.fsd
        assert f.segmentor.voxel_size == (0.2, 0.2, 0.2)
        assert f.segmentor.unet_encoder_channels[4] == (512, 512, 512)
        assert f.segmentor.unet_strided_paddings[2] == (1, 1, 0)  # (0, 1, 1) zyx
        assert f.connected_dists == (0.6, 0.6, 0.6, 0.2, 0.4, 0.1)
        assert cfg.frustum_head.in_channel == 128 * 3 * 2 + 128
        assert (cfg.refine_max_dist[0], cfg.refine_max_dist[3], cfg.refine_max_dist[9]) == \
            (1.0, 4.0, 0.0)
    else:
        assert cfg.num_classes == 26 and cfg.num_cams == 7 and cfg.fsd.head.code_size == 8
        assert _raw_has_no_velocity(path)


def test_merge_with_a_list_base_and_delete_matches_jax(tmp_path):
    (tmp_path / "a.py").write_text(
        "model = dict(type='FSF', head=dict(in_channel=1, loss=dict(w=1.0), keep=[1, 2]))\n"
        "data = dict(train=dict(type='A', n=1), n=0)\n")
    (tmp_path / "b.py").write_text(
        "model = dict(head=dict(loss=dict(g=2.0)), extra=3)\nrate = 0.5\n")
    (tmp_path / "c.py").write_text(
        "_base_ = ['a.py', 'b.py']\n"
        "model = dict(head=dict(loss=dict(_delete_=True, w=5.0), keep=[3]))\n"
        "data = dict(train=dict(_delete_=True, type='B'))\n")
    path = str(tmp_path / "c.py")
    raw = T.load_reference_config(path)
    assert raw == J.load_reference_config(path)
    assert raw == {
        "model": {"type": "FSF", "head": {"in_channel": 1, "loss": {"w": 5.0}, "keep": [3]},
                  "extra": 3},
        "data": {"train": {"type": "B"}, "n": 0}, "rate": 0.5}
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": [1]}
    over = {"a": {"c": {"_delete_": True, "f": 3}}, "e": [2], "g": {"_delete_": True}}
    assert T._merge(base, over) == J._merge(base, over) == {
        "a": {"b": 1, "c": {"f": 3}}, "e": [2], "g": {}}
    assert base == {"a": {"b": 1, "c": {"d": 2}}, "e": [1]}  # not modified
