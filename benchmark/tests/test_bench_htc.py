"""The HTC family at a size that a CPU test holds: a tiny ``htc_nusc``
(one bottleneck a stage, 16 proposals, 4 detections, two cameras at 96 ×
160, every detection pasted) joins a checkout by files and entries alone and
serves ``correct``; its work counter is a hand count; the control (the
reference with TF32 operands) and both planted faults (DCN offsets ignored,
RoIAlign without its half-pixel offset) are not ``correct``; a program that
runs the forward with TF32 allowed cannot run the cell; and the HTC
reference loads nothing of the program or of JAX.

The tiny limits: on one CPU thread the program reads ``moved_share`` 0,
``mask_gap`` about 1.5e-5, ``anno_moved`` 0 and ``paint_gap`` 0 against the
reference (seed 2**31 + 11); the control and both model faults
``moved_share`` and ``anno_moved`` 1; and ``paste_offset`` (every mask one
pixel right) ``paint_gap`` about 0.5, its detections unmoved (the tiny
masks are a few pixels wide)."""
import json
import os

import pytest
import torch
from torch import nn

from benchmark import calibrate
from benchmark.tests import tiny
from benchmark.tests.test_bench_data_driven import snapshot
from benchmark.tests.test_bench_isolation import loaded_after

TINY_LIMITS = dict(moved_share=0.02, mask_gap=1e-4, anno_moved=0.02, paint_gap=0.01)


def add_tiny_htc(root: str) -> None:
    """The configuration ``tiny_htc``, the mix ``tiny_masks`` and the cell
    ``tiny_htc.masks`` beside the manifest's own entries."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "htc_nusc.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_htc"
    cfg["model"].update(depth_blocks=[1, 1, 1, 1], rpn_pre_nms=16, num_proposals=16, max_dets=4)
    cfg["cameras"].update(num_cams=2, img_h=96, img_w=160, fx=80.0)
    cfg["scene"].update(extent=10.0, n_rings=4, pts_per_ring=300, n_walls=2, sweeps=2)
    cfg["tool"]["score_thr"] = 0.0
    cfg["limits"] = TINY_LIMITS
    with open(os.path.join(bench, "configs", "tiny_htc.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_masks.json"), "w") as f:
        json.dump(dict(mode="serve", pool=2, objects=[3, 5], points_on="host", traced_units=1,
                       judged_units=2), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny_htc", source="tests",
                             file="benchmark/configs/tiny_htc.json", reduced=[], why="tests"))
    b["workloads"].append(dict(name="tiny_htc.masks", config="tiny_htc", traffic="tiny_masks",
                               chips=1, why="tests"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "htc_nusc.masks" in m.get("workloads", []):
            m["workloads"].append("tiny_htc.masks")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


@pytest.fixture(scope="module")
def htc_root(tmp_path_factory):
    """A checkout with the tiny HTC cell; (its root, the benchmark's files
    before, after)."""
    root = tiny.make_checkout(str(tmp_path_factory.mktemp("htc")))
    before = snapshot(os.path.join(root, "benchmark"))
    add_tiny_htc(root)
    return root, before, snapshot(os.path.join(root, "benchmark"))


def test_tiny_htc_joins_by_files_and_serves_correct(htc_root):
    root, before, after = htc_root
    assert all(after[k] == v for k, v in before.items())     # no file changed
    res = tiny.run(root, "tiny_htc.masks")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    names = {k.split(".frame")[0] for k in res["checks"]}
    assert names == {"moved_share", "mask_gap", "anno_moved", "paint_gap"}


@pytest.mark.parametrize("variant", [("control",), ("fault", "dcn_offsets_ignored"),
                                     ("fault", "roi_align_unaligned"),
                                     ("fault", "paste_offset")])
def test_control_and_faults_are_not_correct(htc_root, variant):
    with calibrate._variant(*variant):
        res = tiny.run(htc_root[0], "tiny_htc.masks")
    assert not res["correct"], res["checks"]


def test_a_program_in_tf32_cannot_run_the_cell(htc_root, monkeypatch):
    """The configuration states f32 with TF32 off: with ``run_htc``'s
    precision left at PyTorch's default (cuDNN's TF32 allowed), the first
    sample raises before the window."""
    import contextlib

    from fullysparsefusion_tpu_torch import generate_masks as gm

    monkeypatch.setattr(gm, "f32_without_tf32", contextlib.nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tiny.run(htc_root[0], "tiny_htc.masks")


def test_work_count_is_the_hand_count():
    """One 3 × 3 conv (groups 2), one deformable conv (groups 4) and one
    linear layer, counted against their formulas; and RoIAlign's share of a
    ``roi_feats`` call."""
    from benchmark.families import htc as family
    from benchmark.reference.models.htc import DeformConvBlock

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 16, 3, 1, 1, groups=2)
            self.dcn = DeformConvBlock(16, 16, 1, 4)
            self.fc = nn.Linear(16, 5)

        def forward(self, x):
            y = self.dcn(self.conv(x))
            return self.fc(y.mean((2, 3)))

        def roi_feats(self, pyramid, sem, rois, valid, out_size):
            return torch.zeros(rois.shape[0], 4, out_size, out_size)

    net = Net()
    nn.init.normal_(net.dcn.weight)
    wc = family.work_count(net)
    with torch.no_grad():
        net(torch.randn(2, 8, 6, 10))
        net.roi_feats(None, None, torch.zeros(3, 4), None, 7)
    t = wc.totals()
    wc.detach()
    px = 2 * 6 * 10
    conv = 2.0 * px * 16 * (8 // 2) * 9
    offset_conv = 2.0 * px * 18 * 16 * 9
    dcn = 2.0 * px * 16 * (16 // 4) * 9 + 8.0 * px * 9 * 16
    linear = 2.0 * 2 * 16 * 5
    roi = 32.0 * 3 * 4 * (7 * 7 + 14 * 14)
    assert t["conv_flop"] == conv + offset_conv
    assert t["dcn_flop"] == dcn and t["linear_flop"] == linear and t["roi_align_flop"] == roi
    assert t["flop"] == conv + offset_conv + dcn + linear + roi
    assert "roi_feats" not in vars(net)                      # detached


def test_htc_reference_loads_nothing_of_the_program():
    top = loaded_after("from benchmark.reference.models import htc\n"
                       "from benchmark.reference import masks\n"
                       "from benchmark.reference.ops import dcn, nms_2d, roi_align")
    assert "fullysparsefusion_tpu_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "fullysparsefusion_tpu"}
    cfg = os.path.join(tiny.BENCH, "configs", "htc_nusc.json")
    top = loaded_after("import json\nfrom benchmark.harness import manifest\n"
                       f"manifest.family(json.load(open({cfg!r})))\n"
                       "import fullysparsefusion_tpu_torch.generate_masks")
    assert not top & {"jax", "jaxlib", "flax", "fullysparsefusion_tpu"}
    assert "fullysparsefusion_tpu_torch" in top          # the program itself, by design
