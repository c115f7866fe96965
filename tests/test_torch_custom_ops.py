"""The port's kernels as ``torch.library`` custom ops (``ops/library.py``,
namespace ``fsf``) on the CPU, where each op runs its plain version.

For each op, on inputs drawn with numpy from a seed: ``torch.library.opcheck``
(schema, autograd registration, the fake implementation against the real
output, an AOT trace with dynamic shapes); the op's output bitwise its plain
version's and the public wrapper's; the fake implementation's shape and
dtype the real output's; no launch counted on the CPU. Then the conv plan's
trace hazard: after ``torch.export`` of a gather-path conv, no module of the
port holds a FakeTensor (``plan_rulebook`` once cached its tap bits in a
module dict, which an export filled with one), and an eager call still gives
the numpy plan. Imports torch, numpy and the port only.
"""
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from fullysparsefusion_tpu_torch.ops import ccl, library, nms, segment, sparse_conv
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

K3 = 27


def _rulebook(rng, n_src, n_out):
    rows = rng.integers(0, 2 * n_src, (K3, n_out))
    return torch.tensor(np.where(rows < n_src, rows, n_src), dtype=torch.int32)


def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(torch.bfloat16)


def _cases(name):
    """[(op, args, plain version's output, wrapper's output, wrapper)] of one
    kernel."""
    rng = np.random.default_rng(0)
    if name == "gather_conv":
        n_src, n_out, cin, cout = 300, 200, 16, 24
        feats, rows, w = _bf16(rng, n_src, cin), _rulebook(rng, n_src, n_out), \
            _bf16(rng, K3, cin, cout)
        plan = sparse_conv.plan_rulebook(rows, n_src)
        return [(library.gather_conv, (feats, rows, w, plan.order, plan.masks),
                 sparse_conv.gather_conv_plain(feats, rows, w),
                 sparse_conv.gather_conv(feats, rows, w, plan), sparse_conv.gather_conv)]
    if name == "dw_per_tap":
        n_src, n_out, cin, cout = 300, 333, 16, 24      # n_out off the 128-row tile
        feats, rows, g = _bf16(rng, n_src, cin), _rulebook(rng, n_src, n_out), \
            _bf16(rng, n_out, cout)
        plan = sparse_conv.plan_rulebook(rows, n_src)
        n_chunks = 40
        buf = sparse_conv.dw_work_list_plain(plan.masks, plan.order, K3, n_chunks)
        return [(library.dw_work_list, (plan.masks, plan.order, K3, n_chunks), buf,
                 sparse_conv.dw_work_list(plan, K3, n_chunks).buf, None),
                (library.gather_conv_dw, (feats, rows, g, plan.order, buf, n_chunks),
                 sparse_conv.dw_per_tap_plain(feats, rows, g),
                 sparse_conv.dw_per_tap(feats, rows, g, plan), sparse_conv.dw_per_tap)]
    if name == "ccl_roots":
        g, n = 3, 150
        xy = torch.tensor(rng.uniform(0, 6, (g, n, 2)), dtype=torch.float32)
        batch = torch.tensor(rng.integers(0, 2, (g, n)), dtype=torch.int32)
        valid = torch.tensor(rng.uniform(size=(g, n)) < 0.8)
        return [(library.ccl_roots, (xy, batch, valid), ccl.ccl_roots_plain(xy, batch, valid),
                 ccl.ccl_roots(xy, batch, valid), ccl.ccl_roots)]
    if name == "segment_sum":
        n, cap = 600, 40           # ~60 distinct keys: overflow; half the rows trash
        keys = torch.tensor(rng.integers(0, 60, n), dtype=torch.int32)
        seg = segment.unique_segments(keys, torch.tensor(rng.uniform(size=n) < 0.5), cap)
        feat = torch.tensor(rng.normal(size=(n, 5)), dtype=torch.float32, requires_grad=True)
        return [(library.segment_sum, (feat, seg.seg_id, seg.order, seg.offsets),
                 segment.segment_sum_plain(feat, seg.seg_id, cap),
                 segment.segment_sum(feat, seg.seg_id, cap), segment.segment_sum)]
    c, n = 4, 90
    iou = torch.tensor(rng.uniform(size=(n, n)), dtype=torch.float32)
    order = torch.tensor(np.stack([rng.permutation(n) for _ in range(c)]), dtype=torch.int32)
    vs = torch.tensor(rng.uniform(size=(c, n)) < 0.8)
    return [(library.nms_keep, (iou, order, vs, 0.5), nms.nms_keep_plain(iou, order, vs, 0.5),
             nms.nms_keep(iou, order, vs, 0.5), nms.nms_keep)]


@pytest.mark.parametrize("name", ["gather_conv", "dw_per_tap", "ccl_roots", "nms_keep",
                                  "segment_sum"])
def test_op_on_the_cpu_is_the_plain_version(name):
    launches = {k: getattr(f, "launches") for k, f in (
        ("gather_conv", sparse_conv.gather_conv), ("dw_per_tap", sparse_conv.dw_per_tap),
        ("ccl_roots", ccl.ccl_roots), ("nms_keep", nms.nms_keep),
        ("segment_sum", segment.segment_sum))}
    for op, args, plain, wrapped, wrapper in _cases(name):
        assert op._qualname == f"fsf::{op._name}"
        report = torch.library.opcheck(op, args)
        assert set(report.values()) == {"SUCCESS"}, report
        got = op(*args)
        assert got.dtype == plain.dtype and torch.equal(got, plain)
        assert torch.equal(wrapped, plain)
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
        assert isinstance(fake, FakeTensor)
        assert fake.shape == got.shape and fake.dtype == got.dtype
        assert fake.device == got.device
        if wrapper is not None:          # the CPU runs no kernel: nothing counted
            assert wrapper.launches == launches[name]


# a 3 x 3 x 1 kernel (9 taps): a tap count no other test plans, so the export
# below is the first plan of it in the process, as a serving process's is
KERNEL = (3, 3, 1)


class _SubmConv(torch.nn.Module):
    """One gather-path submanifold conv: rulebook, plan and K1's op."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)

    def forward(self, feats, coords, batch, valid):
        st = sparse_conv.SparseTensor(feats, coords, batch, valid, (8, 8, 4), 1)
        rows = sparse_conv.build_subm_rulebook(st, KERNEL)
        plan = sparse_conv.plan_rulebook(rows, st.capacity)
        return sparse_conv.subm_conv_apply(feats, valid, rows, self.w, plan), plan


def _fake_tensors(obj, depth=0):
    if isinstance(obj, FakeTensor):
        return 1
    if depth > 3:
        return 0
    if isinstance(obj, dict):
        obj = list(obj.values()) + list(obj.keys())
    if isinstance(obj, (list, tuple, set)):
        return sum(_fake_tensors(o, depth + 1) for o in obj)
    return 0


def test_export_leaves_no_fake_tensor_behind():
    rng = np.random.default_rng(1)
    cap = 64
    coords = torch.tensor(rng.integers(0, [8, 8, 4], (cap, 3)), dtype=torch.int32)
    batch = torch.zeros(cap, dtype=torch.int32)
    valid = torch.tensor(rng.uniform(size=cap) < 0.7)
    feats = torch.tensor(rng.normal(size=(cap, 16)), dtype=torch.float32)
    conv = _SubmConv(torch.tensor(rng.normal(size=(9, 16, 8)), dtype=torch.float32))
    with torch.no_grad():
        program = torch.export.export(conv, (feats, coords, batch, valid), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.fsf.gather_conv.default) == 1
    held = {name: _fake_tensors(vars(mod)) for name, mod in list(sys.modules.items())
            if name.startswith("fullysparsefusion_tpu_torch")}
    assert not any(held.values()), {k: v for k, v in held.items() if v}
    # an eager call after the trace: the plan is the numpy one, the output the program's
    with torch.no_grad():
        out, plan = conv(feats, coords, batch, valid)
        (again, plan_again) = program.module()(feats, coords, batch, valid)
    rows = sparse_conv.build_subm_rulebook(
        sparse_conv.SparseTensor(feats, coords, batch, valid, (8, 8, 4), 1), KERNEL).numpy()
    masks = ((rows < cap).astype(np.int64) << np.arange(9)[:, None]).sum(0)
    np.testing.assert_array_equal(plan.masks.numpy(), masks)
    np.testing.assert_array_equal(plan.order.numpy(), np.argsort(masks, kind="stable"))
    assert torch.equal(out, again) and torch.equal(plan.masks, plan_again.masks)
