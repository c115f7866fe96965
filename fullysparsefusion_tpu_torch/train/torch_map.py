"""Reference torch ``state_dict`` <-> flax-named variable tree (the port's
copy of the JAX package's ``train/torch_map.py``, NumPy only).

FSF's training recipe warm-starts from an FSD pretrain checkpoint (the
reference config's ``load_from``), so loading the reference's mmdet3d
weights matters. This module enumerates a complete tensor-level map between
the reference's layout and the flax variable tree whose names the port's
submodules carry (``weights.to_jax_variables`` / ``from_jax_variables``
bridge that tree and the port's ``state_dict``): every flax leaf gets a
torch key, and a conversion reports leftover torch keys and unfilled leaves
instead of dropping them.

Torch-side names come from the reference plugin's module attributes:

* FSF detector attrs: ``frustum_obj_head``, ``frustum_sir``,
  ``combine_frustum_feat_mlp``, ``combine_fsd_feat_mlp``, ``encode_2d_mlp``,
  ``segmentor_updated_mlp``, ``refine_sir_layers``, ``refine_img_mlp``,
  ``lidar_img_mlp``, ``position_encoder``, ``out_proj``,
  ``frustum_refined_head``, plus the inherited ``segmentor``, ``backbone``,
  ``bbox_head``.
* ``build_mlp``: a Sequential of Sequential(Linear(bias=False), Norm, Act)
  per hidden layer, plus a bare biased Linear last when ``is_head``. Keys:
  ``{p}.{i}.0.weight``, ``{p}.{i}.1.{weight,bias}`` and
  ``{p}.{last}.{weight,bias}``.
* SIR backbone: ``block_list.{b}`` of SIRLayer.
* SparseClusterHead: ``shared_mlp`` + ``task_heads.{t}.{attr}``.
* VoteSegHead: ``pre_seg_conv`` + ``conv_seg`` + ``voting``.

The VoteSegmentor internals (DynamicScatterVFE, SimpleSparseUNet, SIRLayer
bodies) follow mmdet3d's convention (``vfe_layers.{i}.linear/.norm``,
``conv_input`` / ``encoder_layers.encoder_layer{s}`` / ...);
``cli/convert_checkpoint.py --list`` prints a real checkpoint's keys, so a
divergence shows up as reported unmapped keys, not silence.

Layout transforms: torch Linear ``[out, in]`` <-> flax kernel ``[in, out]``
(transpose); norm ``weight/bias`` <-> ``scale/bias``; BN running stats <->
``batch_stats``; spconv ``[Cout, kz, ky, kx, Cin]`` <-> ``[K^3, Cin, Cout]``;
2D conv OIHW <-> HWIO; transposed conv ``[Cin, Cout, kh, kw]`` <->
``[kh, kw, Cin, Cout]``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Entry:
    torch_key: str
    col: str                 # "params" | "batch_stats"
    path: Tuple[str, ...]    # flax path within the collection
    transform: str           # "T" | "id" | "spconv"


# ---------------------------------------------------------------------------
# transforms

def _to_flax(t: str, v: np.ndarray) -> np.ndarray:
    if t == "T":
        return np.ascontiguousarray(v.T)
    if t == "spconv":
        cout, kz, ky, kx, cin = v.shape
        return np.ascontiguousarray(
            np.transpose(v, (1, 2, 3, 4, 0)).reshape(kz * ky * kx, cin, cout)
        )
    if t == "conv2d":        # torch OIHW → flax HWIO
        return np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
    if t == "deconv2d":      # torch ConvTranspose2d [Cin,Cout,kh,kw] → [kh,kw,Cin,Cout]
        return np.ascontiguousarray(np.transpose(v, (2, 3, 0, 1)))
    return np.asarray(v)


def _to_torch(t: str, v: np.ndarray, k: int = 3) -> np.ndarray:
    if t == "T":
        return np.ascontiguousarray(np.asarray(v).T)
    if t == "spconv":
        k3, cin, cout = v.shape
        return np.ascontiguousarray(
            np.transpose(np.asarray(v).reshape(k, k, k, cin, cout), (4, 0, 1, 2, 3))
        )
    if t == "conv2d":
        return np.ascontiguousarray(np.transpose(np.asarray(v), (3, 2, 0, 1)))
    if t == "deconv2d":
        return np.ascontiguousarray(np.transpose(np.asarray(v), (2, 3, 0, 1)))
    return np.asarray(v)


# ---------------------------------------------------------------------------
# per-module-family enumerators (operate on params subtrees)

def _dense_idx(sub) -> List[str]:
    ks = [k for k in sub if k.startswith("Dense_")]
    return sorted(ks, key=lambda s: int(s.split("_")[1]))


def _mlp(sub, base: Tuple[str, ...], prefix: str, norm: str = "ln") -> List[Entry]:
    """flax ``MLP`` ↔ torch ``build_mlp``: non-head layers are
    Linear(bias=False)+Norm+Act nested Sequentials, head layer a bare biased
    Linear (ops/sst_ops.py:808-833)."""
    out = []
    norm_mod = "LayerNorm_0" if norm == "ln" else "MaskedBatchNorm_0"
    for d in _dense_idx(sub):
        i = int(d.split("_")[1])
        is_head = f"Norm_{i}" not in sub
        if is_head:
            out.append(Entry(f"{prefix}.{i}.weight", "params", base + (d, "kernel"), "T"))
            out.append(Entry(f"{prefix}.{i}.bias", "params", base + (d, "bias"), "id"))
        else:
            out.append(Entry(f"{prefix}.{i}.0.weight", "params", base + (d, "kernel"), "T"))
            npath = base + (f"Norm_{i}", norm_mod)
            out.append(Entry(f"{prefix}.{i}.1.weight", "params", npath + ("scale",), "id"))
            out.append(Entry(f"{prefix}.{i}.1.bias", "params", npath + ("bias",), "id"))
            if norm == "bn":
                out.append(Entry(f"{prefix}.{i}.1.running_mean", "batch_stats",
                                 npath + ("mean",), "id"))
                out.append(Entry(f"{prefix}.{i}.1.running_var", "batch_stats",
                                 npath + ("var",), "id"))
    return out


def _vfe_layers(sub, base: Tuple[str, ...], prefix: str, norm: str) -> List[Entry]:
    """DynamicVFELayer stack ↔ ``vfe_layers.{i}.linear/.norm`` (mmdet3d
    DynamicVFE convention; fork's DynamicScatterVFE/SIRLayer share it)."""
    out = []
    layers = sorted(
        (k for k in sub if k.startswith("DynamicVFELayer_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    norm_mod = "LayerNorm_0" if norm == "ln" else "MaskedBatchNorm_0"
    for l in layers:
        i = int(l.split("_")[-1])
        out.append(Entry(
            f"{prefix}.vfe_layers.{i}.linear.weight", "params",
            base + (l, "Dense_0", "kernel"), "T",
        ))
        npath = base + (l, "Norm_0", norm_mod)
        lp = f"{prefix}.vfe_layers.{i}.norm"
        out.append(Entry(f"{lp}.weight", "params", npath + ("scale",), "id"))
        out.append(Entry(f"{lp}.bias", "params", npath + ("bias",), "id"))
        if norm == "bn":
            out.append(Entry(f"{lp}.running_mean", "batch_stats", npath + ("mean",), "id"))
            out.append(Entry(f"{lp}.running_var", "batch_stats", npath + ("var",), "id"))
    return out


def _sir(sub, base: Tuple[str, ...], prefix: str) -> List[Entry]:
    """SIR backbone ↔ ``{prefix}.block_list.{b}`` (sir.py:63).  Per block:
    VFE layers (LN) + the rel-pos MLP — plain biased Linears with activations
    between, Sequential indices 0,2,4… (the fork's SIRLayer ``rel_mlp``)."""
    out = []
    blocks = sorted(
        (k for k in sub if k.startswith("SIRLayer_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    for blk in blocks:
        b = int(blk.split("_")[-1])
        bp = f"{prefix}.block_list.{b}"
        out += _vfe_layers(sub[blk], base + (blk,), bp, norm="ln")
        if "MLP_0" in sub[blk]:
            for d in _dense_idx(sub[blk]["MLP_0"]):
                j = int(d.split("_")[1])
                dp = base + (blk, "MLP_0", d)
                out.append(Entry(f"{bp}.rel_mlp.{2 * j}.weight", "params", dp + ("kernel",), "T"))
                out.append(Entry(f"{bp}.rel_mlp.{2 * j}.bias", "params", dp + ("bias",), "id"))
    return out


def _cluster_head(sub, base: Tuple[str, ...], prefix: str,
                  attr_names: Tuple[str, ...] = ("center", "dim", "rot", "vel", "score", "iou"),
                  ) -> List[Entry]:
    """SparseClusterHead ↔ ``shared_mlp`` + ``task_heads.{t}.{attr}``
    (sparse_cluster_head.py:77, sparse_cluster_head_v2.py:110-118;
    FSDSeparateHead attrs are is_head build_mlps, :29-33)."""
    out = _mlp(sub["MLP_0"], base + ("MLP_0",), f"{prefix}.shared_mlp")
    heads = sorted(
        (k for k in sub if k.startswith("SeparateHead_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    for h in heads:
        t = int(h.split("_")[-1])
        mlps = sorted(
            (k for k in sub[h] if k.startswith("MLP_")),
            key=lambda s: int(s.split("_")[-1]),
        )
        assert len(mlps) <= len(attr_names), (mlps, attr_names)
        for m in mlps:
            a = attr_names[int(m.split("_")[-1])]
            out += _mlp(sub[h][m], base + (h, m), f"{prefix}.task_heads.{t}.{a}")
    return out


_UNET_RE = [
    # flax conv name → torch conv path inside the backbone.
    # conv_input / conv_out match mmdet3d SparseUNet; encoder stage s lives
    # at encoder_layers.encoder_layer{s+1} with block index j (j=0 is the
    # strided conv for s>=1); decoder stage d at decoder_layers.
    (re.compile(r"^conv_input$"), lambda m: "conv_input"),
    (re.compile(r"^conv_out$"), lambda m: "conv_out"),
    (re.compile(r"^enc(\d+)_subm(\d+)$"),
     lambda m: f"encoder_layers.encoder_layer{int(m.group(1)) + 1}.{int(m.group(2))}"),
    (re.compile(r"^enc(\d+)_down$"),
     lambda m: f"encoder_layers.encoder_layer{int(m.group(1)) + 1}.0"),
    (re.compile(r"^dec(\d+)_subm(\d+)$"),
     lambda m: f"decoder_layers.decoder_layer{int(m.group(1)) + 1}.{int(m.group(2))}"),
    (re.compile(r"^dec(\d+)_up$"),
     lambda m: f"decoder_layers.decoder_layer{int(m.group(1)) + 1}.up"),
]


def _unet(sub, base: Tuple[str, ...], prefix: str) -> List[Entry]:
    out = []
    for conv in sorted(sub):
        torch_conv = None
        for pat, fn in _UNET_RE:
            m = pat.match(conv)
            if m:
                torch_conv = fn(m)
                break
        assert torch_conv is not None, f"unrecognized UNet conv {conv}"
        cp = f"{prefix}.{torch_conv}"
        cb = base + (conv,)
        out.append(Entry(f"{cp}.0.weight", "params", cb + ("w",), "spconv"))
        npath = cb + ("MaskedBatchNorm_0",)
        out.append(Entry(f"{cp}.1.weight", "params", npath + ("scale",), "id"))
        out.append(Entry(f"{cp}.1.bias", "params", npath + ("bias",), "id"))
        out.append(Entry(f"{cp}.1.running_mean", "batch_stats", npath + ("mean",), "id"))
        out.append(Entry(f"{cp}.1.running_var", "batch_stats", npath + ("var",), "id"))
    return out


def _seg_core(sub, base: Tuple[str, ...], prefix: str) -> List[Entry]:
    """SegmentorCore ↔ ``{prefix}.voxel_encoder`` + ``{prefix}.backbone``."""
    out = _vfe_layers(
        sub["DynamicScatterVFE_0"], base + ("DynamicScatterVFE_0",),
        f"{prefix}.voxel_encoder", norm="bn",
    )
    out += _unet(sub["SparseUNet_0"], base + ("SparseUNet_0",), f"{prefix}.backbone")
    return out


def _seg_head(sub, base: Tuple[str, ...], prefix: str) -> List[Entry]:
    """VoteSegHead ↔ ``pre_seg_conv``/``conv_seg``/``voting``
    (segmentation_head.py:55,64-65); Dense_0=conv_seg, Dense_1=voting."""
    out = _mlp(sub["MLP_0"], base + ("MLP_0",), f"{prefix}.pre_seg_conv", norm="bn")
    for d, t in (("Dense_0", "conv_seg"), ("Dense_1", "voting")):
        out.append(Entry(f"{prefix}.{t}.weight", "params", base + (d, "kernel"), "T"))
        out.append(Entry(f"{prefix}.{t}.bias", "params", base + (d, "bias"), "id"))
    return out


def _zero_init_mlp(sub, base: Tuple[str, ...], prefix: str) -> List[Entry]:
    """ZeroInitMLP ↔ is_head build_mlp (``segmentor_updated_mlp``,
    FSF.py:135-143): hidden Linear+LN pairs then a biased zero-init head."""
    out = []
    for d in _dense_idx(sub):
        i = int(d.split("_")[1])
        if f"LayerNorm_{i}" in sub:
            out.append(Entry(f"{prefix}.{i}.0.weight", "params", base + (d, "kernel"), "T"))
            ln = base + (f"LayerNorm_{i}",)
            out.append(Entry(f"{prefix}.{i}.1.weight", "params", ln + ("scale",), "id"))
            out.append(Entry(f"{prefix}.{i}.1.bias", "params", ln + ("bias",), "id"))
        else:
            out.append(Entry(f"{prefix}.{i}.weight", "params", base + (d, "kernel"), "T"))
            out.append(Entry(f"{prefix}.{i}.bias", "params", base + (d, "bias"), "id"))
    return out


# ---------------------------------------------------------------------------
# HTC (2D pre-inference model, models/htc.py ↔ mmdet HybridTaskCascade —
# checkpoint layout of htc_x101_64x4d_fpn_dconv…nuim as listed by
# cli/convert_checkpoint.py --list)

def _conv2d(base: Tuple[str, ...], flax_name: str, prefix: str,
            bias: bool = True) -> List[Entry]:
    out = [Entry(f"{prefix}.weight", "params", base + (flax_name, "kernel"),
                 "conv2d")]
    if bias:
        out.append(Entry(f"{prefix}.bias", "params",
                         base + (flax_name, "bias"), "id"))
    return out


def _bn2d(base: Tuple[str, ...], flax_name: str, prefix: str) -> List[Entry]:
    b = base + (flax_name,)
    return [
        Entry(f"{prefix}.weight", "params", b + ("scale",), "id"),
        Entry(f"{prefix}.bias", "params", b + ("bias",), "id"),
        Entry(f"{prefix}.running_mean", "batch_stats", b + ("mean",), "id"),
        Entry(f"{prefix}.running_var", "batch_stats", b + ("var",), "id"),
    ]


def _fc(base: Tuple[str, ...], flax_name: str, prefix: str) -> List[Entry]:
    return [
        Entry(f"{prefix}.weight", "params", base + (flax_name, "kernel"), "T"),
        Entry(f"{prefix}.bias", "params", base + (flax_name, "bias"), "id"),
    ]


def _htc_entries(params: Dict) -> List[Entry]:
    e: List[Entry] = []
    bb = params["backbone"]
    e += _conv2d(("backbone",), "stem_conv", "backbone.conv1", bias=False)
    e += _bn2d(("backbone",), "stem_bn", "backbone.bn1")
    for name in sorted(k for k in bb if k.startswith("layer")):
        s, b = name[len("layer"):].split("_")
        t = f"backbone.layer{s}.{b}"
        base = ("backbone", name)
        blk = bb[name]
        e += _conv2d(base, "conv1", f"{t}.conv1", bias=False)
        e += _bn2d(base, "bn1", f"{t}.bn1")
        if "kernel" in blk["conv2"]:   # plain grouped 3×3
            e += _conv2d(base, "conv2", f"{t}.conv2", bias=False)
        else:                           # DCN block
            cb = base + ("conv2",)
            e += [
                Entry(f"{t}.conv2.weight", "params", cb + ("w",), "conv2d"),
                Entry(f"{t}.conv2.conv_offset.weight", "params",
                      cb + ("conv_offset_w",), "conv2d"),
                Entry(f"{t}.conv2.conv_offset.bias", "params",
                      cb + ("conv_offset_b",), "id"),
            ]
        e += _bn2d(base, "bn2", f"{t}.bn2")
        e += _conv2d(base, "conv3", f"{t}.conv3", bias=False)
        e += _bn2d(base, "bn3", f"{t}.bn3")
        if "ds_conv" in blk:
            e += _conv2d(base, "ds_conv", f"{t}.downsample.0", bias=False)
            e += _bn2d(base, "ds_bn", f"{t}.downsample.1")
    for i in range(4):
        e += _conv2d(("neck",), f"lateral{i}", f"neck.lateral_convs.{i}.conv")
    for i in range(4):
        e += _conv2d(("neck",), f"fpn{i}", f"neck.fpn_convs.{i}.conv")
    e += _conv2d(("rpn_head",), "rpn_conv", "rpn_head.rpn_conv")
    e += _conv2d(("rpn_head",), "rpn_cls", "rpn_head.rpn_cls")
    e += _conv2d(("rpn_head",), "rpn_reg", "rpn_head.rpn_reg")
    for i in range(3):
        hb = (f"bbox_head{i}",)
        t = f"roi_head.bbox_head.{i}"
        e += _fc(hb, "fc1", f"{t}.shared_fcs.0")
        e += _fc(hb, "fc2", f"{t}.shared_fcs.1")
        e += _fc(hb, "fc_cls", f"{t}.fc_cls")
        e += _fc(hb, "fc_reg", f"{t}.fc_reg")
    for i in range(3):
        mb = (f"mask_head{i}",)
        t = f"roi_head.mask_head.{i}"
        if i > 0:
            e += _conv2d(mb, "conv_res", f"{t}.conv_res.conv")
        for j in range(4):
            e += _conv2d(mb, f"conv{j}", f"{t}.convs.{j}.conv")
        e += [
            Entry(f"{t}.upsample.weight", "params", mb + ("upsample_w",),
                  "deconv2d"),
            Entry(f"{t}.upsample.bias", "params", mb + ("upsample_b",), "id"),
        ]
        e += _conv2d(mb, "conv_logits", f"{t}.conv_logits")
    sb = ("semantic_head",)
    t = "roi_head.semantic_head"
    for i in range(5):
        e += _conv2d(sb, f"lateral{i}", f"{t}.lateral_convs.{i}.conv")
    for j in range(4):
        e += _conv2d(sb, f"conv{j}", f"{t}.convs.{j}.conv")
    e += _conv2d(sb, "conv_embedding", f"{t}.conv_embedding.conv")
    e += _conv2d(sb, "conv_logits", f"{t}.conv_logits")
    return e


# ---------------------------------------------------------------------------
# model-level enumeration

def build_entries(params: Dict, model: str = "fsf") -> List[Entry]:
    """Complete tensor map for a model's variable tree.

    ``params`` is the flax ``variables["params"]`` dict (shapes or arrays).
    Every leaf of params and the associated batch_stats is covered; the
    function raises on unknown top-level modules so structural drift is loud.
    """
    e: List[Entry] = []
    if model == "fsf":
        for group in sorted(params):
            b = (group,)
            sub = params[group]
            if group == "seg_core":
                e += _seg_core(sub, b, "segmentor")
            elif group == "seg_head":
                e += _seg_head(sub, b, "segmentor.segmentation_head")
            elif group == "seg_enhance_mlp":
                e += _zero_init_mlp(sub, b, "segmentor_updated_mlp")
            elif group == "frustum":
                e += _mlp(sub["MLP_0"], b + ("MLP_0",), "encode_2d_mlp")
                e += _sir(sub["SIR_0"], b + ("SIR_0",), "frustum_sir")
            elif group == "frustum_head":
                e += _cluster_head(sub, b, "frustum_obj_head")
            elif group == "fsd_branch":
                e += _sir(sub["backbone"], b + ("backbone",), "backbone")
                e += _cluster_head(sub["bbox_head"], b + ("bbox_head",), "bbox_head")
            elif group in ("combine_frustum_mlp", "combine_fsd_mlp"):
                name = ("combine_frustum_feat_mlp" if group == "combine_frustum_mlp"
                        else "combine_fsd_feat_mlp")
                e += _mlp(sub, b, name)
            elif (m := re.match(r"^refine_sir_(\d+)$", group)):
                e += _sir(sub, b, f"refine_sir_layers.{m.group(1)}")
            elif (m := re.match(r"^refine_img_mlp_(\d+)$", group)):
                e += _mlp(sub, b, f"refine_img_mlp.{m.group(1)}")
            elif (m := re.match(r"^lidar_img_mlp_(\d+)$", group)):
                e += _mlp(sub, b, f"lidar_img_mlp.{m.group(1)}")
            elif (m := re.match(r"^position_encoder_(\d+)$", group)):
                e += _mlp(sub, b, f"position_encoder.{m.group(1)}")
            elif (m := re.match(r"^out_proj_(\d+)$", group)):
                e += _mlp(sub, b, f"out_proj.{m.group(1)}")
            elif (m := re.match(r"^refined_head_(\d+)$", group)):
                e += _cluster_head(sub, b, f"frustum_refined_head.{m.group(1)}")
            else:
                raise KeyError(f"no torch mapping for FSF module {group!r}")
    elif model == "fsd":
        for group in sorted(params):
            b = (group,)
            sub = params[group]
            if group == "segmentor":
                e += _seg_core(sub["SegmentorCore_0"], b + ("SegmentorCore_0",), "segmentor")
                e += _seg_head(sub["VoteSegHead_0"], b + ("VoteSegHead_0",),
                               "segmentor.segmentation_head")
            elif group == "query_branch":
                e += _sir(sub["backbone"], b + ("backbone",), "backbone")
                e += _cluster_head(sub["bbox_head"], b + ("bbox_head",), "bbox_head")
            else:
                raise KeyError(f"no torch mapping for FSD module {group!r}")
    elif model == "htc":
        e += _htc_entries(params)
    else:
        raise ValueError(model)
    return e


# ---------------------------------------------------------------------------
# conversion / synthesis

def _get(tree, path):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree, path, v):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = v


def _leaf_paths(tree, base=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_paths(v, base + (k,))
        else:
            out.append(base + (k,))
    return out


def convert_state_dict(sd: Dict[str, np.ndarray], skeleton: Dict,
                       model: str = "fsf") -> Tuple[Dict, Dict]:
    """torch state_dict → ``{"params", "batch_stats"}`` matching ``skeleton``.

    ``skeleton`` is the model's ``variables``: arrays, or shape-only leaves
    (an object with a ``shape`` and no ``__array__``).
    Returns ``(variables, report)`` where report lists ``missing`` flax
    leaves (no torch key found), ``unmapped`` torch keys, and shape
    ``mismatches``. Leaves missing from the checkpoint keep skeleton values.
    """
    entries = build_entries(skeleton["params"], model)
    out = {"params": {}, "batch_stats": {}}
    used, missing, mismatch = set(), [], []
    for ent in entries:
        ref = _get(skeleton.get(ent.col, {}), ent.path)
        if ref is None:
            continue  # model variant without this leaf
        if ent.torch_key not in sd:
            missing.append(ent.torch_key)
            continue
        v = _to_flax(ent.transform, sd[ent.torch_key])
        if tuple(v.shape) != tuple(ref.shape):
            mismatch.append((ent.torch_key, tuple(v.shape), tuple(ref.shape)))
            continue
        _set(out[ent.col], ent.path, v.astype(np.float32))
        used.add(ent.torch_key)
    # keep skeleton values for anything unfilled so the tree always loads
    filled = 0
    for col in ("params", "batch_stats"):
        for path in _leaf_paths(skeleton.get(col, {})):
            if _get(out[col], path) is None:
                ref = _get(skeleton[col], path)
                arr = (np.asarray(ref) if hasattr(ref, "__array__")
                       else np.zeros(ref.shape, np.float32))  # shape only
                _set(out[col], path, arr)
            else:
                filled += 1
    unmapped = sorted(
        k for k in sd
        if k not in used and not k.endswith("num_batches_tracked")
    )
    report = dict(
        filled=filled, total=len(entries), missing=sorted(missing),
        unmapped=unmapped, mismatch=mismatch,
    )
    return out, report


def synthesize_state_dict(variables: Dict, model: str = "fsf",
                          kernel_k: int = 3) -> Dict[str, np.ndarray]:
    """flax variables → torch-layout state_dict (the exact inverse of
    ``convert_state_dict``; used by the round-trip tests and by exporting
    trained weights back to the reference format)."""
    entries = build_entries(variables["params"], model)
    sd = {}
    for ent in entries:
        v = _get(variables.get(ent.col, {}), ent.path)
        if v is None:
            raise KeyError(f"flax leaf {ent.col}/{'/'.join(ent.path)} missing")
        sd[ent.torch_key] = _to_torch(ent.transform, np.asarray(v), kernel_k)
    return sd
