"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's config surface, field for field, so the two
configs compare with ``dataclasses.asdict``. ``Capacities`` gives every
data-dependent set (points, voxels, foreground, clusters, RoI points) a fixed
capacity; the port keeps them so outputs compare row by row with the JAX
package.

``unet_window_conv`` / ``unet_window_conv_train`` are kept for field parity
only: they select a TPU dispatch in the JAX package and mean nothing here
(every gather-path conv runs the one gather-conv kernel).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

NUSC_CLASS_NAMES = (
    "car", "truck", "trailer", "bus", "construction_vehicle",
    "bicycle", "motorcycle", "pedestrian", "traffic_cone", "barrier",
)
NUSC_GROUPS = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)


@dataclass(frozen=True)
class Capacities:
    """Fixed capacities (per global batch unless noted)."""

    points: int = 32768          # padded raw points
    voxels: int = 16384          # segmentation-voxelization capacity
    prevox: int = 16384          # 0.1 m pre-voxelization capacity
    fg_per_group: int = 2048     # compacted foreground points per class-group
    # clustering-voxel capacity per group; re-slotted per sample before CCL,
    # so provision batch_size × the worst single-sample voxel count
    cluster_voxels_per_group: int = 1024
    clusters: int = 512          # total cluster (query) capacity
    max_gt: int = 128            # padded GT boxes per sample
    frustum_points: int = 8192   # compacted in-mask foreground points
    frustum_objects: int = 256   # camera-query capacity
    roi_points: int = 16384      # total pooled points across RoIs
    max_roi_points: int = 512    # per-RoI point cap
    out_boxes: int = 500         # NMS max_num


def _small_caps() -> Capacities:
    """Tiny capacities for tests."""
    return Capacities(
        points=2048, voxels=2048, prevox=2048, fg_per_group=256,
        cluster_voxels_per_group=128, clusters=128, max_gt=16,
        frustum_points=512, frustum_objects=32, roi_points=1024,
        max_roi_points=64, out_boxes=64,
    )


@dataclass(frozen=True)
class VoteSegmentorConfig:
    """VoteSegmentor (reference FSF_nuScenes_config.py:33-103)."""

    num_classes: int = 10
    point_dim: int = 5
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    point_cloud_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    vfe_channels: Tuple[int, ...] = (64, 64)
    unet_base_channels: int = 64
    unet_output_channels: int = 128
    unet_encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (128,), (128, 128, 128), (128, 128, 128), (256, 256, 256), (512, 512, 512)
    )
    unet_decoder_channels: Tuple[Tuple[int, ...], ...] = (
        (512, 512, 256), (256, 256, 128), (128, 128, 128), (128, 128, 128)
    )
    unet_strided_paddings: Tuple[Tuple[int, int, int], ...] = (
        (1, 1, 1), (1, 1, 1), (1, 1, 0), (1, 1, 1)
    )
    unet_capacity_divisors: Tuple[int, ...] = (1, 1, 2, 4, 8)
    # explicit per-stage active-set capacities (override the divisors)
    unet_stage_capacities: Optional[Tuple[int, ...]] = None
    # occupancy (capacity / grid cells) at or above which a stage's convs
    # run dense (scatter → conv3d → gather back) instead of the gather conv
    unet_dense_min_occupancy: float = 0.15
    unet_window_conv: Tuple[int, ...] = (192, 256, 64)
    unet_window_conv_train: bool = False
    head_hidden_dims: Tuple[int, ...] = (128, 128)
    seg_loss_weight: float = 10.0
    vote_loss_weight: float = 1.0
    bg_class_weight: float = 0.1


@dataclass(frozen=True)
class HeadConfig:
    """SparseClusterHeadV2-family head (reference :125-156)."""

    num_classes: int = 10
    in_channel: int = 768
    shared_mlp_dims: Tuple[int, ...] = (1024, 1024)
    code_size: int = 10
    common_attrs: Tuple[Tuple[str, int, int, int], ...] = (
        ("center", 3, 2, 128), ("dim", 3, 2, 128), ("rot", 2, 2, 128), ("vel", 2, 2, 128)
    )
    num_cls_layer: int = 2
    cls_hidden_dim: int = 128
    act: str = "gelu"
    norm: str = "ln"
    focal_gamma: float = 4.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_center_weight: float = 0.5
    loss_size_weight: float = 0.5
    loss_rot_weight: float = 0.2
    loss_vel_weight: float = 0.2
    with_corner_loss: bool = False
    corner_delta: float = 1.0
    corner_loss_weight: float = 1.0
    with_iou: bool = False
    iou_fg_thresh: float = 0.75
    iou_bg_thresh: float = 0.25
    loss_iou_weight: float = 1.0
    iou_label_mode: str = "iou"
    dist_min_thre: float = 0.3
    dist_max_thre: float = 2.0
    # test cfg
    nms_thr: float = 0.25
    score_thr: float = 0.05
    max_num: int = 500


@dataclass(frozen=True)
class FSDConfig:
    """LiDAR-query (FSD) branch (reference FSF_nuScenes_config.py:105-198)."""

    class_names: Tuple[str, ...] = NUSC_CLASS_NAMES
    group_names: Tuple[Tuple[str, ...], ...] = NUSC_GROUPS
    # task groups for the cluster head; None → one task of every class
    tasks: Optional[Tuple[Tuple[str, ...], ...]] = None
    segmentor: VoteSegmentorConfig = field(default_factory=VoteSegmentorConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    score_thresh: Tuple[float, ...] = (0.1,) * 6
    offset_weight: str = "max"
    pre_voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    cluster_voxel_sizes: Tuple[Tuple[float, float, float], ...] = (
        (0.3, 0.3, 8.0), (0.3, 0.3, 8.0), (0.3, 0.3, 8.0),
        (0.1, 0.1, 8.0), (0.2, 0.2, 8.0), (0.05, 0.05, 8.0),
    )
    connected_dists: Tuple[float, ...] = (0.6, 0.6, 0.6, 0.2, 0.4, 0.1)
    min_cluster_points: int = 2
    sir_num_blocks: int = 3
    sir_feat_channels: Tuple[Tuple[int, ...], ...] = ((128, 128),) * 3
    sir_rel_mlp_hidden: Tuple[Tuple[int, ...], ...] = ((16, 32),) * 3
    sir_xyz_normalizer: Tuple[float, float, float] = (20.0, 20.0, 4.0)
    caps: Capacities = field(default_factory=Capacities)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def num_groups(self) -> int:
        return len(self.group_names)

    def group_class_ids(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(
            tuple(self.class_names.index(n) for n in g) for g in self.group_names
        )

    def task_tuple(self) -> Tuple[Tuple[str, ...], ...]:
        """Effective task groups — ``tasks`` or one task of every class."""
        return self.tasks if self.tasks else (self.class_names,)


@dataclass(frozen=True)
class FSFConfig:
    """Full LiDAR+camera fusion detector (reference FSF_nuScenes_config.py:105-411)."""

    fsd: FSDConfig = field(default_factory=FSDConfig)
    num_cams: int = 6
    overlap_k: int = 3            # top-k instance ids kept per point
    frustum_head: HeadConfig = field(
        default_factory=lambda: HeadConfig(
            in_channel=768 + 128, nms_thr=0.35, score_thr=0.01
        )
    )
    refined_head: HeadConfig = field(
        default_factory=lambda: HeadConfig(
            in_channel=1024, loss_cls_weight=2.0, nms_thr=0.35, score_thr=0.01
        )
    )
    encode_2d_dims: Tuple[int, ...] = (128, 128)
    embed_dims: int = 1024
    num_refine_stages: int = 1
    extra_wlh: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    refine_img_mlp_dims: Tuple[int, ...] = (32, 32)
    rois_per_point: int = 2
    refine_max_dist: Tuple[float, ...] = (
        1.0, 1.0, 2.0, 4.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.0
    )

    @property
    def caps(self) -> Capacities:
        return self.fsd.caps

    @property
    def num_classes(self) -> int:
        return self.fsd.num_classes


AV2_CLASS_NAMES = (
    "Regular_vehicle",
    "Pedestrian", "Bicyclist", "Motorcyclist", "Wheeled_rider",
    "Bollard", "Construction_cone", "Sign", "Construction_barrel",
    "Stop_sign", "Mobile_pedestrian_crossing_sign",
    "Large_vehicle", "Bus", "Box_truck", "Truck", "Vehicular_trailer",
    "Truck_cab", "School_bus", "Articulated_bus", "Message_board_trailer",
    "Bicycle", "Motorcycle", "Wheeled_device", "Wheelchair", "Stroller",
    "Dog",
)
AV2_GROUPS = (
    AV2_CLASS_NAMES[:1], AV2_CLASS_NAMES[1:5], AV2_CLASS_NAMES[5:11],
    AV2_CLASS_NAMES[11:20], AV2_CLASS_NAMES[20:25], AV2_CLASS_NAMES[25:],
)


def nusc_fsf_config(caps: Optional[Capacities] = None) -> FSFConfig:
    """Production nuScenes FSF (reference FSF_nuScenes_config.py)."""
    fsd = FSDConfig(caps=caps or Capacities())
    return FSFConfig(fsd=fsd)


# the JAX package bench's per-sample capacities and UNet stage capacities
# (measured scan occupancy + 10 %); max_gt and max_roi_points stay per sample
BENCH_CAPS = dict(
    points=131072, voxels=57344, prevox=65536, fg_per_group=4096,
    cluster_voxels_per_group=1024, clusters=1024, frustum_points=16384,
    frustum_objects=256, roi_points=32768,
)
BENCH_STAGE_CAPS = (57344, 40960, 24576, 8192, 2560)


def bench_fsf_config(batch: int = 1) -> FSFConfig:
    """Full-width nuScenes FSF at the JAX package bench's capacities for a
    global batch of ``batch`` samples: every capacity but ``max_gt`` (128)
    and ``max_roi_points`` (512) scaled by ``batch``, as the bench scales
    them (its ``FSF_BENCH_BATCH``)."""
    caps = Capacities(**{k: v * batch for k, v in BENCH_CAPS.items()}, max_gt=128,
                      max_roi_points=512)
    seg = VoteSegmentorConfig(unet_stage_capacities=tuple(c * batch for c in BENCH_STAGE_CAPS))
    return FSFConfig(fsd=FSDConfig(caps=caps, segmentor=seg))


def av2_fsf_config(caps: Optional[Capacities] = None) -> FSFConfig:
    """Production Argoverse 2 FSF (reference FSF_AV2_config.py): 26 classes,
    7 ring cameras, ±204.8 m range, code_size 8 (no velocity)."""
    n = len(AV2_CLASS_NAMES)
    seg = VoteSegmentorConfig(
        num_classes=n,
        point_dim=4,
        voxel_size=(0.2, 0.2, 0.2),
        point_cloud_range=(-204.8, -204.8, -3.2, 204.8, 204.8, 3.2),
    )
    common_attrs_no_vel = (
        ("center", 3, 2, 128), ("dim", 3, 2, 128), ("rot", 2, 2, 128)
    )
    head = HeadConfig(num_classes=n, code_size=8, common_attrs=common_attrs_no_vel)
    fsd = FSDConfig(
        class_names=AV2_CLASS_NAMES,
        group_names=AV2_GROUPS,
        segmentor=seg,
        head=head,
        score_thresh=(0.4, 0.25, 0.25, 0.25, 0.25, 0.25),
        cluster_voxel_sizes=(
            (0.3, 0.3, 6.4), (0.05, 0.05, 6.4), (0.08, 0.08, 6.4),
            (0.5, 0.5, 6.4), (0.1, 0.1, 6.4), (0.08, 0.08, 6.4),
        ),
        connected_dists=(0.6, 0.1, 0.15, 1.0, 0.2, 0.15),
        caps=caps or Capacities(),
    )
    frustum_head = HeadConfig(
        num_classes=n, code_size=8, common_attrs=common_attrs_no_vel,
        in_channel=768 + 128, nms_thr=0.35, score_thr=0.01,
    )
    refined_head = HeadConfig(
        num_classes=n, code_size=8, common_attrs=common_attrs_no_vel,
        in_channel=1024, loss_cls_weight=2.0, nms_thr=0.35, score_thr=0.01,
    )
    return FSFConfig(
        fsd=fsd,
        num_cams=7,
        frustum_head=frustum_head,
        refined_head=refined_head,
        refine_max_dist=(1.0,) * n,
    )


def tiny_fsf_config(**overrides) -> FSFConfig:
    """Small FSF config for CPU tests."""
    fsd = tiny_fsd_config()
    frustum_head = HeadConfig(
        in_channel=3 * 64 + 32,
        shared_mlp_dims=(64, 64),
        common_attrs=(
            ("center", 3, 2, 32), ("dim", 3, 2, 32), ("rot", 2, 2, 32), ("vel", 2, 2, 32)
        ),
        cls_hidden_dim=32,
        max_num=64,
        nms_thr=0.35,
        score_thr=0.01,
    )
    refined_head = HeadConfig(
        in_channel=128,
        shared_mlp_dims=(64, 64),
        common_attrs=(
            ("center", 3, 2, 32), ("dim", 3, 2, 32), ("rot", 2, 2, 32), ("vel", 2, 2, 32)
        ),
        cls_hidden_dim=32,
        max_num=64,
        loss_cls_weight=2.0,
        nms_thr=0.35,
        score_thr=0.01,
    )
    kw = dict(
        fsd=fsd,
        frustum_head=frustum_head,
        refined_head=refined_head,
        encode_2d_dims=(32, 32),
        embed_dims=128,
        refine_img_mlp_dims=(16, 16),
    )
    kw.update(overrides)
    return FSFConfig(**kw)


def tiny_av2_fsf_config() -> FSFConfig:
    """The tiny FSF config at Argoverse 2's shape, for CPU runs of AV2
    trees (the port's own; the JAX package's AV2 tests build the same from
    its ``tiny_fsf_config`` and ``av2_fsf_config``): 26 classes in AV2's
    six groups, code size 8 without the velocity attribute, 7 cameras,
    4-dim points, AV2's cluster voxel sizes, connected distances, score
    thresholds and refinement distances."""
    n = len(AV2_CLASS_NAMES)
    base, av2 = tiny_fsf_config(), av2_fsf_config().fsd

    def head(h):
        return replace(h, num_classes=n, code_size=8,
                       common_attrs=tuple(a for a in h.common_attrs if a[0] != "vel"))

    seg = replace(base.fsd.segmentor, num_classes=n, point_dim=4)
    fsd = replace(base.fsd, class_names=AV2_CLASS_NAMES, group_names=AV2_GROUPS, segmentor=seg,
                  head=head(base.fsd.head), score_thresh=av2.score_thresh,
                  cluster_voxel_sizes=av2.cluster_voxel_sizes,
                  connected_dists=av2.connected_dists)
    return replace(base, fsd=fsd, num_cams=7, frustum_head=head(base.frustum_head),
                   refined_head=head(base.refined_head), refine_max_dist=(1.0,) * n)


def tiny_fsd_config(**overrides) -> FSDConfig:
    """Small FSD config for CPU tests: tiny grids and capacities."""
    seg = VoteSegmentorConfig(
        voxel_size=(0.4, 0.4, 0.4),
        point_cloud_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 3.2),
        vfe_channels=(16, 16),
        unet_base_channels=16,
        unet_output_channels=32,
        unet_encoder_channels=((16,), (32, 32), (64, 64)),
        unet_decoder_channels=((64, 32), (32, 32)),
        unet_strided_paddings=((1, 1, 1), (1, 1, 1)),
        unet_capacity_divisors=(1, 1, 2),
        head_hidden_dims=(32, 32),
    )
    head = HeadConfig(
        in_channel=3 * 64,
        shared_mlp_dims=(64, 64),
        common_attrs=(
            ("center", 3, 2, 32), ("dim", 3, 2, 32), ("rot", 2, 2, 32), ("vel", 2, 2, 32)
        ),
        cls_hidden_dim=32,
        max_num=64,
    )
    kw = dict(
        segmentor=seg,
        head=head,
        sir_feat_channels=((32, 32),) * 3,
        sir_rel_mlp_hidden=((8, 16),) * 3,
        caps=_small_caps(),
    )
    kw.update(overrides)
    return FSDConfig(**kw)
