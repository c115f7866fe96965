# RECONSTRUCTED for the tests: this is not the reference's
# `projects/configs/nuScenes/FSF_nuScenes_config.py`, which is not in the
# repository. It has the structure of the `model` dict that
# `config_compat.interpret_fsf_config` reads, and its values are those of
# `config.nusc_fsf_config()` and of the facts `tests/test_config_compat.py`
# asserts of the reference's file: voxel size 0.2, the 512-channel stage 4,
# stage 3's (0, 1, 1) zyx padding, `connected_dist` per class group, the
# frustum head's 896 inputs, the refinement's DistAssigner table (car 1.0,
# bus 4.0, barrier 0.0). It holds no weights and downloads nothing.

_base_ = ['../_base_/fsf_base.py']

voxel_size = [0.2, 0.2, 0.2]
point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
class_names = [
    'car', 'truck', 'trailer', 'bus', 'construction_vehicle',
    'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier',
]
group_names = [['car'], ['truck', 'construction_vehicle'], ['bus', 'trailer'], ['barrier'],
               ['motorcycle', 'bicycle'], ['pedestrian', 'traffic_cone']]
num_classes = len(class_names)
seg_voxel_size = (0.2, 0.2, 0.2)
sparse_shape = [40, 512, 512]

seg_score_thresh = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
norm_cfg = dict(type='LN', eps=1e-3)
common_attrs = dict(center=(3, 2, 128), dim=(3, 2, 128), rot=(2, 2, 128), vel=(2, 2, 128))
box_losses = dict(
    loss_center=dict(type='L1Loss', loss_weight=0.5),
    loss_size=dict(type='L1Loss', loss_weight=0.5),
    loss_rot=dict(type='L1Loss', loss_weight=0.2),
    loss_vel=dict(type='L1Loss', loss_weight=0.2),
)

model = dict(
    type='FSF',
    num_cams=6,
    segmentor=dict(
        type='VoteSegmentor',
        voxel_layer=dict(voxel_size=seg_voxel_size, max_num_points=-1,
                         point_cloud_range=point_cloud_range, max_voxels=(-1, -1)),
        voxel_encoder=dict(type='DynamicScatterVFE', in_channels=5, feat_channels=[64, 64],
                           voxel_size=seg_voxel_size, with_cluster_center=True,
                           with_voxel_center=True, point_cloud_range=point_cloud_range,
                           norm_cfg=dict(type='naiveSyncBN1d', eps=1e-3, momentum=0.01)),
        middle_encoder=dict(type='PseudoMiddleEncoderForSpconvFSD'),
        backbone=dict(
            type='SimpleSparseUNet',
            in_channels=64,
            sparse_shape=sparse_shape,
            order=('conv', 'norm', 'act'),
            norm_cfg=dict(type='naiveSyncBN1d', eps=1e-3, momentum=0.01),
            base_channels=64,
            output_channels=128,
            encoder_channels=((128,), (128, 128, 128), (128, 128, 128), (256, 256, 256),
                              (512, 512, 512)),
            encoder_paddings=((1,), (1, 1, 1), (1, 1, 1), ((0, 1, 1), 1, 1), (1, 1, 1)),
            decoder_channels=((512, 512, 256), (256, 256, 128), (128, 128, 128),
                              (128, 128, 128), (128, 128, 128)),
            decoder_paddings=((1, 1), (1, 0), (1, 0), (0, 0), (0, 1)),
        ),
        decode_neck=dict(type='Voxel2PointScatterNeck', voxel_size=seg_voxel_size,
                         point_cloud_range=point_cloud_range),
        segmentation_head=dict(
            type='VoteSegHead',
            in_channel=67,
            hidden_dims=[128, 128],
            num_classes=num_classes,
            dropout_ratio=0.0,
            conv_cfg=dict(type='Conv1d'),
            norm_cfg=dict(type='naiveSyncBN1d'),
            act_cfg=dict(type='ReLU'),
            loss_decode=dict(type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.8,
                             loss_weight=10.0, class_weight=[1.0] * num_classes + [0.1]),
            loss_vote=dict(type='L1Loss', loss_weight=1.0),
        ),
        train_cfg=dict(point_loss=True, score_thresh=seg_score_thresh,
                       class_names=class_names, centroid_offset=False),
    ),
    backbone=dict(
        type='SIR',
        num_blocks=3,
        in_channels=[84] + [133] * 2,
        feat_channels=[[128, 128]] * 3,
        rel_mlp_hidden_dims=[[16, 32]] * 3,
        norm_cfg=norm_cfg,
        mode='max',
        xyz_normalizer=[20.0, 20.0, 4.0],
        act='gelu',
        unique_once=True,
    ),
    bbox_head=dict(
        type='SparseClusterHeadV2',
        num_classes=num_classes,
        bbox_coder=dict(type='BasePointBBoxCoder', code_size=10),
        loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=4.0, alpha=0.25,
                      loss_weight=1.0),
        **box_losses,
        in_channel=128 * 3 * 2,
        shared_mlp_dims=[1024, 1024],
        train_cfg=None,
        test_cfg=None,
        norm_cfg=norm_cfg,
        tasks=[dict(class_names=class_names)],
        class_names=class_names,
        common_attrs=common_attrs,
        num_cls_layer=2,
        cls_hidden_dim=128,
        separate_head=dict(type='FSDSeparateHead', norm_cfg=norm_cfg, act='gelu'),
        as_rpn=False,
    ),
    cluster_assigner=dict(
        cluster_voxel_size=[[0.3, 0.3, 8.0], [0.3, 0.3, 8.0], [0.3, 0.3, 8.0],
                            [0.1, 0.1, 8.0], [0.2, 0.2, 8.0], [0.05, 0.05, 8.0]],
        min_points=2,
        point_cloud_range=point_cloud_range,
        connected_dist=[0.6, 0.6, 0.6, 0.2, 0.4, 0.1],
        class_names=group_names,
    ),
    frustum_obj_head=dict(
        type='FrustumClusterHead',
        num_classes=num_classes,
        bbox_coder=dict(type='BasePointBBoxCoder', code_size=10),
        loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=4.0, alpha=0.25,
                      loss_weight=1.0),
        **box_losses,
        in_channel=128 * 3 * 2 + 128,
        shared_mlp_dims=[1024, 1024],
        norm_cfg=norm_cfg,
        tasks=[dict(class_names=class_names)],
        class_names=class_names,
        common_attrs=common_attrs,
        num_cls_layer=2,
        cls_hidden_dim=128,
        separate_head=dict(type='FSDSeparateHead', norm_cfg=norm_cfg, act='gelu'),
        test_cfg=dict(nms_thr=0.35, score_thr=0.01, max_num=500),
    ),
    refined_obj_head=[dict(
        type='FrustumRefinedHead',
        num_classes=num_classes,
        bbox_coder=dict(type='BasePointBBoxCoder', code_size=10),
        loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=4.0, alpha=0.25,
                      loss_weight=2.0),
        **box_losses,
        in_channel=1024,
        shared_mlp_dims=[1024, 1024],
        norm_cfg=norm_cfg,
        tasks=[dict(class_names=class_names)],
        class_names=class_names,
        common_attrs=common_attrs,
        num_cls_layer=2,
        cls_hidden_dim=128,
        separate_head=dict(type='FSDSeparateHead', norm_cfg=norm_cfg, act='gelu'),
        assigner=dict(
            type='DistAssigner',
            assigner_dist=dict(
                assign_tasks=[dict(class_names=g) for g in group_names],
                max_dist=[[1.0], [1.0, 0.5], [4.0, 2.0], [0.0], [0.5, 0.5], [0.5, 0.5]],
            ),
        ),
        test_cfg=dict(nms_thr=0.35, score_thr=0.01, max_num=500),
    )],
    mlp_cfg=dict(embed_dims=1024),
    roi_extractor=dict(type='DynamicPointROIExtractor', extra_wlh=[1.0, 1.0, 1.0],
                       max_inbox_point=512, max_all_pts=200000),
    refine_encode_2d_mlp_cfg=dict(mlp_channel=[32, 32]),
    train_cfg=dict(
        score_thresh=seg_score_thresh,
        sync_reg_avg_factor=True,
        pre_voxelization_size=[0.1, 0.1, 0.1],
        disable_pretrain=True,
        disable_pretrain_topks=[600] * 6,
        group_names=group_names,
        centroid_assign=True,
        class_names=class_names,
    ),
    test_cfg=dict(
        score_thresh=seg_score_thresh,
        pre_voxelization_size=[0.1, 0.1, 0.1],
        skip_rcnn=True,
        group_names=group_names,
        use_rotate_nms=True,
        nms_pre=-1,
        nms_thr=0.25,
        score_thr=0.05,
        min_bbox_size=0,
        max_num=500,
    ),
)

data = dict(samples_per_gpu=1, workers_per_gpu=4)
runner = dict(type='EpochBasedRunner', max_epochs=6)
