# RECONSTRUCTED for the tests: this is not the reference's
# `projects/configs/Argoverse2/FSF_AV2_config.py`, which is not in the
# repository. It inherits the nuScenes FSF config and overrides what
# `config.av2_fsf_config()` changes, with the facts `tests/test_config_compat.py`
# asserts of the reference's file: 26 classes, 7 ring cameras, code size 8
# (no velocity), a +-204.8 m range, foreground score threshold 0.4 for
# vehicles, `connected_dist` per class group. The dataset entries replace the
# base's through `_delete_`. It holds no weights and downloads nothing.

_base_ = ['../nuScenes/FSF_nuScenes_config.py']

point_cloud_range = [-204.8, -204.8, -3.2, 204.8, 204.8, 3.2]
class_names = [
    'Regular_vehicle',
    'Pedestrian', 'Bicyclist', 'Motorcyclist', 'Wheeled_rider',
    'Bollard', 'Construction_cone', 'Sign', 'Construction_barrel',
    'Stop_sign', 'Mobile_pedestrian_crossing_sign',
    'Large_vehicle', 'Bus', 'Box_truck', 'Truck', 'Vehicular_trailer',
    'Truck_cab', 'School_bus', 'Articulated_bus', 'Message_board_trailer',
    'Bicycle', 'Motorcycle', 'Wheeled_device', 'Wheelchair', 'Stroller',
    'Dog',
]
group_names = [class_names[:1], class_names[1:5], class_names[5:11], class_names[11:20],
               class_names[20:25], class_names[25:]]
num_classes = len(class_names)
seg_score_thresh = (0.4, 0.25, 0.25, 0.25, 0.25, 0.25)
norm_cfg = dict(type='LN', eps=1e-3)
common_attrs = dict(center=(3, 2, 128), dim=(3, 2, 128), rot=(2, 2, 128))
coder = dict(type='BasePointBBoxCoder', code_size=8)
# what the three heads share (no velocity term); each head's dict replaces
# the base's through `_delete_`
head_common = dict(
    num_classes=num_classes,
    bbox_coder=coder,
    loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=4.0, alpha=0.25, loss_weight=1.0),
    loss_center=dict(type='L1Loss', loss_weight=0.5),
    loss_size=dict(type='L1Loss', loss_weight=0.5),
    loss_rot=dict(type='L1Loss', loss_weight=0.2),
    shared_mlp_dims=[1024, 1024],
    norm_cfg=norm_cfg,
    tasks=[dict(class_names=class_names)],
    class_names=class_names,
    common_attrs=common_attrs,
    num_cls_layer=2,
    cls_hidden_dim=128,
    separate_head=dict(type='FSDSeparateHead', norm_cfg=norm_cfg, act='gelu'),
)

model = dict(
    num_cams=7,
    segmentor=dict(
        voxel_layer=dict(point_cloud_range=point_cloud_range),
        voxel_encoder=dict(in_channels=4, point_cloud_range=point_cloud_range),
        backbone=dict(sparse_shape=[32, 2048, 2048]),
        decode_neck=dict(point_cloud_range=point_cloud_range),
        segmentation_head=dict(
            num_classes=num_classes,
            loss_decode=dict(class_weight=[1.0] * num_classes + [0.1]),
        ),
        train_cfg=dict(score_thresh=seg_score_thresh, class_names=class_names),
    ),
    bbox_head=dict(_delete_=True, type='SparseClusterHeadV2', in_channel=128 * 3 * 2,
                   as_rpn=False, train_cfg=None, test_cfg=None, **head_common),
    cluster_assigner=dict(
        cluster_voxel_size=[[0.3, 0.3, 6.4], [0.05, 0.05, 6.4], [0.08, 0.08, 6.4],
                            [0.5, 0.5, 6.4], [0.1, 0.1, 6.4], [0.08, 0.08, 6.4]],
        point_cloud_range=point_cloud_range,
        connected_dist=[0.6, 0.1, 0.15, 1.0, 0.2, 0.15],
        class_names=group_names,
    ),
    frustum_obj_head=dict(_delete_=True, type='FrustumClusterHead',
                          in_channel=128 * 3 * 2 + 128,
                          test_cfg=dict(nms_thr=0.35, score_thr=0.01, max_num=500),
                          **head_common),
    refined_obj_head=[dict(
        type='FrustumRefinedHead',
        **dict(head_common, loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=4.0,
                                          alpha=0.25, loss_weight=2.0)),
        in_channel=1024,
        assigner=dict(
            type='DistAssigner',
            assigner_dist=dict(
                assign_tasks=[dict(class_names=g) for g in group_names],
                max_dist=[[1.0] * len(g) for g in group_names],
            ),
        ),
        test_cfg=dict(nms_thr=0.35, score_thr=0.01, max_num=500),
    )],
    train_cfg=dict(score_thresh=seg_score_thresh, group_names=group_names,
                   class_names=class_names),
    test_cfg=dict(score_thresh=seg_score_thresh, group_names=group_names),
)

dataset_type = 'Argoverse2Dataset'
data_root = 'data/argo2/'
av2_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=4, use_dim=4),
    dict(type='PointsRangeFilter', point_cloud_range=point_cloud_range),
    dict(type='DefaultFormatBundle3D', class_names=class_names, with_label=False),
    dict(type='Collect3D', keys=['points']),
]
data = dict(
    train=dict(_delete_=True, type=dataset_type, data_root=data_root,
               ann_file=data_root + 'av2_infos_train.pkl', pipeline=av2_pipeline,
               classes=class_names, test_mode=False, box_type_3d='LiDAR'),
    val=dict(_delete_=True, type=dataset_type, data_root=data_root,
             ann_file=data_root + 'av2_infos_val.pkl', pipeline=av2_pipeline,
             classes=class_names, test_mode=True, box_type_3d='LiDAR'),
    test=dict(_delete_=True, type=dataset_type, data_root=data_root,
              ann_file=data_root + 'av2_infos_val.pkl', pipeline=av2_pipeline,
              classes=class_names, test_mode=True, box_type_3d='LiDAR'),
)
evaluation = dict(pipeline=av2_pipeline)
