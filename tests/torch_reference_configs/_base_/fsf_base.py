# RECONSTRUCTED for the tests: this is not the reference's file. It is an
# mmcv-style `_base_` config that the reconstructed FSF configs inherit, in
# the layout of mmdet3d's `_base_/datasets` + `_base_/default_runtime.py`
# files. It holds no weights and downloads nothing.

point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
class_names = [
    'car', 'truck', 'trailer', 'bus', 'construction_vehicle',
    'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier',
]
dataset_type = 'NuScenesDataset'
data_root = 'data/nuscenes/'
input_modality = dict(use_lidar=True, use_camera=True, use_radar=False, use_map=False,
                      use_external=False)
file_client_args = dict(backend='disk')

train_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=5, use_dim=5,
         file_client_args=file_client_args),
    dict(type='LoadPointsFromMultiSweeps', sweeps_num=10, file_client_args=file_client_args),
    dict(type='LoadAnnotations3D', with_bbox_3d=True, with_label_3d=True, with_attr_label=False),
    dict(type='GlobalRotScaleTrans', rot_range=[-0.3925, 0.3925],
         scale_ratio_range=[0.95, 1.05], translation_std=[0, 0, 0]),
    dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5),
    dict(type='PointsRangeFilter', point_cloud_range=point_cloud_range),
    dict(type='ObjectRangeFilter', point_cloud_range=point_cloud_range),
    dict(type='ObjectNameFilter', classes=class_names),
    dict(type='PointShuffle'),
    dict(type='DefaultFormatBundle3D', class_names=class_names),
    dict(type='Collect3D', keys=['points', 'gt_bboxes_3d', 'gt_labels_3d']),
]
test_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=5, use_dim=5,
         file_client_args=file_client_args),
    dict(type='LoadPointsFromMultiSweeps', sweeps_num=10, file_client_args=file_client_args),
    dict(type='DefaultFormatBundle3D', class_names=class_names, with_label=False),
    dict(type='Collect3D', keys=['points']),
]
data = dict(
    samples_per_gpu=2,
    workers_per_gpu=4,
    train=dict(
        type='CBGSDataset',
        dataset=dict(type=dataset_type, data_root=data_root,
                     ann_file=data_root + 'nuscenes_infos_train.pkl',
                     pipeline=train_pipeline, classes=class_names, modality=input_modality,
                     test_mode=False, box_type_3d='LiDAR')),
    val=dict(type=dataset_type, data_root=data_root,
             ann_file=data_root + 'nuscenes_infos_val.pkl', pipeline=test_pipeline,
             classes=class_names, modality=input_modality, test_mode=True,
             box_type_3d='LiDAR'),
    test=dict(type=dataset_type, data_root=data_root,
              ann_file=data_root + 'nuscenes_infos_val.pkl', pipeline=test_pipeline,
              classes=class_names, modality=input_modality, test_mode=True,
              box_type_3d='LiDAR'),
)
evaluation = dict(interval=24, pipeline=test_pipeline)

optimizer = dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999), weight_decay=0.05,
                 paramwise_cfg=dict(custom_keys=dict(segmentor=dict(lr_mult=0.2))))
optimizer_config = dict(grad_clip=dict(max_norm=10, norm_type=2))
lr_config = dict(policy='cyclic', target_ratio=(10, 1e-4), cyclic_times=1, step_ratio_up=0.4)
momentum_config = dict(policy='cyclic', target_ratio=(0.85 / 0.95, 1), cyclic_times=1,
                       step_ratio_up=0.4)
runner = dict(type='EpochBasedRunner', max_epochs=6)

checkpoint_config = dict(interval=1)
log_config = dict(interval=50, hooks=[dict(type='TextLoggerHook')])
dist_params = dict(backend='nccl')
log_level = 'INFO'
work_dir = None
load_from = None
resume_from = None
workflow = [('train', 1)]
