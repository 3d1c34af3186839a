"""Programmatic model configs (mirrors the ``tools/cfgs`` YAMLs) for tests,
the chip smoke run and users of the port."""
from __future__ import annotations

from .config import ROOT_DIR, EDict, cfg_from_yaml_file


def load_yaml_cfg(rel_path: str) -> EDict:
    return cfg_from_yaml_file(ROOT_DIR / rel_path)


def iassd_kitti_cfg() -> EDict:
    """The flagship full-size IA-SSD KITTI config."""
    return load_yaml_cfg('tools/cfgs/kitti_models/IA-SSD.yaml')


def spsnet_kitti_cfg() -> EDict:
    """The SPSNet flagship KITTI config (stability hook, PAGNet backbone,
    sss_aware sampling, MLT head)."""
    return load_yaml_cfg('tools/cfgs/kitti_models/SPSNet.yaml')


def pointrcnn_kitti_cfg() -> EDict:
    """PointRCNN KITTI (``tools/cfgs/kitti_models/pointrcnn.yaml``): the
    two-stage point detector, PointNet2MSG + PointHeadBox +
    PointRCNNHead."""
    return load_yaml_cfg('tools/cfgs/kitti_models/pointrcnn.yaml')


def pv_rcnn_kitti_cfg() -> EDict:
    """PV-RCNN KITTI (``tools/cfgs/kitti_models/pv_rcnn.yaml``): SECOND's
    voxel stack for the proposals, voxel set abstraction of 2048 keypoints
    and the RoI-grid head."""
    return load_yaml_cfg('tools/cfgs/kitti_models/pv_rcnn.yaml')


def second_kitti_cfg() -> EDict:
    """SECOND KITTI (``tools/cfgs/kitti_models/second.yaml``)."""
    return load_yaml_cfg('tools/cfgs/kitti_models/second.yaml')


def voxel_rcnn_kitti_cfg() -> EDict:
    """Voxel R-CNN KITTI (``tools/cfgs/kitti_models/voxel_rcnn_car.yaml``):
    SECOND's voxel stack for the proposals and the RoI-grid pool over the
    voxels of x_conv2-4."""
    return load_yaml_cfg('tools/cfgs/kitti_models/voxel_rcnn_car.yaml')


def centerpoint_waymo_cfg() -> EDict:
    """CenterPoint Waymo (``tools/cfgs/waymo_models/centerpoint.yaml``):
    VoxelResBackBone8x, the BEV backbone and the CenterHead decode."""
    return load_yaml_cfg('tools/cfgs/waymo_models/centerpoint.yaml')


def pv_rcnn_plusplus_waymo_cfg(resnet: bool = False) -> EDict:
    """PV-RCNN++ Waymo (``tools/cfgs/waymo_models/pv_rcnn_plusplus.yaml``,
    or ``pv_rcnn_plusplus_resnet.yaml`` with ``resnet``): the plain
    CenterHead, SPC keypoints and VectorPool aggregation."""
    name = 'pv_rcnn_plusplus_resnet' if resnet else 'pv_rcnn_plusplus'
    return load_yaml_cfg(f'tools/cfgs/waymo_models/{name}.yaml')


def pointpillar_kitti_cfg() -> EDict:
    """PointPillars KITTI (``tools/cfgs/kitti_models/pointpillar.yaml``):
    PillarVFE over 0.16 m pillars, the scatter, the BEV backbone and
    AnchorHeadSingle."""
    return load_yaml_cfg('tools/cfgs/kitti_models/pointpillar.yaml')


def pointpillar_waymo_cfg() -> EDict:
    """PointPillars Waymo (``tools/cfgs/waymo_models/pointpillar_1x.yaml``):
    0.32 m pillars, a 468 x 468 map, the anchors at stride 1."""
    return load_yaml_cfg('tools/cfgs/waymo_models/pointpillar_1x.yaml')


def centerpoint_pillar_waymo_cfg(dynamic: bool = False) -> EDict:
    """CenterPoint over pillars on Waymo
    (``tools/cfgs/waymo_models/centerpoint_pillar_1x.yaml``, or with
    ``dynamic`` ``centerpoint_dyn_pillar_1x.yaml``: DynamicPillarVFE over
    65 536 sampled points)."""
    name = 'centerpoint_dyn_pillar_1x' if dynamic else \
        'centerpoint_pillar_1x'
    return load_yaml_cfg(f'tools/cfgs/waymo_models/{name}.yaml')


def stability_cfg() -> EDict:
    """The stability model's own training config (MODEL: ``GenerateCenter``
    at npoint 16384, MSG 0.2 / 0.8; OPTIMIZATION: ``adam_onecycle`` at LR
    0.003, 16 scenes a step)."""
    return load_yaml_cfg('tools/cfgs/stability/sf_unc.yaml')


def scale_sa_config(model_cfg: EDict, factor: int) -> EDict:
    """Shrink NPOINT_LIST by ``factor`` (for small test shapes)."""
    sa = model_cfg.BACKBONE_3D.SA_CONFIG
    sa.NPOINT_LIST = [[max(p // factor, 4) if p > 0 else p for p in layer]
                      for layer in sa.NPOINT_LIST]
    return model_cfg


def tiny_iassd_cfg() -> EDict:
    """Tiny IA-SSD (CPU-fast) with the same topology as the flagship."""
    return EDict({
        'NAME': 'IASSD',
        'BACKBONE_3D': {
            'NAME': 'IASSD_Backbone',
            'SA_CONFIG': {
                'NPOINT_LIST': [[128], [64], [32], [16], [-1], [16]],
                'SAMPLE_RANGE_LIST': [[-1]] * 6,
                'SAMPLE_METHOD_LIST': [['D-FPS'], ['D-FPS'], ['ctr_aware'],
                                       ['ctr_aware'], [], []],
                'RADIUS_LIST': [[0.2, 0.8], [0.8, 1.6], [1.6, 4.8], [], [],
                                [4.8, 6.4]],
                'NSAMPLE_LIST': [[4, 8], [4, 8], [4, 8], [], [], [4, 8]],
                'MLPS': [[[8, 8, 16], [8, 8, 16]],
                         [[16, 16, 32], [16, 16, 32]],
                         [[32, 32, 32], [32, 32, 32]],
                         [],
                         [32],
                         [[32, 32, 64], [32, 32, 64]]],
                'LAYER_TYPE': ['SA_Layer', 'SA_Layer', 'SA_Layer', 'SA_Layer',
                               'Vote_Layer', 'SA_Layer'],
                'DILATED_GROUP': [False] * 6,
                'AGGREGATION_MLPS': [[16], [32], [64], [64], [], [64]],
                'CONFIDENCE_MLPS': [[], [16], [32], [], [], []],
                'LAYER_INPUT': [0, 1, 2, 3, 4, 3],
                'CTR_INDEX': [-1, -1, -1, -1, -1, 5],
                'MAX_TRANSLATE_RANGE': [3.0, 3.0, 2.0],
            },
        },
        'POINT_HEAD': {
            'NAME': 'IASSD_Head',
            'CLS_FC': [32], 'REG_FC': [32],
            'CLASS_AGNOSTIC': False,
            'TARGET_CONFIG': {
                'INS_AWARE_ASSIGN': True,
                'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2],
                'ASSIGN_METHOD': {
                    'NAME': 'extend_gt', 'ASSIGN_TYPE': 'centers_origin',
                    'EXTRA_WIDTH': [1.0, 1.0, 1.0], 'FG_PC_IGNORE': False,
                },
                'BOX_CODER': 'PointResidual_BinOri_Coder',
                'BOX_CODER_CONFIG': {
                    'angle_bin_num': 12,
                    'use_mean_size': True,
                    'mean_size': [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                                  [1.76, 0.6, 1.73]],
                },
            },
            'LOSS_CONFIG': {
                'LOSS_CLS': 'WeightedCrossEntropy',
                'LOSS_REG': 'WeightedSmoothL1Loss',
                'LOSS_INS': 'WeightedCrossEntropy',
                'SAMPLE_METHOD_LIST': [['D-FPS'], ['D-FPS'], ['ctr_aware'],
                                       ['ctr_aware'], [], []],
                'LOSS_VOTE_TYPE': 'none',
                'CORNER_LOSS_REGULARIZATION': True,
                'CENTERNESS_REGULARIZATION': True,
                'CENTERNESS_REGULARIZATION_SA': True,
                'LOSS_WEIGHTS': {
                    'ins_aware_weight': [0, 1.0, 1.0],
                    'vote_weight': 1.0, 'point_cls_weight': 1.0,
                    'point_box_weight': 1.0, 'corner_weight': 1.0,
                    'code_weights': [1.0] * 6, 'dir_weight': 0.2,
                },
            },
        },
        'POST_PROCESSING': {
            'RECALL_THRESH_LIST': [0.3, 0.5, 0.7],
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {
                'MULTI_CLASSES_NMS': False, 'NMS_TYPE': 'nms_gpu',
                'NMS_THRESH': 0.01, 'NMS_PRE_MAXSIZE': 64,
                'NMS_POST_MAXSIZE': 16,
            },
        },
    })


def tiny_spsnet_cfg() -> EDict:
    """Tiny SPSNet-IA: PAGNet backbone (surface features + stds threading),
    sss_aware samplers, MLT head."""
    cfg = tiny_iassd_cfg()
    cfg.NAME = 'SPSNet'
    sa = cfg.BACKBONE_3D.SA_CONFIG
    cfg.BACKBONE_3D.NAME = 'PAGNet_Backbone'
    sa.SAMPLE_METHOD_LIST = [['D-FPS'], ['D-FPS'], ['sss_aware'],
                             ['sss_aware'], [], []]
    sa.SS_RADIUS_LIST = [[0.05], [0.2], [0.4], [0.8], [], []]
    sa.SS_NSAMPLE_LIST = [[4], [4], [4], [4], [], []]
    sa.USE_SURFACE = True
    cfg.POINT_HEAD.NAME = 'MLT_SSD_Head'
    cfg.POINT_HEAD.LOSS_CONFIG.SAMPLE_METHOD_LIST = sa.SAMPLE_METHOD_LIST
    return cfg


def tiny_pointrcnn_cfg() -> EDict:
    """Tiny PointRCNN (CPU-fast) with the flagship two-stage topology."""
    return EDict({
        'NAME': 'PointRCNN',
        'BACKBONE_3D': {
            'NAME': 'PointNet2MSG',
            'SA_CONFIG': {
                'NPOINTS': [64, 32, 16, 8],
                'RADIUS': [[0.1, 0.5], [0.5, 1.0], [1.0, 2.0], [2.0, 4.0]],
                'NSAMPLE': [[4, 8], [4, 8], [4, 8], [4, 8]],
                'MLPS': [[[8, 8, 16], [8, 8, 16]],
                         [[16, 16, 32], [16, 16, 32]],
                         [[32, 32, 64], [32, 32, 64]],
                         [[64, 64, 128], [64, 64, 128]]],
            },
            'FP_MLPS': [[32, 32], [32, 32], [64, 64], [64, 64]],
        },
        'POINT_HEAD': {
            'NAME': 'PointHeadBox',
            'CLS_FC': [32], 'REG_FC': [32],
            'CLASS_AGNOSTIC': False,
            'TARGET_CONFIG': {
                'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2],
                'BOX_CODER': 'PointResidualCoder',
                'BOX_CODER_CONFIG': {
                    'use_mean_size': True,
                    'mean_size': [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                                  [1.76, 0.6, 1.73]],
                },
            },
            'LOSS_CONFIG': {
                'LOSS_REG': 'WeightedSmoothL1Loss',
                'LOSS_WEIGHTS': {
                    'point_cls_weight': 1.0, 'point_box_weight': 1.0,
                    'code_weights': [1.0] * 8,
                },
            },
        },
        'ROI_HEAD': {
            'NAME': 'PointRCNNHead',
            'CLASS_AGNOSTIC': True,
            'ROI_POINT_POOL': {
                # generous so sparse synthetic clouds still pool points
                'POOL_EXTRA_WIDTH': [8.0, 8.0, 8.0],
                'NUM_SAMPLED_POINTS': 32,
                'DEPTH_NORMALIZER': 70.0,
            },
            'XYZ_UP_LAYER': [16, 16],
            'CLS_FC': [32], 'REG_FC': [32],
            'DP_RATIO': 0.0, 'USE_BN': False,
            'SA_CONFIG': {
                'NPOINTS': [16, 8, -1],
                'RADIUS': [0.2, 0.4, 100],
                'NSAMPLE': [4, 4, 4],
                'MLPS': [[16, 16], [16, 32], [32, 64]],
            },
            'NMS_CONFIG': {
                'TRAIN': {'NMS_TYPE': 'nms_gpu', 'MULTI_CLASSES_NMS': False,
                          'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16,
                          'NMS_THRESH': 0.8},
                'TEST': {'NMS_TYPE': 'nms_gpu', 'MULTI_CLASSES_NMS': False,
                         'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 8,
                         'NMS_THRESH': 0.85},
            },
            'TARGET_CONFIG': {
                'BOX_CODER': 'ResidualCoder',
                'ROI_PER_IMAGE': 16, 'FG_RATIO': 0.5,
                'SAMPLE_ROI_BY_EACH_CLASS': True,
                'CLS_SCORE_TYPE': 'cls',
                'CLS_FG_THRESH': 0.6, 'CLS_BG_THRESH': 0.45,
                'CLS_BG_THRESH_LO': 0.1, 'HARD_BG_RATIO': 0.8,
                'REG_FG_THRESH': 0.55,
            },
            'LOSS_CONFIG': {
                'CLS_LOSS': 'BinaryCrossEntropy',
                'REG_LOSS': 'smooth-l1',
                'CORNER_LOSS_REGULARIZATION': True,
                'LOSS_WEIGHTS': {
                    'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.0,
                    'rcnn_corner_weight': 1.0, 'code_weights': [1.0] * 7,
                },
            },
        },
        'POST_PROCESSING': {
            'RECALL_THRESH_LIST': [0.3, 0.5, 0.7],
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {
                'MULTI_CLASSES_NMS': False, 'NMS_TYPE': 'nms_gpu',
                'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 64,
                'NMS_POST_MAXSIZE': 16,
            },
        },
    })


def tiny_stability_model_cfg() -> EDict:
    """A tiny ``STABILITY_HOOK.MODEL`` (the stability model of the JAX
    package's SPSNet chain test): one SA layer at npoint 256."""
    return EDict({
        'SF_FEATURE_DIM': 32, 'LATENT_DIM': 4,
        'SA_CONFIG': {
            'NPOINT_LIST': [[256]],
            'SAMPLE_RANGE_LIST': [[-1]],
            'SAMPLE_METHOD_LIST': [['D-FPS']],
            'RADIUS_LIST': [[0.2, 0.8]],
            'NSAMPLE_LIST': [[4, 8]],
            'MLPS': [[[8, 8, 16], [8, 8, 16]]],
            'LAYER_TYPE': ['SA_Layer'],
            'DILATED_GROUP': [False],
            'AGGREGATION_MLPS': [[32]],
            'CONFIDENCE_MLPS': [[]],
            'LAYER_INPUT': [0],
            'CTR_INDEX': [-1],
        },
        'GENERATOR': {'LATENT_DIM': 4, 'PW_FEATURE_DIM': 32},
        'TARGET_CONFIG': {'INS_AWARE_ASSIGN': True,
                          'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
        'LOSS_CONFIG': {'LOSS_REG': 'WeightedSmoothL1Loss',
                        'LOSS_WEIGHTS': {'code_weights': [1.0, 1.0, 1.0]}},
    })


def tiny_pvrcnn_cfg(final_zyx) -> EDict:
    """Tiny PV-RCNN (CPU-fast) with the topology of ``pv_rcnn.yaml``, for
    a sparse grid whose final (nz, ny, nx) is ``final_zyx``; the JAX
    package's tests build the same (``tests/test_pvrcnn.py``)."""
    return EDict({
        'NAME': 'PVRCNN',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
        'MAP_TO_BEV': {'NAME': 'HeightCompression',
                       'NUM_BEV_FEATURES': int(final_zyx[0]) * 128},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone',
                        'LAYER_NUMS': [1], 'LAYER_STRIDES': [1],
                        'NUM_FILTERS': [32], 'UPSAMPLE_STRIDES': [1],
                        'NUM_UPSAMPLE_FILTERS': [32]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle', 'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True,
            'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': [
                {'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                 'anchor_rotations': [0, 1.57],
                 'anchor_bottom_heights': [-1.78],
                 'align_center': False, 'feature_map_stride': 8,
                 'matched_threshold': 0.6, 'unmatched_threshold': 0.45}],
            'TARGET_ASSIGNER_CONFIG': {'BOX_CODER': 'ResidualCoder'},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2,
                'code_weights': [1.0] * 7}},
        },
        'PFE': {
            'NAME': 'VoxelSetAbstraction',
            'NUM_KEYPOINTS': 64,
            'NUM_OUTPUT_FEATURES': 32,
            'FEATURES_SOURCE': ['bev', 'x_conv3', 'x_conv4', 'raw_points'],
            'SA_LAYER': {
                'raw_points': {'MLPS': [[8, 8], [8, 8]],
                               'POOL_RADIUS': [0.4, 0.8], 'NSAMPLE': [4, 4]},
                'x_conv3': {'DOWNSAMPLE_FACTOR': 4,
                            'MLPS': [[8, 8], [8, 8]],
                            'POOL_RADIUS': [1.2, 2.4], 'NSAMPLE': [4, 4]},
                'x_conv4': {'DOWNSAMPLE_FACTOR': 8,
                            'MLPS': [[8, 8], [8, 8]],
                            'POOL_RADIUS': [2.4, 4.8], 'NSAMPLE': [4, 4]},
            },
        },
        'POINT_HEAD': {
            'NAME': 'PointHeadSimple',
            'CLS_FC': [16],
            'CLASS_AGNOSTIC': True,
            'USE_POINT_FEATURES_BEFORE_FUSION': True,
            'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0}},
        },
        'ROI_HEAD': {
            'NAME': 'PVRCNNHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32],
            'CLS_FC': [32], 'REG_FC': [32],
            'ROI_GRID_POOL': {'GRID_SIZE': 3,
                              'MLPS': [[8, 8], [8, 8]],
                              'POOL_RADIUS': [0.8, 1.6], 'NSAMPLE': [4, 4]},
            'NMS_CONFIG': {
                'TRAIN': {'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16,
                          'NMS_THRESH': 0.8},
                'TEST': {'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 8,
                         'NMS_THRESH': 0.85}},
            'TARGET_CONFIG': {
                'BOX_CODER': 'ResidualCoder',
                'ROI_PER_IMAGE': 16, 'FG_RATIO': 0.5,
                'SAMPLE_ROI_BY_EACH_CLASS': True,
                'CLS_SCORE_TYPE': 'roi_iou',
                'CLS_FG_THRESH': 0.75, 'CLS_BG_THRESH': 0.25,
                'CLS_BG_THRESH_LO': 0.1, 'HARD_BG_RATIO': 0.8,
                'REG_FG_THRESH': 0.55},
            'LOSS_CONFIG': {
                'CLS_LOSS': 'BinaryCrossEntropy', 'REG_LOSS': 'smooth-l1',
                'CORNER_LOSS_REGULARIZATION': True,
                'LOSS_WEIGHTS': {'rcnn_cls_weight': 1.0,
                                 'rcnn_reg_weight': 1.0,
                                 'rcnn_corner_weight': 1.0,
                                 'code_weights': [1.0] * 7}},
        },
        'POST_PROCESSING': {'SCORE_THRESH': 0.1, 'NMS_CONFIG': {
            'MULTI_CLASSES_NMS': False, 'NMS_THRESH': 0.1,
            'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16}},
    })


def tiny_voxelrcnn_cfg(final_zyx) -> EDict:
    """Tiny Voxel R-CNN (CPU-fast) with the topology of
    ``voxel_rcnn_car.yaml``; the JAX package's tests build the same
    (``tests/test_voxelrcnn.py``)."""
    pv = tiny_pvrcnn_cfg(final_zyx)
    cfg = EDict({k: pv[k] for k in ('VFE', 'BACKBONE_3D', 'MAP_TO_BEV',
                                    'BACKBONE_2D', 'DENSE_HEAD',
                                    'POST_PROCESSING')})
    cfg.NAME = 'VoxelRCNN'
    cfg.ROI_HEAD = EDict({
        'NAME': 'VoxelRCNNHead', 'CLASS_AGNOSTIC': True,
        'SHARED_FC': [32, 32], 'CLS_FC': [32], 'REG_FC': [32],
        'ROI_GRID_POOL': {
            'GRID_SIZE': 3,
            'FEATURES_SOURCE': ['x_conv3', 'x_conv4'],
            'POOL_LAYERS': {
                'x_conv3': {'MLPS': [[8, 8]], 'POOL_RADIUS': [1.2],
                            'NSAMPLE': [4]},
                'x_conv4': {'MLPS': [[8, 8]], 'POOL_RADIUS': [2.4],
                            'NSAMPLE': [4]},
            },
        },
        'NMS_CONFIG': pv.ROI_HEAD.NMS_CONFIG,
        'TARGET_CONFIG': pv.ROI_HEAD.TARGET_CONFIG,
        'LOSS_CONFIG': pv.ROI_HEAD.LOSS_CONFIG})
    return cfg


def tiny_centerpoint_voxel_cfg(final_zyx) -> EDict:
    """Tiny voxel CenterPoint (CPU-fast) with the topology of the
    res3d-centerpoint configs: VoxelResBackBone8x, two head groups (Car;
    Pedestrian and Cyclist) of the upstream CenterHead decode, the
    velocity maps of nuScenes and the fork's IoU map with its rectifier,
    for a sparse grid whose final (nz, ny, nx) is ``final_zyx``."""
    return EDict({
        'NAME': 'CenterPoint',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelResBackBone8x'},
        'MAP_TO_BEV': {'NAME': 'HeightCompression',
                       'NUM_BEV_FEATURES': int(final_zyx[0]) * 128},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone',
                        'LAYER_NUMS': [1], 'LAYER_STRIDES': [1],
                        'NUM_FILTERS': [32], 'UPSAMPLE_STRIDES': [1],
                        'NUM_UPSAMPLE_FILTERS': [32]},
        'DENSE_HEAD': {
            'NAME': 'CenterHead', 'CLASS_AGNOSTIC': False,
            'CLASS_NAMES_EACH_HEAD': [['Car'], ['Pedestrian', 'Cyclist']],
            'SHARED_CONV_CHANNEL': 16, 'USE_BIAS_BEFORE_NORM': True,
            'NUM_HM_CONV': 2,
            'SEPARATE_HEAD_CFG': {
                'HEAD_ORDER': ['center', 'center_z', 'dim', 'rot', 'vel'],
                'HEAD_DICT': {
                    'center': {'out_channels': 2, 'num_conv': 2},
                    'center_z': {'out_channels': 1, 'num_conv': 2},
                    'dim': {'out_channels': 3, 'num_conv': 2},
                    'rot': {'out_channels': 2, 'num_conv': 2},
                    'vel': {'out_channels': 2, 'num_conv': 2},
                    'iou': {'out_channels': 1, 'num_conv': 2}}},
            'TARGET_ASSIGNER_CONFIG': {
                'FEATURE_MAP_STRIDE': 8, 'NUM_MAX_OBJS': 16,
                'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 0.25, 'iou_weight': 1.0,
                'code_weights': [1.0] * 6 + [0.2, 0.2, 1.0, 1.0]}},
            'POST_PROCESSING': {
                'SCORE_THRESH': 0.1,
                'POST_CENTER_LIMIT_RANGE': [-1.0, -8.0, -5.0, 14.0, 8.0, 3.0],
                'MAX_OBJ_PER_SAMPLE': 48, 'RECTIFIER': [0.5, 0.6, 0.7],
                'NMS_CONFIG': {'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.2,
                               'NMS_PRE_MAXSIZE': 48,
                               'NMS_POST_MAXSIZE': 12}},
        },
        'POST_PROCESSING': {'RECALL_THRESH_LIST': [0.3, 0.5, 0.7],
                            'EVAL_METRIC': 'kitti'},
    })


def _vector_pool_cfg(agg_type, reduced, groups) -> dict:
    cfg = {'NAME': 'VectorPoolAggregationModuleMSG',
           'NUM_GROUPS': len(groups),
           'LOCAL_AGGREGATION_TYPE': agg_type,
           'NUM_REDUCED_CHANNELS': reduced,
           'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
           'MSG_POST_MLPS': [16]}
    for k, (nv, r, ns) in enumerate(groups):
        cfg[f'GROUP_CFG_{k}'] = {'NUM_LOCAL_VOXEL': nv,
                                 'MAX_NEIGHBOR_DISTANCE': r,
                                 'NEIGHBOR_NSAMPLE': ns,
                                 'POST_MLPS': [8, 8]}
    return cfg


def tiny_pvrcnnpp_cfg(final_zyx) -> EDict:
    """Tiny PV-RCNN++ (CPU-fast) with the topology of
    ``waymo_models/pv_rcnn_plusplus.yaml``, for a sparse grid whose final
    (nz, ny, nx) is ``final_zyx``; the JAX package's tests build the same
    (``tests/test_pvrcnn_plusplus.py``)."""
    return EDict({
        'NAME': 'PVRCNNPlusPlus',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
        'MAP_TO_BEV': {'NAME': 'HeightCompression',
                       'NUM_BEV_FEATURES': int(final_zyx[0]) * 128},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone',
                        'LAYER_NUMS': [1], 'LAYER_STRIDES': [1],
                        'NUM_FILTERS': [32], 'UPSAMPLE_STRIDES': [1],
                        'NUM_UPSAMPLE_FILTERS': [32]},
        'DENSE_HEAD': {
            'NAME': 'CenterHead', 'CLASS_AGNOSTIC': False,
            'SHARED_CONV_CHANNEL': 16,
            'TARGET_ASSIGNER_CONFIG': {
                'FEATURE_MAP_STRIDE': 8, 'NUM_MAX_OBJS': 16,
                'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2},
            'POST_CONFIG': {'MAX_OBJ_PER_SAMPLE': 32},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0,
                'code_weights': [1.0] * 8}},
        },
        'PFE': {
            'NAME': 'VoxelSetAbstraction',
            'NUM_KEYPOINTS': 64,
            'NUM_OUTPUT_FEATURES': 32,
            'SAMPLE_METHOD': 'SPC',
            'SPC_SAMPLING': {'NUM_SECTORS': 4,
                             'SAMPLE_RADIUS_WITH_ROI': 1.6},
            'FEATURES_SOURCE': ['bev', 'x_conv3', 'x_conv4', 'raw_points'],
            'SA_LAYER': {
                'raw_points': _vector_pool_cfg(
                    'local_interpolation', 1,
                    [([2, 2, 2], 0.4, -1), ([3, 3, 3], 0.8, -1)]),
                'x_conv3': _vector_pool_cfg('local_interpolation', 32,
                                            [([3, 3, 3], 1.2, -1)]),
                'x_conv4': _vector_pool_cfg('local_interpolation', 32,
                                            [([3, 3, 3], 2.4, -1)]),
            },
        },
        'POINT_HEAD': {
            'NAME': 'PointHeadSimple',
            'CLS_FC': [16],
            'CLASS_AGNOSTIC': True,
            'USE_POINT_FEATURES_BEFORE_FUSION': False,
            'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0}},
        },
        'ROI_HEAD': {
            'NAME': 'PVRCNNHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32], 'CLS_FC': [32], 'REG_FC': [32],
            'ROI_GRID_POOL': dict(
                _vector_pool_cfg('voxel_random_choice', 16,
                                 [([2, 2, 2], 0.8, 8), ([2, 2, 2], 1.6, 8)]),
                GRID_SIZE=3, IN_CHANNEL=32),
            'NMS_CONFIG': {
                'TRAIN': {'NMS_PRE_MAXSIZE': 32, 'NMS_POST_MAXSIZE': 16,
                          'NMS_THRESH': 0.8},
                'TEST': {'NMS_PRE_MAXSIZE': 32, 'NMS_POST_MAXSIZE': 8,
                         'NMS_THRESH': 0.85}},
            'TARGET_CONFIG': {
                'BOX_CODER': 'ResidualCoder',
                'ROI_PER_IMAGE': 16, 'FG_RATIO': 0.5,
                'SAMPLE_ROI_BY_EACH_CLASS': True,
                'CLS_SCORE_TYPE': 'roi_iou',
                'CLS_FG_THRESH': 0.75, 'CLS_BG_THRESH': 0.25,
                'CLS_BG_THRESH_LO': 0.1, 'HARD_BG_RATIO': 0.8,
                'REG_FG_THRESH': 0.55},
            'LOSS_CONFIG': {
                'CLS_LOSS': 'BinaryCrossEntropy', 'REG_LOSS': 'smooth-l1',
                'CORNER_LOSS_REGULARIZATION': True,
                'LOSS_WEIGHTS': {'rcnn_cls_weight': 1.0,
                                 'rcnn_reg_weight': 1.0,
                                 'rcnn_corner_weight': 1.0,
                                 'code_weights': [1.0] * 7}},
        },
        'POST_PROCESSING': {'SCORE_THRESH': 0.1, 'NMS_CONFIG': {
            'MULTI_CLASSES_NMS': False, 'NMS_THRESH': 0.1,
            'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16}},
    })


def tiny_pointpillar_cfg() -> EDict:
    """Tiny PointPillars over a small BEV grid (CPU-fast)."""
    return EDict({
        'NAME': 'PointPillar',
        'VFE': {'NAME': 'PillarVFE', 'WITH_DISTANCE': False,
                'USE_ABSOLUTE_XYZ': True, 'USE_NORM': True,
                'NUM_FILTERS': [32]},
        'MAP_TO_BEV': {'NAME': 'PointPillarScatter', 'NUM_BEV_FEATURES': 32},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone',
                        'LAYER_NUMS': [2, 2], 'LAYER_STRIDES': [2, 2],
                        'NUM_FILTERS': [32, 64],
                        'UPSAMPLE_STRIDES': [1, 2],
                        'NUM_UPSAMPLE_FILTERS': [64, 64]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle',
            'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True,
            'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0,
            'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': [
                {'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                 'anchor_rotations': [0, 1.57],
                 'anchor_bottom_heights': [-1.78],
                 'align_center': False, 'feature_map_stride': 2,
                 'matched_threshold': 0.6, 'unmatched_threshold': 0.45},
                {'class_name': 'Pedestrian', 'anchor_sizes': [[0.8, 0.6, 1.73]],
                 'anchor_rotations': [0, 1.57],
                 'anchor_bottom_heights': [-0.6],
                 'align_center': False, 'feature_map_stride': 2,
                 'matched_threshold': 0.5, 'unmatched_threshold': 0.35},
                {'class_name': 'Cyclist', 'anchor_sizes': [[1.76, 0.6, 1.73]],
                 'anchor_rotations': [0, 1.57],
                 'anchor_bottom_heights': [-0.6],
                 'align_center': False, 'feature_map_stride': 2,
                 'matched_threshold': 0.5, 'unmatched_threshold': 0.35},
            ],
            'TARGET_ASSIGNER_CONFIG': {
                'NAME': 'AxisAlignedTargetAssigner',
                'POS_FRACTION': -1.0, 'SAMPLE_SIZE': 512,
                'NORM_BY_NUM_EXAMPLES': False,
                'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder',
            },
            'LOSS_CONFIG': {
                'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                 'dir_weight': 0.2,
                                 'code_weights': [1.0] * 7},
            },
        },
        'POST_PROCESSING': {
            'RECALL_THRESH_LIST': [0.3, 0.5, 0.7],
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False, 'NMS_TYPE': 'nms_gpu',
                           'NMS_THRESH': 0.01, 'NMS_PRE_MAXSIZE': 256,
                           'NMS_POST_MAXSIZE': 32},
        },
    })


def tiny_centerpoint_cfg() -> EDict:
    """Tiny CenterPoint-pillar (CPU-fast)."""
    cfg = tiny_pointpillar_cfg()
    cfg.NAME = 'CenterPoint'
    cfg.DENSE_HEAD = EDict({
        'NAME': 'CenterHead',
        'CLASS_AGNOSTIC': False,
        'SHARED_CONV_CHANNEL': 32,
        'TARGET_ASSIGNER_CONFIG': {
            'FEATURE_MAP_STRIDE': 2,
            'NUM_MAX_OBJS': 32,
            'GAUSSIAN_OVERLAP': 0.1,
            'MIN_RADIUS': 2,
        },
        'POST_CONFIG': {'MAX_OBJ_PER_SAMPLE': 32},
        'LOSS_CONFIG': {
            'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                             'code_weights': [1.0] * 8},
        },
    })
    return cfg
