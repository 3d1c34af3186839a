"""Programmatic model configs (mirrors the ``tools/cfgs`` YAMLs) for tests,
the chip smoke run and users of the port."""
from __future__ import annotations

from .config import ROOT_DIR, EDict, cfg_from_yaml_file


def load_yaml_cfg(rel_path: str) -> EDict:
    return cfg_from_yaml_file(ROOT_DIR / rel_path)


def iassd_kitti_cfg() -> EDict:
    """The flagship full-size IA-SSD KITTI config."""
    return load_yaml_cfg('tools/cfgs/kitti_models/IA-SSD.yaml')


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
