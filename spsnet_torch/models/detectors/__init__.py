"""Detector registry (``pcdet/models/detectors/__init__.py``) and the
port's entry point."""
from __future__ import annotations

import numpy as np
import torch

from ..blocks import init_weights
from .centerpoint import CenterPoint
from .iassd import IASSD
from .point_rcnn import PointRCNN
from .pointpillar import PointPillar
from .pv_rcnn import PVRCNN
from .pv_rcnn_plusplus import PVRCNNPlusPlus
from .second_net import SECONDNet
from .voxel_rcnn import VoxelRCNN

# PAGNet and SPSNet-IA are IASSD with the PAGNet backbone and the MLT head,
# both picked by the config; SPSNet's batch carries the stability hook's
# 'stds' (``runtime.trainer.make_stability_preprocess``)
_DETECTORS = {'IASSD': IASSD, 'PAGNet': IASSD, 'SPSNet': IASSD,
              'PointRCNN': PointRCNN, 'SECONDNet': SECONDNet,
              'PVRCNN': PVRCNN, 'VoxelRCNN': VoxelRCNN,
              'CenterPoint': CenterPoint, 'PVRCNNPlusPlus': PVRCNNPlusPlus,
              'PointPillar': PointPillar}
_VOXEL_DETECTORS = (SECONDNet, PVRCNN, VoxelRCNN, CenterPoint,
                    PVRCNNPlusPlus, PointPillar)
# the modules the port has, by config block: a block naming another one
# (UNetV2, AnchorHeadMulti, ...) is not ported
_PORTED = {
    'VFE': {'MeanVFE', 'PillarVFE', 'DynamicPillarVFE', 'DynPillarVFE'},
    'BACKBONE_3D': {'IASSD_Backbone', 'PAGNet_Backbone', 'PointNet2MSG',
                    'VoxelBackBone8x', 'VoxelResBackBone8x'},
    'MAP_TO_BEV': {'HeightCompression', 'PointPillarScatter'},
    'BACKBONE_2D': {'BaseBEVBackbone'},
    'DENSE_HEAD': {'AnchorHeadSingle', 'CenterHead', 'CenterHeadIoU'},
    'PFE': {'VoxelSetAbstraction'},
    'POINT_HEAD': {'IASSD_Head', 'MLT_SSD_Head', 'PointHeadBox',
                   'PointHeadSimple'},
    'ROI_HEAD': {'PointRCNNHead', 'PVRCNNHead', 'VoxelRCNNHead'},
}


# the ROADMAP Queue 1 item of each module that the configs of tools/cfgs
# name and the port lacks
_ITEMS = {'AnchorHeadMulti': 'F6', 'SECONDHead': 'F7', 'UNetV2': 'F8',
          'PointIntraPartOffsetHead': 'F8', 'PartA2FCHead': 'F8',
          'AL_3D': 'F9', 'Sparse2BEV': 'F9', 'RB_Fusion': 'F9',
          'ImageVFE': 'F10', 'Conv2DCollapse': 'F10'}


def unported_modules(model_cfg) -> list:
    """The config blocks (with their NAME) that the port does not have."""
    return [f'{key} {block.NAME}' for key, block in model_cfg.items()
            if hasattr(block, 'get') and block.get('NAME') is not None
            and block.NAME not in _PORTED.get(key, ())]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU on its own). On CUDA, fp32 matmuls and
    convolutions are set to full fp32: no TF32, which keeps three decimal
    digits, so the card computes what JAX computes on the CPU; and cuDNN
    times its convolution algorithms at a shape's first call and keeps the
    fastest (its heuristics chose an FFT algorithm of 33 024 launches for
    the B = 2 BEV backbone of the voxel detectors: 435 ms on the H100)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the plain '
                'PyTorch versions on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    return device


def build_detector(model_cfg, num_class: int, device='cuda',
                   generator: torch.Generator | None = None,
                   input_channels: int = 4, fps_seeding=None,
                   class_names=None, **geometry):
    """Build the detector named by ``model_cfg.NAME`` on ``device`` in eval
    mode, with seeded random weights drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None). Load trained weights with
    ``load_state_dict`` or ``utils.weights.load_flax``; call ``.train()``
    for the train step (``runtime.trainer``). ``fps_seeding``
    (``ops.FpsSeeding``) turns on seeded D-FPS in the SA layers and the
    VSA; None, the default, keeps exact FPS. The voxel detectors take their
    ``voxel_size``, ``point_cloud_range`` and ``final_grid_zyx`` from
    ``geometry``, which ``build_detector_from_cfg`` derives, and
    ``class_names`` (the config's CLASS_NAMES), through which a CenterHead
    maps CLASS_NAMES_EACH_HEAD to class ids ('1', '2', ... when None)."""
    device = resolve_device(device)
    name = model_cfg.NAME
    missing = unported_modules(model_cfg)
    if name not in _DETECTORS or missing:
        items = [f'{m} item {_ITEMS[m.split()[-1]]}' for m in missing
                 if m.split()[-1] in _ITEMS]
        raise NotImplementedError('; '.join([
            f'detector {name} ({", ".join(missing) or "no such detector"}): '
            f'the port serves and trains {sorted(_DETECTORS)}', *items,
            'the rest of the voxel and two-stage zoo is ROADMAP Queue 1 '
            'item F6-F10 (F6 AnchorHeadMulti and multi-class NMS, F7 '
            'SECOND-IoU, F8 PartA2, F9 the AL_3D stack, F10 CaDDN), the rest '
            'of the point family item E']))
    cls = _DETECTORS[name]
    if cls in _VOXEL_DETECTORS:
        if cls is PVRCNN:
            geometry['fps_seeding'] = fps_seeding
        model = cls(model_cfg, num_class, input_channels,
                    class_names=class_names, **geometry)
    else:
        model = cls(model_cfg, num_class, input_channels, fps_seeding)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device).eval()


def build_detector_from_cfg(cfg, device='cuda',
                            generator: torch.Generator | None = None,
                            fps_seeding=None):
    """Build from a full experiment config, as ``spsnet_tpu/models/
    detectors/__init__.py:66-105`` does: the class names, the point
    channels from DATA_CONFIG's POINT_FEATURE_ENCODING, and for the voxel
    detectors the point-cloud range, the voxel size of its voxelization
    step and the sparse backbone's final grid (``data.processor.
    sparse_plan.plan_final_grid`` over the grid with z padded by one
    slice)."""
    from ...data.processor.sparse_plan import plan_final_grid
    geometry, channels = {}, 4
    data_cfg = cfg.get('DATA_CONFIG', None)
    if data_cfg is not None:
        pcr = data_cfg.get('POINT_CLOUD_RANGE', None)
        if pcr is not None:
            geometry['point_cloud_range'] = tuple(float(v) for v in pcr)
        for p in data_cfg.get('DATA_PROCESSOR', []) or []:
            if p['NAME'].startswith('transform_points_to_voxels') \
                    and 'VOXEL_SIZE' in p:
                geometry['voxel_size'] = tuple(float(v)
                                               for v in p['VOXEL_SIZE'])
        pfe = data_cfg.get('POINT_FEATURE_ENCODING', None)
        if pfe is not None:
            channels = len(pfe['used_feature_list'])
        if 'voxel_size' in geometry and pcr is not None and \
                cfg.MODEL.get('BACKBONE_3D', None) is not None:
            span = np.asarray(pcr[3:6]) - np.asarray(pcr[0:3])
            grid_zyx = np.round(span / np.asarray(
                geometry['voxel_size'])).astype(np.int64)[::-1].copy()
            grid_zyx[0] += 1
            geometry['final_grid_zyx'] = plan_final_grid(grid_zyx)
    if _DETECTORS.get(cfg.MODEL.NAME) not in _VOXEL_DETECTORS:
        geometry = {}
    return build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
                          generator=generator, input_channels=channels,
                          fps_seeding=fps_seeding,
                          class_names=list(cfg.CLASS_NAMES), **geometry)
