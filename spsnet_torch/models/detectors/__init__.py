"""Detector registry (``pcdet/models/detectors/__init__.py``) and the
port's entry point."""
from __future__ import annotations

import torch

from ..blocks import init_weights
from .iassd import IASSD
from .point_rcnn import PointRCNN

# PAGNet and SPSNet-IA are IASSD with the PAGNet backbone and the MLT head,
# both picked by the config; SPSNet's batch carries the stability hook's
# 'stds' (``runtime.trainer.make_stability_preprocess``)
_DETECTORS = {'IASSD': IASSD, 'PAGNet': IASSD, 'SPSNet': IASSD,
              'PointRCNN': PointRCNN}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU on its own). On CUDA, fp32 matmuls and
    convolutions are set to full fp32: no TF32, which keeps three decimal
    digits, so the card computes what JAX computes on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the plain '
                'PyTorch versions on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def build_detector(model_cfg, num_class: int, device='cuda',
                   generator: torch.Generator | None = None,
                   input_channels: int = 4, fps_seeding=None):
    """Build the detector named by ``model_cfg.NAME`` on ``device`` in eval
    mode, with seeded random weights drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None). Load trained weights with
    ``load_state_dict`` or ``utils.weights.load_flax``; call ``.train()``
    for the train step (``runtime.trainer``). ``fps_seeding``
    (``ops.FpsSeeding``) turns on seeded D-FPS in the SA layers; None, the
    default, keeps exact FPS."""
    device = resolve_device(device)
    name = model_cfg.NAME
    if name not in _DETECTORS or 'VFE' in model_cfg:
        # a PAGNet config with a VFE block is the AL_3D pillar stack, a
        # PointRCNN one PartA2_free's voxel stack
        raise NotImplementedError(
            f'detector {name}: the port has the point configs of '
            f'{sorted(_DETECTORS)}; the voxel, pillar and two-stage zoo is '
            'ROADMAP Queue 1 item F')
    model = _DETECTORS[name](model_cfg, num_class, input_channels,
                             fps_seeding)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device).eval()
