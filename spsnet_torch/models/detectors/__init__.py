"""Detector registry (``pcdet/models/detectors/__init__.py``) and the
port's inference entry point."""
from __future__ import annotations

import torch

from ..blocks import init_weights
from .iassd import IASSD

_DETECTORS = {'IASSD': IASSD}


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
                   input_channels: int = 4):
    """Build the detector named by ``model_cfg.NAME`` on ``device`` in eval
    mode, with seeded random weights drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None). Load trained weights with
    ``load_state_dict`` or ``utils.weights.load_flax``."""
    device = resolve_device(device)
    name = model_cfg.NAME
    if name not in _DETECTORS:
        raise NotImplementedError(
            f'detector {name}: only IASSD is ported (ROADMAP Queue 1)')
    model = _DETECTORS[name](model_cfg, num_class, input_channels)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device).eval()
