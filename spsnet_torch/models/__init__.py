from .detectors import build_detector

__all__ = ['build_detector']
