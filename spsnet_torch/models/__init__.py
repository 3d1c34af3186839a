from .detectors import build_detector, build_detector_from_cfg

__all__ = ['build_detector', 'build_detector_from_cfg']
