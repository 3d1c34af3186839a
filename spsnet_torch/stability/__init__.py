"""SPSNet's stability model and its point-deletion hook."""
from .hook import (apply_stability_hook, fake_labels_from_boxes,
                   stability_delete_points)
from .model import GenerateCenter

__all__ = ['GenerateCenter', 'apply_stability_hook', 'fake_labels_from_boxes',
           'stability_delete_points']
