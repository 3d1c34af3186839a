"""SPSNet's stability model, its loss and train step, and its
point-deletion hook."""
from .hook import (apply_stability_hook, fake_labels_from_boxes,
                   stability_delete_points)
from .model import (GenerateCenter, assign_stability_targets,
                    generate_center_loss)
from .train import make_stability_train_step

__all__ = ['GenerateCenter', 'apply_stability_hook',
           'assign_stability_targets', 'fake_labels_from_boxes',
           'generate_center_loss', 'make_stability_train_step',
           'stability_delete_points']
