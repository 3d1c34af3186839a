"""IA-SSD's bin-orientation box coder.

``PointResidual_BinOri_Coder`` (``box_coder_utils.py:224-319``, as in
``spsnet_tpu/utils/box_coder.py:83-156``): six residuals (xyz normalised by
the class mean-size diagonal, log dims) plus ``bin_size`` orientation-bin
logits and ``bin_size`` in-bin residuals; ``code_size = 6 + 2 * bin_size``.
"""
from __future__ import annotations

import numpy as np
import torch


class PointResidualBinOriCoder:

    def __init__(self, use_mean_size=True, mean_size=None, angle_bin_num=12,
                 **kwargs):
        self.bin_size = int(kwargs.get('bin_size', angle_bin_num))
        self.code_size = 6 + 2 * self.bin_size
        self.bin_inter = 2 * np.pi / self.bin_size
        self.use_mean_size = use_mean_size
        if use_mean_size:
            self.mean_size = np.asarray(mean_size, dtype=np.float32)
            if self.mean_size.min() <= 0:
                raise ValueError('mean_size entries must be positive')

    def _anchor_size(self, classes):
        """Mean sizes of (...,) classes in [1, num_class] -> (..., 3)."""
        mean = torch.as_tensor(self.mean_size, device=classes.device)
        return mean[(classes.long() - 1).clamp(0, mean.shape[0] - 1)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """(..., 7+) gt boxes at (..., 3) points, (...,) classes in
        [1, num_class] -> (..., 8) targets ``[xt, yt, zt, dxt, dyt, dzt,
        bin_id, bin_res]``; ``bin_id`` is an integer held as a float."""
        dims = gt_boxes[..., 3:6].clamp(min=1e-5)
        xg, yg, zg = gt_boxes[..., :3].unbind(-1)
        dxg, dyg, dzg = dims.unbind(-1)
        rg = gt_boxes[..., 6]
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_size(gt_classes).unbind(-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xt = (xg - xa) / diagonal
            yt = (yg - ya) / diagonal
            zt = (zg - za) / dza
            dxt = torch.log(dxg / dxa)
            dyt = torch.log(dyg / dya)
            dzt = torch.log(dzg / dza)
        else:
            xt, yt, zt = xg - xa, yg - ya, zg - za
            dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
        rg = rg.clamp(-np.pi + 1e-5, np.pi - 1e-5)
        bin_id = torch.floor((rg + np.pi) / self.bin_inter)
        bin_res = ((rg + np.pi) - (bin_id * self.bin_inter
                                   + self.bin_inter / 2)) \
            / (self.bin_inter / 2)
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, bin_id, bin_res],
                           dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """(..., 6 + 2*bins) predictions at (..., 3) points -> (..., 7)
        boxes; ``pred_classes`` (...,) in [1, num_class] picks the mean
        size."""
        xt, yt, zt, dxt, dyt, dzt = box_encodings[..., :6].unbind(-1)
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_size(pred_classes).unbind(-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xg = xt * diagonal + xa
            yg = yt * diagonal + ya
            zg = zt * dza + za
            dxg = torch.exp(dxt) * dxa
            dyg = torch.exp(dyt) * dya
            dzg = torch.exp(dzt) * dza
        else:
            xg, yg, zg = xt + xa, yt + ya, zt + za
            dxg, dyg, dzg = torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)

        bins = box_encodings[..., 6:6 + self.bin_size]
        res_all = box_encodings[..., 6 + self.bin_size:6 + 2 * self.bin_size]
        bin_id = bins.argmax(dim=-1)
        bin_res = res_all.gather(-1, bin_id[..., None])[..., 0]
        rg = bin_id.to(box_encodings.dtype) * self.bin_inter - np.pi \
            + self.bin_inter / 2 + bin_res * (self.bin_inter / 2)
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)


_CODERS = {'PointResidual_BinOri_Coder': PointResidualBinOriCoder}


def build_box_coder(name, **kwargs):
    if name not in _CODERS:
        raise NotImplementedError(
            f'box coder {name}: only PointResidual_BinOri_Coder is ported '
            '(ROADMAP Queue 1 items 8-9)')
    return _CODERS[name](**kwargs)
