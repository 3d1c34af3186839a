"""Box coders of the point family.

- ``ResidualCoder`` (``box_coder_utils.py:5-68``, as in
  ``spsnet_tpu/utils/box_coder.py:19-81``): the anchor residual coder
  PointRCNN's RoI head decodes against each RoI;
- ``PointResidualCoder`` (``box_coder_utils.py:144-221``, as
  ``box_coder.py:159-214``): PointRCNN's point head, eight residuals with
  the heading as (cos, sin);
- ``PointResidual_BinOri_Coder`` (``box_coder_utils.py:224-319``, as
  ``box_coder.py:83-156``): IA-SSD's, six residuals (xyz normalised by the
  class mean-size diagonal, log dims) plus ``bin_size`` orientation-bin
  logits and ``bin_size`` in-bin residuals; ``code_size = 6 + 2 *
  bin_size``.
"""
from __future__ import annotations

import numpy as np
import torch


def _split(t, n):
    return [t[..., i] for i in range(n)]


class ResidualCoder:
    """Anchor residual coder: xy by the anchor's BEV diagonal, z by its
    height, log size ratios, the heading difference (or its cos and sin
    differences with ``encode_angle_by_sincos``), extra channels as
    differences."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size + int(bool(encode_angle_by_sincos))
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """(..., 7+) boxes against (..., 7+) anchors -> (..., code_size)."""
        anchors = torch.cat([anchors[..., :3],
                             anchors[..., 3:6].clamp(min=1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5),
                           boxes[..., 6:]], dim=-1)
        xa, ya, za, dxa, dya, dza, ra = _split(anchors, 7)
        xg, yg, zg, dxg, dyg, dzg, rg = _split(boxes, 7)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        parts = [(xg - xa) / diagonal, (yg - ya) / diagonal,
                 (zg - za) / dza, torch.log(dxg / dxa), torch.log(dyg / dya),
                 torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            parts += [torch.cos(rg) - torch.cos(ra),
                      torch.sin(rg) - torch.sin(ra)]
        else:
            parts.append(rg - ra)
        e = min(boxes.shape[-1], anchors.shape[-1]) - 7
        extra = boxes[..., 7:7 + e] - anchors[..., 7:7 + e]
        return torch.cat([torch.stack(parts, dim=-1), extra], dim=-1)

    def decode(self, encodings, anchors):
        """(..., code_size) against (..., 7+) anchors -> (..., 7+) boxes;
        anchors with fewer extra channels than the code are zero-padded."""
        xa, ya, za, dxa, dya, dza, ra = _split(anchors, 7)
        n = 8 if self.encode_angle_by_sincos else 7
        xt, yt, zt, dxt, dyt, dzt = _split(encodings, 6)
        rest = encodings[..., n:]
        extra_a = anchors[..., 7:]
        if rest.shape[-1] > extra_a.shape[-1]:
            pad = rest.shape[-1] - extra_a.shape[-1]
            extra_a = torch.cat([extra_a, extra_a.new_zeros(
                (*extra_a.shape[:-1], pad))], dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rg = torch.atan2(encodings[..., 7] + torch.sin(ra),
                             encodings[..., 6] + torch.cos(ra))
        else:
            rg = encodings[..., 6] + ra
        out = torch.stack([xt * diagonal + xa, yt * diagonal + ya,
                           zt * dza + za, torch.exp(dxt) * dxa,
                           torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg],
                          dim=-1)
        return torch.cat([out, rest + extra_a[..., :rest.shape[-1]]], dim=-1)


class PointResidualCoder:
    """Point residual coder with the heading as (cos, sin): (..., 7+) gt at
    (..., 3) points -> ``[xt, yt, zt, dxt, dyt, dzt, cos, sin, extra...]``,
    xyz normalised by the class mean size when ``use_mean_size``."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None,
                 **kwargs):
        self.code_size = code_size
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
        dims = gt_boxes[..., 3:6].clamp(min=1e-5)
        xg, yg, zg = _split(gt_boxes, 3)
        dxg, dyg, dzg = _split(dims, 3)
        rg = gt_boxes[..., 6]
        xa, ya, za = _split(points, 3)
        if self.use_mean_size:
            dxa, dya, dza = _split(self._anchor_size(gt_classes), 3)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            parts = [(xg - xa) / diagonal, (yg - ya) / diagonal,
                     (zg - za) / dza, torch.log(dxg / dxa),
                     torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            parts = [xg - xa, yg - ya, zg - za, torch.log(dxg),
                     torch.log(dyg), torch.log(dzg)]
        parts += [torch.cos(rg), torch.sin(rg)]
        return torch.cat([torch.stack(parts, dim=-1), gt_boxes[..., 7:]],
                         dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """(..., 8) predictions at (..., 3) points -> (..., 7) boxes;
        ``pred_classes`` (...,) in [1, num_class] picks the mean size."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = _split(box_encodings, 8)
        xa, ya, za = _split(points, 3)
        if self.use_mean_size:
            dxa, dya, dza = _split(self._anchor_size(pred_classes), 3)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xyz = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za]
            dims = [torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                    torch.exp(dzt) * dza]
        else:
            xyz = [xt + xa, yt + ya, zt + za]
            dims = [torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        return torch.stack([*xyz, *dims, torch.atan2(sint, cost)], dim=-1)


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


_CODERS = {'ResidualCoder': ResidualCoder,
           'PointResidualCoder': PointResidualCoder,
           'PointResidual_BinOri_Coder': PointResidualBinOriCoder,
           'PointResidualBinOriCoder': PointResidualBinOriCoder}


def build_box_coder(name, **kwargs):
    if name not in _CODERS:
        raise NotImplementedError(
            f'box coder {name}: the port has {sorted(_CODERS)} (the '
            'others are ROADMAP Queue 1 item F)')
    return _CODERS[name](**kwargs)
