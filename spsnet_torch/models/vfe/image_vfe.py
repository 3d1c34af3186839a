"""CaDDN's camera-to-voxel feature encoder (``vfe/image_vfe.py`` +
``image_vfe_modules/``, as ``spsnet_tpu/models/vfe/image_vfe.py``), NCHW.

- ``DDN``: the JAX package's compact residual encoder (not the reference's
  DeepLabV3-ResNet101, ROADMAP Queue 3): a 7 x 7 stride-2 stem, a 3 x 3
  stride-2 max-pool, two residual blocks at stride 4 (the features), a
  third at twice the width, three 3 x 3 convolutions at dilations 1, 6 and
  12, and a 1 x 1 classifier to D + 1 depth bins. Every BatchNorm at flax's
  momentum 0.99 and eps 1e-3 (``blocks.BatchNormNCHW``). Submodules carry
  the flax names (``stem``, ``stem_bn``, ``layer1a.Conv_0``, ...), which
  the weight bridge maps one to one.
- ``ImageVFE``: the channel reduce (1 x 1 conv, BN, ReLU), the softmax over
  D + 1 bins without the last (beyond range), their outer product as the
  frustum volume (B, C, D, Hf, Wf), the sample grid of the voxel centres
  (``FrustumGrid``) and ``trilinear_sample``: (B, C, X, Y, Z) voxels.
- ``image_vfe_loss``: focal cross entropy on the binned lidar depth, fg /
  bg weighted by the 2D boxes.

JAX computes all of it in XLA (no ``pallas_call``); the port in plain
PyTorch, cuDNN's convolutions and ``F.grid_sample``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_count
from ...utils.common import true_div
from ..blocks import BatchNormNCHW
from .pillar_vfe import f32


def _rounded_once(fn, x):
    """``fn`` of fp32 ``x`` in float64, rounded to fp32 once: the correctly
    rounded fp32 square root (torch's fp32 ``sqrt`` on the CPU is an ulp
    off it at times, the card's and numpy's are not), and a log that the
    card and the CPU round alike."""
    return fn(x.double()).to(x.dtype)


def bin_depths(depth_map, mode: str, depth_min: float, depth_max: float,
               num_bins: int, target: bool = False):
    """Continuous depth -> bin index (``transform_utils.bin_depths``, as
    ``spsnet_tpu/models/vfe/image_vfe.py:32-53``) in the JAX package's op
    order, its Python constants rounded to fp32, its quotients true ones on
    every device (``true_div``) and its square root and log rounded once
    (``_rounded_once``): the floor of a target is a discrete decision. With
    ``target``, out-of-range and non-finite indices become the extra class
    ``num_bins``, then the floor (int64)."""
    if mode == 'UD':
        bin_size = (depth_max - depth_min) / num_bins
        indices = true_div(depth_map - f32(depth_min), f32(bin_size))
    elif mode == 'LID':
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * _rounded_once(torch.sqrt, 1 + true_div(
            8 * (depth_map - f32(depth_min)), f32(bin_size)))
    elif mode == 'SID':
        indices = true_div(num_bins * (
            _rounded_once(torch.log, 1 + depth_map) -
            f32(math.log(1 + depth_min))),
            f32(math.log(1 + depth_max) - math.log(1 + depth_min)))
    else:
        raise NotImplementedError(mode)
    if target:
        bad = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
        indices = torch.where(bad, float(num_bins), indices)
        indices = indices.clamp(0, num_bins).floor().long()
    return indices


def _bn(channels: int) -> BatchNormNCHW:
    return BatchNormNCHW(channels, eps=1e-3, momentum=0.01)


class ResBlock(nn.Module):
    """Two 3 x 3 bias-free convolutions with BatchNorm, the input (through
    the 1 x 1 ``proj`` where the width or stride changes) added before the
    last ReLU (``image_vfe.py:56-74``)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, channels, 3, stride, 1,
                                bias=False)
        self.BatchNorm_0 = _bn(channels)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.BatchNorm_1 = _bn(channels)
        self.proj = nn.Conv2d(in_channels, channels, 1, stride, bias=False) \
            if in_channels != channels or stride != 1 else None

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        return F.relu(h + (x if self.proj is None else self.proj(x)))


class DDN(nn.Module):
    """The depth distribution network (``image_vfe.py:77-110``): images
    (B, H, W, 3) -> features (B, C, H/4, W/4) and logits (B, D + 1, H/4,
    W/4). ``layer2`` is not dilated (the code's, whatever its comment
    says)."""

    def __init__(self, num_bins: int, feat_channels: int = 64):
        super().__init__()
        c = feat_channels
        self.stem = nn.Conv2d(3, c // 2, 7, 2, 3, bias=False)
        self.stem_bn = _bn(c // 2)
        self.layer1a = ResBlock(c // 2, c)
        self.layer1b = ResBlock(c, c)
        self.layer2 = ResBlock(c, 2 * c)
        for i, d in enumerate((1, 6, 12)):
            setattr(self, f'aspp{i}', nn.Conv2d(2 * c, c, 3, padding=d,
                                                dilation=d, bias=False))
            setattr(self, f'aspp{i}_bn', _bn(c))
        self.classifier = nn.Conv2d(3 * c, num_bins + 1, 1)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.stem_bn(self.stem(x)))
        # flax's max_pool pads with -inf, as torch's does
        x = F.max_pool2d(x, 3, 2, 1)
        feat = self.layer1b(self.layer1a(x))
        h = self.layer2(feat)
        h = torch.cat([F.relu(getattr(self, f'aspp{i}_bn')(
            getattr(self, f'aspp{i}')(h))) for i in range(3)], dim=1)
        return feat, self.classifier(h)


def trilinear_sample(volume, grid):
    """The frustum volume (B, C, D, Hf, Wf) at (B, X, Y, Z, 3) grid points
    (u, v, d) normalised to [-1, 1]: (B, C, X, Y, Z). ``F.grid_sample``'s
    default ``align_corners=False`` mapping ``((g + 1) size - 1) / 2`` with
    zeros outside, which the reference's Sampler relies on and the JAX
    package reproduces (``image_vfe.py:113-150``)."""
    return F.grid_sample(volume, grid, mode='bilinear', padding_mode='zeros',
                         align_corners=False)


def voxel_centers(grid_size, point_cloud_range) -> np.ndarray:
    """(X, Y, Z, 3) float32 lidar coordinates of the voxel centres, in the
    JAX package's numpy fp32 arithmetic (``image_vfe.py:169-175``): the
    voxel size is the range's span over the grid, not the config's."""
    X, Y, Z = [int(g) for g in grid_size]
    pcr = np.asarray(point_cloud_range, np.float32)
    vs = (pcr[3:] - pcr[:3]) / np.asarray([X, Y, Z], np.float32)
    ix, iy, iz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing='ij')
    centers = np.stack([ix, iy, iz], axis=-1).astype(np.float32) + 0.5
    return centers * vs + pcr[:3]


class FrustumGrid(nn.Module):
    """The sample grid of the voxel centres (``make_frustum_grid``,
    ``image_vfe.py:153-196``; reference ``frustum_grid_generator.py``).
    The centres are a buffer made once; a call projects them, lidar ->
    camera -> image, through the two (B, 4, 4) and (B, 3, 4) products,
    takes depth = z_img - P[2, 3] and the guarded ``1 / (z + 1e-8)``,
    normalises u and v by the full-resolution image shape minus one and
    the bin by ``num_bins - 1``, and sends non-finite entries to -2."""

    def __init__(self, grid_size, point_cloud_range, disc, num_bins: int,
                 image_shape):
        super().__init__()
        self.register_buffer('centers', torch.from_numpy(
            voxel_centers(grid_size, point_cloud_range)), persistent=False)
        self.disc, self.num_bins = disc, num_bins
        self.image_shape = [int(s) for s in image_shape]

    def forward(self, lidar_to_cam, cam_to_img):
        """(B, 4, 4), (B, 3, 4) -> the (B, X, Y, Z, 3) grid."""
        ones = self.centers.new_ones(self.centers.shape[:-1] + (1,))
        lidar_h = torch.cat([self.centers, ones], dim=-1)
        cam = torch.einsum('bij,xyzj->bxyzi', lidar_to_cam, lidar_h)[..., :3]
        cam_h = torch.cat([cam, cam.new_ones(cam.shape[:-1] + (1,))], dim=-1)
        img = torch.einsum('bij,bxyzj->bxyzi', cam_to_img, cam_h)
        depth = img[..., 2] - cam_to_img[:, 2, 3][:, None, None, None]
        z = img[..., 2:3]
        scale = torch.where(z.abs() > f32(1e-8), 1.0 / (z + f32(1e-8)), 1.0)
        uv = img[..., :2] * scale
        d_bin = bin_depths(depth, self.disc['mode'],
                           float(self.disc['depth_min']),
                           float(self.disc['depth_max']), self.num_bins)
        h, w = self.image_shape
        grid = torch.stack([
            true_div(uv[..., 0], float(w - 1)) * 2 - 1,
            true_div(uv[..., 1], float(h - 1)) * 2 - 1,
            true_div(d_bin, float(self.num_bins - 1)) * 2 - 1], dim=-1)
        return torch.where(torch.isfinite(grid), grid, -2.0)


class ImageVFE(nn.Module):
    """Images and calibration -> 'voxel_features_3d' (B, C, X, Y, Z) and
    'image_vfe_ret' {'depth_logits': (B, D + 1, Hf, Wf)}
    (``image_vfe.py:199-247``). Each stage is a method, so that a profile
    can range it."""

    def __init__(self, model_cfg, grid_size, point_cloud_range):
        super().__init__()
        ffn = model_cfg.FFN
        self.disc = dict(ffn.DDN.DISCRETIZE) if 'DISCRETIZE' in ffn.DDN \
            else dict(ffn.DISCRETIZE)
        self.num_bins = int(self.disc['num_bins'])
        self.downsample = int(model_cfg.get('DOWNSAMPLE_FACTOR', 4))
        feat = int(ffn.DDN.get('FEAT_CHANNELS', 64))
        self.ddn = DDN(self.num_bins, feat)
        cr = ffn.CHANNEL_REDUCE
        k = int(cr.get('kernel_size', 1))
        self.channel_reduce = nn.Conv2d(feat, int(cr['out_channels']), k,
                                        padding=k // 2,
                                        bias=bool(cr.get('bias', False)))
        self.channel_reduce_bn = _bn(int(cr['out_channels']))
        self.grid = FrustumGrid(grid_size, point_cloud_range, self.disc,
                                self.num_bins, model_cfg.IMAGE_SHAPE)

    def reduce(self, feat):
        return F.relu(self.channel_reduce_bn(self.channel_reduce(feat)))

    def depth_probs(self, logits):
        """The softmax over the D + 1 bins without the beyond-range one."""
        return torch.softmax(logits, dim=1)[:, :self.num_bins]

    @staticmethod
    def frustum(probs, feat):
        """(B, D, Hf, Wf) x (B, C, Hf, Wf) -> (B, C, D, Hf, Wf)."""
        return probs[:, None] * feat[:, :, None]

    @staticmethod
    def sample(volume, grid):
        return trilinear_sample(volume, grid)

    def forward(self, batch):
        feat, logits = self.ddn(batch['images'])
        volume = self.frustum(self.depth_probs(logits), self.reduce(feat))
        grid = self.grid(batch['trans_lidar_to_cam'],
                         batch['trans_cam_to_img'])
        return dict(batch, voxel_features_3d=self.sample(volume, grid),
                    image_vfe_ret={'depth_logits': logits})


def depth_targets(depth_maps, disc, downsample: int, shape):
    """The binned depth of each feature pixel (B, Hf, Wf), int64: the
    full-resolution (B, H, W) depth map strided by ``downsample``
    (``image_vfe.py:258``) and cut to ``shape``. A map that is already at
    feature resolution (the data processor's block mean) does not stride
    to it: ValueError, as JAX's loss fails to broadcast it (ROADMAP
    Queue 3)."""
    strided = depth_maps[:, ::downsample, ::downsample][
        :, :shape[0], :shape[1]]
    if tuple(strided.shape[1:]) != tuple(shape):
        raise ValueError(
            f'depth maps {tuple(depth_maps.shape)} strided by {downsample} '
            f'give {tuple(strided.shape[1:])}, not the logits\' '
            f'{tuple(shape)}: the loss takes full-resolution depth maps')
    return bin_depths(strided, disc['mode'], float(disc['depth_min']),
                      float(disc['depth_max']), int(disc['num_bins']),
                      target=True)


def foreground(boxes2d, downsample: int, shape):
    """(B, Hf, Wf) bool: the feature pixels (x, y) inside a 2D box of
    (B, N, 4) full-resolution [x1, y1, x2, y2] over the factor, x1 <= x <
    x2 and y1 <= y < y2 (the balancer's fg mask); a box with x2 <= x1 is
    padding."""
    boxes = true_div(boxes2d, float(downsample))
    ys = torch.arange(shape[0], dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(shape[1], dtype=boxes.dtype, device=boxes.device)
    b = boxes[:, None, None]                         # (B, 1, 1, N, 4)
    inside = ((xs[None, None, :, None] >= b[..., 0]) &
              (xs[None, None, :, None] < b[..., 2]) &
              (ys[None, :, None, None] >= b[..., 1]) &
              (ys[None, :, None, None] < b[..., 3]) &
              (b[..., 2] > b[..., 0]))
    return inside.any(-1)


def image_vfe_loss(ret, batch, loss_cfg, disc_cfg, downsample: int):
    """The depth-distribution loss (``image_vfe.py:250-290``; reference
    ``ddn_loss.py`` + ``balancer.py``): focal cross entropy (alpha, gamma)
    of the logits at the binned depth, weighted fg_weight inside a 2D box
    (full-resolution [x1, y1, x2, y2] of 'gt_boxes2d' (B, N, 4) over the
    factor; a box with x2 <= x1 is padding) and bg_weight elsewhere, the
    mean over B x Hf x Wf (B the joined batch's in a data-parallel step,
    ``parallel.global_count``) times ``weight``. Returns (loss,
    {'ddn_loss'})."""
    logits = ret['depth_logits']                     # (B, D + 1, Hf, Wf)
    B, _, Hf, Wf = logits.shape
    target = depth_targets(batch['depth_maps'], disc_cfg, downsample,
                           (Hf, Wf))
    logp = torch.log_softmax(logits, dim=1).gather(1, target[:, None])[:, 0]
    alpha = f32(loss_cfg.get('alpha', 0.25))
    gamma = f32(loss_cfg.get('gamma', 2.0))
    pix_loss = -alpha * torch.pow(1 - torch.exp(logp), gamma) * logp
    fg = foreground(batch['gt_boxes2d'], downsample, (Hf, Wf))
    weights = torch.where(fg, f32(loss_cfg.get('fg_weight', 13.0)),
                          f32(loss_cfg.get('bg_weight', 1.0)))
    loss = (pix_loss * weights).sum() / float(global_count(B) * Hf * Wf) * \
        f32(loss_cfg.get('weight', 3.0))
    return loss, {'ddn_loss': loss}
