"""2-D blocks of the AL range-view / BEV dual-branch family (port of
``spsnet_tpu/models/backbones_2d/al_2d.py``; reference
``backbones_2d/AL_2D.py`` and the attention and fusion blocks of
``backbones_3d/AL_3D.py``), NCHW.

Each flax module is a torch module of the same name and the same
children, so the weight bridge maps ``{parent}/{child}/kernel`` onto
``{parent}.{child}.weight``. BatchNorm at eps 1e-3 and momentum 0.01
(flax's 0.99), with flax's running-variance rule
(``blocks.BatchNormNCHW``). As in the JAX package the range U-Net pools
and upsamples the width only (the reference's ``AL_3D_V3``), and
``BasicBlock`` has no residual add (commented out in the reference).

flax's ``ConvTranspose(3, strides=s, padding='SAME')`` pads the dilated
input by (2, 1) on a stride-2 axis and (1, 1) on a stride-1 axis, and
correlates with the kernel as it is; ``SameConvTranspose2d`` computes it
as torch's transposed convolution with the kernel flipped (the bridge
flips it) and padding 0 on a stride-2 axis (1 on a stride-1 axis), then
keeps the first s * H rows and s * W columns: no choice of ``padding``
and ``output_padding`` gives that window without the crop.

The max pools of the attentions are ``amax``, whose gradient splits
evenly among tied entries, as JAX's ``max`` does (their inputs are ReLU
outputs, where all-zero rows tie).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNormNCHW
from . import projection


def _bn(channels: int) -> BatchNormNCHW:
    return BatchNormNCHW(channels, eps=1e-3, momentum=0.01)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(out, (3, 3), strides, padding='SAME')`` with a
    bias: input (B, C, H, W) -> (B, out, s_h H, s_w W). The weight is
    torch's (in, out, 3, 3), the flax kernel flipped in both axes."""

    def __init__(self, in_channels: int, out_channels: int, stride):
        stride = tuple(int(s) for s in stride)
        if not set(stride) <= {1, 2}:
            raise ValueError(f'stride {stride}: 1 or 2 on each axis')
        super().__init__(in_channels, out_channels, 3, stride=stride,
                         padding=tuple(2 - s for s in stride))

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                               self.padding)
        return y[..., :self.stride[0] * x.shape[-2],
                 :self.stride[1] * x.shape[-1]]


class BasicBlock(nn.Module):
    """Two (Conv 3 x 3, BatchNorm, ReLU) (``AL_2D.BasicBlock``)."""

    def __init__(self, in_channels: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, padding=1)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.bn2 = _bn(planes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class BasicBlockCP(nn.Module):
    """Conv (dilated) + BatchNorm + ReLU (``AL_2D.BasicBlock_CP``); the
    torch children ``conv`` and ``bn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3), dilation: int = 1, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels,
                              tuple(kernel_size), dilation=dilation,
                              padding=padding)
        self.bn = _bn(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class EncBlock(nn.Module):
    """Dilated conv trio + 1 x 1 merge + shortcut, then an average pool
    (``AL_2D.EncBlock``): 2 x 2, or 1 x 2 (width only) in the range
    view."""

    def __init__(self, input_channels: int, range_view: bool = False):
        super().__init__()
        c = input_channels
        self.conv1 = BasicBlockCP(c, c, (3, 3), 1, 1)
        self.conv2 = BasicBlockCP(c, c, (3, 3), 2, 2)
        self.conv3 = BasicBlockCP(c, c, (2, 2), 2, 1)
        self.conv4 = BasicBlockCP(3 * c, 2 * c, (1, 1), 1, 0)
        self.conv5 = BasicBlockCP(c, 2 * c, (1, 1), 1, 0)
        self.window = (1, 2) if range_view else (2, 2)

    def forward(self, x):
        o1 = self.conv1(x)
        o2 = self.conv2(o1)
        o3 = self.conv3(o2)
        out = self.conv4(torch.cat([o1, o2, o3], 1)) + self.conv5(x)
        return F.avg_pool2d(out, self.window, self.window)


class DecBlock(nn.Module):
    """Transposed-conv upsample (2 x 2, or 1 x 2 in the range view) +
    dilated trio + merge (``AL_2D.DecBlock``)."""

    def __init__(self, input_channels: int, range_view: bool = False):
        super().__init__()
        c = input_channels // 2
        self.transconv = SameConvTranspose2d(
            input_channels, c, (1, 2) if range_view else (2, 2))
        self.trans_bn = _bn(c)
        self.conv1 = BasicBlockCP(c, c, (3, 3), 1, 1)
        self.conv2 = BasicBlockCP(c, c, (3, 3), 2, 2)
        self.conv3 = BasicBlockCP(c, c, (2, 2), 2, 1)
        self.conv4 = BasicBlockCP(3 * c, c, (1, 1), 1, 0)
        self.conv5 = BasicBlockCP(c, c, (1, 1), 1, 0)

    def forward(self, x):
        up = F.relu(self.trans_bn(self.transconv(x)))
        o2 = self.conv1(up)
        o3 = self.conv2(o2)
        o4 = self.conv3(o3)
        return self.conv4(torch.cat([o2, o3, o4], 1)) + self.conv5(up)


class CPUnet(nn.Module):
    """The four-level CPGNet U-Net (``AL_2D.CP_Unet``, layers_num 4):
    (B, C, H, W) -> (out (B, output_channels, H, W), {'e1', 'e2', 'e3',
    'd0'})."""

    def __init__(self, input_channels: int, output_channels: int,
                 range_view: bool = False):
        super().__init__()
        c = input_channels
        self.pre_conv = BasicBlock(c, c)
        self.enc0 = EncBlock(c, range_view)
        self.enc1 = EncBlock(2 * c, range_view)
        self.enc2 = EncBlock(4 * c, range_view)
        self.dec0 = DecBlock(8 * c, range_view)
        self.basic0 = BasicBlock(8 * c, 4 * c)
        self.dec1 = DecBlock(4 * c, range_view)
        self.basic1 = BasicBlock(4 * c, 2 * c)
        self.dec2 = DecBlock(2 * c, range_view)
        self.basic2 = BasicBlock(2 * c, c)
        self.out_conv = nn.Conv2d(c, output_channels, 1)

    def forward(self, x):
        e0 = self.pre_conv(x)
        e1 = self.enc0(e0)
        e2 = self.enc1(e1)
        e3 = self.enc2(e2)
        d0 = self.basic0(torch.cat([e2, self.dec0(e3)], 1))
        d1 = self.basic1(torch.cat([e1, self.dec1(d0)], 1))
        d2 = self.basic2(torch.cat([e0, self.dec2(d1)], 1))
        return self.out_conv(d2), {'e1': e1, 'e2': e2, 'e3': e3, 'd0': d0}


class ChannelAttention(nn.Module):
    """Squeeze-excite over the global average and max pools
    (``AL_3D.ChannelAttention``): (B, C, H, W) -> (B, C, 1, 1)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.fc1 = nn.Linear(channels, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, channels, bias=False)

    def forward(self, x):
        avg, mx = x.mean(dim=(2, 3)), x.amax(dim=(2, 3))
        out = self.fc2(F.relu(self.fc1(avg))) + self.fc2(F.relu(self.fc1(mx)))
        return torch.sigmoid(out)[..., None, None]


class SpatialAttention(nn.Module):
    """A 7 x 7 conv over the channel mean and max maps
    (``AL_3D.SpatialAttention``): (B, C, H, W) -> (B, 1, H, W)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x):
        stat = torch.stack([x.mean(dim=1), x.amax(dim=1)], 1)
        return torch.sigmoid(self.conv(stat))


class CBAM(nn.Module):
    """Residual conv block with channel and spatial attention
    (``AL_3D.CBAM``)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.ca = ChannelAttention(planes)
        self.sa = SpatialAttention()

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = self.ca(out) * out
        out = self.sa(out) * out
        return F.relu(out + x)


class Space2Depth(nn.Module):
    """Space-to-depth by ``down_scale`` then a 1 x 1 compress, BatchNorm
    and ReLU (``AL_3D.Space2Depth``). The channel order (c, s1, s2) of the
    JAX package's rearrange is ``F.pixel_unshuffle``'s."""

    def __init__(self, in_channels: int, output_channels: int,
                 down_scale: int):
        super().__init__()
        self.down_scale = int(down_scale)
        self.compress = nn.Conv2d(in_channels * self.down_scale ** 2,
                                  output_channels, 1)
        self.bn = _bn(output_channels)

    def forward(self, x):
        if self.down_scale > 1:
            x = F.pixel_unshuffle(x, self.down_scale)
        return F.relu(self.bn(self.compress(x)))


class FusionBlock(nn.Module):
    """Range decoder + RV -> points -> BEV re-projection
    (``AL_3D.FusionBlock``): the range encoder's pyramid {'e1', 'e2',
    'e3'} decoded back to the full range width by CBAM-gated width-only
    transposed convs, gathered at the points (bilinear), scatter-maxed
    onto the BEV lattice, then space-to-depth to a quarter of the BEV
    resolution: (B, input_channels / 2, H / 4, W / 4)."""

    def __init__(self, input_channels: int, bev_shape: Sequence[int]):
        super().__init__()
        c = input_channels
        self.bev_shape = tuple(int(v) for v in bev_shape)
        self.cbam1 = CBAM(c)
        self.transconv1 = SameConvTranspose2d(c, c // 2, (1, 2))
        self.trans_bn1 = _bn(c // 2)
        self.cbam2 = CBAM(c)
        self.cbam2_conv = nn.Conv2d(c, c // 2, 3, padding=1)
        self.cbam2_bn = _bn(c // 2)
        self.transconv2 = SameConvTranspose2d(c // 2, c // 4, (1, 2))
        self.trans_bn2 = _bn(c // 4)
        self.cbam3 = CBAM(c // 2)
        self.cbam3_conv = nn.Conv2d(c // 2, c // 4, 3, padding=1)
        self.cbam3_bn = _bn(c // 4)
        self.transconv3 = SameConvTranspose2d(c // 4, c // 8, (1, 2))
        self.trans_bn3 = _bn(c // 8)
        self.sd1 = Space2Depth(c // 8, c // 4, 2)
        self.sd2 = Space2Depth(c // 4, c // 2, 2)
        self.sd3 = Space2Depth(c // 2, c // 2, 1)

    def forward(self, range_dict, range_uvk, bev_uvk):
        x = self.cbam1(range_dict['e3'])
        x = F.relu(self.trans_bn1(self.transconv1(x)))
        x = self.cbam2(torch.cat([x, range_dict['e2']], 1))
        x = F.relu(self.cbam2_bn(self.cbam2_conv(x)))
        x = F.relu(self.trans_bn2(self.transconv2(x)))
        x = self.cbam3(torch.cat([x, range_dict['e1']], 1))
        x = F.relu(self.cbam3_bn(self.cbam3_conv(x)))
        x = F.relu(self.trans_bn3(self.transconv3(x)))
        pw = projection.g2p_bilinear(x, *range_uvk)
        bev = projection.p2g_max(pw, *bev_uvk, self.bev_shape)
        return self.sd3(self.sd2(self.sd1(bev)))
