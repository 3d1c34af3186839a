"""SPSNet's stability (point-uncertainty) model, the CVAE ``GenerateCenter``.

Port of ``spsnet_tpu/stability/model.py:34-109`` (reference
``stability_generate/model.py``):

- ``surface_pw_feature``: one D-FPS SA layer, MSG radii [0.2, 0.8] and a
  64-wide aggregation -> a per-point feature. SPSNet.yaml runs it at
  npoint == N, where the layer takes every point in order (no FPS);
- ``EncoderSurfaceFeature``: two Linears -> (mu, logvar) of a latent
  Gaussian per point;
- ``ObjectFeatEncoder``: concat(feature, z) -> MLP -> a 3-d center offset.

In eval mode the forward gives ``stds = sum_dim exp(0.5 * logvar)``, the
per-point stability that the SPSNet samplers and the delete hook read; in
training it gives ``center_pred`` from a latent drawn with an explicit
``torch.Generator``, and ``generate_center_loss`` (``model.py:112-168``;
reference ``model.py:454-508``) is its training loss.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops, parallel
from ..models.dense_heads import target_assign
from ..models.sa_module import SAModuleMSGWithSampling
from ..models.surface_feature import FeatureExtraction
from ..utils import box_utils, loss_utils

# added to the latent scale, as the reference does
_SCALE_EPS = 3e-22


class EncoderSurfaceFeature(nn.Module):

    def __init__(self, in_channels: int, latent_size: int = 8):
        super().__init__()
        self.fc_mu = nn.Linear(in_channels, latent_size)
        self.fc_logvar = nn.Linear(in_channels, latent_size)

    def forward(self, features):
        return self.fc_mu(features), self.fc_logvar(features)


class ObjectFeatEncoder(nn.Module):
    """fc(C + latent -> 64) relu -> fc(64) relu -> fc(64) relu -> fc(3),
    the last without a bias."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc_ce1 = nn.Linear(64, 64)
        self.fc_ce2 = nn.Linear(64, 3, bias=False)

    def forward(self, x, z):
        h = torch.relu(self.fc1(torch.cat([x, z], dim=-1)))
        h = torch.relu(self.fc2(h))
        return self.fc_ce2(torch.relu(self.fc_ce1(h)))


class GenerateCenter(nn.Module):
    """``model_cfg``: ``STABILITY_HOOK.MODEL`` of SPSNet.yaml (SA_CONFIG with
    one SA layer, LATENT_DIM, optionally USE_SURFACE for the model_V3
    variant that puts the DenseEdgeConv surface features in front of the
    SA feature)."""

    def __init__(self, model_cfg, input_channels: int = 4):
        super().__init__()
        sa = model_cfg.SA_CONFIG
        agg = sa.get('AGGREGATION_MLPS', None)
        self.surface_pw_feature = SAModuleMSGWithSampling(
            in_channels=input_channels - 3,
            npoint_list=list(sa.NPOINT_LIST[0]),
            sample_range_list=list(sa.SAMPLE_RANGE_LIST[0]),
            sample_type_list=list(sa.SAMPLE_METHOD_LIST[0]),
            radii=list(sa.RADIUS_LIST[0]),
            nsamples=list(sa.NSAMPLE_LIST[0]),
            mlps=[list(m) for m in sa.MLPS[0]],
            num_class=1,
            aggregation_mlp=list(agg[0]) if agg else None)
        self.sf_extract = FeatureExtraction() \
            if model_cfg.get('USE_SURFACE', False) else None
        width = self.surface_pw_feature.out_channels
        if self.sf_extract is not None:
            width += self.sf_extract.out_channels
        latent = int(model_cfg.LATENT_DIM)
        self.feature_encoder = EncoderSurfaceFeature(width, latent)
        self.obj_encoder = ObjectFeatEncoder(width + latent)

    def forward(self, batch, generator: torch.Generator | None = None):
        """batch: dict with 'points' (B, N, 3 + C). Returns a dict with
        soc_feature, mu, logvar, layer_xyz and, in eval mode, 'stds' (B, M);
        in training 'center_pred' (B, M, 3), its latent drawn from
        ``generator`` (a CPU ``torch.Generator``, required; in a
        data-parallel step this rank's rows of the joined batch's draw,
        ``parallel.draw_rows``)."""
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None
        new_xyz, soc_feature, _, sampled_idx, _ = self.surface_pw_feature(
            xyz, features)
        if self.sf_extract is not None:
            sf = ops.gather_points(self.sf_extract(xyz), sampled_idx)
            soc_feature = torch.cat([sf, soc_feature], dim=-1)
        mu, logvar = self.feature_encoder(soc_feature)
        ret = {'soc_feature': soc_feature, 'mu': mu, 'logvar': logvar,
               'layer_xyz': new_xyz}
        if self.training:
            if generator is None:
                raise ValueError('the training forward draws its latent from '
                                 'an explicit torch.Generator')
            eps = parallel.draw_rows(
                lambda shape, g: torch.randn(shape, generator=g), mu.shape,
                generator).to(mu.device)
            # the reference reparametrises with std = exp(0.5 * logvar)
            z = mu + eps * torch.exp(0.5 * logvar)
            ret['center_pred'] = self.obj_encoder(soc_feature, z)
        else:
            ret['stds'] = torch.exp(0.5 * logvar).sum(dim=-1)
        return ret


def assign_stability_targets(layer_xyz, gt_boxes):
    """The foreground of the layer's points and their offsets to the
    centre of their box (``model.py:363-370, 392-407``): gt boxes (B, T, 8
    or 10; a 10-column box drops its two velocity columns) enlarged by 0.5
    give the ignore ring. Returns (fg_mask (B, M) bool, offsets (B, M, 3))."""
    if gt_boxes.shape[-1] == 10:
        gt_boxes = torch.cat([gt_boxes[..., 0:7], gt_boxes[..., -1:]], dim=-1)
    ext = box_utils.enlarge_box3d(gt_boxes, [0.5, 0.5, 0.5])
    t = target_assign.assign_targets_iassd(
        layer_xyz.detach(), gt_boxes, ext, set_ignore_flag=True, num_class=3)
    return t.fg_mask, layer_xyz - t.gt_box_of_points[..., 0:3]


def params_l2_norm_sum(model: nn.Module):
    """The sum over ``model``'s parameter tensors of their L2 norms, not
    squared (``l2_regularisation``, ``model.py:24-32``); the 1e-12 keeps
    the gradient of an all-zero tensor finite. BatchNorm's running
    statistics are buffers and stay out, as flax keeps them out of
    ``params``."""
    return sum(torch.sqrt((p * p).sum() + 1e-12) for p in model.parameters())


def _kl_diag_normal(mu1, sigma1, mu2, sigma2):
    """KL(N(mu1, sigma1^2) || N(mu2, sigma2^2)) summed over the last dim."""
    return (torch.log(sigma2 / sigma1)
            + (sigma1 ** 2 + (mu1 - mu2) ** 2) / (2.0 * sigma2 ** 2)
            - 0.5).sum(dim=-1)


def generate_center_loss(model, ret, gt_boxes, code_weights=None):
    """The stability model's training loss of a training forward ``ret`` of
    ``model`` against (B, T, 8 or 10) ``gt_boxes``: smooth-L1 of
    ``center_pred`` against the foreground offsets, 5e-4 times
    ``params_l2_norm_sum``, and 5e-2 times two KL terms of the latent
    N(mu, sigma) with sigma = exp(logvar) (the reference's scale, not
    exp(logvar / 2)): from N(0, 1) on the foreground and from N(mu, 20) on
    the background, each a mean over its points. Returns (loss, tb) with
    the JAX package's tb keys.

    In a data-parallel step the counts are the joined batch's
    (``parallel.global_sum``) and the parameter term, which is no batch
    term, is ``1 / world`` of itself on each rank: the ranks' shares (and
    DDP's mean of their gradients times the world) then count it once, as
    the JAX package's one program over the mesh does
    (``spsnet_tpu/stability/model.py:143-168``)."""
    fg_mask, gt_offsets = assign_stability_targets(ret['layer_xyz'], gt_boxes)
    fg = fg_mask.to(torch.float32)
    pos_norm = parallel.global_sum(fg.sum()).clamp(min=1.0)
    reg = loss_utils.weighted_smooth_l1(
        ret['center_pred'], gt_offsets.detach(), weights=fg / pos_norm,
        code_weights=code_weights).sum()
    l2 = 5e-4 * params_l2_norm_sum(model)
    if parallel.step_world() > 1:
        l2 = l2 / parallel.step_world()
    mu = ret['mu']
    sigma = torch.exp(ret['logvar']) + _SCALE_EPS
    kl_fg_all = _kl_diag_normal(torch.zeros_like(mu), torch.ones_like(sigma),
                                mu, sigma)
    kl_fg = 5e-2 * (kl_fg_all * fg).sum() / pos_norm
    bg = 1.0 - fg
    kl_bg_all = _kl_diag_normal(mu, torch.full_like(sigma, 20.0), mu, sigma)
    kl_bg = 5e-2 * (kl_bg_all * bg).sum() / \
        parallel.global_sum(bg.sum()).clamp(min=1.0)
    loss = reg + l2 + kl_fg + kl_bg
    return loss, {'center_loss_box': reg, 'l2_reg': l2, 'lattent_loss': kl_fg,
                  'lattent_loss2': kl_bg, 'loss': loss}
