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
``torch.Generator``. Its training loss is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..models.sa_module import SAModuleMSGWithSampling
from ..models.surface_feature import FeatureExtraction


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
        ``generator`` (a CPU ``torch.Generator``, required)."""
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
            eps = torch.randn(mu.shape, generator=generator).to(mu.device)
            # the reference reparametrises with std = exp(0.5 * logvar)
            z = mu + eps * torch.exp(0.5 * logvar)
            ret['center_pred'] = self.obj_encoder(soc_feature, z)
        else:
            ret['stds'] = torch.exp(0.5 * logvar).sum(dim=-1)
        return ret
