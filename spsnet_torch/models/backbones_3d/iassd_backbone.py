"""IA-SSD encoder: SA-with-sampling chain + vote layer, dense (B, N, C).

Port of ``spsnet_tpu/models/backbones_3d/iassd_backbone.py``
(``IASSD_Backbone``, ``backbones_3d/IASSD_backbone.py``). Config keys
(``SA_CONFIG``): NPOINT_LIST, SAMPLE_RANGE_LIST, SAMPLE_METHOD_LIST,
RADIUS_LIST, NSAMPLE_LIST, MLPS, LAYER_TYPE, DILATED_GROUP,
AGGREGATION_MLPS, CONFIDENCE_MLPS, LAYER_INPUT, CTR_INDEX,
MAX_TRANSLATE_RANGE, USE_SURFACE, and SS_RADIUS_LIST / SS_NSAMPLE_LIST
(S-FPS's swap ball, the first entry of a layer's list). The layers live in
``SA_modules``, as in the reference state dict. ``fps_seeding`` (an
``ops.FpsSeeding`` or None) goes to every SA layer's D-FPS, ``msg_shared``
(off by default) to every SA layer's grouping, and the forward's
``sampling_generator`` to the Rand samplers.

The same class serves as ``PAGNet_Backbone`` (``backbones_3d/
PAGNet_backbone.py``): with ``USE_SURFACE`` a DenseEdgeConv 60-d surface
descriptor (``SF_extract``) is computed on the raw cloud, gathered along the
sampling chain of SA layers 0-3 and fed to the vote layer in front of its
features; per-point ``stds`` from the batch (SPSNet stability) are carried
through every SA layer.
"""
from __future__ import annotations

from torch import nn

from ... import ops
from ..sa_module import SAModuleMSGWithSampling, VoteLayer
from ..surface_feature import FeatureExtraction


def _layer_fps_ordered(sampled_here: bool, seeded: bool,
                       prev_ordered: bool) -> bool:
    """Whether a pure single-D-FPS layer's output is a D-FPS chain in
    selection order: yes when it ran exact FPS; a seeded run puts its seeds
    first, which is no FPS chain; a pass-through (n <= npoint) keeps its
    input's order."""
    if not sampled_here:
        return prev_ordered
    return not seeded


def _input_index(layer_input):
    return layer_input[-1] if isinstance(layer_input, list) else layer_input


class IASSDBackbone(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 fps_seeding=None, msg_shared: bool = False):
        super().__init__()
        self.fps_seeding = fps_seeding
        sa_cfg = model_cfg.SA_CONFIG
        self.SF_extract = FeatureExtraction() \
            if sa_cfg.get('USE_SURFACE', False) else None
        surface = 0 if self.SF_extract is None else \
            self.SF_extract.out_channels
        self.layer_types = list(sa_cfg.LAYER_TYPE)
        self.ctr_idx_list = list(sa_cfg.CTR_INDEX)
        self.layer_inputs = [_input_index(x) for x in sa_cfg.LAYER_INPUT]
        aggregation_mlps = sa_cfg.get('AGGREGATION_MLPS', None)
        confidence_mlps = sa_cfg.get('CONFIDENCE_MLPS', None)
        ss_radii = sa_cfg.get('SS_RADIUS_LIST', None)
        ss_nsamples = sa_cfg.get('SS_NSAMPLE_LIST', None)

        channel_out_list = [input_channels - 3]
        # dfps_static[j]: encoder_xyz[j] is configured as the output of a
        # pure single-D-FPS SA layer; whether that layer really ran FPS is
        # decided per call from the shapes (see forward)
        self.dfps_static = [False]
        self.npoint0 = []
        modules = []
        for k, layer_type in enumerate(self.layer_types):
            channel_in = channel_out_list[self.layer_inputs[k]]
            if layer_type == 'SA_Layer':
                methods = list(sa_cfg.SAMPLE_METHOD_LIST[k])
                npoints = list(sa_cfg.NPOINT_LIST[k])
                self.dfps_static.append(
                    self.ctr_idx_list[k] == -1 and methods == ['D-FPS']
                    and npoints[0] > 0)
                self.npoint0.append(int(npoints[0]) if npoints else 0)
                agg = aggregation_mlps[k] if aggregation_mlps else None
                conf = confidence_mlps[k] if confidence_mlps else None
                module = SAModuleMSGWithSampling(
                    in_channels=channel_in,
                    npoint_list=npoints,
                    sample_range_list=list(sa_cfg.SAMPLE_RANGE_LIST[k]),
                    sample_type_list=methods,
                    radii=list(sa_cfg.RADIUS_LIST[k]),
                    nsamples=list(sa_cfg.NSAMPLE_LIST[k]),
                    mlps=[list(m) for m in sa_cfg.MLPS[k]],
                    num_class=num_class,
                    dilated_group=bool(sa_cfg.DILATED_GROUP[k]),
                    aggregation_mlp=list(agg) if agg else None,
                    confidence_mlp=list(conf) if conf else None,
                    fps_seeding=fps_seeding,
                    ss_radius=(ss_radii[k][0] if ss_radii and ss_radii[k]
                               else None),
                    ss_nsample=(ss_nsamples[k][0]
                                if ss_nsamples and ss_nsamples[k] else None),
                    msg_shared=msg_shared)
            elif layer_type == 'Vote_Layer':
                self.dfps_static.append(False)
                self.npoint0.append(0)
                module = VoteLayer(channel_in, list(sa_cfg.MLPS[k]),
                                   sa_cfg.get('MAX_TRANSLATE_RANGE', None),
                                   surface_channels=surface)
            else:
                raise NotImplementedError(layer_type)
            channel_out_list.append(module.out_channels)
            modules.append(module)
        self.SA_modules = nn.ModuleList(modules)
        self.num_point_features = channel_out_list[-1]

    def forward(self, batch, sampling_generator=None):
        """
        Args:
            batch: dict with 'points' (B, N, 3 + C) [x, y, z, feat...] and
                optionally 'stds' (B, N) from the stability model (SPSNet).
            sampling_generator: a CPU ``torch.Generator`` for the Rand
                samplers, or None.
        Returns: ``batch`` updated with centers / centers_origin /
            ctr_offsets (B, M, 3), centers_features (B, M, C), encoder_xyz,
            encoder_features and sa_ins_preds (lists, one entry per layer).
        """
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None
        stds = batch.get('stds', None)

        encoder_xyz, encoder_features, sa_ins_preds = [xyz], [features], []
        li_cls_pred = None
        centers = centers_origin = ctr_offsets = surface = None
        fps_ordered = [False]
        for i, module in enumerate(self.SA_modules):
            in_idx = self.layer_inputs[i]
            xyz_input = encoder_xyz[in_idx]
            feat_input = encoder_features[in_idx]
            if self.layer_types[i] == 'SA_Layer':
                ctr_xyz = (encoder_xyz[self.ctr_idx_list[i]]
                           if self.ctr_idx_list[i] != -1 else None)
                if self.dfps_static[i + 1] and ctr_xyz is None:
                    fps_ordered.append(_layer_fps_ordered(
                        xyz_input.shape[1] > self.npoint0[i],
                        ops.fps_seeding_active(self.fps_seeding,
                                               self.npoint0[i],
                                               allow_seed=True),
                        fps_ordered[in_idx]))
                else:
                    fps_ordered.append(False)
                li_xyz, li_features, li_cls_pred, sampled_idx, stds = module(
                    xyz_input, feat_input, li_cls_pred, ctr_xyz=ctr_xyz,
                    stds=stds, input_fps_ordered=fps_ordered[in_idx],
                    sampling_generator=sampling_generator)
                if self.SF_extract is not None and i <= 3:
                    if i == 0:
                        surface = self.SF_extract(xyz)
                    surface = ops.gather_points(surface, sampled_idx)
            else:
                fps_ordered.append(False)
                li_xyz, li_features, centers_origin, ctr_offsets = module(
                    xyz_input, feat_input, surface_features=surface)
                centers = li_xyz
                li_cls_pred = None
            encoder_xyz.append(li_xyz)
            encoder_features.append(li_features)
            sa_ins_preds.append(li_cls_pred)

        batch = dict(batch)
        batch['ctr_offsets'] = ctr_offsets
        batch['centers'] = centers
        batch['centers_origin'] = centers_origin
        batch['centers_features'] = encoder_features[-1]
        batch['encoder_xyz'] = encoder_xyz
        batch['sa_ins_preds'] = sa_ins_preds
        batch['encoder_features'] = encoder_features
        return batch
