"""IA-SSD encoder: SA-with-sampling chain + vote layer, dense (B, N, C).

Port of ``spsnet_tpu/models/backbones_3d/iassd_backbone.py``
(``IASSD_Backbone``, ``backbones_3d/IASSD_backbone.py``). Config keys
(``SA_CONFIG``): NPOINT_LIST, SAMPLE_RANGE_LIST, SAMPLE_METHOD_LIST,
RADIUS_LIST, NSAMPLE_LIST, MLPS, LAYER_TYPE, DILATED_GROUP,
AGGREGATION_MLPS, CONFIDENCE_MLPS, LAYER_INPUT, CTR_INDEX,
MAX_TRANSLATE_RANGE. The layers live in ``SA_modules``, as in the reference
state dict.
"""
from __future__ import annotations

from torch import nn

from ..sa_module import SAModuleMSGWithSampling, VoteLayer


def _layer_fps_ordered(sampled_here: bool, prev_ordered: bool) -> bool:
    """Whether a pure single-D-FPS layer's output is a D-FPS chain in
    selection order: yes when it ran (exact) FPS; a pass-through
    (n <= npoint) keeps its input's order."""
    return True if sampled_here else prev_ordered


def _input_index(layer_input):
    return layer_input[-1] if isinstance(layer_input, list) else layer_input


class IASSDBackbone(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        sa_cfg = model_cfg.SA_CONFIG
        if sa_cfg.get('USE_SURFACE', False):
            raise NotImplementedError(
                'USE_SURFACE (PAGNet surface features): ROADMAP Queue 1 item 6')
        self.layer_types = list(sa_cfg.LAYER_TYPE)
        self.ctr_idx_list = list(sa_cfg.CTR_INDEX)
        self.layer_inputs = [_input_index(x) for x in sa_cfg.LAYER_INPUT]
        aggregation_mlps = sa_cfg.get('AGGREGATION_MLPS', None)
        confidence_mlps = sa_cfg.get('CONFIDENCE_MLPS', None)

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
                    confidence_mlp=list(conf) if conf else None)
            elif layer_type == 'Vote_Layer':
                self.dfps_static.append(False)
                self.npoint0.append(0)
                module = VoteLayer(channel_in, list(sa_cfg.MLPS[k]),
                                   sa_cfg.get('MAX_TRANSLATE_RANGE', None))
            else:
                raise NotImplementedError(layer_type)
            channel_out_list.append(module.out_channels)
            modules.append(module)
        self.SA_modules = nn.ModuleList(modules)
        self.num_point_features = channel_out_list[-1]

    def forward(self, batch):
        """
        Args:
            batch: dict with 'points' (B, N, 3 + C) [x, y, z, feat...].
        Returns: ``batch`` updated with centers / centers_origin /
            ctr_offsets (B, M, 3), centers_features (B, M, C), encoder_xyz,
            encoder_features and sa_ins_preds (lists, one entry per layer).
        """
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None

        encoder_xyz, encoder_features, sa_ins_preds = [xyz], [features], []
        li_cls_pred = None
        centers = centers_origin = ctr_offsets = None
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
                        fps_ordered[in_idx]))
                else:
                    fps_ordered.append(False)
                li_xyz, li_features, li_cls_pred, _ = module(
                    xyz_input, feat_input, li_cls_pred, ctr_xyz=ctr_xyz,
                    input_fps_ordered=fps_ordered[in_idx])
            else:
                fps_ordered.append(False)
                li_xyz, li_features, centers_origin, ctr_offsets = module(
                    xyz_input, feat_input)
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
