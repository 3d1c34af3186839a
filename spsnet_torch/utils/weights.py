"""Weight bridge: the JAX package's flax variables -> the port's state dict.

The port's parameter names are the reference torch names, which the JAX
package's checkpoint importer maps the other way
(``spsnet_tpu/utils/checkpoint_import.py:29-37``):

    flax path                                      torch name
    backbone_3d/sa_{i}/mlp_{s}/Dense_{k}/kernel    backbone_3d.SA_modules.{i}.mlps.{s}.{3k}.weight
    .../BatchNorm_{k}/{scale,bias}, {mean,var}     ....{3k+1}.{weight,bias}, {running_mean,running_var}
    backbone_3d/sa_{i}/aggregation/...             backbone_3d.SA_modules.{i}.aggregation_layer.*
    backbone_3d/sa_{i}/confidence/SharedMLP_0/...  backbone_3d.SA_modules.{i}.confidence_layers.{3k,3k+1}
    backbone_3d/sa_{i}/confidence/Dense_0/*        ....confidence_layers.{3h}.* (h hidden layers)
    backbone_3d/vote_{i}/mlp/...                   backbone_3d.SA_modules.{i}.mlp_modules.*
    backbone_3d/vote_{i}/ctr_reg/*                 backbone_3d.SA_modules.{i}.ctr_reg.*
    point_head/{cls_center,box_center,box_iou3d}/  point_head.{cls_center,box_center,box_iou3d}_layers.*
    point_head/{cls_layers,box_layers}/            point_head.{cls_layers,box_layers}.* (PointHeadBox)
    backbone_3d/fp_{i}/mlp/...                     backbone_3d.FP_modules.{i}.mlp.*
    roi_head/xyz_up/Dense_{k}, roi_head/merge/...  roi_head.{xyz_up_layer,merge_down_layer}.{2k} (no BN)
    roi_head/sa_{i}/mlp_0/...                      roi_head.SA_modules.{i}.mlps.0.*
    roi_head/{cls_layers,reg_layers}/...           roi_head.{cls_layers,reg_layers}.* (a Dropout
                                                     after the first block shifts later indices by 1)
    backbone_3d/sf_extract/transform_{i}/Dense_0   backbone_3d.SF_extract.transforms.{i}.linear
    backbone_3d/sf_extract/conv_{i}/layer_first    backbone_3d.SF_extract.convs.{i}.layer_first.linear
      .../layer_{j}, .../layer_last (/Dense_0)       ....convs.{i}.layers.{j-1}.linear, ....layer_last.linear

(the surface DGCNN's names as ``checkpoint_import.py:255-280`` maps them).
The stability model ``GenerateCenter`` has its own tree, mapped by
``generator_flax_to_torch``:

    surface_pw_feature/{mlp_{s},aggregation}/...   surface_pw_feature.{mlps.{s},aggregation_layer}.*
    feature_encoder/{fc_mu,fc_logvar}              feature_encoder.{fc_mu,fc_logvar}
    obj_encoder/{fc1,fc2,fc_ce1,fc_ce2}            obj_encoder.{fc1,fc2,fc_ce1,fc_ce2}
    sf_extract/...                                 sf_extract.* (as SF_extract above)

The voxel detectors (SECOND, PV-RCNN) add:

    backbone_3d/{conv_input,conv1,conv2_down,...,conv_out}/{Dense_0,BatchNorm_0}
                                                   backbone_3d.{name}.{0,1} (sparse conv)
    backbone_2d/block{i}_down, block{i}_down_bn    backbone_2d.blocks.{i}.{1,2}
    backbone_2d/block{i}_conv{j}, block{i}_bn{j}   backbone_2d.blocks.{i}.{4+3j,5+3j}
    backbone_2d/deblock{i}, deblock{i}_bn          backbone_2d.deblocks.{i}.{0,1}
    dense_head/{conv_cls,conv_box,conv_dir_cls}    dense_head.{conv_cls,conv_box,conv_dir_cls}
    pfe/raw_mlp_{s}/...                            pfe.SA_rawpoints.mlps.{s}.*
    pfe/x_conv{n}_mlp_{s}/...                      pfe.SA_layers.x_conv{n}.mlps.{s}.*
    pfe/vsa_point_feature_fusion/...               pfe.vsa_point_feature_fusion.*
    point_head/cls_layers/...                      point_head.cls_layers.* (PointHeadSimple)
    roi_head/pool_mlp_{s}/...                      roi_head.roi_grid_pool_layer.mlps.{s}.*
    roi_head/shared_fc/{Dense_k,BatchNorm_k}       roi_head.shared_fc_layer.{4k,4k+1} (a Dropout
                                                     after each layer but the last)

A Dense kernel (in, out) becomes a Linear weight (out, in); a Conv kernel
(kh, kw, in, out) a Conv2d weight (out, in, kh, kw). A flax ConvTranspose
kernel (kh, kw, in, out) becomes a ConvTranspose2d weight (in, out, kh, kw)
flipped in both spatial axes: with kernel = stride, flax sends input i to
output s * i + r through tap s - 1 - r, torch through tap r. A SharedMLP
without BatchNorm (no ``BatchNorm_k`` beside its ``Dense_k``) has its
Linear at 2k.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_HEADS = {'cls_center': 'cls_center_layers', 'box_center': 'box_center_layers',
          'box_iou3d': 'box_iou3d_layers', 'cls_layers': 'cls_layers',
          'box_layers': 'box_layers'}
# (collection, leaf) -> torch leaf, for a Dense and a BatchNorm module
_DENSE_LEAF = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias'}
_BN_LEAF = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
            ('batch_stats', 'mean'): 'running_mean',
            ('batch_stats', 'var'): 'running_var'}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _seq_index(layer: str, bn: bool = True, shift: int = 0) -> int:
    """Sequential index of a SharedMLP layer: Dense_k -> 3k, BatchNorm_k
    -> 3k+1 (ReLU at 3k+2 holds no weights); Dense_k -> 2k without
    BatchNorm; plus ``shift`` from layer 1 on (a Dropout after layer 0)."""
    m = re.fullmatch(r'(Dense|BatchNorm)_(\d+)', layer)
    if m is None:
        raise KeyError(layer)
    k = int(m.group(2))
    return (3 if bn else 2) * k + (m.group(1) == 'BatchNorm') + \
        (shift if k >= 1 else 0)


def _head_index(head, rest, hidden, shift: int = 0) -> int:
    """Index in an MLPHead: its SharedMLP_0 layers, then the output Dense_0
    at 3h for h hidden layers (plus ``shift`` after a Dropout behind the
    first)."""
    h = hidden.get(head, 0)
    if len(rest) == 2 and rest[0] == 'SharedMLP_0':
        return _seq_index(rest[1], shift=shift)
    if rest == ('Dense_0',):
        return 3 * h + (shift if h >= 1 else 0)
    raise KeyError(rest)


def _sa_name(base, module, rest, hidden) -> str:
    """Torch name of a module inside an SA layer (``rest`` below it)."""
    mm = re.fullmatch(r'mlp_(\d+)', rest[0])
    if mm and len(rest) == 2:
        return f'{base}.mlps.{mm.group(1)}.{_seq_index(rest[1])}'
    if rest[0] == 'aggregation' and len(rest) == 2:
        return f'{base}.aggregation_layer.{_seq_index(rest[1])}'
    if rest[0] == 'confidence':
        head = module[:len(module) - len(rest) + 1]
        return f'{base}.confidence_layers.{_head_index(head, rest[1:], hidden)}'
    raise KeyError(module)


def _surface_name(base, module, rest) -> str:
    """Torch name of a Dense of the surface DGCNN (``rest`` below it)."""
    if rest[-1:] != ('Dense_0',):
        raise KeyError(module)
    m = re.fullmatch(r'transform_(\d+)', rest[0])
    if m and len(rest) == 2:
        return f'{base}.transforms.{m.group(1)}.linear'
    m = re.fullmatch(r'conv_(\d+)', rest[0])
    if m and len(rest) == 3:
        sub = rest[1]
        layer = re.fullmatch(r'layer_(\d+)', sub)
        if layer:
            sub = f'layers.{int(layer.group(1)) - 1}'
        elif sub not in ('layer_first', 'layer_last'):
            raise KeyError(module)
        return f'{base}.convs.{m.group(1)}.{sub}.linear'
    raise KeyError(module)


def _backbone_name(module, hidden) -> str:
    if module[1] == 'sf_extract':
        return _surface_name('backbone_3d.SF_extract', module, module[2:])
    m = re.fullmatch(r'(sa|vote|fp)_(\d+)', module[1])
    if m is None:
        raise KeyError(module)
    rest = module[2:]
    if m.group(1) == 'fp':
        if len(rest) == 2 and rest[0] == 'mlp':
            return (f'backbone_3d.FP_modules.{m.group(2)}.mlp.'
                    f'{_seq_index(rest[1])}')
        raise KeyError(module)
    base = f'backbone_3d.SA_modules.{m.group(2)}'
    if m.group(1) == 'sa':
        return _sa_name(base, module, rest, hidden)
    if rest == ('ctr_reg',):
        return f'{base}.ctr_reg'
    if len(rest) == 2 and rest[0] == 'mlp':
        return f'{base}.mlp_modules.{_seq_index(rest[1])}'
    raise KeyError(module)


def _roi_head_name(module, hidden, bn_paths) -> str:
    """Torch name prefix of a flax module path of the PointRCNN or the
    PV-RCNN head."""
    rest = module[1:]
    m = re.fullmatch(r'pool_mlp_(\d+)', rest[0])
    if m and len(rest) == 2:
        return (f'roi_head.roi_grid_pool_layer.mlps.{m.group(1)}.'
                f'{_seq_index(rest[1])}')
    if rest[0] == 'shared_fc' and len(rest) == 2:
        k = int(rest[1].split('_')[-1])
        return f'roi_head.shared_fc_layer.{_seq_index(rest[1]) + k}'
    if len(rest) == 2 and rest[0] in ('xyz_up', 'merge'):
        sub = 'xyz_up_layer' if rest[0] == 'xyz_up' else 'merge_down_layer'
        return (f'roi_head.{sub}.'
                f'{_seq_index(rest[1], module[:2] in bn_paths)}')
    m = re.fullmatch(r'sa_(\d+)', rest[0])
    if m and len(rest) == 3 and rest[1] == 'mlp_0':
        return f'roi_head.SA_modules.{m.group(1)}.mlps.0.{_seq_index(rest[2])}'
    if rest[0] in ('cls_layers', 'reg_layers'):
        idx = _head_index(module[:2], rest[1:], hidden, shift=1)
        return f'roi_head.{rest[0]}.{idx}'
    raise KeyError(module)


_SPARSE_CONV = re.compile(r'conv(_input|_out|\d(_down|_a|_b)?)')
_BEV_LAYER = re.compile(r'(de)?block(\d+)(_down|_conv(\d+))?(_bn(\d*))?')


def _bev_name(layer) -> str:
    """Torch name of a BaseBEVBackbone layer: ``blocks.{i}`` is ZeroPad,
    Conv, BN, ReLU, then (Conv, BN, ReLU) per layer; ``deblocks.{i}``
    ConvTranspose, BN, ReLU."""
    m = _BEV_LAYER.fullmatch(layer)
    if m is None:
        raise KeyError(layer)
    deblock, i, kind, conv_j, bn, bn_j = m.groups()
    if deblock:
        if kind:
            raise KeyError(layer)
        return f'backbone_2d.deblocks.{i}.{1 if bn else 0}'
    if kind == '_down':
        if bn_j:
            raise KeyError(layer)
        return f'backbone_2d.blocks.{i}.{2 if bn else 1}'
    if kind is None and bn and bn_j:
        return f'backbone_2d.blocks.{i}.{5 + 3 * int(bn_j)}'
    if conv_j is not None and not bn:
        return f'backbone_2d.blocks.{i}.{4 + 3 * int(conv_j)}'
    raise KeyError(layer)


def _voxel_name(module) -> str:
    """Torch name prefix of a flax module of the voxel detectors' own
    blocks (raises ``KeyError`` for any other)."""
    top, rest = module[0], module[1:]
    if top == 'backbone_3d' and len(rest) == 2 and \
            _SPARSE_CONV.fullmatch(rest[0]):
        return f'backbone_3d.{rest[0]}.{_seq_index(rest[1])}'
    if top == 'backbone_2d' and len(rest) == 1:
        return _bev_name(rest[0])
    if top == 'dense_head' and rest in (('conv_cls',), ('conv_box',),
                                        ('conv_dir_cls',)):
        return f'dense_head.{rest[0]}'
    if top == 'pfe' and len(rest) == 2:
        m = re.fullmatch(r'(raw|x_conv\d)_mlp_(\d+)', rest[0])
        if m:
            group = 'SA_rawpoints' if m.group(1) == 'raw' else \
                f'SA_layers.{m.group(1)}'
            return f'pfe.{group}.mlps.{m.group(2)}.{_seq_index(rest[1])}'
        if rest[0] == 'vsa_point_feature_fusion':
            return f'pfe.vsa_point_feature_fusion.{_seq_index(rest[1])}'
    raise KeyError(module)


def _torch_name(module, hidden, bn_paths) -> str:
    """Torch name prefix of a flax module path of the detector."""
    if module[0] in ('backbone_2d', 'dense_head', 'pfe') or (
            module[0] == 'backbone_3d' and len(module) == 3 and
            _SPARSE_CONV.fullmatch(module[1])):
        return _voxel_name(module)
    if module[0] == 'point_head' and len(module) > 2 and module[1] in _HEADS:
        idx = _head_index(module[:2], module[2:], hidden)
        return f'point_head.{_HEADS[module[1]]}.{idx}'
    if module[0] == 'backbone_3d' and len(module) >= 3:
        return _backbone_name(module, hidden)
    if module[0] == 'roi_head' and len(module) >= 3:
        return _roi_head_name(module, hidden, bn_paths)
    raise KeyError(module)


def _generator_name(module, hidden, bn_paths) -> str:
    """Torch name prefix of a flax module path of ``GenerateCenter``."""
    rest = module[1:]
    if module[0] == 'surface_pw_feature' and rest:
        return _sa_name('surface_pw_feature', module, rest, hidden)
    if module[0] == 'sf_extract' and rest:
        return _surface_name('sf_extract', module, rest)
    if (module[0] == 'feature_encoder' and rest in (('fc_mu',),
                                                     ('fc_logvar',))) or \
            (module[0] == 'obj_encoder' and rest in (
                ('fc1',), ('fc2',), ('fc_ce1',), ('fc_ce2',))):
        return f'{module[0]}.{rest[0]}'
    raise KeyError(module)


def _n_hidden(params) -> dict:
    """Hidden-layer count of every MLPHead, keyed by its module path."""
    counts = {}
    for path, _ in _leaves(params):
        if 'SharedMLP_0' in path:
            head = path[:path.index('SharedMLP_0')]
            layer = path[path.index('SharedMLP_0') + 1]
            if layer.startswith('Dense_'):
                counts.setdefault(head, set()).add(layer)
    return {k: len(v) for k, v in counts.items()}


def _is_bn(module_name: str) -> bool:
    """A flax BatchNorm: ``BatchNorm_k`` in a SharedMLP or a sparse conv,
    ``..._bn`` / ``block{i}_bn{j}`` in the BEV backbone."""
    return module_name.startswith('BatchNorm') or \
        re.fullmatch(r'\w+_bn\d*', module_name) is not None


def _kernel_to_torch(arr, name):
    """A Dense, Conv or ConvTranspose kernel in torch's layout."""
    if arr.ndim == 2:
        return arr.T
    if '.deblocks.' in name:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1).copy()
    return arr.transpose(3, 2, 0, 1).copy()


def _convert(variables, name_of) -> "OrderedDict[str, torch.Tensor]":
    unknown = set(variables) - {'params', 'batch_stats'}
    if unknown:
        raise KeyError(f'unmapped flax collections: {sorted(unknown)}')
    hidden = _n_hidden(variables['params'])
    bn_paths = {path[:-2] for path, _ in _leaves(variables['params'])
                if path[-2].startswith('BatchNorm_')}
    sd = OrderedDict()
    for coll in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(coll, {})):
            module, leaf = path[:-1], path[-1]
            is_bn = bool(module) and _is_bn(module[-1])
            leaf_map = _BN_LEAF if is_bn else _DENSE_LEAF
            where = f'{coll}/{"/".join(path)}'
            if (coll, leaf) not in leaf_map:
                raise KeyError(f'unmapped flax leaf: {where}')
            try:
                name = (f'{name_of(module, hidden, bn_paths)}.'
                        f'{leaf_map[coll, leaf]}')
            except (KeyError, IndexError) as e:
                raise KeyError(f'unmapped flax leaf: {where}') from e
            if name in sd:
                raise KeyError(f'flax leaf {where} maps onto {name} twice')
            arr = np.asarray(value, dtype=np.float32)
            if leaf == 'kernel':
                arr = _kernel_to_torch(arr, name)
            sd[name] = torch.tensor(arr)
            if is_bn and leaf == 'scale':
                sd[name.replace('.weight', '.num_batches_tracked')] = \
                    torch.tensor(0)
    return sd


def flax_to_torch(variables) -> "OrderedDict[str, torch.Tensor]":
    """A detector's ``{'params', 'batch_stats'}`` flax trees
    (numpy-convertible leaves) -> the port's state dict, with
    ``num_batches_tracked`` = 0 for every BatchNorm. Raises ``KeyError`` on
    a flax leaf it cannot map."""
    return _convert(variables, _torch_name)


def generator_flax_to_torch(variables) -> "OrderedDict[str, torch.Tensor]":
    """``flax_to_torch`` for the variables of the stability model
    ``GenerateCenter`` (``stability/model.py``)."""
    return _convert(variables, _generator_name)


def load_flax(model: torch.nn.Module, variables,
              convert=flax_to_torch) -> torch.nn.Module:
    """Load flax variables into ``model`` (a detector; pass ``convert=
    generator_flax_to_torch`` for a ``GenerateCenter``); raises on any key
    left unmapped on either side or on a shape mismatch (``strict`` load)."""
    model.load_state_dict(convert(variables), strict=True)
    return model
