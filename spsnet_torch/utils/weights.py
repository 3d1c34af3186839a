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

Voxel R-CNN and CenterPoint add:

    backbone_3d/res{i}_{a,b}/conv{j}/...           backbone_3d.res{i}_{a,b}.conv{j}.{0,1} (residual block)
    roi_head/x_conv{n}_{in,pos,out}_{s}/...        roi_head.roi_grid_pool_layers.x_conv{n}.mlps_{in,pos,out}.{s}.{0,1}
    roi_head/{cls_layers,reg_layers}/...           as PV-RCNN's, but a Dropout after each hidden
                                                     layer but the last (the Voxel R-CNN tree is the
                                                     one whose roi_head holds x_conv{n}_in_{s})
    dense_head/shared_conv, shared_bn              dense_head.shared_conv.{0,1}
    dense_head/head_{g}/{name}_conv{k}, _bn{k}     dense_head.heads_list.{g}.{name}.{k}.{0,1}
    dense_head/head_{g}/{name}_out                 dense_head.heads_list.{g}.{name}.{K} (K convs before it)

The pillar detectors (PointPillar, CenterPoint over pillars) add:

    vfe/pfn_{i}/Dense_0, vfe/pfn_{i}/BatchNorm_0   vfe.pfn_layers.{i}.{linear,norm} (PillarVFE)
    vfe/pfn{i}_fc, vfe/pfn{i}_bn                   vfe.pfn_layers.{i}.{linear,norm} (DynamicPillarVFE)

PV-RCNN++ adds (the plain CenterHead; VectorPool aggregation, ``src`` one
of raw_vp, x_conv{n}_vp and roi_head's vp_pool):

    dense_head/{shared,hm,center,center_z,dim,rot} dense_head.{same name}
    pfe/raw_vp/..., pfe/x_conv{n}_vp/...           pfe.SA_rawpoints.*, pfe.SA_layers.x_conv{n}.*
    roi_head/vp_pool/...                           roi_head.roi_grid_pool_layer.*
    {src}/layer_{k}/grouped_kernel                 ....layers.{k}.grouped_kernel (G, C_in, co) as is
    {src}/layer_{k}/agg_bn                         ....layers.{k}.agg_bn
    {src}/layer_{k}/{post_i, post_bn_i}            ....layers.{k}.post_mlps.{3i, 3i+1}
    {src}/{msg_post_i, msg_post_bn_i}              ....msg_post_mlps.{3i, 3i+1}

A Dense kernel (in, out) becomes a Linear weight (out, in); a Conv kernel
(kh, kw, in, out) a Conv2d weight (out, in, kh, kw). A flax ConvTranspose
kernel (kh, kw, in, out) becomes a ConvTranspose2d weight (in, out, kh, kw)
flipped in both spatial axes: with kernel = stride, flax sends input i to
output s * i + r through tap s - 1 - r, torch through tap r; a deblock
that is a strided Conv (an UPSAMPLE_STRIDE below 1) maps as a Conv. A
SharedMLP without BatchNorm (no ``BatchNorm_k`` beside its ``Dense_k``)
has its Linear at 2k.
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
_DENSE_LEAF = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
               ('params', 'grouped_kernel'): 'grouped_kernel'}
_BN_LEAF = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
            ('batch_stats', 'mean'): 'running_mean',
            ('batch_stats', 'var'): 'running_var'}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _seq_index(layer: str, bn: bool = True, shift: int = 0,
               each: bool = False) -> int:
    """Sequential index of a SharedMLP layer: Dense_k -> 3k, BatchNorm_k
    -> 3k+1 (ReLU at 3k+2 holds no weights); Dense_k -> 2k without
    BatchNorm; plus ``shift`` from layer 1 on (a Dropout after layer 0), or
    with ``each`` plus k (a Dropout after each layer before k)."""
    m = re.fullmatch(r'(Dense|BatchNorm)_(\d+)', layer)
    if m is None:
        raise KeyError(layer)
    k = int(m.group(2))
    return (3 if bn else 2) * k + (m.group(1) == 'BatchNorm') + \
        (k if each else shift if k >= 1 else 0)


def _head_index(head, rest, hidden, shift: int = 0) -> int:
    """Index in an MLPHead: its SharedMLP_0 layers, then the output Dense_0
    at 3h for h hidden layers (plus ``shift`` after a Dropout behind the
    first, or h - 1 for a Dropout behind each hidden layer but the last,
    the heads of ``hidden.dropout_each``)."""
    h = hidden.get(head, 0)
    each = head in hidden.dropout_each
    if len(rest) == 2 and rest[0] == 'SharedMLP_0':
        return _seq_index(rest[1], shift=shift, each=each)
    if rest == ('Dense_0',):
        return 3 * h + (max(h - 1, 0) if each else shift if h >= 1 else 0)
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
    if rest[0] == 'vp_pool':
        return _vector_pool_name('roi_head.roi_grid_pool_layer', rest[1:])
    m = _VOXEL_POOL.fullmatch(rest[0])
    if m and len(rest) == 2 and rest[1] in ('Dense_0', 'BatchNorm_0'):
        return (f'roi_head.roi_grid_pool_layers.{m.group(1)}.'
                f'mlps_{m.group(2)}.{m.group(3)}.{_seq_index(rest[1])}')
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
_RES_BLOCK = re.compile(r'res\d_[ab]')
_VOXEL_POOL = re.compile(r'(x_conv\d)_(in|pos|out)_(\d+)')
_CENTER_LAYER = re.compile(r'(\w+)_(conv|bn)(\d+)')
_PFN = re.compile(r'pfn_(\d+)|pfn(\d+)_(fc|bn)')
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


_VP_LAYER = re.compile(r'(msg_post|post)(_bn)?_(\d+)')
_PLAIN_CENTER = ('shared', 'hm', 'center', 'center_z', 'dim', 'rot')


def _vector_pool_name(base, rest) -> str:
    """Torch name of a ``VectorPoolAggregationMSG`` layer (``rest`` below
    its flax module, torch module ``base``)."""
    g = re.fullmatch(r'layer_(\d+)', rest[0]) if rest else None
    if g and len(rest) == 1:
        return f'{base}.layers.{g.group(1)}'
    if g and rest[1:] == ('agg_bn',):
        return f'{base}.layers.{g.group(1)}.agg_bn'
    m = _VP_LAYER.fullmatch(rest[-1]) if rest else None
    if m is None or (m.group(1) == 'post') != bool(g) or \
            len(rest) != (2 if g else 1):
        raise KeyError(rest)
    seq = 3 * int(m.group(3)) + bool(m.group(2))
    if g:
        return f'{base}.layers.{g.group(1)}.post_mlps.{seq}'
    return f'{base}.msg_post_mlps.{seq}'


def _center_head_name(rest, hidden) -> str:
    """Torch name of a ``CenterHeadIoU`` or plain ``CenterHead`` layer
    (``rest`` below dense_head)."""
    if len(rest) == 1 and rest[0] in _PLAIN_CENTER:
        return f'dense_head.{rest[0]}'
    if rest in (('shared_conv',), ('shared_bn',)):
        return f'dense_head.shared_conv.{int(rest[0] == "shared_bn")}'
    g = re.fullmatch(r'head_(\d+)', rest[0])
    if g is None or len(rest) != 2:
        raise KeyError(rest)
    base = f'dense_head.heads_list.{g.group(1)}'
    if rest[1].endswith('_out'):
        name = rest[1][:-len('_out')]
        return f'{base}.{name}.{hidden.head_convs[rest[0], name]}'
    m = _CENTER_LAYER.fullmatch(rest[1])
    if m is None:
        raise KeyError(rest)
    name, kind, k = m.groups()
    return f'{base}.{name}.{k}.{int(kind == "bn")}'


def _voxel_name(module, hidden) -> str:
    """Torch name prefix of a flax module of the voxel detectors' own
    blocks (raises ``KeyError`` for any other)."""
    top, rest = module[0], module[1:]
    if top == 'backbone_3d' and len(rest) == 2 and \
            _SPARSE_CONV.fullmatch(rest[0]):
        return f'backbone_3d.{rest[0]}.{_seq_index(rest[1])}'
    if top == 'backbone_3d' and len(rest) == 3 and \
            _RES_BLOCK.fullmatch(rest[0]) and rest[1] in ('conv1', 'conv2'):
        return f'backbone_3d.{rest[0]}.{rest[1]}.{_seq_index(rest[2])}'
    if top == 'backbone_2d' and len(rest) == 1:
        return _bev_name(rest[0])
    if top == 'dense_head' and rest in (('conv_cls',), ('conv_box',),
                                        ('conv_dir_cls',)):
        return f'dense_head.{rest[0]}'
    if top == 'dense_head':
        return _center_head_name(rest, hidden)
    m = re.fullmatch(r'(raw|x_conv\d)_vp', rest[0]) if top == 'pfe' else None
    if m:
        group = 'SA_rawpoints' if m.group(1) == 'raw' else \
            f'SA_layers.{m.group(1)}'
        return _vector_pool_name(f'pfe.{group}', rest[1:])
    if top == 'pfe' and len(rest) == 2:
        m = re.fullmatch(r'(raw|x_conv\d)_mlp_(\d+)', rest[0])
        if m:
            group = 'SA_rawpoints' if m.group(1) == 'raw' else \
                f'SA_layers.{m.group(1)}'
            return f'pfe.{group}.mlps.{m.group(2)}.{_seq_index(rest[1])}'
        if rest[0] == 'vsa_point_feature_fusion':
            return f'pfe.vsa_point_feature_fusion.{_seq_index(rest[1])}'
    raise KeyError(module)


def _vfe_name(module) -> str:
    """Torch name prefix of a pillar VFE's layer: PillarVFE's
    ``pfn_{i}/{Dense_0,BatchNorm_0}``, DynamicPillarVFE's ``pfn{i}_{fc,bn}``."""
    m = _PFN.fullmatch(module[1]) if len(module) >= 2 else None
    if m is None:
        raise KeyError(module)
    if m.group(1) is not None:
        if module[2:] not in (('Dense_0',), ('BatchNorm_0',)):
            raise KeyError(module)
        i, bn = m.group(1), module[2] == 'BatchNorm_0'
    else:
        if len(module) != 2:
            raise KeyError(module)
        i, bn = m.group(2), m.group(3) == 'bn'
    return f'vfe.pfn_layers.{i}.{"norm" if bn else "linear"}'


def _torch_name(module, hidden, bn_paths) -> str:
    """Torch name prefix of a flax module path of the detector."""
    if module[0] == 'vfe':
        return _vfe_name(module)
    if module[0] in ('backbone_2d', 'dense_head', 'pfe') or (
            module[0] == 'backbone_3d' and len(module) >= 3 and
            (_SPARSE_CONV.fullmatch(module[1]) or
             _RES_BLOCK.fullmatch(module[1]))):
        return _voxel_name(module, hidden)
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


class _Layout(dict):
    """Hidden-layer count of every MLPHead, keyed by its module path; with
    ``dropout_each``, the heads with a Dropout behind each hidden layer
    but the last (Voxel R-CNN's towers), and ``head_convs``, the hidden
    conv count of each CenterHead output, keyed by (head_{g}, name)."""
    dropout_each = frozenset()


def _n_hidden(params) -> _Layout:
    counts, convs, voxel_rcnn = {}, {}, False
    for path, _ in _leaves(params):
        if 'SharedMLP_0' in path:
            head = path[:path.index('SharedMLP_0')]
            layer = path[path.index('SharedMLP_0') + 1]
            if layer.startswith('Dense_'):
                counts.setdefault(head, set()).add(layer)
        if path[0] == 'roi_head' and _VOXEL_POOL.fullmatch(path[1]):
            voxel_rcnn = True
        if path[0] == 'dense_head' and len(path) == 4:
            m = _CENTER_LAYER.fullmatch(path[2])
            if m and m.group(2) == 'conv':
                convs.setdefault((path[1], m.group(1)), set()).add(path[2])
    layout = _Layout({k: len(v) for k, v in counts.items()})
    layout.head_convs = {k: len(v) for k, v in convs.items()}
    if voxel_rcnn:
        layout.dropout_each = frozenset({('roi_head', 'cls_layers'),
                                         ('roi_head', 'reg_layers')})
    return layout


def _is_bn(module_name: str) -> bool:
    """A flax BatchNorm: ``BatchNorm_k`` in a SharedMLP or a sparse conv,
    ``..._bn`` / ``block{i}_bn{j}`` in the BEV backbone, ``agg_bn`` and
    ``(msg_)post_bn_{i}`` in VectorPool aggregation."""
    return module_name.startswith('BatchNorm') or \
        re.fullmatch(r'\w+_bn(\d*|_\d+)', module_name) is not None


def _kernel_to_torch(arr, name, conv_deblocks=()):
    """A Dense, Conv or ConvTranspose kernel in torch's layout (a deblock
    is a ConvTranspose unless its index is in ``conv_deblocks``)."""
    if arr.ndim == 2:
        return arr.T
    m = re.search(r'\.deblocks\.(\d+)\.', name)
    if m and int(m.group(1)) not in conv_deblocks:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1).copy()
    return arr.transpose(3, 2, 0, 1).copy()


def _convert(variables, name_of,
             conv_deblocks=()) -> "OrderedDict[str, torch.Tensor]":
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
                arr = _kernel_to_torch(arr, name, conv_deblocks)
            sd[name] = torch.tensor(arr)
            if is_bn and leaf == 'scale':
                sd[name.replace('.weight', '.num_batches_tracked')] = \
                    torch.tensor(0)
    return sd


def flax_to_torch(variables,
                  conv_deblocks=()) -> "OrderedDict[str, torch.Tensor]":
    """A detector's ``{'params', 'batch_stats'}`` flax trees
    (numpy-convertible leaves) -> the port's state dict, with
    ``num_batches_tracked`` = 0 for every BatchNorm. ``conv_deblocks``:
    the indices of the BEV backbone's deblocks that are strided Convs
    (``base_bev_backbone.StridedDeblock``), the others ConvTransposes.
    Raises ``KeyError`` on a flax leaf it cannot map."""
    return _convert(variables, _torch_name, conv_deblocks)


def conv_deblocks_of(model: torch.nn.Module) -> frozenset:
    """The indices of ``model``'s BEV deblocks whose first layer is a
    Conv2d and not a ConvTranspose2d."""
    return frozenset(
        int(name.split('.')[-2]) for name, m in model.named_modules()
        if name.startswith('backbone_2d.deblocks.') and name.endswith('.0')
        and isinstance(m, torch.nn.Conv2d))


def generator_flax_to_torch(variables) -> "OrderedDict[str, torch.Tensor]":
    """``flax_to_torch`` for the variables of the stability model
    ``GenerateCenter`` (``stability/model.py``)."""
    return _convert(variables, _generator_name)


def load_flax(model: torch.nn.Module, variables,
              convert=flax_to_torch) -> torch.nn.Module:
    """Load flax variables into ``model`` (a detector; pass ``convert=
    generator_flax_to_torch`` for a ``GenerateCenter``); raises on any key
    left unmapped on either side or on a shape mismatch (``strict`` load)."""
    sd = convert(variables, conv_deblocks_of(model)) \
        if convert is flax_to_torch else convert(variables)
    model.load_state_dict(sd, strict=True)
    return model
