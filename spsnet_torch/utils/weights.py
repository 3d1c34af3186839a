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

A Dense kernel (in, out) becomes a Linear weight (out, in).
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_HEADS = {'cls_center': 'cls_center_layers', 'box_center': 'box_center_layers',
          'box_iou3d': 'box_iou3d_layers'}
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


def _seq_index(layer: str) -> int:
    """Sequential index of a SharedMLP layer: Dense_k -> 3k,
    BatchNorm_k -> 3k+1 (ReLU at 3k+2 holds no weights)."""
    m = re.fullmatch(r'(Dense|BatchNorm)_(\d+)', layer)
    if m is None:
        raise KeyError(layer)
    return 3 * int(m.group(2)) + (m.group(1) == 'BatchNorm')


def _head_index(head, rest, hidden) -> int:
    """Index in an MLPHead: its SharedMLP_0 layers, then the output Dense_0
    at 3h for h hidden layers."""
    if len(rest) == 2 and rest[0] == 'SharedMLP_0':
        return _seq_index(rest[1])
    if rest == ('Dense_0',):
        return 3 * hidden.get(head, 0)
    raise KeyError(rest)


def _torch_name(module, hidden) -> str:
    """Torch name prefix of a flax module path."""
    if module[0] == 'point_head' and len(module) > 2 and module[1] in _HEADS:
        idx = _head_index(module[:2], module[2:], hidden)
        return f'point_head.{_HEADS[module[1]]}.{idx}'
    m = re.fullmatch(r'(sa|vote)_(\d+)', module[1]) \
        if module[0] == 'backbone_3d' and len(module) > 2 else None
    if m is None:
        raise KeyError(module)
    base = f'backbone_3d.SA_modules.{m.group(2)}'
    rest = module[2:]
    if m.group(1) == 'vote':
        if rest == ('ctr_reg',):
            return f'{base}.ctr_reg'
        if len(rest) == 2 and rest[0] == 'mlp':
            return f'{base}.mlp_modules.{_seq_index(rest[1])}'
        raise KeyError(module)
    mm = re.fullmatch(r'mlp_(\d+)', rest[0])
    if mm and len(rest) == 2:
        return f'{base}.mlps.{mm.group(1)}.{_seq_index(rest[1])}'
    if rest[0] == 'aggregation' and len(rest) == 2:
        return f'{base}.aggregation_layer.{_seq_index(rest[1])}'
    if rest[0] == 'confidence':
        idx = _head_index(module[:3], rest[1:], hidden)
        return f'{base}.confidence_layers.{idx}'
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


def flax_to_torch(variables) -> "OrderedDict[str, torch.Tensor]":
    """``{'params', 'batch_stats'}`` flax trees (numpy-convertible leaves)
    -> the port's state dict, with ``num_batches_tracked`` = 0 for every
    BatchNorm. Raises ``KeyError`` on a flax leaf it cannot map."""
    unknown = set(variables) - {'params', 'batch_stats'}
    if unknown:
        raise KeyError(f'unmapped flax collections: {sorted(unknown)}')
    hidden = _n_hidden(variables['params'])
    sd = OrderedDict()
    for coll in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(coll, {})):
            module, leaf = path[:-1], path[-1]
            is_bn = bool(module) and module[-1].startswith('BatchNorm')
            leaf_map = _BN_LEAF if is_bn else _DENSE_LEAF
            where = f'{coll}/{"/".join(path)}'
            if (coll, leaf) not in leaf_map:
                raise KeyError(f'unmapped flax leaf: {where}')
            try:
                name = f'{_torch_name(module, hidden)}.{leaf_map[coll, leaf]}'
            except KeyError as e:
                raise KeyError(f'unmapped flax leaf: {where}') from e
            if name in sd:
                raise KeyError(f'flax leaf {where} maps onto {name} twice')
            arr = np.asarray(value, dtype=np.float32)
            if leaf == 'kernel':
                arr = arr.T
            sd[name] = torch.tensor(arr)
            if is_bn and leaf == 'scale':
                sd[name.replace('.weight', '.num_batches_tracked')] = \
                    torch.tensor(0)
    return sd


def load_flax(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax variables into ``model``; raises on any key left unmapped
    on either side or on a shape mismatch (``strict`` load)."""
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model
