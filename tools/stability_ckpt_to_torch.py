"""Convert a stability-model checkpoint of ``tools/train_stability.py`` into
the state dict that the PyTorch port reads.

Usage:
    python tools/stability_ckpt_to_torch.py \
        --ckpt output/stability/sf_unc/default/ckpt --out generator.pt

``--ckpt`` is what ``spsnet_tpu.stability.hook.load_generator_checkpoint``
takes: the checkpoint manager's root (its newest step), a step directory or
an item directory. The output is a ``torch.save`` file of the port's
``GenerateCenter`` state dict (``spsnet_torch.utils.weights.
generator_flax_to_torch``); name it in ``MODEL.STABILITY_HOOK.CKPT`` for the
port's ``make_stability_preprocess``.

This tool imports the JAX package to read the checkpoint, so it lives in
``tools/`` and not in ``spsnet_torch/``, which imports no JAX.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def convert(ckpt, out) -> Path:
    """Read the stability checkpoint at ``ckpt`` and write the port's state
    dict to ``out``; returns ``out``."""
    import jax
    import numpy as np
    import torch

    from spsnet_tpu.stability.hook import load_generator_checkpoint
    from spsnet_torch.utils.weights import generator_flax_to_torch

    gen_vars = jax.tree_util.tree_map(np.asarray,
                                      load_generator_checkpoint(ckpt))
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(generator_flax_to_torch(gen_vars), out)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--ckpt', type=str, required=True,
                        help='checkpoint root, step dir or item dir')
    parser.add_argument('--out', type=str, required=True,
                        help='torch state dict to write')
    args = parser.parse_args()
    print(convert(args.ckpt, args.out))


if __name__ == '__main__':
    main()
