"""Weights across from the JAX package: a flax parameter tree -> state_dict.

The JAX package keeps torch's names and layouts (`models/layers.py`), so a
leaf `a/b/c` becomes the key `a.b.c` unchanged, with one exception: flax's
LayerNorm names its gain `scale` where torch says `weight`. The expert
stack's leading E axis is kept as it is. The tree arrives as nested dicts
of numpy arrays (`jax.tree.map(np.asarray, params)` on the JAX side), so
this module needs neither JAX nor flax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (a flax `params` tree) -> torch state_dict."""
    state = {}
    for path, leaf in _flatten(tree):
        if path[-1] == "scale" and len(path) > 1 and path[-2].startswith("norm"):
            path = path[:-1] + ("weight",)
        state[".".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return state
