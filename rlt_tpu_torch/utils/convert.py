"""Weights across from the JAX package: a flax parameter tree -> state_dict.

The JAX package keeps torch's names and layouts (`models/layers.py`), so a
leaf `a/b/c` becomes the key `a.b.c` unchanged, with one exception: flax's
LayerNorm names its gain `scale` where torch says `weight`. The expert
stack's leading E axis is kept as it is, and so is a population's leading
member axis K (`population_params_from_jax`: the tree of `jax.vmap`ped
inits). The tree arrives as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, params)` on the JAX side), so this module needs
neither JAX nor flax. `stack_state_dicts` stacks K port state_dicts into
the state_dict of one model with members.
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


def population_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flax `params` tree whose every leaf leads with the member axis K
    (the JAX package's population state, `jax.vmap` of the init) -> the
    state_dict of the port's model with `members=K`: the same keys, the
    member axis kept in front."""
    state = params_from_jax(tree)
    sizes = {t.shape[0] if t.dim() else None for t in state.values()}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"a population tree leads every leaf with one member axis; "
                         f"got leading sizes {sorted(map(str, sizes))}")
    return state


def stack_state_dicts(states) -> dict[str, torch.Tensor]:
    """K state_dicts of one model -> one state_dict with each leaf's K
    values stacked on a new leading member axis."""
    states = list(states)
    if not states:
        raise ValueError("no state_dicts to stack")
    keys = list(states[0])
    for state in states[1:]:
        if list(state) != keys:
            raise ValueError("the state_dicts to stack have different keys")
    return {k: torch.stack([state[k] for state in states]) for k in keys}
