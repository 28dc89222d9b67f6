"""Weights between the JAX package's flax parameter trees and the port's
``state_dict``s — the one place that knows how the two name them.

The port keeps flax's names and layouts (``wte``, ``wpe``,
``block_{i}/ln1/scale``, ``block_{i}/attention/query/kernel`` of shape
``[d, heads, head_dim]``, ...), so a flax path maps to a ``state_dict``
key by joining its parts with ``.``, and the arrays move unchanged.
Arrays cross as numpy: this module imports neither JAX nor flax.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` (the
parameters, the Adam moments and step, the loss-scaler state) into the
port's, so both packages can continue one training run from the same
point.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            flat.update(_flatten(sub, key + "."))
        else:
            flat[key] = sub
    return flat


def _tensor(arr) -> torch.Tensor:
    """A numpy array (bfloat16 included, which numpy holds as an
    extension type) as a tensor of the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def gpt_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax GPT ``params`` tree (nested mappings of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as a ``state_dict``
    for :class:`apex_tpu_torch.models.GPT` (``load_state_dict`` then
    checks every name and shape)."""
    return {key: torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in _flatten(params).items()}


def gpt_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The inverse: a GPT ``state_dict`` as a nested dict of float32 numpy
    arrays in the flax tree's layout (``flax.core.freeze`` it, or pass it
    to ``model.apply`` as ``{"params": tree}``)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def train_state_from_jax(state, device=None):
    """A JAX ``apex_tpu.training.TrainState`` whose leaves are numpy
    arrays (``jax.tree_util.tree_map(np.asarray, state)``), with an
    ``AdamState`` optimizer state, as the port's ``TrainState`` on
    ``device``: parameters and moments keep their dtypes and flax names,
    the step and the scaler state become 0-dim tensors."""
    from .amp.loss_scaler import LossScalerState
    from .optimizers.functional import AdamState
    from .training import TrainState

    def tree(t):
        return {k: _tensor(v).to(device) for k, v in _flatten(t).items()}

    def scalar(x):
        return _tensor(x).to(device)

    opt = state.opt_state
    return TrainState(
        params=tree(state.params),
        opt_state=AdamState(step=scalar(opt.step).to(torch.int32),
                            exp_avg=tree(opt.exp_avg),
                            exp_avg_sq=tree(opt.exp_avg_sq)),
        scaler=LossScalerState(*(scalar(x) for x in state.scaler)))
