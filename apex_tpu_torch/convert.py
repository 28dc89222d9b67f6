"""Weights between the JAX package's flax parameter trees and the port's
``state_dict``s — the one place that knows how the two name them.

The port keeps flax's names and layouts (``wte``, ``wpe``,
``block_{i}/ln1/scale``, ``block_{i}/attention/query/kernel`` of shape
``[d, heads, head_dim]``, ...), so a flax path maps to a ``state_dict``
key by joining its parts with ``.``, and the arrays move unchanged.
Arrays cross as numpy: this module imports neither JAX nor flax.

The ResNet trees keep flax's layouts too: conv kernels ``[KH, KW, Cin,
Cout]`` (the port permutes them inside its forward) and the Dense kernel
``[in, out]``, so optimizer state moves without transposes.
:func:`resnet_variables_from_jax` splits flax's ``params`` and
``batch_stats`` collections into two flat mappings.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` (the
parameters, the Adam, SGD, LAMB or NovoGrad state, leafwise or bucketed,
the loss-scaler state and the model state) into the port's, and
:func:`fused_optimizer_state_from_jax` a JAX ``FusedOptimizer``'s
``state_dict`` (masters, moments, step, bucketed ``Packed`` state) into
the port's fused optimizer classes, so both packages can continue one
training run from the same point (``amp.state_dict()`` needs nothing:
the two packages write the same ``{"loss_scaler{i}": {"loss_scale",
"unskipped"}}``).  The DCGAN pair's variables move with
:func:`dcgan_params_from_jax` / :func:`dcgan_params_to_jax`.  A bucketed
state's ``Packed`` moments cross unchanged: the port's
:class:`~apex_tpu_torch.multi_tensor.BucketStore` lays out the same
buckets as JAX's for the converted tree.

For weight hot-swap (:mod:`apex_tpu_torch.serving.hotswap`),
:func:`lm_train_state_like` is the template an LM trainer checkpoint is
loaded against and :func:`gpt_params_from_train_state` the ``extract``
that gives the GPT module its parameters from it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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
    return _flat_fp32(params)


def _flat_fp32(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {key: torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in _flatten(tree).items()}


def gpt_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The inverse: a GPT ``state_dict`` as a nested dict of float32 numpy
    arrays in the flax tree's layout (``flax.core.freeze`` it, or pass it
    to ``model.apply`` as ``{"params": tree}``)."""
    return _nest(state_dict)


def bert_params_from_jax(params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """A flax BERT ``params`` tree (nested mappings of numpy arrays) as a
    ``state_dict`` for :class:`apex_tpu_torch.models.BertEncoder`."""
    return _flat_fp32(params)


def bert_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The inverse: a BERT ``state_dict`` as a nested dict of float32
    numpy arrays in the flax tree's layout."""
    return _nest(state_dict)


def resnet_variables_from_jax(variables: Mapping[str, Any]
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor]]:
    """A flax ResNet's variables (``{"params": ..., "batch_stats": ...}``,
    nested mappings of numpy arrays) as ``(params, batch_stats)``, flat
    mappings of ``state_dict`` names to fp32 tensors
    (``ResNet.load_state_dict({**params, **batch_stats})`` checks every
    name and shape)."""
    return (_flat_fp32(variables["params"]),
            _flat_fp32(variables.get("batch_stats", {})))


def resnet_variables_to_jax(params: Mapping[str, torch.Tensor],
                            batch_stats: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Any]:
    """The inverse: ``{"params": tree, "batch_stats": tree}`` of float32
    numpy arrays in the flax layout."""
    return {"params": _nest(params), "batch_stats": _nest(batch_stats)}


def dcgan_params_from_jax(variables: Mapping[str, Any]
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """A flax DCGAN ``Generator``'s or ``Discriminator``'s variables
    (``{"params": ..., "batch_stats": ...}``) as ``(params,
    batch_stats)`` for :mod:`apex_tpu_torch.models.dcgan` (kernels keep
    flax's ``[in, out]`` and HWIO layouts)."""
    return resnet_variables_from_jax(variables)


def dcgan_params_to_jax(params: Mapping[str, torch.Tensor],
                        batch_stats: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The inverse: ``{"params": tree, "batch_stats": tree}`` of float32
    numpy arrays in the flax layout."""
    return resnet_variables_to_jax(params, batch_stats)


def _nest(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, t in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def _is_packed(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == (
        "data", "rest")


def _state_tree(t, device):
    """A numpy tree of the JAX package's optimizer state as the port's:
    a ``Packed`` keeps its buckets, a nested mapping becomes a flat
    ``name -> tensor`` dict (dtypes kept)."""
    from .multi_tensor.buckets import Packed
    if _is_packed(t):
        return Packed(data=tuple(_tensor(x).to(device) for x in t.data),
                      rest=tuple(_tensor(x).to(device) for x in t.rest))
    return {k: _tensor(v).to(device) for k, v in _flatten(t).items()}


def _opt_state_from_jax(opt, device):
    """An ``AdamState``, ``SGDState``, ``LambState`` or ``NovoGradState``
    of numpy leaves as the port's."""
    from .optimizers import functional as F
    fields = {}
    for name, value in opt._asdict().items():
        if name == "step":
            fields[name] = _tensor(value).to(device, torch.int32)
        elif name == "initialized":
            fields[name] = _tensor(value).to(device).bool()
        else:
            fields[name] = _state_tree(value, device)
    return getattr(F, type(opt).__name__)(**fields)


def train_state_from_jax(state, device=None):
    """A JAX ``apex_tpu.training.TrainState`` whose leaves are numpy
    arrays (``jax.tree_util.tree_map(np.asarray, state)``), with an
    ``AdamState``, ``SGDState``, ``LambState`` or ``NovoGradState``
    optimizer state, leafwise or bucketed, as the port's ``TrainState``
    on ``device``: parameters, moments, momentum buffers and the model
    state (``batch_stats``) keep their dtypes and flax names, a
    ``Packed`` moment its buckets (NovoGrad's per-tensor vectors
    included), the step, the SGD ``initialized`` flag and the scaler
    state become 0-dim tensors."""
    from .amp.loss_scaler import LossScalerState
    from .training import TrainState

    model_state = getattr(state, "model_state", None)
    return TrainState(
        params=_state_tree(state.params, device),
        opt_state=_opt_state_from_jax(state.opt_state, device),
        scaler=LossScalerState(*(_tensor(x).to(device)
                                 for x in state.scaler)),
        model_state=(None if model_state is None
                     else _state_tree(model_state, device)))


def fused_optimizer_state_from_jax(state_dict, device=None) -> dict:
    """A JAX ``FusedOptimizer.state_dict()`` (numpy leaves:
    ``jax.tree_util.tree_map(np.asarray, opt.state_dict())``) as the
    port's :meth:`FusedOptimizer.state_dict` format, for
    ``load_state_dict`` on a port optimizer whose groups carry the flax
    names (``model.named_parameters()``, or names found by
    ``amp.initialize``): each group's state (moments as flat
    ``name -> tensor`` dicts, or the ``Packed`` buckets of a bucketed
    optimizer, which the port's store lays out as JAX's does), its lr,
    and the fp32 masters; a JAX run continues in the port."""
    out = {"state": [_opt_state_from_jax(st, device)
                     for st in (state_dict["state"]
                                if isinstance(state_dict["state"], list)
                                else [state_dict["state"]])],
           "lr": [float(np.asarray(x)) for x in state_dict["lr"]]}
    masters = state_dict.get("master_params")
    if masters is not None:
        out["master_params"] = [
            {k: _tensor(v).to(device, torch.float32)
             for k, v in _flatten(m).items()} for m in masters]
    return out



def lm_train_state_like(model, opt_level: str = "O2", device="cpu"):
    """A template of the LM trainer's ``TrainState`` for ``model``
    (``examples/lm/main_amp.py``: Adam, ``opt_level``; the parameters as
    ``model.state_dict()`` names them, on ``device``): what a checkpoint
    of that trainer is loaded against (the watcher's ``like``).  Its
    values are zeros; only dtypes, shapes and devices matter."""
    from . import training

    init_fn, _ = training.make_train_step(lambda p, b: None,
                                          training.adam(),
                                          opt_level=opt_level)
    return init_fn({k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                    for k, v in model.state_dict().items()})


def gpt_params_from_train_state(restored) -> Dict[str, torch.Tensor]:
    """The GPT module's parameters from a restored LM trainer checkpoint
    (a :class:`~apex_tpu_torch.checkpoint.Restored` or its
    ``TrainState``): the fp32 masters, under the module's
    ``state_dict`` names (``load_state_dict`` takes them as they are)."""
    state = getattr(restored, "state", restored)
    return dict(state.params)
