"""Manual precision helpers — counterpart of
``apex_tpu/bf16_utils/bf16util.py`` (reference
``apex/fp16_utils/fp16util.py:7-187``).

The JAX helpers are pure functions over parameter pytrees.  Here a
"network" is an ``nn.Module`` (cast in place, parameter identities
kept, as the reference's helpers do) or a ``name -> tensor`` mapping
(a new mapping comes back); the master copies are tensors beside the
model's.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..amp import policy as _policy
from ..multi_tensor import multi_tensor_l2norm

__all__ = ["to_bf16", "to_half", "tofp16", "BN_convert_float",
           "convert_module", "convert_network", "network_to_half",
           "BF16Model", "FP16Model", "prep_param_lists",
           "model_grads_to_master_grads", "master_params_to_model_params",
           "clip_grad_norm"]


def to_bf16(value):
    """Every floating tensor of ``value`` cast to bfloat16 (reference
    ``tofp16``; "half" is bfloat16 here, as in the JAX package)."""
    return _policy.to_type(torch.bfloat16, value)


to_half = to_bf16


class tofp16(nn.Module):
    """A module that casts its input to bfloat16 (reference
    ``fp16util.py:7-15``)."""

    def forward(self, x):
        return to_bf16(x)


def _recast(params, pick, dtype):
    """Cast the floating parameters ``pick(name)`` selects to ``dtype``:
    in place on a module (returned), into a new mapping otherwise."""
    if isinstance(params, nn.Module):
        for name, p in params.named_parameters():
            if p.is_floating_point() and pick(name):
                p.data = p.data.to(dtype)
        return params
    return {k: v.to(dtype) if v.is_floating_point() and pick(k) else v
            for k, v in params.items()}


def BN_convert_float(params, norm_predicate=None):
    """The normalization parameters (by name) back to fp32 (reference
    ``fp16util.py:17-32``)."""
    pred = norm_predicate or _policy.default_norm_predicate
    return _recast(params, pred, torch.float32)


def convert_module(params, dtype):
    """Every floating parameter to ``dtype`` (reference
    ``fp16util.py:34-52``)."""
    return _recast(params, lambda name: True, dtype)


def convert_network(params, dtype, norm_predicate=None):
    """The model to ``dtype`` with the norms kept fp32 — the rule amp O2
    uses (reference ``fp16util.py:74-86``)."""
    pred = norm_predicate or _policy.default_norm_predicate
    return _recast(params, lambda name: not pred(name), dtype)


def network_to_half(network: nn.Module) -> nn.Module:
    """``Sequential(tofp16(), convert_network(network, bf16))``
    (reference ``fp16util.py:54-61``)."""
    return nn.Sequential(tofp16(), convert_network(network, torch.bfloat16))


class BF16Model(nn.Module):
    """A network converted to bfloat16 whose inputs are cast to bfloat16
    (reference ``FP16Model``, ``fp16util.py:88-102``)."""

    def __init__(self, network: nn.Module):
        super().__init__()
        self.network = convert_network(network, torch.bfloat16)

    def forward(self, *inputs):
        return self.network(*to_bf16(inputs))


FP16Model = BF16Model


def _params(model_or_params):
    if isinstance(model_or_params, nn.Module):
        return [p for p in model_or_params.parameters() if p.requires_grad]
    if isinstance(model_or_params, Mapping):
        return list(model_or_params.values())
    return list(model_or_params)


def prep_param_lists(model, flat_master: bool = False):
    """``(model_params, master_params)``: the model's parameters and fp32
    copies that require grad (reference ``fp16util.py:104-134``); with
    ``flat_master`` the masters are one flat fp32 vector."""
    model_params = _params(model)
    if flat_master:
        flat = torch.cat([p.detach().float().reshape(-1)
                          for p in model_params])
        return model_params, [flat.requires_grad_(True)]
    masters = [p.detach().float().clone().requires_grad_(True)
               for p in model_params]
    return model_params, masters


def model_grads_to_master_grads(model_params, master_params,
                                flat_master: bool = False) -> None:
    """The model's ``.grad`` into the masters' ``.grad`` in fp32
    (reference ``fp16util.py:136-156``)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in model_params]
    if flat_master:
        master_params[0].grad = torch.cat([g.float().reshape(-1)
                                           for g in grads])
        return
    for m, g in zip(master_params, grads):
        m.grad = g.detach().float().clone()


@torch.no_grad()
def master_params_to_model_params(model_params, master_params,
                                  flat_master: bool = False) -> None:
    """The masters' values into the model's parameters, cast to their
    dtypes (reference ``fp16util.py:158-173``)."""
    if flat_master:
        master_params = torch.split(master_params[0].detach(),
                                    [p.numel() for p in model_params])
        master_params = [m.view(p.shape)
                         for m, p in zip(master_params, model_params)]
    torch._foreach_copy_(list(model_params),
                         [m.detach() for m in master_params])


def clip_grad_norm(grads, max_norm, norm_type: float = 2.0):
    """``(clipped, total_norm)``: the gradient tree scaled by
    ``min(1, max_norm / (total + 1e-6))`` (the JAX package's form of the
    reference's ``clip_grad_norm``, ``fp16util.py:180-187``)."""
    leaves, rebuild = pytree.tree_flatten(grads)
    floats = [g for g in leaves if isinstance(g, torch.Tensor)
              and g.is_floating_point()]
    if norm_type == 2.0:
        total = multi_tensor_l2norm(floats)
    elif norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in floats]).max()
    else:
        total = torch.stack([torch.sum(g.float().abs() ** norm_type)
                             for g in floats]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    clipped = [(g * scale).to(g.dtype) if isinstance(g, torch.Tensor)
               and g.is_floating_point() else g for g in leaves]
    return pytree.tree_unflatten(clipped, rebuild), total
