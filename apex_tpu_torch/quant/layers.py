"""Model-side quantization hook — counterpart of ``apex_tpu/quant/layers.py``.

amp O4 routes the annotated projections through the int8 kernel while
everything else keeps O2's semantics exactly.  :class:`QuantDenseGeneral`
is the port's ``DenseGeneral`` with a :class:`QuantConfig` attached: the
same ``kernel``/``bias`` names, shapes and generator draws, so an O2 and
an O4 model share one ``state_dict``.  The models' ``quant=`` argument
selects it (``models/bert.py`` ``_dense_factory``).

========== ==============================================================
``off``     the plain ``DenseGeneral`` arithmetic
``observe`` the plain arithmetic, plus a running absmax of the input
            (before the compute cast) in the non-persistent ``amax``
            buffer; :func:`quant_stats` collects them for
            :meth:`~apex_tpu_torch.quant.calibrate.Calibrator.harvest`
``quant``   a site with a frozen scale runs
            :func:`~apex_tpu_torch.quant.kernels.quantized_matmul`; a
            site without one runs the plain arithmetic bit for bit, so a
            missing or partial calibration degrades to O2
========== ==============================================================

A site's name is flax's ``/``-joined module path (``block_0/mlp_up``,
``block_1/attention/query``), given by :func:`name_quant_sites`, which
the ``GPT`` constructor calls: a JAX ``Calibration`` drives the port's
model directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..models.bert import DenseGeneral
from . import kernels as K

__all__ = ["QuantConfig", "QuantDenseGeneral", "name_quant_sites",
           "quant_stats"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """One quantization policy for a model build.

    ``mode``: ``"off"`` / ``"observe"`` / ``"quant"``; ``scales``: a
    :class:`~apex_tpu_torch.quant.calibrate.Calibration` or a plain ``{site:
    x_scale}`` mapping; ``impl``/``interpret`` are passed to
    :func:`~apex_tpu_torch.quant.kernels.quantized_matmul`."""

    mode: str = "quant"
    scales: Any = None
    impl: Optional[str] = None
    interpret: bool = False

    def __post_init__(self):
        if self.mode not in ("off", "observe", "quant"):
            raise ValueError(f"QuantConfig mode must be 'off', 'observe' "
                             f"or 'quant', got {self.mode!r}")

    @classmethod
    def observe(cls) -> "QuantConfig":
        """The observation-phase config (no scales yet)."""
        return cls(mode="observe")

    @classmethod
    def frozen(cls, calibration, **kw) -> "QuantConfig":
        """A serving or training config over a frozen calibration."""
        return cls(mode="quant", scales=calibration, **kw)

    def scale_for(self, name: str) -> Optional[float]:
        s = self.scales
        if s is None:
            return None
        if hasattr(s, "x_scale_for"):
            return s.x_scale_for(name)
        return s.get(name)


class QuantDenseGeneral(DenseGeneral):
    """Parameter-compatible quantized ``DenseGeneral`` (see the module
    docstring); ``site`` is set by :func:`name_quant_sites`."""

    def __init__(self, in_shape, out_shape, dtype=torch.float32, *,
                 quant: Optional[QuantConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_shape, out_shape, dtype, device=device,
                         generator=generator)
        self.quant = quant if quant is not None else QuantConfig("off")
        self.site = ""
        self.register_buffer("amax", torch.zeros((), device=self.bias.device),
                             persistent=False)
        self._x_scales: Dict[tuple, torch.Tensor] = {}

    def forward(self, x):
        cfg = self.quant
        if cfg.mode == "observe":
            self.amax = torch.maximum(self.amax,
                                      x.detach().abs().amax().float())
        elif cfg.mode == "quant":
            x_scale = cfg.scale_for(self.site)
            if x_scale is not None:
                return self._quantized(x, x_scale)
        return super().forward(x)

    def _x_scale(self, value: float, device) -> torch.Tensor:
        """The frozen scale as an fp32 device tensor, made once per device
        (a host-to-device copy per call would synchronise the stream)."""
        key = (float(value), str(device))
        t = self._x_scales.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.tensor(float(value), dtype=torch.float32,
                                 device=device)
            self._x_scales[key] = t
        return t

    def _quantized(self, x, x_scale):
        """Cast x and the kernel to the compute dtype (the JAX
        ``promote_dtype``), flatten to 2-D, the int8 kernel, the bias
        added in the compute dtype."""
        n_in = math.prod(self.in_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x2d = x.reshape(-1, n_in).to(self.dtype)
        w = self.kernel.reshape(n_in, -1).to(self.dtype)
        cfg = self.quant
        y = K.quantized_matmul(x2d, w,
                               x_scale=self._x_scale(x_scale, x.device),
                               impl=cfg.impl, interpret=cfg.interpret)
        y = y + self.bias.reshape(-1).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


def name_quant_sites(model: torch.nn.Module) -> None:
    """Give every :class:`QuantDenseGeneral` under ``model`` its site name:
    its module path below ``model``, ``/``-joined as flax's."""
    for name, mod in model.named_modules():
        if isinstance(mod, QuantDenseGeneral):
            mod.site = name.replace(".", "/")


def quant_stats(model: torch.nn.Module) -> Dict[str, float]:
    """``{site: amax}`` of every observing site: the host floats
    :meth:`~apex_tpu_torch.quant.calibrate.Calibrator.harvest` takes (one
    device-to-host read per site, at the batch boundary of the
    observation phase).  Each site's absmax is zeroed after the read, so
    each harvest sees one batch, as each JAX ``apply`` starts a fresh
    ``quant_stats`` collection."""
    stats = {}
    for mod in model.modules():
        if isinstance(mod, QuantDenseGeneral) and mod.quant.mode == "observe":
            stats[mod.site] = float(mod.amax)
            mod.amax = torch.zeros_like(mod.amax)
    return stats
