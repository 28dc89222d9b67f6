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

The weight's int8 operands (``qw [N, Kp]``, ``w_scale [N]``) are
prepared once per weight version while no gradient is recorded (serving
under ``torch.inference_mode``, evaluation under ``torch.no_grad``): the
site keeps them keyed on its ``kernel`` parameter by identity (a weak
reference), its ``_version`` counter and data address, the compute dtype
and the device, so ``load_state_dict``, an in-place update or a
``.data`` assignment prepares again.  An update through ``.data`` in
place (``p.data.add_``) bumps no counter of ``p`` and is not seen.  With
gradients recorded (training: under ``functional_call`` the kernel is a
fresh tensor each step) every call prepares, as the JAX package does
inside its jitted step.  ``preparations`` counts a site's preparations.

A site's name is flax's ``/``-joined module path (``block_0/mlp_up``,
``block_1/attention/query``), given by :func:`name_quant_sites`, which
the ``GPT`` constructor calls: a JAX ``Calibration`` drives the port's
model directly.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
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
        self._prepared: Optional[tuple] = None   # (key, weakref, qw, ws)
        self.preparations = 0

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

    def _weight(self) -> torch.Tensor:
        """The kernel as a ``[K, N]`` matrix in the compute dtype."""
        return self.kernel.reshape(math.prod(self.in_shape), -1).to(
            self.dtype)

    def _prepared_weight(self):
        """``(qw, w_scale)`` of :meth:`_weight`, made once per version of
        ``self.kernel`` and kept (built outside inference mode, so that a
        model that serves and then trains carries no inference tensor
        into autograd)."""
        p = self.kernel
        key = (p._version, p.data_ptr(), self.dtype, p.device)
        hit = self._prepared
        if hit is not None and hit[0] == key and hit[1]() is p:
            return hit[2], hit[3]
        with torch.inference_mode(False), torch.no_grad():
            w = self._weight()
            ws = K.channel_scale(w)
            qw = K.weight_layout(w, ws)
        self._prepared = (key, weakref.ref(p), qw, ws)
        self.preparations += 1
        return qw, ws

    def _quantized(self, x, x_scale):
        """Cast x and the kernel to the compute dtype (the JAX
        ``promote_dtype``), flatten to 2-D, the int8 kernel, the bias
        added in the compute dtype.  Without gradients the weight's
        operands come prepared (:meth:`_prepared_weight`)."""
        n_in = math.prod(self.in_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x2d = x.reshape(-1, n_in).to(self.dtype)
        cfg = self.quant
        xs = self._x_scale(x_scale, x.device)
        if torch.is_grad_enabled():
            self._prepared = None
            self.preparations += 1
            y = K.quantized_matmul(x2d, self._weight(), x_scale=xs,
                                   impl=cfg.impl, interpret=cfg.interpret)
        else:
            qw, ws = self._prepared_weight()
            y = K._quantized_matmul_prepared(x2d, qw, ws, xs, impl=cfg.impl)
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
