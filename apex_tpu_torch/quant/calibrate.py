"""Scale calibration: observe -> freeze -> serve — counterpart of
``apex_tpu/quant/calibrate.py``.

* the **observation phase** runs a few real batches through a model built
  with ``QuantConfig.observe()``: every
  :class:`~apex_tpu_torch.quant.layers.QuantDenseGeneral` keeps a running
  absmax of its input, and :func:`~apex_tpu_torch.quant.layers.quant_stats`
  hands them to :meth:`Calibrator.harvest`, one bounded amax history per
  site;
* :meth:`Calibrator.freeze` collapses each history into one frozen scale:
  ``"max"`` (the delayed-amax history of FP8 training) or a nearest-rank
  percentile (LLM.int8()-style outlier clipping);
* the frozen :class:`Calibration` is plain host state.  Its
  ``state_dict()`` is the JAX package's, key for key, so scales move
  between the two packages unchanged in either direction.

Telemetry, as in the JAX package: :meth:`Calibrator.observe` mirrors
each absmax into a metrics registry (``registry=``, else the active
recorder's; none, nothing) as the ``quant_absmax/<site>`` high-water
gauge and the ``quant_amax/<site>`` histogram, and
:meth:`Calibration.note_saturation` emits a ``kind="quant"`` event (the
``quant_scale_saturation`` watchdog rule's input) and counts into
``quant_saturations/<site>``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

from ..telemetry import events as _events
from ..telemetry.metrics import nearest_rank_percentiles

__all__ = ["Calibrator", "Calibration"]

#: the quantized range half-width (kernels.QMAX, without importing torch
#: into this host-only module)
_QMAX = 127.0


def _active_registry():
    """The active recorder's registry, or None: calibration mirrors into
    telemetry only while a run records."""
    rec = _events.get_recorder()
    return rec.metrics if rec is not None else None


def _flatten_stats(tree, prefix=()) -> Dict[str, float]:
    """Flatten nested dicts of ``amax`` leaves (the JAX ``quant_stats``
    collection) or a flat ``{site: amax}`` mapping into ``{"block_0/mlp_up":
    amax_float}``."""
    out: Dict[str, float] = {}
    if hasattr(tree, "items"):
        for k, v in tree.items():
            if k == "amax":
                out["/".join(str(p) for p in prefix)] = float(v)
            else:
                out.update(_flatten_stats(v, prefix + (str(k),)))
        return out
    out["/".join(str(p) for p in prefix)] = float(tree)
    return out


class Calibration:
    """Frozen per-site activation scales (the observe phase's output).

    ``scales``: ``{site: x_scale}`` (floats, ``amax / 127``); ``amax``:
    the amax each scale froze from.  ``get``/``x_scale_for`` return None
    for an unknown site, whose layer then runs the plain (bitwise O2)
    arithmetic."""

    def __init__(self, scales: Dict[str, float],
                 amax: Optional[Dict[str, float]] = None,
                 meta: Optional[dict] = None):
        self.scales = {str(k): float(v) for k, v in scales.items()}
        self.amax = {str(k): float(v) for k, v in (amax or {}).items()}
        self.meta = dict(meta or {})
        self._saturations: Dict[str, int] = {}

    def x_scale_for(self, name: str) -> Optional[float]:
        return self.scales.get(name)

    get = x_scale_for

    def __len__(self) -> int:
        return len(self.scales)

    def __contains__(self, name: str) -> bool:
        return name in self.scales

    def __repr__(self) -> str:
        return (f"Calibration({len(self.scales)} site(s), "
                f"mode={self.meta.get('mode')!r})")

    def state_dict(self) -> dict:
        """JSON-compatible dict, the JAX package's format (version 1)."""
        return {"version": 1, "scales": dict(self.scales),
                "amax": dict(self.amax), "meta": dict(self.meta)}

    @classmethod
    def from_state_dict(cls, sd: dict) -> "Calibration":
        if int(sd.get("version", 1)) != 1:
            raise ValueError(
                f"unknown quant calibration version {sd.get('version')!r}")
        return cls(sd.get("scales") or {}, sd.get("amax") or {},
                   sd.get("meta") or {})

    def note_saturation(self, name: str, exceeded: int, *,
                        window: Optional[int] = None,
                        recorder=None) -> None:
        """Count ``exceeded`` elements (or steps) that overflowed the
        calibrated range of ``name`` in the last window of ``window``
        steps (:func:`kernels.saturation_count` gives the device-side
        count; read it at a boundary the caller already pays).  With a
        recorder (``recorder``, else the active one) a positive count is
        a ``quant`` ``saturation`` event and adds to the
        ``quant_saturations/<name>`` counter."""
        exceeded = int(exceeded)
        self._saturations[name] = self._saturations.get(name, 0) + exceeded
        rec = recorder if recorder is not None else _events.get_recorder()
        if rec is None or exceeded <= 0:
            return
        rec.event("quant", phase="saturation", name=name,
                  exceeded=exceeded, amax=self.amax.get(name),
                  **({"window": int(window)} if window else {}))
        rec.metrics.counter(f"quant_saturations/{name}").inc(exceeded)

    @property
    def saturations(self) -> Dict[str, int]:
        return dict(self._saturations)


class Calibrator:
    """Bounded amax-history accumulator for the observation phase.

    ``history`` bounds the delayed-amax window (freeze against the max of
    the last H observations, so one early batch cannot pin the range
    forever); ``registry`` the metrics registry the observations are
    mirrored into (default: the active recorder's, none without one)."""

    def __init__(self, *, history: int = 16, registry=None):
        self.history = max(1, int(history))
        self._hist: Dict[str, deque] = {}
        self._registry = registry

    def observe(self, name: str, amax: float) -> None:
        """Fold one site's observed absmax (a host float)."""
        amax = float(amax)
        name = str(name)
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = deque(maxlen=self.history)
        h.append(amax)
        reg = (self._registry if self._registry is not None
               else _active_registry())
        if reg is not None:
            reg.gauge(f"quant_absmax/{name}").set_max(amax)
            reg.histogram(f"quant_amax/{name}").observe(amax)

    def harvest(self, stats) -> "Calibrator":
        """Fold one batch's statistics: the ``{site: amax}`` mapping of
        :func:`~apex_tpu_torch.quant.layers.quant_stats` (or the JAX
        ``quant_stats`` nested dicts) — one :meth:`observe` per site."""
        for name, amax in _flatten_stats(stats).items():
            self.observe(name, amax)
        return self

    @property
    def sites(self):
        return sorted(self._hist)

    def freeze(self, mode: Any = "max") -> Calibration:
        """Collapse each site's history into one frozen scale: ``"max"``
        the max over the history, a float ``mode`` (e.g. ``99.9``) its
        nearest-rank percentile."""
        if not self._hist:
            raise ValueError(
                "Calibrator has no observations — run an observation "
                "phase (mode='observe' + harvest) before freeze()")
        scales, amaxes = {}, {}
        for name, h in self._hist.items():
            vals = list(h)
            if mode == "max":
                amax = max(vals)
            else:
                q = float(mode)
                if not 0.0 < q <= 100.0:
                    raise ValueError(
                        f"percentile mode must be in (0, 100], got {q}")
                amax = nearest_rank_percentiles(vals, (q,))[0]
            amaxes[name] = float(amax)
            scales[name] = (float(amax) / _QMAX) if amax > 0 else 1.0
        return Calibration(scales, amaxes,
                           meta={"mode": str(mode),
                                 "history": self.history,
                                 "observations": {
                                     k: len(v)
                                     for k, v in self._hist.items()}})
