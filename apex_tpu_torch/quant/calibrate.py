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

Not ported yet (telemetry, a later slice): the metrics-registry mirror of
``observe`` and the ``kind="quant"`` events of ``note_saturation``; a
``registry=`` or ``recorder=`` that is given raises
``NotImplementedError``.  Without one the port does what the JAX package
does with no active recorder: it counts and returns.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Calibrator", "Calibration"]

#: the quantized range half-width (kernels.QMAX, without importing torch
#: into this host-only module)
_QMAX = 127.0


def nearest_rank_percentiles(samples: Sequence[float],
                             qs: Sequence[float] = (50.0, 90.0, 99.0)
                             ) -> List[Optional[float]]:
    """Nearest-rank percentiles of a sample list (``[]`` -> all None): the
    JAX package's one percentile definition
    (``apex_tpu/telemetry/metrics.py``)."""
    data = sorted(samples)
    if not data:
        return [None for _ in qs]
    out = []
    for q in qs:
        idx = min(len(data) - 1,
                  max(0, int(round(q / 100.0 * (len(data) - 1)))))
        out.append(data[idx])
    return out


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
        calibrated range of ``name`` (:func:`kernels.saturation_count`
        gives the device-side count).  ``window`` labels the telemetry
        event, which is not ported yet."""
        if recorder is not None:
            raise NotImplementedError("the telemetry recorder is not "
                                      "ported yet (ROADMAP queue 1 item 2)")
        del window
        self._saturations[name] = (self._saturations.get(name, 0)
                                   + int(exceeded))

    @property
    def saturations(self) -> Dict[str, int]:
        return dict(self._saturations)


class Calibrator:
    """Bounded amax-history accumulator for the observation phase.

    ``history`` bounds the delayed-amax window (freeze against the max of
    the last H observations, so one early batch cannot pin the range
    forever)."""

    def __init__(self, *, history: int = 16, registry=None):
        if registry is not None:
            raise NotImplementedError("the metrics-registry mirror is not "
                                      "ported yet (ROADMAP queue 1 item 2)")
        self.history = max(1, int(history))
        self._hist: Dict[str, deque] = {}

    def observe(self, name: str, amax: float) -> None:
        """Fold one site's observed absmax (a host float)."""
        name = str(name)
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = deque(maxlen=self.history)
        h.append(float(amax))

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
