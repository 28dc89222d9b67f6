"""The port's run-health watchdog against the JAX package's.

Each of the twelve rules gets a synthetic event sequence that fires it;
the same events go through JAX's ``Watchdog`` and the port's, which must
raise the same alerts (rule, step, severity, value) and the same health
verdict, exactly.  Parametrised over the rules, each in three shapes:
``fires`` (one alert), ``debounced`` (the trigger again inside the
debounce window: still one) and ``refires`` (again past it: two).  A
seeded random mix of every kind is folded through both as well, and the
rules' thresholds are the JAX package's (the constructor kwargs
forwarded the same way).
"""

import math

import numpy as np
import pytest

from apex_tpu.telemetry import watchdog as jwdog
from apex_tpu_torch.telemetry import watchdog as twdog

DEBOUNCE = 64


def _metrics(step, bad):
    return [{"kind": "metrics", "step": step, "n_valid": 2,
             "loss": [1.5, float("nan") if bad else 1.25]}]


def _skips(step, scale=1024.0):
    return [{"kind": "scale", "event": "skip", "step": step + j,
             "scale": scale / 2 ** j} for j in range(4)]


def _loader(step, _):
    return [{"kind": "loader", "stats": {"loader_stall_pct": 55.0}}]


def _waits(step, _):
    return [{"kind": "loader_wait", "t": float(step + j), "dur": 0.6,
             "qdepth": 0} for j in range(32)]


def _windows(step, _):
    out = [{"kind": "window", "step": step + j, "n_valid": 1, "dur": 0.01,
            "gap": 0.001} for j in range(9)]
    out.append({"kind": "window", "step": step + 9, "n_valid": 1,
                "dur": 0.2, "gap": 0.0})
    return out


def _retraces(step, _):
    return [{"kind": "retrace", "program": "hot", "step": step + 10 * j,
             "first": j == 0, "new_sig": True, "sig": f"s{j}"}
            for j in range(4)]


def _snapshot(step, _):
    return [{"kind": "checkpoint", "phase": "snapshot", "step": step,
             "dur": 3.25}]


def _backlog(step, _):
    return [{"kind": "checkpoint", "phase": "backlog", "step": step,
             "value": 2}]


def _ckpt_error(step, _):
    return [{"kind": "checkpoint", "phase": "error", "step": step,
             "error": "OSError: disk full"}]


def _memory(step, _):
    return [{"kind": "memory", "phase": "harvest", "step": step,
             "peak_bytes": 95, "bytes_limit": 100}]


def _queue(step, _):
    return [{"kind": "serving", "phase": "admit", "slot": 0,
             "queue_wait": 2.5}]


def _quant(step, _):
    return [{"kind": "quant", "phase": "saturation", "name": "block_0/qkv",
             "exceeded": 9, "step": step, "window": 16}]


def _burn(step, _):
    return [{"kind": "slo", "phase": "eval", "burn_short": 4.0,
             "burn_long": 2.5, "goodput_pct": 90.0, "target_pct": 99.0}]


def _exhausted(step, _):
    return [{"kind": "slo", "phase": "eval", "exhausted": True,
             "goodput_pct": 50.0, "bad": 8, "n": 16, "target_pct": 99.0}]


# rule -> (trigger(step, flag), whether its alerts debounce on the step)
RULES = {
    "nonfinite": (lambda s, _: _metrics(s, True), True),
    "scale_collapse": (lambda s, _: _skips(s), True),
    "loader_stall": (_loader, False),
    "step_time": (_windows, True),
    "retrace_storm": (_retraces, True),
    "checkpoint_stall": (_snapshot, True),
    "checkpoint_failed": (_ckpt_error, True),
    "memory_headroom": (_memory, True),
    "serving_queue_stall": (_queue, False),
    "quant_scale_saturation": (_quant, True),
    "slo_burn": (_burn, False),
    "slo_exhausted": (_exhausted, False),
}


def test_every_rule_is_covered():
    assert set(RULES) == set(jwdog.RULE_NAMES) == set(twdog.RULE_NAMES)
    assert list(jwdog.RULE_NAMES) == list(twdog.RULE_NAMES)


def _fold(mod, events, **kw):
    wd = mod.Watchdog(None, **kw)
    for e in events:
        wd.observe(dict(e))
    return wd


def _key(alerts):
    """The alerts without their message (the port's words may differ)."""
    return [{k: v for k, v in a.items() if k != "message"} for a in alerts]


def _both(events, **kw):
    j, t = _fold(jwdog, events, **kw), _fold(twdog, events, **kw)
    assert _key(t.alerts) == _key(j.alerts)
    assert t.health() == j.health()
    assert t.format_line().split(" — ")[0] == j.format_line().split(" — ")[0]
    return t


def _filler(n):
    return [{"kind": "marker", "i": i} for i in range(n)]


@pytest.mark.parametrize("mode", ["fires", "debounced", "refires"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule, mode):
    trigger, by_step = RULES[rule]
    events = trigger(100, True)
    if mode == "debounced":
        events = events + trigger(110, True)
    elif mode == "refires":
        later = 100 + 10 * DEBOUNCE
        events = events + (trigger(later, True) if by_step
                           else _filler(DEBOUNCE) + trigger(later, True))
    wd = _both(events)
    fired = [a for a in wd.alerts if a["rule"] == rule]
    assert len(fired) == (2 if mode == "refires" else 1), wd.alerts
    assert wd.health()["ok"] is False
    sev = "critical" if rule in ("nonfinite", "scale_collapse",
                                 "retrace_storm", "checkpoint_failed",
                                 "slo_exhausted") else "warning"
    assert fired[0]["severity"] == sev


@pytest.mark.parametrize("rule", ["step_time", "scale_collapse",
                                  "loader_stall", "retrace_storm",
                                  "memory_headroom"])
def test_thresholds_forwarded_as_jax_does(rule):
    """A threshold past the trigger silences the rule in both."""
    kw = {"step_time": dict(anomaly_factor=50.0),
          "scale_collapse": dict(max_skips=8, scale_floor=0.5),
          "loader_stall": dict(stall_pct=90.0),
          "retrace_storm": dict(storm_count=9),
          "memory_headroom": dict(min_headroom_pct=1.0)}[rule]
    wd = _both(RULES[rule][0](100, True), **kw)
    assert wd.health() == {"ok": True, "alerts": 0, "by_rule": {},
                           "worst": None}


def test_benign_shapes_raise_nothing():
    """An isolated skip, a finite loss, first captures, a short wait, a
    headroom above 10%: no alert in either package."""
    events = (_metrics(0, False)
              + [{"kind": "scale", "event": "skip", "step": 3,
                  "scale": 512.0},
                 {"kind": "scale", "event": "grow", "step": 4,
                  "scale": 1024.0},
                 {"kind": "retrace", "first": True, "new_sig": True,
                  "step": 0},
                 {"kind": "retrace", "first": False, "new_sig": False,
                  "step": 1},
                 {"kind": "memory", "peak_bytes": 50, "bytes_limit": 100},
                 {"kind": "memory", "peak_bytes": 50},
                 {"kind": "serving", "phase": "admit", "queue_wait": 0.1},
                 {"kind": "quant", "phase": "saturation", "exceeded": 2}])
    wd = _both(events)
    assert wd.health()["ok"] and wd.format_line() == "ok (0 alerts)"


def _random_events(seed, n=600):
    rng = np.random.RandomState(seed)
    kinds = ["metrics", "scale", "loader_wait", "window", "retrace",
             "checkpoint", "memory", "serving", "quant", "slo", "loader"]
    out, step, t = [], 0, 0.0
    for _ in range(n):
        kind = kinds[rng.randint(len(kinds))]
        t += float(rng.exponential(0.05))
        e = {"kind": kind, "t": round(t, 6)}
        if kind == "metrics":
            loss = rng.randn(2).tolist()
            if rng.rand() < 0.05:
                loss[1] = math.inf
            e.update(step=step, n_valid=2, loss=loss)
            step += 2
        elif kind == "scale":
            e.update(event="skip" if rng.rand() < 0.7 else "grow",
                     step=step + int(rng.randint(3)),
                     scale=float(2.0 ** rng.randint(0, 16)))
        elif kind == "loader_wait":
            e.update(dur=float(rng.rand() * 0.1), qdepth=0)
        elif kind == "window":
            e.update(step=step, n_valid=2,
                     dur=float(rng.choice([0.01, 0.011, 0.2])), gap=0.001)
        elif kind == "retrace":
            e.update(step=step, first=bool(rng.rand() < 0.2),
                     new_sig=bool(rng.rand() < 0.8))
        elif kind == "checkpoint":
            e.update(phase=str(rng.choice(["snapshot", "backlog", "error",
                                           "commit"])),
                     step=step, dur=float(rng.rand() * 4), value=1,
                     error="x")
        elif kind == "memory":
            e.update(peak_bytes=int(rng.randint(100)), bytes_limit=100)
        elif kind == "serving":
            e.update(phase="admit", queue_wait=float(rng.rand() * 3))
        elif kind == "quant":
            e.update(phase="saturation", name="s", exceeded=int(
                rng.randint(8)), step=step)
        elif kind == "slo":
            e.update(phase="eval", burn_short=float(rng.rand() * 3),
                     burn_long=float(rng.rand() * 3),
                     exhausted=bool(rng.rand() < 0.1), goodput_pct=90.0,
                     target_pct=99.0, bad=1, n=10)
        else:
            e.update(stats={"loader_stall_pct": float(rng.rand() * 60)})
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_mix_matches_jax(seed):
    wd = _both(_random_events(seed))
    assert wd.alerts, "the mix should trip some rule"


@pytest.mark.parametrize("debounce", [1, 16, 256])
def test_debounce_window_matches_jax(debounce):
    wd = _both(_random_events(7), debounce_steps=debounce)
    assert wd.debounce_steps == debounce
