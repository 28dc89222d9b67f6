"""The persistent per-card kernel-config cache.

Counterpart of ``apex_tpu/tune/store.py``, in its file format: one JSON
file, ``tune_configs.json`` (schema 1), whose entries are keyed
``device|kernel|vN|bucket``.  The device is :func:`device_kind`, the CUDA
device's name with spaces collapsed (``NVIDIA_H100_80GB_HBM3``), so an
entry written for a TPU, or for another card, never matches here; a
kernel that changes what its tile means bumps its ``TUNE_VERSION`` and
its old entries stop matching (:func:`prune_stale` drops them).

Where the file lives: an explicit path, then ``APEX_TPU_TUNE_CACHE``,
then the directory :func:`set_default_dir` installed
(:func:`apex_tpu_torch.cache.enable` points it at the compilation-cache
directory), then ``~/.cache/apex_tpu``.

The cache can never break a run: a corrupt or truncated file, a partial
entry or a newer schema falls back to the kernels' rules, announced once
per path on stderr; every read swallows unexpected errors; a write is
read-modify-write with an atomic ``os.replace``.  The in-memory view is
memoized per path; ``_STATE["gen"]`` counts its changes, so
:mod:`apex_tpu_torch.tune.dispatch` can drop its own memo when the
store's moves.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CACHE_FILENAME", "SCHEMA", "cache_path", "set_default_dir",
           "device_kind", "load", "lookup", "put", "entries",
           "prune_stale", "key_for"]

CACHE_FILENAME = "tune_configs.json"
#: schema of the on-disk file; a future major reads as corrupt (the
#: rules, announced) rather than misread
SCHEMA = 1

_lock = threading.Lock()
_STATE: Dict[str, Any] = {
    "dir": None,          # set_default_dir() override (cache.enable)
    "memo_path": None,    # path the memoized data was loaded from
    "memo": None,         # {"schema": 1, "entries": {...}}
    "warned": set(),      # paths already warned about (loudly-once)
    "gen": 0,             # bumped whenever the memo changes
}


def _set_memo(path, data) -> None:
    _STATE["memo_path"], _STATE["memo"] = path, data
    _STATE["gen"] += 1


def set_default_dir(path: Optional[str]) -> None:
    """Point the default cache location at ``path`` (a directory);
    drops the memo when the location changes."""
    with _lock:
        path = os.path.abspath(os.path.expanduser(path)) if path else None
        if _STATE["dir"] != path:
            _STATE["dir"] = path
            _set_memo(None, None)


def cache_path(path: Optional[str] = None) -> str:
    """The cache file: an explicit ``path`` (a file, or a directory to
    hold :data:`CACHE_FILENAME`) wins, then ``APEX_TPU_TUNE_CACHE``, then
    :func:`set_default_dir`'s directory, then ``~/.cache/apex_tpu``."""
    cand = path or os.environ.get("APEX_TPU_TUNE_CACHE") or _STATE["dir"] \
        or os.path.join("~", ".cache", "apex_tpu")
    cand = os.path.abspath(os.path.expanduser(cand))
    if os.path.isdir(cand) or not cand.endswith(".json"):
        cand = os.path.join(cand, CACHE_FILENAME)
    return cand


def device_kind() -> str:
    """The cache key's device: ``torch.cuda.get_device_name()`` with
    spaces collapsed to ``_`` (``NVIDIA_H100_80GB_HBM3``), or ``cpu``
    without a card."""
    try:
        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name()).strip().replace(" ",
                                                                     "_")
    except Exception:
        pass
    return "cpu"


def key_for(kernel: str, version: int, bucket: str,
            dev_kind: Optional[str] = None) -> str:
    """The flat entry key: ``device|kernel|vN|bucket``."""
    return "|".join([dev_kind or device_kind(), kernel,
                     f"v{int(version)}", bucket])


def _warn_once(path: str, msg: str) -> None:
    if path in _STATE["warned"]:
        return
    _STATE["warned"].add(path)
    print(f"apex_tpu_torch.tune: {msg} ({path}) — falling back to built-in "
          f"default configs", file=sys.stderr)


def _read_file(path: str) -> Dict[str, Any]:
    """Parse the cache file; corrupt, partial or future-schema content
    is announced once and read as empty."""
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {"schema": SCHEMA, "entries": {}}
    except (OSError, ValueError) as e:
        _warn_once(path, f"config cache unreadable/corrupt "
                         f"({type(e).__name__}: {e})")
        return {"schema": SCHEMA, "entries": {}}
    if not isinstance(raw, dict) or not isinstance(raw.get("entries"), dict):
        _warn_once(path, "config cache has no entries table")
        return {"schema": SCHEMA, "entries": {}}
    try:
        schema = int(raw.get("schema", 0))
    except (TypeError, ValueError):
        schema = SCHEMA + 1
    if schema > SCHEMA:
        _warn_once(path, f"config cache schema {raw.get('schema')} is "
                         f"newer than this build understands ({SCHEMA})")
        return {"schema": SCHEMA, "entries": {}}
    ents = {key: ent for key, ent in raw["entries"].items()
            if isinstance(ent, dict) and isinstance(ent.get("config"), dict)}
    if len(ents) != len(raw["entries"]):
        _warn_once(path, f"{len(raw['entries']) - len(ents)} partial "
                         f"config-cache entr(ies) skipped")
    return {"schema": SCHEMA, "entries": ents}


def load(path: Optional[str] = None, *, reload: bool = False
         ) -> Dict[str, Any]:
    """The cache's in-memory view (memoized per path); ``reload=True``
    reads the file again (what a restart does)."""
    p = cache_path(path)
    with _lock:
        if not reload and _STATE["memo_path"] == p \
                and _STATE["memo"] is not None:
            return _STATE["memo"]
        data = _read_file(p)
        _set_memo(p, data)
        return data


def lookup(kernel: str, version: int, bucket: str, *,
           dev_kind: Optional[str] = None,
           path: Optional[str] = None) -> Optional[Dict[str, int]]:
    """The cached config for this key, or None (a miss, a stale version,
    another device, an unreadable cache).  Never raises."""
    try:
        data = load(path)
        ent = data["entries"].get(key_for(kernel, version, bucket, dev_kind))
        return dict(ent["config"]) if ent else None
    except Exception:           # the cache must never break dispatch
        return None


def _write(p: str, data: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(p), exist_ok=True)
    tmp = f"{p}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, p)


def put(kernel: str, version: int, bucket: str,
        config: Dict[str, int], *,
        meta: Optional[Dict[str, Any]] = None,
        dev_kind: Optional[str] = None,
        path: Optional[str] = None) -> str:
    """Persist one tuned config (read-modify-write, atomic replace);
    returns its key.  The memo is refreshed, so the writing process
    dispatches its own result at once."""
    p = cache_path(path)
    with _lock:
        data = _read_file(p)
        key = key_for(kernel, version, bucket, dev_kind)
        data["entries"][key] = {
            "kernel": kernel, "version": int(version), "bucket": bucket,
            "device_kind": dev_kind or device_kind(),
            "config": dict(config), "meta": dict(meta or {}),
        }
        _write(p, data)
        _set_memo(p, data)
        return key


def entries(path: Optional[str] = None,
            dev_kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every cached entry (optionally of one device kind), sorted by key,
    each with its ``key``: the CLI's ``show`` table."""
    data = load(path)
    out = []
    for key in sorted(data["entries"]):
        ent = dict(data["entries"][key])
        if dev_kind and ent.get("device_kind") != dev_kind:
            continue
        ent["key"] = key
        out.append(ent)
    return out


def prune_stale(current_versions: Dict[str, int],
                path: Optional[str] = None) -> int:
    """Drop the entries whose kernel is in ``current_versions`` with
    another version; returns how many went."""
    p = cache_path(path)
    with _lock:
        data = _read_file(p)
        stale = [k for k, e in data["entries"].items()
                 if e.get("kernel") in current_versions
                 and int(e.get("version", -1))
                 != int(current_versions[e["kernel"]])]
        for k in stale:
            del data["entries"][k]
        if stale:
            _write(p, data)
        _set_memo(p, data)
        return len(stale)
