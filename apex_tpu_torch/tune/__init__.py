"""apex_tpu_torch.tune — the per-card kernel-config tuner.

Counterpart of ``apex_tpu/tune``.  Every hand-written kernel of the port
runs one tile chosen by a rule; this package measures the tiles each
kernel family has on this card and keeps the winner per shape bucket:

* :mod:`~apex_tpu_torch.tune.registry` — a :class:`KernelSpec` per
  family (its config keys, candidates, legality check, oracle, the
  ledger regions it lives in); :mod:`~apex_tpu_torch.tune.kernels`
  registers the six: ``flash_attention``, ``conv2d``,
  ``fused_layer_norm``, ``bn_relu_residual``, ``xentropy``,
  ``quantized_matmul``;
* :mod:`~apex_tpu_torch.tune.measure` — times the legal candidates on
  the card (a CUDA graph of the calls replayed between CUDA events,
  build and first launch excluded, the minimum of ``reps`` passes), holds each against the rule's output (bit for
  bit where the family is exact, else its stated tolerance), and orders
  the search by a roofline ledger's verdict
  (:func:`~apex_tpu_torch.tune.measure.bound_from_ledger`);
* :mod:`~apex_tpu_torch.tune.store` — ``tune_configs.json`` in the JAX
  package's format, keyed by (card, kernel, version, bucket), beside
  :mod:`apex_tpu_torch.cache`'s directory when that is enabled;
* :mod:`~apex_tpu_torch.tune.dispatch` — the consult each kernel's
  wrapper makes on its kernel path, memoized in the process; a miss
  runs the rule.  Dispatch never tunes;
* :mod:`~apex_tpu_torch.tune.space` — the card's legality rules (shared
  memory per block, Triton's block limits) and the shape buckets.

CLI::

    python -m apex_tpu_torch.tune kernel flash_attention   # tune one
    python -m apex_tpu_torch.tune ledger LEDGER.json       # ledger-driven
    python -m apex_tpu_torch.tune show                     # cached table
    python -m apex_tpu_torch.tune prune                    # stale entries
"""

from . import space                                     # noqa: F401
from .dispatch import kernel_config, dispatch_stats     # noqa: F401
from .store import lookup, put, entries, cache_path     # noqa: F401

__all__ = ["space", "kernel_config", "dispatch_stats", "lookup", "put",
           "entries", "cache_path", "KernelSpec", "register", "get_spec",
           "all_specs", "load_builtin", "tune_kernel", "tune_from_ledger",
           "bound_from_ledger", "TuneResult"]

# The registry and measure layers import the kernel modules, which import
# tune.space and tune.dispatch: they load on first use, so a kernel
# module can import this package without a cycle.
_LAZY = {
    "KernelSpec": ("registry", "KernelSpec"),
    "register": ("registry", "register"),
    "get_spec": ("registry", "get_spec"),
    "all_specs": ("registry", "all_specs"),
    "load_builtin": ("registry", "load_builtin"),
    "tune_kernel": ("measure", "tune_kernel"),
    "tune_from_ledger": ("measure", "tune_from_ledger"),
    "bound_from_ledger": ("measure", "bound_from_ledger"),
    "TuneResult": ("measure", "TuneResult"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod_name, attr = _LAZY[name]
        mod = importlib.import_module("." + mod_name, __name__)
        val = getattr(mod, attr)
        globals()[name] = val
        return val
    raise AttributeError(
        "module 'apex_tpu_torch.tune' has no attribute {!r}".format(name))
