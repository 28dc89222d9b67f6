"""The process-wide amp state — counterpart of
``apex_tpu/amp/_amp_state.py`` (reference ``apex/amp/_amp_state.py``).

Holds the active ``Properties``, the per-loss scalers, the verbosity,
``hard_override`` (refusals become warnings) and the O1 policy's
switches.  Rank-0 printing reads ``RANK`` from the
environment, as ``torch.distributed`` launchers set it.
"""

from __future__ import annotations

import os


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.verbosity = 1
        self.opt_properties = None
        self.loss_scalers = []
        # the O1 policy (amp.autocast): consulted by its TorchFunctionMode
        self.autocast_enabled = False
        self.autocast_dtype = None
        self.allow_banned = False


_amp_state = AmpState()


def warn_or_err(msg):
    if _amp_state.hard_override:
        print("Warning: " + msg)
    else:
        raise RuntimeError(msg)


def maybe_print(msg, rank0=False):
    if _amp_state.verbosity > 0:
        if not rank0 or os.environ.get("RANK", "0") == "0":
            print(msg)


def master_params(optimizer):
    """The tensors an amp-wired optimizer updates, group by group: its
    fp32 masters at O2 (reference ``_amp_state.py:61-70``), else the
    model's parameters."""
    for group in optimizer.param_groups:
        yield from group["params"]
