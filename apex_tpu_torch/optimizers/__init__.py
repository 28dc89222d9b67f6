"""Optimizers: the functional Adam, SGD, LAMB and NovoGrad of the
training step, leafwise or over a :class:`~apex_tpu_torch.multi_tensor.
BucketStore`'s flat buckets (the fused optimizer classes wait)."""

from . import functional
from .functional import (AdamState, LambState, NovoGradState, SGDState,
                         adam_init, adam_update, lamb_init, lamb_update,
                         novograd_init, novograd_update, sgd_init,
                         sgd_update)

__all__ = ["AdamState", "LambState", "NovoGradState", "SGDState",
           "adam_init", "adam_update", "functional", "lamb_init",
           "lamb_update", "novograd_init", "novograd_update", "sgd_init",
           "sgd_update"]
