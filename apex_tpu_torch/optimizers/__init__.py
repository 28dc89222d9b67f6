"""Optimizers: the fused optimizer classes (``FusedAdam``, ``FusedLAMB``,
``FusedNovoGrad``, ``FusedSGD``, ``FP16_Optimizer``), the functional
Adam, SGD, LAMB and NovoGrad they and the training step run (leafwise
or over a :class:`~apex_tpu_torch.multi_tensor.BucketStore`'s flat
buckets), and the ``(init, update)`` transforms."""

from . import functional
from .base import FusedOptimizer
from .fp16_optimizer import FP16_Optimizer
from .functional import (AdamState, LambState, NovoGradState, SGDState,
                         adam_init, adam_update, lamb_init, lamb_update,
                         novograd_init, novograd_update, sgd_init,
                         sgd_update)
from .fused_adam import FusedAdam
from .fused_lamb import FusedLAMB
from .fused_novograd import FusedNovoGrad
from .fused_sgd import FusedSGD
from .transforms import fused_adam, fused_lamb, fused_novograd, fused_sgd

__all__ = ["AdamState", "FP16_Optimizer", "FusedAdam", "FusedLAMB",
           "FusedNovoGrad", "FusedOptimizer", "FusedSGD", "LambState",
           "NovoGradState", "SGDState", "adam_init", "adam_update",
           "functional", "fused_adam", "fused_lamb", "fused_novograd",
           "fused_sgd", "lamb_init", "lamb_update", "novograd_init",
           "novograd_update", "sgd_init", "sgd_update"]
