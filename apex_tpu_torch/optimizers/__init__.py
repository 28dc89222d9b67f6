"""Optimizers: the functional Adam and SGD of the training step."""

from .functional import (AdamState, SGDState, adam_init, adam_update,
                         sgd_init, sgd_update)

__all__ = ["AdamState", "SGDState", "adam_init", "adam_update", "sgd_init",
           "sgd_update"]
