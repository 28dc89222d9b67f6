"""Optimizers: the functional Adam of the training step."""

from .functional import AdamState, adam_init, adam_update

__all__ = ["AdamState", "adam_init", "adam_update"]
