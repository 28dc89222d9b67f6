"""Contrib: the fused softmax cross-entropy (:mod:`.xentropy`) and the
NHWC GroupBN module (:mod:`.groupbn`)."""
