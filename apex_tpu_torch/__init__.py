"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The JAX package ``apex_tpu`` is the reference; this package mirrors its
module names (``normalization.fused_layer_norm``, ``ops.flash_attention``,
``models.gpt``, ``serving.engine``, ...) so each piece has a counterpart
to be read and tested against.  It imports ``torch`` and never JAX.

Every kernel that the JAX package writes in Pallas for the TPU is a
kernel written by hand here (CUDA C++ for ``sm_90a`` under ``csrc/``,
or Triton), with a plain PyTorch version beside it.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

Entry points (models, the serving engine and its CLI, the LM trainer
``python -m apex_tpu_torch.examples.lm.main_amp``) run on CUDA unless
the caller passes ``device="cpu"``; without a GPU they raise.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
