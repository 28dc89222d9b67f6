"""apex_tpu_torch.quant — the int8 path (amp O4): counterpart of
``apex_tpu/quant``.

* :mod:`.kernels` — the CUDA quantized matmul (x quantized to int8 in
  the kernel, int8 x int8 -> int32 on the tensor cores, the dequantize
  epilogue), its plain version, and the straight-through backward;
* :mod:`.calibrate` — the observation history and the frozen scales,
  whose ``state_dict`` is the JAX package's;
* :mod:`.layers` — :class:`QuantDenseGeneral`, the parameter-compatible
  projection the models' ``quant=`` argument selects;
* the int8 KV cache lives with its pool in
  :mod:`apex_tpu_torch.serving.kv_cache` (``cache_dtype=torch.int8``).

Recipe::

    from apex_tpu_torch import quant
    from apex_tpu_torch.models import gpt2_small

    obs = gpt2_small(dtype=torch.bfloat16, quant=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    with torch.no_grad():
        for batch in observation_batches:
            obs(batch)
            cal.harvest(quant.quant_stats(obs))
    calibration = cal.freeze()                 # or cal.freeze(99.9)

    model = gpt2_small(dtype=torch.bfloat16,
                       quant=quant.QuantConfig.frozen(calibration))
    model.load_state_dict(obs.state_dict())   # the same parameters
    init_fn, step_fn = training.make_train_step(loss_fn, tx,
                                                opt_level="O4")
"""

from .calibrate import Calibration, Calibrator      # noqa: F401
from .kernels import (amax_to_scale, channel_scale, dequantize,  # noqa: F401
                      quantize, quantized_matmul, quantized_matmul_ref,
                      saturation_count)
from .layers import (QuantConfig, QuantDenseGeneral,  # noqa: F401
                     name_quant_sites, quant_stats)

__all__ = ["Calibration", "Calibrator", "QuantConfig",
           "QuantDenseGeneral", "amax_to_scale", "channel_scale",
           "dequantize", "quantize", "quantized_matmul",
           "quantized_matmul_ref", "saturation_count"]
