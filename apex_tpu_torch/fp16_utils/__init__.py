"""Alias of :mod:`apex_tpu_torch.bf16_utils` under the reference's name
(``apex/fp16_utils``): "fp16" means bfloat16 here, as in the JAX
package."""

from ..bf16_utils import *  # noqa: F401,F403
from ..bf16_utils import __all__  # noqa: F401
