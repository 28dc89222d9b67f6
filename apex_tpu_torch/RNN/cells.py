"""RNN cells, one step each: ``cell(carry, x) -> (carry, out)`` —
counterpart of ``apex_tpu/RNN/cells.py`` (reference ``apex/RNN/cells.py``
and the torch cells ``RNNBackend.py`` drives).

The gate products run in the module's ``dtype`` (input and weight cast
to it, as flax's ``Dense(dtype=)`` casts them); the gate math is done in
fp32 and the cell state is carried in fp32.  The products are plain
matrix products outside any kernel, as in JAX.  Sub-layer names are
JAX's (``ih``, ``hh``; the GRU's ``ih_rz``, ``hh_rz``, ``ih_n``,
``hh_n``; the mLSTM's ``mih``, ``mhh``), each an ``nn.Linear`` whose
``weight`` is the flax kernel transposed (:mod:`apex_tpu_torch.convert`,
``rnn_params_from_jax``).  Parameters are fp32, made on the CPU from a
``torch.Generator`` with flax's initializers (lecun-normal weights, zero
biases) and moved to ``device``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..models.bert import lecun_normal_


class Dense(nn.Linear):
    """flax ``Dense`` as an ``nn.Linear``: input, weight and bias cast to
    ``dtype`` for the product, which comes out in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias)
        with torch.no_grad():
            lecun_normal_(self.weight, in_features, generator)
            if bias:
                self.bias.zero_()
        self.to(resolve_device(device))
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class _Cell(nn.Module):
    #: hidden states a carry holds: (h,) or (h, c)
    n_states = 1

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.dtype = dtype
        self._kw = dict(dtype=dtype, device=device, generator=generator)

    def _dense(self, n_in: int, n_out: int, bias: bool) -> Dense:
        return Dense(n_in, n_out, bias, **self._kw)

    @classmethod
    def n_hidden_states(cls) -> int:
        return cls.n_states


class RNNReLUCell(_Cell):
    """h' = relu(W_ih x + W_hh h + b), the activation in ``dtype``."""
    act = staticmethod(torch.relu)

    def __init__(self, input_size, hidden_size, bias=True,
                 dtype=torch.float32, **kw):
        super().__init__(input_size, hidden_size, bias, dtype, **kw)
        self.ih = self._dense(input_size, hidden_size, bias)
        self.hh = self._dense(hidden_size, hidden_size, bias)

    def forward(self, carry, x):
        (h,) = carry
        g = self.ih(x) + self.hh(h.to(self.dtype))
        h = self.act(g).float()
        return (h,), h


class RNNTanhCell(RNNReLUCell):
    act = staticmethod(torch.tanh)


def _lstm_update(gates, c):
    i, f, g, o = torch.chunk(gates.float(), 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


class LSTMCell(_Cell):
    n_states = 2

    def __init__(self, input_size, hidden_size, bias=True,
                 dtype=torch.float32, **kw):
        super().__init__(input_size, hidden_size, bias, dtype, **kw)
        self.ih = self._dense(input_size, 4 * hidden_size, bias)
        self.hh = self._dense(hidden_size, 4 * hidden_size, bias)

    def forward(self, carry, x):
        h, c = carry
        return _lstm_update(self.ih(x) + self.hh(h.to(self.dtype)), c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, bias=True,
                 dtype=torch.float32, **kw):
        super().__init__(input_size, hidden_size, bias, dtype, **kw)
        self.ih_rz = self._dense(input_size, 2 * hidden_size, bias)
        self.hh_rz = self._dense(hidden_size, 2 * hidden_size, bias)
        self.ih_n = self._dense(input_size, hidden_size, bias)
        self.hh_n = self._dense(hidden_size, hidden_size, bias)

    def forward(self, carry, x):
        (h,) = carry
        hd = h.to(self.dtype)
        rz = torch.sigmoid((self.ih_rz(x) + self.hh_rz(hd)).float())
        r, z = torch.chunk(rz, 2, dim=-1)
        n = torch.tanh(self.ih_n(x).float() + r * self.hh_n(hd).float())
        h = (1.0 - z) * n + z * h
        return (h,), h


class mLSTMCell(_Cell):
    """Multiplicative LSTM (reference ``mLSTMCell``): ``m = (W_mih x) *
    (W_mhh h)``, gates ``W_ih x + W_hh m``."""
    n_states = 2

    def __init__(self, input_size, hidden_size, bias=True,
                 dtype=torch.float32, **kw):
        super().__init__(input_size, hidden_size, bias, dtype, **kw)
        self.mih = self._dense(input_size, hidden_size, False)
        self.mhh = self._dense(hidden_size, hidden_size, False)
        self.ih = self._dense(input_size, 4 * hidden_size, bias)
        self.hh = self._dense(hidden_size, 4 * hidden_size, bias)

    def forward(self, carry, x):
        h, c = carry
        m = self.mih(x) * self.mhh(h.to(self.dtype))
        return _lstm_update(self.ih(x) + self.hh(m), c)
