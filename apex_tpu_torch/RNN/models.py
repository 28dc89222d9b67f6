"""Stacked and bidirectional RNNs and their factories — counterpart of
``apex_tpu/RNN/models.py`` (reference ``apex/RNN/models.py`` and
``RNNBackend.py``'s ``stackedRNN``/``bidirectionalRNN``).

The time loop is a Python loop over T (JAX's ``nn.scan``), and the
hidden state is explicit: pass ``initial_states`` and get the final
states back.  Layout is time-major ``[T, B, F]`` (``batch_first=True``
transposes at the boundary).  Layers are ``layer{i}``, the two stacks
of a bidirectional RNN ``fwd`` and ``bwd``, the output projection
``proj``, as JAX names them.  Inter-layer dropout (``train=True``)
draws its masks from the ``generator`` the forward is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
from torch import nn

from .._device import resolve_device
from .cells import (Dense, GRUCell, LSTMCell, RNNReLUCell, RNNTanhCell,
                    mLSTMCell)


def _dropout(x, rate: float, generator: Optional[torch.Generator]):
    """flax ``Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``."""
    if generator is None:
        raise ValueError("dropout in training needs generator= (a "
                         "torch.Generator on the input's device)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class stackedRNN(nn.Module):
    """``num_layers`` cells stacked, looped over time (reference
    ``stackedRNN.forward``, with the inter-layer dropout and the
    ``reverse`` flag of the bidirectional wrapper)."""

    def __init__(self, cell_cls: Type[nn.Module], input_size: int,
                 hidden_size: int, num_layers: int = 1, bias: bool = True,
                 dropout: float = 0.0, output_size: Optional[int] = None,
                 batch_first: bool = False,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cell_cls = cell_cls
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.output_size = output_size
        self.batch_first = batch_first
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"layer{i}", cell_cls(
                input_size if i == 0 else hidden_size, hidden_size, bias,
                dtype, device=dev, generator=generator))
        if output_size is not None and output_size != hidden_size:
            # the reference RNNCell's w_ho projection
            self.proj = Dense(hidden_size, output_size, True, dtype,
                              device=dev, generator=generator)
        else:
            self.proj = None

    def _zero_carry(self, x):
        zeros = torch.zeros((x.shape[1], self.hidden_size),
                            dtype=torch.float32, device=x.device)
        return tuple(zeros for _ in range(self.cell_cls.n_hidden_states()))

    def forward(self, inputs, initial_states: Optional[Sequence] = None, *,
                reverse: bool = False, train: bool = False,
                collect_hidden: bool = False,
                generator: Optional[torch.Generator] = None):
        """``inputs`` ``[T, B, F]`` (``[B, T, F]`` if ``batch_first``).
        Returns ``(outputs [T, B, H], final_states)``, the final states a
        list of per-layer carries ``(h,)`` or ``(h, c)``; with
        ``collect_hidden=True`` every timestep's states a layer instead
        (each ``[T, B, H]``)."""
        x = inputs.transpose(0, 1) if self.batch_first else inputs
        if reverse:
            x = torch.flip(x, dims=(0,))
        finals = []
        for i in range(self.num_layers):
            cell = getattr(self, f"layer{i}")
            carry = (self._zero_carry(x) if initial_states is None
                     else tuple(initial_states[i]))
            outs, states = [], []
            for t in range(x.shape[0]):
                carry, out = cell(carry, x[t])
                outs.append(out)
                if collect_hidden:
                    states.append(carry)
            x = torch.stack(outs)
            finals.append(tuple(torch.stack(s) for s in zip(*states))
                          if collect_hidden else carry)
            if self.dropout > 0 and train and i < self.num_layers - 1:
                x = _dropout(x, self.dropout, generator)
        if self.proj is not None:
            x = self.proj(x)
        if reverse:
            x = torch.flip(x, dims=(0,))
        if self.batch_first:
            x = x.transpose(0, 1)
        return x, finals


class bidirectionalRNN(nn.Module):
    """A forward and a reverse stack (``fwd``, ``bwd``), their outputs
    concatenated on the features (reference ``bidirectionalRNN``)."""

    def __init__(self, cell_cls, input_size, hidden_size, num_layers=1,
                 bias=True, dropout=0.0, output_size=None,
                 batch_first=False, dtype=torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(num_layers=num_layers, bias=bias, dropout=dropout,
                  output_size=output_size, batch_first=batch_first,
                  dtype=dtype, device=device, generator=generator)
        self.fwd = stackedRNN(cell_cls, input_size, hidden_size, **kw)
        self.bwd = stackedRNN(cell_cls, input_size, hidden_size, **kw)

    def forward(self, inputs, initial_states=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        fwd_init = rev_init = None
        if initial_states is not None:
            fwd_init, rev_init = initial_states
        out_f, fin_f = self.fwd(inputs, fwd_init, train=train,
                                generator=generator)
        out_r, fin_r = self.bwd(inputs, rev_init, reverse=True, train=train,
                                generator=generator)
        return torch.cat([out_f, out_r], dim=-1), (fin_f, fin_r)


def _factory(cell_cls, input_size, hidden_size, num_layers, bias=True,
             batch_first=False, dropout=0.0, bidirectional=False,
             output_size=None, dtype=torch.float32, *, device=None,
             seed: int = 0):
    cls = bidirectionalRNN if bidirectional else stackedRNN
    return cls(cell_cls, input_size, hidden_size, num_layers, bias,
               dropout, output_size, batch_first, dtype, device=device,
               generator=torch.Generator().manual_seed(seed))


def _make(cell_cls, doc):
    def factory(input_size, hidden_size, num_layers, bias=True,
                batch_first=False, dropout=0.0, bidirectional=False,
                output_size=None, dtype=torch.float32, *, device=None,
                seed: int = 0):
        return _factory(cell_cls, input_size, hidden_size, num_layers, bias,
                        batch_first, dropout, bidirectional, output_size,
                        dtype, device=device, seed=seed)
    factory.__name__ = factory.__qualname__ = doc
    factory.__doc__ = (
        f"A ``{cell_cls.__name__}`` stack (``bidirectional=True``: a "
        f"``bidirectionalRNN``) with the reference's signature; parameters "
        f"made from ``torch.Generator().manual_seed(seed)`` and moved to "
        f"``device``.")
    return factory


LSTM = _make(LSTMCell, "LSTM")
GRU = _make(GRUCell, "GRU")
ReLU = _make(RNNReLUCell, "ReLU")
Tanh = _make(RNNTanhCell, "Tanh")
mLSTM = _make(mLSTMCell, "mLSTM")
