"""The RNN stack — counterpart of ``apex_tpu/RNN`` (reference
``apex/RNN``): the cells, ``stackedRNN``, ``bidirectionalRNN`` and the
``LSTM``/``GRU``/``ReLU``/``Tanh``/``mLSTM`` factories."""

from .cells import (GRUCell, LSTMCell, RNNReLUCell,       # noqa: F401
                    RNNTanhCell, mLSTMCell)
from .models import (GRU, LSTM, ReLU, Tanh,               # noqa: F401
                     bidirectionalRNN, mLSTM, stackedRNN)

__all__ = ["GRU", "GRUCell", "LSTM", "LSTMCell", "RNNReLUCell",
           "RNNTanhCell", "ReLU", "Tanh", "bidirectionalRNN", "mLSTM",
           "mLSTMCell", "stackedRNN"]
