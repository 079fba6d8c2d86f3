"""Recurrent layers (port of ``paddle_tpu/nn/layers/rnn.py``).

The reference scans each layer and direction with one ``lax.scan``; here
:class:`RNN` is a loop over time in plain torch ops, one cell call a
step (a step launches a handful of kernels: the two products, the gate
activations and the state update). Inputs are ``[batch, time, size]``
unless ``time_major``.

What stays the reference's, so states and checkpoints cross unchanged:

- parameter names and layouts: ``rnns.<i>.cell.weight_ih`` (one
  direction) or ``rnns.<i>.rnn_fw.cell.weight_ih`` / ``rnn_bw`` (two),
  ``weight_ih`` ``[gates * hidden, input]``, ``weight_hh`` ``[gates *
  hidden, hidden]``, each drawn ``Uniform(±1/sqrt(hidden))``; gate order
  i, f, g, o (LSTM) and r, z, c with ``c = tanh(x_c + r * (W_hc h +
  b_hc))`` (GRU);
- final states: a layer returns its cell's state (``h``, or ``(h, c)``;
  ``(state_fw, state_bw)`` for two directions) and the multi-layer
  classes stack each leaf over the layers, ``[num_layers, B, H]``;
- ``sequence_length`` is accepted and not read;
- dropout applies between layers, in training mode only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ...framework.tree import tree_map
from ..initializer import Uniform, create_parameter
from .containers import LayerList

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_size, hidden_size,
                           dtype=torch.float32, device=None):
        return torch.zeros((batch_size, hidden_size), dtype=dtype,
                           device=device)

    def _weights(self, gates, input_size, hidden_size, device, generator):
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        kw = dict(default_initializer=init, device=device,
                  generator=generator)
        self.weight_ih = create_parameter((gates * hidden_size, input_size),
                                          **kw)
        self.weight_hh = create_parameter((gates * hidden_size, hidden_size),
                                          **kw)
        self.bias_ih = create_parameter((gates * hidden_size,), is_bias=True,
                                        **kw)
        self.bias_hh = create_parameter((gates * hidden_size,), is_bias=True,
                                        **kw)

    def _zeros(self, inputs):
        return self.get_initial_states(inputs.shape[0], self.hidden_size,
                                       inputs.dtype, inputs.device)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._weights(1, input_size, hidden_size, device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        pre = inputs @ self.weight_ih.T + self.bias_ih + \
            states @ self.weight_hh.T + self.bias_hh
        h = torch.tanh(pre) if self.activation == "tanh" else F.relu(pre)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._weights(4, input_size, hidden_size, device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        h, c = states
        gates = inputs @ self.weight_ih.T + self.bias_ih + \
            h @ self.weight_hh.T + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._weights(3, input_size, hidden_size, device, generator)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        gi = inputs @ self.weight_ih.T + self.bias_ih
        gh = h @ self.weight_hh.T + self.bias_hh
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h_new = (1.0 - z) * c + z * h
        return h_new, h_new


class RNN(nn.Module):
    """A cell run over the time axis: ``(outputs, final_state)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)  # [T, B, C]
        state = initial_states
        if state is None:
            z = torch.zeros((x.shape[1], self.cell.hidden_size),
                            dtype=x.dtype, device=x.device)
            state = (z, z) if isinstance(self.cell, LSTMCell) else z
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(x.shape[0])
        outputs = [None] * x.shape[0]
        for t in steps:
            outputs[t], state = self.cell(x[t], state)
        out = torch.stack(outputs)
        return (out if self.time_major else out.transpose(0, 1)), state


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(nn.Module):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        cell_cls = {"LSTM": LSTMCell, "GRU": GRUCell,
                    "RNN_TANH": SimpleRNNCell,
                    "RNN_RELU": SimpleRNNCell}[mode]
        extra = {"activation": "relu"} if mode == "RNN_RELU" else {}
        kw = dict(device=device, generator=generator, **extra)
        self.rnns = LayerList()
        for layer_i in range(num_layers):
            in_size = input_size if layer_i == 0 \
                else hidden_size * self.num_directions
            if bidirect:
                self.rnns.append(BiRNN(cell_cls(in_size, hidden_size, **kw),
                                       cell_cls(in_size, hidden_size, **kw),
                                       time_major))
            else:
                self.rnns.append(RNN(cell_cls(in_size, hidden_size, **kw),
                                     time_major=time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        final_states = []
        for i, rnn in enumerate(self.rnns):
            st = None if initial_states is None else tree_map(
                lambda t: t[i], initial_states)
            out, fs = rnn(out, st)
            final_states.append(fs)
            if self.dropout > 0 and i < self.num_layers - 1 and self.training:
                out = F.dropout(out, self.dropout, training=True)
        stacked = tree_map(lambda *ts: torch.stack(ts), *final_states)
        return out, stacked


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, generator=None,
                 **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, device=device,
                         generator=generator)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, generator=None, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         generator=generator)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, generator=None, **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         generator=generator)
