"""Convolutional recurrent cells.

Counterpart of the JAX package's ``gluon/contrib/rnn/conv_rnn_cell.py``
(reference: gluon/contrib/rnn/conv_rnn_cell.py; Shi et al. 2015
ConvLSTM), on the port's ``Convolution`` (cuDNN on the card). The
input-to-hidden and hidden-to-hidden transforms are convolutions, so
states carry spatial structure: state shape = (batch, hidden_channels,
*spatial)."""
from __future__ import annotations

from ...nn.basic_layers import _init
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(x, n):
    if isinstance(x, int):
        return (x,) * n
    assert len(x) == n
    return tuple(x)


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared conv-recurrent plumbing (reference:
    conv_rnn_cell.py:37 _BaseConvRNNCell)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad, activation, n_gates, dims,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super(_BaseConvRNNCell, self).__init__(prefix=prefix,
                                               params=params)
        self._dims = dims
        self._input_shape = tuple(input_shape)   # (C_in, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._n_gates = n_gates
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            assert k % 2 == 1, \
                "h2h kernel must be odd to preserve the state's " \
                "spatial shape (got %s)" % (self._h2h_kernel,)
        self._i2h_pad = _tup(i2h_pad, dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        c_in = self._input_shape[0]
        out_ch = n_gates * hidden_channels
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(out_ch, c_in) + self._i2h_kernel,
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(out_ch, hidden_channels) + self._h2h_kernel,
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(out_ch,),
            init=_init(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(out_ch,),
            init=_init(h2h_bias_initializer), allow_deferred_init=True)

    def _state_spatial(self):
        # i2h conv with stride 1: spatial' = spatial + 2*pad - k + 1
        return tuple(s + 2 * p - k + 1 for s, p, k in
                     zip(self._input_shape[1:], self._i2h_pad,
                         self._i2h_kernel))

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial()
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}]

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        out_ch = self._n_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=out_ch)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=out_ch)
        return i2h, h2h

    def infer_shape(self, x):
        pass                                     # shapes are explicit


class _ConvRNNCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, activation="tanh", dims=2,
                 **kwargs):
        super(_ConvRNNCell, self).__init__(
            input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad, activation, n_gates=1, dims=dims, **kwargs)

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, activation="tanh", dims=2,
                 **kwargs):
        super(_ConvLSTMCell, self).__init__(
            input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad, activation, n_gates=4, dims=dims, **kwargs)

    def _alias(self):
        return "conv_lstm"

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial()
        layout = "NC" + "DHW"[-self._dims:]
        return [{"shape": shape, "__layout__": layout},
                {"shape": shape, "__layout__": layout}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.Activation(slices[2],
                                    act_type=self._activation)
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c,
                                         act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, activation="tanh", dims=2,
                 **kwargs):
        super(_ConvGRUCell, self).__init__(
            input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad, activation, n_gates=3, dims=dims, **kwargs)

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_s[0] + h2h_s[0])
        update = F.sigmoid(i2h_s[1] + h2h_s[1])
        new = F.Activation(i2h_s[2] + reset * h2h_s[2],
                           act_type=self._activation)
        next_h = update * states[0] + (1.0 - update) * new
        return next_h, [next_h]


def _make(base, dims, doc_kind):
    class _Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, activation="tanh", **kwargs):
            super(_Cell, self).__init__(input_shape, hidden_channels,
                                        i2h_kernel, h2h_kernel,
                                        i2h_pad=i2h_pad,
                                        activation=activation,
                                        dims=dims, **kwargs)
    _Cell.__name__ = "Conv%dD%sCell" % (dims, doc_kind)
    _Cell.__qualname__ = _Cell.__name__
    _Cell.__doc__ = ("%dD convolutional %s cell (reference: gluon/"
                     "contrib/rnn/conv_rnn_cell.py Conv%dD%sCell)."
                     % (dims, doc_kind, dims, doc_kind))
    return _Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "RNN")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "RNN")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "RNN")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "LSTM")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "LSTM")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "LSTM")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "GRU")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "GRU")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "GRU")
