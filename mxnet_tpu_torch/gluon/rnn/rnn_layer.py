"""Gluon fused recurrent layers: RNN, LSTM, GRU.

Counterpart of the JAX package's ``gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py): the parameters are kept per layer
and direction under the JAX package's names
(``{l,r}{i}_{i2h,h2h}_{weight,bias}``, LSTMP's ``{l,r}{i}_h2r_weight``)
and concatenated at each call into the ``RNN`` op's flat vector (per
layer and direction W, R, bW, bR[, P]), which the op runs on cuDNN on the
card. The layer runs eagerly on NDArrays, or as part of a hybridized
block's traced Symbol (``F.RNN`` a node of the graph, replayed inside the
block's CUDA graphs on the card).
"""
from __future__ import annotations

from ..block import HybridBlock, _is_symbol
from ..nn.basic_layers import _init

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super(_RNNLayer, self).__init__(**kwargs)
        assert layout in ("TNC", "NTC"), "Invalid layout %s" % layout
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        hout = projection_size if projection_size else hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param("%s%d_h2h_weight" % (j, i),
                                     (ng * nh, hout), h2h_weight_initializer)
                self._register_param("%s%d_i2h_bias" % (j, i), (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param("%s%d_h2h_bias" % (j, i), (ng * nh,),
                                     h2h_bias_initializer)
                if projection_size:
                    self._register_param("%s%d_h2r_weight" % (j, i),
                                         (projection_size, nh),
                                         h2h_weight_initializer)
            ni = hout * self._dir

    def _register_param(self, name, shape, init_arg):
        p = self.params.get(name, shape=shape, init=_init(init_arg),
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        mapping = "%s -> %s" % (self._input_size or None, self._hidden_size)
        return "%s(%s, %s, layers=%s%s)" % (
            self.__class__.__name__, mapping, self._layout, self._num_layers,
            ", bidirectional" if self._dir == 2 else "")

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, x, *args):
        ni = x.shape[2]
        hout = self._projection_size or self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._reg_params["%s%d_i2h_weight" % (j, i)]._set_shape_from(
                    (self._gates * self._hidden_size, ni))
            ni = hout * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, ``func(shape=..., **kwargs)`` each (default
        ``nd.zeros``; pass ``ctx=`` for the device)."""
        from ... import ndarray as nd
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **kwargs))
        return states

    def _zero_states(self, F, inputs):
        """Zero states for (T, N, C) ``inputs``: on their device, or shaped
        from them in a trace."""
        if not _is_symbol(inputs):
            return self.begin_state(inputs.shape[1], ctx=inputs.context)
        x0 = F.slice_axis(F.slice_axis(inputs, axis=0, begin=0, end=1),
                          axis=2, begin=0, end=1)
        z = F.zeros_like(x0)
        return [F.broadcast_axis(z, axis=(0, 2), size=(s[0], s[2]))
                for s in (info["shape"] for info in self.state_info(0))]

    def hybrid_forward(self, F, inputs, *states, **params):
        """``outputs`` without ``states``, else ``[outputs, *new
        states]`` (``__call__`` nests them as ``(outputs, states)``)."""
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        skip_states = not states
        if skip_states:
            states = self._zero_states(F, inputs)
        kwargs = dict(state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2, mode=self._mode,
                      p=self._dropout, state_outputs=True)
        if self._projection_size:
            kwargs["projection_size"] = self._projection_size
        out = F.RNN(inputs, self._flatten_params(F, params), *states,
                    **kwargs)
        n_out = 3 if self._mode == "lstm" else 2
        outputs = out[0]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return [outputs] + [out[i] for i in range(1, n_out)]

    def _flatten_params(self, F, params):
        """The op's flat vector: per layer and direction W, R, bW, bR[, P]
        (the JAX package's layout)."""
        chunks = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                chunks.append(F.reshape(params["%s%d_i2h_weight" % (j, i)],
                                        shape=(-1,)))
                chunks.append(F.reshape(params["%s%d_h2h_weight" % (j, i)],
                                        shape=(-1,)))
                chunks.append(params["%s%d_i2h_bias" % (j, i)])
                chunks.append(params["%s%d_h2h_bias" % (j, i)])
                if self._projection_size:
                    chunks.append(F.reshape(
                        params["%s%d_h2r_weight" % (j, i)], shape=(-1,)))
        return F.Concat(*chunks, dim=0)

    def __call__(self, inputs, states=None):
        """``layer(x)`` gives the outputs, ``layer(x, states)`` the
        outputs and the final states (a list); the states go to
        ``forward`` as further inputs, so a hybridized layer traces and
        replays them with the sequence."""
        if states is None:
            return super(_RNNLayer, self).__call__(inputs)
        if not isinstance(states, (list, tuple)):
            states = [states]
        out = super(_RNNLayer, self).__call__(inputs, *states)
        return out[0], list(out[1:])


class RNN(_RNNLayer):
    """Elman RNN layer (reference: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super(RNN, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer,
            "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM layer (reference: rnn_layer.py LSTM); ``projection_size``
    makes it an LSTMP."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super(LSTM, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "lstm",
            projection_size=projection_size, **kwargs)

    def state_info(self, batch_size=0):
        hout = self._projection_size or self._hidden_size
        return [{"shape": (self._num_layers * self._dir, batch_size, hout),
                 "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU layer (reference: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super(GRU, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
