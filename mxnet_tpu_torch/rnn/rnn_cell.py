"""Symbolic RNN cells (the legacy ``mx.rnn`` API).

Counterpart of the JAX package's ``rnn/rnn_cell.py`` (reference:
python/mxnet/rnn/rnn_cell.py): cells build Symbol graphs step by step
and ``unroll`` lays the steps out over time, with the JAX package's node
and parameter names. As there, ``begin_state`` takes a concrete
``batch_size`` (the reference's 0 = unknown needs shape inference a
bound executor does not do), and ``FusedRNNCell`` is the unrolled unfused
cells (the JAX package's :353-400), not the ``RNN`` op, so its
parameters keep the per-gate names.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell"]


def _sym():
    from .. import symbol
    return symbol


class RNNParams(object):
    """Container holding a cell's shared weight Symbols (reference:
    rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = _sym().var(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract cell: ``cell(inputs, states) -> (output, new_states)``
    (reference: rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    @property
    def params(self):
        self._own_params = False
        return self._params

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    def begin_state(self, func=None, batch_size=1, **kwargs):
        """Initial states: ``func(name=..., shape=...)`` symbols
        (defaults to ``sym.zeros``)."""
        assert not self._modified, \
            "After applying modifier cells, call the modifier's begin_state"
        if func is None:
            func = _sym().zeros
        states = []
        for info in self.state_info:
            self._init_counter += 1
            shape = (batch_size,) + tuple(info["shape"][1:])
            states.append(func(
                name="%sbegin_state_%d" % (self._prefix,
                                           self._init_counter),
                shape=shape, **kwargs))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def _iter_inputs(self, length, inputs, layout):
        """Split ``inputs`` (one (N,T,C)/(T,N,C) symbol or a list of
        per-step symbols) into ``length`` step symbols (N, C)."""
        sym = _sym()
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != length:
                raise MXNetError("unroll: expected %d step inputs, got %d"
                                 % (length, len(inputs)))
            return list(inputs)
        axis = layout.find("T")
        sliced = sym.SliceChannel(inputs, num_outputs=length, axis=axis,
                                  squeeze_axis=True)
        return [sliced[i] for i in range(length)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size=1):
        """Unroll the cell over ``length`` steps (reference:
        rnn_cell.py:295). Returns (outputs, final_states); outputs is a
        stacked (N,T,C) symbol when ``merge_outputs`` else a list."""
        self.reset()
        sym = _sym()
        steps = self._iter_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs = []
        for x in steps:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            t_axis = layout.find("T")
            outputs = sym.stack(*outputs, axis=t_axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu cell: h' = act(W x + R h + b)
    (reference: rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        p = self._params
        self._iW = p.get("i2h_weight")
        self._iB = p.get("i2h_bias")
        self._hW = p.get("h2h_weight")
        self._hB = p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden,
                                 name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden,
                                 name=name + "h2h")
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name=name + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:408; gate order i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        p = self._params
        self._iW = p.get("i2h_weight")
        self._iB = p.get("i2h_bias")
        self._hW = p.get("h2h_weight")
        self._hB = p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        nh = self._num_hidden
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=4 * nh, name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=4 * nh, name=name + "h2h")
        gates = sym.SliceChannel(i2h + h2h, num_outputs=4,
                                 name=name + "slice")
        in_gate = sym.Activation(gates[0], act_type="sigmoid")
        forget_gate = sym.Activation(gates[1] + self._forget_bias,
                                     act_type="sigmoid")
        in_trans = sym.Activation(gates[2], act_type="tanh")
        out_gate = sym.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh",
                                           name=name + "state")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference: rnn_cell.py:469; gate order r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        p = self._params
        self._iW = p.get("i2h_weight")
        self._iB = p.get("i2h_bias")
        self._hW = p.get("h2h_weight")
        self._hB = p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        nh = self._num_hidden
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=3 * nh, name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=3 * nh, name=name + "h2h")
        ir, iz, inn = [sym.SliceChannel(i2h, num_outputs=3)[j]
                       for j in range(3)]
        hr, hz, hn = [sym.SliceChannel(h2h, num_outputs=3)[j]
                      for j in range(3)]
        reset = sym.Activation(ir + hr, act_type="sigmoid")
        update = sym.Activation(iz + hz, act_type="sigmoid")
        new = sym.Activation(inn + reset * hn, act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * new
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Stack cells vertically (reference: rnn_cell.py:748)."""

    def __init__(self, params=None):
        super(SequentialRNNCell, self).__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def reset(self):
        super(SequentialRNNCell, self).reset()
        for c in getattr(self, "_cells", ()):
            c.reset()

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size=1):
        """Layer-by-layer unroll (reference: rnn_cell.py:807): each
        child unrolls over the whole sequence before the next layer (which
        Bidirectional children need)."""
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        pos = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            last = i == len(self._cells) - 1
            inputs, st = cell.unroll(
                length, inputs, begin_state=begin_state[pos:pos + n],
                layout=layout,
                merge_outputs=merge_outputs if last else None,
                batch_size=batch_size)
            next_states.extend(st)
            pos += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout-on-output cell (reference: rnn_cell.py:827)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super(DropoutCell, self).__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = _sym().Dropout(inputs, p=self._dropout)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over opposite time directions and concatenate
    per-step outputs (reference: rnn_cell.py BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return (self._l_cell.begin_state(**kwargs) +
                self._r_cell.begin_state(**kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size=1):
        self.reset()
        sym = _sym()
        steps = self._iter_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        nl = len(self._l_cell.state_info)
        l_out, l_states = self._l_cell.unroll(
            length, steps, begin_state=begin_state[:nl], layout=layout,
            merge_outputs=False, batch_size=batch_size)
        r_out, r_states = self._r_cell.unroll(
            length, list(reversed(steps)), begin_state=begin_state[nl:],
            layout=layout, merge_outputs=False, batch_size=batch_size)
        r_out = list(reversed(r_out))
        outputs = [sym.Concat(l, r, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in enumerate(zip(l_out, r_out))]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=layout.find("T"))
        return outputs, l_states + r_states


class FusedRNNCell(BaseRNNCell):
    """API twin of the reference's cuDNN-fused cell (rnn_cell.py:536),
    as the JAX package builds it: ``num_layers`` of (optionally
    bidirectional) unfused cells, with DropoutCells between them,
    unrolled."""

    _MODES = {"rnn_relu": (RNNCell, {"activation": "relu"}),
              "rnn_tanh": (RNNCell, {"activation": "tanh"}),
              "lstm": (LSTMCell, {}),
              "gru": (GRUCell, {})}

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None,
                 params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super(FusedRNNCell, self).__init__(prefix=prefix, params=params)
        if mode not in self._MODES:
            raise MXNetError("FusedRNNCell: unknown mode %r" % mode)
        cls, kw = self._MODES[mode]
        self._stack = SequentialRNNCell(params=self._params)
        for i in range(num_layers):
            if bidirectional:
                cell = BidirectionalCell(
                    cls(num_hidden, prefix="%sl%d_" % (prefix, i), **kw),
                    cls(num_hidden, prefix="%sr%d_" % (prefix, i), **kw),
                    output_prefix="%sbi_l%d_" % (prefix, i))
            else:
                cell = cls(num_hidden, prefix="%sl%d_" % (prefix, i), **kw)
            self._stack.add(cell)
            if dropout > 0 and i != num_layers - 1:
                self._stack.add(DropoutCell(
                    dropout, prefix="%sdrop%d_" % (prefix, i)))

    @property
    def state_info(self):
        return self._stack.state_info

    def begin_state(self, **kwargs):
        return self._stack.begin_state(**kwargs)

    def __call__(self, inputs, states):
        return self._stack(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size=1):
        return self._stack.unroll(length, inputs,
                                  begin_state=begin_state, layout=layout,
                                  merge_outputs=merge_outputs,
                                  batch_size=batch_size)
