"""Gluon recurrent cells.

Counterpart of the JAX package's ``gluon/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/rnn_cell.py): RecurrentCell, RNNCell, LSTMCell,
GRUCell, SequentialRNNCell, DropoutCell, ZoneoutCell, ResidualCell,
BidirectionalCell, with the same parameter names (``i2h_weight``, ...)
and gate orders (LSTM i, f, c, o; GRU r, z, n). ``unroll`` lays the steps
out one after another. A cell steps on NDArrays (``F`` the ``ndarray``
namespace) or, inside a hybridized block's trace, on Symbols (``F`` the
``symbol`` namespace, each parameter its variable), so a hybridized net
that unrolls a cell runs as one traced graph; a Symbol sequence without
``begin_state`` starts from zeros shaped from its first step.
"""
from __future__ import annotations

from ..block import Block, HybridBlock, _is_symbol
from ..nn.basic_layers import _init

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _F(x):
    """The op namespace of ``x`` (a Symbol, an NDArray, or a list of
    them)."""
    if isinstance(x, (list, tuple)):
        x = x[0]
    if _is_symbol(x):
        from ... import symbol
        return symbol
    from ... import ndarray
    return ndarray


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """``(inputs, time axis, batch size)``: a tensor split into ``length``
    steps of (N, C) unless ``merge``, or a list of steps stacked when
    ``merge`` is True (reference: rnn_cell.py _format_sequence). A
    Symbol's batch size is unknown: 0."""
    assert layout in ("NTC", "TNC")
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if not isinstance(inputs, (list, tuple)):
        F = _F(inputs)
        batch_size = 0 if _is_symbol(inputs) else inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                length = inputs.shape[axis]
            parts = F.SliceChannel(inputs, num_outputs=length, axis=axis,
                                   squeeze_axis=True)
            inputs = [parts[i] for i in range(length)] if length > 1 \
                else [parts if not isinstance(parts, list) else parts[0]]
    else:
        assert length is None or len(inputs) == length
        batch_size = 0 if _is_symbol(inputs[0]) else inputs[0].shape[0]
        if merge is True:
            inputs = _stack(inputs, axis)
    return inputs, axis, batch_size


def _stack(arrays, axis):
    return _F(arrays).stack(*arrays, axis=axis)


def _symbol_zeros(x, shape):
    """A Symbol of zeros (N,) + ``shape[1:]`` whose N is the batch of the
    step Symbol ``x`` (N, ...)."""
    from ... import symbol as F
    z = F.zeros_like(F.slice_axis(F.Flatten(x), axis=1, begin=0, end=1))
    rest = tuple(shape[1:])
    if len(rest) > 1:
        z = F.Reshape(z, shape=(0,) + (1,) * len(rest))
    return F.broadcast_axis(z, axis=tuple(range(1, len(rest) + 1)),
                            size=rest)


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    outputs = F.SequenceMask(_stack(list(data), time_axis), valid_length,
                             use_sequence_length=True, axis=time_axis)
    if not merge:
        parts = F.SliceChannel(outputs, num_outputs=len(data),
                               axis=time_axis, squeeze_axis=True)
        outputs = [parts[i] for i in range(len(data))]
    return outputs


class RecurrentCell(Block):
    """Base class for recurrent cells (reference: rnn_cell.py:85)."""

    def __init__(self, prefix=None, params=None):
        super(RecurrentCell, self).__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before another unroll."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, ``func(shape=..., **kwargs)`` each (default
        ``nd.zeros``; pass ``ctx=`` for the device)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        from ... import ndarray as nd
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **{**kwargs, **info}))
        return states

    def _zero_states(self, steps, batch_size):
        """Zeros for every state: on the steps' device, or shaped from the
        first step of a Symbol sequence."""
        if _is_symbol(steps[0]):
            return [_symbol_zeros(steps[0], info["shape"])
                    for info in self.state_info(0)]
        return self.begin_state(batch_size=batch_size,
                                ctx=steps[0].context)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` steps (reference: rnn_cell.py
        unroll): ``(outputs, final states)``; with ``valid_length`` the
        outputs past each sequence's length are zero and the states are
        those at its last valid step."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        F = _F(inputs)
        states = begin_state if begin_state is not None else \
            self._zero_states(inputs, batch_size)
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [_stack(list(ele_list), 0)
                      for ele_list in zip(*all_states)]
            states = [F.SequenceLast(s, valid_length,
                                     use_sequence_length=True, axis=0)
                      for s in states]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, True)
            if merge_outputs is False:
                parts = F.SliceChannel(outputs, num_outputs=length,
                                       axis=axis, squeeze_axis=True)
                outputs = [parts[i] for i in range(length)]
        elif merge_outputs:
            outputs = _stack(outputs, axis)
        return outputs, states

    def _forward_cell(self, inputs, states):
        raise NotImplementedError

    def forward(self, inputs, states):
        return self._forward_cell(inputs, states)

    def __call__(self, inputs, states):
        self._counter += 1
        for hook in self._forward_pre_hooks:
            hook(self, (inputs, states))
        out = self._forward_cell(inputs, states)
        for hook in self._forward_hooks:
            hook(self, (inputs, states), out)
        return out


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell written as ``hybrid_forward(F, x, states, **params)``
    (reference: rnn_cell.py HybridRecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super(HybridRecurrentCell, self).__init__(prefix=prefix,
                                                  params=params)

    def _forward_cell(self, inputs, states):
        from ..parameter import DeferredInitializationError
        if _is_symbol(inputs):
            from ... import symbol as F
            params = {n: p.var() for n, p in self._reg_params.items()}
            return self.hybrid_forward(F, inputs, states, **params)
        from ... import ndarray as F
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(inputs, states)
            params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(F, inputs, states, **params)

    def _finish_deferred(self, inputs, states=None):
        self.infer_shape(inputs)
        for p in self.collect_params().values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def infer_shape(self, x):
        pass

    def hybrid_forward(self, F, x, states, **params):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The four parameters of RNNCell, LSTMCell and GRUCell: i2h / h2h
    weight (gates * hidden, in / hidden) and bias (gates * hidden)."""

    _n_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super(_GatedCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        n = self._n_gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(n, input_size),
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(n, hidden_size),
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(n,), init=_init(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(n,), init=_init(h2h_bias_initializer),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x):
        self.i2h_weight._set_shape_from(
            (self._n_gates * self._hidden_size, x.shape[-1]))

    def _i2h_h2h(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                 h2h_bias):
        n = self._n_gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman RNN cell: h' = act(W x + b_i + R h + b_h)
    (reference: rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super(RNNCell, self).__init__(
            hidden_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, input_size,
            prefix=prefix, params=params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._i2h_h2h(F, inputs, states[0], i2h_weight,
                                 h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell (reference: rnn_cell.py LSTMCell; gates i, f, c, o)."""

    _n_gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._i2h_h2h(F, inputs, states[0], i2h_weight,
                                 h2h_weight, i2h_bias, h2h_bias)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell (reference: rnn_cell.py GRUCell; gates r, z, n, cuDNN's
    convention)."""

    _n_gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._i2h_h2h(F, inputs, prev_h, i2h_weight, h2h_weight,
                                 i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked one on another (reference: rnn_cell.py
    SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super(SequentialRNNCell, self).__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def _forward_cell(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class HybridSequentialRNNCell(SequentialRNNCell):
    pass


class DropoutCell(HybridRecurrentCell):
    """Dropout on the cell's input, no state (reference: rnn_cell.py
    DropoutCell); draws from the port's generator."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super(DropoutCell, self).__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that wrap another cell (reference: rnn_cell.py
    ModifierCell): the base cell's parameters and states."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super(ModifierCell, self).__init__(
            prefix=base_cell.prefix + self._alias(), params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout (reference: rnn_cell.py ZoneoutCell): each output and
    state keeps its previous value where a Dropout mask of ones is 0, in
    training only."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. Apply ZoneoutCell " \
            "to the cells underneath instead."
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super(ZoneoutCell, self).reset()
        self._prev_output = None

    def _forward_cell(self, inputs, states):
        F = _F(inputs)
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (reference: rnn_cell.py
    ResidualCell)."""

    def _alias(self):
        return "residual"

    def _forward_cell(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence in opposite directions, outputs
    concatenated (reference: rnn_cell.py BidirectionalCell); only through
    ``unroll``."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def _alias(self):
        return "bi"

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def _forward_cell(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        F = _F(inputs)
        reversed_inputs = list(reversed(inputs))
        states = begin_state if begin_state is not None else \
            self._zero_states(inputs, batch_size)
        l_cell, r_cell = self._children.values()
        nl = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:nl], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=states[nl:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is not None:
            r_outputs = _mask_sequence_variable_length(
                F, list(reversed(r_outputs)), length, valid_length, axis,
                False)
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [F.Concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = _stack(outputs, axis)
        return outputs, l_states + r_states
