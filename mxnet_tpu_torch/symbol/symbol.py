"""Symbolic graph API.

Counterpart of the JAX package's ``symbol/symbol.py``: a Symbol is a
small Python DAG over the op registry. Names, the auto-created input
variables of ``_apply_op`` (``<node>_<input>``), argument/output/aux
listings, ``attr_dict`` and the JSON format are the JAX package's, so a
graph serialized there (``Symbol.tojson()``) loads here with the same
argument names. Where the JAX package traces the graph into one jitted
function, here ``_graph_eval_fn`` runs it eagerly on tensors; shape
inference runs each op on ``device="meta"`` tensors (no memory, no
compute) where the JAX package uses ``jax.eval_shape``.

Variables may carry a type (``Variable(dtype="int8")``, the ``__dtype__``
attr, as the quantized serving graphs' int8 weights do): shape inference
gives them meta tensors of that type, and ``simple_bind(type_dict=...)``
binds such buffers in it. ``get_internals`` groups every node's outputs,
variables included, in the JAX package's order; ``sym[i]`` picks one
output; ``save`` / ``load`` write and read the JSON file atomically.

An op whose function takes ``*args`` (``Custom``) gets an input slot for
each further positional Symbol and each keyword Symbol, as in the JAX
package; a positional ``None`` leaves its slot unwired (``bias`` under
``no_bias``), as the op function takes it on tensors.

Composition (``sym(data=other)``: a copy whose free variables are
replaced by other symbols), ``Group``, ``copy``, ``list_inputs``,
``get_children`` and the arithmetic of the JAX package (``+ - * / **``
with symbols or scalars, the reversed forms, unary ``-``, the
comparisons ``> >= < <=``, ``reshape``) over the registry's
``elemwise_*`` / ``_*_scalar`` ops are the JAX package's; ``==`` stays
identity, so symbols live in dicts and sets. Gluon's hybridize traces a
block into such a graph (``gluon/block.py``).

Not ported yet (ROADMAP A8.6): ``infer_type``, control-flow subgraphs,
``AttrScope``; group2ctx model parallelism is A13.
"""
from __future__ import annotations

import inspect
import json
import numbers
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

# ops whose trailing inputs are auxiliary states (updated by the
# executor during training, never gradient-trained)
AUX_STATES = {"BatchNorm": ("moving_mean", "moving_var")}


class _NameManager(threading.local):
    """Auto-naming for anonymous symbols (reference:
    python/mxnet/name.py NameManager): ``<hint><n>``, n counting per hint
    from 0 in each thread."""

    def __init__(self):
        self._counter = {}
        self.prefix = ""

    def get(self, hint):
        hint = hint.lower().lstrip("_")
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%s%d" % (self.prefix, hint, idx)


_name_mgr = _NameManager()


def _positional_params(op):
    """The positional parameters of an op's function, the generator of
    a ``needs_rng`` op left out."""
    params = [p for p in inspect.signature(op.fn).parameters.values()
              if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                            inspect.Parameter.POSITIONAL_ONLY)]
    return params[1:] if op.needs_rng else params


def _input_names(op):
    """Array-input parameter names of an op, from its function's
    signature: positional parameters that are not attrs, each with
    whether it has a default."""
    return [(p.name, p.default is not inspect.Parameter.empty)
            for p in _positional_params(op)
            if not p.name.startswith("_") and p.name not in op.attr_defaults]


def _attr_names(op):
    """The op's attrs that its function takes positionally, in
    signature order: where a positional argument that is not a Symbol
    goes (``F.clip(x, -0.5, 0.5)``)."""
    return [p.name for p in _positional_params(op)
            if p.name in op.attr_defaults]


class _Node(object):
    """One graph node: an op application or a variable (op is None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "in_names")

    def __init__(self, op, name, attrs=None, inputs=(), is_aux=False,
                 in_names=None):
        self.op = op
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)      # [(_Node, out_index)]
        self.is_aux = is_aux
        # names of the op input slots actually wired, aligned with inputs
        self.in_names = in_names

    @property
    def is_var(self):
        return self.op is None


def _topo(entries):
    """Topological order of the nodes reachable from output entries."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for n, _i in node.inputs:
            visit(n)
        order.append(node)

    for n, _i in entries:
        visit(n)
    return order


def _n_outputs(node):
    return _reg.get_op(node.op).n_outputs(node.attrs)


def _op_attrs(node):
    """The attrs an op function takes: annotations (``__x__``) dropped."""
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


class Symbol(object):
    """Symbolic multi-output expression (reference: symbol.py Symbol)."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        if len(self._entries) == 1:
            return "<Symbol %s>" % self._entries[0][0].name
        return "<Symbol Grouped %s>" % ",".join(
            n.name for n, _ in self._entries)

    def __getitem__(self, index):
        """One output, by position or by name (``fc1`` or
        ``fc1_output``)."""
        outputs = self.list_outputs()
        if isinstance(index, str):
            matches = [i for i, n in enumerate(outputs)
                       if n == index or n == index + "_output"]
            if not matches:
                raise ValueError("cannot find output %r" % index)
            index = matches[0]
        if not 0 <= index < len(outputs):
            raise IndexError("index %d out of range" % index)
        return Symbol([self._entries[index]])

    def get_internals(self):
        """Every node's outputs as one grouped symbol, variables
        included, in topological order (reference: symbol.py
        get_internals)."""
        entries = []
        for node in _topo(self._entries):
            if node.is_var:
                entries.append((node, 0))
            else:
                entries.extend((node, i) for i in range(_n_outputs(node)))
        return Symbol(entries)

    def get_children(self):
        """The inputs of this symbol's outputs as one grouped symbol, or
        None for a variable (reference: symbol.py get_children)."""
        entries, seen = [], set()
        for node, _ in self._entries:
            for src, oi in node.inputs:
                if (id(src), oi) not in seen:
                    seen.add((id(src), oi))
                    entries.append((src, oi))
        return Symbol(entries) if entries else None

    def __copy__(self):
        return Symbol(self._entries)

    def __deepcopy__(self, memo):
        return self.copy()

    def copy(self):
        """A deep copy: new nodes, the same names and attrs."""
        return load_json(self.tojson())

    # -- composition -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """A copy with free variables replaced (reference: symbol.py
        __call__): positional symbols take the free arguments in
        ``list_arguments`` order, keywords the variable of that name (or,
        for a one-op symbol, of that input slot: ``data`` for
        ``fc1_data``); ``name`` renames a one-output result."""
        s = self.copy()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        name = kwargs.pop("name", None)
        nodes = _topo(self._entries)
        subst = {}
        if args:
            free = [n for n in nodes if n.is_var and not n.is_aux]
            if len(args) > len(free):
                raise MXNetError("too many positional arguments to compose")
            for node, sym in zip(free, args):
                subst[id(node)] = _single_entry(sym)
        for key, sym in kwargs.items():
            hit = [n for n in nodes if n.is_var and n.name == key] or \
                [n for n in nodes if n.is_var and n.name.endswith("_" + key)]
            if not hit:
                raise MXNetError("no variable named %r to compose" % key)
            subst[id(hit[0])] = _single_entry(sym)
        _substitute(nodes, self, subst)
        if name is not None and len(self._entries) == 1:
            self._entries[0][0].name = name

    # -- listings ----------------------------------------------------------
    def list_inputs(self):
        """Every variable, arguments and auxiliary states, in
        topological order."""
        return [n.name for n in _topo(self._entries) if n.is_var]

    def list_arguments(self):
        return [n.name for n in _topo(self._entries)
                if n.is_var and not n.is_aux]

    def list_outputs(self):
        outs = []
        for node, idx in self._entries:
            if node.is_var:
                outs.append(node.name)
            elif _n_outputs(node) == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    def list_auxiliary_states(self):
        return [n.name for n in _topo(self._entries)
                if n.is_var and n.is_aux]

    # -- attributes --------------------------------------------------------
    def attr_dict(self):
        out = {}
        for node in _topo(self._entries):
            if node.attrs:
                out[node.name] = {k: str(v) for k, v in node.attrs.items()}
        return out

    def _set_attr(self, **kwargs):
        for node, _ in self._entries:
            node.attrs.update(kwargs)

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from known input shapes,
        in list_arguments / list_outputs / list_auxiliary_states order.
        Raises :class:`MXNetError` when a shape cannot be inferred."""
        return self._infer_shape(*args, **kwargs)[:3]

    def _infer_shape(self, *args, **kwargs):
        """:meth:`infer_shape`'s three lists, then ``_deduce_shapes``'
        pair (every leaf's shape, every node output's shape)."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        try:
            shapes, outs = _deduce_shapes(self, known)
        except MXNetError:
            raise
        except Exception as e:      # an op refused its input shapes
            raise MXNetError("infer_shape error: %s" % e) from e
        out_shapes = [shapes[n.name] if n.is_var else outs[(id(n), oi)]
                      for n, oi in self._entries]
        return ([shapes[n] for n in arg_names], out_shapes,
                [shapes[n] for n in aux_names], (shapes, outs))

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """The JAX package's JSON graph (nodes / arg_nodes / heads)."""
        nodes = _topo(self._entries)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_var else n.op,
                "name": n.name,
                "attrs": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in n.attrs.items()},
                "inputs": [[nid[id(src)], oi, 0] for src, oi in n.inputs],
            })
            if n.is_aux:
                jnodes[-1]["aux"] = True
            if n.in_names is not None:
                jnodes[-1]["in_names"] = list(n.in_names)
        heads = [[nid[id(n)], oi, 0] for n, oi in self._entries]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_var]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10300]}},
                          indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname``, atomically: a crash mid-save
        never tears an existing symbol file."""
        from ..checkpoint import atomic_writer
        with atomic_writer(fname, "w") as f:
            f.write(self.tojson())

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Allocate zeroed arrays of the inferred shapes on ``ctx``
        (default ``cuda:0``) and bind them; ``type_dict`` maps argument
        and auxiliary names to their types (float32 otherwise)."""
        from ..context import default_device
        from ..ndarray.ndarray import zeros
        ctx = default_device(ctx)
        arg_shapes, _, aux_shapes, deduced = self._infer_shape(**kwargs)
        type_dict = type_dict or {}
        args = [zeros(s, ctx=ctx, dtype=type_dict.get(n, np.float32))
                for n, s in zip(self.list_arguments(), arg_shapes)]
        aux = [zeros(s, ctx=ctx, dtype=type_dict.get(n, np.float32))
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)]
        exe = self.bind(ctx, args, grad_req=grad_req, aux_states=aux)
        exe._deduced = deduced       # its cost count reuses the shapes
        return exe

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        if group2ctx:
            raise NotImplementedError("group2ctx model parallelism is not "
                                      "ported yet (ROADMAP A13)")
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_op(_reg.get_op(op_name), (a, b), {}, None)
        if isinstance(other, numbers.Real) and not isinstance(other, bool):
            return _apply_op(_reg.get_op(scalar_op), (self,),
                             {"scalar": float(other)}, None)
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "elemwise_sub", "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "elemwise_div", "_rdiv_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _apply_op(_reg.get_op("negative"), (self,), {}, None)

    def __abs__(self):
        return _apply_op(_reg.get_op("abs"), (self,), {}, None)

    def __gt__(self, other):
        return self._binop(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "_lesser_equal", "_lesser_equal_scalar")

    def reshape(self, shape, **kwargs):
        return _apply_op(_reg.get_op("Reshape"), (self,),
                         dict(kwargs, shape=tuple(shape)), None)

    def __hash__(self):
        return object.__hash__(self)

    def __eq__(self, other):
        return self is other

    def __bool__(self):
        raise TypeError("Symbol has no truth value: comparisons build "
                        "graph nodes")


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A symbolic variable (reference: symbol.py var)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = {"__%s__" % k: v for k, v in dict(attr or {}).items()}
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = ("bfloat16" if str(dtype) == "bfloat16"
                              else np.dtype(dtype).name)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def Group(symbols):
    """The outputs of ``symbols``, in order, as one symbol (reference:
    symbol.py Group)."""
    entries = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group takes Symbols, got %s" % type(s).__name__)
        entries.extend(s._entries)
    return Symbol(entries)


def _single_entry(sym):
    if not isinstance(sym, Symbol) or len(sym._entries) != 1:
        raise MXNetError("can only compose with single-output symbols")
    return sym._entries[0]


def _substitute(nodes, sym, subst):
    """Rewire every input of ``nodes`` and every output entry of ``sym``
    that reads a variable in ``subst`` (id -> entry) to that entry."""
    if not subst:
        return
    for node in nodes:
        node.inputs = [subst.get(id(src), (src, oi)) if src.is_var
                       else (src, oi) for src, oi in node.inputs]
    sym._entries = [subst.get(id(n), (n, oi)) if n.is_var else (n, oi)
                    for n, oi in sym._entries]


def load(fname):
    """A Symbol from a JSON file written by :meth:`Symbol.save` (this
    package's or the JAX package's)."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """A Symbol from the JSON of :meth:`Symbol.tojson` (this package's or
    the JAX package's)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in (jn.get("attrs") or {}).items()}
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attrs, is_aux=jn.get("aux", False))
        else:
            _reg.get_op(jn["op"])      # raises for an op not ported yet
            node = _Node(jn["op"], jn["name"], attrs,
                         in_names=jn.get("in_names"))
            node.inputs = [(nodes[i], oi) for i, oi, _v in jn["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _v in data["heads"]])


# ---------------------------------------------------------------------------
# op application (the symbol-side analog of an eager op call)
# ---------------------------------------------------------------------------

def _apply_op(op, args, attrs, name):
    """A graph node applying ``op``; creates ``<name>_<input>`` variables
    for missing array inputs as the reference's compose does (e.g.
    ``fc1_weight``), skipping optional ones (bias under ``no_bias``)."""
    in_names = _input_names(op)
    inputs = {}
    kw = dict(attrs)
    attrs = {}
    for k, v in kw.items():
        if isinstance(v, Symbol):
            inputs[k] = v
        elif k == "attr" and isinstance(v, dict):
            attrs.update({"__%s__" % a: b for a, b in v.items()})
        else:
            attrs[k] = v
    variadic = any(p.kind is inspect.Parameter.VAR_POSITIONAL
                   for p in inspect.signature(op.fn).parameters.values())
    pos = 0
    skipped = set()
    free_attrs = [n for n in _attr_names(op) if n not in attrs]
    for a in args:
        if a is not None and not isinstance(a, Symbol):
            # an attribute given positionally, in signature order
            if not free_attrs:
                raise TypeError("positional args to symbol op %s must be "
                                "Symbols or its attributes in order, got "
                                "%s" % (op.name, type(a)))
            attrs[free_attrs.pop(0)] = a
            continue
        while pos < len(in_names) and in_names[pos][0] in inputs:
            pos += 1
        if a is None:
            # an absent optional input (bias=None): its slot stays unwired
            if pos < len(in_names):
                skipped.add(in_names[pos][0])
            pos += 1
            continue
        if pos >= len(in_names):
            if not variadic:
                raise MXNetError("too many inputs for op %s" % op.name)
            # *args ops (Custom): an input slot per extra Symbol
            in_names = list(in_names) + [("arg%d" % pos, False)]
        inputs[in_names[pos][0]] = a
        pos += 1
    unknown = [k for k in inputs if k not in dict(in_names)]
    if unknown:
        if not variadic:
            raise MXNetError("unknown input(s) %s for op %s"
                             % (unknown, op.name))
        # keyword Symbols of a *args op (sym.Custom(data=x, ...)) are
        # further inputs, in keyword order
        in_names = list(in_names) + [(k, False) for k in unknown]

    if name is None:
        name = _name_mgr.get(op.name)
    aux_names = AUX_STATES.get(op.name, ())
    node_inputs, wired = [], []
    for in_name, has_default in in_names:
        if in_name in inputs:
            sym = inputs[in_name]
            if len(sym._entries) != 1:
                raise MXNetError("op inputs must be single-output symbols")
            ent = sym._entries[0]
            if in_name in aux_names and ent[0].is_var:
                ent[0].is_aux = True
            node_inputs.append(ent)
            wired.append(in_name)
            continue
        if in_name in skipped or (in_name == "bias"
                                  and attrs.get("no_bias", False)):
            continue
        if has_default and in_name not in aux_names and in_name != "bias":
            continue
        node_inputs.append((_Node(None, "%s_%s" % (name, in_name),
                                  is_aux=in_name in aux_names), 0))
        wired.append(in_name)
    node = _Node(op.name, name, attrs, node_inputs, in_names=wired)
    return Symbol([(node, i) for i in range(op.n_outputs(attrs))])


# ---------------------------------------------------------------------------
# graph evaluation: the executor's core
# ---------------------------------------------------------------------------

def _aux_input_positions(op, node):
    wired = node.in_names
    if wired is None:
        wired = [n for n, _d in _input_names(op)][:len(node.inputs)]
    missing = [a for a in AUX_STATES[node.op] if a not in wired]
    if missing:
        raise MXNetError("cannot locate the aux inputs %s of %s"
                         % (missing, node.name))
    return [wired.index(a) for a in AUX_STATES[node.op]]


def _graph_eval_fn(symbol, is_train):
    """``fn(env: name -> tensor, gen=None) -> (outputs, stats)``.

    ``env`` holds the argument and auxiliary tensors. Each op that draws
    random numbers (Dropout) draws from ``gen``, by default the port's
    generator of the env's device (``random.generator``), one draw after
    another in topological order (the JAX package folds one key per RNG
    node, symbol/symbol.py:759-772); a creation op creates on that
    device. ``fn.needs_rng`` says whether the graph draws. ``stats`` lists,
    for each BatchNorm that normalized with batch statistics (training,
    not ``use_global_stats``), ``(moving_mean_name, moving_var_name,
    momentum, batch_mean, batch_var)`` with the statistics detached: the
    executor and Gluon's CachedOp update the moving statistics with them
    (:func:`update_moving_stats`), in place, ``new = momentum * old +
    (1 - momentum) * batch`` (the JAX package's functional update,
    symbol/symbol.py:796-802, with the biased variance)."""
    nodes = _topo(symbol._entries)

    def fn(env, gen=None):
        values = {}
        stats = []
        dev = next((t.device for t in env.values()
                    if isinstance(t, torch.Tensor)), None)
        if gen is None and fn.needs_rng and dev.type != "meta":
            from .. import random as _random
            gen = _random.generator(dev)
        for node in nodes:
            if node.is_var:
                if node.name not in env:
                    raise MXNetError("unbound variable %r" % node.name)
                values[(id(node), 0)] = env[node.name]
                continue
            op = _reg.get_op(node.op)
            attrs = _op_attrs(node)
            if "train_mode" in op.attr_defaults and "train_mode" not in attrs:
                attrs["train_mode"] = is_train
            arrs = [values[(id(src), oi)] for src, oi in node.inputs]
            if "ctx" in op.attr_defaults and not arrs:
                attrs["ctx"] = dev
            if (node.op in AUX_STATES and is_train
                    and not attrs.get("use_global_stats", False)):
                attrs["output_mean_var"] = True
                out, mean, var = _reg.apply(op, arrs, attrs, gen)
                mm, mv = [node.inputs[i][0].name
                          for i in _aux_input_positions(op, node)]
                stats.append((mm, mv, float(attrs.get("momentum", 0.9)),
                              mean.detach(), var.detach()))
                outs = (out, mean, var) \
                    if node.attrs.get("output_mean_var", False) else (out,)
            else:
                outs = _reg.apply(op, arrs, attrs, gen)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
        return tuple(values[(id(n), oi)] for n, oi in symbol._entries), stats

    fn.needs_rng = any(not n.is_var and _reg.get_op(n.op).needs_rng
                       for n in nodes)
    return fn


def update_moving_stats(stats, aux):
    """Apply ``_graph_eval_fn``'s batch statistics to the moving ones in
    ``aux`` (name -> tensor), in place, grouped by momentum: ``old =
    momentum * old + (1 - momentum) * batch`` (the Gluon layer's
    arithmetic)."""
    groups = {}
    for mm, mv, mom, mean, var in stats:
        olds, news = groups.setdefault(mom, ([], []))
        olds += [aux[mm], aux[mv]]
        news += [mean.to(aux[mm].dtype), var.to(aux[mv].dtype)]
    with torch.no_grad():
        for mom, (olds, news) in groups.items():
            torch._foreach_mul_(olds, mom)
            torch._foreach_add_(olds, torch._foreach_mul(news, 1 - mom))


# ---------------------------------------------------------------------------
# shape deduction
# ---------------------------------------------------------------------------

def _deduce_shapes(symbol, known):
    """Leaf and output shapes. Variables with a ``__shape__`` attr or an
    entry in ``known`` are fixed; parameter leaves are deduced per
    consuming op from its data input (``_deduce_params``); each op's
    outputs come from running it on meta tensors once its inputs are
    known. Returns ({leaf name: shape}, {(node id, out): shape})."""
    nodes = _topo(symbol._entries)
    shapes = dict(known)
    for n in nodes:
        shape = n.attrs.get("__shape__") if n.is_var else None
        if shape and n.name not in shapes and all(d > 0 for d in shape):
            # a parameter's variable before its deferred shape is known
            # carries 0 entries: deduced below like an unannotated one
            shapes[n.name] = tuple(shape)
    out_shapes = {}

    def entry_shape(src, oi):
        return shapes.get(src.name) if src.is_var \
            else out_shapes.get((id(src), oi))

    progress = True
    while progress:
        progress = False
        for node in nodes:
            if node.is_var or (id(node), 0) in out_shapes:
                continue
            in_shapes = [entry_shape(s, oi) for s, oi in node.inputs]
            if any(s is None for s in in_shapes):
                if not _deduce_params(node, in_shapes, shapes):
                    continue
                progress = True
                in_shapes = [entry_shape(s, oi) for s, oi in node.inputs]
                if any(s is None for s in in_shapes):
                    continue
            op = _reg.get_op(node.op)
            attrs = _op_attrs(node)
            if "train_mode" in op.attr_defaults:
                attrs["train_mode"] = False
            metas = [torch.empty(s, device="meta", dtype=_var_dtype(src))
                     for s, (src, _oi) in zip(in_shapes, node.inputs)]
            if "ctx" in op.attr_defaults and not metas:
                attrs["ctx"] = "meta"
            with torch.no_grad():
                outs = _reg.apply(op, metas, attrs)
            for i, o in enumerate(outs):
                out_shapes[(id(node), i)] = tuple(o.shape)
            progress = True
    missing = [n.name for n in nodes if n.is_var and n.name not in shapes]
    if missing:
        raise MXNetError("cannot infer shapes for %s" % missing)
    return shapes, out_shapes


def _var_dtype(node):
    """The torch type of a variable's ``__dtype__`` attr (float32 for
    an untyped variable or an op output)."""
    from ..ndarray.ndarray import to_torch_dtype
    dtype = node.attrs.get("__dtype__") if node.is_var else None
    return to_torch_dtype(dtype) if dtype else torch.float32


def _deduce_params(node, in_shapes, shapes):
    """Fill in missing parameter-leaf shapes of the core NN ops from the
    data input's shape (each op's FInferShape in the reference)."""
    ins = node.inputs
    attrs = node.attrs

    def set_leaf(pos, shape):
        src, _ = ins[pos]
        if src.is_var and src.name not in shapes:
            shapes[src.name] = tuple(int(x) for x in shape)
            return True
        return False

    data_shape = in_shapes[0] if in_shapes else None
    if data_shape is None:
        return False
    changed = False
    if node.op == "FullyConnected":
        num_hidden = attrs.get("num_hidden")
        in_dim = (int(np.prod(data_shape[1:])) if attrs.get("flatten", True)
                  else data_shape[-1])
        changed |= set_leaf(1, (num_hidden, in_dim))
        if len(ins) > 2:
            changed |= set_leaf(2, (num_hidden,))
    elif node.op in ("Convolution", "Deconvolution"):
        num_filter = attrs.get("num_filter")
        group = attrs.get("num_group", 1)
        lead = (num_filter, data_shape[1] // group) \
            if node.op == "Convolution" \
            else (data_shape[1], num_filter // group)
        changed |= set_leaf(1, lead + tuple(attrs.get("kernel", ())))
        if len(ins) > 2:
            changed |= set_leaf(2, (num_filter,))
    elif node.op in ("BatchNorm", "InstanceNorm", "LayerNorm"):
        axis = attrs.get("axis", -1 if node.op == "LayerNorm" else 1)
        c = data_shape[axis % len(data_shape)]
        for pos in range(1, len(ins)):
            changed |= set_leaf(pos, (c,))
    elif node.op == "Embedding":
        changed |= set_leaf(1, (attrs.get("input_dim"),
                                attrs.get("output_dim")))
    elif node.op == "RNN":
        from ..ops.nn import rnn_param_size
        H = int(attrs.get("state_size", 0))
        proj = attrs.get("projection_size")
        layers = int(attrs.get("num_layers", 1))
        dirs = 2 if attrs.get("bidirectional", False) else 1
        changed |= set_leaf(1, (rnn_param_size(
            layers, data_shape[2], H, dirs == 2, attrs.get("mode", "lstm"),
            proj),))
        lead = (layers * dirs, data_shape[1])
        if len(ins) > 2:
            changed |= set_leaf(2, lead + (proj or H,))
        if len(ins) > 3:
            changed |= set_leaf(3, lead + (H,))
    elif node.op in ("SoftmaxOutput", "Softmax") and len(ins) > 1:
        # the label of a single-output softmax is one class per row
        changed |= set_leaf(1, tuple(data_shape[:1]))
    elif node.op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput") and len(ins) > 1:
        changed |= set_leaf(1, tuple(data_shape))
    return changed
