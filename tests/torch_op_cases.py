"""The per-op cases of the port's core op surface: for each op of the
JAX package's ``ops/{creation,elemwise,reduce,matrix,nn}.py`` (an alias
runs its target's case), numpy-seeded inputs at three shapes (or
attribute sets) and its attributes, and the code that runs a case in
one package on one device.

Imported by ``test_torch_ops_surface.py`` (the port against the JAX
package on the CPU) and by ``chip_smoke.py`` phase 29 (the port on the
card against the port on the CPU). It imports neither JAX nor torch.
"""
import numpy as np

# ---------------------------------------------------------------------------
# input makers: each takes (rng, shape) and gives a list of numpy arrays
# ---------------------------------------------------------------------------

def U(lo, hi):
    return lambda rng, s: [rng.uniform(lo, hi, s).astype(np.float32)]


def SIGNED(lo, hi):
    """Magnitudes in [lo, hi) with random signs (off zero)."""
    def make(rng, s):
        m = rng.uniform(lo, hi, s)
        return [(m * rng.choice([-1.0, 1.0], s)).astype(np.float32)]
    return make


def INTS(lo, hi):
    return lambda rng, s: [rng.randint(lo, hi, s).astype(np.float32)]


def DISTINCT(rng, s):
    """A permutation of distinct values (no ties anywhere)."""
    n = int(np.prod(s))
    return [(rng.permutation(n).astype(np.float32) / n - 0.5).reshape(s)]


def PAIR(a, b):
    return lambda rng, s: a(rng, s[0]) + b(rng, s[1])


def SAME(*makers):
    return lambda rng, s: [x for m in makers for x in m(rng, s)]


UNARY_SHAPES = [(7,), (2, 5), (2, 3, 4)]
BCAST_SHAPES = [((7,), (7,)), ((2, 5), (1, 5)), ((2, 3, 4), (2, 1, 4))]


def spec(make, shapes=UNARY_SHAPES, attrs=None, grad=None, no_grad=()):
    """A case: inputs from ``make`` per entry of ``shapes``; ``attrs`` a
    dict, or a list aligned with ``shapes``; ``grad`` the inputs to
    differentiate (default: every float input not in ``no_grad``)."""
    return {"make": make, "shapes": shapes, "attrs": attrs, "grad": grad,
            "no_grad": set(no_grad)}


SPECS = {}

_UNARY_DOMAINS = {
    "abs": SIGNED(0.1, 2), "sign": SIGNED(0.1, 2), "rint": U(-3, 3),
    "round": U(-3, 3), "ceil": U(-3, 3), "floor": U(-3, 3),
    "trunc": U(-3, 3), "fix": U(-3, 3), "square": U(-2, 2),
    "sqrt": U(0.1, 3), "rsqrt": U(0.1, 3), "cbrt": SIGNED(0.2, 3),
    "rcbrt": SIGNED(0.2, 3), "exp": U(-2, 2), "log": U(0.1, 3),
    "log10": U(0.1, 3), "log2": U(0.1, 3), "log1p": U(-0.5, 3),
    "expm1": U(-2, 2), "sin": U(-3, 3), "cos": U(-3, 3),
    "tan": U(-1.2, 1.2), "arcsin": U(-0.9, 0.9), "arccos": U(-0.9, 0.9),
    "arctan": U(-3, 3), "sinh": U(-2, 2), "cosh": U(-2, 2),
    "tanh": U(-2, 2), "arcsinh": U(-3, 3), "arccosh": U(1.1, 3),
    "arctanh": U(-0.9, 0.9), "degrees": U(-3, 3), "radians": U(-90, 90),
    "negative": U(-2, 2), "reciprocal": SIGNED(0.2, 3),
    "relu": SIGNED(0.05, 2), "sigmoid": U(-3, 3), "softsign": U(-3, 3),
    "softrelu": U(-3, 3), "erf": U(-2, 2), "erfinv": U(-0.9, 0.9),
    "gamma": U(0.5, 4), "gammaln": U(0.5, 4), "logical_not": INTS(-1, 2),
    "_copy": U(-2, 2), "stop_gradient": U(-2, 2), "make_loss": U(-2, 2),
    "zeros_like": U(-2, 2), "ones_like": U(-2, 2),
    "shape_array": U(-2, 2), "size_array": U(-2, 2),
    "hard_sigmoid": U(-4, 4), "smooth_l1": U(-2, 2),
}
for _n, _m in _UNARY_DOMAINS.items():
    SPECS[_n] = spec(_m)
SPECS["smooth_l1"]["attrs"] = [{"scalar": 1.5}, {}, {"scalar": 0.8}]
SPECS["hard_sigmoid"]["attrs"] = [{}, {"alpha": 0.3, "beta": 0.4}, {}]
SPECS["clip"] = spec(SIGNED(0.55, 2), attrs=[{"a_min": -0.5, "a_max": 0.5},
                                            {"a_min": -1.0, "a_max": 1.5},
                                            {"a_min": 0.0, "a_max": 0.7}])
SPECS["Cast"] = spec(U(-3, 3), attrs=[{"dtype": "float16"},
                                      {"dtype": "int32"},
                                      {"dtype": "uint8"}])

_BINARY_DOMAINS = {
    "broadcast_add": (U(-2, 2), U(-2, 2)),
    "broadcast_sub": (U(-2, 2), U(-2, 2)),
    "broadcast_mul": (U(-2, 2), U(-2, 2)),
    "broadcast_div": (U(-2, 2), SIGNED(0.5, 2)),
    "broadcast_mod": (U(-3, 3), SIGNED(0.7, 2)),
    "broadcast_power": (U(0.5, 2), U(-1.5, 1.5)),
    "broadcast_maximum": (DISTINCT, DISTINCT),
    "broadcast_minimum": (DISTINCT, DISTINCT),
    "broadcast_hypot": (SIGNED(0.1, 2), SIGNED(0.1, 2)),
    "arctan2": (SIGNED(0.1, 2), SIGNED(0.1, 2)),
}
for _n, (_a, _b) in _BINARY_DOMAINS.items():
    SPECS[_n] = spec(PAIR(_a, _b), shapes=BCAST_SHAPES)
for _n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor"):
    SPECS[_n] = spec(PAIR(INTS(0, 3), INTS(0, 3)), shapes=BCAST_SHAPES)
for _n in ("_logical_and", "_logical_or", "_logical_xor"):
    SPECS[_n] = spec(SAME(INTS(-1, 2), INTS(-1, 2)))

_SCALAR_DOMAINS = {
    "_plus_scalar": (U(-2, 2), 1.5), "_minus_scalar": (U(-2, 2), 0.5),
    "_rminus_scalar": (U(-2, 2), 2.0), "_mul_scalar": (U(-2, 2), -1.5),
    "_div_scalar": (U(-2, 2), 4.0), "_rdiv_scalar": (SIGNED(0.3, 2), 3.0),
    "_mod_scalar": (U(-3, 3), 1.3), "_rmod_scalar": (U(0.6, 2), 2.5),
    "_power_scalar": (U(0.3, 2), 2.5), "_rpower_scalar": (U(-1, 1), 2.0),
    "_maximum_scalar": (U(-2, 2), 0.25), "_minimum_scalar": (U(-2, 2), 0.25),
    "_hypot_scalar": (U(-2, 2), 1.5),
}
for _n, (_m, _s) in _SCALAR_DOMAINS.items():
    SPECS[_n] = spec(_m, attrs=[{"scalar": _s}, {"scalar": _s * 0.5},
                                {"scalar": _s}])
for _n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
           "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
           "_logical_and_scalar", "_logical_or_scalar",
           "_logical_xor_scalar"):
    SPECS[_n] = spec(INTS(0, 3), attrs=[{"scalar": 1.0}, {"scalar": 0.0},
                                        {"scalar": 2.0}])
SPECS["add_n"] = spec(SAME(U(-2, 2), U(-2, 2), U(-2, 2)))
SPECS["SoftmaxActivation"] = spec(U(-2, 2), shapes=[(2, 5), (2, 3, 4),
                                                    (2, 3, 2, 2)],
                                  attrs=[{}, {"mode": "channel"},
                                         {"mode": "instance"}])

# -- reductions --------------------------------------------------------------
_RED_ATTRS = [{}, {"axis": 1, "keepdims": True},
              {"axis": (0, 2), "exclude": True}]
for _n in ("sum", "mean", "max", "min"):
    SPECS[_n] = spec(DISTINCT, attrs=_RED_ATTRS)
SPECS["prod"] = spec(U(0.6, 1.4), attrs=_RED_ATTRS)


def NANS(rng, s):
    x = rng.uniform(0.6, 1.4, s).astype(np.float32)
    x.reshape(-1)[::3] = np.nan
    return [x]


SPECS["nansum"] = spec(NANS, attrs=_RED_ATTRS)
SPECS["nanprod"] = spec(NANS, attrs=_RED_ATTRS)
SPECS["norm"] = spec(SIGNED(0.1, 2), attrs=[{}, {"ord": 1, "axis": 1},
                                            {"axis": (1, 2),
                                             "keepdims": True}])
SPECS["argmax"] = spec(INTS(0, 4), attrs=[{}, {"axis": 1, "keepdims": True},
                                         {"axis": 2}])
SPECS["argmin"] = spec(INTS(0, 4), attrs=[{"axis": 0}, {"axis": 1},
                                         {"axis": -1, "keepdims": True}])
SPECS["argmax_channel"] = spec(INTS(0, 4), shapes=[(3, 4), (2, 5),
                                                   (2, 3, 4)])
SPECS["sort"] = spec(DISTINCT, attrs=[{}, {"axis": 0, "is_ascend": False},
                                      {"axis": None}])
SPECS["argsort"] = spec(INTS(0, 4), attrs=[{}, {"axis": 0,
                                                "is_ascend": False},
                                           {"dtype": "int32"}])
SPECS["topk"] = spec(DISTINCT, shapes=[(7,), (2, 5), (2, 3, 4), (3, 6)],
                     attrs=[{"k": 3, "ret_typ": "value"},
                            {"k": 2, "ret_typ": "indices",
                             "is_ascend": True},
                            {"k": 2, "axis": 1, "ret_typ": "both"},
                            {"k": 2, "axis": 0, "ret_typ": "mask"}])
SPECS["L2Normalization"] = spec(SIGNED(0.1, 2), shapes=[(2, 5), (2, 3, 4),
                                                        (2, 3, 2, 2)],
                                attrs=[{}, {"mode": "channel"},
                                       {"mode": "spatial"}])


def EDGES(rng, s):
    x = rng.uniform(0, 1, s).astype(np.float32)
    return [x, np.array([0.0, 0.1, 0.45, 0.5, 0.9], np.float32)]


SPECS["_histogram"] = spec(U(0, 1), attrs=[{"bin_cnt": 5, "range": (0, 1)},
                                           {"bin_cnt": 4},
                                           {"bin_cnt": 3,
                                            "range": (0.2, 0.8)}])
SPECS["histogram"] = spec(EDGES)

# -- creation ----------------------------------------------------------------
NONE = lambda rng, s: []  # noqa: E731
SPECS["_zeros"] = spec(NONE, attrs=[{"shape": (3,)}, {"shape": (2, 4)},
                                    {"shape": (2, 1, 3), "dtype": "int32"}])
SPECS["_ones"] = spec(NONE, attrs=[{"shape": (3,)}, {"shape": (2, 4)},
                                   {"shape": (2, 3), "dtype": "uint8"}])
SPECS["_full"] = spec(NONE, attrs=[{"shape": (3,), "value": 2.5},
                                   {"shape": (2, 4), "value": -1.0},
                                   {"shape": (2, 3), "value": 7,
                                    "dtype": "int32"}])
SPECS["_arange"] = spec(NONE, attrs=[{"start": 5}, {"start": 1.0,
                                                    "stop": 4.0,
                                                    "step": 0.5},
                                     {"start": 2, "stop": 11, "step": 3,
                                      "repeat": 2, "dtype": "int32"}])
SPECS["_linspace"] = spec(NONE, attrs=[{"start": 0.0, "stop": 1.0,
                                        "num": 5},
                                       {"start": -2.0, "stop": 3.0,
                                        "num": 7, "endpoint": False},
                                       {"start": 1.0, "stop": 10.0,
                                        "num": 10}])
SPECS["_eye"] = spec(NONE, attrs=[{"N": 3}, {"N": 3, "M": 5, "k": 1},
                                  {"N": 4, "M": 2, "k": -1,
                                   "dtype": "int32"}])

# -- shape and indexing ------------------------------------------------------
SPECS["Reshape"] = spec(U(-2, 2), shapes=[(2, 3, 4), (6, 4), (2, 3, 4)],
                        attrs=[{"shape": (0, -1)}, {"shape": (-4, 2, 3, -2)},
                               {"shape": (-3, 0)}])
SPECS["reshape_like"] = spec(lambda rng, s: U(-2, 2)(rng, s[0])
                             + U(-2, 2)(rng, s[1]),
                             shapes=[((6,), (2, 3)), ((2, 6), (3, 4)),
                                     ((2, 3, 4), (4, 6))], grad=[0])
SPECS["Flatten"] = spec(U(-2, 2), shapes=[(2, 3), (2, 3, 4), (2, 1, 2, 3)])
SPECS["transpose"] = spec(U(-2, 2), attrs=[{}, {"axes": (1, 0)},
                                           {"axes": (2, 0, 1)}])
SPECS["expand_dims"] = spec(U(-2, 2), attrs=[{"axis": 0}, {"axis": 2},
                                             {"axis": -1}])
SPECS["squeeze"] = spec(U(-2, 2), shapes=[(1, 7), (2, 1, 5, 1),
                                          (1, 3, 1)],
                        attrs=[{}, {"axis": 1}, {"axis": (0, 2)}])
SPECS["swapaxes"] = spec(U(-2, 2), shapes=[(2, 5), (2, 3, 4), (2, 3, 4)],
                         attrs=[{"dim1": 0, "dim2": 1},
                                {"dim1": 0, "dim2": 2},
                                {"dim1": 2, "dim2": 1}])
SPECS["slice"] = spec(U(-2, 2), shapes=[(7,), (4, 5), (3, 4, 5)],
                      attrs=[{"begin": (1,), "end": (6,), "step": (2,)},
                             {"begin": (None, 4), "end": (3, 0),
                              "step": (1, -2)},
                             {"begin": (0, 1, None), "end": (2, 3, None),
                              "step": (None, None, -1)}])
SPECS["slice_axis"] = spec(U(-2, 2), shapes=[(7,), (4, 5), (3, 4, 5)],
                           attrs=[{"axis": 0, "begin": 1, "end": 5},
                                  {"axis": 1, "begin": 2, "end": None},
                                  {"axis": -1, "begin": 0, "end": 3}])
SPECS["slice_like"] = spec(lambda rng, s: U(-2, 2)(rng, s[0])
                           + U(-2, 2)(rng, s[1]),
                           shapes=[((5,), (3,)), ((4, 5), (2, 3)),
                                   ((3, 4, 5), (2, 2, 2))],
                           attrs=[{}, {"axes": (1,)}, {"axes": (0, 2)}],
                           grad=[0])
SPECS["Concat"] = spec(lambda rng, s: [rng.uniform(-1, 1, x).astype(
    np.float32) for x in s],
    shapes=[((3,), (4,)), ((2, 3), (2, 1), (2, 2)),
            ((2, 3, 4), (1, 3, 4))],
    attrs=[{"dim": 0}, {"dim": 1}, {"dim": 0}])
SPECS["stack"] = spec(SAME(U(-2, 2), U(-2, 2)), attrs=[{}, {"axis": 1},
                                                       {"axis": -1}])
SPECS["SliceChannel"] = spec(U(-2, 2), shapes=[(6,), (2, 6), (2, 4, 3)],
                             attrs=[{"num_outputs": 3, "axis": 0},
                                    {"num_outputs": 2},
                                    {"num_outputs": 4, "axis": 1,
                                     "squeeze_axis": True}])
SPECS["tile"] = spec(U(-2, 2), attrs=[{"reps": (2,)}, {"reps": (2, 1, 3)},
                                      {"reps": (1, 2)}])
SPECS["repeat"] = spec(U(-2, 2), attrs=[{"repeats": 2},
                                        {"repeats": 3, "axis": 1},
                                        {"repeats": 2, "axis": -1}])
SPECS["reverse"] = spec(U(-2, 2), attrs=[{"axis": 0}, {"axis": 1},
                                         {"axis": (0, 2)}])
SPECS["Pad"] = spec(U(-2, 2), shapes=[(2, 3, 4, 5), (1, 2, 5, 4),
                                      (2, 2, 3, 3)],
                    attrs=[{"mode": "constant",
                            "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                            "constant_value": 0.5},
                           {"mode": "edge",
                            "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
                           {"mode": "reflect",
                            "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}])
SPECS["broadcast_to"] = spec(U(-2, 2), shapes=[(1,), (2, 1), (1, 3, 1)],
                             attrs=[{"shape": (5,)}, {"shape": (0, 4)},
                                    {"shape": (2, 3, 4)}])
SPECS["broadcast_like"] = spec(lambda rng, s: U(-2, 2)(rng, s[0])
                               + U(-2, 2)(rng, s[1]),
                               shapes=[((1,), (4,)), ((2, 1), (2, 3)),
                                       ((1, 3, 1), (2, 3, 2))], grad=[0])
SPECS["broadcast_axis"] = spec(U(-2, 2), shapes=[(1,), (2, 1), (1, 3, 1)],
                               attrs=[{"axis": 0, "size": 3},
                                      {"axis": (1,), "size": (4,)},
                                      {"axis": (0, 2), "size": (2, 5)}])
SPECS["dot"] = spec(lambda rng, s: U(-1, 1)(rng, s[0]) + U(-1, 1)(rng, s[1]),
                    shapes=[((5,), (5,)), ((3, 4), (3, 5)),
                            ((2, 3, 4), (5, 4))],
                    attrs=[{}, {"transpose_a": True},
                           {"transpose_b": True}])
SPECS["batch_dot"] = spec(lambda rng, s: U(-1, 1)(rng, s[0])
                          + U(-1, 1)(rng, s[1]),
                          shapes=[((2, 3, 4), (2, 4, 5)),
                                  ((3, 4, 2), (3, 4, 5)),
                                  ((2, 3, 4), (2, 5, 4))],
                          attrs=[{}, {"transpose_a": True},
                                 {"transpose_b": True}])
SPECS["khatri_rao"] = spec(lambda rng, s: [rng.uniform(-1, 1, x).astype(
    np.float32) for x in s], shapes=[((2, 3), (4, 3)),
                                     ((3, 2), (2, 2), (2, 2)),
                                     ((1, 4), (3, 4))])


def INDEXED(data_lo, idx_lo, idx_hi):
    """(data, float indices in [idx_lo, idx_hi)): ``s`` is (data shape,
    index shape)."""
    def make(rng, s):
        return [rng.uniform(-2, 2, s[0]).astype(np.float32),
                rng.randint(idx_lo, idx_hi, s[1]).astype(np.float32)]
    return make


SPECS["take"] = spec(INDEXED(-2, -3, 9), shapes=[((5,), (4,)),
                                                 ((6, 3), (2, 3)),
                                                 ((2, 7, 3), (5,))],
                     attrs=[{}, {"mode": "wrap"}, {"axis": 1,
                                                   "mode": "wrap"}],
                     grad=[0])
SPECS["batch_take"] = spec(INDEXED(-2, 0, 3), shapes=[((4, 3), (4,)),
                                                      ((2, 5), (2,)),
                                                      ((6, 3), (6,))],
                           grad=[0])
SPECS["pick"] = spec(INDEXED(-2, 0, 3), shapes=[((4, 3), (4,)),
                                                ((2, 3, 5), (2, 5)),
                                                ((6, 3), (6,))],
                     attrs=[{}, {"axis": 1, "keepdims": True}, {}],
                     grad=[0])
SPECS["Embedding"] = spec(lambda rng, s: [
    rng.randint(0, 6, s).astype(np.float32),
    rng.uniform(-1, 1, (6, 4)).astype(np.float32)],
    attrs={"input_dim": 6, "output_dim": 4}, grad=[1])
SPECS["one_hot"] = spec(INTS(-1, 6), attrs=[{"depth": 6},
                                            {"depth": 4, "on_value": 2.0,
                                             "off_value": -1.0},
                                            {"depth": 5,
                                             "dtype": "int32"}])


def GATHER(rng, s):
    data_shape, m, n = s
    idx = np.stack([rng.randint(0, data_shape[i], n) for i in range(m)])
    return [rng.uniform(-2, 2, data_shape).astype(np.float32),
            idx.astype(np.float32)]


SPECS["gather_nd"] = spec(GATHER, shapes=[((5,), 1, 4), ((3, 4), 2, 5),
                                          ((2, 3, 4), 2, 3)], grad=[0])


def SCATTER(rng, s):
    shape, m, n = s
    flat = rng.permutation(int(np.prod(shape[:m])))[:n]
    idx = np.stack(np.unravel_index(flat, shape[:m]))
    return [rng.uniform(-2, 2, (n,) + tuple(shape[m:])).astype(np.float32),
            idx.astype(np.float32)]


SPECS["scatter_nd"] = spec(SCATTER, shapes=[((6,), 1, 3), ((3, 4), 2, 5),
                                            ((3, 4, 2), 1, 2)],
                           attrs=[{"shape": (6,)}, {"shape": (3, 4)},
                                  {"shape": (3, 4, 2)}], grad=[0])
SPECS["where"] = spec(SAME(INTS(0, 2), U(-2, 2), U(-2, 2)), grad=[1, 2])
SPECS["boolean_mask_scalar_fill"] = spec(SAME(U(-2, 2), INTS(0, 2)),
                                         attrs=[{}, {"value": -1.5},
                                                {"value": 3.0}], grad=[0])
SPECS["diag"] = spec(U(-2, 2), shapes=[(4,), (3, 5), (2, 3, 4)],
                     attrs=[{"k": 1}, {}, {"k": -1}])


def SEQ(rng, s):
    shape, axis = s
    n = shape[1 - axis]
    return [rng.uniform(-2, 2, shape).astype(np.float32),
            rng.randint(1, shape[axis] + 1, n).astype(np.float32)]


SEQ_SHAPES = [((5, 3), 0), ((4, 2, 3), 0), ((3, 5, 2), 1)]
SPECS["SequenceMask"] = spec(SEQ, shapes=SEQ_SHAPES,
                             attrs=[{"use_sequence_length": True},
                                    {"use_sequence_length": True,
                                     "value": -1.0},
                                    {"use_sequence_length": True,
                                     "axis": 1}], grad=[0])
SPECS["SequenceLast"] = spec(SEQ, shapes=SEQ_SHAPES,
                             attrs=[{"use_sequence_length": True}, {},
                                    {"use_sequence_length": True,
                                     "axis": 1}], grad=[0])
SPECS["SequenceReverse"] = spec(SEQ, shapes=SEQ_SHAPES[:2] + [
    ((6, 2, 2), 0)], attrs=[{"use_sequence_length": True}, {},
                            {"use_sequence_length": True}], grad=[0])
SPECS["space_to_depth"] = spec(U(-2, 2), shapes=[(1, 2, 4, 4),
                                                 (2, 1, 6, 4),
                                                 (1, 3, 2, 2)],
                               attrs=[{"block_size": 2}] * 3)
SPECS["depth_to_space"] = spec(U(-2, 2), shapes=[(1, 8, 2, 2),
                                                 (2, 4, 3, 2),
                                                 (1, 9, 1, 2)],
                               attrs=[{"block_size": 2}, {"block_size": 2},
                                      {"block_size": 3}])
SPECS["_getitem"] = spec(U(-2, 2), shapes=[(7,), (4, 5), (3, 4, 5)],
                         attrs=[{"key": (("s", None, None, -2),)},
                                {"key": (("i", 1), ("s", 4, 0, -1))},
                                {"key": (("e",), ("n",), ("s", 1, 4, 2))}])


def RAVEL(rng, s):
    shape, n = s
    return [np.stack([rng.randint(0, d, n) for d in shape]).astype(
        np.float32)]


SPECS["_ravel_multi_index"] = spec(RAVEL, shapes=[((5,), 3), ((3, 4), 5),
                                                  ((2, 3, 4), 4)],
                                   attrs=[{"shape": (5,)},
                                          {"shape": (3, 4)},
                                          {"shape": (2, 3, 4)}])
SPECS["_unravel_index"] = spec(lambda rng, s: [rng.randint(
    0, int(np.prod(s[0])), s[1]).astype(np.float32)],
    shapes=[((5,), 3), ((3, 4), 5), ((2, 3, 4), 4)],
    attrs=[{"shape": (5,)}, {"shape": (3, 4)}, {"shape": (2, 3, 4)}])
SPECS["Crop"] = spec(lambda rng, s: [rng.uniform(-2, 2, x).astype(
    np.float32) for x in s], shapes=[((1, 2, 6, 7),), ((2, 1, 5, 5),),
                                     ((1, 2, 6, 6), (1, 1, 3, 4))],
    attrs=[{"h_w": (3, 4), "offset": (1, 2)},
           {"h_w": (3, 3), "center_crop": True},
           {"num_args": 2, "center_crop": True}], grad=[0])

# -- nn -------------------------------------------------------------------
SPECS["FullyConnected"] = spec(lambda rng, s: [
    rng.uniform(-1, 1, s[0]).astype(np.float32),
    rng.uniform(-1, 1, (4, s[1])).astype(np.float32),
    rng.uniform(-1, 1, (4,)).astype(np.float32)],
    shapes=[((2, 5), 5), ((3, 2, 3), 6), ((2, 3, 4), 4)],
    attrs=[{"num_hidden": 4}, {"num_hidden": 4},
           {"num_hidden": 4, "flatten": False}])


def CONV(cin_per_group_w):
    def make(rng, s):
        x_shape, w_shape = s
        return [rng.uniform(-1, 1, x_shape).astype(np.float32),
                rng.uniform(-1, 1, w_shape).astype(np.float32),
                rng.uniform(-1, 1, (w_shape[0] if cin_per_group_w
                                    else w_shape[1],)).astype(np.float32)]
    return make


SPECS["Convolution"] = spec(CONV(True), shapes=[
    ((2, 3, 9), (4, 3, 3)), ((2, 4, 7, 6), (6, 2, 3, 3)),
    ((1, 4, 8, 8), (4, 1, 3, 3))],
    attrs=[{"kernel": (3,), "num_filter": 4, "stride": (2,), "pad": (1,)},
           {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
            "dilate": (2, 1)},
           {"kernel": (3, 3), "num_filter": 4, "num_group": 4,
            "pad": (1, 1), "stride": (2, 2), "no_bias": True}])
SPECS["Deconvolution"] = spec(lambda rng, s: [
    rng.uniform(-1, 1, s[0]).astype(np.float32),
    rng.uniform(-1, 1, s[1]).astype(np.float32),
    rng.uniform(-1, 1, (s[2],)).astype(np.float32)],
    shapes=[((2, 3, 5), (3, 4, 3), 4), ((1, 4, 5, 4), (4, 3, 3, 3), 6),
            ((2, 2, 3, 3), (2, 2, 4, 4), 2)],
    attrs=[{"kernel": (3,), "num_filter": 4, "stride": (2,), "pad": (1,),
            "adj": (1,), "no_bias": False},
           {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
            "stride": (2, 1)},
           {"kernel": (4, 4), "num_filter": 2, "stride": (2, 2),
            "pad": (1, 1), "no_bias": False}])
SPECS["Pooling"] = spec(DISTINCT, shapes=[(2, 3, 9), (1, 2, 7, 7),
                                          (2, 2, 6, 5), (1, 2, 4, 4)],
                        attrs=[{"kernel": (3,), "stride": (2,),
                                "pool_type": "avg"},
                               {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "max"},
                               {"kernel": (2, 3), "pool_type": "sum",
                                "pooling_convention": "full",
                                "stride": (2, 2)},
                               {"global_pool": True, "kernel": (1, 1),
                                "pool_type": "avg"}])
SPECS["UpSampling"] = spec(U(-2, 2), shapes=[(1, 2, 3, 3), (2, 1, 2, 4),
                                             (1, 3, 4, 2)],
                           attrs=[{"scale": 2}, {"scale": 3},
                                  {"scale": 2, "sample_type": "bilinear"}])


def NORM(c_axis):
    def make(rng, s):
        c = s[c_axis]
        return [rng.uniform(-2, 2, s).astype(np.float32),
                rng.uniform(0.5, 1.5, (c,)).astype(np.float32),
                rng.uniform(-1, 1, (c,)).astype(np.float32)]
    return make


def BN(rng, s):
    return NORM(1)(rng, s) + [rng.uniform(-1, 1, (s[1],)).astype(np.float32),
                              rng.uniform(0.5, 2, (s[1],)).astype(np.float32)]


SPECS["BatchNorm"] = spec(BN, shapes=[(4, 3), (2, 3, 4), (2, 2, 3, 3)],
                          attrs=[{"fix_gamma": False},
                                 {"fix_gamma": False,
                                  "output_mean_var": True},
                                 {"use_global_stats": True,
                                  "fix_gamma": False, "eps": 1e-5}],
                          no_grad=(3, 4))
SPECS["LayerNorm"] = spec(NORM(-1), shapes=[(3, 5), (2, 3, 4), (2, 3, 4)],
                          attrs=[{}, {"output_mean_var": True},
                                 {"eps": 1e-3}])
SPECS["InstanceNorm"] = spec(NORM(1), shapes=[(2, 3, 5), (2, 2, 3, 4),
                                              (1, 3, 2, 2, 2)])
SPECS["LRN"] = spec(U(-2, 2), shapes=[(2, 6, 3, 3), (1, 3, 4, 4),
                                      (2, 8, 2, 2)],
                    attrs=[{}, {"nsize": 3, "alpha": 1e-2, "beta": 0.5},
                           {"nsize": 5, "knorm": 1.0, "alpha": 0.1}])
SPECS["Activation"] = spec(SIGNED(0.05, 2), shapes=UNARY_SHAPES * 2,
                           attrs=[{}, {"act_type": "sigmoid"},
                                  {"act_type": "tanh"},
                                  {"act_type": "softrelu"},
                                  {"act_type": "softsign"}, {}])
SPECS["LeakyReLU"] = spec(lambda rng, s: SIGNED(0.05, 2)(rng, s)
                          + [rng.uniform(0.1, 0.5, (s[1],)).astype(
                              np.float32)],
                          shapes=[(2, 5), (2, 3, 4), (2, 3), (3, 2, 2),
                                  (2, 4)],
                          attrs=[{"act_type": "leaky", "slope": 0.1},
                                 {"act_type": "prelu"},
                                 {"act_type": "elu", "slope": 0.7},
                                 {"act_type": "selu"},
                                 {"act_type": "gelu"}])
for _n in ("softmax", "log_softmax", "softmin"):
    SPECS[_n] = spec(U(-2, 2), attrs=[{}, {"axis": 0},
                                      {"axis": 1, "temperature": 2.0}])


def LOGITS(rng, s):
    return [rng.uniform(-2, 2, s).astype(np.float32),
            rng.randint(0, s[-1], s[0]).astype(np.float32)]


SPECS["softmax_cross_entropy"] = spec(LOGITS, shapes=[(3, 4), (2, 7),
                                                      (5, 3)], grad=[0])
SPECS["SoftmaxOutput"] = spec(LOGITS, shapes=[(3, 4), (2, 7), (5, 3)],
                              attrs=[{}, {"grad_scale": 0.5,
                                          "normalization": "batch"},
                                     {"smooth_alpha": 0.1}], grad=[0])
for _n in ("LinearRegressionOutput", "LogisticRegressionOutput",
           "MAERegressionOutput"):
    SPECS[_n] = spec(lambda rng, s: [
        rng.uniform(-2, 2, s).astype(np.float32),
        rng.uniform(-2, 2, s).astype(np.float32)],
        shapes=[(4,), (3, 2), (2, 3)],
        attrs=[{}, {"grad_scale": 0.5}, {}], grad=[0])
SPECS["Dropout"] = spec(U(-2, 2), attrs=[{"p": 0.0, "mode": "always"},
                                         {"p": 0.5, "train_mode": False},
                                         {"p": 0.0, "axes": (0,)}])


# ---------------------------------------------------------------------------
# running one case in one package on one device
# ---------------------------------------------------------------------------

def attrs_at(sp, i):
    a = sp["attrs"]
    return dict(a[i] if isinstance(a, list) else (a or {}))


def wanted_grads(sp, inputs, differentiable):
    """The inputs whose gradients a case holds."""
    if not differentiable:
        return []
    floats = [k for k, a in enumerate(inputs) if a.dtype.kind == "f"]
    return sp["grad"] if sp["grad"] is not None else \
        [k for k in floats if k not in sp["no_grad"]]


def run_case(mx, name, inputs, attrs, want_grad, heads, rng_heads,
             ctx=None):
    """Op ``name`` of package ``mx`` on ``inputs`` (numpy) placed on
    ``ctx`` (default ``mx.cpu()``): (outputs, the gradients of
    ``sum(out * head)`` with respect to the inputs ``want_grad``, the
    output NDArrays). ``heads`` (output index -> numpy) is filled from
    ``rng_heads`` where empty, so that a second call uses the same."""
    ctx = mx.cpu() if ctx is None else ctx
    arrs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    for i in want_grad:
        arrs[i].attach_grad()
    with ctx:
        if not want_grad:
            out = mx.nd.invoke_op(name, arrs, attrs)
            outs = out if isinstance(out, list) else [out]
            return [o.asnumpy() for o in outs], None, outs
        with mx.autograd.record():
            out = mx.nd.invoke_op(name, arrs, attrs)
            outs = out if isinstance(out, list) else [out]
            loss = None
            for j, o in enumerate(outs):
                if np.dtype(o.dtype).kind != "f":
                    continue
                if j not in heads:
                    heads[j] = rng_heads.uniform(-1, 1, o.shape).astype(
                        o.dtype)
                term = (o * mx.nd.array(heads[j], ctx=ctx,
                                        dtype=o.dtype)).sum()
                loss = term if loss is None else loss + term
            for i in want_grad:
                term = (arrs[i] * 0.0).sum()
                loss = term if loss is None else loss + term
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [arrs[i].grad.asnumpy() for i in want_grad], outs)


def close(got, want, tol, what):
    """``got`` against ``want``: the same shape and type; integer (and
    float16) values bitwise (float16 within ``tol``), float values within
    ``tol`` of ``want``'s largest finite magnitude, non-finite where it
    is."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind != "f" or str(want.dtype) == "float16":
        if str(want.dtype) == "float16":
            got, want = got.astype(np.float32), want.astype(np.float32)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
            return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= tol * scale, "%s: max err %g > %g x %g" % (what, err, tol,
                                                             scale)
