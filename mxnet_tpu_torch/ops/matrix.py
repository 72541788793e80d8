"""Shape, indexing and linear-algebra operators (the JAX package's
``ops/matrix.py``): ``Reshape`` with MXNet's special codes and the other
shape ops, ``slice`` / ``_getitem`` (negative steps included: the
elements of the positive-step slice over the same range, flipped),
concatenation and splitting, ``tile`` / ``repeat`` / ``flip`` / ``Pad``,
the ``broadcast_*`` shape ops, ``dot`` / ``batch_dot`` (cuBLAS, as the
JAX package leaves them to XLA) and ``khatri_rao``, the gathers and
scatters (``take`` with ``clip`` and ``wrap``, ``Embedding``,
``one_hot``, ``gather_nd``, ``scatter_nd``, ``pick``), the sequence ops,
``space_to_depth`` / ``depth_to_space``, the index ravels, ``diag`` and
``Crop``. Indices given as floats are truncated toward zero, as the JAX
package's ``astype(int32)``."""
from __future__ import annotations

import torch

import torch.nn.functional as F

from ..base import MXNetError
from .registry import alias, register


@register("Flatten")
def _flatten(x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


def infer_reshape(src_shape, target, reverse=False):
    """The output shape of ``Reshape(shape=target)`` on ``src_shape``,
    with the special codes 0 (copy a dim), -1 (infer), -2 (copy the
    rest), -3 (merge two), -4 (split one in two) (reference:
    src/operator/tensor/matrix_op-inl.h InferReshapeShape; the JAX
    package's ``ops/matrix.py`` ``infer_reshape``)."""
    tgt = list(target)
    groups = []
    i = 0
    while i < len(tgt):
        if tgt[i] == -4:
            if i + 2 >= len(tgt):
                raise MXNetError("reshape: -4 needs two following entries")
            groups.append((tgt[i], tgt[i + 1], tgt[i + 2]))
            i += 3
        else:
            groups.append((tgt[i],))
            i += 1
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        groups = groups[::-1]
    out = []
    src_i = 0
    infer_idx = -1
    for g in groups:
        t = g[0]
        if t > 0:
            out.append(t)
            src_i += 1
        elif t == 0:
            if src_i >= len(src):
                raise MXNetError("reshape: 0 out of bounds")
            out.append(src[src_i])
            src_i += 1
        elif t == -1:
            if infer_idx >= 0:
                raise MXNetError("reshape: more than one -1")
            infer_idx = len(out)
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif t == -3:
            if src_i + 1 >= len(src):
                raise MXNetError("reshape: -3 needs two source dims")
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif t == -4:
            if src_i >= len(src):
                raise MXNetError("reshape: -4 out of source dims")
            d1, d2 = (g[2], g[1]) if reverse else (g[1], g[2])
            d = src[src_i]
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape: -4 with two -1s")
            if d1 == -1:
                d1 = d // d2
            if d2 == -1:
                d2 = d // d1
            out.extend([d1, d2])
            src_i += 1
        else:
            raise MXNetError("reshape: invalid code %d" % t)
    total = 1
    for s in src_shape:
        total *= s
    if infer_idx >= 0:
        known = 1
        for j, v in enumerate(out):
            if j != infer_idx:
                known *= v
        out[infer_idx] = total // known
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", attr_defaults={"shape": None, "reverse": False})
def _reshape(x, shape=None, reverse=False):
    return x.reshape(infer_reshape(tuple(x.shape), shape, reverse))


alias("reshape", "Reshape")


@register("reshape_like")
def _reshape_like(x, y):
    return x.reshape(y.shape)


@register("transpose", attr_defaults={"axes": None})
def _transpose(x, axes=None):
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register("expand_dims", attr_defaults={"axis": 0})
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("slice_axis", attr_defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(x, axis=0, begin=0, end=None):
    return x[(slice(None),) * (axis % x.dim()) + (slice(begin, end),)]


@register("pick", attr_defaults={"axis": -1, "keepdims": False,
                                 "mode": "clip"})
def _pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x``'s entry at ``index`` along ``axis``; indices are truncated
    to integers and clipped into range."""
    axis = axis % x.dim()
    idx = torch.clamp(index.long(), 0, x.shape[axis] - 1)
    if idx.dim() < x.dim():
        idx = idx.unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("where")
def _where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("squeeze", attr_defaults={"axis": None})
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("swapaxes", attr_defaults={"dim1": 0, "dim2": 0})
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


alias("SwapAxis", "swapaxes")


# ---------------------------------------------------------------------------
# basic indexing, negative steps included
# ---------------------------------------------------------------------------

def _positive_slices(shape, key):
    """``key`` (ints, slices of any step, Ellipsis, None) as a key of
    ints, positive-step slices and None over a tensor of ``shape``, and
    the output dims to flip afterwards: a negative-step slice selects
    the elements of a positive-step slice over the same range, in the
    reverse order."""
    if not isinstance(key, tuple):
        key = (key,)
    used = sum(1 for k in key if k is not None and k is not Ellipsis)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - used) + key[i + 1:]
    out, flips, dim, out_dim = [], [], 0, 0
    for k in key:
        if k is None:
            out.append(None)
            out_dim += 1
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            start, stop, step = k.indices(shape[dim])
            count = len(range(start, stop, step))
            if count:
                low = start + (count - 1) * step
                k = slice(low, start + 1, -step)
            else:
                k = slice(0, 0)
            flips.append(out_dim)
        out.append(k)
        dim += 1
        if isinstance(k, slice):
            out_dim += 1
    return tuple(out), flips


def basic_getitem(x, key):
    """``x[key]`` with numpy's meaning of a negative step."""
    k, flips = _positive_slices(tuple(x.shape), key)
    out = x[k]
    return out.flip(flips) if flips else out


def basic_setitem(x, key, value):
    """``x[key] = value`` in place, with numpy's meaning of a negative
    step."""
    k, flips = _positive_slices(tuple(x.shape), key)
    if flips and isinstance(value, torch.Tensor):
        value = torch.broadcast_to(value, x[k].shape).flip(flips)
    x[k] = value


def encode_index_key(key):
    """An int / slice / Ellipsis / None key as a hashable attr (the JAX
    package's encoding); None for any other key."""
    if not isinstance(key, tuple):
        key = (key,)
    out = []
    for k in key:
        if isinstance(k, bool):
            return None
        if isinstance(k, int) or (hasattr(k, "__index__")
                                  and not isinstance(k, torch.Tensor)):
            out.append(("i", int(k)))
        elif isinstance(k, slice):
            out.append(("s", k.start, k.stop, k.step))
        elif k is Ellipsis:
            out.append(("e",))
        elif k is None:
            out.append(("n",))
        else:
            return None
    return tuple(out)


def decode_index_key(enc):
    out = []
    for item in enc:
        tag = item[0]
        if tag == "i":
            out.append(item[1])
        elif tag == "s":
            out.append(slice(item[1], item[2], item[3]))
        elif tag == "e":
            out.append(Ellipsis)
        else:
            out.append(None)
    return tuple(out)


@register("_getitem", attr_defaults={"key": ()})
def _getitem(data, key=()):
    """Basic indexing by an encoded key (``encode_index_key``)."""
    return basic_getitem(data, decode_index_key(key))


@register("slice", attr_defaults={"begin": (), "end": (), "step": ()})
def _slice(x, begin=(), end=(), step=()):
    step = step or (None,) * len(begin)
    return basic_getitem(x, tuple(slice(b, e, s)
                                  for b, e, s in zip(begin, end, step)))


@register("slice_like", attr_defaults={"axes": ()})
def _slice_like(x, like, axes=()):
    axes = axes or tuple(range(min(x.dim(), like.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, like.shape[a % like.dim()])
    return x[tuple(idx)]


# ---------------------------------------------------------------------------
# joining, splitting, repeating
# ---------------------------------------------------------------------------

@register("Concat", attr_defaults={"dim": 1})
def _concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


alias("concat", "Concat")


@register("stack", attr_defaults={"axis": 0})
def _stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


def _split_n_outputs(attrs):
    return int(dict(attrs)["num_outputs"])


@register("SliceChannel", num_outputs=_split_n_outputs,
          attr_defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False})
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    n = int(num_outputs)
    if x.shape[axis] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d" % (axis, x.shape[axis], n))
    parts = torch.split(x, x.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


alias("split", "SliceChannel")


@register("tile", attr_defaults={"reps": ()})
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat", attr_defaults={"repeats": 1, "axis": None})
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, int(repeats), dim=axis)


@register("reverse", attr_defaults={"axis": 0})
def _reverse(x, axis=0):
    return x.flip((axis,) if isinstance(axis, int) else tuple(axis))


alias("flip", "reverse")


@register("Pad", attr_defaults={"mode": "constant", "pad_width": (),
                                "constant_value": 0.0})
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is (before, after) for every axis, first axis first;
    ``edge`` and ``reflect`` pad the axes after the first two."""
    pairs = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
             for i in range(len(pad_width) // 2)]
    if mode == "constant":
        spans = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, spans, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad mode %r (constant, edge, reflect)" % (mode,))
    if any(p for pair in pairs[:2] for p in pair):
        raise MXNetError("Pad %s: the first two axes take no padding"
                         % mode)
    spans = [p for pair in reversed(pairs[2:]) for p in pair]
    return F.pad(x, spans, mode="replicate" if mode == "edge" else mode)


alias("pad", "Pad")


# ---------------------------------------------------------------------------
# broadcasting to a shape
# ---------------------------------------------------------------------------

@register("broadcast_to", attr_defaults={"shape": ()})
def _broadcast_to(x, shape=()):
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape))
    return x.expand(tgt).contiguous()


@register("broadcast_like")
def _broadcast_like(x, like):
    return x.expand(like.shape).contiguous()


@register("broadcast_axis", attr_defaults={"axis": (), "size": ()})
def _broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    tgt = list(x.shape)
    for a, n in zip(axis, size):
        tgt[a] = n
    return x.expand(tgt).contiguous()


alias("broadcast_axes", "broadcast_axis")


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

@register("dot", attr_defaults={"transpose_a": False, "transpose_b": False})
def _dot(a, b, transpose_a=False, transpose_b=False):
    """The last axis of ``a`` against the first of ``b``;
    ``transpose_a`` moves ``a``'s first axis last, ``transpose_b``
    ``b``'s last axis first (reference: dot-inl.h)."""
    if transpose_a and a.dim() > 1:
        a = a.movedim(0, -1)
    if transpose_b and b.dim() > 1:
        b = b.movedim(-1, 0)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot", attr_defaults={"transpose_a": False,
                                      "transpose_b": False})
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("khatri_rao")
def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


# ---------------------------------------------------------------------------
# gathers and scatters
# ---------------------------------------------------------------------------

def _index(indices):
    """Indices as int64, truncated toward zero."""
    return indices if indices.dtype == torch.int64 else \
        indices.to(torch.int32).to(torch.int64)


def _take_along(x, idx, dim):
    """``torch.gather`` with ``jnp.take_along_axis``'s bounds: a negative
    index counts from the end once, and one still out of range gives the
    fill value (NaN; the least value of a signed integer type, the
    largest of an unsigned one) where torch raises or clamps (C.15)."""
    n = x.shape[dim]
    idx = torch.where(idx < 0, idx + n, idx)
    out = torch.gather(x, dim, idx.clamp(0, n - 1))
    if x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = True
    else:
        info = torch.iinfo(x.dtype)
        fill = info.min if info.min < 0 else info.max
    return torch.where((idx >= 0) & (idx < n), out,
                       torch.full_like(out, fill))


@register("take", attr_defaults={"axis": 0, "mode": "clip"})
def _take(x, indices, axis=0, mode="clip"):
    """``x``'s slices along ``axis`` at ``indices``: out-of-range indices
    clipped into range (``clip``) or taken modulo the axis (``wrap``)."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = _index(indices)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise MXNetError("take mode %r (clip, wrap)" % (mode,))
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@register("batch_take")
def _batch_take(x, indices):
    return _take_along(x, _index(indices)[:, None], 1)[:, 0]


@register("Embedding", attr_defaults={"input_dim": 0, "output_dim": 0,
                                      "dtype": "float32",
                                      "sparse_grad": False})
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """Rows of ``weight`` at ``data``, clipped into range."""
    return _take(weight, data, 0, "clip")


@register("one_hot", differentiable=False,
          attr_defaults={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                         "dtype": "float32"})
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32"):
    from ..ndarray.ndarray import to_torch_dtype
    idx = _index(indices)
    oh = (idx[..., None] == torch.arange(int(depth), device=idx.device)).to(
        torch.float32)
    return (oh * on_value + (1.0 - oh) * off_value).to(to_torch_dtype(dtype))


@register("gather_nd")
def _gather_nd(data, indices):
    """``data`` at the index tuples of ``indices``' first axis; as jnp
    indexing, a negative index counts from the end once and the result
    is then clamped into range (C.15)."""
    idx = _index(indices)
    return data[tuple(
        torch.where(idx[i] < 0, idx[i] + data.shape[i], idx[i]).clamp(
            0, data.shape[i] - 1) for i in range(idx.shape[0]))]


@register("scatter_nd", attr_defaults={"shape": ()})
def _scatter_nd(data, indices, shape=()):
    idx = _index(indices)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register("boolean_mask_scalar_fill", attr_defaults={"value": 0.0})
def _mask_fill(data, mask, value=0.0):
    return torch.where(mask.bool(), data,
                       torch.full_like(data, value))


@register("diag", attr_defaults={"k": 0})
def _diag(x, k=0):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# sequence ops: masks over the time axis
# ---------------------------------------------------------------------------

@register("SequenceMask", attr_defaults={"use_sequence_length": False,
                                         "value": 0.0, "axis": 0})
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``; data is
    (T, N, ...) for ``axis`` 0, (N, T, ...) for 1."""
    if not use_sequence_length or sequence_length is None:
        return data
    t = torch.arange(data.shape[axis], device=data.device)
    length = sequence_length.to(t.dtype)
    mask = t[:, None] < length[None, :] if axis == 0 \
        else t[None, :] < length[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full_like(data, value))


@register("SequenceLast", attr_defaults={"use_sequence_length": False,
                                         "axis": 0})
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step; a length of 0 reads the last
    step and one past the end the fill value, as the JAX package's
    ``take_along_axis`` (C.15)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    moved = data.movedim(axis, 0)
    last = _index(sequence_length) - 1
    idx = last.reshape((1, -1) + (1,) * (moved.dim() - 2)).expand(
        (1,) + moved.shape[1:])
    return _take_along(moved, idx, 0)[0]


@register("SequenceReverse", attr_defaults={"use_sequence_length": False,
                                            "axis": 0})
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """The first ``length`` steps of each sequence (time is axis 0)
    reversed, the rest kept."""
    if not use_sequence_length or sequence_length is None:
        return data.flip(0)
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    length = _index(sequence_length)[None, :]
    rev = torch.where(t < length, length - 1 - t, t)
    rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


@register("space_to_depth", attr_defaults={"block_size": 1})
def _space_to_depth(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space", attr_defaults={"block_size": 1})
def _depth_to_space(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


# ---------------------------------------------------------------------------
# index ravels (one multi-index per column) and Crop
# ---------------------------------------------------------------------------

@register("_ravel_multi_index", differentiable=False,
          attr_defaults={"shape": ()})
def _ravel_multi_index(data, shape=()):
    """(ndim, N) multi-indices to (N,) flat ones, each index clipped into
    its axis."""
    shape = tuple(int(s) for s in shape)
    flat = torch.zeros(data.shape[1:], dtype=torch.int64,
                       device=data.device)
    for i, n in enumerate(shape):
        flat = flat * n + _index(data[i]).clamp(0, n - 1)
    return flat.to(data.dtype)


alias("ravel_multi_index", "_ravel_multi_index")


@register("_unravel_index", differentiable=False,
          attr_defaults={"shape": ()})
def _unravel_index(data, shape=()):
    """(N,) flat indices to (ndim, N) multi-indices."""
    shape = tuple(int(s) for s in shape)
    rest = _index(data)
    rows = []
    for n in reversed(shape):
        rows.append(torch.remainder(rest, n))
        rest = torch.div(rest, n, rounding_mode="floor")
    return torch.stack(rows[::-1], dim=0).to(data.dtype)


alias("unravel_index", "_unravel_index")


@register("Crop", attr_defaults={"offset": (0, 0), "h_w": (0, 0),
                                 "center_crop": False, "num_args": 1})
def _crop(data, *like, offset=(0, 0), h_w=(0, 0), center_crop=False,
          num_args=1):
    """``data`` (N, C, H, W) cropped to ``h_w`` or to the spatial size of
    a second input, at ``offset`` or centred (reference: crop.cc)."""
    if like:
        th, tw = like[0].shape[2], like[0].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    if y0 < 0 or x0 < 0 or y0 + th > h or x0 + tw > w:
        raise MXNetError("Crop: window %dx%d at offset (%d,%d) exceeds input"
                         " %dx%d" % (th, tw, y0, x0, h, w))
    return data[:, :, y0:y0 + th, x0:x0 + tw]
