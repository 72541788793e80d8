"""One bound inference executor over a symbol JSON and a params blob.

Counterpart of the JAX package's ``serving.py`` (the Python side of the
C predict API, reference: include/mxnet/c_predict_api.h): ``Predictor``
binds the graph once, copies the parameters in, and then serves
``set_input`` / ``forward`` / ``get_output``; ``reshape`` derives a
predictor for other input shapes that shares the weight tensors, which
is what lets ``serve.InferenceEngine`` keep one executor per batch
bucket for the price of one copy of the weights.

The params blob is ``nd.save``'s format (either layout, from either
package); keys carry the reference's ``arg:`` / ``aux:`` prefixes (raw
names count as arguments). Every buffer binds in its checkpoint's type,
so the int8 weights of a quantized artifact stay int8; the int8
convolution weights that ``int8_conv_im2col``'s wgmma route takes are
bound once in channels-last memory (OHWI, K-major), so that no forward
copies them (the artifact's format is unchanged). ``dev_type`` is
the C API's: None (the default) or 2 binds on the card ``dev_id``, 1 on
the host. The telemetry endpoint (``serve_metrics``) is not ported yet
(ROADMAP A16).
"""
from __future__ import annotations

import numpy as np
import torch

from . import telemetry as _tm
from .base import MXNetError

__all__ = ["Predictor"]


def _device(dev_type, dev_id):
    from . import context as _ctx
    if dev_type is None or int(dev_type) == 2:
        return _ctx.default_device(_ctx.gpu(dev_id))
    if int(dev_type) == 1:
        return _ctx.cpu()
    raise MXNetError("dev_type %r: 1 (cpu), 2 (gpu) or None (gpu)"
                     % (dev_type,))


def _bind_conv_weights_channels_last(sym, exe):
    """Rebind, in channels-last memory, each int8 weight of a 2-D
    ``_contrib_quantized_conv_int8`` whose shape the wgmma route of
    ``int8_conv_im2col`` takes (idempotent: a weight already so stays)."""
    from .ops.cuda.int8_matmul import conv_wgmma_shape_ok
    from .symbol.symbol import _topo
    for node in _topo(sym._entries):
        if node.op != "_contrib_quantized_conv_int8" or len(node.inputs) < 2:
            continue
        arr = exe.arg_dict.get(node.inputs[1][0].name)
        a = node.attrs
        if arr is None or arr._data.dtype != torch.int8 \
                or arr._data.dim() != 4 or len(a.get("kernel") or ()) != 2:
            continue
        if conv_wgmma_shape_ok(arr.shape, tuple(a.get("stride") or (1, 1)),
                               tuple(a.get("dilate") or (1, 1)),
                               tuple(a.get("pad") or (0, 0)),
                               int(a.get("num_group", 1))):
            arr._set_data(arr._data.contiguous(
                memory_format=torch.channels_last))


class Predictor(object):
    """One bound inference executor (reference: c_predict_api.cc
    Predictor)."""

    def __init__(self, symbol_json, param_bytes, dev_type=None, dev_id=0,
                 input_shapes=None, input_types=None):
        from .ndarray.utils import load_bytes
        from .symbol import load_json
        sym = load_json(symbol_json)
        saved = load_bytes(param_bytes, name="<param blob>")
        if not isinstance(saved, dict):
            raise MXNetError("param blob must be a named-tensor dict")
        arg_params, aux_params = {}, {}
        for k, v in saved.items():
            if k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k[4:] if k.startswith("arg:") else k] = v
        self._sym = sym
        self._arg_params = arg_params
        self._aux_params = aux_params
        self._ctx = _device(dev_type, dev_id)
        self._input_types = {k: np.dtype(t)
                             for k, t in (input_types or {}).items()}
        shapes = dict(input_shapes or {})
        self._exe = sym.simple_bind(ctx=self._ctx, grad_req="null",
                                    type_dict=self._type_dict(), **shapes)
        for k, v in arg_params.items():
            if k in self._exe.arg_dict:
                self._exe.arg_dict[k][:] = v
        for k, v in aux_params.items():
            if k in self._exe.aux_dict:
                self._exe.aux_dict[k][:] = v
        _bind_conv_weights_channels_last(sym, self._exe)
        self._input_names = list(shapes)
        self._outputs = None

    def _type_dict(self):
        """Every buffer in its checkpoint type; inputs float32 unless
        ``input_types`` says otherwise."""
        type_dict = {k: v.dtype for k, v in self._arg_params.items()}
        type_dict.update({k: v.dtype for k, v in self._aux_params.items()})
        type_dict.update(self._input_types)
        return type_dict

    def set_input(self, key, data_bytes):
        """``data_bytes``: raw little-endian bytes in the bound input's
        type and shape."""
        if key not in self._exe.arg_dict:
            raise MXNetError("unknown input %r" % key)
        arr = self._exe.arg_dict[key]
        t = arr._data
        want = t.numel() * t.element_size()
        if len(data_bytes) != want:
            raise MXNetError(
                "input %r size mismatch: got %d bytes, want %d (shape %s, "
                "dtype %s)" % (key, len(data_bytes), want, arr.shape,
                               arr.dtype))
        if t.dtype == torch.bfloat16:
            flat = torch.frombuffer(bytearray(data_bytes),
                                    dtype=torch.bfloat16)
        else:
            dt = np.dtype(arr.dtype)
            wire = dt.newbyteorder("<") if dt.itemsize > 1 else dt
            flat = torch.from_numpy(np.frombuffer(
                data_bytes, dtype=wire).astype(dt))
        arr[:] = flat.reshape(arr.shape)

    def forward(self):
        t0 = _tm.monotonic()
        self._outputs = self._exe.forward(is_train=False)
        _tm.counter("serving/requests_total",
                    "Inference requests accepted").inc()
        _tm.histogram("serving/request_seconds",
                      "Inference request latency (host-side, submit to "
                      "result)").observe(_tm.monotonic() - t0)

    def num_outputs(self):
        self._ensure_forward()
        return len(self._outputs)

    def get_output_shape(self, index):
        self._ensure_forward()
        return tuple(int(d) for d in self._outputs[index].shape)

    def get_output(self, index):
        """Raw float32 little-endian bytes of output ``index``."""
        self._ensure_forward()
        t = self._outputs[index]._data.detach().float().cpu()
        return t.numpy().astype("<f4", copy=False).tobytes()

    def _ensure_forward(self):
        if self._outputs is None:
            raise MXNetError("call forward() first")

    def reshape(self, input_shapes):
        """A predictor bound for new input shapes (reference:
        MXPredReshape). Parameter and aux buffers whose shapes do not
        depend on the inputs are shared with this predictor
        (``Executor.alias_args``): no second copy of the weights."""
        input_shapes = dict(input_shapes)
        new = Predictor.__new__(Predictor)
        new._sym = self._sym
        new._arg_params = self._arg_params
        new._aux_params = self._aux_params
        new._ctx = self._ctx
        new._input_types = self._input_types
        new._exe = self._sym.simple_bind(ctx=self._ctx, grad_req="null",
                                         type_dict=self._type_dict(),
                                         **input_shapes)
        # never alias an input buffer, not even one this call leaves to
        # inference: set_input on one predictor must not feed the other
        no_share = set(input_shapes) | set(self._input_names)
        shared = [n for n in new._exe.arg_dict
                  if n not in no_share and n in self._exe.arg_dict
                  and new._exe.arg_dict[n].shape
                  == self._exe.arg_dict[n].shape]
        shared += [n for n in new._exe.aux_dict
                   if n in self._exe.aux_dict
                   and new._exe.aux_dict[n].shape
                   == self._exe.aux_dict[n].shape]
        new._exe.alias_args(self._exe, shared)
        resident = set(shared)
        for k, v in self._arg_params.items():
            if k in new._exe.arg_dict and k not in resident:
                new._exe.arg_dict[k][:] = v
        for k, v in self._aux_params.items():
            if k in new._exe.aux_dict and k not in resident:
                new._exe.aux_dict[k][:] = v
        _bind_conv_weights_channels_last(self._sym, new._exe)
        new._input_names = list(input_shapes) + [
            n for n in self._input_names if n not in input_shapes]
        new._outputs = None
        return new
