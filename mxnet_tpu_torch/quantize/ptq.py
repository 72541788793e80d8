"""Post-training quantization: trained checkpoint -> calibrated int8
serving artifact.

Counterpart of the JAX package's ``quantize/ptq.py``:

1. :func:`quantize_checkpoint` loads the newest valid checkpoint under a
   prefix (``checkpoint.load_latest_valid``: manifest checksums verified,
   torn checkpoints skipped), runs calibration batches through the fp32
   graph (``calibrate.py``) and rewrites every FullyConnected /
   Convolution into the per-channel int8 serving ops
   (``_contrib_quantized_fc_int8`` / ``_contrib_quantized_conv_int8``,
   which run the ``int8_matmul`` / ``int8_conv_im2col`` kernels).
2. The result is a :class:`QuantizedParams` artifact on disk: symbol JSON,
   params (int8 weights, float32 per-channel scales, the untouched fp32
   bias and aux) and a checksummed manifest with the calibration
   metadata, all through ``checkpoint.atomic_writer``. The files are the
   JAX package's: an artifact written by either package loads in the
   other.
3. ``serving.Predictor(qp.symbol_json, qp.param_bytes())`` serves it,
   alone or under ``serve.InferenceEngine``.

Weights get one exact float32 scale per output channel; activations one
calibrated scale per tensor. ``serve.ModelRegistry.swap(quantized=...)``
serves an artifact on a live server, ``enable_shadow`` canaries it.
"""
from __future__ import annotations

import json as _json
import logging

import numpy as np

from .. import telemetry as _tm
from ..base import MXNetError
from .calibrate import _host, collect_activation_ranges

__all__ = ["quantize_checkpoint", "quantize_symbol", "QuantizedParams",
           "validate_excluded_names"]

_QUANT_OPS = {"FullyConnected": "_contrib_quantized_fc_int8",
              "Convolution": "_contrib_quantized_conv_int8"}
_INT8_MAX = 127.0


def validate_excluded_names(symbol, excluded_sym_names):
    """Every entry of ``excluded_sym_names`` must name an op node of the
    graph (a typo'd exclusion would quantize the layer it meant to
    protect); raises :class:`MXNetError` naming the strangers, returns
    the set."""
    from ..symbol.symbol import _topo
    excluded = set(excluded_sym_names or ())
    node_names = {n.name for n in _topo(symbol._entries) if not n.is_var}
    strangers = sorted(excluded - node_names)
    if strangers:
        raise MXNetError(
            "excluded_sym_names %s name no op node in the graph "
            "(graph has: %s)" % (strangers, sorted(node_names)))
    return excluded


def _per_channel_quantize(w):
    """fp32 weight -> (int8 weight, fp32 per-channel scales), channel =
    axis 0. Zero-range channels get scale 1.0 and quantize to zeros."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w.reshape(w.shape[0], -1)), axis=1)
    scale = np.where(amax > 0, amax / _INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                -_INT8_MAX, _INT8_MAX).astype(np.int8)
    return q, scale


def _act_scale(ranges):
    """Calibrated (min, max) -> static activation scale 127 / amax (1.0
    for a degenerate range)."""
    amax = max(abs(float(ranges[0])), abs(float(ranges[1])))
    return _INT8_MAX / amax if amax > 0 else 1.0


def quantize_symbol(symbol, arg_params, act_ranges, excluded_sym_names=(),
                    logger=None):
    """Rewrite FullyConnected / Convolution nodes into the per-channel
    int8 serving ops; returns ``(qsym, qarg_params, meta)``.

    A node quantizes when it is not excluded, its weight is a graph
    parameter present in ``arg_params`` and ``act_ranges`` has a finite
    calibrated range for its data input; others stay fp32 (logged).
    ``qarg_params`` drops each quantized node's fp32 weight and adds
    ``<node>_weight_q`` (int8) and ``<node>_w_scale`` (fp32 per channel);
    every other parameter passes through."""
    from ..ndarray.ndarray import array as nd_array
    from ..ops import registry as _reg
    from ..symbol import symbol as _S
    log = logger or logging
    excluded = validate_excluded_names(symbol, excluded_sym_names)
    arg_params = dict(arg_params or {})
    qparams = dict(arg_params)
    meta = {}
    new_of = {}        # id(old node) -> Symbol of all its outputs

    for node in _S._topo(symbol._entries):
        if node.is_var:
            if node.name in arg_params:
                # the known shape, baked in for the quantized graph's
                # shape inference
                attrs = dict(node.attrs or {})
                attrs["__shape__"] = tuple(arg_params[node.name].shape)
                nv = _S._Node(None, node.name, attrs, is_aux=node.is_aux)
                new_of[id(node)] = _S.Symbol([(nv, 0)])
            else:
                new_of[id(node)] = _S.Symbol([(node, 0)])
            continue
        slot = list(node.in_names or [])
        inputs_kw = {name: new_of[id(src)][oi]
                     for name, (src, oi) in zip(slot, node.inputs)}
        attrs = dict(node.attrs or {})
        quantize = (node.op in _QUANT_OPS and node.name not in excluded
                    and "weight" in slot and "data" in slot)
        if quantize:
            wsrc = node.inputs[slot.index("weight")][0]
            # a computed weight stays fp32
            quantize = wsrc.is_var and wsrc.name in arg_params
        if quantize:
            dsrc, doi = node.inputs[slot.index("data")]
            rng = act_ranges.get((dsrc.name, doi))
            if rng is None:
                log.warning("no calibrated range for %r input of %r; "
                            "layer stays fp32", dsrc.name, node.name)
                quantize = False
            elif not (np.isfinite(rng[0]) and np.isfinite(rng[1])):
                log.warning("non-finite calibrated range %s for %r; "
                            "layer stays fp32", rng, node.name)
                quantize = False
        if not quantize:
            new_of[id(node)] = _S._apply_op(_reg.get_op(node.op), [],
                                            {**attrs, **inputs_kw},
                                            node.name)
            continue

        wq, wscale = _per_channel_quantize(_host(arg_params[wsrc.name]))
        act = _act_scale(rng)
        qparams.pop(wsrc.name, None)
        qparams[node.name + "_weight_q"] = nd_array(wq, ctx="cpu",
                                                    dtype=np.int8)
        qparams[node.name + "_w_scale"] = nd_array(wscale, ctx="cpu")
        wq_sym = _S.Variable(node.name + "_weight_q", shape=wq.shape,
                             dtype="int8")
        ws_sym = _S.Variable(node.name + "_w_scale", shape=wscale.shape)
        if node.op == "FullyConnected":
            keep = ("num_hidden", "no_bias", "flatten")
        else:
            keep = ("kernel", "stride", "dilate", "pad", "num_filter",
                    "num_group", "no_bias", "layout")
        qattrs = {k: attrs[k] for k in keep if k in attrs}
        qattrs["act_scale"] = act
        args = [inputs_kw["data"], wq_sym, ws_sym]
        bias_sym = inputs_kw.get("bias")
        if bias_sym is not None and not attrs.get("no_bias", False):
            args.append(bias_sym)
        else:
            qattrs["no_bias"] = True
        new_of[id(node)] = _S._apply_op(_reg.get_op(_QUANT_OPS[node.op]),
                                        args, qattrs, node.name + "_int8")
        meta[node.name] = {"op": node.op, "act_scale": act,
                           "channels": int(wq.shape[0]),
                           "act_range": [float(rng[0]), float(rng[1])]}

    entries = []
    for node, oi in symbol._entries:
        entries.extend(new_of[id(node)][oi]._entries)
    return _S.Symbol(entries), qparams, meta


class QuantizedParams(object):
    """A calibrated int8 serving artifact: the quantized symbol, params
    (per-channel int8 weights, fp32 scales, fp32 bias and aux) and the
    manifest's calibration metadata. Produced by
    :func:`quantize_checkpoint`, served by ``serving.Predictor``."""

    def __init__(self, symbol, arg_params, aux_params, meta, prefix=None):
        self.symbol = symbol
        self.arg_params = dict(arg_params)
        self.aux_params = dict(aux_params or {})
        self.meta = dict(meta or {})
        self.prefix = prefix

    @property
    def symbol_json(self):
        return self.symbol.tojson()

    def _save_dict(self):
        """The checkpoint's ``arg:`` / ``aux:`` key scheme, defined here
        once for the file and the blob."""
        save_dict = {("arg:%s" % k): v for k, v in self.arg_params.items()}
        save_dict.update({("aux:%s" % k): v
                          for k, v in self.aux_params.items()})
        return save_dict

    def param_bytes(self):
        """The params in the ``nd.save`` checkpoint format: what
        ``serving.Predictor`` takes."""
        from ..ndarray.utils import save_bytes
        return save_bytes(self._save_dict())

    def save(self, prefix):
        """Write the artifact under ``prefix`` (symbol JSON, params, a
        checksummed manifest carrying ``quantized`` metadata, every file
        atomically) and return ``prefix``."""
        from ..checkpoint import write_manifest
        from ..ndarray.utils import save as nd_save
        sym_file = "%s-symbol.json" % prefix
        self.symbol.save(sym_file)
        param_file = "%s-%04d.params" % (prefix, 0)
        nd_save(param_file, self._save_dict())
        write_manifest(prefix, 0, {"params": param_file, "symbol": sym_file},
                       extra={"quantized": {"format": 1,
                                            "layers": self.meta}})
        self.prefix = prefix
        _tm.counter("quantize/checkpoints_total",
                    "Quantized int8 artifacts written").inc()
        return prefix

    @classmethod
    def load(cls, prefix):
        """The newest valid artifact under ``prefix`` (manifest checksums
        verified, torn ones skipped). Raises :class:`MXNetError` when
        nothing loads or the checkpoint is not a quantized artifact."""
        from ..checkpoint import load_latest_valid, manifest_path
        state = load_latest_valid(prefix)
        if state is None:
            raise MXNetError("no quantized artifact under %r" % prefix)
        if state.symbol is None:
            raise MXNetError("artifact %r has no symbol file" % prefix)
        try:
            with open(manifest_path(prefix, state.epoch)) as f:
                man = _json.load(f)
        except (OSError, ValueError) as e:
            raise MXNetError("artifact manifest unreadable: %s" % e) from e
        qmeta = man.get("quantized")
        if qmeta is None:
            raise MXNetError(
                "%r is a plain checkpoint, not a quantized artifact (run "
                "quantize_checkpoint to produce one)" % prefix)
        return cls(state.symbol, state.arg_params, state.aux_params,
                   qmeta.get("layers", {}), prefix=prefix)


def quantize_checkpoint(prefix, calib_data, epoch=None, out_prefix=None,
                        calib_mode="minmax", excluded_sym_names=(),
                        data_names=("data",), num_calib_examples=None,
                        symbol=None, logger=None, ctx=None):
    """Trained checkpoint -> calibrated int8 artifact on disk.

    prefix : checkpoint prefix (``model.save_checkpoint`` layout); with
        ``epoch=None`` the newest checkpoint whose checksums verify.
    calib_data : batches fed through the fp32 graph to calibrate the
        activation ranges, on ``ctx`` (default ``cuda:0``).
    calib_mode : ``"minmax"`` / ``"naive"`` (exact ranges) or
        ``"percentile"`` / ``"entropy"`` (clipped at
        ``MXNET_QUANT_PERCENTILE``), or an observer factory.
    excluded_sym_names : op nodes kept fp32; each must exist.
    out_prefix : the artifact's prefix, default ``<prefix>-int8``.
    symbol : overrides the checkpointed symbol.

    Returns the saved :class:`QuantizedParams` (``.prefix`` names it)."""
    from ..checkpoint import load_latest_valid
    from ..model import load_checkpoint as _load_ckpt
    if epoch is not None:
        sym, arg_params, aux_params = _load_ckpt(prefix, epoch)
    else:
        state = load_latest_valid(prefix)
        if state is None:
            raise MXNetError("no checkpoint under %r to quantize" % prefix)
        sym, arg_params, aux_params = (state.symbol, state.arg_params,
                                       state.aux_params)
    if symbol is not None:
        sym = symbol
    if sym is None:
        raise MXNetError(
            "checkpoint %r has no symbol file; pass symbol=" % prefix)
    stats = collect_activation_ranges(
        sym, arg_params, aux_params, calib_data, data_names=data_names,
        observer=calib_mode, num_calib_examples=num_calib_examples, ctx=ctx)
    qsym, qarg, meta = quantize_symbol(sym, arg_params, stats,
                                       excluded_sym_names, logger=logger)
    if not meta:
        raise MXNetError(
            "nothing quantized under %r: no FullyConnected/Convolution node "
            "has a parameter weight and a calibrated input range" % prefix)
    qp = QuantizedParams(qsym, qarg, aux_params, meta)
    qp.save(out_prefix or (prefix + "-int8"))
    return qp
