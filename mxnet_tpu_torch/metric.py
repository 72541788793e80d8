"""Evaluation metrics.

The JAX package's ``metric.py`` for the training path: ``create``,
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy`` and
``CrossEntropy``. Metrics run on the host on numpy copies (``asnumpy`` is
the sync point with the card). The other metrics and ``CustomMetric``
come with ROADMAP A8.6.
"""
from __future__ import annotations

import numpy

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass):
    name = klass.__name__.lower()
    _METRIC_REGISTRY[name] = klass
    return klass


def _alias(*names):
    def reg(klass):
        for n in names:
            _METRIC_REGISTRY[n.lower()] = klass
        return klass
    return reg


def create(metric, *args, **kwargs):
    """Create a metric from a name, callable, list, or instance
    (reference: metric.py create)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        if metric.lower() not in _METRIC_REGISTRY:
            raise MXNetError("metric %r is not ported to mxnet_tpu_torch "
                             "yet (ROADMAP A8.6)" % metric)
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    if callable(metric):
        raise NotImplementedError("CustomMetric is not ported yet "
                                  "(ROADMAP A8.6)")
    raise TypeError("metric should be a str, callable, list or EvalMetric")


def _as_numpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Reference: metric.py check_label_shapes."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


class EvalMetric(object):
    """Base metric (reference: python/mxnet/metric.py:46)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference: metric.py:206)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@_alias("acc", "accuracy")
@register
class Accuracy(EvalMetric):
    """Classification accuracy (reference: metric.py:313)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_label = _as_numpy(pred_label)
            label = _as_numpy(label)
            if pred_label.shape != label.shape:
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32").flat
            label = label.astype("int32").flat
            labels_arr, preds_arr = check_label_shapes(
                numpy.asarray(label), numpy.asarray(pred_label), shape=True)
            self.sum_metric += (preds_arr == labels_arr).sum()
            self.num_inst += len(preds_arr)


@_alias("top_k_accuracy", "top_k_acc")
@register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference: metric.py:383)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) == 2, "Predictions should be 2 dims"
            pred_label = numpy.argsort(_as_numpy(pred_label).astype("float32"),
                                       axis=1)
            label = _as_numpy(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.flat == label.flat).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_label[:, num_classes - 1 - j].flat
                        == label.flat).sum()
            self.num_inst += num_samples


@_alias("ce", "cross-entropy")
@register
class CrossEntropy(EvalMetric):
    """Cross entropy over picked probabilities (reference: metric.py:985)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]
