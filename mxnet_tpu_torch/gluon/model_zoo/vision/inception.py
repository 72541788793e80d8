"""Inception v3 for the Gluon model zoo (the JAX package's
``gluon/model_zoo/vision/inception.py``; reference:
python/mxnet/gluon/model_zoo/vision/inception.py), with its parameter
names.

The topology is data, as in the JAX package: ``_STEM`` and ``_STAGES``
spell out every convolution (channels, kernel, stride, padding) and
pool, and ``_Mix`` / ``_ExpandedMix`` turn a stage's branch lists into
blocks whose outputs concatenate on channels in the order the branches
were registered (``_children``' insertion order, the same whether the
block runs eagerly, hybridized or traced). The 8x8 tail's branches fork
into (1x3, 3x1) pairs that concatenate first. The final
``AvgPool2D(8)`` needs a 299x299 input.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import get_model_file

__all__ = ["Inception3", "inception_v3"]


def _c(channels, kernel, stride=1, pad=0):
    """One conv row of the topology table."""
    return {"channels": channels, "kernel_size": kernel,
            "strides": stride, "padding": pad}


def _cbr(cfg):
    """conv -> BN(eps 1e-3) -> relu, the network's only conv unit."""
    unit = nn.HybridSequential(prefix="")
    unit.add(nn.Conv2D(use_bias=False, **cfg))
    unit.add(nn.BatchNorm(epsilon=0.001))
    unit.add(nn.Activation("relu"))
    return unit


def _branch(rows):
    """A branch: an optional leading pool marker, then conv rows."""
    seq = nn.HybridSequential(prefix="")
    for row in rows:
        if row == "avgpool":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif row == "maxpool":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            seq.add(_cbr(row))
    return seq


# stem: 299x299x3 -> 35x35x192
_STEM = (_c(32, 3, stride=2), _c(32, 3), _c(64, 3, pad=1), "maxpool",
         _c(80, 1), _c(192, 3), "maxpool")


def _a_stage(prefix, pool_features):
    return (prefix, [
        [_c(64, 1)],
        [_c(48, 1), _c(64, 5, pad=2)],
        [_c(64, 1), _c(96, 3, pad=1), _c(96, 3, pad=1)],
        ["avgpool", _c(pool_features, 1)],
    ])


def _c_stage(prefix, mid):
    return (prefix, [
        [_c(192, 1)],
        [_c(mid, 1), _c(mid, (1, 7), pad=(0, 3)),
         _c(192, (7, 1), pad=(3, 0))],
        [_c(mid, 1), _c(mid, (7, 1), pad=(3, 0)),
         _c(mid, (1, 7), pad=(0, 3)), _c(mid, (7, 1), pad=(3, 0)),
         _c(192, (1, 7), pad=(0, 3))],
        ["avgpool", _c(192, 1)],
    ])


def _e_stage(prefix):
    """Expanded tail block: branches 2 and 3 fork into (1x3, 3x1) pairs
    whose outputs concatenate, as (stem_rows, [fork_rows, ...])."""
    return (prefix, "expand", [
        ([_c(320, 1)], None),
        ([_c(384, 1)], [[_c(384, (1, 3), pad=(0, 1))],
                        [_c(384, (3, 1), pad=(1, 0))]]),
        ([_c(448, 1), _c(384, 3, pad=1)],
         [[_c(384, (1, 3), pad=(0, 1))], [_c(384, (3, 1), pad=(1, 0))]]),
        (["avgpool", _c(192, 1)], None),
    ])


# the 35x35 A mixes, the 17x17 reduction and C mixes, the 8x8 reduction
# and tail
_STAGES = (
    _a_stage("A1_", 32),
    _a_stage("A2_", 64),
    _a_stage("A3_", 64),
    ("B_", [
        [_c(384, 3, stride=2)],
        [_c(64, 1), _c(96, 3, pad=1), _c(96, 3, stride=2)],
        ["maxpool"],
    ]),
    _c_stage("C1_", 128),
    _c_stage("C2_", 160),
    _c_stage("C3_", 160),
    _c_stage("C4_", 192),
    ("D_", [
        [_c(192, 1), _c(320, 3, stride=2)],
        [_c(192, 1), _c(192, (1, 7), pad=(0, 3)),
         _c(192, (7, 1), pad=(3, 0)), _c(192, 3, stride=2)],
        ["maxpool"],
    ]),
    _e_stage("E1_"),
    _e_stage("E2_"),
)


class _Mix(HybridBlock):
    """Parallel branches from a table row, concatenated on channels."""

    def __init__(self, branches, prefix=None):
        super(_Mix, self).__init__(prefix=prefix)
        with self.name_scope():
            for rows in branches:
                self.register_child(_branch(rows))

    def hybrid_forward(self, F, x):
        return F.Concat(*[b(x) for b in self._children.values()], dim=1)


class _ExpandedMix(HybridBlock):
    """A tail mix whose branches may fork: each entry is (stem rows,
    fork branch lists or None); fork outputs concatenate before the
    outer concatenation. Children register stem, then forks, branch by
    branch: the order the parameter names follow."""

    def __init__(self, spec, prefix=None):
        super(_ExpandedMix, self).__init__(prefix=prefix)
        self._plan = []
        with self.name_scope():
            for rows, forks in spec:
                stem = self.register_child(_branch(rows))
                arms = [self.register_child(_branch(f)) for f in forks or ()]
                self._plan.append((stem, arms))

    def hybrid_forward(self, F, x):
        outs = []
        for stem, arms in self._plan:
            y = stem(x)
            if arms:
                y = F.Concat(*[arm(y) for arm in arms], dim=1)
            outs.append(y)
        return F.Concat(*outs, dim=1)


class Inception3(HybridBlock):
    """Inception v3 assembled from the tables above (reference:
    inception.py Inception3)."""

    def __init__(self, classes=1000, **kwargs):
        super(Inception3, self).__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for row in _STEM:
                if row == "maxpool":
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                else:
                    self.features.add(_cbr(row))
            for stage in _STAGES:
                if stage[1] == "expand":
                    self.features.add(_ExpandedMix(stage[2],
                                                   prefix=stage[0]))
                else:
                    self.features.add(_Mix(stage[1], prefix=stage[0]))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root="~/.mxnet/models",
                 **kwargs):
    """Inception v3; ``pretrained`` loads ``<root>/inceptionv3.params``
    (reference: inception.py inception_v3)."""
    net = Inception3(**kwargs)
    if pretrained:
        net.load_parameters(get_model_file("inceptionv3", root=root),
                            ctx=ctx)
    return net
