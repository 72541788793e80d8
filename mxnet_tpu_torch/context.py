"""Device contexts: ``gpu(i)`` / ``cpu()`` as :class:`Context`.

Counterpart of the JAX package's ``context.py``: a :class:`Context` has
``device_type`` (``"gpu"`` or ``"cpu"``) and ``device_id``, prints as
``gpu(0)`` / ``cpu(0)``, and ``with ctx:`` makes it the current context
of this thread (a per-thread stack; a new thread starts outside every
``with``). A Context is also the torch device string it names
(``"cuda:0"``, ``"cpu"``), so every torch call that takes a device takes
a Context, and ``torch.device(ctx)`` is the device.

Entry points of this package run on the CUDA card unless the caller
asks for the host explicitly, by a ``ctx`` / ``device`` argument or
inside ``with mx.cpu():``; with no card and no explicit request they
raise instead of quietly running on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "gpu", "cpu", "current_context", "num_gpus",
           "default_device"]

_local = threading.local()


class Context(str):
    """A device context (reference: python/mxnet/context.py:28).

    ``Context("gpu", 1)``, ``Context("cpu")``, or a torch device (or its
    string): ``Context(torch.device("cuda", 1))`` is ``gpu(1)``."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cuda": 2}

    def __new__(cls, device_type, device_id=0):
        if isinstance(device_type, Context):
            return device_type
        if isinstance(device_type, torch.device) or (
                isinstance(device_type, str) and ":" in device_type):
            dev = torch.device(device_type)
            device_type, device_id = dev.type, dev.index or 0
        if device_type not in cls.devstr2type:
            raise MXNetError("unsupported device type %r (gpu or cpu)"
                             % (device_type,))
        typeid = cls.devstr2type[device_type]
        device_id = int(device_id)
        self = str.__new__(cls, "cpu" if typeid == 1
                           else "cuda:%d" % device_id)
        self.device_typeid = typeid
        self.device_id = device_id
        return self

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    @property
    def type(self):
        """The torch device type: ``"cuda"`` or ``"cpu"``."""
        return "cpu" if self.device_typeid == 1 else "cuda"

    @property
    def index(self):
        """The torch device index (None on the host, as torch's)."""
        return None if self.device_typeid == 1 else self.device_id

    def __eq__(self, other):
        if isinstance(other, (str, torch.device)):
            try:
                other = Context(other)
            except (MXNetError, RuntimeError):
                return False
            return (self.device_typeid, self.device_id) == \
                (other.device_typeid, other.device_id)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __reduce__(self):
        return (Context, (self.device_type, self.device_id))

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def gpu(device_id=0):
    """The CUDA card ``device_id``."""
    return Context("gpu", device_id)


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def current_context():
    """The context of the innermost ``with`` of this thread; ``gpu(0)``
    outside every ``with`` (the JAX package's default is ``cpu(0)``:
    this package's entry points run on the card unless asked)."""
    stack = _stack()
    return stack[-1] if stack else gpu(0)


def num_gpus():
    """The number of CUDA cards torch sees (0 without one)."""
    return torch.cuda.device_count()


def default_device(device=None):
    """Resolve an entry point's ``device`` argument to a
    :class:`torch.device`.

    ``None`` means the current context (``cuda:0`` outside every
    ``with``); a CPU device is returned only when asked for. Raises
    :class:`MXNetError` when a CUDA device is wanted and none is
    present."""
    dev = torch.device(current_context() if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError("unsupported device %s (cuda or cpu)" % dev)
    return dev
