"""Device meshes.

Counterpart of the JAX package's ``parallel/mesh.py``. A :class:`Mesh`
names its axes and carries ``.shape``, the ordered dict of axis sizes
that ``jax.sharding.Mesh.shape`` is (``parallel.transformer``'s mesh
checks take it), and its devices. Only a one-device mesh is ported:
``make_mesh`` refuses an axis above 1, naming the ROADMAP item that
ports it (A13 for data parallelism over ``torch.distributed``, A15 for
the model-parallel axes). So the sharding descriptors change nothing,
and the multi-process helpers act as the JAX package's do in a single
process: every value is host-local, and a batch or a replicated value
lands whole on the mesh's device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..context import default_device

__all__ = ["Mesh", "Sharding", "make_mesh", "current_mesh", "set_mesh",
           "data_parallel_sharding", "replicated_sharding",
           "global_dp_mesh", "mesh_process_count", "host_local_value",
           "make_replicated_global", "make_batch_global",
           "make_accum_batch_global"]

# the ROADMAP item that ports each mesh axis above size 1
MESH_ITEMS = {"dp": "A13", "sp": "A13/A15", "tp": "A15", "pp": "A15",
              "ep": "A15"}

_state = threading.local()


def check_axis(name, size):
    """Raise for an axis above 1, naming the item that ports it."""
    if size > 1:
        raise NotImplementedError(
            "mesh axis %r = %d: only a one-device mesh is ported; sharded "
            "training over torch.distributed is ROADMAP %s"
            % (name, size, MESH_ITEMS.get(name, "A13/A15")))


class Mesh(object):
    """Named axes over devices: ``axis_names``, ``shape`` (axis name ->
    size, in order), ``devices`` (an array of ``torch.device`` shaped
    like the axes) and ``device``, the one device of a ported mesh."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of %d axes named %s"
                             % (self.devices.ndim, self.axis_names))
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        for name, size in self.shape.items():
            check_axis(name, size)

    @property
    def device(self):
        return self.devices.flat[0]

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape), self.device)


def make_mesh(shape=None, axis_names=("dp",), devices=None):
    """A Mesh over the visible devices: by default every card (the host
    inside ``with mx.cpu():``; raises without a card). ``shape``: the
    axis sizes, or None to put every device on the first axis. A
    product above the device count raises, as in the JAX package; an
    axis above 1 raises naming its ROADMAP item."""
    if devices is None:
        dev = default_device()
        devices = [dev] if dev.type == "cpu" else [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [default_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if shape is None:
        shape = (len(devs),)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError("mesh shape %s needs %d devices, have %d"
                         % (shape, n, len(devs)))
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), tuple(axis_names)[:len(shape)])


def set_mesh(mesh):
    """Make ``mesh`` this thread's current mesh; returns the previous."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    return prev


def current_mesh():
    return getattr(_state, "mesh", None)


# a mesh and a partition spec (one entry an array dimension: an axis
# name or None), the JAX package's NamedSharding; on a one-device mesh
# every array lies whole on the device whatever the spec
Sharding = namedtuple("Sharding", ["mesh", "spec"])


def data_parallel_sharding(mesh, axis="dp", ndim=2):
    """The leading (batch) dim split over ``axis``."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated_sharding(mesh):
    return Sharding(mesh, ())


def global_dp_mesh(axis="dp"):
    """1-D data-parallel mesh over every device of every process: in one
    process, the cards it sees (a mesh across processes is A13)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError("a mesh across %d processes: sharded "
                                  "training over torch.distributed is "
                                  "ROADMAP A13"
                                  % torch.distributed.get_world_size())
    return make_mesh(None, (axis,))


def mesh_process_count(mesh):
    """How many processes own devices of ``mesh``: 1, every device of a
    ported mesh is this process's."""
    return 1


def host_local_value(arr):
    """This process's view of a value: the value itself (every array is
    fully addressable in one process)."""
    return arr


def _on_mesh(mesh, value):
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return t.to(mesh.device)


def make_replicated_global(mesh, host_value):
    """A value every process holds (parameters, optimizer state), on the
    mesh's device."""
    return _on_mesh(mesh, host_value)


def make_batch_global(mesh, host_local_batch, axis="dp"):
    """The global batch from this process's rows: with one process, the
    rows themselves on the mesh's device."""
    return _on_mesh(mesh, host_local_batch)


def make_accum_batch_global(mesh, host_local_batch, axis="dp"):
    """The microbatched batch ``[A, L, ...]`` of the gradient-accumulation
    step, on the mesh's device."""
    data = host_local_batch if isinstance(host_local_batch, torch.Tensor) \
        else np.asarray(host_local_batch)
    if data.ndim < 2:
        raise ValueError("accum batch needs shape [A, L, ...], got %s"
                         % (tuple(data.shape),))
    return _on_mesh(mesh, data)
