"""Random number generation: one explicit :class:`torch.Generator` per
device, all seeded by :func:`seed`.

Counterpart of the JAX package's ``random.py`` (a global threefry key
advanced per op). The numbers differ from JAX's for the same seed; what
carries over is determinism: after ``seed(n)`` the same sequence of
draws on the same device gives the same values.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

_lock = threading.Lock()
# gens: device -> Generator; pending: device name -> the state bytes
# set_state restored for a generator not created yet
_state = {"seed": 0, "gens": {}, "pending": {}}


def seed(seed_state, ctx=None):
    """Seed every device's generator (reference: python/mxnet/random.py:30).
    ``ctx`` is accepted for the reference's signature; all devices are
    reseeded."""
    with _lock:
        _state["seed"] = int(seed_state)
        _state["gens"] = {}
        _state["pending"] = {}


def generator(device):
    """The generator that draws for ``device``, created and seeded on
    first use after the last :func:`seed`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["gens"].get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_state["seed"])
            pending = _state["pending"].pop(str(dev), None)
            if pending is not None:
                gen.set_state(torch.tensor(list(pending), dtype=torch.uint8))
            _state["gens"][dev] = gen
        return gen


def get_state():
    """This package's random state as JSON-ready data: the seed and each
    generator created since, by device, its state in hex: what a
    checkpoint manifest records and :func:`set_state` restores."""
    with _lock:
        return {"seed": int(_state["seed"]),
                "generators": {str(dev): bytes(gen.get_state().tolist()).hex()
                               for dev, gen in _state["gens"].items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot (a resumed ``fit``): the seed,
    and each generator's state when its device is next drawn on. The JAX
    package's snapshot (``{"seed", "counter"}``) restores the seed
    alone: its counter numbers threefry keys, which no torch generator
    reproduces."""
    with _lock:
        _state["seed"] = int(state["seed"])
        _state["gens"] = {}
        _state["pending"] = {dev: bytes.fromhex(h) for dev, h in
                             state.get("generators", {}).items()}
