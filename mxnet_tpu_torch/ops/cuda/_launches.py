"""Launch accounting for kernels that a CUDA graph replays.

Every kernel wrapper adds to its module's counters (``LAUNCHES``, and
``ROUTES`` / ``CONVERSIONS`` where the module has them) in Python, where
it launches. A CUDA graph replays the launches it captured without
calling a wrapper, and a capture itself launches nothing. So the graph
runner (``gluon/_graphs.py``) takes a :func:`snapshot` before and after
each capture: their :func:`delta` is what one replay launches. It takes
the capture's counts back (``add(d, -1)``) and adds them again on every
replay (``add(d)``). The counters of ``rtc`` launches count the same
way.
"""
from __future__ import annotations

__all__ = ["snapshot", "delta", "add"]

_ATTRS = ("LAUNCHES", "ROUTES", "CONVERSIONS")


def _counters():
    """Every counter dict of the kernel modules and of ``rtc``, in a
    fixed order."""
    from . import KERNEL_MODULES
    from ... import rtc
    return [getattr(mod, attr) for mod in KERNEL_MODULES + (rtc,)
            for attr in _ATTRS if isinstance(getattr(mod, attr, None), dict)]


def snapshot():
    """``{(counter index, name, route or None): count}`` of now."""
    flat = {}
    for i, counts in enumerate(_counters()):
        for name, n in counts.items():
            if isinstance(n, dict):
                for route, m in n.items():
                    flat[(i, name, route)] = m
            else:
                flat[(i, name, None)] = n
    return flat


def delta(before, after):
    """The counts ``after`` has beyond ``before`` (nonzero entries)."""
    out = {}
    for key, n in after.items():
        d = n - before.get(key, 0)
        if d:
            out[key] = d
    return out


def add(counts, times=1):
    """Add ``times`` x ``counts`` (a :func:`delta`) to the counters."""
    counters = _counters()
    for (i, name, route), n in counts.items():
        c = counters[i]
        if route is None:
            c[name] = c.get(name, 0) + n * times
        else:
            c[name][route] += n * times
