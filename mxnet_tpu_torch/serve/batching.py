"""Batch buckets: a bounded ladder of sizes that traffic pads up to."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["power_of_two_buckets", "parse_buckets", "validate_buckets",
           "pick_bucket"]


def power_of_two_buckets(max_batch):
    """Power-of-two bucket ladder up to ``max_batch`` (inclusive):
    ``8 -> (1, 2, 4, 8)``. A non-power-of-two max becomes the final
    bucket (``6 -> (1, 2, 4, 6)``)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise MXNetError("max_batch must be >= 1, got %d" % max_batch)
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def validate_buckets(buckets, spec=None):
    """An explicit bucket ladder, strictly increasing positive sizes, as
    a tuple. Unsorted, duplicate or non-positive entries raise naming the
    spec: a ladder an operator wrote down is config, and reordering it
    silently would hide the typo it almost certainly is."""
    name = repr(spec) if spec is not None else repr(list(buckets))
    buckets = tuple(int(b) for b in buckets)
    if not buckets:
        raise MXNetError("bucket spec %s is empty" % name)
    for b in buckets:
        if b < 1:
            raise MXNetError("bucket spec %s: sizes must be >= 1 (got %d)"
                             % (name, b))
    for prev, cur in zip(buckets, buckets[1:]):
        if cur == prev:
            raise MXNetError("bucket spec %s has duplicate bucket %d"
                             % (name, cur))
        if cur < prev:
            raise MXNetError("bucket spec %s is not sorted ascending "
                             "(%d after %d)" % (name, cur, prev))
    return buckets


def parse_buckets(spec, max_batch):
    """Buckets from a config spec: a comma list (``"1,4,16"``,
    MXNET_SERVE_BUCKETS) checked by :func:`validate_buckets`, or, when
    empty, the power-of-two ladder up to ``max_batch``."""
    if not spec:
        return power_of_two_buckets(max_batch)
    try:
        buckets = [int(tok) for tok in str(spec).split(",") if tok.strip()]
    except ValueError:
        raise MXNetError("bad bucket spec %r (want e.g. '1,2,4,8')"
                         % (spec,)) from None
    return validate_buckets(buckets, spec)


def pick_bucket(n, buckets):
    """Smallest bucket holding ``n`` rows. ``n`` beyond the largest
    bucket is an explicit error naming the ladder — the caller's
    admission check should have rejected it."""
    for b in buckets:
        if b >= n:
            return b
    raise MXNetError("batch of %d rows exceeds the largest bucket of "
                     "%s — split the request or raise the ladder"
                     % (n, tuple(buckets)))
