"""Host-side bookkeeping for the KV-cache page pool of decode serving.

The decode engine (serve/decode.py) preallocates one fixed pool of
KV-cache pages on the device (``parallel.transformer.init_kv_pages``)
and hands each admitted request a *block table* — the ordered list of
page ids its positions live in. This module is the allocator for that
pool: a free list with hard invariants, checked on every transition,
because a bookkeeping bug here silently corrupts another request's
cache rather than crashing.

Invariants:

* a page is owned by at most one request at a time — ``alloc`` never
  hands out a page that has not been ``free``\\ d;
* ``free`` of a retired request returns exactly the pages it was
  allocated; freeing a page twice (or one never allocated) raises;
* exhaustion RAISES :class:`PagePoolExhausted` immediately — admission
  control turns that into a 503, never a queue that waits for memory;
* page id 0 is the NULL PAGE: never allocated, permanently reserved as
  the write target for padding slots in a partially-filled decode
  batch. ``capacity`` therefore = ``num_pages - 1``.
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from .engine import QueueFullError

__all__ = ["PagePoolExhausted", "PagePool", "pages_needed", "NULL_PAGE"]

NULL_PAGE = 0


class PagePoolExhausted(QueueFullError):
    """The free list cannot cover the requested page count. A
    :class:`~.engine.QueueFullError` subclass, so it rides the 503
    admission path — but the error detail names PAGES, distinct from
    queue-depth rejection (more device memory vs more replicas)."""


def pages_needed(tokens, page_size):
    """Pages covering ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // int(page_size))


class PagePool(object):
    """Free-list allocator over ``num_pages`` pool slots (id 0 reserved
    as the null page). Thread-safe: submitting threads reserve pages
    while the scheduler thread frees them."""

    def __init__(self, num_pages):
        num_pages = int(num_pages)
        if num_pages < 2:
            raise MXNetError("page pool needs >= 2 pages (page 0 is "
                             "the reserved null page), got %d"
                             % num_pages)
        self.num_pages = num_pages
        self._lock = threading.Lock()
        # LIFO free list: a retiring request's pages are the hottest
        # candidates for the next admission
        self._free = list(range(num_pages - 1, 0, -1))
        self._allocated = set()

    @property
    def capacity(self):
        """Allocatable pages (excludes the null page)."""
        return self.num_pages - 1

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self):
        with self._lock:
            return len(self._allocated)

    def can_cover(self, n):
        """Would ``alloc(n)`` succeed right now? (Advisory: admission
        still calls ``alloc`` and handles the race through its raise.)"""
        with self._lock:
            return len(self._free) >= int(n)

    def alloc(self, n):
        """Allocate ``n`` pages; returns their ids (position order).
        Raises :class:`PagePoolExhausted` — synchronously, never a
        wait — when the free list is short."""
        n = int(n)
        if n < 1:
            raise MXNetError("alloc of %d pages (need >= 1)" % n)
        with self._lock:
            if n > len(self._free):
                raise PagePoolExhausted(
                    "kv page pool exhausted: need %d pages, %d free "
                    "of %d (raise MXNET_DECODE_NUM_PAGES or shed "
                    "load)" % (n, len(self._free), self.capacity))
            ids = [self._free.pop() for _ in range(n)]
            for p in ids:
                # the free list and allocated set must partition
                # 1..num_pages-1 at all times
                if p in self._allocated or p == NULL_PAGE:
                    raise MXNetError(
                        "page allocator invariant violated: page %d "
                        "double-assigned" % p)
                self._allocated.add(p)
            return ids

    def free(self, ids):
        """Return pages to the pool. Every id must currently be
        allocated — a double free (or a free of the null page) is an
        invariant violation and raises."""
        with self._lock:
            for p in ids:
                if p not in self._allocated:
                    raise MXNetError(
                        "page allocator invariant violated: freeing "
                        "page %d that is not allocated (double free?)"
                        % p)
            for p in ids:
                self._allocated.discard(p)
                self._free.append(p)
