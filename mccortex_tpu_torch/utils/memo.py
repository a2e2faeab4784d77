"""One memo for values made from objects the caller holds: a lookup table
from a key tensor, an adjacency, a unitig view, a replica on another
device.

An entry is found by the identity of its key objects, plus plain values
such as k or a shape, and follows one rule:

- It lives only while every key object it was made for is alive.  The
  memo holds them through weakrefs, and the death of any one drops the
  entry: a caller can only ask again with an object it still holds, so
  such an entry could never hit.  A hit also needs every stored
  reference to return the very object asked for, so an id reused after
  a free never hits.
- A memo holds at most BOUND entries, the oldest dropped first.

A value must not hold its own key objects (a view of a key tensor holds
it), or its entry lives until the bound drops it.
"""

from __future__ import annotations

import weakref

BOUND = 16      # the most any site needs at once: a store and a link
                # store replicated on each of 8 devices


class Memo:
    """Values keyed on the identity of key objects; see the module."""

    def __init__(self):
        self._entries: dict = {}    # key -> (weakrefs, value), oldest first

    def __len__(self) -> int:
        return len(self._entries)

    def _find(self, objs: tuple, plain: tuple):
        ck = tuple(map(id, objs)) + plain
        ent = self._entries.get(ck)
        if ent is not None and all(r() is o for r, o in zip(ent[0], objs)):
            return ck, ent
        return ck, None

    def peek(self, objs: tuple, *plain):
        """The value made for these key objects and plain values, or None;
        never builds."""
        ent = self._find(objs, plain)[1]
        return None if ent is None else ent[1]

    def get(self, objs: tuple, build, *plain):
        """The value made for these key objects and plain values; on a
        miss, build() makes it and the memo keeps it."""
        ck, ent = self._find(objs, plain)
        if ent is not None:
            return ent[1]
        value = build()
        self._entries.pop(ck, None)
        while len(self._entries) >= BOUND:
            self._entries.pop(next(iter(self._entries)), None)

        def drop(_dead, entries=self._entries, ck=ck):
            # a key object died: drop the entry under ck if it is one made
            # for a dead object (not a newer one made since)
            ent = entries.get(ck)
            if ent is not None and any(r() is None for r in ent[0]):
                entries.pop(ck, None)

        self._entries[ck] = (tuple(weakref.ref(o, drop) for o in objs), value)
        return value
