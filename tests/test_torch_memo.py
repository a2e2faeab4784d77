"""utils.memo: the one identity-keyed memo of the port.  An entry hits
only for the very key objects it was made for, lives only while they
do, and a memo holds at most BOUND entries, the oldest dropped first."""

import gc
import weakref

import numpy as np
import torch

from mccortex_tpu_torch.utils import memo as M


class _Key:
    """A plain key object (weakref-able, like a store or a link store)."""


def _builds(memo, objs, *plain):
    """How many times a get() of these keys builds (0 or 1)."""
    made = []
    memo.get(objs, lambda: made.append(1) or object(), *plain)
    return len(made)


def test_a_hit_returns_the_same_object():
    memo = M.Memo()
    keys = torch.arange(6).reshape(3, 2)
    first = memo.get((keys,), lambda: [1, 2], 31)
    assert memo.get((keys,), lambda: [1, 2], 31) is first
    # plain values are part of the key; so is every key object
    assert memo.get((keys,), lambda: [1, 2], 33) is not first
    other = np.zeros(3)
    assert memo.get((keys, other), lambda: "pair") == "pair"
    assert memo.get((keys, other), lambda: "again") == "pair"
    assert len(memo) == 3


def test_a_new_object_at_a_reused_id_misses():
    memo = M.Memo()
    a = _Key()
    memo.get((a,), lambda: "a")
    ida = id(a)
    del a
    for _ in range(1000):           # CPython hands a freed slot out again
        b = _Key()
        if id(b) == ida:
            break
    assert memo.get((b,), lambda: "b") == "b"
    # an entry left at a live object's id for another object never hits
    c, stranger = _Key(), _Key()
    memo._entries[(id(c),)] = ((weakref.ref(stranger),), "stranger's")
    assert memo.peek((c,)) is None
    assert memo.get((c,), lambda: "c") == "c"


def test_an_entry_goes_when_its_key_object_is_freed():
    memo = M.Memo()
    a, b = torch.zeros(4), torch.ones(4)
    memo.get((a,), lambda: "a")
    memo.get((b,), lambda: "b")
    memo.get((a, b), lambda: "ab")
    assert len(memo) == 3
    del a
    gc.collect()
    # a's own entry and the pair's went; b's stays and still hits
    assert len(memo) == 1
    assert memo.peek((b,)) == "b" and _builds(memo, (b,)) == 0


def test_the_oldest_goes_first_at_the_bound():
    memo = M.Memo()
    keys = [_Key() for _ in range(M.BOUND + 1)]
    for i, k in enumerate(keys):
        memo.get((k,), lambda i=i: i)
    assert len(memo) == M.BOUND
    assert memo.peek((keys[0],)) is None
    assert [memo.peek((k,)) for k in keys[1:]] == list(range(1, M.BOUND + 1))
    assert _builds(memo, (keys[0],)) == 1       # built again, keys[1] out
    assert memo.peek((keys[1],)) is None and len(memo) == M.BOUND


def test_two_memos_never_share_entries():
    one, two = M.Memo(), M.Memo()
    keys = torch.arange(3)
    assert one.get((keys,), lambda: "table") == "table"
    assert two.peek((keys,)) is None
    assert two.get((keys,), lambda: "view") == "view"
    assert one.peek((keys,)) == "table"


def test_peek_never_builds():
    memo = M.Memo()
    keys = torch.arange(3)
    assert memo.peek((keys,), 31) is None
    assert len(memo) == 0
    memo.get((keys,), lambda: "adj", 31)
    assert memo.peek((keys,), 31) == "adj" and memo.peek((keys,), 33) is None
    assert len(memo) == 1
