"""The retire tap's columns: copies across chunk boundaries, in order, and
none of the program's arrays kept."""

import numpy as np

from benchkit import runner


class Small(runner._Columns):
    CHUNK = 5


def test_columns_across_chunks():
    c = Small(np.uint32, np.int8)
    for k in (3, 4, 7, 0, 2):
        c.add(np.arange(k), np.arange(k) % 3)
    ids, tags = c.arrays()
    want = np.concatenate([np.arange(k) for k in (3, 4, 7, 0, 2)])
    assert np.array_equal(ids, want) and ids.dtype == np.uint32
    assert np.array_equal(tags, want % 3)
    assert len(c.chunks) == 4 and c.n == 16


def test_recorder_keeps_copies_only():
    rec = runner._Recorder(lambda: 2.5)
    rows = np.zeros((4, 272), np.uint32)
    rows[:, 15] = [7, 8, 9, 10]
    slots, verdicts, actions = np.arange(4), np.ones(4, bool), np.full(4, 2)
    rec.on_retire(0, rows, slots, verdicts, actions, 3)
    rows[:, 15] = 0
    slots[:] = 9
    a = rec.arrays()
    assert a["ids"].tolist() == [7, 8, 9, 10]
    assert a["slots"].tolist() == [0, 1, 2, 3]
    assert a["ticks"].tolist() == [3] * 4 and a["t"].tolist() == [2.5] * 4
    empty = runner._Recorder(lambda: 0.0).arrays()
    assert empty["ids"].size == 0 and empty["ticks"].dtype == np.int64
