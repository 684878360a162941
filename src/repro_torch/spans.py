"""``SpanRecorder``: named, nested host spans; a module that imports no
other of the package.  Each ``DataplaneRuntime`` holds one as ``rt.spans``
(the ``dp.`` names, ``SPAN_NAMES``), each ``ServeEngine`` one as
``eng.spans`` (the ``serve.`` names, ``SERVE_SPAN_NAMES``; the model's
decode step opens the ``serve.decode.`` ones).  Off by default, a span
site costs one attribute check and returns a shared no-op context.
``start()`` clears the buffer and turns it on: each span then records its
name, its start and end on ``time.perf_counter_ns`` (the clock of
``Telemetry`` and the rings' enqueue stamps), its parent and its counts,
into a bounded buffer whose overflow is counted, and opens a
``torch.profiler`` range of the same name, so a device trace's idle gaps
can be named by the span the host was in.  ``summary()`` folds the buffer
per name.
"""

from __future__ import annotations

import time

#: The data plane's spans, parent before child (``DataplaneRuntime``).
SPAN_NAMES = (
    "dp.dispatch",          # DataplaneRuntime.dispatch; rows offered
    "dp.dispatch.hash",     # flow words, Toeplitz hash, buckets, RETA lookup
    "dp.dispatch.push",     # per-queue split, ring pushes, drop taps; admitted, dropped
    "dp.boundary",          # control apply (and policy, in tick); epochs applied
    "dp.tick",              # DataplaneRuntime.tick
    "dp.tick.pop",          # ring pops; rows
    "dp.tick.stage",        # _pad and np.stack; rows, padded
    "dp.tick.h2d",          # the host-to-device copy; nbytes
    "dp.tick.launch",       # packet_step / fan-out launches, the event; queues
    "dp.retire",            # _retire; rows
    "dp.retire.wait",       # the wait on the tick's event
    "dp.retire.d2h",        # per-queue result copies to the host
    "dp.retire.tap",        # the on_retire tap (the caller's code)
    "dp.retire.account",    # telemetry, ring completion, audit, record, deltas
)

#: The serving engine's spans, parent before child (``ServeEngine``; the
#: ``serve.decode.`` ones inside the model's decode step).
SERVE_SPAN_NAMES = (
    "serve.admit",          # ServeEngine._admit: deadlines, prefills, splices
    "serve.prefill",        # one request's bucketed prefill; rows, padded
    "serve.splice",         # its state written into the batch row; nbytes
    "serve.decode",         # one decode step; rows, kv_resident, kv_valid
    "serve.decode.mamba",   # one mamba layer of the step (ssm, hybrid, zamba2)
    "serve.decode.shared",  # one zamba2 site: a shared block and its linear
    "serve.decode.head",    # the banked head grouped by slot; rows, padded
    "serve.retire",         # next tokens appended, finished rows freed
)

#: The counts a span may carry, summed per name by ``summary()``.
COUNT_KEYS = ("rows", "padded", "nbytes", "admitted", "dropped", "epochs",
              "queues", "kv_resident", "kv_valid")


class _NoSpan:
    """The shared context of every span site while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, rows=None, padded=None, nbytes=None, admitted=None,
              dropped=None, epochs=None, queues=None, kv_resident=None,
              kv_valid=None):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    """One open span of a started recorder."""

    __slots__ = ("rec", "name", "parent", "t0", "child_ns", "counts", "rf")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec = rec
        self.name = name
        self.child_ns = 0
        self.counts = None

    def __enter__(self):
        stack = self.rec._stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.rf = self.rec._range(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(None, None, None)
        rec = self.rec
        rec._stack.pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        rec._store((self.name, self.t0, t1, dur - self.child_ns,
                    parent.name if parent is not None else None, self.counts))
        return False

    def count(self, rows=None, padded=None, nbytes=None, admitted=None,
              dropped=None, epochs=None, queues=None, kv_resident=None,
              kv_valid=None):
        """Add to this span's counts (``COUNT_KEYS``; None: not given).  The
        counts stay a tuple here; ``summary()`` folds them."""
        add = (rows, padded, nbytes, admitted, dropped, epochs, queues,
               kv_resident, kv_valid)
        c = self.counts
        self.counts = add if c is None else tuple(
            b if a is None else a if b is None else a + b
            for a, b in zip(c, add))


def _profiler_range():
    """The cheapest profiler range this PyTorch has: the fast form where it
    exists, ``record_function`` otherwise."""
    try:
        from torch._C._profiler import _RecordFunctionFast
        return _RecordFunctionFast
    except ImportError:
        from torch.autograd.profiler import record_function
        return record_function


class SpanRecorder:
    """Named, nested host spans, off until ``start()``.

    ``span(name)`` is the one span site: a context manager whose ``count``
    adds to the span's counts (``COUNT_KEYS``).  Records are tuples
    ``(name, t0_ns, t1_ns, self_ns, parent, counts)`` (``counts`` a tuple
    over ``COUNT_KEYS``, or None) in a buffer of ``capacity`` records (a 20 s window of the data
    plane's sequential ticks takes ~30,000); a span that would not fit is
    counted in ``overflow`` and dropped."""

    def __init__(self):
        self.capacity = 1 << 17
        self.on = False
        self.records: list[tuple] = []
        self.overflow = 0
        self._stack: list[_Span] = []
        self._range = None

    def start(self) -> None:
        """Clear the buffer and record from now on."""
        if self._range is None:
            self._range = _profiler_range()
        self.records = []
        self.overflow = 0
        self._stack = []
        self.on = True

    def stop(self) -> None:
        """Record nothing more; the buffer stays for ``summary()``."""
        self.on = False

    def span(self, name: str):
        if not self.on:
            return _NO_SPAN
        return _Span(self, name)

    def _store(self, record: tuple) -> None:
        if len(self.records) < self.capacity:
            self.records.append(record)
        else:
            self.overflow += 1

    def summary(self) -> dict:
        """Per span name, in order of first close: ``count``, ``total_s``,
        ``self_s`` (total less the part its children cover), ``parent``
        (of its first record) and the summed counts that any of its
        records gave.  Spans lost to a full buffer are counted in
        ``overflow``, not here."""
        out: dict = {}
        for name, t0, t1, self_ns, parent, counts in self.records:
            s = out.get(name)
            if s is None:
                s = out[name] = {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                 "parent": parent}
            s["count"] += 1
            s["total_s"] += (t1 - t0) * 1e-9
            s["self_s"] += self_ns * 1e-9
            if counts is not None:
                for k, v in zip(COUNT_KEYS, counts):
                    if v is not None:
                        s[k] = s.get(k, 0) + int(v)
        return out
