"""Spans on the host clock and the device trace of a traced window.

``Spans`` records the harness's own spans (``begin`` / ``end`` by name, on
``time.perf_counter``) around its calls into the program; while the
profiler runs each span is also a ``record_function`` range, so the trace
holds it on the profiler's clock. ``Trace`` runs ``torch.profiler`` over
the traced window and reduces its events once, to what the metric readers
read: the window's length, the device's busy time (the union of kernel,
copy and set intervals), kernel launches, device time by the frozen kernel
families (``work.FAMILIES``), each ``yat_ad::`` dispatcher call with its
inputs' shapes and types, and the idle gaps charged to the harness span
the host was in when the gap ended.
"""

from __future__ import annotations

import time
from collections import defaultdict

from portbench.work import kernel_family


class Spans:
    def __init__(self):
        self.closed: dict[str, list[float]] = defaultdict(list)  # name -> durations (s)
        self._open: dict[str, tuple[float, object]] = {}
        self.window: dict[str, list[float]] = {}                # the window's, frozen
        self.tracing = False

    def freeze(self) -> None:
        """Keep the durations closed so far as the window's."""
        self.window = {k: list(v) for k, v in self.closed.items()}

    def begin(self, name: str) -> None:
        rf = None
        if self.tracing:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        self._open[name] = (time.perf_counter(), rf)

    def end(self, name: str) -> float:
        t0, rf = self._open.pop(name)
        t1 = time.perf_counter()
        if rf is not None:
            rf.__exit__(None, None, None)
        self.closed[name].append(t1 - t0)
        return t1 - t0

    def mean_ms(self, name: str) -> float | None:
        """The window's mean duration of ``name``, in ms."""
        v = self.window.get(name)
        return 1e3 * sum(v) / len(v) if v else None


class Trace:
    """``with Trace() as t:`` profiles the card; ``t.summary`` afterwards."""

    WINDOW = "pb.traced"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof.profiler.kineto_results.events(), self.WINDOW)
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_name: str) -> dict:
    from torch.autograd import DeviceType

    window = None
    spans, ops, dev = [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("pb.") or getattr(e, "is_user_annotation", lambda: False)():
                continue  # a host span's range drawn on the device's timeline
            dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == window_name:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith("pb."):
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("yat_ad::"):
            ops.append({"name": name, "start": e.start_ns(),
                        "shapes": [list(s) for s in e.shapes()], "dtypes": list(e.dtypes())})
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name} span")
    w0, w1 = window
    dev = [d for d in dev if d[2] > w0 and d[1] < w1]
    ops = [op for op in ops if w0 <= op["start"] <= w1]
    busy = _merge((max(s, w0), min(e, w1)) for _, s, e in dev)
    busy_ns = sum(e - s for s, e in busy)
    fam = defaultdict(float)
    n_kernels = 0
    for name, s, e in dev:
        fam[kernel_family(name)] += (e - s) / 1e9
        n_kernels += not name.startswith(("Memcpy", "Memset"))
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        inner = [sp for sp in spans if sp[1] <= g1 <= sp[2]]
        owner = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "pb.other"
        gaps[owner] += (g1 - g0) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9, "kernels": n_kernels,
            "families": dict(fam), "ops": ops, "idle_gaps": dict(gaps)}
