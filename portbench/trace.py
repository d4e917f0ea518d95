"""The profiler pass of a traced run, and its reduction.

A traced run profiles one stretch of its window with ``torch.profiler``
(CPU and CUDA activities) and reduces it to: the device's busy seconds
(the union of every device operation's interval: kernels, copies and
fills), the stretch's wall seconds, the kernels launched and their device
time by name, and the idle gaps of the device by the host span they fall
in.  Spans are the benchmark's own: ``record_function`` ranges named
``pb:<layer>`` around the calls it makes into each layer of the program
(:meth:`Tracer.span`, :meth:`Tracer.wrap`).

The busy and idle arithmetic copies ``chip_smoke.py`` ``profile_flush``
of commit 14675cf (device time summed from the profiler's CUDA events,
over the host clock's wall time), with the union of intervals in place of
the sum so that overlapping operations count once.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import time

import torch

SPAN = "pb:"
TOP = 10
NOT_KERNELS = ("Memcpy", "Memset")
WALK = 64         # spans looked at back from a gap (threads interleave)


class Tracer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.wall = 0.0
        self.notes: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        gc.collect()     # no dead CUDA graph is destroyed inside the stretch
        self._sync()
        # every thread: the serving scheduler launches from its own
        self.prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def prime(self) -> None:
        """Start and stop the profiler once outside the window, so that
        starting it inside costs no set-up of its own."""
        self.start()
        self.stop()
        self.prof = None

    @contextlib.contextmanager
    def stretch(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def note(self, **kw) -> None:
        """What the driver counted in the stretch (steps, records,
        requests)."""
        self.notes.update(kw)

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(SPAN + name)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span around every call of ``obj.attr`` (on the instance)."""
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        setattr(obj, attr, spanned)

    def summary(self) -> dict:
        """The stretch reduced: ``busy_s``, ``window_s``, ``kernels`` (the
        number launched), ``by_kernel`` {name: [seconds, count]},
        ``device_ops`` and ``idle_gaps`` (the ten largest, [name,
        seconds])."""
        if self.prof is None:
            return {}
        dev, spans = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith(SPAN):
                # a span: on the host, and again as the device-side
                # annotation the profiler makes of it, which is no
                # operation of the device
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((tr.start, tr.end, e.name[len(SPAN):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
        dev.sort()
        by_kernel: dict = {}
        kernels = 0
        for s, t, name in dev:
            if not name.startswith(NOT_KERNELS):
                kernels += 1
            rec = by_kernel.setdefault(name, [0.0, 0])
            rec[0] += (t - s) * 1e-6
            rec[1] += 1
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) * 1e-6
        spans.sort()
        starts = [sp[0] for sp in spans]
        gaps: dict = {}
        for (_, a), (b, _) in zip(merged, merged[1:]):
            name = _span_at(spans, starts, (a + b) / 2)
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"busy_s": busy, "window_s": self.wall, "kernels": kernels,
                "by_kernel": by_kernel,
                "device_ops": [[k[:96], v[0]] for k, v in top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:TOP]}


def _span_at(spans: list, starts: list, t: float) -> str:
    """The innermost span open at ``t``: the latest-starting of the
    ``WALK`` spans that start last before it and hold it."""
    i = bisect.bisect_right(starts, t)
    for sp in reversed(spans[max(i - WALK, 0):i]):
        if sp[1] >= t:
            return sp[2]
    return "no span"


def kernel_seconds(summary: dict, pattern) -> tuple:
    """(device seconds, launches) of the kernels whose name ``pattern``
    (a compiled regular expression) matches."""
    s, n = 0.0, 0
    for name, (sec, count) in summary.get("by_kernel", {}).items():
        if pattern.search(name):
            s += sec
            n += count
    return s, n


def idle_share(ctx: dict):
    """Per cent of the traced stretch in which no operation ran on the
    device."""
    tr = ctx.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
