"""The traced sub-window of a ``--trace 1`` run and what is read from it.

``traced_window`` is ``chip_smoke.py::traced_window`` (commit 529a356)
reshaped for the benchmark: a ``torch.profiler`` trace (CUPTI) of ``reps``
calls with ``pad`` calls on each side, the card left idle for ``idle_s``
before and after the measured calls, which are found on the device's own
clock between the trace's two longest gaps (a trace loses device events at
its ends, and its device times drift from the host's). The idle gaps are
a quarter second, as the host of a one-card machine can stall for tens of
milliseconds inside the measured calls; a trace whose kernel families'
launches between the gaps do not pair up with the calls recorded is taken
again. The trace of these few calls is written to the run's temporary
directory, read back and deleted; what is kept is in memory. While the
measured calls run, the calls of each kernel family are recorded
(``Recorder``), so that their work can be counted from their own
arguments.
"""

import contextlib
import functools
import importlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Trace:
    """The measured calls' device events (sorted by start), the host events
    over them, the host seconds of the measured calls, their number and
    the recorded family calls."""

    device: list
    host: list
    window_s: float
    reps: int
    calls: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the device events' intervals."""
        busy, end = 0.0, -1.0
        for e in self.device:
            start, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        return busy * 1e-6


class Recorder:
    """Wraps the ``CALLS`` attributes of every kernel family so that, while
    ``on``, each call's arguments and result are kept, by family."""

    def __init__(self, families: dict):
        self.families = families
        self.on = False
        self.calls = {name: [] for name in families}
        self._saved = []

    def __enter__(self):
        for name, family in self.families.items():
            for module_name, attr in family.CALLS:
                try:
                    module = importlib.import_module(module_name)
                except ImportError:
                    continue
                original = getattr(module, attr, None)
                if original is None:
                    continue
                self._saved.append((module, attr, original))
                setattr(module, attr, self._wrap(name, original))
        return self

    def __exit__(self, *exc):
        for module, attr, original in reversed(self._saved):
            counts = {k: v for k, v in vars(getattr(module, attr)).items() if k != "__wrapped__"}
            original.__dict__.update(counts)  # what the wrapper counted goes on
            setattr(module, attr, original)
        self._saved.clear()

    def _wrap(self, family: str, fn):
        @functools.wraps(fn)  # with its attributes: a wrapper counts its launches on them
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                self.calls[family].append((args, kwargs, out))
            return out
        return recorded


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flush(device, idle_s):
    """Tiny fills at the trace's ends, a quarter of the idle time away: the
    events a trace loses at its ends are these first."""
    if device.type == "cuda":
        for _ in range(8):
            torch.zeros(1, device=device)
    _sync(device)
    time.sleep(idle_s / 4)


def _profile(fn, host: bool):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def traced_window(fn: Callable, reps: int, pad: int, device, families: dict,
                  host: bool = False, idle_s: float = 0.25, agree: Optional[Callable] = None,
                  attempts: int = 5) -> Optional[Trace]:
    """A :class:`Trace` of ``reps`` calls of ``fn``, or None where the trace
    holds no device events (a rehearsal on the CPU). With ``host`` the
    trace also records the host's ops, which doubles the host's time a
    call; without, only the device's events (CUPTI), so that busy and idle
    time read close to an untraced run's. ``agree(fault) -> fault`` makes
    ranks of a data-parallel run retry together (a fault on any rank is a
    fault on all)."""
    agree = agree or (lambda fault: fault)
    fault = None
    for _ in range(attempts):
        wall = []
        with Recorder(families) as rec:
            def run():
                _flush(device, idle_s)
                for _ in range(pad):
                    fn()
                _sync(device)
                time.sleep(idle_s)
                rec.on = True
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                _sync(device)
                wall.append(time.perf_counter() - t0)
                rec.on = False
                time.sleep(idle_s)
                for _ in range(pad):
                    fn()
                _sync(device)
                time.sleep(idle_s / 4)
                _flush(device, idle_s)

            events = _profile(run, host)
        device_events = sorted((e for e in events if e.get("ph") == "X"
                                and e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
        fault, inside = None, []
        if not device_events:
            fault = "the trace holds no device events"
        else:
            gaps, end = [], float(device_events[0]["ts"])
            for e in device_events:  # gaps[i] precedes device_events[i]
                gaps.append(float(e["ts"]) - end)
                end = max(end, float(e["ts"]) + float(e["dur"]))
            first, last = sorted(sorted(range(len(device_events)), key=gaps.__getitem__)[-2:])
            inside = device_events[first:last]
            if min(gaps[first], gaps[last]) <= idle_s * 0.5e6:
                fault = "the measured calls are not set apart by idle gaps"
            elif not inside:
                fault = "no device events between the idle gaps"
            elif any(len(rec.calls[name]) != sum(matches(e["name"], family.KERNELS)
                                                 for e in inside)
                     for name, family in families.items()):
                # a stall of the host inside the measured calls, or events lost
                fault = "the kernel families' launches do not pair up with their calls"
        fault = agree(fault)
        if fault is not None and device.type != "cuda":
            return None  # a rehearsal on the CPU: no device to trace
        if fault is None:
            t0, t1 = float(inside[0]["ts"]), float(inside[-1]["ts"]) + float(inside[-1]["dur"])
            host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                    and float(e["ts"]) < t1 and float(e["ts"]) + float(e.get("dur", 0)) > t0]
            return Trace(inside, host, wall[-1], reps, rec.calls)
    raise RuntimeError(f"traced window: {fault} after {attempts} attempts")


def matches(name: str, kernels) -> bool:
    """Whether a device event's name is one of the ``kernels``' (a template
    instance's name goes on with ``<``, a plain one's with ``(``)."""
    return any(f"{k}(" in name or f"{k}<" in name for k in kernels)


def device_ops(trace: Trace, top: int = 10) -> list:
    """``[[name, seconds]]`` of the device operations that took most time."""
    by_name = {}
    for e in trace.device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    return [[n[:160], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Optional[Trace], top: int = 10, least_us: float = 5.0) -> list:
    """``[[what the host was doing, seconds]]`` of the idle gaps between the
    measured calls' device events, each gap named by the innermost host
    event at its middle (with the benchmark's own span around it), summed
    by name, the longest first; empty without a trace."""
    if trace is None:
        return []
    host = sorted(trace.host, key=lambda e: float(e["ts"]))
    sums, end, at, active = {}, float(trace.device[0]["ts"]), 0, []
    for e in trace.device:
        start = float(e["ts"])
        gap = start - end
        if gap >= least_us:
            mid = end + gap / 2  # the gaps' middles come in order: one sweep
            while at < len(host) and float(host[at]["ts"]) <= mid:
                active.append(host[at])
                at += 1
            active = [h for h in active if float(h["ts"]) + float(h.get("dur", 0)) >= mid]
            spans = [h["name"] for h in active if h["name"].startswith("portbench.")]
            ops = [h for h in active if not h["name"].startswith("portbench.")]
            inner = min(ops, key=lambda h: float(h.get("dur", 0)), default=None)
            name = " / ".join([spans[0] if spans else "outside the calls",
                               inner["name"] if inner else "between ops"])
            sums[name[:160]] = sums.get(name[:160], 0.0) + gap * 1e-6
        end = max(end, start + float(e["dur"]))
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def family_seconds(trace: Trace, families: dict):
    """``(least seconds, device seconds)`` over every recorded call of every
    family with calls, from the work counters and the device events; None
    where a family's calls and kernel launches do not pair up one to one
    (the trace lost events) or no family ran."""
    from portbench.work import least_seconds

    least = device = 0.0
    ran = False
    for name, family in families.items():
        calls = trace.calls.get(name, [])
        events = [e for e in trace.device if matches(e["name"], family.KERNELS)]
        if not calls and not events:
            continue
        if len(calls) != len(events):
            return None
        ran = True
        least += sum(least_seconds(*family.work(a, k, o)) for a, k, o in calls)
        device += sum(float(e["dur"]) * 1e-6 for e in events)
    return (least, device) if ran and device > 0 else None


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    with torch.profiler.record_function(f"portbench.{name}"):
        yield
