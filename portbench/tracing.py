"""Reading a ``torch.profiler`` trace of the traced steps, in memory.

From the profiler's events: the device operations (kernels, copies, sets)
with their intervals, the kernel launches, the host synchronisations (the
scalar reads ``aten::_local_scalar_dense``), the busy time as the union of
device intervals inside the traced span, and the idle gaps between them
with the innermost host operation running at each gap's middle.  Nothing is
written to disk.
"""

from __future__ import annotations

from portbench.yardstick import union_seconds

SYNC_OP = "aten::_local_scalar_dense"


def _is_device(evt):
    from torch.autograd import DeviceType

    return evt.device_type != DeviceType.CPU


def _is_annotation(evt, span_name):
    """A ``record_function`` range that the profiler mirrors on the
    device's timeline: not device work."""
    return evt.name == span_name or getattr(evt, "is_user_annotation", False)


def summarise(prof, span_name):
    """A dict: ``window_s``, ``busy_s``, ``launches``, ``syncs``,
    ``device_s_by_name`` (seconds per device operation name), ``gaps``
    (``(seconds, host op)`` longest first) and ``gemm_names``."""
    events = prof.events()
    span = [e for e in events if e.name == span_name]
    if not span:
        raise RuntimeError(f"trace has no span {span_name!r}")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    device, host = [], []
    syncs = 0
    for e in events:
        if _is_device(e):
            if not _is_annotation(e, span_name):
                device.append(e)
        else:
            host.append(e)
            if e.name == SYNC_OP:
                syncs += 1
    by_name, intervals, launches = {}, [], 0
    for e in device:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
        if not e.name.startswith(("Memcpy", "Memset")):
            launches += 1
    busy_us, gaps = union_seconds(intervals)
    if intervals:
        first = min(s for s, _ in intervals)
        last = max(t for _, t in intervals)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    gaps = sorted(((b - a, a, b) for a, b in gaps if b > a), reverse=True)
    named = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inner = None
        for e in host:
            r = e.time_range
            if r.start <= mid <= r.end and e.name != span_name and (
                    inner is None or r.start >= inner.time_range.start):
                inner = e
        named.append((length * 1e-6, inner.name if inner else "none"))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "launches": launches, "syncs": syncs,
            "device_s_by_name": by_name, "gaps": named,
            "gemm_names": sorted({n for n in by_name if "gemm" in n.lower()})}


def seconds_matching(summary, pattern):
    """Device seconds of the operations whose name contains ``pattern``."""
    return sum(v for k, v in summary["device_s_by_name"].items()
               if pattern in k)
