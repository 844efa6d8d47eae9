"""Device-trace windows of a running server, and what they reduce to.

A window is ``torch.profiler`` (CUDA activity) over the traffic that
follows the measured window, while this thread samples what the server's
dispatcher thread is doing. Kineto drops device records now and then, all
of a window's or the late ones (C13), so a run takes several windows and
reads the first whose records of the frame kernel's last launch are as
many as the frame-kernel dispatches the program counted over it
(``fused_frames.LAUNCHES``). From that window, placed on the host's clock
(``spans.device_window``), come: the seconds some kernel, copy or memset
ran on the device (the union of their intervals), the kernels' summed time
by name, and the longest idle gaps, each named by what the dispatcher was
doing in most of the samples that fall in it.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from portbench import spans

#: a frame kernel's records (``csrc/fused_frames.cu``): the resident plan's
#: one launch, or the stages of the three-launch plan
FRAME_KERNELS = ("fft_resident", "fft_stage")
#: the record each frame-kernel dispatch ends with, once a dispatch
LAST_LAUNCH = ("fft_resident", "OutStore")
#: the serve plane's dispatcher thread (``serve.StreamServer.start``)
DISPATCHER = "totton-serve-dispatch"
MARK_VALUE = 7.0


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def reduce_window(w: dict) -> dict | None:
    """A window's device numbers, on the host's clock
    (``spans.device_window``: the offset from the first counter
    snapshot's ``clock_offset_ns`` where the marker agrees with it, else
    from the marker), its device records clipped to the host interval
    [t0, t1]; None where the marker's record is missing. Besides the
    seconds busy and the kernels' time, it returns the window's
    ``offset_ns``, ``bounds_ns``, ``busy_ns`` (the busy intervals) and
    ``kernels`` (the device records), which the span metrics read."""
    dev = spans.device_window(w)
    if dev is None:
        return None
    lo, hi = dev["bounds_ns"]
    busy = dev["busy_ns"]
    by_name: dict[str, float] = {}
    for n, a, b, _launch in dev["kernels"]:
        if not _is_copy(n):
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(zip(edges[0::2], edges[1::2]), key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        seen: dict[str, int] = {}
        for t, label in w["samples"]:
            if g0 <= t * 1e9 < g1:
                seen[label] = seen.get(label, 0) + 1
        if seen:
            top = max(seen, key=seen.get)
            share = seen[top] / sum(seen.values()) * 100
            label = f"dispatcher in {top} ({share:.0f}% of samples)"
        else:
            label = "dispatcher not sampled"
        named.append([label, (g1 - g0) * 1e-9])
    frame_s = sum(v for n, v in by_name.items()
                  if any(k in n for k in FRAME_KERNELS))
    return dict(
        dev,
        window_s=w["t1"] - w["t0"],
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        kernel_s=sum(by_name.values()),
        frame_kernel_s=frame_s,
        last_launches=sum(1 for n, _a, _b, _l in dev["kernels"]
                          if any(k in n for k in LAST_LAUNCH)),
        device_ops=sorted(([n[:160], v] for n, v in by_name.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=named)


def _dispatcher_ident() -> int | None:
    for t in threading.enumerate():
        if t.name == DISPATCHER:
            return t.ident
    return None


def _frame_label(frame) -> str:
    """What a thread is doing: its innermost frame in the port's package,
    and the innermost frame itself where that lies outside it."""
    inner, port = frame, None
    f = frame
    while f is not None:
        if "totton_tpu_torch" in f.f_code.co_filename:
            port = f
            break
        f = f.f_back
    def name(fr) -> str:
        return f"{os.path.basename(fr.f_code.co_filename)}:{fr.f_code.co_name}"

    if port is None:
        return name(inner)
    return name(port) if port is inner else f"{name(port)} > {name(inner)}"


def warm_profiler() -> None:
    """One short profile on an idle card, in set-up: the profiler's first
    start initializes CUPTI, which would otherwise stall the server's
    launches inside the first traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").fill_(1.0)
        torch.cuda.synchronize()


def _mark(side, marker) -> float:
    """Launch the marker kernel on the idle side stream; its host time."""
    import torch

    with torch.cuda.stream(side):
        t = time.perf_counter()
        marker.fill_(MARK_VALUE)
    return t


def take_windows(seconds: float, count: int, snapshot, until: float
                 ) -> list[dict]:
    """Up to ``count`` profiler windows of ``seconds`` back to back, each
    kept whole and reduced only after the run (reducing a trace is Python
    work that would take the GIL from the server's threads). Each window
    holds the profiler, the counters at its ends, the frame-kernel
    dispatches between them, a marker kernel launched on a side stream at
    a known host time (it ties the host's clock to the trace's), and the
    dispatcher thread's stack sampled every millisecond."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from totton_tpu_torch.ops import fused_frames

    side = torch.cuda.Stream()
    marker = torch.zeros(1, device="cuda")
    ident = _dispatcher_ident()
    windows = []
    for _ in range(count):
        if time.monotonic() + seconds > until:
            break
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        # The profiler's first records can be lost: the window and its
        # first marker start a little after it.
        time.sleep(0.05)
        marks = [_mark(side, marker)]
        launches0, snap0 = fused_frames.LAUNCHES, snapshot()
        t0 = time.perf_counter()
        samples = []
        while (now := time.perf_counter()) < t0 + seconds:
            frame = sys._current_frames().get(ident)
            if frame is not None:
                samples.append((now, _frame_label(frame)))
            del frame
            time.sleep(0.001)
        launches1, snap1 = fused_frames.LAUNCHES, snapshot()
        t1 = time.perf_counter()
        marks.append(_mark(side, marker))
        time.sleep(0.05)
        prof.stop()
        windows.append(dict(prof=prof, marks=marks, t0=t0, t1=t1,
                            samples=samples, before=snap0, after=snap1,
                            dispatched=launches1 - launches0))
    return windows


def pick_window(windows: list[dict], log) -> dict | None:
    """The first window that kept a record of every frame-kernel dispatch
    (two steps are in flight at either end), reduced; None (with a line
    on ``log`` saying why) where none did."""
    for i, w in enumerate(windows, 1):
        out = reduce_window(w)
        n = w["dispatched"]
        if out is not None and out["busy_s"] > 0 and n > 0 \
                and out["last_launches"] >= n - 2:
            out.update(attempt=i, dispatched=n, before=w["before"],
                       after=w["after"])
            return out
        kept = None if out is None else out["last_launches"]
        log(f"trace: profiler window {i} kept {kept} frame-kernel "
            f"dispatches of {n}")
    log(f"trace: none of {len(windows)} profiler windows kept every "
        "dispatch; the device metrics are left out")
    return None
