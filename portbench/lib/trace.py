"""The traced window (``--trace 1``): ``torch.profiler`` over a fixed number
of calls, and what the per-layer readers take from it.

Each call runs inside ``record_function("portbench.call")``, the calls
inside ``record_function("portbench.window")``, so the window and the
calls share the device operations' time base.

Two profiled passes make one Trace.  The first records the host's
framework operations and the device's operations and nothing more: the
idle share, the launches, the kernels' times and the host's issue time
come from it.  The second also records the Python stack: a profile hook
(``sys.setprofile``) runs every call of a function of the program inside
``record_function("portbench.frame:<file>(<line>): <function>")``, which
slows the host several times over.  The profiler links each kernel to the
framework operation that launched it, and the frames that operation nests
in assign the kernel's device time to a module of the program.  The
hand-written kernels, launched through ctypes and so by no framework
operation, are known by name.
"""

from __future__ import annotations

import bisect
import collections
import re
import time

WINDOW, CALL = "portbench.window", "portbench.call"
FRAME = "portbench.frame:"
_COPY = re.compile(r"^(Memcpy|Memset)")
_PKG = "hmvec_tpu_torch/"


class FrameRanges:
    """A profile hook: each call of a function of the program runs inside a
    ``record_function`` range named by its file, first line and name."""

    def __init__(self):
        from torch.autograd.profiler import record_function

        self.record_function = record_function
        self.open = []

    def __call__(self, frame, event, arg):
        if event == "call":
            code = frame.f_code
            path = code.co_filename.replace("\\", "/")
            i = path.find(_PKG)
            if i >= 0:
                rf = self.record_function(
                    f"{FRAME}{path[i + len(_PKG):]}({code.co_firstlineno}): "
                    f"{code.co_name}")
                rf.__enter__()
                self.open.append((frame, rf))
        elif event == "return" and self.open and self.open[-1][0] is frame:
            self.open.pop()[1].__exit__(None, None, None)


def stack_frames(ev) -> tuple:
    """The program's frames a profiled operation nests in, innermost first,
    each as 'models/power.py(186): power_1halo'."""
    frames, node = [], ev.cpu_parent
    while node is not None:
        if node.name.startswith(FRAME):
            frames.append(node.name[len(FRAME):])
        node = node.cpu_parent
    return tuple(frames)


def _merge(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What one traced window recorded, in microseconds on the profiler's
    clock.

    window: (start, end) of the traced calls; calls: (start, end) of each;
    devices: the indices of the cards the cell uses; device_ops: (name,
    card, start, end) of every device operation (kernel, copy, set);
    cpu_ops: [start, end, name, innermost program frame] of every
    framework operation on the host; host_issue_ms: per call, the host
    clock from the call's entry to its return, before anything waits for
    the device; thetas: the calls' parameters; launched: (program frames,
    kernel name, duration) of every kernel a framework operation launched
    in the stack pass, over ``launched_calls`` calls; context: the
    configuration, the traffic and the configuration's reference module,
    for readers that count work.
    """

    def __init__(self, window, calls, devices, device_ops, launched, cpu_ops,
                 host_issue_ms, thetas, context):
        self.window, self.calls, self.devices = window, calls, devices
        self.device_ops, self.launched, self.cpu_ops = (device_ops, launched,
                                                        cpu_ops)
        self.launched_calls = len(calls)
        self.host_issue_ms, self.thetas = host_issue_ms, thetas
        self.context = context

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        """(name, card, start, end) of the kernels in the window."""
        w0, w1 = self.window
        return [op for op in self.device_ops
                if not _COPY.match(op[0]) and w0 <= op[2] < w1]

    def _spans(self, device):
        w0, w1 = self.window
        return _merge([max(s, w0), min(e, w1)]
                      for _, d, s, e in self.device_ops
                      if d == device and e > w0 and s < w1)

    def busy_us(self, device) -> float:
        """Time in which some operation ran on the card, in the window."""
        return float(sum(e - s for s, e in self._spans(device)))

    def idle_gaps(self, device):
        """(start, end) of each stretch of the window with nothing running
        on the card."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self._spans(device):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def kernel_us(self, name_part: str, call: int | None = None) -> float:
        """Device time of the kernels whose name holds ``name_part``, over
        the window or within one call."""
        lo, hi = self.window if call is None else self.calls[call]
        return float(sum(e - s for n, _, s, e in self.kernels()
                         if name_part in n and lo <= s < hi))

    def launched_us_per_call(self, module: str) -> float:
        """Device time per call of the kernels launched by framework
        operations with a frame of ``module`` (such as 'models/power.py')
        on their stack."""
        us = sum(us for frames, name, us in self.launched
                 if not _COPY.match(name)
                 and any(f.startswith(module + "(") for f in frames))
        return float(us) / self.launched_calls

    def adopt(self, framed: "Trace"):
        """Take the kernels' modules from the frames pass, and name each
        framework operation of this pass by the program frame of the
        operation of the same name and the same count within the first
        call there (every call issues the same operations in the same
        order)."""
        self.launched, self.launched_calls = (framed.launched,
                                              framed.n_calls)
        frames = collections.defaultdict(list)
        for op in framed._by_call()[0]:
            frames[op[2]].append(op[3])
        for mine in self._by_call():
            seen = collections.Counter()
            for op in mine:
                k = seen[op[2]]
                seen[op[2]] += 1
                if k < len(frames[op[2]]):
                    op[3] = frames[op[2]][k]

    def _by_call(self):
        """Per call, its aten operations in the order they started."""
        ops = sorted((o for o in self.cpu_ops if o[2].startswith("aten::")),
                     key=lambda o: o[0])
        starts = [o[0] for o in ops]
        return [ops[bisect.bisect_left(starts, c0):
                    bisect.bisect_left(starts, c1)] for c0, c1 in self.calls]

    def host_activity(self, t) -> str:
        """What the host was doing at time t: the innermost operation
        running then, in the innermost aten operation with its program
        frame; else the last of the 64 that started last to end before t."""
        if not hasattr(self, "_starts"):
            self.cpu_ops.sort(key=lambda o: o[0])
            self._starts = [o[0] for o in self.cpu_ops]
        i = bisect.bisect_right(self._starts, t)
        recent = self.cpu_ops[max(0, i - 64):i]
        running = [op for op in recent if op[1] > t]
        if running:
            inner = running[-1]
            aten = next((op for op in reversed(running)
                         if op[2].startswith("aten::")), inner)
            where = f" in {aten[2]}" if aten is not inner else ""
            return f"{inner[2]}{where} at {aten[3] or 'the harness'}"
        if not recent:
            return "Python"
        last = max(recent, key=lambda o: o[1])
        return f"Python after {last[2]} at {last[3] or 'the harness'}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, averaged over the cards."""
        w0, w1 = self.window
        by_name = collections.Counter()
        for name, _, s, e in self.device_ops:
            if w0 <= s < w1:
                by_name[name[:120]] += (e - s) * 1e-6
        gaps = collections.Counter()
        for dev in self.devices:
            for s, e in self.idle_gaps(dev):
                gaps[self.host_activity((s + e) / 2)] += (e - s) * 1e-6
        n = len(self.devices)
        return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
                "idle_gaps": [[k, v / n] for k, v in gaps.most_common(top)]}


def run_traced(batched, traffic, n_calls, devices, on_call, context,
               to_host, frames: bool = False) -> Trace:
    """Run n_calls calls under torch.profiler and return their Trace;
    ``frames``: record the program's frames (the second pass).  As in the
    measured window, ``to_host`` brings each call's spectra to the host
    and ``on_call(theta, host_rows)`` sees them."""
    import sys

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = any(torch.device(d).type == "cuda" for d in devices)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    issue, thetas = [], []
    hook = FrameRanges() if frames else None
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n_calls):
                theta = traffic.next_batch()
                with record_function(CALL):
                    t0 = time.perf_counter()
                    sys.setprofile(hook)
                    try:
                        out = batched(theta)
                    finally:
                        sys.setprofile(None)
                    issue.append((time.perf_counter() - t0) * 1e3)
                    host = to_host(out)
                on_call(theta, host)
                thetas.append(theta)
    window, calls, device_ops, launched, cpu_ops = None, [], [], [], []
    for ev in prof.events():
        t0, t1 = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # the device-side copies of the harness's ranges are no work
            if not (ev.name.startswith("portbench.")
                    or getattr(ev, "is_user_annotation", False)):
                device_ops.append((ev.name, ev.device_index, t0, t1))
        elif ev.name == WINDOW:
            window = (t0, t1)
        elif ev.name == CALL:
            calls.append((t0, t1))
        elif not ev.name.startswith(FRAME):
            fr = stack_frames(ev)
            cpu_ops.append([t0, t1, ev.name, fr[0] if fr else None])
            launched.extend((fr, k.name, k.duration) for k in ev.kernels)
    calls.sort()
    return Trace(window, calls, [torch.device(d).index for d in devices],
                 device_ops, launched, cpu_ops, issue, thetas, context)
