"""The traced run's instruments, all in the benchmark's own files. The
window has two parts:

- the profiled part, its first ``trace_seconds`` (whole batches or
  calls, the device drained at its end):
  torch.profiler (CPU and CUDA activity, input shapes), and forward hooks
  on the trunk units (the modules with ``fusable`` set) that record each
  call's voxels and widths for the roofline;
- the rest, after the profiler has stopped and written out its events:
  CUDA events at the cost processor's forward pre- and post-hooks, the
  host spans the drivers open around calls into a layer (``span``), and
  the frames and time from which ``mfu`` is taken, so that the
  profiler's own cost is in none of them.

``observation`` reduces all of it, once the window has closed, to the
record the per-layer readers take.
"""

import time

import torch

from . import roofline


class Tracer:
    """Off (``enabled`` False): every method does nothing."""

    def __init__(self, enabled, trace_seconds):
        self.enabled = enabled
        self.trace_seconds = trace_seconds
        self.active = False      # the profiled part
        self.after = False       # the rest of the window
        self.prof = None
        self.hooks = []
        self.cost_events = []
        self.trunk_calls = []
        self.spans = {}
        self.frames = self.calls = 0
        self.after_frames = self.after_done = 0
        self.t0 = self.t1 = self.t2 = self.t_last = None

    # -- instruments -----------------------------------------------------
    def attach(self, module):
        """Hooks on ``module``'s cost processor and trunk units."""
        if not self.enabled:
            return
        cp = getattr(module, "cost_processor", None)
        if cp is not None:
            def pre(_m, _args):
                if self.after:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    self.cost_events.append([start, None])

            def post(_m, _args, _out):
                if self.after and self.cost_events and \
                        self.cost_events[-1][1] is None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.cost_events[-1][1] = end
            self.hooks += [cp.register_forward_pre_hook(pre),
                           cp.register_forward_hook(post)]
        for m in module.modules():
            if getattr(m, "fusable", False):
                def unit(mod, args, out):
                    if self.active:
                        x = args[0]
                        vox = x.numel() // x.shape[-1]
                        self.trunk_calls.append(
                            (vox, mod.in_features, mod.features))
                self.hooks.append(m.register_forward_hook(unit))

    def detach(self):
        for h in self.hooks:
            h.remove()
        self.hooks = []

    def span(self, name, seconds):
        """A host span of ``seconds`` in layer ``name``."""
        if self.after:
            self.spans.setdefault(name, []).append(seconds)

    # -- the traced part of the window -----------------------------------
    def begin(self):
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def tick(self, frames, done):
        """Count ``frames`` dispatched; ``done``: all the work dispatched so
        far has completed (the host holds its results). Ends the profiled
        part once it has run for ``trace_seconds``; in the rest of the
        window, ``mfu`` counts the frames completed up to the last
        ``done``."""
        if self.after:
            self.after_frames += frames
            if done:
                self.after_done = self.after_frames
                self.t_last = time.perf_counter()
        if not self.active:
            return
        self.frames += frames
        self.calls += 1
        if time.perf_counter() - self.t0 >= self.trace_seconds:
            self.end()

    def end(self):
        if not self.active:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self.prof.__exit__(None, None, None)
        self.after = True
        self.t2 = self.t_last = time.perf_counter()

    # -- reduction -------------------------------------------------------
    def observation(self, family, max_disp, frame):
        """The record the per-layer readers take (see layer_metrics/)."""
        self.end()
        self.after = False
        self.detach()
        device_events = []
        cpu_events = []
        for e in self.prof.events():
            kind = e.device_type.name
            if kind == "CUDA":
                device_events.append(e)
            elif kind == "CPU":
                cpu_events.append(e)
        kernels = {}
        intervals = []
        for e in device_events:
            t = e.time_range
            dur = (t.end - t.start) * 1e-6
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += dur
            k[1] += 1
            intervals.append((t.start, t.end))
        busy_s, gaps = _busy_and_gaps(intervals)
        conv_ops = [(e.name, [list(s) for s in e.input_shapes[:3]],
                     e.device_time_total * 1e-6)
                    for e in cpu_events
                    if e.name in ("aten::convolution",
                                  "aten::convolution_backward")]
        launches = sum(c for name, (_, c) in kernels.items()
                       if not name.startswith(("Memcpy", "Memset")))
        torch.cuda.synchronize()
        cost_s = sum(s.elapsed_time(e) for s, e in self.cost_events
                     if e is not None) * 1e-3
        return {
            "frames": self.frames,
            "calls": self.calls,
            "window_s": self.t1 - self.t0,
            "busy_s": busy_s,
            "launches": launches,
            "kernels": sorted(([n, s, c] for n, (s, c) in kernels.items()),
                              key=lambda r: -r[1]),
            "conv_ops": conv_ops,
            "cost_processor_s": cost_s,
            "cost_processor_calls": len(self.cost_events),
            "trunk_calls": self.trunk_calls,
            "trunk_kernel": roofline.TRUNK_KERNEL,
            "spans": self.spans,
            "idle_gaps": _name_gaps(gaps, cpu_events),
            "flops_per_frame": roofline.count_flops(family, max_disp,
                                                    *frame),
            "after_frames": self.after_frames,
            "after_done_frames": self.after_done,
            "after_s": self.t_last - self.t2,
        }


def _busy_and_gaps(intervals):
    """(seconds covered by the union of device intervals [(start, end)]
    in microseconds, the idle gaps between them [(start, end)])."""
    busy, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6, gaps


def _name_gaps(gaps, cpu_events, longest=400, top=10):
    """The idle gaps summed by what the host was doing at each one's
    middle: the innermost CPU operation covering it (the latest to
    start), else 'python'. The ``longest`` gaps are named; [[name,
    seconds], ...], the most time first, ``top`` of them."""
    if not gaps:
        return []
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in cpu_events), key=lambda o: o[0])
    starts = [o[0] for o in ops]
    import bisect
    sums = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = (s + e) / 2
        name = "python"
        i = bisect.bisect_right(starts, mid)
        # the latest-starting op before mid that still covers it; ops
        # nest, so a short look back finds it
        for j in range(i - 1, max(i - 2000, 0) - 1, -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        sums[name] = sums.get(name, 0.0) + (e - s) * 1e-6
    return sorted(([n, v] for n, v in sums.items()),
                  key=lambda r: -r[1])[:top]
