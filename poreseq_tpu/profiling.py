"""JAX profiler traces of a run, and a summary of the device's part in them.

`trace` is the one tracing path: `poreseq consensus --profile DIR` and
`chip_smoke.py --profile` both go through it.  A warm consensus run launches
millions of kernels (every scan step is one), and the GPU tracer's default
activity buffers drop events past about a million, so `trace` raises them.

`summarize` reads one trace file: the device busy and idle share, kernel time
by jitted program (the XLA module), by (program, kernel) and by kernel name.
"""

from __future__ import annotations

import glob
import os
import random
import tempfile

#: GPU tracer buffer sizes (events); the defaults truncate a consensus run
GPU_MAX_EVENTS = 1 << 24


def profiler_options():
    import jax

    opts = jax.profiler.ProfileOptions()
    opts.advanced_configuration = {
        "gpu_max_activity_api_events": GPU_MAX_EVENTS,
        "gpu_max_callback_api_events": GPU_MAX_EVENTS,
    }
    return opts


def _trace_files(log_dir):
    """{path: mtime_ns} of every trace file under log_dir."""
    return {p: os.stat(p).st_mtime_ns
            for p in glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                               recursive=True)}


class trace:
    """Context manager: profile the block into `log_dir` (a new temporary
    directory when None).  On exit, `path` is the trace file this block
    wrote, never an older one found in the same directory (a trace started
    within the same second as an earlier one overwrites its file)."""

    def __init__(self, log_dir: str | None = None):
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="psq_trace_")
        self.path: str | None = None

    def __enter__(self):
        import jax

        os.makedirs(self.log_dir, exist_ok=True)
        self._before = _trace_files(self.log_dir)
        jax.profiler.start_trace(self.log_dir,
                                 profiler_options=profiler_options())
        return self

    def __exit__(self, *exc):
        import jax

        jax.profiler.stop_trace()
        new = {p: t for p, t in _trace_files(self.log_dir).items()
               if self._before.get(p) != t}
        self.path = max(new, key=new.get) if new else None
        return False


def summarize(trace_file, window=None, top=12, every=16, write=print):
    """Write the device busy/idle share, kernel time by program and the top
    kernels of `trace_file` (a path, or a loaded jax.profiler.ProfileData).
    `window` names a host TraceAnnotation whose span is also used as the
    idle-share denominator.  Scan bodies run as CUDA graphs, whose kernels
    carry no finer op name than their program; reading an event's stats is
    slow at millions of events, so the program split is estimated from a
    random sample of one kernel in `every` (a fixed stride would alias with
    the period of a scan body's kernels).  Returns the device idle share
    over the device span."""
    from jax.profiler import ProfileData

    pd = (ProfileData.from_file(trace_file)
          if isinstance(trace_file, str) else trace_file)
    rng = random.Random(0)
    host_window = None
    per_op, per_module, per_pair, intervals = {}, {}, {}, []
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if window is not None and ev.name == window:
                        host_window = (ev.start_ns,
                                       ev.start_ns + ev.duration_ns)
            continue
        if not plane.name.startswith("/device"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if rng.random() * every < 1:
                    module = dict(ev.stats).get("hlo_module", "?")
                    per_module[module] = (per_module.get(module, 0.0)
                                          + ev.duration_ns)
                    key = (module, ev.name)
                    per_pair[key] = per_pair.get(key, 0.0) + ev.duration_ns
    if not intervals:
        raise RuntimeError("the trace holds no device kernel: {}".format(
            trace_file))
    write("{} device events".format(len(intervals)))
    intervals.sort()
    busy, (cur0, cur1) = 0.0, intervals[0]
    for a, b in intervals[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    span = intervals[-1][1] - intervals[0][0]
    idle = 1 - busy / span
    write("device busy {:.3f} s over a {:.3f} s device span: idle share "
          "{:.4f}".format(busy / 1e9, span / 1e9, idle))
    if host_window:
        win = host_window[1] - host_window[0]
        write("host window {:.3f} s: device idle share {:.4f}".format(
            win / 1e9, 1 - busy / win))
    sampled = sum(per_module.values())
    write("share of kernel time by program (random sample, one kernel in "
          "{}):".format(every))
    for name, ns in sorted(per_module.items(), key=lambda kv: -kv[1]):
        write("  {:6.2%}  {}".format(ns / sampled, name))
    write("top (program, kernel) pairs (same sample):")
    for (module, name), ns in sorted(per_pair.items(),
                                     key=lambda kv: -kv[1])[:top]:
        write("  {:6.2%}  {}  {}".format(ns / sampled, module, name[:80]))
    total = sum(per_op.values())
    write("top kernels (summed time, share of all kernel time):")
    for name, ns in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        write("  {:10.4f} s {:6.2%}  {}".format(ns / 1e9, ns / total,
                                                name[:110]))
    return idle
