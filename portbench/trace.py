"""Reduction of a ``torch.profiler`` window to device time, attribution
and idle gaps.

- Busy time is the union of the device activities' intervals inside the
  profiled window, so work that overlaps on several streams counts once.
- A device activity belongs to a harness range when the host call that
  launched it ran inside that range, or inside the backward of an
  operation that ran inside it: the launch is found by the CUDA
  correlation id (or the profiler's link to the launching operation),
  and a backward node by the forward operation's (thread, sequence
  number).  No kernel name enters the attribution.
- Idle gaps are the parts of the window with no device activity, each
  named by the innermost harness range (``portbench.*``) the host's main
  thread was in when the device ran dry.
"""
from __future__ import annotations

import bisect
import collections

#: every range the harness opens starts with this
PREFIX = "portbench."
WINDOW = PREFIX + "profiled"


def activities(device):
    """The profiler activities for ``device``: the host, and the card's."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


class Timeline:
    """Host events ``(tid, start, end, name, corr, seq, fwd_tid)`` and
    device activities ``(start, end, name, corr, linked)``, times in ns on
    one clock."""

    def __init__(self, host, device):
        self.host = host
        self.device = device
        win = [e for e in host if e[3] == WINDOW]
        if not win:
            raise ValueError("the profile holds no %r range" % WINDOW)
        self.main_tid, self.t0, self.t1 = win[0][0], win[0][1], win[0][2]
        corrs = {d[3] for d in device}
        self._launch = {}
        for tid, s, _, name, corr, _, _ in host:
            if corr in corrs and name.startswith("cu"):
                self._launch[corr] = (tid, s)
        self._op = {e[4]: (e[0], e[1]) for e in host if e[4]}

    @classmethod
    def from_profile(cls, prof):
        from torch.autograd import DeviceType
        host, device = [], []
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            n = (e.duration_ns() if hasattr(e, "duration_ns")
                 else e.duration_us() * 1000)
            if e.device_type() == DeviceType.CUDA:
                # the profiler mirrors host ranges onto the device's
                # timeline; they are spans, not device work
                if _annotation(e):
                    continue
                device.append((s, s + n, e.name(), e.correlation_id(),
                               e.linked_correlation_id()))
            else:
                host.append((e.start_thread_id(), s, s + n, e.name(),
                             e.correlation_id(), e.sequence_nr(),
                             e.fwd_thread_id()))
        return cls(host, device)

    # -- whole window ------------------------------------------------------
    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def _busy_intervals(self):
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for s, e, *_ in self.device if e > self.t0 and s < self.t1)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self._busy_intervals()) * 1e-9

    @property
    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def top_device_ops(self, n=10):
        """``[[name, seconds]]``: device activities by total time."""
        tot = collections.Counter()
        for s, e, name, *_ in self.device:
            if e > self.t0 and s < self.t1:
                tot[name] += (min(e, self.t1) - max(s, self.t0)) * 1e-9
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, n=10):
        """``[[host range, seconds]]``: idle time summed by the innermost
        harness range the main thread was in at each gap's start,
        largest first."""
        ranges = sorted((s, e, name) for tid, s, e, name, *_ in self.host
                        if tid == self.main_tid and name.startswith(PREFIX)
                        and name != WINDOW)
        tot = collections.Counter()
        at = self.t0
        for s, e in self._busy_intervals() + [[self.t1, self.t1]]:
            if s > at:
                inside = [r for r in ranges if r[0] <= at < r[1]]
                name = inside[-1][2] if inside else "outside any range"
                tot[name] += (s - at) * 1e-9
            at = max(at, e)
        return [[k, v] for k, v in tot.most_common(n)]

    # -- attribution -------------------------------------------------------
    def _launch_of(self, dev):
        _, _, _, corr, linked = dev
        return self._launch.get(corr) or self._op.get(linked)

    def range_device_s(self, label, backward=True):
        """Device seconds of every activity launched inside a ``label``
        range, or (``backward``) inside the backward node of an operation
        that ran in one."""
        roots = collections.defaultdict(list)
        for tid, s, e, name, *_ in self.host:
            if name == label:
                roots[tid].append((s, e))
        if backward:
            fwd = set()
            fwd_roots = {tid: _merge(iv) for tid, iv in roots.items()}
            for tid, s, _, _, _, seq, _ in self.host:
                if seq is not None and seq >= 0 and \
                        _inside(fwd_roots, tid, s):
                    fwd.add((tid, seq))
            for tid, s, e, _, _, seq, ftid in self.host:
                if ftid and (ftid, seq) in fwd:
                    roots[tid].append((s, e))
        roots = {tid: _merge(iv) for tid, iv in roots.items()}
        total = 0
        for dev in self.device:
            where = self._launch_of(dev)
            if where is not None and _inside(roots, where[0], where[1]):
                total += dev[1] - dev[0]
        return total * 1e-9


def _annotation(event):
    """True for a user range the profiler shows on the device's rows."""
    is_ann = getattr(event, "is_user_annotation", None)
    if is_ann is not None and is_ann():
        return True
    return event.name().startswith(PREFIX)


def _merge(iv):
    """Sorted, disjoint union of intervals ``[(start, end)]``."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _inside(roots, tid, t):
    iv = roots.get(tid)
    if not iv:
        return False
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t < iv[i][1]
