"""Monitor: tap intermediate op outputs for debugging (the PyTorch
package's copy of ``mxnet_tpu/monitor.py``'s ``Monitor``).

``install`` sets the executor's monitor callback with ``monitor_all``:
a monitored forward then runs the user's graph node by node and hands
every node's outputs to the statistic.  Slow; a debugging tool, as the
reference's.  The reference's ``StepStatsMonitor`` reads its profiler's
dispatch and compile counters, which the port does not have.
"""
from __future__ import annotations

import logging
import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor(object):
    """Collect (step, node_name, stat) every `interval` batches."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """returns |x|/size(x), async execution."""
                return x.abs().mean() if hasattr(x, "abs") else abs(x).mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Install the tap on an executor (reference monitor.py:install)."""
        exe.set_monitor_callback(self.stat_helper, monitor_all=True)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval elapsed."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read() if hasattr(array, "wait_to_read") \
                        else None
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; returns [(step, name, stat_str)]."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                if hasattr(array, "wait_to_read"):
                    array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                v_list = [v_list]
            s = ""
            for v in v_list:
                if isinstance(v, NDArray):
                    v = v.asnumpy()
                s += "%s " % str(v)
            res.append((n, k, s.strip()))
        self.queue = []
        return res

    def toc_print(self):
        """toc + log the results."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res
