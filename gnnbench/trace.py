"""``torch.profiler`` over a stretch of the window, reduced to numbers.

The device operations of the stretch (kernels, copies, sets) give the busy
time (the union of their intervals), kernel time by name, the launch
count and the breakdown; each idle gap of the device is named by the host
operation that overlaps it most.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

GAPS_NAMED = 500        # the longest idle gaps that are named by host op
TOP = 10


class Profile:
    """Start, stop, then read; one stretch per instance."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.window_s = 0.0

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        dev: List[Tuple[str, int, int]] = []
        host: List[Tuple[str, int, int]] = []
        for e in self._prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                dev.append(row)
            elif e.duration_ns() > 0:
                host.append(row)
        self._prof = None                       # free the raw trace
        self.dev_names = [r[0] for r in dev]
        self.dev_t = np.array([r[1:] for r in dev], np.int64).reshape(-1, 2)
        self.host_names = [r[0] for r in host]
        self.host_t = np.array([r[1:] for r in host], np.int64).reshape(-1, 2)
        self._merge()

    # ------------------------------------------------------------ reading
    def _merge(self) -> None:
        """Union of the device intervals, and the gaps between them."""
        order = np.argsort(self.dev_t[:, 0], kind="stable")
        busy, spans = 0, []
        for s, e in self.dev_t[order]:
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        self.busy_s = sum(e - s for s, e in spans) / 1e9
        self.gaps = np.array([(spans[i][1], spans[i + 1][0])
                              for i in range(len(spans) - 1)],
                             np.int64).reshape(-1, 2)

    def is_kernel(self, name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    @property
    def n_kernels(self) -> int:
        return sum(self.is_kernel(n) for n in self.dev_names)

    def kernel_seconds(self, patterns: Sequence[str]) -> Optional[float]:
        """Device seconds of the kernels whose name holds one of
        ``patterns``; ``None`` when none ran."""
        dur = self.dev_t[:, 1] - self.dev_t[:, 0]
        hit = [i for i, n in enumerate(self.dev_names)
               if any(p in n for p in patterns)]
        if not hit:
            return None
        return float(dur[hit].sum()) / 1e9

    def device_ops(self) -> List[List]:
        """The device operations that took most time, summed by name."""
        tot: Dict[str, int] = {}
        for n, (s, e) in zip(self.dev_names, self.dev_t):
            tot[n] = tot.get(n, 0) + int(e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:120], ns / 1e9] for n, ns in top]

    def idle_gaps(self) -> List[List]:
        """Idle device time of the longest gaps, summed by the host
        operation that overlaps each gap most."""
        if not len(self.gaps):
            return []
        length = self.gaps[:, 1] - self.gaps[:, 0]
        longest = np.argsort(-length, kind="stable")[:GAPS_NAMED]
        hs, he = self.host_t[:, 0], self.host_t[:, 1]
        tot: Dict[str, int] = {}
        for i in longest:
            a, b = self.gaps[i]
            name = "host code outside any profiled op"
            if len(hs):
                overlap = np.minimum(he, b) - np.maximum(hs, a)
                j = int(np.argmax(overlap))
                if overlap[j] > 0:
                    name = self.host_names[j]
            tot[name] = tot.get(name, 0) + int(length[i])
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:120], ns / 1e9] for n, ns in top]
