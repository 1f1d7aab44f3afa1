"""The traced run's reading of the device: torch.profiler over whole calls,
its Chrome trace parsed into kernels, their launching host ranges and the
harness's spans.

A kernel belongs to a span (`portbench.call`, `portbench.step`,
`portbench.K3`) when the host call that launched it (the CUDA runtime event
of the same correlation id) lies inside the span on the same thread, and is
ATen's when that call lies inside an `aten::` op: the port's own kernels
are launched through ctypes, outside any ATen op.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
ATEN_NAME = re.compile(r"\bat::|\bat_cuda_detail::")


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:80]


class Kernel:
    __slots__ = ("name", "ts", "dur", "aten", "spans", "cat")

    def __init__(self, name, ts, dur, cat):
        self.name, self.ts, self.dur, self.cat = name, ts, dur, cat
        self.aten, self.spans = False, set()


class TraceView:
    """Device activity of the traced window (times in seconds)."""

    def __init__(self, events: list):
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
        calls = sorted((e for e in host if e["name"] == "portbench.call"), key=lambda e: e["ts"])
        if not calls:
            raise ValueError("the trace holds no portbench.call span")
        self.calls = len(calls)
        self.t0, self.t1 = calls[0]["ts"], max(e["ts"] + e["dur"] for e in calls)
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.steps = sum(1 for e in host if e["name"] == "portbench.step")

        self.ops, lookup = [], {}
        for e in dev:
            k = Kernel(e["name"], e["ts"], e.get("dur", 0.0), e["cat"])
            k.aten = bool(ATEN_NAME.search(e["name"]))
            corr = e.get("args", {}).get("correlation")
            if corr in launch:
                lookup.setdefault((launch[corr]["tid"], launch[corr]["ts"]), []).append(k)
            self.ops.append(k)
        self._attribute(host, lookup)
        self.kernels = [k for k in self.ops if k.cat == "kernel" and "portbench.call" in k.spans]
        self.host = host

    @staticmethod
    def _attribute(host, lookup):
        """Give each kernel the spans and ATen ops open when it was launched
        (host ranges on one thread nest, so a stack sweep finds them)."""
        by_tid = {}
        for e in host:
            by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]))
        for tid, ranges in by_tid.items():
            ranges.sort(key=lambda r: (r[0], -r[1]))
            points = sorted(ts for (t, ts) in lookup if t == tid)
            stack, i = [], 0
            for ts in points:
                while i < len(ranges) and ranges[i][0] <= ts:
                    stack.append(ranges[i])
                    i += 1
                stack = [r for r in stack if r[1] >= ts]
                for k in lookup[(tid, ts)]:
                    for _s, _e, name, cat in stack:
                        if cat == "user_annotation":
                            k.spans.add(name)
                        elif name.startswith("aten::"):
                            k.aten = True

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device
        (the union of their intervals)."""
        iv = sorted((max(k.ts, self.t0), min(k.ts + k.dur, self.t1)) for k in self.ops
                    if k.ts + k.dur > self.t0 and k.ts < self.t1)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def device_seconds(self, pick) -> float:
        return sum(k.dur for k in self.kernels if pick(k)) * 1e-6

    def count(self, pick) -> int:
        return sum(1 for k in self.kernels if pick(k))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host range open at their start."""
        by = {}
        for k in self.kernels:
            by[short_name(k.name)] = by.get(short_name(k.name), 0.0) + k.dur * 1e-6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        iv = sorted((k.ts, k.ts + k.dur) for k in self.ops if k.ts < self.t1 and k.ts + k.dur > self.t0)
        gaps, end = [], self.t0
        for s, e in iv:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            inner = [h for h in self.host if h["ts"] <= s <= h["ts"] + h["dur"]]
            inner.sort(key=lambda h: h["dur"])
            named.append([inner[0]["name"] if inner else "no host range", (e - s) * 1e-6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def profile_calls(run_calls, tmpdir=None) -> TraceView:
    """Run `run_calls()` under torch.profiler (CPU and CUDA activity) and
    read its Chrome trace; the file is removed after reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_calls()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return TraceView(events)
