"""The traced steps: ``torch.profiler`` over a few train steps, with the
benchmark's own spans around the program's modules, reduced to device
time by module group, busy time, idle gaps and the kernels that took most.

A module group (``conv``, ``bn``, ...) is a set of module classes named by
the metric readers. Its forward is the span ``bench.fwd.<group>`` (module
hooks); its backward is the span ``bench.bwd.<group>`` around each
autograd node that the module's forward created (node pre- and post-hooks,
found by walking the output's graph back to the module's inputs). A kernel
counts for a group when it is launched inside one of its spans, whatever
kernel or library computes the module.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

import torch
from torch.autograd.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SPAN = re.compile(r"^bench\.(fwd|bwd)\.(.+)$")


class _Span:
    """A record_function span opened in one hook and closed in another."""

    def __init__(self, name: str):
        self.rf = record_function(name)

    def open(self, *_):
        self.rf.__enter__()

    def close(self, *_):
        self.rf.__exit__(None, None, None)


class GroupHooks:
    """Spans around the forward and the backward of every module of
    ``model`` whose class name is in a group; ``remove()`` takes them
    off."""

    def __init__(self, model: torch.nn.Module, groups: dict[str, set]):
        # nodes by id, held: a node's Python object lives only while it is
        # referenced, and a new one may take a freed one's id
        self.handles, self.seen = [], {}
        for module in model.modules():
            for group, names in groups.items():
                if type(module).__name__ in names:
                    self._hook(module, group)
                    break

    def _hook(self, module, group):
        inputs = []

        def pre(mod, args):
            inputs.append([a.grad_fn for a in args
                           if isinstance(a, torch.Tensor) and a.grad_fn])
            span = _Span(f"bench.fwd.{group}")
            span.open()
            inputs.append(span)

        def post(mod, args, out):
            span, stop = inputs.pop(), inputs.pop()
            span.close()
            if isinstance(out, torch.Tensor) and out.grad_fn is not None:
                self._hook_graph(out.grad_fn, stop, group)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def _hook_graph(self, root, stop: list, group: str):
        stop_ids = {id(n) for n in stop}
        todo = [root]
        while todo:
            node = todo.pop()
            if (node is None or id(node) in stop_ids or id(node) in self.seen
                    or type(node).__name__ == "AccumulateGrad"):
                continue
            self.seen[id(node)] = node
            span = _Span(f"bench.bwd.{group}")
            node.register_prehook(lambda grads, s=span: s.open())
            node.register_hook(lambda gi, go, s=span: s.close())
            todo += [n for n, _ in node.next_functions]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def profile_steps(step, n: int, hooks_on) -> dict:
    """Run ``step()`` n times under the profiler, each in a ``bench.step``
    span inside one ``bench.window`` span, with ``hooks_on()`` giving the
    group hooks (removed after); returns ``reduce_trace`` of the trace."""
    from torch.profiler import ProfilerActivity, profile

    hooks = hooks_on()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    with record_function("bench.step"):
                        step()
                    hooks.seen.clear()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        hooks.remove()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return reduce_trace(events)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _open_at(spans: list, queries: list) -> list:
    """For each time in ``queries``, the spans of ``spans`` (start, end,
    name), which nest as one thread's do, that hold it, outermost first.
    One sweep over both, sorted."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(queries)), key=queries.__getitem__)
    out, stack, i = [None] * len(queries), [], 0
    for q in order:
        t = queries[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = [x for x in stack if x[1] >= t]
    return out


def reduce_trace(events: list[dict]) -> dict:
    """Over the device work launched inside the ``bench.window`` span:
    device seconds by module group (``group_s``) and under the optimizer's
    span (``optimizer_s``), by kernel name (``by_kernel``); the traced
    window's length (from the span's start to the last such work's end),
    its busy seconds and its longest idle gaps with what the host was
    doing then; the count of traced steps."""
    spans = collections.defaultdict(list)  # tid -> [(start, end, name)]
    host = collections.defaultdict(list)  # tid -> ops and spans
    launches, device = {}, []
    window, steps = None, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args", {})
        start = float(e["ts"])
        end = start + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((start, end, e["name"], args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (e["tid"], start)
        if cat == "user_annotation":
            spans[e["tid"]].append((start, end, e["name"]))
            if e["name"] == "bench.window":
                window = (start, end, e["tid"])
            steps += e["name"] == "bench.step"
        if cat in ("cpu_op", "user_annotation"):
            host[e["tid"]].append((start, end, e["name"]))
    if window is None:
        return {"steps": steps, "group_s": {}, "optimizer_s": 0.0,
                "by_kernel": {}, "window_s": None, "busy_s": None,
                "idle_gaps": []}
    # the device work that the window's steps launched
    device = [d for d in device if d[3] in launches
              and window[0] <= launches[d[3]][1] <= window[1]]
    by_kernel = collections.Counter()
    queries = collections.defaultdict(list)  # tid -> [(launch time, dur)]
    for start, end, name, corr in device:
        by_kernel[name] += (end - start) / 1e6
        tid, at = launches[corr]
        queries[tid].append((at, (end - start) / 1e6))
    group = collections.Counter()
    optimizer = 0.0
    for tid, qs in queries.items():
        for (_, dur), names in zip(qs, _open_at(spans[tid],
                                               [at for at, _ in qs])):
            groups = [m.group(2) for m in (_SPAN.match(n) for _, _, n in names)
                      if m]
            if groups:
                group[groups[-1]] += dur
            if any(n.startswith("Optimizer.step#") for _, _, n in names):
                optimizer += dur
    out = {"steps": steps, "group_s": dict(group), "optimizer_s": optimizer,
           "by_kernel": dict(by_kernel), "window_s": None, "busy_s": None,
           "idle_gaps": []}
    if not device:
        return out
    w0 = window[0]
    w1 = max(max(e for _, e, _, _ in device), window[1])
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in device
                   if e > w0 and s < w1])
    out["window_s"] = (w1 - w0) / 1e6
    out["busy_s"] = sum(e - s for s, e in busy) / 1e6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    # what the host was doing: the innermost op or span open at the gap's
    # start on any thread (the backward runs on the autograd engine's)
    starts = [s for s, _ in gaps]
    doing = [_open_at(ops, starts) for ops in host.values()]
    labelled = collections.Counter()
    for i, (s, e) in enumerate(gaps):
        open_spans = [d[i][-1] for d in doing if d[i]]
        label = (max(open_spans)[2] if open_spans
                 else "host: between ops")
        labelled[label] += (e - s) / 1e6
    out["idle_gaps"] = labelled.most_common(10)
    return out
