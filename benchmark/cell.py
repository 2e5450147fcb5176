"""One run of one cell: the program's train step built as its trainer
builds it, its first steps (the warm-up, and what the check compares),
the measured window, the traced steps with ``--trace 1``, then the
reference and the check.

The window is the trainer's loop (``train/pretrain.py:train``): each step
called as soon as the previous call returns, on batches taken in turn
from a pool made on the card at set-up, the metrics read with ``.item()``
every ``sync_every`` steps and at no other point, a CUDA event recorded
after each call; the window closes with ``torch.cuda.synchronize()`` on
the host clock.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import check, faults, spec, synth, trace
from .reference import train as reference
from .reference.tsv4 import LOSS_NAMES

# the MultiStepLR's milestones lie at epochs 120 and 160: steps a run
# never reaches
STEPS_PER_EPOCH = 10 ** 6
FORBIDDEN = ("jax", "jaxlib", "flax", "dualvar_tpu")


class Program:
    """The system under test: ``dualvar_tpu_torch``'s pretrain step for the
    cell's preset, as ``setup_training`` builds it, with the benchmark's
    initial state, generator and frame pool."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device,
                 rank: int = 0, tf32: bool = True):
        from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
        from dualvar_tpu_torch.train import pretrain

        cfg, tr = cell.config, cell.traffic
        self.batch = tr["batch_per_process"]
        preset = PRETRAIN_PRESETS[cfg["preset"]]
        pcfg = preset.replace(
            data=dataclasses.replace(preset.data, seq_len=cfg["seq_len"],
                                     img_dim=cfg["img_dim"],
                                     scale_hw=tuple(cfg["frames_hw"])),
            optim=dataclasses.replace(preset.optim, batch_size=self.batch),
            model=dataclasses.replace(preset.model, dtype=cfg["dtype"]),
            run=dataclasses.replace(preset.run, seed=0))
        _agree(cfg, pcfg)
        if device.type == "cuda":
            # as train() sets it; False only for a float32 witness
            torch.backends.cudnn.allow_tf32 = tf32
        self.task = pretrain.build_task(pcfg)
        self.model = self.task.model.to(device).train()
        self.model.load_state_dict(synth.make_state(cfg, seed, device))
        self.optimizer, scheduler = pretrain.make_optimizer(
            pcfg, self.task.parameters(), STEPS_PER_EPOCH)
        self.wd = pcfg.optim.wd
        self.train_step = pretrain.make_train_step(
            self.task, self.optimizer, scheduler, pretrain.aug_config(pcfg),
            pretrain._AUTOCAST[pcfg.model.dtype])
        self.generator = synth.run_generator(seed, device, rank)
        self.pool = synth.make_frames(cfg, self.batch, tr["pool_batches"],
                                      seed, device, rank)
        self.calls = 0

    def step(self) -> dict:
        frames = self.pool[self.calls % len(self.pool)]
        self.calls += 1
        return self.train_step(frames, self.generator)

    def first_steps(self, n: int) -> dict:
        """The first ``n`` steps with the readings the check compares
        (``reference/train.py:readings``' keys)."""
        params = dict(self.model.named_parameters())
        start = {k: v.detach().clone()
                 for k, v in self.model.state_dict().items()}
        seen = []
        hook = self.model.register_forward_pre_hook(
            lambda m, args: None if seen else seen.append(args[0].detach()))
        out = {"losses": []}
        try:
            for i in range(n):
                metrics = self.step()
                out["losses"].append({k: metrics[k].item()
                                      for k in LOSS_NAMES})
                if i == 0:
                    hook.remove()
                    out["block"] = seen[0].float().cpu()
                    out["out_bytes"] = seen[0].element_size()
                    state = self.optimizer.state
                    out["grad1"] = check.norms({
                        k: state[p]["momentum_buffer"] - self.wd * start[k]
                        for k, p in params.items()
                        if "momentum_buffer" in state.get(p, {})})
        finally:
            hook.remove()
        out["change"] = check.norms({k: v - start[k] for k, v in
                                     self.model.state_dict().items()})
        return out


def _agree(cfg: dict, pcfg) -> None:
    """The preset must state what the configuration's file says."""
    m, o, d = pcfg.model, pcfg.optim, pcfg.data
    pairs = {"net": m.net, "model": m.model, "mode": m.mode,
             "n_series": m.n_series, "series_dim": m.series_dim,
             "dim": m.moco_dim, "temperature": m.moco_t,
             "aligned_T": m.aligned_T, "shufflerank_theta": m.shufflerank_theta,
             "dtype": m.dtype, "optim": o.optim, "lr": o.lr,
             "momentum": o.momentum, "wd": o.wd, "ds": d.ds}
    bad = {k: (cfg[k], v) for k, v in pairs.items() if cfg[k] != v}
    if bad or pcfg.aug.aug_temp_consist is not True or m.packed_encode:
        raise ValueError(f"preset {cfg['preset']!r} departs from the "
                         f"configuration: {bad}")


class _Marks:
    """Step ends: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(prog: Program, seconds: float, sync_every: int,
            device: torch.device, host_clock: bool = False,
            group: bool = False) -> dict:
    """The window: steps for ``seconds`` of host time, then a
    synchronize. With ``host_clock`` the host's seconds around each call
    are kept too. In a process group every process must run as many
    steps: process 0's clock decides, at the sync points only, and a
    broadcast of the benchmark's own (not counted among the program's
    collectives) carries its decision."""
    _sync(device)
    marks, host, failed, steps = _Marks(device), [], 0, 0
    t0 = time.perf_counter()
    go = torch.ones((), device=device)
    marks.mark()
    while True:
        h = time.perf_counter()
        metrics = prog.step()
        if host_clock:
            host.append(time.perf_counter() - h)
        marks.mark()
        steps += 1
        if steps % sync_every == 0:
            failed += not math.isfinite(metrics["total_loss"].item())
            if group:
                go.fill_(float(time.perf_counter() - t0 < seconds))
                torch.distributed.broadcast(go, 0)
                if not go.item():
                    break
        if not group and time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return {"seconds": time.perf_counter() - t0, "steps": steps,
            "intervals_ms": marks.intervals_ms(), "host_s": host,
            "failed": failed}


def _groups(readers) -> dict[str, set]:
    groups: dict[str, set] = {}
    for r in readers:
        for g, names in getattr(r, "HOOKS", {}).items():
            groups.setdefault(g, set()).update(names)
    return groups


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _check_modules():
    forbidden = _forbidden_modules()
    if forbidden:
        raise SystemExit(f"modules loaded that the port must not load: "
                         f"{forbidden}")


def run_process(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
                t_start: float, device: torch.device, rank: int = 0,
                world: int = 1) -> dict:
    """One process's part of a run: set-up, its first steps (process 0
    keeps the readings), the window, the traced steps. ``t_start``: the
    run's start, ``time.time()``."""
    from dualvar_tpu_torch.core import dist

    tr = cell.traffic
    if world > 1:
        dist.init_distributed(device)
    readers = [spec.reader(m["name"]) for m in spec.metrics(cell.name, True)]
    prog = Program(cell, seed, device, rank)
    readings = prog.first_steps(tr["compared_steps"])
    _sync(device)
    setup_s = time.time() - t_start
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = sum(dist.collectives.values())
    win = measure(prog, seconds, tr["sync_every"], device,
                  host_clock=trace_on, group=world > 1)
    counters = {"collectives_per_step":
                (sum(dist.collectives.values()) - before) / win["steps"]}
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if trace_on:
        groups = _groups(readers)
        traced = trace.profile_steps(
            prog.step, tr["trace_steps"],
            lambda: trace.GroupHooks(prog.model, groups))
    _check_modules()
    out = {"setup_s": setup_s, "window": win, "counters": counters,
           "setup_peak": setup_peak, "window_peak": window_peak,
           "trace": traced, "batch": prog.batch,
           "readings": readings if rank == 0 else None}
    del prog
    gc.collect()
    if world > 1:
        dist.destroy()
    return out


def _spawn(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
           t_start: float, device: torch.device,
           fault: str | None) -> list[dict]:
    """Each process of the cell's traffic as a process of its own
    (``ranks.py``), joined as a group by the variables
    ``core/dist.py:init_distributed`` reads, on a free local port; each
    writes its part under ``TMPDIR``. Every process is waited for."""
    world = cell.traffic["processes"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as fh:
            json.dump({"cell": dataclasses.asdict(cell), "seed": seed,
                       "seconds": seconds, "trace": trace_on,
                       "t_start": t_start, "device": device.type,
                       "fault": fault}, fh)
        procs = []
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(spec.HERE, "ranks.py"), job,
                 os.path.join(tmp, f"rank{r}.pt")],
                env=env, stdout=sys.stderr))
        deadline = time.time() + 330
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.time()))
                     for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"a process of the run failed: exit codes "
                               f"{codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def collect(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
            t_start: float, device: torch.device,
            fault: str | None = None) -> list[dict]:
    """Every process's part of a run (``run_process``): in this process for
    one, in processes of their own for more. ``fault`` (``faults.py``) is
    for the check's controls; a benchmark run plants none."""
    if cell.traffic["processes"] == 1:
        with faults.planted(fault):
            return [run_process(cell, seed, seconds, trace_on, t_start,
                                device)]
    return _spawn(cell, seed, seconds, trace_on, t_start, device, fault)


def run(name: str, seed: int, seconds: float, trace_on: bool,
        t_start: float, device: str = "cuda", cell: spec.Cell | None = None,
        fault: str | None = None) -> dict:
    """One run; returns the result line's object. ``t_start``: the run's
    start, ``time.time()``. ``cell`` replaces the one ``BENCHMARK.json``
    names (the tests' small sizes); ``fault`` see ``collect``."""
    device = torch.device(device)
    cell = cell or spec.cell(name)
    world = cell.traffic["processes"]
    parts = collect(cell, seed, seconds, trace_on, t_start, device, fault)
    device = torch.device(device.type)
    _check_modules()
    lead = parts[0]
    entries = spec.metrics(cell.name, trace_on)
    ctx = SimpleNamespace(
        cell=cell, config=cell.config, batch=lead["batch"], processes=world,
        setup_s=max(p["setup_s"] for p in parts), window=lead["window"],
        peak_bytes=max(p["window_peak"] for p in parts),
        trace=lead["trace"], counters=lead["counters"],
        out_bytes=lead["readings"]["out_bytes"])
    metrics = {}
    for m in entries:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cuda = device.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference_readings(cell, seed, device)
    within, rows = check.judge(check.numbers(lead["readings"], ref),
                               cell.limits)
    failed = sum(p["window"]["failed"] for p in parts)
    result = {
        "correct": within and failed == 0,
        "attempted": lead["window"]["steps"], "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": max(max(p["setup_peak"],
                                                p["window_peak"])
                                            for p in parts)},
    }
    traced = lead["trace"]
    if traced is not None:
        result["device"]["busy_s"] = sum(
            p["trace"]["busy_s"] or 0.0 for p in parts) / len(parts)
        result["device"]["window_s"] = traced["window_s"]
        ops = sorted(traced["by_kernel"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:160], t] for n, t in ops[:10]],
            "idle_gaps": [list(x) for x in traced["idle_gaps"]]}
    result["checks"] = rows
    return result


def reference_readings(cell: spec.Cell, seed: int, device: torch.device,
                       numerics: str = "float32",
                       plane_dtype: torch.dtype = torch.float32) -> dict:
    """The reference's readings of the run's first steps, from the seed:
    the same initial state, batches and draws, worked out again; with
    several processes, each process's shard and draws, the step on the
    global batch."""
    cfg, tr = cell.config, cell.traffic
    n, world = tr["compared_steps"], tr["processes"]
    state = synth.make_state(cfg, seed, device)
    pools = [synth.make_frames(cfg, tr["batch_per_process"],
                               tr["pool_batches"], seed, device, r)
             for r in range(world)]
    batches = [[pool[i % len(pool)] for pool in pools] for i in range(n)]
    gens = [synth.run_generator(seed, device, r) for r in range(world)]
    return reference.readings(cfg, state, batches, gens, numerics,
                              plane_dtype)
