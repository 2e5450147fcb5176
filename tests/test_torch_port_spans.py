"""The port's spans and counters (``dualvar_tpu_torch/core/spans.py``) and
the benchmark's readers of them, on the CPU at tiny sizes: nesting,
parents, step ids and self time on a clock the test sets; the ring's bound
and the first records it keeps apart; the set-up spans' totals;
``record_function`` and CUDA events touched only while a profiler runs;
the flagship step's stage spans and its ``host_syncs``; each reader's
arithmetic on a hand-made record.

Two tests run on the card only (they skip without one): over one B=8
flagship step at its real shapes, the synchronizing calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports equal the step's
``host_syncs``, each made inside a ``dualvar.sync.*`` span; and in a bf16
R(2+1)D and S3D-G step every ``Conv3d`` input is in ``channels_last_3d``
memory and ``nchw_convs`` reads 0. The file imports no JAX; run it on the
card with ``python -m pytest --noconftest tests/test_torch_port_spans.py``.
"""

import collections
import dataclasses
import importlib.util
import os
import warnings
from types import SimpleNamespace

import pytest
import torch

from dualvar_tpu_torch.core import spans
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.train import pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("trainer.syncs", "trainer.sync_wait_ms", "trainer.enqueue_ms",
           "aug.ms", "losses.ms", "setup.model_s", "setup.first_step_s",
           "setup.kernel_load_s", "backbone.nchw_convs")


@pytest.fixture(autouse=True)
def fresh_record():
    spans.reset()
    yield
    spans.reset()


class Clock:
    """``time.perf_counter_ns`` that moves only when the test says."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def ms(self, t):
        self.ns += int(t * 1e6)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(spans, "time", c)
    return c


def test_nesting_parents_step_ids_and_self_time(clock):
    with spans.span("dualvar.setup.build_task"):
        clock.ms(5)
    for _ in range(2):
        with spans.span(spans.STEP):
            clock.ms(1)
            with spans.span("dualvar.step.aug"):
                clock.ms(2)
                with spans.sync("aug_check"):
                    clock.ms(3)
            with spans.span("dualvar.step.forward"):
                with spans.span("dualvar.losses"):
                    clock.ms(0.5)
                    with spans.span("dualvar.loss.clip"):
                        clock.ms(0.25)
            clock.ms(1)
    with spans.sync("outside"):  # no step open: spanned, not counted
        pass
    views = spans.steps()
    assert [v["id"] for v in views] == [0, 1]
    v = views[1]
    assert v["profiled"] is False and v["stream_ms"] == {}
    assert list(v["host_ms"]) == [
        spans.STEP, "dualvar.step.aug", "dualvar.sync.aug_check",
        "dualvar.step.forward", "dualvar.losses", "dualvar.loss.clip"]
    assert v["host_ms"] == pytest.approx({
        spans.STEP: 7.75, "dualvar.step.aug": 5.0,
        "dualvar.sync.aug_check": 3.0, "dualvar.step.forward": 0.75,
        "dualvar.losses": 0.75, "dualvar.loss.clip": 0.25})
    assert v["self_ms"] == pytest.approx({
        spans.STEP: 2.0, "dualvar.step.aug": 2.0,
        "dualvar.sync.aug_check": 3.0, "dualvar.step.forward": 0.0,
        "dualvar.losses": 0.5, "dualvar.loss.clip": 0.25})
    assert v["syncs"] == {spans.STEP: 1, "dualvar.step.aug": 1,
                          "dualvar.sync.aug_check": 1}
    assert v["counts"] == {"host_syncs": 1}
    rec = spans._record
    clip = rec.first["dualvar.loss.clip"]
    assert [clip.parent.name, clip.parent.parent.name,
            clip.parent.parent.parent.name] == [
        "dualvar.losses", "dualvar.step.forward", spans.STEP]
    assert clip.step.id == 0 and rec.first[spans.STEP].parent is None
    assert rec.first["dualvar.setup.build_task"].step is None
    assert spans.first_ms("dualvar.setup.build_task") == pytest.approx(5.0)
    assert spans.first_ms("dualvar.nothing") is None
    lines = spans.summary(views)
    assert lines[0] == (f"{spans.STEP}: host 7.750 ms, self 2.000 ms, "
                        "stream -, syncs 1 a step over 2")
    assert len(lines) == 6 and spans.summary([]) == []


def test_count_adds_to_the_open_step_only():
    spans.count("nchw_convs")  # no step open: nothing
    with spans.span(spans.STEP):
        spans.count("nchw_convs")
        spans.count("nchw_convs", 3)
        with spans.sync("aug_check"):
            pass
    spans.count("nchw_convs")
    with spans.span(spans.STEP):
        pass
    first, second = spans.steps()
    assert first["counts"] == {"nchw_convs": 4, "host_syncs": 1}
    assert second["counts"] == {}


def test_the_ring_keeps_its_last_steps_and_first_records(clock):
    for i in range(spans.RING + 44):
        with spans.span(spans.STEP):
            clock.ms(100 if i == 0 else 1)
    views = spans.steps()
    assert len(views) == spans.RING
    assert [v["id"] for v in views] == list(range(44, spans.RING + 44))
    # the first step (the warm-up) survives the ring apart
    assert spans.first_ms(spans.STEP) == pytest.approx(100.0)
    assert all(v["host_ms"][spans.STEP] == pytest.approx(1.0)
               for v in views)


def test_set_up_spans_are_totalled_over_the_process(clock, monkeypatch):
    """Each ``dualvar.setup.*`` name keeps its total over the process,
    inside the first step or outside any, past the ring; the
    ``setup.kernel_load_s`` reader reads it. ``ops/build.py:load_library``
    opens the span once a library (a library on disk, loaded by a stub)."""
    from dualvar_tpu_torch.ops import build

    with spans.span("dualvar.setup.kernel_load"):
        clock.ms(7)
    with spans.span(spans.STEP):
        with spans.span("dualvar.setup.kernel_load"):
            clock.ms(3)
    for _ in range(spans.RING):
        with spans.span(spans.STEP):
            clock.ms(1)
    assert spans.setup_ms("dualvar.setup.kernel_load") == pytest.approx(10.0)
    assert spans.first_ms("dualvar.setup.kernel_load") == pytest.approx(7.0)
    assert spans.setup_ms(spans.STEP) is None  # not a set-up name
    assert _read("setup.kernel_load_s") == pytest.approx(0.010)

    spans.reset()
    monkeypatch.setattr(build.os.path, "exists", lambda path: True)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    build.load_library.cache_clear()
    try:
        for _ in range(2):
            assert build.load_library("aug_fused") == build.library_path(
                "aug_fused")
    finally:
        build.load_library.cache_clear()
    assert spans._record.first["dualvar.setup.kernel_load"].step is None
    assert spans.setup_ms("dualvar.setup.kernel_load") == 0.0  # one span


class Refused:
    def __init__(self, *a, **kw):
        raise AssertionError("touched with no profiler running")


class FakeEvent:
    """A CUDA event on a stream whose clock moves 1.5 ms a tick; each
    record is a tick."""
    made, ticks = [], 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        FakeEvent.made.append(self)

    def record(self):
        FakeEvent.ticks += 1
        self.at = FakeEvent.ticks

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5 * (end.at - self.at)


def test_record_function_and_events_only_under_a_profiler(monkeypatch):
    monkeypatch.setattr(spans._profiler, "record_function", Refused)
    monkeypatch.setattr(torch.cuda, "Event", Refused)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with spans.span(spans.STEP):
        with spans.span("dualvar.step.aug", device=True):
            pass
    assert spans.steps()[-1]["profiled"] is False

    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    FakeEvent.made = []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span(spans.STEP):
            with spans.span("dualvar.step.aug", device=True):
                torch.ones(3).sum()
            with spans.span("dualvar.step.metrics"):
                pass
    v = spans.steps()[-1]
    assert v["profiled"] is True
    assert len(FakeEvent.made) == 2
    assert all(e.at is not None for e in FakeEvent.made)
    assert v["stream_ms"] == {"dualvar.step.aug": pytest.approx(1.5)}
    names = {e.name for e in prof.events()}
    assert {spans.STEP, "dualvar.step.aug", "dualvar.step.metrics"} <= names


def _flagship(**data):
    """The flagship preset (SimCLR-TSV4, R(2+1)D) in float32, at the data
    sizes given."""
    cfg = PRETRAIN_PRESETS["paper_table1_k400"]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data),
        model=dataclasses.replace(cfg.model, dtype="float32"),
        optim=dataclasses.replace(cfg.optim, batch_size=2))


def _step(cfg, device, with_task=False):
    task = pretrain.build_task(cfg)
    task.model.to(device).train()
    optimizer, scheduler = pretrain.make_optimizer(cfg, task.parameters(), 10)
    step = pretrain.make_train_step(
        task, optimizer, scheduler, pretrain.aug_config(cfg),
        pretrain._AUTOCAST[cfg.model.dtype])
    H0, W0 = cfg.data.scale_hw
    frames = torch.randint(0, 256, (cfg.optim.batch_size,
                                    3 * cfg.data.seq_len, H0, W0, 3),
                           dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    return (step, frames, gen) + ((task,) if with_task else ())


def test_flagship_step_spans_its_stages_and_counts_its_syncs():
    """Each call is one step with the stage spans, the losses and the four
    terms; the ``_check`` read-back is spanned and counted once a step,
    and ``host_syncs`` counts every ``dualvar.sync.*`` span."""
    cfg = _flagship(seq_len=8, img_dim=32, scale_hw=(40, 36))
    step, frames, gen = _step(cfg, "cpu")
    for _ in range(2):
        step(frames, gen)
    views = spans.steps()
    assert [v["id"] for v in views] == [0, 1]
    assert spans.first_ms("dualvar.setup.build_task") > 0
    for v in views:
        assert set(v["host_ms"]) >= {
            spans.STEP, "dualvar.step.aug", "dualvar.step.forward",
            "dualvar.losses", "dualvar.loss.clip", "dualvar.loss.tc",
            "dualvar.loss.aug_ranking", "dualvar.loss.unaug_ranking",
            "dualvar.step.backward", "dualvar.step.update",
            "dualvar.step.metrics"}
        assert "dualvar.step.grad_sync" not in v["host_ms"]  # no group
        assert v["syncs"]["dualvar.sync.aug_check"] == 1
        assert v["counts"]["host_syncs"] == sum(
            n for name, n in v["syncs"].items()
            if name.startswith(spans.SYNC)) == v["syncs"][spans.STEP]
        assert v["syncs"]["dualvar.step.aug"] == v["counts"]["host_syncs"]


def test_flagship_step_on_the_cpu_counts_every_nchw_convolution():
    """On the CPU the backbone keeps NCDHW (``card_layout`` leaves a CPU
    tensor as it is), so ``nchw_convs`` counts every ``Conv3d`` call of
    the step whose input is not also channels-last (a map of one position
    is both); a call outside a step counts nowhere."""
    from dualvar_tpu_torch.models.layers import Conv3d

    cfg = _flagship(seq_len=8, img_dim=32, scale_hw=(40, 36))
    step, frames, gen, task = _step(cfg, "cpu", with_task=True)
    convs = [m for m in task.model.modules() if isinstance(m, Conv3d)]
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append(not args[0].is_contiguous(
            memory_format=torch.channels_last_3d))) for m in convs]
    try:
        step(frames, gen)
        in_step = list(calls)
        task.model.backbone(torch.zeros(1, 3, 8, 32, 32))  # outside a step
    finally:
        for h in hooks:
            h.remove()
    (view,) = spans.steps()
    # the backbone twice: the 3B views, then the B shuffled clips
    assert len(in_step) == 2 * len(convs) == 48
    assert view["counts"]["nchw_convs"] == sum(in_step) > 40
    assert len(calls) == 3 * len(convs) and len(spans.steps()) == 1


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(name, window_steps=3, trace_steps=2):
    ctx = SimpleNamespace(window={"steps": window_steps},
                          trace={"steps": trace_steps})
    return _reader(name).read(ctx)


def test_readers_on_a_hand_made_record(clock, monkeypatch):
    """Set-up: build_task 1.5 s; step 0 (the warm-up) 2 s. Then 4 steps of
    the window, step k waiting (2 + k) ms in its first sync, 0 ms in k
    more, and issuing 10 ms besides; then 2 profiled steps, whose host
    times the host readers leave out and whose aug and losses spans the
    stream readers read."""
    for name in READERS:
        assert _read(name) is None, name  # an empty record
    with spans.span("dualvar.setup.build_task"):
        clock.ms(1500)
    with spans.span(spans.STEP):
        clock.ms(2000)
    for k in range(4):
        with spans.span(spans.STEP):
            clock.ms(4)
            with spans.span("dualvar.step.aug"):
                with spans.sync("aug_check"):
                    clock.ms(2 + k)
                for _ in range(k):
                    with spans.sync("jitter_identity"):
                        pass
                clock.ms(6)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(spans._profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(spans._profiler, "record_function",
                        lambda name: SimpleNamespace(
                            __enter__=lambda: None,
                            __exit__=lambda *a: None))
    FakeEvent.made = []
    for _ in range(2):
        with spans.span(spans.STEP):
            clock.ms(500)
            with spans.span("dualvar.step.aug", device=True):
                pass  # one tick: 1.5 ms
            with spans.span("dualvar.losses", device=True):
                FakeEvent.ticks += 1  # two ticks: 3.0 ms
    # the window's last 3 unprofiled steps: k = 1, 2, 3
    assert _read("trainer.syncs") == pytest.approx((2 + 3 + 4) / 3)
    assert _read("trainer.sync_wait_ms") == pytest.approx((3 + 4 + 5) / 3)
    assert _read("trainer.enqueue_ms") == pytest.approx(10.0)
    # a window longer than the record: what the ring holds
    assert _read("trainer.sync_wait_ms", window_steps=50) == pytest.approx(
        (2 + 3 + 4 + 5) / 5)
    assert _read("trainer.enqueue_ms", window_steps=50) == pytest.approx(
        (2000 + 4 * 10) / 5)
    assert _read("aug.ms") == pytest.approx(1.5)
    assert _read("losses.ms") == pytest.approx(3.0)
    assert _read("aug.ms", trace_steps=0) is None
    assert _read("setup.model_s") == pytest.approx(1.5)
    assert _read("setup.first_step_s") == pytest.approx(2.0)


def test_nchw_convs_reader_is_the_window_mean(monkeypatch):
    """``backbone.nchw_convs``: None with no step, the mean count over the
    window's unprofiled steps (a step that counted nothing reads 0), and
    None from a program without ``spans.count``."""
    assert _read("backbone.nchw_convs") is None
    for k in (0, 2, 4, 9):
        with spans.span(spans.STEP):
            spans.count("nchw_convs", k)
    assert _read("backbone.nchw_convs") == pytest.approx(15 / 3)
    assert _read("backbone.nchw_convs", window_steps=2) == pytest.approx(6.5)
    spans.reset()
    for _ in range(3):
        with spans.span(spans.STEP):
            pass
    assert _read("backbone.nchw_convs") == 0.0
    monkeypatch.delattr(spans, "count")
    assert _read("backbone.nchw_convs") is None


@pytest.mark.parametrize("preset", ["paper_table1_k400", "s3dg_k400"])
def test_every_convolution_of_a_bf16_step_is_channels_last_on_the_card(
        preset):
    """A B=8 bf16 step of the flagship (R(2+1)D) and of S3D-G at their real
    shapes, after a warm-up step: every ``Conv3d`` input in
    ``channels_last_3d`` memory, and the step's ``nchw_convs`` 0."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    from dualvar_tpu_torch.models.layers import Conv3d

    cfg = PRETRAIN_PRESETS[preset]
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, batch_size=8))
    step, frames, gen, task = _step(cfg, "cuda", with_task=True)
    step(frames, gen)
    torch.cuda.synchronize()
    spans.reset()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous(
            memory_format=torch.channels_last_3d)))
        for m in task.model.modules() if isinstance(m, Conv3d)]
    try:
        step(frames, gen)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    (view,) = spans.steps()
    assert len(seen) > 40 and all(seen), (len(seen), sum(seen))
    assert view["counts"].get("nchw_convs", 0) == 0


def test_every_sync_of_a_flagship_step_is_counted_on_the_card():
    """The card's own account: one B=8 flagship step in bf16 at its real
    shapes, after a warm-up step, under the sync debug mode."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    cfg = PRETRAIN_PRESETS["paper_table1_k400"]
    step, frames, gen = _step(cfg, "cuda")
    step(frames, gen)
    torch.cuda.synchronize()
    spans.reset()
    reported = []  # each synchronizing call: the span open then, the line

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            stack = spans._record.stack
            reported.append((stack[-1].name if stack else None,
                             f"{filename}:{lineno}"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(frames, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (view,) = spans.steps()
    assert view["counts"]["host_syncs"] == len(reported) > 0, reported
    # each one inside a dualvar.sync.* span, as many in each as it counted
    assert collections.Counter(name for name, _ in reported) == {
        name: n for name, n in view["syncs"].items()
        if name.startswith(spans.SYNC)}, reported
