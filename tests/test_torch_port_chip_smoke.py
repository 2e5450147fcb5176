"""The shape of ``chip_smoke.py``, the port's check on the card, held on the
CPU without a card: which checks its main run reaches (by ``ast``, against
the list its main run reached before the studies left it), the float32
feature gate (``f32_gate``, ``f32_errors``) on made-up errors, the phase
clock (``PhaseClock``) and the bands and minutes the script is held to.
Nothing here builds or launches a kernel, and nothing imports JAX.
"""

import ast
import importlib.util
import json
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "chip_smoke.py")

# every check_* and run_* function that main() reached before the studies
# and the timing-only step windows moved to ``--study``
PARENT_REACHED = (
    "check_aug_bf16_compute", "check_aug_classifier_shapes",
    "check_aug_f32_unchanged", "check_aug_kernel", "check_bench_record",
    "check_bn_routes_at_world_one", "check_chain_stage",
    "check_channel_sums_kernel", "check_conv_kernel", "check_conv_on_path_r",
    "check_dtw_case", "check_embedded_pad128_step", "check_f32_classifier",
    "check_f32_forward", "check_features_on_card", "check_graft",
    "check_moco_state", "check_native_batches", "check_observability",
    "check_packed_s3dg", "check_pad_blocks_saved", "check_ptxas_clean",
    "check_remat_running_stats", "check_restore_on_card",
    "check_shuffle_bn_at_world_one", "check_soak", "check_soft_dtw_kernels",
    "check_store", "check_sums_on_path_g", "check_sums_profiler",
    "check_unfused_on_card", "run_aug_study", "run_backbone_steps",
    "run_bench_phase", "run_bf16_compute_step", "run_learning",
    "run_main_path", "run_path", "run_path_c", "run_path_d", "run_path_e",
    "run_path_f", "run_path_g", "run_path_j", "run_path_m",
    "run_path_m_resume", "run_path_p", "run_path_r", "run_path_s",
    "run_path_v", "run_smoke_presets", "run_soak_paths", "run_torchrun")
# reached only through ``--study`` (``run_study``): aug_fused's studies, the
# two diagnoses, the float32 error growth through the batch norms and the
# step times the main run does not take
STUDY_ONLY = ("run_aug_study", "check_aug_f32_unchanged",
              "diagnose_aug_f32_margin", "diagnose_conv_bf16_margin",
              "study_f32_growth", "study_step_times")


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graph():
    """Top-level function -> the top-level functions its body names."""
    with open(PATH) as fh:
        tree = ast.parse(fh.read())
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return {name: {x.id for x in ast.walk(node)
                   if isinstance(x, ast.Name) and x.id in defs}
            for name, node in defs.items()}


def _reached(graph, root, skip=()):
    seen, stack = set(), [root]
    while stack:
        name = stack.pop()
        if name in seen or name in skip:
            continue
        seen.add(name)
        stack.extend(graph[name] - seen)
    return seen


@pytest.mark.parametrize("name", sorted(set(PARENT_REACHED)
                                        - set(STUDY_ONLY)))
def test_main_run_still_reaches_each_check(graph, name):
    assert name in _reached(graph, "main", skip={"run_study"})


def test_studies_are_off_the_main_run_and_under_study(graph):
    normal = _reached(graph, "main", skip={"run_study"})
    assert not normal & set(STUDY_ONLY)
    assert set(STUDY_ONLY) <= _reached(graph, "run_study")
    assert "run_study" in graph["main"]


@pytest.mark.parametrize("errs, atol, ok", [
    # two float32 answers 2.45e-4 apart, each within 2e-4 of float64
    ({"card_vs_cpu": 2.45e-4, "cpu_vs_f64": 1.5e-4, "card_vs_f64": 1.9e-4},
     2e-4, True),
    ({"card_vs_cpu": 1.0e-5, "cpu_vs_f64": 1.5e-4, "card_vs_f64": 2.1e-4},
     2e-4, False),
    ({"card_vs_cpu": 1.0e-5, "cpu_vs_f64": 2.1e-4, "card_vs_f64": 1.5e-4},
     2e-4, False),
    ({"card_vs_cpu": 9.8e-4, "cpu_vs_f64": 7.6e-4, "card_vs_f64": 1.4e-3},
     1.5e-3, True),
    ({"card_vs_cpu": 0.0, "cpu_vs_f64": 0.0, "card_vs_f64": math.nan},
     2e-4, False),
], ids=["card-vs-cpu-over", "card-over", "cpu-over", "r50-band", "nan"])
def test_f32_gate_holds_each_float32_answer_against_float64(cs, errs, atol,
                                                             ok):
    assert cs.f32_gate(errs, atol) is ok


def test_f32_errors_are_the_largest_pairwise_differences(cs):
    f64 = [torch.tensor([1.0, -2.0], dtype=torch.float64),
           torch.tensor([[0.5]], dtype=torch.float64)]
    cpu = [torch.tensor([1.0 + 1e-4, -2.0]), torch.tensor([[0.5]])]
    card = [torch.tensor([1.0, -2.0 - 3e-4]), torch.tensor([[0.5 + 2e-4]])]
    errs = cs.f32_errors(card, cpu, f64)
    assert errs["cpu_vs_f64"] == pytest.approx(1e-4, rel=1e-3)
    assert errs["card_vs_f64"] == pytest.approx(3e-4, rel=1e-3)
    assert errs["card_vs_cpu"] == pytest.approx(3e-4, rel=1e-3)
    assert errs["max_abs_out"] == 2.0
    with pytest.raises(ValueError):  # the passes must pair up
        cs.f32_errors(card, cpu[:1], f64)


def test_phase_clock_prints_each_phase_and_the_json_line(cs, capsys):
    clock = cs.PhaseClock()
    with clock("build"):
        pass
    with pytest.raises(SystemExit):  # a failed phase still reports
        with clock("path G"):
            cs.fail("made up")
    with clock("build"):  # a repeated name adds up
        pass
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[1].strip() for line in out] == [
        "build", "path G", "build"]
    assert all(line.startswith("phase: ") and line.endswith(" s")
               for line in out)
    line = json.loads(clock.line(12.5))
    assert list(line["phase_seconds"]) == ["build", "path G"]
    assert all(v >= 0 for v in line["phase_seconds"].values())
    assert line["sum_s"] == pytest.approx(sum(
        line["phase_seconds"].values()))
    assert line["total_s"] == 12.5


def test_main_prints_phase_seconds_before_the_kernels_line():
    """The last prints of the main run, in order: the wall time, the
    ``phase_seconds`` line, the ``kernels`` line, the card, the contract
    line."""
    with open(PATH) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    prints = [ast.unparse(n.args[0]) for n in ast.walk(main)
              if isinstance(n, ast.Call) and getattr(n.func, "id", "")
              == "print" and n.args]
    tail = prints[prints.index("phase.line(total)"):]
    assert tail[1].startswith("json.dumps({'kernels'")
    assert tail[2] == "smi"
    assert tail[3].startswith("json.dumps({'ok': True")
    assert "'platform': 'gpu'" in tail[3]


def test_bands_and_soak_minutes(cs):
    """The float32 feature bands are the ones the gate held before it
    moved to float64; the SimCLR soak runs half a minute, MoCo's three
    (one wrap of the 16,384-row queue)."""
    assert cs.FEATURE_F32_ATOL == 2e-4
    assert cs.FEATURE_F32_ATOL_BY_NET == {"r50": 1.5e-3}
    assert cs.CLF_F32_ATOL == 2e-4
    assert (cs.SOAK_MINUTES, cs.MOCO_SOAK_MINUTES) == (0.5, 3.0)
