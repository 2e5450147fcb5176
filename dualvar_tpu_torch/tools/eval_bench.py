"""Throughput of the test protocols' shared forward on the card.
Counterpart of the JAX package's ``scripts/eval_bench.py``.

Validation, the temporal ten-clip test, the multi-crop tests and retrieval
all run one hot step: a uint8 batch -> the eval crop (``aug/pipeline.py:
eval_batch``: centre crop and normalisation, no kernel) -> the backbone
(``models/backbones:select_backbone``) -> ``models/heads.py:
LinearClassifier``'s linear head over 101 classes -> a float32 softmax (the
protocols consume probabilities). It runs under ``torch.inference_mode()``
and bfloat16 autocast on 16x112x112 clips from 171x128 frames, on every net
of the JAX script with its batch candidates, largest first; a batch that
runs out of device memory moves the search to the next
(``tools/timing.py:fit_batch``), any other failure ends the run with a
non-zero exit. 3 warm-up steps, then 3 chains of 20 steps; ``clips_per_sec``
is B over the best chain's step time, ``videos_per_sec_10clip`` a tenth of
it. Each record is merged into ``--out`` (default
``build/bench/eval.json``) as it is measured; the last line of standard
output is the list of records.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.eval_bench [net | net:B ...]
        [--steps 20] [--chains 3] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import json
import sys

import torch

from ..aug.pipeline import AugConfig, eval_batch
from ..models.backbones import select_backbone
from ..models.heads import LinearClassifier
from ..train.pretrain import _resolve_device
from ..train.tasks import step_context
from .bench import SMOKE_BATCHES, shapes, tool_parser
from .soak import fixed_frames
from .sweep_merge import parse_batches, sweep
from .timing import device_line, log, measure

NUM_CLASS = 101
# batch candidates a family, largest first
CANDIDATES = {
    "r3d": (512, 256, 128),
    "r21d": (512, 256, 128, 64),
    "c3d": (512, 256, 128),
    "s3d": (512, 256, 128, 64),
    "s3dg": (512, 256, 128, 64),
    "r2d3d18": (1024, 512, 256, 128),
    "r50": (512, 256, 128, 64),
}


def make_eval_step(model: LinearClassifier, aug_cfg: AugConfig,
                   dtype: torch.dtype = torch.bfloat16):
    """``step(frames_u8) -> probabilities`` (B, classes) float32: the eval
    crop, ``model`` (in eval mode) under ``dtype`` autocast, softmax."""
    def step(frames_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), step_context(frames_u8.device.type,
                                                  dtype) as autocast:
            clips = eval_batch(frames_u8, aug_cfg)
            with autocast():
                logit, _ = model(clips)
            return torch.softmax(logit.float(), dim=-1)

    return step


class EvalUnit:
    """The eval step of ``net`` (weights drawn from seed 0) on a fixed uint8
    batch; ``step()`` returns the probabilities."""

    def __init__(self, net: str, batch: int, smoke: bool,
                 device: torch.device):
        T, H0, W0, img = shapes(smoke)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            backbone, info = select_backbone(net)
            model = LinearClassifier(backbone, info["feature_size"],
                                     num_class=NUM_CLASS)
        self.model = model.to(device).eval()
        self.frames = fixed_frames(batch, T, (H0, W0), device)
        self._step = make_eval_step(
            self.model, AugConfig(img_dim=img, seq_len=T),
            torch.float32 if smoke else torch.bfloat16)

    def step(self) -> torch.Tensor:
        return self._step(self.frames)


def bench_net(net: str, n_steps: int = 20, chains: int = 3, batches=None,
              device: str | torch.device = "cuda", smoke: bool = False
              ) -> dict:
    """One net's record; ``error`` where no candidate fits."""
    device = _resolve_device(device)
    candidates = batches or (SMOKE_BATCHES if smoke else CANDIDATES[net])
    m = measure(lambda b: EvalUnit(net, b, smoke, device), candidates,
                n_steps, chains, device, net, count_flops=False)
    if m.batch is None:
        return {"net": net, "error": "all batch candidates failed",
                "did_not_fit": m.did_not_fit}
    clips = m.batch / m.per_step
    rec = {"net": net, **m.fields(device),
           "clips_per_sec": round(clips, 1),
           "videos_per_sec_10clip": round(clips / 10, 1),
           "output_finite": bool(torch.isfinite(m.out).all())}
    log(f"{net}: B={m.batch} {rec['ms_per_step']} ms/batch, "
        f"{rec['clips_per_sec']} clips/s = {rec['videos_per_sec_10clip']} "
        f"videos/s at 10 clips/video (chains {rec['chains_ms']})")
    return rec


def main(argv: list[str] | None = None) -> int:
    p = tool_parser(__doc__, "eval.json")
    p.add_argument("nets", nargs="*",
                   help=f"of {', '.join(CANDIDATES)}, or net:B for given "
                        "batches")
    args = p.parse_args(argv)
    line = device_line(torch.device(args.device))
    log(f"device: {line}")
    _, _, _, img = shapes(args.smoke)

    def bench(spec):
        net, _, batches = spec.partition(":")
        return bench_net(net, args.steps, args.chains,
                         parse_batches(batches) if batches else None,
                         args.device, args.smoke)

    out = sweep(args.nets or list(CANDIDATES), bench, args.out,
                {"shape": f"16x{img}^2 center-crop eval, bf16",
                 "device": line},
                list(CANDIDATES))
    print(json.dumps(out), flush=True)
    return 0 if all(r.get("output_finite") for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
