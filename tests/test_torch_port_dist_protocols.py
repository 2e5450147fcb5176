"""The classifier's test protocols under two gloo processes: ten-crop
(with its center and five-crop groups), temporal ten-clip and retrieval
on a test set of 5 videos, so the shards are padded (3 and 3, one video
twice). Each process tests its shard, the results are gathered and the
padding's duplicates dropped by video id (``train/classifier.py``, the JAX
package's ``_gather_concat`` / ``_dedupe_by_vid`` and seen-count merge):
every accuracy equals a single process's bitwise, on both processes. The
counterpart of ``scripts/multihost_eval_check.py``."""

import dataclasses

from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS, ModelConfig
from dualvar_tpu_torch.train import classifier as TC

from torch_port_util import launch_ranks

VIDEOS = 5


def _cfg(log_root):
    """The smoke preset at the protocol tests' sizes (R3D, 4x32x32 clips,
    2 classes, ds 8: a few test windows a video), batch 2."""
    cfg = CLASSIFIER_PRESETS["smoke"]
    return dataclasses.replace(
        cfg, num_class=2,
        data=dataclasses.replace(
            cfg.data, seq_len=4, ds=8, img_dim=32, scale_hw=(40, 36),
            synthetic_videos=VIDEOS, synthetic_classes=2, workers=2),
        model=ModelConfig(net="r3d", dtype="float32"),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        run=dataclasses.replace(cfg.run, log_root=str(log_root)))


def test_protocols_under_two_processes_equal_one_process(tmp_path):
    single = _cfg(tmp_path / "single")
    want = {"ten": TC.test_multicrop(single, "ten", device="cpu"),
            "temporal": TC.test_temporal_tenclip(single, device="cpu"),
            "retrieval": TC.test_retrieval(single, device="cpu")}
    outs = launch_ranks("protocols", {"cfg": _cfg(tmp_path / "ranks")},
                        tmp_path / "run")
    assert len(TC.tenclip_dataset(single, "test")) == VIDEOS
    for rank, out in enumerate(outs):
        for name in ("ten", "temporal", "retrieval"):
            assert out[name] == want[name], (rank, name)
    # the accuracies are not all of one value: the comparison has teeth
    assert len({v for v in want["ten"].values()}) > 1 or \
        want["temporal"]["top1"] not in (0.0, 1.0)
