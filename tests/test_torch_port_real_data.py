"""The port's real-data path against the JAX package's, on the CPU: a JPEG
frame tree on disk and its CSV index -> ``load_split`` -> the datasets ->
``HostLoader`` (the native batch assembler, or PIL) -> a train step; and the
offline tools that build such a tree (``write_csv``, ``extract_frames``).

The frame tree is the one of tests/test_real_data_path.py. Batches are
compared bitwise: both packages decode with the same native source (or both
with PIL) from the same per-(seed, epoch, index) numpy streams.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from dualvar_tpu.data import loader as JL
from dualvar_tpu.data.indices import load_split as jax_load_split
from dualvar_tpu.data.prep import extract_frames as jax_extract
from dualvar_tpu.data.prep import write_csv as jax_write_csv
from dualvar_tpu_torch import native
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.data import loader as TL
from dualvar_tpu_torch.data.indices import load_class_index, load_split
from dualvar_tpu_torch.data.prep import extract_frames, write_csv
from dualvar_tpu_torch.train.pretrain import train

import torch_port_util  # noqa: F401  (caps torch's threads)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

SCALE = (48, 40)
NATIVE = [pytest.param(True, id="native"), pytest.param(False, id="pil")]


def _needs_native(use_native):
    if use_native and not native.available():
        pytest.skip("g++ or libjpeg missing: no native decoder here")


@pytest.fixture(scope="module")
def frame_db(tmp_path_factory):
    """8 videos x 2 classes, 30 frames each, reference directory layout:
    {db}/{class}/{video}/image_%05d.jpg + ClassInd.txt + the split CSVs
    (tests/test_real_data_path.py's tree, with a test split too)."""
    root = tmp_path_factory.mktemp("idx")
    db = tmp_path_factory.mktemp("frames")
    classes = ["wave", "jump"]
    (root / "ClassInd.txt").write_text("\n".join(classes))
    rng = np.random.RandomState(0)
    rows = []
    for v in range(8):
        cls = classes[v % 2]
        vdir = db / cls / f"v_{cls}_{v:03d}"
        vdir.mkdir(parents=True)
        base = rng.randint(0, 255, (60, 80, 3), dtype=np.uint8)
        for i in range(30):
            Image.fromarray(np.roll(base, i * 2, axis=1)).save(
                str(vdir / f"image_{i + 1:05d}.jpg"), quality=80)
        rows.append(f"{vdir}/,30")
    (root / "train_split01.csv").write_text("\n".join(rows))
    (root / "test_split01.csv").write_text("\n".join(rows[:4]))
    return str(root), str(db)


def _pair(frame_db, use_native, make, mode="train"):
    """The same dataset in both packages (``make(package_loader, entries,
    class_index, source)``)."""
    root, db = frame_db
    out = []
    for L, split, classes in ((JL, jax_load_split, JL.load_class_index),
                              (TL, load_split, load_class_index)):
        entries = split(root, mode, val_size=2)
        src = L.JpegFrameSource(db, scale=SCALE, use_native=use_native)
        out.append(make(L, entries, classes(root), src))
    return out


def _batches(dataset, batch_size, loader_cls, epochs=(0, 1)):
    loader = loader_cls(dataset, batch_size=batch_size, seed=3,
                        num_workers=2)
    try:
        return [b for e in epochs for b in loader.epoch(e)]
    finally:
        if hasattr(loader, "close"):
            loader.close()
        else:
            loader.pool.shutdown(wait=True)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("use_native", NATIVE)
def test_pretrain_batches_equal_the_jax_packages(frame_db, use_native):
    _needs_native(use_native)
    jds, tds = _pair(frame_db, use_native, lambda L, e, ci, src:
                     L.PretrainDataset(entries=e, class_index=ci, source=src,
                                       num_frames=4, ds=2))
    assert (tds.source.native_batch is not None) == use_native
    want = _batches(jds, 3, JL.HostLoader)
    got = _batches(tds, 3, TL.HostLoader)
    assert got[0]["frames"].shape == (3, 12) + SCALE + (3,)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("use_native", NATIVE)
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_classifier_batches_equal_the_jax_packages(frame_db, use_native,
                                                   mode):
    _needs_native(use_native)
    jds, tds = _pair(frame_db, use_native, lambda L, e, ci, src:
                     L.ClassifierDataset(entries=e, class_index=ci,
                                         source=src, num_frames=4, ds=2,
                                         mode=mode), mode)
    _assert_batches_equal(_batches(tds, 2, TL.HostLoader),
                          _batches(jds, 2, JL.HostLoader))


def test_tenclip_batches_equal_the_jax_packages(frame_db):
    use_native = native.available()
    jds, tds = _pair(frame_db, use_native, lambda L, e, ci, src:
                     L.TenClipDataset(entries=e, class_index=ci, source=src,
                                      num_frames=2, ds=1))
    got = _batches(tds, 2, TL.HostLoader, epochs=(0,))
    assert got[0]["frames"].shape == (2, 20) + SCALE + (3,)
    _assert_batches_equal(got, _batches(jds, 2, JL.HostLoader, epochs=(0,)))


def test_native_assembler_equals_the_per_sample_path(frame_db):
    _needs_native(True)
    root, db = frame_db
    entries = load_split(root, "train", val_size=2)
    ds = TL.PretrainDataset(entries=entries,
                            class_index=load_class_index(root),
                            source=TL.JpegFrameSource(db, scale=SCALE),
                            num_frames=4, ds=2)
    with TL.HostLoader(ds, batch_size=4, seed=7, num_workers=3) as loader:
        assert loader._native_batch_ctx() is not None
        for epoch in (0, 2):
            indices = [5, 0, 3, 1]
            batch = loader._assemble(epoch, indices)
            samples = [loader._sample(epoch, i) for i in indices]
            for k in batch:
                np.testing.assert_array_equal(
                    batch[k], np.stack([s[k] for s in samples]), err_msg=k)
            # the readahead hint walks the same plans and decodes nothing
            loader._readahead(epoch, indices)


def test_fast_decode_without_the_native_decoder_raises(frame_db):
    """Unlike the JAX package, which then decodes exactly with PIL."""
    _, db = frame_db
    with pytest.raises(RuntimeError, match="fast_decode"):
        TL.JpegFrameSource(db, scale=SCALE, use_native=False,
                           fast_decode=True)
    with pytest.raises(RuntimeError, match="fast_decode"):
        TL.JpegFrameSource(db, scale=40, fast_decode=True)


@pytest.mark.parametrize("fast_decode", [False, True])
def test_pretrain_step_on_real_files(frame_db, tmp_path, fast_decode):
    """``train()`` of a small SimCLR on the frame tree, through
    ``build_dataset``'s JpegFrameSource: finite losses, a checkpoint."""
    if fast_decode:
        _needs_native(True)
    root, db = frame_db
    cfg = PRETRAIN_PRESETS["smoke"]
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, synthetic=False, dataset="ucf101-2clip-stage-prototype",
            data_root=root, db_path=db, val_size=2, seq_len=4, ds=2,
            img_dim=32, scale_hw=(40, 36), workers=2,
            fast_decode=fast_decode),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path)))
    metrics = train(cfg, max_steps=2, device="cpu")
    assert np.isfinite(metrics["total_loss"])
    assert os.path.exists(os.path.join(
        tmp_path, "smoke", "pretrain", "exp", "model", "latest",
        "epoch0.pth.tar"))


def _ucf_tree(base):
    """A UCF101-style frame tree and split lists (one empty video, which
    write_csv skips)."""
    frames, splits = base / "frames", base / "splits"
    splits.mkdir()
    lines = {}
    for c, cls in enumerate(["ApplyEyeMakeup", "Archery"]):
        for v in range(3):
            name = f"v_{cls}_g0{v + 1}_c01"
            vdir = frames / cls / name
            vdir.mkdir(parents=True)
            for i in range(v + (c != 0 or v != 1)):  # one video left empty
                (vdir / f"image_{i + 1:05d}.jpg").write_bytes(b"x")
            lines.setdefault("train" if v < 2 else "test", []).append(
                f"{cls}/{name}.avi {c + 1}")
    for which in (1, 2, 3):
        (splits / f"trainlist{which:02d}.txt").write_text(
            "\n".join(lines["train"]))
        (splits / f"testlist{which:02d}.txt").write_text(
            "\n".join(lines["test"]))
        for cls in ("ApplyEyeMakeup", "Archery"):
            (splits / f"{cls}_test_split{which}.txt").write_text("".join(
                f"v_{cls}_g0{v + 1}_c01.avi {1 if v < 2 else 2}\n"
                for v in range(3)))
    for sub in ("train", "val"):  # k400: frame dirs under train/ and val/
        for v in range(2):
            vdir = frames / sub / "abseiling" / f"k{v}"
            vdir.mkdir(parents=True)
            (vdir / "image_00001.jpg").write_bytes(b"x")
    return str(frames), str(splits)


@pytest.mark.parametrize("dataset", ["ucf101", "hmdb51", "k400"])
def test_write_csv_writes_the_jax_tools_files(tmp_path, monkeypatch,
                                              capsys, dataset):
    frames, splits = _ucf_tree(tmp_path)
    outs = {}
    for name, main in (("jax", None), ("port", write_csv.main)):
        out = str(tmp_path / f"out_{name}")
        argv = [dataset, "--frame_root", frames, "--split_root", splits,
                "--out_root", out]
        if main is None:
            monkeypatch.setattr(sys, "argv", ["write_csv", *argv])
            jax_write_csv.main()
        else:
            main(argv)
        outs[name] = {f: open(os.path.join(out, f)).read()
                      for f in sorted(os.listdir(out))}
    assert len(outs["port"]) == 6 and outs["port"] == outs["jax"]
    assert any(outs["port"].values())


def test_extract_frames_writes_the_jax_tools_frames(tmp_path):
    cv2 = pytest.importorskip("cv2")
    video_dir = tmp_path / "videos" / "Archery"
    video_dir.mkdir(parents=True)
    path = str(video_dir / "v_Archery_g01_c01.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                             (64, 48))
    rng = np.random.RandomState(0)
    for i in range(7):
        writer.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
    writer.release()
    got = extract_frames.extract_video(path, str(tmp_path / "port"), dim=40)
    want = jax_extract.extract_video(path, str(tmp_path / "jax"), dim=40)
    assert got == want == 7
    for i in range(1, 8):
        name = os.path.join("v_Archery_g01_c01", f"image_{i:05d}.jpg")
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read()
    counts = extract_frames.extract_dataset(
        str(tmp_path / "videos"), str(tmp_path / "tree"), n_jobs=1, dim=40)
    assert counts == [7]
    assert extract_frames.resize_dim(320, 240, 128) == \
        jax_extract.resize_dim(320, 240, 128)
