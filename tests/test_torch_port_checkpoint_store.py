"""The port's checkpoint store (dualvar_tpu_torch.core.checkpoint) against
the JAX package's orbax ``CheckpointStore``: the same saves keep the same
epochs in ``latest`` and ``best`` and give the same ``best_epoch``, ties,
saves without metrics and skipped saves included, with and without
``keep_all``, across a close and a reopen. Then what the JAX store cannot
show: the asynchronous save's snapshot, wait and error, the rename that
leaves no torn file, and the flat layout earlier versions of the port
wrote."""

import os

import numpy as np
import pytest
import torch

from dualvar_tpu.core.checkpoint import CheckpointStore as JaxStore
from dualvar_tpu_torch.core import checkpoint as C
from dualvar_tpu_torch.core.checkpoint import (CheckpointStore,
                                               checkpoint_file,
                                               load_state_dict,
                                               restore_single, save_single)

import torch_port_util  # noqa: F401  (caps torch's threads)

# (epoch, acc or None) in save order; None saves without metrics (acc 0.0)
SEQUENCES = {
    "ties": [(0, .1), (1, .5), (2, .3), (3, .5), (4, .2), (5, .9), (6, .1),
             (7, .5), (8, .5)],
    "all_equal": [(e, 0.0) for e in range(8)],
    "no_metrics": [(0, .1), (1, None), (2, .3), (3, None), (4, .2),
                   (5, .9), (6, .1), (7, .5), (8, .5)],
    "decreasing": [(e, 1.0 - e / 10) for e in range(7)],
    "skipped": [(0, .9), (5, .8), (2, .7), (3, .6), (6, .1), (7, .95)],
    "sparse": [(4, .4), (9, .3), (14, .8), (19, .8), (24, .2), (29, .8),
               (34, .1), (39, .8)],
}


def _epochs(directory):
    return sorted(C._epoch_files(directory))


def _state(epoch):
    return {"epoch": epoch, "w": torch.full((3,), float(epoch))}


@pytest.mark.parametrize("keep_all", [False, True])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_retention_matches_the_jax_store(tmp_path, name, keep_all):
    seq = SEQUENCES[name]
    half = len(seq) // 2
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for part in (seq[:half], seq[half:]):  # closed and reopened between
        jax_store = JaxStore(jdir, keep_all=keep_all)
        port = CheckpointStore(pdir, keep_all=keep_all)
        for epoch, acc in part:
            metrics = None if acc is None else {"acc": acc}
            jax_store.save(epoch, {"w": np.zeros(3)}, metrics)
            port.save(epoch, _state(epoch), metrics)
        want_latest = sorted(jax_store.latest_mgr.all_steps())
        want_best = sorted(jax_store.best_mgr.all_steps())
        assert _epochs(port.latest_dir) == want_latest
        assert _epochs(port.best_dir) == want_best
        assert port.latest_epoch() == jax_store.latest_epoch()
        assert port.best_epoch() == jax_store.best_epoch()
        jax_store.close()
        port.close()
    reopened = CheckpointStore(pdir, keep_all=keep_all)
    assert reopened.best_epoch() == port.best_epoch()
    # every kept file holds its own epoch, in either directory
    for epoch in set(want_latest) | set(want_best):
        assert reopened.restore(epoch)["epoch"] == epoch
    assert reopened.restore()["epoch"] == want_latest[-1]


def test_async_save_snapshots_waits_and_restores(tmp_path):
    store = CheckpointStore(str(tmp_path), async_save=True)
    state = {"w": torch.zeros(4), "nested": [torch.ones(2)]}
    assert store.save(0, state, {"acc": 0.5})
    # the step goes on changing its tensors while the file is written
    state["w"].add_(7.0)
    state["nested"][0].mul_(3.0)
    assert store.latest_epoch() == 0  # counted while in flight
    got = store.restore(0)  # waits for the write
    assert torch.equal(got["w"], torch.zeros(4))
    assert torch.equal(got["nested"][0], torch.ones(2))
    assert not store.save(0, state)  # an epoch not past the newest: skipped
    store.close()
    assert _epochs(store.latest_dir) == [0]


def test_async_save_error_is_raised_and_leaves_no_torn_file(tmp_path,
                                                            monkeypatch):
    store = CheckpointStore(str(tmp_path), async_save=True)
    store.save(0, _state(0), {"acc": 0.1})
    store.wait_until_finished()
    real_save = torch.save

    def torn(obj, path):  # half a file, then the disk fills
        with open(path, "wb") as fh:
            fh.write(b"\x80\x02half a pickle")
        raise OSError("no space left on device")

    monkeypatch.setattr(C.torch, "save", torn)
    assert store.save(1, _state(1), {"acc": 0.9})  # returns; write fails
    with pytest.raises(OSError, match="no space"):
        store.wait_until_finished()
    # the failed epoch is not in the store, and no file carries its name
    assert store.latest_epoch() == 0 and store.best_epoch() == 0
    assert "epoch1.pth.tar" not in os.listdir(store.latest_dir)
    assert "epoch1.pth.tar" not in os.listdir(store.best_dir)
    # the next save, and close, re-raise the error of the one before
    store.save(2, _state(2))
    with pytest.raises(OSError, match="no space"):
        store.save(3, _state(3))
    monkeypatch.setattr(C.torch, "save", real_save)
    store.close()
    # a reopened store clears the temporary file and reads what is whole
    reopened = CheckpointStore(str(tmp_path))
    assert not [n for n in os.listdir(reopened.latest_dir)
                if n.endswith(".tmp")]
    assert reopened.latest_epoch() == 0
    assert reopened.restore()["epoch"] == 0
    assert checkpoint_file(str(tmp_path)).endswith(
        os.path.join("latest", "epoch0.pth.tar"))


def test_sync_save_error_is_raised_by_save(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))

    def failing(obj, path):
        raise OSError("disk gone")

    monkeypatch.setattr(C.torch, "save", failing)
    with pytest.raises(OSError, match="disk gone"):
        store.save(0, _state(0), {"acc": 1.0})
    assert store.latest_epoch() is None and store.best_epoch() is None


def test_flat_layout_of_earlier_port_versions_reads_as_latest(tmp_path):
    """A ``model/`` of ``epoch*.pth.tar`` files: the store's latest (no
    best), and ``checkpoint_file`` / ``load_state_dict`` read it, as they
    read the store's layout."""
    flat = tmp_path / "flat"
    flat.mkdir()
    for epoch in (3, 11, 7):
        torch.save({"epoch": epoch, "state_dict": {"w": torch.tensor(
            [float(epoch)])}}, flat / f"epoch{epoch}.pth.tar")
    store = CheckpointStore(str(flat))
    assert store.best_dir is None and not (flat / "latest").exists()
    assert store.latest_epoch() == 11 and store.best_epoch() == 11
    assert store.restore()["epoch"] == 11
    assert store.restore(3)["epoch"] == 3
    assert checkpoint_file(str(flat)).endswith("epoch11.pth.tar")
    assert float(load_state_dict(str(flat))["w"]) == 11.0
    # saving into it keeps the JAX store's flat rule: the latest two
    store.save(12, {"epoch": 12, "state_dict": {"w": torch.tensor([12.0])}})
    assert _epochs(str(flat)) == [11, 12]

    layered = CheckpointStore(str(tmp_path / "layered"))
    layered.save(5, {"epoch": 5, "state_dict": {"w": torch.tensor([5.0])}},
                 {"acc": 1.0})
    layered.save(6, {"epoch": 6, "state_dict": {"w": torch.tensor([6.0])}},
                 {"acc": 0.0})
    assert float(load_state_dict(layered.directory)["w"]) == 6.0
    with pytest.raises(FileNotFoundError):
        checkpoint_file(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="epoch 4"):
        layered.restore(4)


def test_save_single_round_trip(tmp_path):
    path = str(tmp_path / "features.pth")
    state = {"f": torch.arange(6.0).reshape(2, 3), "names": ["a", "b"]}
    save_single(path, state)
    got = restore_single(path)
    assert torch.equal(got["f"], state["f"]) and got["names"] == ["a", "b"]
    assert os.listdir(tmp_path) == ["features.pth"]
