"""Metric sinks: JSONL scalars, images, and TensorBoard where it imports.

Own copy of ``dualvar_tpu/core/metrics_writer.py`` (the port imports
nothing of the JAX package). The reference writes tensorboardX scalars and
images from a background thread (utils/tensorboard_utils.py:4-28,
PlotterThread) under the local/ and global/ namespaces (pretrain.py:
460-482). Here ``{log_dir}/metrics.jsonl`` is the machine-readable scalar
sink (one object a scalar: ``tag``, ``value``, ``step``, ``ts``), PNG files
under ``{log_dir}/img/`` the image sink (``.npy`` where pillow is missing),
and tensorboardX, where it imports, gets the same items from the same
queue.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time

import numpy as np


class MetricsWriter:
    """One writer thread drains a queue of scalars and images; ``close()``
    writes what is queued and joins it."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=log_dir)
            except ImportError:
                pass
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def add_scalar(self, tag: str, value: float, step: int):
        self._q.put(("scalar", tag, float(value), int(step)))

    def add_image(self, tag: str, image, step: int):
        """Queue an image (reference PlotterThread.add_data(...,
        data_type='image'), tensorboard_utils.py:17). ``image`` is (H, W, C)
        or (H, W), float in [0, 1] or uint8 (a tensor is copied to the host);
        written as ``{log_dir}/img/{tag}_{step}.png`` (tag path-sanitised)
        and mirrored to TensorBoard when available."""
        if hasattr(image, "detach"):
            image = image.detach().cpu().numpy()
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        self._q.put(("image", tag, img, int(step)))

    def _write_image(self, tag: str, img: np.ndarray, step: int):
        img_dir = os.path.join(self.log_dir, "img")
        os.makedirs(img_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(" ", "_")
        path = os.path.join(img_dir, f"{safe}_{step}.png")
        try:
            from PIL import Image

            Image.fromarray(img).save(path)
        except ImportError:  # pillow is optional at the library boundary
            np.save(path.replace(".png", ".npy"), img)
        if self._tb is not None:
            chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
            self._tb.add_image(tag, chw, step)

    def _drain(self):
        while True:
            kind, tag, value, step = self._q.get()
            if kind == "stop":
                return
            try:
                if kind == "image":
                    self._write_image(tag, value, step)
                    continue
                self._jsonl.write(
                    json.dumps({"tag": tag, "value": value, "step": step,
                                "ts": time.time()}) + "\n")
                self._jsonl.flush()
                if self._tb is not None:
                    self._tb.add_scalar(tag, value, step)
            except Exception as e:  # a bad item must not kill the sink
                # (disk full, unwritable img dir, TensorBoard failure): the
                # later scalars and images still matter more than this one
                print(f"[metrics_writer] dropped {kind} {tag!r}: {e}",
                      flush=True)

    def close(self):
        self._q.put(("stop", "", 0.0, 0))
        self._thread.join(timeout=5)
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
