"""Metric sinks: JSONL scalars, images, and TensorBoard where it imports.

Own copy of ``dualvar_tpu/core/metrics_writer.py`` (the port imports
nothing of the JAX package). The reference writes tensorboardX scalars and
images from a background thread (utils/tensorboard_utils.py:4-28,
PlotterThread) under the local/ and global/ namespaces (pretrain.py:
460-482). Here ``{log_dir}/metrics.jsonl`` is the machine-readable scalar
sink (one object a scalar: ``tag``, ``value``, ``step``, ``ts``), PNG files
under ``{log_dir}/img/`` the image sink (``.npy`` where pillow is missing),
and tensorboardX, where it imports, gets the same items from the same
queue. A write that fails, or a queue that does not drain, makes
``close()`` raise (ROADMAP C.9: the JAX package's writer prints the first
and ignores the second).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time

import numpy as np

# how long ``MetricsWriter.close()`` waits for the queue to drain
JOIN_TIMEOUT_S = 60.0


class MetricsWriter:
    """One writer thread drains a queue of scalars and images. A write
    that fails is counted and the drain goes on with the next item;
    ``close()`` writes what is queued, joins the thread and raises
    ``MetricsWriteError`` if any item was dropped or the thread has not
    ended within ``JOIN_TIMEOUT_S``. The file is closed only after the
    thread has ended."""

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
        # written by the drain thread only; read by close() after the join
        self.dropped = 0
        self.first_error: str | None = None
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
            except Exception as e:  # a bad item must not stop the sink
                # (disk full, unwritable img dir, TensorBoard failure): the
                # later items are still written, and close() reports this
                self.dropped += 1
                if self.first_error is None:
                    self.first_error = f"{kind} {tag!r}: {e!r}"

    def close(self):
        """Write what is queued and end the thread, then close the sinks.
        Raises ``MetricsWriteError`` if the thread has not ended within
        ``JOIN_TIMEOUT_S`` (the file is then left open under it) or if any
        item was dropped."""
        self._q.put(("stop", "", 0.0, 0))
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise MetricsWriteError(
                f"metrics writer under {self.log_dir}: the writer thread "
                f"did not end within {JOIN_TIMEOUT_S} s; "
                f"{self._q.qsize()} items still queued, {self.dropped} "
                f"dropped so far (first error: {self.first_error})")
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self.dropped:
            raise MetricsWriteError(
                f"metrics writer under {self.log_dir}: {self.dropped} items "
                f"dropped; first error: {self.first_error}")


class MetricsWriteError(RuntimeError):
    """A ``MetricsWriter`` lost items or did not finish."""
