"""Offline video -> JPEG frame extraction (reference
process_data/src/extract_frame.py:12-118).

OpenCV decode, short-side resize (240 for UCF101/HMDB51, 150 or 256 for
Kinetics-400), JPEG quality 80, joblib parallel over videos. Runs on the CPU
host; never on the training hot path.

Own copy of ``dualvar_tpu/data/prep/extract_frames.py``: the same frames from
the same videos. OpenCV and joblib are imported where present; without them
the CLI exits with a message.

Usage:
    python -m dualvar_tpu_torch.data.prep.extract_frames ucf101 \
        --video_root /data/UCF101/videos --out_root /data/UCF101/frame
"""

from __future__ import annotations

import argparse
import glob
import os

try:
    import cv2
    from joblib import Parallel, delayed
except ImportError:  # pragma: no cover
    cv2 = None


def resize_dim(w: int, h: int, target: int) -> tuple[int, int]:
    """Scale the short side to ``target`` (reference extract_frame.py:44-49)."""
    if w >= h:
        return int(target * w / h), target
    return target, int(target * h / w)


def extract_video(v_path: str, out_root: str, dim: int = 240, quality: int = 80) -> int:
    """Decode one video to ``{out_root}/{video_name}/image_%05d.jpg``
    (reference extract_frame.py:12-41)."""
    name = os.path.splitext(os.path.basename(v_path))[0]
    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(v_path)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    nw, nh = resize_dim(w, h, dim)
    count = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        count += 1
        frame = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(
            os.path.join(out_dir, f"image_{count:05d}.jpg"),
            frame,
            [cv2.IMWRITE_JPEG_QUALITY, quality],
        )
    cap.release()
    return count


def extract_dataset(
    video_root: str,
    out_root: str,
    pattern: str = "*/*.avi",
    dim: int = 240,
    n_jobs: int = 32,
):
    """Parallel extraction over a glob of videos, preserving the class
    subdirectory (reference main_UCF101, extract_frame.py:52-62)."""
    videos = sorted(glob.glob(os.path.join(video_root, pattern)))

    def one(v):
        cls = os.path.basename(os.path.dirname(v))
        return extract_video(v, os.path.join(out_root, cls), dim=dim)

    return Parallel(n_jobs=n_jobs)(delayed(one)(v) for v in videos)


DATASET_DIMS = {"ucf101": 240, "hmdb51": 240, "k400": 256}
DATASET_PATTERNS = {"ucf101": "*/*.avi", "hmdb51": "*/*.avi", "k400": "*/*.mp4"}


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=sorted(DATASET_DIMS))
    p.add_argument("--video_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--dim", type=int, default=0)
    p.add_argument("--jobs", type=int, default=32)
    args = p.parse_args(argv)
    if cv2 is None:
        raise SystemExit("opencv-python is required for frame extraction")
    dim = args.dim or DATASET_DIMS[args.dataset]
    counts = extract_dataset(
        args.video_root, args.out_root, DATASET_PATTERNS[args.dataset],
        dim=dim, n_jobs=args.jobs,
    )
    print(f"extracted {len(counts)} videos, {sum(counts)} frames")


if __name__ == "__main__":
    main()
