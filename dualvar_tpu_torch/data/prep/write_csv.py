"""Offline CSV index writer: frame dirs -> (path, num_frames) split CSVs
(reference process_data/src/write_csv.py:12-110).

Own copy of ``dualvar_tpu/data/prep/write_csv.py``: the same files from the
same frame tree. Runs on the host only.

Counts ``*.jpg`` per frame directory for each official split list and writes
``{mode}_split%02d.csv`` rows of ``frame_dir_path,num_frames``. The path
column must keep class and video name as its last two directory components
(``.../{class}/{video}/``) — the loaders parse them back out
(dualvar_tpu_torch.data.indices.load_split).

Usage:
    python -m dualvar_tpu_torch.data.prep.write_csv ucf101 \
        --frame_root /data/UCF101/frame --split_root process_data/data/ucf101 \
        --out_root process_data/data/ucf101
"""

from __future__ import annotations

import argparse
import csv
import glob
import os


def count_frames(frame_dir: str) -> int:
    return len(glob.glob(os.path.join(frame_dir, "*.jpg")))


def write_split(
    frame_root: str, rel_video_dirs: list[str], out_csv: str
) -> int:
    rows = []
    for rel in rel_video_dirs:
        d = os.path.join(frame_root, rel)
        n = count_frames(d)
        if n == 0:
            continue
        rows.append((d.rstrip("/") + "/", n))
    with open(out_csv, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return len(rows)


def ucf101_split_videos(split_root: str, which: int, mode: str) -> list[str]:
    """Official UCF101 trainlist/testlist files: 'class/video.avi [label]'."""
    name = f"{'trainlist' if mode == 'train' else 'testlist'}{which:02d}.txt"
    with open(os.path.join(split_root, name)) as f:
        lines = [ln.strip().split(" ")[0] for ln in f if ln.strip()]
    return [os.path.splitext(ln)[0] for ln in lines]


def hmdb51_split_videos(split_root: str, which: int, mode: str) -> list[str]:
    """HMDB51 per-class ``*_test_split{which}.txt``: 'video.avi tag' with tag
    1=train, 2=test (reference write_csv.py:34-74)."""
    tag = "1" if mode == "train" else "2"
    out = []
    for path in sorted(glob.glob(os.path.join(split_root, f"*_test_split{which}.txt"))):
        cls = os.path.basename(path).replace(f"_test_split{which}.txt", "")
        with open(path) as f:
            for ln in f:
                parts = ln.strip().split(" ")
                if len(parts) >= 2 and parts[1] == tag:
                    out.append(os.path.join(cls, os.path.splitext(parts[0])[0]))
    return out


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["ucf101", "hmdb51", "k400"])
    p.add_argument("--frame_root", required=True)
    p.add_argument("--split_root", default="",
                   help="dir of official split lists (unused for k400)")
    p.add_argument("--out_root", required=True)
    p.add_argument("--which_split", type=int, default=0, help="0 = all three")
    args = p.parse_args(argv)

    splits = [args.which_split] if args.which_split else [1, 2, 3]
    os.makedirs(args.out_root, exist_ok=True)
    for which in splits:
        for mode in ("train", "test"):
            if args.dataset == "ucf101":
                vids = ucf101_split_videos(args.split_root, which, mode)
            elif args.dataset == "hmdb51":
                vids = hmdb51_split_videos(args.split_root, which, mode)
            else:  # k400: frame dirs are the split (train/ and val/ roots)
                root = os.path.join(args.frame_root, "train" if mode == "train" else "val")
                vids = [
                    os.path.relpath(d, args.frame_root)
                    for d in sorted(glob.glob(os.path.join(root, "*/*")))
                ]
            out_csv = os.path.join(args.out_root, f"{mode}_split{which:02d}.csv")
            n = write_split(args.frame_root, vids, out_csv)
            print(f"{out_csv}: {n} rows")


if __name__ == "__main__":
    main()
