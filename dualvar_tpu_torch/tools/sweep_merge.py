"""The land-as-measured merge of the benches' records. Counterpart of the
JAX package's ``scripts/_sweep_merge.py``, with its policy, keyed by name:

* an error record never clobbers a measured row, but is kept on the row as
  ``last_error`` (a recurring failure at the recorded configuration leaves
  a trace);
* a re-measurement at the same batch as the recorded row replaces the row
  (the latest measurement wins, so a slower step revises the row down
  instead of hiding under a maximum over runs);
* a re-measurement at another batch that is slower per clip lands as an
  ``also_measured`` annotation on the row;
* a faster one at another batch becomes the row and carries the previous
  row along as an annotation (one per batch, the latest kept);
* every measured row and annotation carries ``measured_at`` (UTC);
* rows without ``clips_per_sec`` are overwritten (an error replaced by a
  success); a file that does not parse is started afresh.

Each record is merged into the file the moment it exists, so a sweep cut
short keeps what it measured.
"""

import datetime
import json
import os

from .timing import log

_ANNOT_KEYS = ("batch", "ms_per_step", "clips_per_sec", "mfu_pct",
               "videos_per_sec_10clip", "measured_at")


def _now() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def parse_batches(spec: str) -> tuple:
    """The batch part of a ``net:batch`` argument: one int or a
    comma-separated list (``s3d:256,128``); SystemExit with a usage message
    on anything else."""
    try:
        batches = tuple(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        raise SystemExit(
            f"bad batch spec {spec!r}: expected 'net:B' or 'net:B1,B2' "
            f"with integer batches (e.g. s3d:256 or s3d:256,128)")
    if not batches or any(b <= 0 for b in batches):
        raise SystemExit(f"bad batch spec {spec!r}: batches must be "
                         f"positive integers")
    return batches


def _annot(rec: dict) -> dict:
    return {k: rec[k] for k in _ANNOT_KEYS if k in rec}


def _dedup_by_batch(annots: list) -> list:
    """The last annotation of each batch (later entries are newer)."""
    by_batch = {}
    for a in annots:
        by_batch[a.get("batch")] = a
    return list(by_batch.values())


def _write(path: str, doc: dict) -> None:
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def merge_result(path: str, rec: dict, fresh_doc: dict, order: list,
                 key: str = "net"):
    """Merge ``rec`` into the document at ``path`` (``fresh_doc`` where
    there is none), rows sorted by ``order`` of their ``key``."""
    doc = fresh_doc
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (json.JSONDecodeError, OSError):
            pass

    if not rec.get("error"):
        rec.setdefault("measured_at", _now())

    prev = next((r for r in doc.get("results", [])
                 if r.get(key) == rec.get(key)), None)
    if prev is not None and prev.get("clips_per_sec"):
        if rec.get("error"):
            prev["last_error"] = {"error": rec["error"],
                                  "batch": rec.get("batch"), "ts": _now()}
            log(f"  merge: keeping measured {rec[key]} row (new attempt "
                f"errored; recorded as last_error)")
            _write(path, doc)
            return
        same_batch = rec.get("batch") == prev.get("batch")
        if not same_batch and rec.get("clips_per_sec", 0) \
                < prev["clips_per_sec"]:
            also = prev.setdefault("also_measured", [])
            also[:] = _dedup_by_batch(
                [a for a in also if a.get("batch") != rec.get("batch")]
                + [_annot(rec)])
            log(f"  merge: {rec[key]} B={rec.get('batch')} slower per clip "
                f"than recorded B={prev.get('batch')}; kept as annotation")
            _write(path, doc)
            return
        if same_batch:
            # the latest measurement at the recorded configuration wins;
            # annotations at other batches are carried through
            if prev.get("also_measured"):
                rec.setdefault("also_measured", prev["also_measured"])
            if rec.get("clips_per_sec", 0) < prev["clips_per_sec"]:
                log(f"  merge: {rec[key]} B={rec.get('batch')} re-measured "
                    f"slower ({rec.get('clips_per_sec')} vs "
                    f"{prev['clips_per_sec']} clips/s); row revised")
        else:
            carried = prev.get("also_measured", []) + [_annot(prev)]
            rec["also_measured"] = _dedup_by_batch(
                [a for a in carried if a.get("batch") != rec.get("batch")]
                + rec.get("also_measured", []))

    doc["results"] = ([r for r in doc.get("results", [])
                       if r.get(key) != rec.get(key)] + [rec])
    doc["results"].sort(key=lambda r: order.index(r[key])
                        if r.get(key) in order else 99)
    _write(path, doc)


def sweep(names, bench, path: str, fresh_doc: dict, order: list,
          key: str = "net") -> list:
    """``bench(name)`` for each of ``names``, each record merged into
    ``path`` the moment it exists; returns the records."""
    out = []
    for name in names:
        rec = bench(name)
        out.append(rec)
        merge_result(path, rec, {**fresh_doc, "results": []}, order, key)
    return out
