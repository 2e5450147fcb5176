"""One process of a run on several processes: ``cell.run_process`` for the
rank that the launch variables name, its part written with ``torch.save``
to the path given. Started by ``cell.run``, never by hand."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(job_path: str, out_path: str) -> int:
    import torch

    from benchmark import cell, faults, spec

    with open(job_path) as fh:
        job = json.load(fh)
    c = spec.Cell(**job["cell"])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    with faults.planted(job["fault"]):
        part = cell.run_process(c, job["seed"], job["seconds"], job["trace"],
                                job["t_start"], device, rank, world)
    torch.save(part, out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
