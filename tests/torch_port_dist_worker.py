"""One rank of the port's multi-process tests on the CPU (gloo).

Run by ``tests/torch_port_util.py:launch_ranks`` as

    python tests/torch_port_dist_worker.py CASE RANK WORLD DIR

It joins the group through ``dualvar_tpu_torch.core.dist.init_distributed``
with torchrun's rank variables and a ``file://`` store in DIR, runs CASE on
the inputs the test wrote to ``DIR/inputs.pt``, and saves what the test
compares to ``DIR/out_RANK.pt``. It imports torch and the port only: the
test holds the results against JAX or a single process.
"""

import datetime
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)  # as tests/torch_port_util.py


def _local(t, rank, world):
    """This rank's rows of a global batch."""
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b]


def case_gather_grad(inp, rank, world):
    """The global NT-Xent over the rank's rows with the gathered columns;
    the gradient of the global loss (the mean over ranks of the local
    losses) with respect to the rank's rows."""
    from dualvar_tpu_torch.core import dist
    from dualvar_tpu_torch.models.ssl.losses import nt_xent_loss

    f = _local(inp["features"], rank, world).clone().requires_grad_(True)
    ret = nt_xent_loss(f, 0.07)
    (ret["clip_contrast_loss"] / world).backward()
    loss = dist.mean_over_ranks({"loss": ret["clip_contrast_loss"]})["loss"]
    arrays = dist.gather_concat(
        f.detach().numpy(), (f.detach().numpy() > 0), torch.tensor(
            [rank]).numpy())
    return {"grad": f.grad, "loss": loss, "logits": ret["clip_logits"],
            "gathered": arrays}


def _step(inp, rank, world, bn_stats):
    """One SimCLR-TSV4 step of the port on the rank's rows: losses,
    metrics, every gradient (averaged over the ranks), the new running
    statistics."""
    from dualvar_tpu_torch.core import dist
    from dualvar_tpu_torch.core.config import ModelConfig
    from dualvar_tpu_torch.train.pretrain import compute_metrics
    from dualvar_tpu_torch.train.tasks import make_task, total_loss

    os.environ["DUALVAR_BN_STATS"] = bn_stats
    task = make_task(ModelConfig(net="r3d", dtype="float32"))
    task.model.load_state_dict(inp["state"])
    task.model.train()
    task.model.backbone.double()
    dist.collectives.clear()
    ret = task.forward(_local(inp["block"], rank, world),
                       perm=_local(inp["perm"], rank, world))
    total_loss(ret).backward()
    dist.average_gradients(task.parameters())
    metrics = compute_metrics(ret)
    return {"ret": {k: v.detach() for k, v in ret.items()},
            "metrics": metrics,
            "grads": {k: p.grad for k, p in task.model.named_parameters()},
            "stats": {k: v for k, v in task.model.state_dict().items()
                      if "running_" in k},
            "collectives": dict(dist.collectives)}


def case_step(inp, rank, world):
    out = {bn: _step(inp, rank, world, bn) for bn in ("xla", "pallas")}
    out["moco"] = _moco(inp, rank, world)
    return out


def _moco(inp, rank, world):
    """A MoCo-TSV4 forward on the rank's rows: losses, metrics, the state
    after the enqueue."""
    import dataclasses

    from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
    from dualvar_tpu_torch.train.pretrain import compute_metrics
    from dualvar_tpu_torch.train.tasks import make_task

    os.environ["DUALVAR_BN_STATS"] = "xla"
    cfg = dataclasses.replace(
        PRETRAIN_PRESETS["paper_table2_moco_r21d"].model, net="r3d",
        dtype="float32", moco_k=inp["moco_k"], mode="clip-sr-tc")
    task = make_task(cfg)
    model = task.model
    model.load_state_dict(inp["moco_state"])
    model.train()
    model.encoder_q.backbone.double()
    model.encoder_k.backbone.double()
    ret = task.forward(_local(inp["moco_block"], rank, world),
                       perm=_local(inp["perm"], rank, world))
    return {"metrics": compute_metrics(ret),
            "state": {k: v for k, v in model.state_dict().items()
                      if k.startswith(("queue", "series_queue",
                                       "encoder_k."))}}


def case_shuffle_bn(inp, rank, world):
    """MoCo steps in the BN-shuffle mode on the rank's rows, one a
    configuration (naked or TimeSeriesV4, a number of groups), with the
    global batch permutation given: metrics (over the ranks), the query
    gradients (averaged over the ranks), the state after the step (queues,
    pointer, key encoder), the collectives of the step. Then the
    permutation as the ranks draw it from their own generators, and the
    refusal of a number of groups the ranks cannot share."""
    import dataclasses

    from dualvar_tpu_torch.core import dist
    from dualvar_tpu_torch.core.config import ModelConfig
    from dualvar_tpu_torch.models.ssl.moco import MoCo
    from dualvar_tpu_torch.train.pretrain import compute_metrics
    from dualvar_tpu_torch.train.tasks import make_task, total_loss

    os.environ["DUALVAR_BN_STATS"] = "xla"
    out = {}
    for name, case in inp["cases"].items():
        cfg = ModelConfig(net="r3d", model=case["model"], dtype="float32",
                          moco_k=inp["moco_k"], moco_m=inp["moco_m"],
                          mode="clip-sr-tc", moco_shuffle_bn=case["groups"])
        task = make_task(cfg)
        model = task.model
        model.load_state_dict(case["state"])
        model.train()
        model.encoder_q.backbone.double()
        model.encoder_k.backbone.double()
        dist.collectives.clear()
        perm = None if case["perm"] is None else _local(case["perm"], rank,
                                                        world)
        ret = task.forward(_local(case["block"], rank, world), perm=perm,
                           bn_perm=case["bn_perm"])
        total_loss(ret).backward()
        dist.average_gradients(task.parameters())
        collectives = dict(dist.collectives)
        out[name] = {
            "metrics": compute_metrics(ret),
            "grads": {k: p.grad for k, p in
                      model.encoder_q.named_parameters()},
            "state": {k: v for k, v in model.state_dict().items()
                      if k.startswith(("queue", "series_queue",
                                       "encoder_k."))},
            "collectives": collectives}
    x2 = torch.zeros(inp["rows"], 1)
    gen = torch.Generator().manual_seed(inp["seed"] + rank)
    out["drawn_bn_perm"] = MoCo.draw_bn_perm(x2, gen)
    bad = make_task(dataclasses.replace(
        ModelConfig(net="r3d", model="moco_naked", dtype="float32",
                    moco_k=inp["moco_k"]), moco_shuffle_bn=3))
    bad.model.train()
    try:
        bad.forward(_local(inp["cases"]["naked_g2"]["block"], rank, world)
                    .float(), generator=torch.Generator().manual_seed(rank))
    except ValueError as e:
        out["refused"] = str(e)
    return out


def case_protocols(inp, rank, world):
    from dualvar_tpu_torch.train import classifier as TC

    cfg = inp["cfg"]
    return {"ten": TC.test_multicrop(cfg, "ten", device="cpu"),
            "temporal": TC.test_temporal_tenclip(cfg, device="cpu"),
            "retrieval": TC.test_retrieval(cfg, device="cpu")}


def case_resume(inp, rank, world):
    """The same 2-process run straight through, and stopped after its first
    epoch then resumed: each run's last step's metrics and the checkpoint
    it ends with."""
    import dataclasses

    from dualvar_tpu_torch.core.checkpoint import CheckpointStore
    from dualvar_tpu_torch.train import pretrain as TP

    out = {}
    for name, runs in (("straight", ((inp["steps"] + 1, ""),)),
                       ("resumed", ((inp["steps"], ""),
                                    (inp["steps"] + 1, "auto")))):
        for max_steps, resume in runs:
            cfg = inp["cfg"]
            cfg = cfg.replace(run=dataclasses.replace(
                cfg.run, log_root=os.path.join(cfg.run.log_root, name),
                resume=resume))
            metrics = TP.train(cfg, max_steps=max_steps, device="cpu")
        out[name] = {"metrics": metrics}
        if rank == 0:  # the writer; its store is closed, every file written
            store = CheckpointStore(os.path.join(TP.set_path(cfg), "model"))
            out[name].update(epoch=store.latest_epoch(),
                             ckpt=store.restore())
    return out


def main():
    case, rank, world, directory = sys.argv[1], *map(int, sys.argv[2:4]), \
        sys.argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from dualvar_tpu_torch.core import dist

    assert dist.init_distributed(
        "cpu", init_method="file://" + os.path.join(directory, "store"),
        timeout=datetime.timedelta(seconds=60))
    inp = torch.load(os.path.join(directory, "inputs.pt"),
                     weights_only=False)
    out = globals()["case_" + case](inp, rank, world)
    torch.save(out, os.path.join(directory, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy()


if __name__ == "__main__":
    main()
