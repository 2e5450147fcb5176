"""Faults planted in the program's train step, for the check's controls
(``calibrate.py`` and the tests; a benchmark run plants none):

* ``half_batch``: the step sees the first half of its batch and takes the
  mean over it;
* ``unchanged``: the step returns the model and the optimizer as they were;
* ``no_exchange``: the gradient is not averaged over the processes.
"""

from __future__ import annotations

import contextlib


def _half_batch(make):
    def broken(*a, **kw):
        step = make(*a, **kw)
        return lambda frames, gen: step(frames[:frames.shape[0] // 2], gen)
    return broken


def _unchanged(make):
    def broken(task, optimizer, *a, **kw):
        step = make(task, optimizer, *a, **kw)

        def run(frames, gen):
            keep = {k: v.clone() for k, v in task.model.state_dict().items()}
            out = step(frames, gen)
            task.model.load_state_dict(keep)
            optimizer.state.clear()
            return out
        return run
    return broken


STEP_FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged}
NAMES = (*STEP_FAULTS, "no_exchange")


@contextlib.contextmanager
def planted(name: str | None):
    """The program with the fault ``name`` planted (None: as it is)."""
    if name is None:
        yield
        return
    from dualvar_tpu_torch.core import dist
    from dualvar_tpu_torch.train import pretrain

    if name == "no_exchange":
        module, attr, new = dist, "average_gradients", lambda params: None
    else:
        module, attr = pretrain, "make_train_step"
        new = STEP_FAULTS[name](pretrain.make_train_step)
    old = getattr(module, attr)
    setattr(module, attr, new)
    try:
        yield
    finally:
        setattr(module, attr, old)
