"""A run's inputs from its seed, made on the device in a few large calls:
the model's initial state (by the configuration's published init rules,
read off the reference model) and the pool of uint8 frame batches. The
same seed gives the same state and frames on the same device type."""

from __future__ import annotations

import torch

from .reference.layers import Numerics, init_rule
from .reference.tsv4 import TSV4

_FRAMES = 0x5EED_F8A3  # offsets the frames' stream from the weights'
_RUN = 0x2C1B_3C6D  # and the run generator's


def _seed(seed: int, salt: int) -> int:
    return (seed + salt) % (1 << 63)


def run_generator(seed: int, device, rank: int = 0) -> torch.Generator:
    """The generator process ``rank``'s train step draws from
    (augmentation, shuffles)."""
    return torch.Generator(device=device).manual_seed(_seed(seed, _RUN + rank))


def make_state(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of the model, float32, keyed as the
    port's and the reference's state dicts: one uniform and one normal
    draw for all the random leaves together, then sliced and scaled."""
    with torch.device("meta"):
        model = TSV4(cfg, Numerics())
    modules = dict(model.named_modules())
    leaves = []
    for key, t in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        leaves.append((key, t.shape, init_rule(modules[owner], leaf,
                                               model.conv_init)))
    g = torch.Generator(device=device).manual_seed(_seed(seed, 0))
    n_uniform = sum(s.numel() for _, s, r in leaves if r[0] == "uniform")
    n_normal = sum(s.numel() for _, s, r in leaves if r[0] == "normal")
    uniform = torch.rand(n_uniform, generator=g, device=device)
    normal = torch.randn(n_normal, generator=g, device=device)
    state, at = {}, {"uniform": 0, "normal": 0}
    for key, shape, (kind, value) in leaves:
        if kind == "const":
            state[key] = torch.full(shape, value, device=device)
            continue
        n = shape.numel()
        src = uniform if kind == "uniform" else normal
        x = src[at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        state[key] = (x * 2 - 1) * value if kind == "uniform" else x * value
    return state


def make_frames(cfg: dict, batch: int, pool: int, seed: int, device,
                rank: int = 0) -> torch.Tensor:
    """Process ``rank``'s (pool, batch, views*T, H0, W0, 3) uint8 frames,
    one draw."""
    g = torch.Generator(device=device).manual_seed(
        _seed(seed, _FRAMES + rank))
    H0, W0 = cfg["frames_hw"]
    shape = (pool, batch, cfg["views"] * cfg["seq_len"], H0, W0, 3)
    return torch.randint(0, 256, shape, generator=g, device=device,
                         dtype=torch.uint8)
