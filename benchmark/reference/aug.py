"""The pretrain augmentation in plain float32 PyTorch: the draws and the
arithmetic, written down once for the benchmark.

What the SimCLR-TSV4 train step does to a uint8 batch (B, 3*T, H0, W0, 3)
before the model sees it (the DualVar reference's pretrain pipeline with
clip-consistent jitter): per clip a crop origin, a 0.8 gate on view 0's
whole pipeline, colour jitter gated 0.8 x 0.8 with factors brightness,
contrast and saturation in [0.2, 1.8] and hue in [-0.2, 0.2] applied in a
random order, a Gaussian blur (13 taps, edge replicated) with probability
0.5 and sigma in [0.1, 2], then ImageNet normalisation.

The draws are taken from a ``torch.Generator`` in a fixed sequence of calls
(``draw_clip_params``), then the segment permutation of the shuffled clip
(``segment_perms``). A generator seeded alike and called alike gives the
same numbers on the same device type, which is how the reference finds the
decisions of the run it checks without reading them from the program.

``plane_dtype=torch.bfloat16`` rounds the planes to bfloat16 after every
op: the precision control of the comparison, never the reference itself.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_W = (0.2989, 0.587, 0.114)
JITTER_RANGES = ((0.2, 1.8), (0.2, 1.8), (0.2, 1.8), (-0.2, 0.2))
BLUR_TAPS = 13


def _rand(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(*shape, generator=g, device=g.device)


def draw_clip_params(g: torch.Generator, B: int, V: int, H0: int, W0: int,
                     d: int):
    """Every clip's decisions, (B, V, ...): crops (y0, x0), op orders,
    jitter factors (identity where not applied), blur (sigma, on)."""
    y0 = torch.randint(0, H0 - d + 1, (B, V), generator=g, device=g.device)
    x0 = torch.randint(0, W0 - d + 1, (B, V), generator=g, device=g.device)
    use_aug = torch.ones(B, V, dtype=torch.bool, device=g.device)
    use_aug[:, 0] = _rand(g, B) < 0.8
    jitter_on = use_aug & (_rand(g, B, V) < 0.8)
    apply = jitter_on & (_rand(g, B, V) < 0.8)
    drawn = []
    for lo, hi in JITTER_RANGES:
        u = _rand(g, B, V, 1)
        drawn.append((u * (hi - lo) + lo).clamp_min(lo)[..., 0])
    drawn = torch.stack(drawn, dim=-1)  # (B, V, 4)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=g.device)
    factors = torch.where(apply[..., None], drawn, ident)
    orders = _rand(g, B, V, 4).argsort(dim=-1)
    blur_on = use_aug & (_rand(g, B, V) < 0.5)
    sigma = 0.1 + 1.9 * _rand(g, B, V)
    return (torch.stack([y0, x0], dim=-1), orders, factors,
            torch.stack([sigma, blur_on.float()], dim=-1))


def segment_perms(g: torch.Generator, B: int, n_series: int) -> torch.Tensor:
    """Each sample's order of its shuffled clip's segments, (B, n_series)."""
    return _rand(g, B, n_series).argsort(dim=1)


def _gray(x):
    return (x[..., 0:1] * GRAY_W[0] + x[..., 1:2] * GRAY_W[1]
            + x[..., 2:3] * GRAY_W[2])


def _blend(a, b, f):
    return (a * f + b * (1.0 - f)).clamp(0.0, 1.0)


def _brightness(x, f):
    return _blend(x, torch.zeros_like(x), f)


def _contrast(x, f):
    return _blend(x, _gray(x).mean(dim=(-3, -2), keepdim=True), f)


def _saturation(x, f):
    return _blend(x, _gray(x), f)


def _hue(x, f):
    """Rotate the hue by f (HSV as torchvision computes it)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = x.max(dim=-1).values, x.min(dim=-1).values
    eqc = maxc == minc
    cr = maxc - minc
    one = torch.ones_like(maxc)
    s = cr / torch.where(eqc, one, maxc)
    crd = torch.where(eqc, one, cr)
    rc, gc, bc = (maxc - r) / crd, (maxc - g) / crd, (maxc - b) / crd
    zero = torch.zeros_like(maxc)
    h = (torch.where(maxc == r, bc - gc, zero)
         + torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
         + torch.where((maxc != g) & (maxc != r), 4.0 + gc - rc, zero))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    h = torch.remainder(h + f[..., 0], 1.0)
    h6, vs = h * 6.0, maxc * s

    def chan(n):
        k = torch.remainder(n + h6, 6.0)
        return maxc - vs * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


_OPS = (_brightness, _contrast, _saturation, _hue)


def _blur(x, sigma, on):
    """Separable Gaussian, W pass then H pass, edges replicated; x (N, T,
    S, S, 3), sigma and on (N,)."""
    r = BLUR_TAPS // 2
    taps = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (taps / sigma.clamp_min(1e-6)[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)  # (N, taps)

    def one_pass(src, axis):
        n = src.shape[axis]
        pos = torch.arange(n, device=src.device)
        acc = torch.zeros_like(src)
        for j in range(BLUR_TAPS):
            idx = (pos - r + j).clamp(0, n - 1)
            acc = acc + k[:, j].reshape(-1, 1, 1, 1, 1) * src.index_select(
                axis, idx)
        return acc

    out = one_pass(one_pass(x, 3), 2)
    return torch.where(on.reshape(-1, 1, 1, 1, 1), out, x)


def augment(frames_u8: torch.Tensor, params, T: int, d: int,
            plane_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, V*T, H0, W0, 3) uint8 with ``draw_clip_params``' decisions ->
    (B, V, T, d, d, 3) float32, normalised."""
    crops, orders, factors, blurs = params
    B, VT, H0, W0, C = frames_u8.shape
    V = VT // T
    N = B * V
    clips = frames_u8.reshape(N, T, H0, W0, C)
    crops = crops.reshape(N, 2)
    span = torch.arange(d, device=frames_u8.device)
    n = torch.arange(N, device=frames_u8.device).reshape(N, 1, 1, 1)
    t = torch.arange(T, device=frames_u8.device).reshape(1, T, 1, 1)
    y = (crops[:, 0, None] + span).reshape(N, 1, d, 1)
    xx = (crops[:, 1, None] + span).reshape(N, 1, 1, d)

    def rnd(v):
        return v.to(plane_dtype).float()

    x = rnd(clips[n, t, y, xx].float() / 255.0)  # (N, T, d, d, 3)
    orders = orders.reshape(N, 4)
    factors = factors.reshape(N, 4)
    for slot in range(4):
        for op in range(4):
            sel = orders[:, slot] == op
            if bool(sel.any()):
                f = factors[sel, op].reshape(-1, 1, 1, 1, 1)
                x[sel] = rnd(_OPS[op](x[sel], f))
    blurs = blurs.reshape(N, 2)
    x = rnd(_blur(x, blurs[:, 0], blurs[:, 1] > 0))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = rnd((x - mean) / std)
    return x.reshape(B, V, T, d, d, C)
