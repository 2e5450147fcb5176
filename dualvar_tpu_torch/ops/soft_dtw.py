"""Differentiable soft-DTW: wrappers, plain version and launch counters.

Replaces the Pallas kernels ``dualvar_tpu/ops/soft_dtw.py:_fwd_kernel`` and
``:_bwd_kernel`` with the hand-written CUDA kernels of ``csrc/soft_dtw.cu``
(one thread a pair, rows in registers, instantiated for the column bucket
that ``_column_bucket`` chooses; see the source for the design). Same
contract as the JAX ``soft_dtw``: for a batch of cost matrices
``D (P, N, M)`` the soft minimum over monotone alignment paths,

    R[i,j] = D[i-1,j-1] + softmin_gamma(R[i-1,j-1], R[i-1,j], R[i,j-1]),

returning ``R[N, M]`` as ``(P,)``, differentiable in ``D`` through the
E-matrix recurrence, with optional Sakoe-Chiba ``bandwidth`` pruning (cells
with ``|i - j| > bandwidth > 0`` keep +inf in R and 0 in E; 0 = no band).

Layout read and written by the kernels: ``D``, ``R`` and ``dD`` are
``(P, N, M)`` float32, row major, contiguous. ``R`` holds the interior cells
only (``R[p, i-1, j-1]`` is the recurrence's ``R[i,j]``): the border is
constant and never stored. N, M <= 16 on the card.

Bound: bytes. A pair moves ``4*N*M`` bytes in and ``4*N*M + 4`` out in the
forward, ``8*N*M + 4`` in and ``4*N*M`` out in the backward, against 3 exp +
1 log (forward) or 3 exp (backward) a cell on the special-function units.

``soft_dtw_forward`` and ``soft_dtw_backward`` launch their kernel for CUDA
tensors (or raise) and take the plain recurrences only for CPU tensors; each
counts its kernel launches in ``.launches``. ``soft_dtw`` is the
differentiable function built on the two; ``soft_dtw_plain`` is the same
function on the plain recurrences on any device, which the tests and the
on-card comparison hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

_MAX_LEN = 16  # kMaxLen of csrc/soft_dtw.cu
_BUCKETS = (2, 4, 8, 16)  # the kernels' instantiations, by columns
_INF = float("inf")


def similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """D[b,i,j] = <x[b,i], y[b,j]> (reference soft_dtw_cuda.py:321-331)."""
    return torch.einsum("bid,bjd->bij", x, y)


def euclidean_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """D[b,i,j] = ||x[b,i] - y[b,j]||^2 (reference soft_dtw_cuda.py:309-319)."""
    return (x[:, :, None, :] - y[:, None, :, :]).square().sum(dim=-1)


# --------------------------------------------------------------------------
# plain PyTorch recurrences (counterpart of _softdtw_R_xla / _softdtw_E_xla)
# --------------------------------------------------------------------------

def _softmin3(a, b, c, gamma: float) -> torch.Tensor:
    """-gamma * log(sum exp(-r/gamma)) over three values, inf-safe: all three
    +inf give +inf, never NaN."""
    r = torch.stack([-a / gamma, -b / gamma, -c / gamma])
    rmax = r.max(dim=0).values
    safe = torch.where(torch.isfinite(rmax), rmax, torch.zeros_like(rmax))
    ex = torch.exp(r - safe).sum(dim=0)
    return torch.where(ex > 0, -gamma * (torch.log(ex) + safe),
                       torch.full_like(ex, _INF))


def _diagonal(p: int, N: int, M: int, bandwidth: float, device):
    """1-indexed (i, j) of the in-band cells with i + j == p, as two int64
    tensors (empty when the band leaves none)."""
    cells = [(i, p - i) for i in range(max(1, p - M), min(N, p - 1) + 1)
             if not (bandwidth > 0 and abs(2 * i - p) > bandwidth)]
    i = torch.tensor([c[0] for c in cells], dtype=torch.long, device=device)
    j = torch.tensor([c[1] for c in cells], dtype=torch.long, device=device)
    return i, j


def _softdtw_R_plain(D: torch.Tensor, gamma: float,
                     bandwidth: float) -> torch.Tensor:
    """Interior of the R matrix, (P, N, M), by anti-diagonals."""
    P, N, M = D.shape
    R = torch.full((P, N + 2, M + 2), _INF, dtype=D.dtype, device=D.device)
    R[:, 0, 0] = 0.0
    for p in range(2, N + M + 1):
        i, j = _diagonal(p, N, M, bandwidth, D.device)
        if i.numel():
            R[:, i, j] = D[:, i - 1, j - 1] + _softmin3(
                R[:, i - 1, j - 1], R[:, i - 1, j], R[:, i, j - 1], gamma)
    return R[:, 1:N + 1, 1:M + 1].contiguous()


def _softdtw_E_plain(D: torch.Tensor, R: torch.Tensor, gamma: float,
                     bandwidth: float) -> torch.Tensor:
    """E matrix, (P, N, M) = d(value)/d(D), from D and the interior of R, by
    reversed anti-diagonals."""
    P, N, M = D.shape
    Dp = torch.zeros((P, N + 2, M + 2), dtype=D.dtype, device=D.device)
    Dp[:, 1:N + 1, 1:M + 1] = D
    # +inf in R becomes -inf, row N+1 and column M+1 are -inf, the corner
    # holds R[N, M] (reference backward :100-101)
    Rp = torch.full((P, N + 2, M + 2), -_INF, dtype=D.dtype, device=D.device)
    Rp[:, 1:N + 1, 1:M + 1] = torch.where(
        torch.isinf(R), torch.full_like(R, -_INF), R)
    Rp[:, N + 1, M + 1] = Rp[:, N, M]
    E = torch.zeros((P, N + 2, M + 2), dtype=D.dtype, device=D.device)
    E[:, N + 1, M + 1] = 1.0
    inv_g = 1.0 / gamma
    for p in range(N + M, 1, -1):
        # only in-band cells are visited: an out-of-band cell has Rp = -inf
        # and -inf - (-inf) would be NaN
        i, j = _diagonal(p, N, M, bandwidth, D.device)
        if not i.numel():
            continue
        rin = Rp[:, i, j]
        a = torch.exp((Rp[:, i + 1, j] - rin - Dp[:, i + 1, j]) * inv_g)
        b = torch.exp((Rp[:, i, j + 1] - rin - Dp[:, i, j + 1]) * inv_g)
        c = torch.exp((Rp[:, i + 1, j + 1] - rin - Dp[:, i + 1, j + 1])
                      * inv_g)
        E[:, i, j] = (E[:, i + 1, j] * a + E[:, i, j + 1] * b
                      + E[:, i + 1, j + 1] * c)
    return E[:, 1:N + 1, 1:M + 1].contiguous()


def _forward_plain(D, gamma, bandwidth):
    R = _softdtw_R_plain(D, gamma, bandwidth)
    return R[:, -1, -1].clone(), R


def _backward_plain(D, R, g, gamma, bandwidth):
    return _softdtw_E_plain(D, R, gamma, bandwidth) * g[:, None, None]


# --------------------------------------------------------------------------
# the two kernel wrappers
# --------------------------------------------------------------------------

def _check(D: torch.Tensor, gamma: float, **others: torch.Tensor) -> None:
    if D.dim() != 3 or D.shape[1] < 1 or D.shape[2] < 1:
        raise ValueError(f"D must be (P, N, M) with N, M >= 1, got "
                         f"{tuple(D.shape)}")
    if not gamma > 0:
        raise ValueError(f"gamma must be positive, got {gamma}")
    allowed = (torch.float32,) if D.is_cuda else (torch.float32,
                                                  torch.float64)
    if D.dtype not in allowed:
        raise TypeError(
            f"D must be float32 on the card (float32 or float64 on the CPU), "
            f"got {D.dtype} on {D.device}; build D with autocast off")
    if D.is_cuda and max(D.shape[1:]) > _MAX_LEN:
        raise ValueError(
            f"sequence lengths {tuple(D.shape[1:])} exceed the kernels' "
            f"supported size {_MAX_LEN}")
    for name, t in others.items():
        if t.dtype != D.dtype or t.device != D.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, D is "
                            f"{D.dtype} on {D.device}")
    for name, t in (("D", D), *others.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _column_bucket(M: int) -> int:
    """The kernels' instantiation for rows of M columns: the smallest of
    2, 4, 8, 16 that holds M. The C entry points run the bucket they are
    given; they only refuse one that does not hold M."""
    if not 1 <= M <= _MAX_LEN:
        raise ValueError(f"no soft-DTW kernel takes {M} columns "
                         f"(1 to {_MAX_LEN})")
    return next(b for b in _BUCKETS if b >= M)


@functools.lru_cache(maxsize=None)
def _kernel(name: str, n_pointers: int):
    """The library's launch function ``name`` (``n_pointers`` device pointers,
    then P, N, M, gamma, bandwidth, the column bucket, stream), with its C
    signature declared."""
    fn = getattr(load_library("soft_dtw"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(name: str, tensors: tuple, shape, gamma: float,
            bandwidth: float) -> None:
    """Launch on the current stream of the tensors' device; no
    synchronisation. Raises if the launch was refused."""
    with torch.cuda.device(tensors[0].device):
        err = _kernel(name, len(tensors))(
            *(t.data_ptr() for t in tensors), *shape, float(gamma),
            float(bandwidth), _column_bucket(shape[2]),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def soft_dtw_forward(D: torch.Tensor, gamma: float = 1.0,
                     bandwidth: float = 0.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """D (P, N, M) -> (values (P,), R (P, N, M) interior cells). CUDA tensors
    go through the forward kernel, CPU tensors through the plain recurrence.
    No gradient is recorded; ``soft_dtw`` is the differentiable function."""
    _check(D, gamma)
    if not D.is_cuda:
        return _forward_plain(D, gamma, bandwidth)
    R = torch.empty_like(D)
    values = torch.empty(D.shape[0], dtype=D.dtype, device=D.device)
    if D.shape[0] == 0:
        return values, R
    _launch("soft_dtw_fwd_launch", (D, R, values), D.shape, gamma, bandwidth)
    soft_dtw_forward.launches += 1
    return values, R


def soft_dtw_backward(D: torch.Tensor, R: torch.Tensor, g: torch.Tensor,
                      gamma: float = 1.0,
                      bandwidth: float = 0.0) -> torch.Tensor:
    """dD (P, N, M) = E * g from D, the interior of R as ``soft_dtw_forward``
    returned it, and the incoming gradient g (P,). CUDA tensors go through
    the backward kernel, CPU tensors through the plain recurrence."""
    _check(D, gamma, R=R, g=g)
    if R.shape != D.shape or g.shape != D.shape[:1]:
        raise ValueError(f"R {tuple(R.shape)} / g {tuple(g.shape)} do not "
                         f"match D {tuple(D.shape)}")
    if not D.is_cuda:
        return _backward_plain(D, R, g, gamma, bandwidth)
    dD = torch.empty_like(D)
    if D.shape[0] == 0:
        return dD
    _launch("soft_dtw_bwd_launch", (D, R, g, dD), D.shape, gamma, bandwidth)
    soft_dtw_backward.launches += 1
    return dD


soft_dtw_forward.launches = 0
soft_dtw_backward.launches = 0


# --------------------------------------------------------------------------
# the differentiable function
# --------------------------------------------------------------------------

class _SoftDTW(torch.autograd.Function):
    """values = soft-DTW(D); saves D and the interior of R for the backward.
    ``plain`` takes the plain recurrences whatever the device."""

    @staticmethod
    def forward(ctx, D, gamma, bandwidth, plain):
        D = D.contiguous()
        if plain:
            _check(D, gamma)
            values, R = _forward_plain(D, gamma, bandwidth)
        else:
            values, R = soft_dtw_forward(D, gamma, bandwidth)
        ctx.save_for_backward(D, R)
        ctx.args = (gamma, bandwidth, plain)
        return values

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        D, R = ctx.saved_tensors
        gamma, bandwidth, plain = ctx.args
        g = g.contiguous()  # sum() hands over an expanded gradient
        backward = _backward_plain if plain else soft_dtw_backward
        return backward(D, R, g, gamma, bandwidth), None, None, None


def soft_dtw(D: torch.Tensor, gamma: float = 1.0,
             bandwidth: float = 0.0) -> torch.Tensor:
    """Soft-DTW values (P,) for cost matrices D (P, N, M), differentiable in
    D (reference SoftDTW module :273-343). On a CUDA tensor both passes are
    the hand-written kernels; on a CPU tensor the plain recurrences."""
    return _SoftDTW.apply(D, gamma, bandwidth, False)


def soft_dtw_plain(D: torch.Tensor, gamma: float = 1.0,
                   bandwidth: float = 0.0) -> torch.Tensor:
    """The same function on the plain PyTorch recurrences, on any device."""
    return _SoftDTW.apply(D, gamma, bandwidth, True)


def soft_dtw_sequences(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0,
                       dist: str = "similarity") -> torch.Tensor:
    """Soft-DTW between sequence batches x (B, N, d), y (B, M, d).
    ``dist='similarity'`` uses the reference's default inner-product cost
    (soft_dtw_cuda.py:321-331), 'euclidean' the squared L2 cost."""
    if dist not in ("similarity", "euclidean"):
        raise ValueError(f"unknown dist {dist!r}")
    D = similarity_matrix(x, y) if dist == "similarity" \
        else euclidean_matrix(x, y)
    return soft_dtw(D, gamma, bandwidth)
