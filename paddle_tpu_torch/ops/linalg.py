"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``).

``torch.linalg`` under paddle's names and arguments. Factorizations that
are fixed only up to sign, phase or pivoting (``svd``, ``qr``, ``eig``,
``eigh``, ``lu``) return torch's factors: compare reconstructions, not
factors.
"""
from __future__ import annotations

import torch

from ._common import float_of, pair, t

__all__ = [
    "matmul", "mm", "bmm", "dot", "mv", "dist", "norm", "cond", "cross",
    "cholesky", "cholesky_solve", "triangular_solve", "inverse", "pinv",
    "solve", "lstsq", "det", "slogdet", "matrix_rank", "matrix_power", "qr",
    "svd", "eig", "eigh", "eigvals", "eigvalsh", "multi_dot", "histogram",
    "bincount", "einsum", "lu", "lu_unpack", "tensordot", "cov", "corrcoef",
    "cdist", "pdist", "inv", "matrix_transpose", "vecdot",
    "householder_product",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = pair(x, y)
    if transpose_x and x.ndim > 1:
        x = x.mT
    if transpose_y and y.ndim > 1:
        y = y.mT
    return torch.matmul(x, y)


def mm(input, mat2, name=None):  # noqa: A002
    return torch.matmul(*pair(input, mat2))


def bmm(x, y, name=None):
    return torch.matmul(*pair(x, y))


def dot(x, y, name=None):
    x, y = pair(x, y)
    return torch.sum(x * y, dim=-1)


def mv(x, vec, name=None):
    return torch.matmul(*pair(x, vec))


def dist(x, y, p=2, name=None):
    x, y = pair(x, y)
    return norm(x - y, p=p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = float_of(t(x))
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        if isinstance(axis, tuple):
            return torch.linalg.matrix_norm(x, "fro", dim=axis,
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(x, 2, dim=axis, keepdim=keepdim)
    if isinstance(p, (int, float)):
        if axis is None:
            x, axis = x.reshape(-1), 0
        return torch.linalg.norm(x, ord=p, dim=axis, keepdim=keepdim)
    raise ValueError(f"unsupported norm order {p}")


def cond(x, p=None, name=None):
    return torch.linalg.cond(t(x), p)


def cross(x, y, axis=9, name=None):
    x, y = pair(x, y)
    if axis == 9:  # paddle's default: the first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(t(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` given ``A``'s Cholesky factor ``y``."""
    x, y = pair(x, y)
    return torch.cholesky_solve(x, y, upper=upper)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x z = y`` (``x^T z = y`` with ``transpose``) for a
    triangular ``x``."""
    x, y = pair(x, y)
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def inverse(x, name=None):
    return torch.linalg.inv(t(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(t(x), rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(*pair(x, y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)``, as numpy's: the
    residuals (squared 2-norms of the columns of ``y - x @ solution``)
    only for a tall ``x`` of full rank, else empty."""
    x, y = pair(x, y)
    sol = torch.linalg.lstsq(x, y, rcond=rcond).solution
    sv = torch.linalg.svdvals(x)
    rank = torch.linalg.matrix_rank(x)
    m, n = x.shape[-2], x.shape[-1]
    if m > n and bool((rank == n).all()):
        r = y - x @ sol
        res = torch.sum(r * r, dim=-2)
    else:
        res = x.new_zeros((0,))
    return sol, res, rank, sv


def det(x, name=None):
    return torch.linalg.det(t(x))


def slogdet(x, name=None):
    sign, logabsdet = torch.linalg.slogdet(t(x))
    return torch.stack([sign, logabsdet])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(t(x), rtol=tol, hermitian=hermitian)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(t(x), n)


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(t(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(t(x), full_matrices=full_matrices))


def eig(x, name=None):
    return tuple(torch.linalg.eig(t(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(t(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(t(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(t(x), UPLO=UPLO)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([t(m) for m in x])


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0); the last bin includes its right edge."""
    x = t(input).reshape(-1)
    if not x.is_floating_point():
        x = x.float()
    return torch.histc(x, bins=bins, min=min, max=max)


def bincount(x, weights=None, minlength=0, name=None):
    x = t(x)
    if weights is not None:
        weights = t(weights, like=x)
    return torch.bincount(x, weights=weights, minlength=minlength)


def einsum(equation, *operands):
    return torch.einsum(equation, *[t(o) for o in operands])


def lu(x, pivot=True, get_infos=False, name=None):
    """Packed LU factors with LAPACK's 1-based pivots (int32)."""
    lu_mat, piv, info = torch.linalg.lu_factor_ex(t(x), pivot=pivot)
    if get_infos:
        return lu_mat, piv, info
    return lu_mat, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of :func:`lu`'s result, ``x = P @ L @ U``."""
    P, L, U = torch.lu_unpack(*pair(x, y), unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None, U if unpack_ludata else None)


def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(*pair(x, y), dims=axes)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = float_of(t(x))
    if not rowvar:
        x = x.T
    if fweights is not None:
        fweights = t(fweights, like=x)
    if aweights is not None:
        aweights = t(aweights, like=x)
    return torch.cov(x, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


def corrcoef(x, rowvar=True, name=None):
    x = float_of(t(x))
    return torch.corrcoef(x if rowvar else x.T)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distances between row batches; for p = 2 the
    matmul formulation, as the reference computes it."""
    x = t(x, dtype=torch.float32)
    y = t(y, like=x, dtype=torch.float32)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = torch.sum(x * x, -1)[..., :, None]
        y2 = torch.sum(y * y, -1)[..., None, :]
        d2 = x2 + y2 - 2.0 * torch.matmul(x, y.mT)
        return torch.sqrt(torch.clamp(d2, min=0.0))
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == float("inf"):
        return torch.amax(diff, -1)
    if p == 0:
        return torch.sum(diff != 0, -1).to(x.dtype)
    return torch.sum(diff ** p, -1) ** (1.0 / p)


def pdist(x, p=2.0, name=None):
    """The upper-triangle (i < j) entries of ``cdist(x, x)``."""
    x = t(x, dtype=torch.float32)
    full = cdist(x, x, p=p)
    i, j = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    return full[i, j]


def inv(x, name=None):
    """Alias of :func:`inverse` (``paddle.linalg.inv``)."""
    return inverse(x)


def matrix_transpose(x, name=None):
    return t(x).mT


def vecdot(x, y, axis=-1, name=None):
    x, y = pair(x, y)
    return torch.sum(x * y, dim=axis)


def householder_product(x, tau, name=None):
    """The product of the Householder reflectors of a QR factorization's
    compact ``(v, tau)`` form: Q with ``x``'s shape ``[..., m, k]``."""
    x = t(x)
    if x.is_complex():
        raise NotImplementedError(
            "householder_product: complex reflectors not supported")
    x = float_of(x)
    return torch.linalg.householder_product(x, t(tau, like=x).to(x.dtype))
