"""The op table shared by the port's CPU parity tests
(``tests/test_torch_ops.py``, against the JAX package) and the card check
of ``chip_smoke.py``'s ``eager_training`` phase (the card against the
port's CPU result): seeded inputs for one case per public function of the
reference's ``ops/*.py``, the per-dtype tolerances, the invariants of the
factorizations and the draws of the random ops. It imports torch and
numpy only.
"""
import zlib

import numpy as np
import torch

import paddle_tpu_torch.ops as P

TOL = {np.dtype(np.float32): (1e-5, 1e-6), np.dtype(np.float64): (1e-7, 1e-8),
       np.dtype(np.complex64): (1e-5, 1e-6),
       np.dtype(np.complex128): (1e-7, 1e-8)}


class G:
    """Seeded inputs for one case."""

    def __init__(self, name):
        self.r = np.random.default_rng(zlib.crc32(name.encode()))

    def f(self, *shape, lo=-1.0, hi=1.0):
        return self.r.uniform(lo, hi, shape).astype(np.float32)

    def pos(self, *shape):
        return self.f(*shape, lo=0.2, hi=0.9)

    def i(self, lo, hi, *shape):
        return self.r.integers(lo, hi, shape).astype(np.int64)

    def b(self, *shape):
        return self.r.random(shape) < 0.5

    def spd(self, n):
        a = self.f(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _u(name):
    return (name, lambda g: ((g.pos(3, 4),), {}))


def _b(name, lo=-1.0, hi=1.0):
    return (name, lambda g: ((g.f(3, 4, lo=lo, hi=hi),
                              g.f(3, 4, lo=lo, hi=hi)), {}))


def _red(name, **kw):
    return (name, lambda g: ((g.f(3, 4, 5),), dict(axis=1, keepdim=True,
                                                     **kw)))


CASES = [
    # ---------------------------------------------------------- creation
    ("to_tensor", lambda g: (([[1.0, 2.0], [3.0, 4.0]],), {})),
    ("full", lambda g: (([2, 3], 1.5), {})),
    ("full_like", lambda g: ((g.f(2, 3), 7.0), {})),
    ("zeros", lambda g: (([2, 3],), {})),
    ("zeros_like", lambda g: ((g.f(2, 3),), {})),
    ("ones", lambda g: (([2, 3],), {"dtype": "int32"})),
    ("ones_like", lambda g: ((g.f(2, 3),), {})),
    ("empty", lambda g: (([2, 3],), {})),
    ("empty_like", lambda g: ((g.f(2, 3),), {})),
    ("arange", lambda g: ((1, 10, 2), {})),
    ("linspace", lambda g: ((0.0, 1.0, 7), {})),
    ("logspace", lambda g: ((0.0, 2.0, 5), {})),
    ("eye", lambda g: ((3, 4), {})),
    ("diag", lambda g: ((g.f(4),), {"offset": 1, "padding_value": 2.0})),
    ("diagflat", lambda g: ((g.f(2, 2),), {"offset": -1})),
    ("tril", lambda g: ((g.f(4, 4),), {"diagonal": -1})),
    ("triu", lambda g: ((g.f(4, 4),), {"diagonal": 1})),
    ("meshgrid", lambda g: ((g.f(3), g.f(4)), {})),
    ("assign", lambda g: ((g.f(3, 4),), {})),
    ("clone", lambda g: ((g.f(3, 4),), {})),
    ("complex", lambda g: ((g.f(3), g.f(3)), {})),
    ("tril_indices", lambda g: ((4, 5, 1), {})),
    ("triu_indices", lambda g: ((4, 5, -1), {})),
    ("vander", lambda g: ((g.f(4),), {"n": 3, "increasing": True})),
    # ---------------------------------------------------------- math
    _b("add"), _b("subtract"), _b("multiply"), _b("divide"),
    ("floor_divide", lambda g: ((g.i(-20, 20, 3, 4), g.i(1, 5, 3, 4)), {})),
    ("mod", lambda g: ((g.f(3, 4, lo=-5, hi=5), g.pos(3, 4)), {})),
    ("remainder", lambda g: ((g.f(3, 4, lo=-5, hi=5), g.pos(3, 4)), {})),
    ("pow", lambda g: ((g.pos(3, 4), g.f(3, 4)), {})),
    ("scale", lambda g: ((g.f(3, 4),), dict(scale=2.0, bias=0.5,
                                            act="tanh"))),
    _b("maximum"), _b("minimum"), _b("fmax"), _b("fmin"),
    ("abs", lambda g: ((g.f(3, 4),), {})), _u("neg"),
    ("sign", lambda g: ((g.f(3, 4),), {})), _u("reciprocal"), _u("square"),
    _u("sqrt"), _u("rsqrt"), _u("exp"), _u("expm1"), _u("log"), _u("log2"),
    _u("log10"), _u("log1p"),
    ("floor", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    ("ceil", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    ("round", lambda g: ((np.array([-2.5, -1.5, -0.4, 0.5, 1.5, 2.6],
                                   np.float32),), {})),
    ("trunc", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    ("frac", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    _u("sin"), _u("cos"), _u("tan"), _u("asin"), _u("acos"), _u("atan"),
    _b("atan2"), _u("sinh"), _u("cosh"), _u("tanh"), _u("asinh"),
    ("acosh", lambda g: ((g.f(3, 4, lo=1.2, hi=3.0),), {})),
    _u("atanh"), _u("deg2rad"), _u("rad2deg"), _u("erf"), _u("erfinv"),
    _u("lgamma"), _u("digamma"), _u("sigmoid"),
    ("logit", lambda g: ((g.pos(3, 4),), {"eps": 0.3})),
    ("logsumexp", lambda g: ((g.f(3, 4, 5),), dict(axis=[0, 2]))),
    _b("logaddexp"),
    ("sum", lambda g: ((g.f(3, 4, 5),), dict(axis=[0, 2], keepdim=True))),
    _red("mean"),
    ("prod", lambda g: ((g.f(3, 4, 5),), dict(axis=[0, 2]))),
    ("max", lambda g: ((g.f(3, 4, 5),), dict(axis=[1, 2]))),
    ("min", lambda g: ((g.f(3, 4, 5),), {})),
    _red("amax"), _red("amin"),
    ("all", lambda g: ((g.b(3, 4),), dict(axis=1))),
    ("any", lambda g: ((g.b(3, 4),), dict(axis=0, keepdim=True))),
    ("count_nonzero", lambda g: ((g.i(0, 2, 3, 4),), dict(axis=1,
                                                          keepdim=True))),
    ("cumsum", lambda g: ((g.f(3, 4),), dict(axis=1))),
    ("cumprod", lambda g: ((g.f(3, 4),), dict(dim=0))),
    ("cummax", lambda g: ((g.f(3, 5),), dict(axis=1))),
    ("cummin", lambda g: ((g.f(3, 5),), {})),
    ("clip", lambda g: ((g.f(3, 4),), dict(min=-0.5, max=0.3))),
    ("nansum", lambda g: ((np.where(g.b(3, 4), np.nan, g.f(3, 4)),),
                          dict(axis=1))),
    ("nanmean", lambda g: ((np.where(g.b(3, 4), np.nan, g.f(3, 4)),),
                           dict(axis=0))),
    ("isfinite", lambda g: ((np.array([1.0, np.inf, -np.inf, np.nan],
                                      np.float32),), {})),
    ("isinf", lambda g: ((np.array([1.0, np.inf, -np.inf, np.nan],
                                   np.float32),), {})),
    ("isnan", lambda g: ((np.array([1.0, np.inf, -np.inf, np.nan],
                                   np.float32),), {})),
    ("stanh", lambda g: ((g.f(3, 4),), {})),
    ("inner", lambda g: ((g.f(3, 4), g.f(2, 4)), {})),
    ("outer", lambda g: ((g.f(3), g.f(4)), {})),
    ("kron", lambda g: ((g.f(2, 3), g.f(3, 2)), {})),
    ("gcd", lambda g: ((g.i(0, 50, 6), g.i(1, 50, 6)), {})),
    ("lcm", lambda g: ((g.i(1, 20, 6), g.i(1, 20, 6)), {})),
    ("diff", lambda g: ((g.f(3, 5),), dict(n=2, axis=1))),
    ("heaviside", lambda g: ((np.array([-1.0, 0.0, 2.0], np.float32),
                              np.array([0.5, 0.5, 0.5], np.float32)), {})),
    ("rot90", lambda g: ((g.f(3, 4),), dict(k=3))),
    ("trace", lambda g: ((g.f(4, 5),), dict(offset=1))),
    ("addmm", lambda g: ((g.f(3, 5), g.f(3, 4), g.f(4, 5)),
                         dict(beta=0.5, alpha=2.0))),
    ("lerp", lambda g: ((g.f(3, 4), g.f(3, 4), 0.3), {})),
    ("add_n", lambda g: (([g.f(3, 4), g.f(3, 4), g.f(3, 4)],), {})),
    ("angle", lambda g: ((g.f(3, 4),), {})),
    ("sgn", lambda g: ((g.f(3, 4),), {})),
    ("frexp", lambda g: ((g.f(3, 4, lo=-9, hi=9),), {})),
    ("ldexp", lambda g: ((g.f(3, 4), g.i(-3, 4, 3, 4)), {})),
    _b("copysign"), _b("hypot"),
    ("signbit", lambda g: ((g.f(3, 4),), {})),
    _u("sinc"), _u("i0"), _u("i0e"), _u("i1"), _u("i1e"),
    ("xlogy", lambda g: ((g.f(3, 4), g.pos(3, 4)), {})),
    ("nan_to_num", lambda g: ((np.array([1.0, np.inf, -np.inf, np.nan],
                                        np.float32),), dict(nan=0.5))),
    ("increment", lambda g: ((g.f(3),), dict(value=2.0))),
    ("multiplex", lambda g: (([g.f(4, 3), g.f(4, 3)],
                              np.array([[1], [0], [1], [1]])), {})),
    ("logcumsumexp", lambda g: ((g.f(3, 4),), dict(axis=1))),
    ("renorm", lambda g: ((g.f(3, 4, lo=-3, hi=3),), dict(p=2, axis=0,
                                                          max_norm=1.0))),
    ("trapezoid", lambda g: ((g.f(3, 5),), dict(dx=0.5))),
    ("cumulative_trapezoid", lambda g: ((g.f(3, 5),),
                                        dict(x=np.sort(g.f(5))))),
    ("floor_mod", lambda g: ((g.f(3, 4, lo=-5, hi=5), g.pos(3, 4)), {})),
    ("rank", lambda g: ((g.f(3, 4, 2),), {})),
    ("shape", lambda g: ((g.f(3, 4, 2),), {})),
    ("broadcast_shape", lambda g: (([3, 1, 4], [5, 1]), {})),
    ("polar", lambda g: ((g.pos(3), g.f(3)), {})),
    _b("add_"), _b("subtract_"), _b("multiply_"),
    ("scale_", lambda g: ((g.f(3, 4),), dict(scale=3.0, bias=1.0,
                                             bias_after_scale=False))),
    ("remainder_", lambda g: ((g.f(3, 4, lo=-5, hi=5), g.pos(3, 4)), {})),
    ("floor_mod_", lambda g: ((g.f(3, 4, lo=-5, hi=5), g.pos(3, 4)), {})),
    ("lerp_", lambda g: ((g.f(3, 4), g.f(3, 4), 0.7), {})),
    ("increment_", lambda g: ((g.f(3),), {})),
    ("nan_to_num_", lambda g: ((np.array([np.inf, np.nan], np.float32),),
                               {})),
    ("ceil_", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})), _u("exp_"),
    ("floor_", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    ("round_", lambda g: ((g.f(3, 4, lo=-3, hi=3),), {})),
    _u("rsqrt_"), _u("sqrt_"), _u("tanh_"), _u("reciprocal_"),
    ("clip_", lambda g: ((g.f(3, 4),), dict(min=-0.2))),
    _u("erfinv_"), ("abs_", lambda g: ((g.f(3, 4),), {})), _u("sigmoid_"),
    ("gammaln", lambda g: ((g.f(3, 4, lo=0.5, hi=5),), {})),
    ("gammainc", lambda g: ((g.f(6, lo=0.5, hi=3), g.f(6, lo=0.1, hi=4)),
                            {})),
    ("gammaincc", lambda g: ((g.f(6, lo=0.5, hi=3), g.f(6, lo=0.1, hi=4)),
                             {})),
    ("multigammaln", lambda g: ((g.f(6, lo=2.0, hi=5.0), 3), {})),
    ("polygamma", lambda g: ((g.f(6, lo=0.5, hi=3), 2), {})),
    _b("nextafter"),
    ("isposinf", lambda g: ((np.array([1.0, np.inf, -np.inf], np.float32),),
                            {})),
    ("isneginf", lambda g: ((np.array([1.0, np.inf, -np.inf], np.float32),),
                            {})),
    ("isreal", lambda g: ((g.f(3),), {})),
    # ---------------------------------------------------------- manipulation
    ("reshape", lambda g: ((g.f(3, 4), [2, -1]), {})),
    ("flatten", lambda g: ((g.f(2, 3, 4),), dict(start_axis=1))),
    ("transpose", lambda g: ((g.f(2, 3, 4), [2, 0, 1]), {})),
    ("moveaxis", lambda g: ((g.f(2, 3, 4), 0, -1), {})),
    ("swapaxes", lambda g: ((g.f(2, 3, 4), 0, 2), {})),
    ("t", lambda g: ((g.f(3, 4),), {})),
    ("concat", lambda g: (([g.f(2, 3), g.f(4, 3)],), dict(axis=0))),
    ("stack", lambda g: (([g.f(2, 3), g.f(2, 3)],), dict(axis=1))),
    ("unstack", lambda g: ((g.f(2, 3),), dict(axis=1))),
    ("split", lambda g: ((g.f(6, 4), [2, -1, 1]), dict(axis=0))),
    ("chunk", lambda g: ((g.f(7, 4), 3), {})),
    ("squeeze", lambda g: ((g.f(1, 3, 1, 4),), dict(axis=[0, 1, 2]))),
    ("unsqueeze", lambda g: ((g.f(3, 4), [0, -1]), {})),
    ("expand", lambda g: ((g.f(3, 1), [2, -1, 4]), {})),
    ("expand_as", lambda g: ((g.f(3, 1), g.f(3, 4)), {})),
    ("broadcast_to", lambda g: ((g.f(3, 1), [3, 4]), {})),
    ("broadcast_tensors", lambda g: (([g.f(3, 1), g.f(1, 4)],), {})),
    ("tile", lambda g: ((g.f(2, 3), [2, 1, 2]), {})),
    ("repeat_interleave", lambda g: ((g.f(2, 3), 2), dict(axis=1))),
    ("roll", lambda g: ((g.f(3, 4), [1, -2]), dict(axis=[0, 1]))),
    ("flip", lambda g: ((g.f(3, 4), [0, 1]), {})),
    ("cast", lambda g: ((g.f(3, 4, lo=-9, hi=9), "int32"), {})),
    ("slice", lambda g: ((g.f(4, 5), [0, 1], [1, 0], [3, 4]), {})),
    ("strided_slice", lambda g: ((g.f(6, 5), [0, 1], [0, 4], [6, 0],
                                  [2, -1]), {})),
    ("gather", lambda g: ((g.f(5, 3), g.i(0, 5, 4)), dict(axis=0))),
    ("gather_nd", lambda g: ((g.f(4, 5, 2), g.i(0, 4, 3, 2)), {})),
    ("scatter", lambda g: ((g.f(5, 3), np.array([3, 0, 1]), g.f(3, 3)),
                           dict(overwrite=False))),
    ("scatter_nd_add", lambda g: ((g.f(4, 3), np.array([[1], [3], [1]]),
                                   g.f(3, 3)), {})),
    ("scatter_nd", lambda g: ((np.array([[1], [3]]), g.f(2, 3), [4, 3]), {})),
    ("put_along_axis", lambda g: ((g.f(3, 4), g.i(0, 4, 3, 1), g.f(3, 1), 1),
                                  dict(reduce="add"))),
    ("take_along_axis", lambda g: ((g.f(3, 4), g.i(0, 4, 3, 2), 1), {})),
    ("index_select", lambda g: ((g.f(3, 4), g.i(0, 4, 5)), dict(axis=1))),
    ("index_sample", lambda g: ((g.f(3, 4), g.i(0, 4, 3, 2)), {})),
    ("masked_select", lambda g: ((g.f(3, 4), g.b(3, 4)), {})),
    ("masked_fill", lambda g: ((g.f(3, 4), g.b(3, 4), 9.0), {})),
    ("where", lambda g: ((g.b(3, 4), g.f(3, 4), g.f(3, 4)), {})),
    ("nonzero", lambda g: ((g.i(0, 2, 3, 4),), {})),
    ("unique", lambda g: ((g.i(0, 5, 12),), dict(return_index=True,
                                                  return_inverse=True,
                                                  return_counts=True))),
    ("unique_consecutive", lambda g: ((np.array([1, 1, 2, 2, 2, 3, 1, 1]),),
                                      dict(return_inverse=True,
                                           return_counts=True))),
    ("tolist", lambda g: ((g.i(0, 9, 2, 3),), {})),
    ("numel", lambda g: ((g.f(3, 4),), {})),
    ("shard_index", lambda g: ((g.i(0, 20, 6, 1), 20, 2, 1), {})),
    ("as_real", lambda g: ((g.f(3) + 1j * g.f(3),), {})),
    ("as_complex", lambda g: ((g.f(3, 2),), {})),
    ("real", lambda g: ((g.f(3) + 1j * g.f(3),), {})),
    ("imag", lambda g: ((g.f(3) + 1j * g.f(3),), {})),
    ("conj", lambda g: ((g.f(3) + 1j * g.f(3),), {})),
    ("pad", lambda g: ((g.f(1, 2, 4, 5), [1, 2, 2, 1]),
                       dict(mode="reflect"))),
    ("unbind", lambda g: ((g.f(3, 4),), dict(axis=1))),
    ("vsplit", lambda g: ((g.f(4, 3), 2), {})),
    ("hsplit", lambda g: ((g.f(3, 4), [1, 3]), {})),
    ("dsplit", lambda g: ((g.f(2, 3, 4), 2), {})),
    ("reverse", lambda g: ((g.f(3, 4), 1), {})),
    ("crop", lambda g: ((g.f(4, 5),), dict(shape=[2, -1], offsets=[1, 2]))),
    ("diagonal", lambda g: ((g.f(3, 4, 5),), dict(offset=1, axis1=1,
                                                  axis2=2))),
    ("fill_diagonal_tensor", lambda g: ((g.f(4, 5), g.f(4)), dict(offset=1))),
    ("diagonal_scatter", lambda g: ((g.f(4, 4), g.f(3)), dict(offset=-1))),
    ("select_scatter", lambda g: ((g.f(3, 4), g.f(3), 1, 2), {})),
    ("index_fill", lambda g: ((g.f(3, 4), np.array([0, 2]), 1, -1.0), {})),
    ("take", lambda g: ((g.f(3, 4), np.array([[0, 13], [-2, 5]])),
                        dict(mode="wrap"))),
    ("unfold", lambda g: ((g.f(3, 8), 1, 3, 2), {})),
    ("as_strided", lambda g: ((g.f(3, 4), [2, 3], [4, 1], 1), {})),
    ("view", lambda g: ((g.f(3, 4), "int32"), {})),
    ("view_as", lambda g: ((g.f(3, 4), g.f(6, 2)), {})),
    ("moveaxis_", lambda g: ((g.f(2, 3, 4), 2, 0), {})),
    ("reshape_", lambda g: ((g.f(3, 4), [4, 3]), {})),
    ("flatten_", lambda g: ((g.f(2, 3, 4),), {})),
    ("squeeze_", lambda g: ((g.f(3, 1),), {})),
    ("unsqueeze_", lambda g: ((g.f(3, 4), 1), {})),
    ("scatter_", lambda g: ((g.f(5, 3), np.array([3, 0]), g.f(2, 3)), {})),
    ("put_along_axis_", lambda g: ((g.f(3, 4), g.i(0, 4, 3, 1), 2.0, 1),
                                   {})),
    ("unflatten", lambda g: ((g.f(3, 12), 1, [2, -1, 3]), {})),
    ("masked_scatter", lambda g: ((g.f(3, 4), g.b(3, 4), g.f(12)), {})),
    ("slice_scatter", lambda g: ((g.f(6, 4), g.f(3, 2), [0, 1], [0, 1],
                                  [6, 4], [2, 2]), {})),
    ("column_stack", lambda g: (([g.f(3), g.f(3, 2)],), {})),
    ("row_stack", lambda g: (([g.f(3), g.f(2, 3)],), {})),
    ("tensor_split", lambda g: ((g.f(7, 2), [2, 5]), {})),
    ("atleast_1d", lambda g: ((np.float32(3.0), g.f(2)), {})),
    ("atleast_2d", lambda g: ((g.f(3),), {})),
    ("atleast_3d", lambda g: ((g.f(3, 2),), {})),
    ("block_diag", lambda g: (([g.f(2, 2), g.f(1, 3)],), {})),
    ("cartesian_prod", lambda g: (([g.f(2), g.f(3)],), {})),
    ("diag_embed", lambda g: ((g.f(2, 3),), dict(offset=1))),
    ("combinations", lambda g: ((g.f(4),), dict(r=2,
                                                with_replacement=True))),
    # ---------------------------------------------------------- linalg
    ("matmul", lambda g: ((g.f(2, 4, 3), g.f(2, 5, 4)),
                          dict(transpose_x=True, transpose_y=True))),
    ("mm", lambda g: ((g.f(3, 4), g.f(4, 2)), {})),
    ("bmm", lambda g: ((g.f(2, 3, 4), g.f(2, 4, 2)), {})),
    ("dot", lambda g: ((g.f(3, 4), g.f(3, 4)), {})),
    ("mv", lambda g: ((g.f(3, 4), g.f(4)), {})),
    ("dist", lambda g: ((g.f(3, 4), g.f(3, 4)), dict(p=3))),
    ("norm", lambda g: ((g.f(3, 4, 5),), dict(p=2, axis=[1, 2]))),
    ("cond", lambda g: ((g.spd(4),), {})),
    ("cross", lambda g: ((g.f(4, 3), g.f(4, 3)), {})),
    ("cholesky", lambda g: ((g.spd(4),), dict(upper=True))),
    ("cholesky_solve", lambda g: ((g.f(4, 2),
                                   np.linalg.cholesky(g.spd(4))), {})),
    ("triangular_solve", lambda g: ((np.triu(g.spd(4)), g.f(4, 2)),
                                    dict(upper=True, transpose=True))),
    ("inverse", lambda g: ((g.spd(4),), {})),
    ("pinv", lambda g: ((g.f(4, 3),), {})),
    ("solve", lambda g: ((g.spd(4), g.f(4, 2)), {})),
    ("lstsq", lambda g: ((g.f(6, 3), g.f(6, 2)), {})),
    ("det", lambda g: ((g.spd(4),), {})),
    ("slogdet", lambda g: ((g.f(4, 4),), {})),
    ("matrix_rank", lambda g: ((g.f(4, 2) @ g.f(2, 5),), {})),
    ("matrix_power", lambda g: ((g.f(3, 3), 3), {})),
    ("qr", lambda g: ((g.f(5, 3),), {})),
    ("svd", lambda g: ((g.f(5, 3),), {})),
    ("eig", lambda g: ((g.f(4, 4),), {})),
    ("eigh", lambda g: ((g.spd(4),), {})),
    ("eigvals", lambda g: ((g.spd(4),), {})),
    ("eigvalsh", lambda g: ((g.spd(4),), dict(UPLO="U"))),
    ("multi_dot", lambda g: (([g.f(3, 4), g.f(4, 5), g.f(5, 2)],), {})),
    ("histogram", lambda g: ((g.f(50),), dict(bins=7, min=-1, max=1))),
    ("bincount", lambda g: ((g.i(0, 6, 20),), dict(minlength=8))),
    ("einsum", lambda g: (("bij,bjk->bik", g.f(2, 3, 4), g.f(2, 4, 2)), {})),
    ("lu", lambda g: ((g.f(4, 4),), {})),
    ("lu_unpack", lambda g: ((g.f(4, 4),), {})),
    ("tensordot", lambda g: ((g.f(3, 4, 5), g.f(4, 5, 2)), dict(axes=2))),
    ("cov", lambda g: ((g.f(3, 6),), {})),
    ("corrcoef", lambda g: ((g.f(6, 3),), dict(rowvar=False))),
    ("cdist", lambda g: ((g.f(4, 3), g.f(5, 3)), dict(p=1.5))),
    ("pdist", lambda g: ((g.f(5, 3),), {})),
    ("inv", lambda g: ((g.spd(3),), {})),
    ("matrix_transpose", lambda g: ((g.f(2, 3, 4),), {})),
    ("vecdot", lambda g: ((g.f(3, 4), g.f(3, 4)), dict(axis=0))),
    ("householder_product", lambda g: ((g.f(5, 3), g.pos(3)), {})),
    # ---------------------------------------------------------- logic
    _b("equal", -2, 2), _b("not_equal", -2, 2), _b("greater_than"),
    _b("greater_equal"), _b("less_than"), _b("less_equal"),
    ("equal_all", lambda g: ((np.ones(3, np.float32),
                              np.ones(3, np.float32)), {})),
    ("allclose", lambda g: ((g.f(3), g.f(3)), {})),
    ("isclose", lambda g: ((g.f(4), np.array([0, 1, 0.5, 0.2], np.float32)),
                           dict(atol=0.5))),
    ("logical_and", lambda g: ((g.b(3, 4), g.b(3, 4)), {})),
    ("logical_or", lambda g: ((g.b(3, 4), g.b(3, 4)), {})),
    ("logical_xor", lambda g: ((g.b(3, 4), g.b(3, 4)), {})),
    ("logical_not", lambda g: ((g.b(3, 4),), {})),
    ("bitwise_and", lambda g: ((g.i(0, 64, 6), g.i(0, 64, 6)), {})),
    ("bitwise_or", lambda g: ((g.i(0, 64, 6), g.i(0, 64, 6)), {})),
    ("bitwise_xor", lambda g: ((g.i(0, 64, 6), g.i(0, 64, 6)), {})),
    ("bitwise_not", lambda g: ((g.i(-64, 64, 6),), {})),
    ("bitwise_left_shift", lambda g: ((g.i(0, 64, 6), g.i(0, 4, 6)), {})),
    ("bitwise_right_shift", lambda g: ((g.i(0, 64, 6), g.i(0, 4, 6)), {})),
    ("is_empty", lambda g: ((np.zeros((0, 3), np.float32),), {})),
    ("is_tensor", lambda g: ((g.f(3),), {})),
    ("is_complex", lambda g: ((g.f(3),), {})),
    ("is_floating_point", lambda g: ((g.f(3),), {})),
    ("is_integer", lambda g: ((g.i(0, 3, 3),), {})),
    ("union1d", lambda g: ((g.i(0, 9, 6), g.i(0, 9, 5)), {})),
    ("intersect1d", lambda g: ((g.i(0, 9, 8), g.i(0, 9, 8)), {})),
    ("setdiff1d", lambda g: ((g.i(0, 9, 8), g.i(0, 9, 4)), {})),
    # ---------------------------------------------------------- search
    ("argmax", lambda g: ((g.f(3, 4),), dict(axis=1, keepdim=True))),
    ("argmin", lambda g: ((g.f(3, 4),), {})),
    ("argsort", lambda g: ((g.f(3, 4),), dict(descending=True))),
    ("sort", lambda g: ((g.f(3, 4),), dict(axis=0))),
    ("topk", lambda g: ((g.f(3, 6), 2), dict(largest=False))),
    ("kthvalue", lambda g: ((g.f(3, 6), 3), dict(keepdim=True))),
    ("mode", lambda g: ((g.i(0, 3, 3, 7),), {})),
    ("searchsorted", lambda g: ((np.sort(g.f(2, 6), axis=1), g.f(2, 3)),
                                dict(right=True))),
    ("bucketize", lambda g: ((g.f(5), np.sort(g.f(6))), {})),
    ("index_add", lambda g: ((g.f(4, 3), np.array([1, 3, 1]), 0, g.f(3, 3)),
                             {})),
    ("index_put", lambda g: ((g.f(4, 3), (np.array([0, 2]), np.array([1, 1])),
                              g.f(2)), dict(accumulate=True))),
    ("isin", lambda g: ((g.i(0, 9, 3, 4), g.i(0, 9, 5)), {})),
    ("digitize", lambda g: ((g.f(6), np.sort(g.f(4))), dict(right=True))),
    # ---------------------------------------------------------- stat
    ("var", lambda g: ((g.f(3, 4, 5),), dict(axis=[0, 2], unbiased=False))),
    ("std", lambda g: ((g.f(3, 4),), dict(axis=1, keepdim=True))),
    ("median", lambda g: ((g.f(3, 4),), dict(axis=1))),
    ("nanmedian", lambda g: ((np.where(g.b(3, 5), np.nan, g.f(3, 5)),),
                             dict(axis=0))),
    ("quantile", lambda g: ((g.f(3, 4, 5), [0.2, 0.7]),
                            dict(axis=[1, 2], keepdim=True))),
    ("nanquantile", lambda g: ((np.where(g.b(3, 6), np.nan, g.f(3, 6)), 0.3),
                               dict(axis=1))),
    ("histogramdd", lambda g: ((g.f(20, 2),),
                               dict(bins=4, ranges=[[-1, 1], [-1, 1]]))),
    # ---------------------------------------------------------- sequence
    ("sequence_pad", lambda g: (([g.f(3, 2), g.f(1, 2), g.f(2, 2)],),
                                dict(pad_value=-1.0))),
    ("sequence_unpad", lambda g: ((g.f(3, 4, 2), np.array([2, 4, 1])), {})),
    ("sequence_pool", lambda g: ((g.f(3, 4, 2), np.array([2, 4, 1])),
                                 dict(pool_type="sqrt"))),
    ("sequence_softmax", lambda g: ((g.f(3, 4), np.array([2, 4, 1])), {})),
    ("sequence_reverse", lambda g: ((g.f(3, 4, 2), np.array([2, 4, 1])), {})),
    ("sequence_expand", lambda g: ((g.f(3, 2), np.array([2, 0, 1])), {})),
    ("sequence_expand_as", lambda g: ((g.f(3, 2), np.array([1, 3, 1])), {})),
    ("sequence_first_step", lambda g: ((g.f(3, 4, 2),
                                        np.array([2, 4, 1])), {})),
    ("sequence_last_step", lambda g: ((g.f(3, 4, 2), np.array([2, 4, 1])),
                                      {})),
    ("sequence_concat", lambda g: (([g.f(2, 3, 2), g.f(2, 2, 2)],
                                    [np.array([2, 3]), np.array([1, 2])]),
                                   {})),
]

RANDOM = ["uniform", "rand", "randn", "normal", "standard_normal", "randint",
          "randint_like", "randperm", "multinomial", "bernoulli", "poisson",
          "exponential_", "uniform_", "normal_", "gaussian"]

# factorizations fixed only up to sign, phase or pivoting
FACTORS = {"qr", "svd", "eig", "eigh", "lu", "lu_unpack"}

# no gradient through the eager tapes: integer, boolean or data-dependent
# results, or a reference that computes through numpy (no vjp)
NO_GRAD = {
    "full_like", "zeros_like", "ones_like", "empty_like",
    "masked_select", "unique", "unique_consecutive", "nonzero", "tolist",
    "bincount", "histogram", "histogramdd", "sequence_pad", "sequence_unpad",
    "sequence_expand", "sequence_expand_as", "sequence_concat",
    "combinations", "as_complex", "lstsq", "matrix_rank", "cond", "dist",
    "norm", "cummax", "cummin", "mode", "kthvalue", "topk", "sort",
    "nextafter", "frexp", "heaviside", "polygamma", "multigammaln",
    "gammainc", "gammaincc", "i0", "i0e", "i1", "i1e", "erfinv", "erfinv_",
    "digamma", "lgamma", "gammaln", "householder_product", "pdist", "cdist",
    "median", "nanmedian", "quantile", "nanquantile", "nanmean", "nansum",
    "view", "take", "as_strided", "renorm", "logcumsumexp", "cumprod",
    "prod",
}


def to_torch(x, device="cpu"):
    """The numpy arrays inside a case's arguments as tensors on
    ``device`` (lists, tuples and scalars as they are)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy()).to(device)
    if isinstance(x, list):
        return [to_torch(v, device) for v in x]
    if isinstance(x, tuple):
        return tuple(to_torch(v, device) for v in x)
    return x


def leaves(x):
    """An op's outputs (nested lists and tuples) as a flat list of numpy
    arrays."""
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            out += leaves(v)
        return out
    if isinstance(x, torch.Tensor):
        d = x.detach().cpu()
        return [(d.float() if d.dtype == torch.bfloat16 else d).numpy()]
    return [np.asarray(x)]


def compare(got, want, name):
    gl, wl = leaves(got), leaves(want)
    assert len(gl) == len(wl), f"{name}: {len(gl)} outputs, want {len(wl)}"
    for k, (a, b) in enumerate(zip(gl, wl)):
        assert a.shape == b.shape, f"{name}[{k}]: {a.shape} != {b.shape}"
        if b.dtype.kind in "fc":
            rtol, atol = TOL.get(b.dtype, TOL[np.dtype(np.float32)])
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{k}]")


def factors_check(name, args, got, want):
    """Reconstructions and invariants of a factorization."""
    a = args[0].astype(np.float64)
    gl = [x.astype(np.complex128) if x.dtype.kind == "c" else
          x.astype(np.float64) for x in leaves(got)]
    tol = dict(rtol=1e-4, atol=1e-5)
    if name == "qr":
        q, r = gl
        np.testing.assert_allclose(q @ r, a, **tol)
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), **tol)
        np.testing.assert_allclose(np.abs(r), np.abs(leaves(want)[1]), **tol)
    elif name == "svd":
        u, s, vh = gl
        np.testing.assert_allclose((u * s) @ vh, a, **tol)
        np.testing.assert_allclose(s, leaves(want)[1], **tol)
    elif name == "eig":
        w, v = gl
        np.testing.assert_allclose(a @ v, v * w, **tol)
        np.testing.assert_allclose(np.sort_complex(w),
                                   np.sort_complex(leaves(want)[0]), **tol)
    elif name == "eigh":
        w, v = gl
        np.testing.assert_allclose(a @ v, v * w, **tol)
        np.testing.assert_allclose(w, leaves(want)[0], **tol)
    elif name == "lu":
        lu, piv = gl
        p, l, u = (x.numpy().astype(np.float64) for x in P.lu_unpack(
            torch.from_numpy(lu), torch.from_numpy(piv.astype(np.int32))))
        np.testing.assert_allclose(p @ l @ u, a, **tol)
    elif name == "lu_unpack":
        p, l, u = gl
        np.testing.assert_allclose(p @ l @ u, a, **tol)


def call_port_factors(name, args, kw, device="cpu"):
    """The port's result of a factorization case on ``device``."""
    to = lambda x: torch.from_numpy(x.copy()).to(device)  # noqa: E731
    if name != "lu_unpack":
        return getattr(P, name)(*[to(a) for a in args], **kw)
    return P.lu_unpack(*P.lu(to(args[0])))


def draw(name, key, device="cpu"):
    """One draw of random op ``name`` (``key`` a generator, or the seed of
    ``gaussian``; creation ops use the current device, which must be
    ``device``)."""
    shape = (400, 50)
    x = torch.full(shape, 0.3, device=device)
    calls = {
        "uniform": lambda: P.uniform(shape, min=-2.0, max=3.0, key=key),
        "rand": lambda: P.rand(shape, key=key),
        "randn": lambda: P.randn(shape, key=key),
        "normal": lambda: P.normal(1.0, 2.0, shape, key=key),
        "standard_normal": lambda: P.standard_normal(shape, key=key),
        "randint": lambda: P.randint(-3, 5, shape, key=key),
        "randint_like": lambda: P.randint_like(x, 0, 7, key=key),
        "randperm": lambda: P.randperm(500, key=key),
        "multinomial": lambda: P.multinomial(torch.tensor([0.1, 0.2, 0.7],
                                                          device=device),
                                             20000, True, key=key),
        "bernoulli": lambda: P.bernoulli(x, key=key),
        "poisson": lambda: P.poisson(torch.full(shape, 4.0, device=device),
                                     key=key),
        "exponential_": lambda: P.exponential_(x, lam=2.0, key=key),
        "uniform_": lambda: P.uniform_(x, 0.0, 1.0, key=key),
        "normal_": lambda: P.normal_(x, 0.5, 0.1, key=key),
        "gaussian": lambda: P.gaussian(shape, 1.0, 0.5, seed=key),
    }
    return calls[name]()


# mean, std of each draw of 20000 (the moments are held within 5 standard
# errors: sd / sqrt(n) for the mean, about sd / sqrt(n / 2) for the sd)
MOMENTS = {"uniform": (0.5, 5 / 12 ** 0.5), "rand": (0.5, 1 / 12 ** 0.5),
           "randn": (0.0, 1.0), "normal": (1.0, 2.0),
           "standard_normal": (0.0, 1.0), "randint": (0.5, (63 / 12) ** 0.5),
           "randint_like": (3.0, 2.0), "bernoulli": (0.3, 0.21 ** 0.5),
           "poisson": (4.0, 2.0), "exponential_": (0.5, 0.5),
           "uniform_": (0.5, 1 / 12 ** 0.5), "normal_": (0.5, 0.1),
           "gaussian": (1.0, 0.5), "multinomial": (1.6, 0.44 ** 0.5)}




def check_random(name, device="cpu"):
    """A random op held to bit-equal replay under a fixed seed, a change
    under another seed, and its range and moments (mean and standard
    deviation within 5 standard errors) on ``device``; returns the draw.
    The current device must be ``device``."""
    from paddle_tpu_torch.framework import random as framework_random

    if name == "gaussian":
        a, b, c = draw(name, 5, device), draw(name, 5, device), \
            draw(name, 6, device)
    else:
        framework_random.seed(123)
        a = draw(name, None, device)
        framework_random.seed(123)
        b = draw(name, None, device)
        c = draw(name, torch.Generator(device=device).manual_seed(9), device)
    assert torch.equal(a, b), f"{name}: a fixed seed does not replay"
    assert not torch.equal(a, c), f"{name}: another seed draws the same"
    assert a.device.type == torch.device(device).type, name
    if name == "randperm":
        assert sorted(a.tolist()) == list(range(500))
        assert a.dtype == torch.int64
        return a
    mean, sd = MOMENTS[name]
    v = a.double().reshape(-1)
    n = v.numel()
    assert abs(float(v.mean()) - mean) < 5 * sd / n ** 0.5, name
    assert abs(float(v.std()) - sd) < 5 * sd / (n / 2) ** 0.5, name
    if name in ("uniform", "rand", "uniform_"):
        lo, hi = (-2.0, 3.0) if name == "uniform" else (0.0, 1.0)
        assert float(v.min()) >= lo and float(v.max()) < hi, name
    if name in ("randint", "randint_like", "bernoulli", "poisson"):
        assert torch.equal(a, a.round()), name
    return a
