"""The XLA split (ops/split.py) against the host golden model
(hostref.split_fp64), bitwise: digits and row/column scales over wide
exponent spreads, both split axes, special values, all-zero and unaligned
shapes."""

import numpy as np
import pytest

from ozimmu_tpu import hostref
from ozimmu_tpu.core.f64x import F64X
from ozimmu_tpu.ops.split import ZERO_ROW_PEXP, split_f64x, split_f64x_cols
from ozimmu_tpu.testing import generate_input


def _check(x: np.ndarray, ns: int, b: int, axis: int):
    fx = F64X.from_numpy(x)
    if axis == 1:  # A operand: one scale per row
        got, pexp = split_f64x(fx, ns, b)
        want, want_p = hostref.split_fp64(x, ns, b)
    else:  # B operand: one scale per column == row split of x.T
        got, pexp = split_f64x_cols(fx, ns, b)
        want, want_p = hostref.split_fp64(np.ascontiguousarray(x.T), ns, b)
        want = want.transpose(0, 2, 1)
    np.testing.assert_array_equal(np.asarray(got), want)
    pexp = np.asarray(pexp).astype(np.int64)
    zero = want_p == hostref.ZERO_ROW_PEXP
    np.testing.assert_array_equal(pexp[~zero], want_p[~zero])
    assert (pexp[zero] == ZERO_ROW_PEXP).all()


class TestSplitXla:
    @pytest.mark.parametrize("axis", [0, 1])
    @pytest.mark.parametrize("ns,b", [(3, 7), (9, 7), (9, 5)])
    def test_exp_spread_bitwise(self, axis, ns, b):
        x = generate_input("exp_rand-8", (160, 224), seed=7)
        _check(x, ns, b, axis)

    @pytest.mark.parametrize("axis", [0, 1])
    def test_special_values(self, axis):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((64, 128))
        x[0, :] = 0.0  # zero row
        x[:, 0] = 0.0  # zero col
        x[1, 1] = 5e-324  # smallest subnormal
        x[2, 2] = -1e-310  # negative subnormal
        x[3, 3] = -0.0
        x[4, 4] = 1e300
        x[5, 5] = -1e-300
        x[6, :] = 1e-310  # an all-subnormal row: nulled scale
        _check(x, 9, 7, axis)

    def test_all_zero_matrix(self):
        _check(np.zeros((32, 128)), 9, 7, 1)

    def test_unaligned_shapes(self):
        x = generate_input("normal01", (100, 200), seed=1)
        _check(x, 8, 7, 1)
        _check(x, 8, 7, 0)

    def test_uniform_large(self):
        x = generate_input("urand01", (256, 384), seed=2)
        _check(x, 9, 7, 1)
        _check(x, 9, 7, 0)
