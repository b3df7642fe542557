"""The XLA recombination (ops/recombine.py): every t-group's int32 total
equals the exact int64 sum of its slice-pair products (host digit planes
from hostref), and the triple-f32 fold carries the exact weighted sum to
far below f64's rounding."""

import numpy as np
import pytest

from ozimmu_tpu import hostref
from ozimmu_tpu.core.f64x import F64X
from ozimmu_tpu.ops.recombine import (
    LOOP_MIN_BYTES, acc_shift, fold_group_totals, group_totals, recombine,
)
from ozimmu_tpu.ops.split import split_f64x, split_f64x_cols
from ozimmu_tpu.schedule import bits_per_int8, group_schedule
from ozimmu_tpu.testing import generate_input


def _planes(m, n, k, ns, seed):
    b = bits_per_int8(k)
    a = generate_input("normal01", (m, k), seed=seed)
    bm = generate_input("normal01", (k, n), seed=seed + 1)
    da, _ = split_f64x(F64X.from_numpy(a), ns, b)
    db, _ = split_f64x_cols(F64X.from_numpy(bm), ns, b)
    # the device planes are the host golden model's (tests/test_split_xla)
    np.testing.assert_array_equal(np.asarray(da), hostref.split_fp64(a, ns, b)[0])
    return np.asarray(da), np.asarray(db), b


def _exact_totals(da, db, ns, k, b):
    return [
        sum(da[i - 1].astype(np.int64) @ db[j - 1].astype(np.int64) for i, j in g.pairs)
        for g in group_schedule(ns, k, b)
    ]


def _run(m, n, k, ns, seed=0):
    da, db, b = _planes(m, n, k, ns, seed)
    got = group_totals(da, db, ns, k, b)
    want = _exact_totals(da, db, ns, k, b)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w)

    # fold: S (triple f32) == sum_t total_t * 2^(w_t + shift), exactly up
    # to the triple's ~2^-71 accumulation error
    shift = acc_shift(ns, b)
    S = [np.asarray(s).astype(np.float64) for s in recombine(da, db, ns, b, k)]
    exact = np.zeros((m, n), dtype=object)
    for grp, w in zip(group_schedule(ns, k, b), want):
        e = grp.weight_log2(b) + shift + 62  # >= 0: integers after * 2^62
        exact = exact + w.astype(object) * (1 << e)
    # every component is a multiple of 2^-62 (ACC_SHIFT): exact integers
    to_int = np.vectorize(lambda v: int(v * 2.0**62), otypes=[object])
    got_S = to_int(S[0]) + to_int(S[1]) + to_int(S[2])
    err = np.abs((got_S - exact).astype(np.float64))
    scale = np.abs(exact.astype(np.float64))
    assert (err <= scale * 2.0**-64).all()


class TestRecombineXla:
    def test_single_group_chunk(self):
        """k small enough that every t-group is one int8 dot."""
        _run(64, 48, 384, ns=9)

    def test_sub_chunked_groups(self):
        """k=16384: the int32 cap splits the t=10 group in two dots."""
        assert len(group_schedule(9, 16384, bits_per_int8(16384))) == 10
        _run(8, 8, 16384, ns=9)

    def test_unaligned_shapes(self):
        _run(50, 34, 68, ns=6, seed=3)

    @pytest.mark.parametrize("ns", [3, 12])
    def test_split_counts(self, ns):
        _run(32, 32, 64, ns=ns, seed=5)

    @pytest.mark.parametrize("m,n", [(512, 520), (32, 40)])
    def test_looped_and_unrolled_agree(self, m, n):
        """From LOOP_MIN_BYTES on the pairs and groups run in loops (one
        product live); below it they are unrolled.  Both are exact, and
        the looped recombine equals the fold of the per-group totals
        (the distributed paths' route) bit for bit."""
        assert (4 * m * n >= LOOP_MIN_BYTES) == (m == 512)
        k, ns = 64, 9
        _run(m, n, k, ns=ns, seed=7)
        da, db, b = _planes(m, n, k, ns, seed=7)
        got = recombine(da, db, ns, b, k)
        want = fold_group_totals(group_totals(da, db, ns, k, b), ns, k, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g).view(np.uint32),
                                          np.asarray(w).view(np.uint32))
