"""The frozen yardstick against the records it was copied with."""

import pytest

import yardstick


def test_k1_bound_at_config3_r137():
    """PERF.md's kernel table: K1 at n = 50 000, p = 262 144, r = 137 is
    bound by operations at 3.63 ms."""
    ms, by = yardstick.bound("packed_dot", 50000, 262144, 137, 3125)
    assert by == "operations"
    assert ms == pytest.approx(3.63, abs=0.005)


@pytest.mark.parametrize("r,ms,by", [(2, 0.98, "bytes"), (8, 0.98, "bytes"),
                                     (64, 1.70, "operations")])
def test_k2_bounds(r, ms, by):
    got, kind = yardstick.bound("packed_tdot", 50000, 262144, r, 3125)
    assert kind == by and got == pytest.approx(ms, abs=0.006)


def test_k3_bound_is_the_sum():
    k1 = yardstick.bound("packed_dot", 50000, 262144, 137, 3125)[0]
    k2 = yardstick.bound("packed_tdot", 50000, 262144, 137, 3125)[0]
    k3 = yardstick.bound("kernel_matvec", 50000, 262144, 137, 3125)[0]
    assert k3 == pytest.approx(k1 + k2)
    assert k3 == pytest.approx(7.26, abs=0.01)


def test_gemm_bounds():
    f, b = yardstick.mmt_work(2048, 16384)
    assert f == 2 * 2048 * 16384 ** 2
    assert b == 4 * (2048 * 16384 + 2 * 16384 ** 2)
    assert yardstick.gemm_bound(f, b) == pytest.approx(f / 989e12 * 1e3)
    f, b = yardstick.eig_t_work(7680, 16384, 16384)
    assert f == 2 * 7680 * 16384 * 16384
    # a tiny product is bound by its bytes
    assert yardstick.gemm_bound(*yardstick.eig_t_work(1, 10, 10)) == \
        pytest.approx(4 * (10 + 100 + 10) / 3.35e12 * 1e3)
