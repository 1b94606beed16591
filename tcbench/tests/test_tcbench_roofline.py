"""K1's counted work against counts made by hand at W = 4 and W = 30."""

import pytest

from tcbench import roofline
from tcbench.roofline import k1


@pytest.mark.parametrize('W, channels, step, gather, nbytes', [
    # W = 4: 4 means + 10 covariance entries + 5 env + land + bathy = 21;
    # step: colouring 4*5 = 20, rhs 4*2 + 2*4 + 48 = 64, four of them 256,
    # RK4 combination 56: 332; gather: blend 6*21 = 126, Cholesky
    # 64 // 3 = 21, square roots and reciprocals 8, scalings 6: 161
    (4, 21, 332, 161, 49),
    # W = 30: 30 + 465 + 7 = 502; step: 30*31 = 930, rhs 4*15 + 2*30 + 48
    # = 168 (four: 672), + 56: 1658; gather: 3012 + 9000 + 60 + 435 = 12507
    (30, 502, 1658, 12507, 257),
])
def test_counts_by_hand(W, channels, step, gather, nbytes):
    assert k1.cell_channels(W) == channels
    assert k1.step_flops(W) == step
    assert k1.gather_flops(W) == gather
    assert k1.step_bytes(W) == nbytes
    work = {'storm_steps': 1000, 'gathers': 340, 'storms': 3, 'cells': 2}
    assert k1.flops(W, work) == 1000 * step + 340 * gather
    assert k1.nbytes(W, work) == (1000 * nbytes + 3 * k1.STORM_BYTES
                                  + 2 * 16 * channels)


def test_least_time_takes_the_binding_bound():
    assert roofline.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
