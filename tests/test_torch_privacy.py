"""The port's RDP accountant (``privacy/accountant.py``) against the
reference package's: per-step RDP and the epsilon of a composed run equal
(both are the same float64 numpy formula, held exactly) over a grid of
sampling rates, noise multipliers and step counts; weak DP's effective
multiplier; the refusals word for word."""

import numpy as np
import pytest

from neuroimagedisttraining_tpu.privacy import accountant as ja
from neuroimagedisttraining_tpu_torch import privacy as pp
from neuroimagedisttraining_tpu_torch.privacy import accountant as pa


@pytest.mark.parametrize("q", [0.0, 0.01, 0.1, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("z", [0.5, 1.0, 1.3, 4.0])
def test_rdp_and_epsilon_equal(q, z):
    got, ref = pa.rdp_gaussian(q, z), ja.rdp_gaussian(q, z)
    np.testing.assert_array_equal(got, ref)
    for steps in (1, 10, 200):
        for delta in (1e-5, 1e-3):
            assert pa.rdp_to_epsilon(steps * got, delta=delta) == \
                ja.rdp_to_epsilon(steps * ref, delta=delta)
        acc_p, acc_j = pa.RDPAccountant(1e-5), ja.RDPAccountant(1e-5)
        acc_p.step(q, z, steps)
        acc_j.step(q, z, steps)
        acc_p.step(0.2, 2.0)
        acc_j.step(0.2, 2.0)
        assert acc_p.spent() == acc_j.spent()


@pytest.mark.parametrize("w", [[1, 1, 1], [3, 5, 0, 2], [10]])
def test_weak_dp_multiplier_equal(w):
    for sd, nb in ((0.05, 5.0), (1.0, 0.5)):
        assert pa.weak_dp_noise_multiplier(sd, nb, w) == \
            ja.weak_dp_noise_multiplier(sd, nb, w)


@pytest.mark.parametrize("call", [
    lambda m: m.rdp_gaussian(1.5, 1.0), lambda m: m.rdp_gaussian(0.1, 0.0),
    lambda m: m.rdp_gaussian(0.1, float("nan")),
    lambda m: m.rdp_gaussian(0.1, 1.0, orders=(1, 2)),
    lambda m: m.rdp_to_epsilon(np.zeros(3), orders=(2, 3, 4), delta=0.0),
    lambda m: m.weak_dp_noise_multiplier(0.0, 1.0, [1]),
    lambda m: m.weak_dp_noise_multiplier(0.1, 1.0, [0, 0]),
    lambda m: m.RDPAccountant(delta=1.5),
    lambda m: m.RDPAccountant().step(0.1, 1.0, -1)])
def test_refusals_equal(call):
    with pytest.raises(ValueError) as ref:
        call(ja)
    with pytest.raises(ValueError) as got:
        call(pa)
    assert str(got.value) == str(ref.value)


def test_package_exports_the_accountant():
    assert pp.DEFAULT_ORDERS == ja.DEFAULT_ORDERS
    assert pp.RDPAccountant is pa.RDPAccountant
    assert {"rdp_gaussian", "rdp_to_epsilon", "weak_dp_noise_multiplier"} \
        <= set(dir(pp))
