"""The port's ``utils/analysis.py`` (a copy: the port imports nothing of
the JAX package) against the JAX package's: every gate of
``tests/test_analysis.py`` run on the port's module, and every estimator
equal to the reference's on the same series."""

import inspect

import numpy as np
import pytest

import test_analysis as reference_tests
from montecarlo_tpu.utils import analysis as ref_analysis
from montecarlo_tpu_torch.utils import analysis

GATES = sorted(name for name, fn in vars(reference_tests).items()
               if name.startswith("test_") and callable(fn))


def test_public_names_follow_the_reference():
    assert analysis.__all__ == ref_analysis.__all__


@pytest.mark.parametrize("gate", GATES)
def test_reference_gate_on_the_port(gate, monkeypatch, tmp_path):
    monkeypatch.setattr(reference_tests, "analysis", analysis)
    fn = getattr(reference_tests, gate)
    args = {"tmp_path": tmp_path}
    fn(**{k: args[k] for k in inspect.signature(fn).parameters})


def test_estimators_equal_the_reference():
    x = reference_tests._ar1(0.6, 5000, seed=4)
    for name in ("autocorrelation", "integrated_autocorr_time",
                 "effective_sample_size", "blocking_error"):
        np.testing.assert_array_equal(getattr(analysis, name)(x),
                                      getattr(ref_analysis, name)(x))
    assert str(analysis.summary(x)) == str(ref_analysis.summary(x))
    a, b = analysis.summary(x), ref_analysis.summary(x)
    assert (a.mean, a.error, a.std, a.tau_int, a.n, a.n_eff) == \
        (b.mean, b.error, b.std, b.tau_int, b.n, b.n_eff)
    assert analysis.jackknife(x, np.mean) == ref_analysis.jackknife(x,
                                                                    np.mean)
    assert analysis.binder_cumulant(x) == ref_analysis.binder_cumulant(x)
    e = np.abs(x) * 3.0
    assert analysis.reweight(e, x, 0.4, 0.45) == ref_analysis.reweight(
        e, x, 0.4, 0.45)
    np.testing.assert_array_equal(
        analysis.multi_reweight([0.4, 0.5], [e, e + 0.1], 0.45, obs=[x, x]),
        ref_analysis.multi_reweight([0.4, 0.5], [e, e + 0.1], 0.45,
                                    obs=[x, x]))
