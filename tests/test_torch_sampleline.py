"""The port's physical sample line (``sensors/sampleline.py``) against the
JAX package's, on the host in float64.

Both compute in Python floats from the same formulas, so every value is
held to 1e-12 (relative where the magnitude is far from 1: Reynolds
numbers, film coefficients, thermal rates): the constants, the Nusselt
correlation across its three regimes, the overall U, the NTU (bare,
insulated, stagnant), the outlet temperature and value, the
``PhysicalSampleLine`` derived fields, a transported sequence of samples,
the configuration's checks and the validation suite.
"""

import math

import numpy as np
import pytest

from ics_wt_physicsengine_tpu.sensors import sampleline as J

from ics_wt_physicsengine_torch import sensors as tsensors
from ics_wt_physicsengine_torch.sensors import sampleline as T
from ics_wt_physicsengine_torch.sensors.types import SampleLine

TOL = 1e-12

CONFIGS = [dict(), dict(insulation_thickness_m=0.01),
           dict(inner_diameter_m=9.5e-3, wall_thickness_m=0.8e-3,
                wall_conductivity_w_mk=16.0, external_h_w_m2k=25.0),
           dict(wall_thickness_m=0.0)]


def _near(a, b):
    assert a == pytest.approx(b, rel=TOL, abs=TOL), (a, b)


def test_constants_and_the_validation_suite():
    for name in ("RHO_WATER", "MU_WATER", "K_WATER", "CP_WATER", "PR_WATER",
                 "NU_LAMINAR", "RE_LAMINAR", "RE_TURBULENT"):
        assert getattr(T, name) == getattr(J, name), name
    assert T.validate_sample_line() is True
    assert J.validate_sample_line() is True
    assert tsensors.validate_sample_line is T.validate_sample_line
    assert tsensors.PhysicalSampleLine is T.PhysicalSampleLine


@pytest.mark.parametrize("re", [10.0, 1000.0, 2300.0, 2300.5, 3100.0,
                                3999.9, 4000.0, 1e4, 3.7e5])
def test_nusselt_and_reynolds(re):
    _near(T.nusselt(re), J.nusselt(re))
    _near(T.nusselt(re, 4.2), J.nusselt(re, 4.2))
    v = re * T.MU_WATER / (T.RHO_WATER * 4.8e-3)
    _near(T.reynolds(v, 4.8e-3), J.reynolds(v, 4.8e-3))


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_overall_u_and_ntu(kw):
    tc, jc = T.LineThermalConfig(**kw), J.LineThermalConfig(**kw)
    for v in (0.01, 0.46, 1.3):
        _near(T.overall_U(tc, v), J.overall_U(jc, v))
    for length in (0.5, 5.0, 40.0):
        for q in (250.0, 500.0, 4000.0):
            _near(T.line_ntu(tc, length, q / 6e4),
                  J.line_ntu(jc, length, q / 6e4))
    assert T.line_ntu(tc, 5.0, 0.0) == math.inf == J.line_ntu(jc, 5.0, 0.0)


def test_outlet_temperature_and_value():
    rng = np.random.default_rng(0)
    for t_in, t_amb, ntu, k, tau in rng.uniform(
            [0.0, -5.0, 0.0, 0.0, 0.0], [40.0, 35.0, 60.0, 0.05, 600.0],
            (20, 5)):
        _near(T.outlet_temperature(t_in, t_amb, ntu),
              J.outlet_temperature(t_in, t_amb, ntu))
        _near(T.outlet_value(1.7, k, tau), J.outlet_value(1.7, k, tau))


@pytest.mark.parametrize("kw", [
    dict(), dict(flow_rate_mL_min=250.0, length_m=12.0, ambient_temp=31.0),
    dict(flow_rate_mL_min=1000.0, length_m=2.0,
         line_decay_rate_per_s=2e-3),
    dict(thermal_kw=dict(insulation_thickness_m=0.01))])
def test_physical_sample_line_transports_like_jax(kw):
    kw = dict(kw)
    thermal = kw.pop("thermal_kw", {})
    tl = T.PhysicalSampleLine(thermal=T.LineThermalConfig(**thermal), **kw)
    jl = J.PhysicalSampleLine(thermal=J.LineThermalConfig(**thermal), **kw)
    assert isinstance(tl, SampleLine)
    for name in ("volume_mL", "volume_L", "flow_rate_L_s",
                 "transport_delay_s", "ntu", "thermal_rate_per_s"):
        _near(getattr(tl, name), getattr(jl, name))
    assert tl.buffer_capacity == jl.buffer_capacity
    rng = np.random.default_rng(3)
    for i in range(150):
        value, temp = rng.uniform(0.2, 2.5), rng.uniform(10.0, 30.0)
        got = tl.transport_sample(value, temp, float(i))
        want = jl.transport_sample(value, temp, float(i))
        _near(got[0], want[0])
        _near(got[1], want[1])


def test_configuration_checks_match_jax():
    for kw in (dict(inner_diameter_m=0.0), dict(wall_thickness_m=-1e-3),
               dict(external_h_w_m2k=0.0)):
        with pytest.raises(ValueError) as got:
            T.LineThermalConfig(**kw)
        with pytest.raises(ValueError) as want:
            J.LineThermalConfig(**kw)
        assert str(got.value) == str(want.value)
