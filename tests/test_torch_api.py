"""The port's object API of the physics core against the JAX package's, on
the CPU: the validation suites, the ``TemperatureDependentKinetics``,
``AqueousChemistry``, ``TransportModel`` and ``SpatialModel`` classes, and
``IntegratedCSTR``'s sub-models, ``derivatives`` and ``print_diagnostics``.

Tolerances: the classes compute on the host in float64 NumPy in both
packages, from the same formulas, so their results are held to 1e-12
(absolute; relative where the magnitude is far from 1). The tracer curves go
through each framework's own ``log``/``exp``/``gammainc`` and are held to
1e-12 as well. ``IntegratedCSTR.derivatives`` runs the reactor's right-hand
side in float64 on both sides and is held to 1e-10, as the port's other
reactor tests are.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import chemistry as jchem
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.core import spatial as jspatial
from ics_wt_physicsengine_tpu.core import thermodynamics as jthermo
from ics_wt_physicsengine_tpu.core import transport as jtransport

from ics_wt_physicsengine_torch import core as tcore
from ics_wt_physicsengine_torch.core import chemistry as tchem
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.core import spatial as tspatial
from ics_wt_physicsengine_torch.core import thermodynamics as tthermo
from ics_wt_physicsengine_torch.core import transport as ttransport
from ics_wt_physicsengine_torch.core.__main__ import main as core_main

torch.set_num_threads(1)

ATOL = 1e-12
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# validation suites and the entry point
# ---------------------------------------------------------------------------

SUITES = {
    "thermodynamics": lambda: tthermo.validate_thermodynamics(),
    "chemistry": lambda: tchem.validate_chemistry(),
    "transport": lambda: ttransport.validate_transport("cpu"),
    "spatial": lambda: tspatial.validate_spatial(),
    "integrated_reactor": lambda: TR.validate_integrated_reactor("cpu"),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_core_validation_suite_runs_on_the_cpu(suite, capsys):
    SUITES[suite]()
    assert "validations passed" in capsys.readouterr().out


def test_run_all_validations_and_the_module_entry_point(capsys):
    """The five core suites, then the six extension-axis suites."""
    tcore.run_all_validations("cpu")
    out = capsys.readouterr().out
    assert out.count("validations passed") == 5
    assert out.count("validation: ALL PASS") == 6
    assert "FAIL:" not in out
    core_main(["--device", "cpu"])
    assert "ALL PHYSICS VALIDATIONS PASSED" in capsys.readouterr().out


def test_validations_want_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.run_all_validations()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.IntegratedCSTR(TR.ReactorConfiguration())


# ---------------------------------------------------------------------------
# TemperatureDependentKinetics
# ---------------------------------------------------------------------------

TEMPS = np.array([0.0, 4.0, 12.5, 20.0, 25.0, 37.0, 100.0])


@pytest.mark.parametrize("method,args", [
    ("celsius_to_kelvin", ()), ("arrhenius_rate", ()),
    ("water_ionization_constant", ()), ("neutral_pH", ()),
    ("carbonate_pKa", (1,)), ("carbonate_pKa", (2,)),
    ("diffusion_coefficient", ()), ("diffusion_coefficient", (0.8,)),
    ("chlorine_decay_rate", ()), ("temperature_compensation_factor", ()),
    ("temperature_compensation_factor", (15.0,)),
])
def test_kinetics_class_matches_jax(method, args):
    port = getattr(tthermo.TemperatureDependentKinetics(), method)
    ref = getattr(jthermo.TemperatureDependentKinetics(), method)
    _close(port(TEMPS, *args), ref(TEMPS, *args), atol=0.0, rtol=ATOL)
    _close(port(21.5, *args), ref(21.5, *args), atol=0.0, rtol=ATOL)


def test_kinetics_class_raises_and_validates_like_jax():
    port = tthermo.TemperatureDependentKinetics()
    for bad in (-0.5, 100.5, np.array([20.0, 120.0])):
        for name in ("celsius_to_kelvin", "arrhenius_rate", "neutral_pH",
                     "water_ionization_constant", "diffusion_coefficient",
                     "chlorine_decay_rate"):
            with pytest.raises(ValueError, match="liquid water range"):
                getattr(port, name)(bad)
    with pytest.raises(ValueError, match="liquid water range"):
        tthermo.check_liquid_water_range(torch.tensor([5.0, -3.0]))
    with pytest.raises(ValueError, match="Dissociation"):
        port.carbonate_pKa(20.0, 3)
    custom = tthermo.ArrheniusParameters(k_ref=2e-4, E_a=4e4, T_ref=298.15)
    jcustom = jthermo.ArrheniusParameters(k_ref=2e-4, E_a=4e4, T_ref=298.15)
    _close(port.arrhenius_rate(TEMPS, custom),
           jthermo.TemperatureDependentKinetics().arrhenius_rate(
               TEMPS, jcustom), atol=0.0, rtol=ATOL)
    for kw in (dict(k_ref=0.0, E_a=1.0), dict(k_ref=1.0, E_a=-1.0),
               dict(k_ref=1.0, E_a=1.0, T_ref=100.0)):
        with pytest.raises(ValueError):
            tthermo.ArrheniusParameters(**kw).validate()
    for name in ("TOLERANCE_KINETICS", "TOLERANCE_PH", "KW_25C", "DPKA_DT",
                 "T_MIN_C", "T_MAX_C", "D_MOLECULAR_REF"):
        assert getattr(port, name) == getattr(
            jthermo.TemperatureDependentKinetics, name)
    assert (tthermo.R_GAS, tthermo.T_REFERENCE_K, tthermo.T_REFERENCE_C) == \
        (jthermo.R_GAS, jthermo.T_REFERENCE_K, jthermo.T_REFERENCE_C)


# ---------------------------------------------------------------------------
# AqueousChemistry
# ---------------------------------------------------------------------------

BUFFERS = [dict(alkalinity=100.0, total_carbonate=2.0, temperature=20.0),
           dict(alkalinity=40.0, total_carbonate=1.2, temperature=8.0),
           dict(alkalinity=180.0, total_carbonate=4.5, temperature=31.0)]


def _chemistries(kw):
    return (tchem.AqueousChemistry(tchem.BufferSystem(**kw)),
            jchem.AqueousChemistry(jchem.BufferSystem(**kw)))


@pytest.mark.parametrize("kw", BUFFERS, ids=lambda kw: f"alk{kw['alkalinity']}")
def test_aqueous_chemistry_matches_jax(kw):
    port, ref = _chemistries(kw)
    for name in ("Kw", "pKw", "pKa1", "Ka1", "pKa2", "Ka2", "pKa_HOCl",
                 "Ka_HOCl"):
        assert getattr(port, name) == pytest.approx(getattr(ref, name),
                                                    rel=ATOL, abs=0.0)
    pH, ref_pH = port.calculate_pH(), ref.calculate_pH()
    assert isinstance(pH, float) and abs(pH - ref_pH) <= ATOL
    assert abs(port.calculate_pH(8.5, tolerance=1e-9)
               - ref.calculate_pH(8.5, tolerance=1e-9)) <= ATOL
    for fn in ("add_acid", "add_base"):
        for mol in (0.001, 0.05):
            assert abs(getattr(port, fn)(1000.0, mol, pH)
                       - getattr(ref, fn)(1000.0, mol, ref_pH)) <= ATOL
    grid = np.linspace(4.0, 11.0, 15)
    for name in ("H_from_pH", "charge_balance_error",
                 "charge_balance_derivative", "buffering_capacity",
                 "pH_dependent_chlorine_decay_factor"):
        _close(getattr(port, name)(grid), getattr(ref, name)(grid),
               atol=0.0, rtol=ATOL)
    _close(port.pH_from_H(10.0 ** -grid), ref.pH_from_H(10.0 ** -grid))
    for a, b in zip(port.alpha_carbonate(grid), ref.alpha_carbonate(grid)):
        _close(a, b)
    spec, ref_spec = (c.chlorine_speciation(2.0, grid) for c in (port, ref))
    assert spec.keys() == ref_spec.keys()
    for key in spec:
        _close(spec[key], ref_spec[key])
    assert isinstance(port.constants.Kw, np.floating)   # host NumPy


def test_buffer_system_validates_like_jax():
    for kw in (dict(alkalinity=-1.0, total_carbonate=1.0),
               dict(alkalinity=1.0, total_carbonate=-1.0)):
        with pytest.raises(ValueError):
            tchem.BufferSystem(**kw).validate()
    with pytest.warns(UserWarning, match="outside typical range"):
        tchem.BufferSystem(100.0, 2.0, temperature=45.0).validate()
    assert tchem.AqueousChemistry.CACO3_MW == jchem.AqueousChemistry.CACO3_MW


# ---------------------------------------------------------------------------
# TransportModel
# ---------------------------------------------------------------------------

def _transports(flow_rate=5.0, n_zones=5, temperature=20.0):
    geom = dict(volume=1000.0, height=2.0, diameter=0.798, n_zones=n_zones)
    flow = dict(flow_rate=flow_rate, impeller_speed=75.0,
                impeller_diameter=0.25)
    return (ttransport.TransportModel(ttransport.GeometryParameters(**geom),
                                      ttransport.FlowParameters(**flow),
                                      temperature),
            jtransport.TransportModel(jtransport.GeometryParameters(**geom),
                                      jtransport.FlowParameters(**flow),
                                      temperature))


@pytest.mark.parametrize("n_zones,temperature", [(5, 20.0), (12, 9.0)])
def test_transport_model_matches_jax(n_zones, temperature):
    port, ref = _transports(n_zones=n_zones, temperature=temperature)
    for name in ("residence_time", "superficial_velocity",
                 "impeller_tip_speed", "Re", "D_turbulent", "D_molecular",
                 "D_effective", "mixing_time_seconds", "mixing_time", "Pe",
                 "k_exchange", "q_per_v"):
        _close(getattr(port, name), getattr(ref, name), atol=0.0, rtol=ATOL)
    np.testing.assert_array_equal(port.K_matrix, ref.K_matrix)
    assert port.is_batch_mode is False
    assert port.dispersion_number() == pytest.approx(
        float(ref.dispersion_number()), rel=ATOL)
    assert port.tanks_in_series_equivalent() == pytest.approx(
        float(ref.tanks_in_series_equivalent()), rel=ATOL)
    rng = np.random.default_rng(3)
    for conc in (rng.uniform(0.5, 2.0, n_zones), np.full(n_zones, 1.3),
                 np.zeros(n_zones)):
        got, want = (m.calculate_mixing_quality(conc) for m in (port, ref))
        _close(got, want)
    t = np.linspace(0.0, 5.0 * port.residence_time * 60.0, 40)
    for mode in ("pulse", "step"):
        got = port.tracer_response(t, mode)
        assert isinstance(got, torch.Tensor) and got.dtype == F64
        _close(got, ref.tracer_response(jnp.asarray(t), mode))
    with pytest.raises(ValueError, match="Unknown tracer input mode"):
        port.tracer_response(t, "ramp")


def test_transport_functions_match_jax_on_tensors_and_batches():
    rng = np.random.default_rng(5)
    conc = rng.uniform(0.1, 3.0, (6, 5))
    for got, want in zip(ttransport.mixing_quality(torch.from_numpy(conc)),
                         jtransport.mixing_quality(jnp.asarray(conc))):
        assert isinstance(got, torch.Tensor)
        _close(got, want)
    for got, want in zip(ttransport.mixing_quality(conc),
                         jtransport.mixing_quality(jnp.asarray(conc))):
        assert isinstance(got, np.ndarray)
        _close(got, want)
    supp = rng.uniform(0.5, 1.0, 4)
    np.testing.assert_array_equal(
        ttransport.exchange_matrix(5, 0.02, 1e-4, suppression=supp),
        jtransport.exchange_matrix(5, 0.02, 1e-4, suppression=supp))
    t = torch.linspace(0.0, 900.0, 31, dtype=F64)
    _close(ttransport.tracer_response_pulse(t, 300.0, 4),
           jtransport.tracer_response_pulse(jnp.asarray(t.numpy()), 300.0, 4))
    _close(ttransport.tracer_response_step(t, 300.0, 4),
           jtransport.tracer_response_step(jnp.asarray(t.numpy()), 300.0, 4))


def test_transport_model_batch_mode_and_diagnostics(capsys):
    port, ref = _transports(flow_rate=0.0)
    assert port.is_batch_mode and port.residence_time is None
    assert port.dispersion_number() == float("inf")
    with pytest.raises(ValueError, match="batch mode"):
        port.tracer_response(np.array([1.0]))
    port.print_diagnostics()
    got = capsys.readouterr().out
    ref.print_diagnostics()
    assert got == capsys.readouterr().out
    port, ref = _transports()
    port.print_diagnostics()
    got = capsys.readouterr().out
    ref.print_diagnostics()
    assert got == capsys.readouterr().out
    with pytest.raises(ValueError, match="Volume inconsistency"):
        ttransport.TransportModel(
            ttransport.GeometryParameters(500.0, 2.0, 0.798),
            ttransport.FlowParameters(5.0))


# ---------------------------------------------------------------------------
# SpatialModel
# ---------------------------------------------------------------------------

PROFILES = {"warm-on-top": [17.0, 19.0, 21.0, 23.0, 25.0],
            "cold-on-top": [25.0, 23.0, 21.0, 19.0, 17.0],
            "anomaly": [2.0, 3.5, 4.0, 6.0, 9.0],
            "thermocline": [18.0, 18.1, 18.2, 22.5, 22.6]}


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_spatial_model_matches_jax(profile):
    temps = np.array(PROFILES[profile])
    params = dict(critical_richardson=0.3, mixing_suppression_factor=0.4)
    port = tspatial.SpatialModel(
        5, 2.0, tspatial.StratificationParameters(**params))
    ref = jspatial.SpatialModel(
        5, 2.0, jspatial.StratificationParameters(**params))
    tds = {"salt": np.linspace(0.0, 0.4, 5)}
    _close(port.update_density_profile(temps, tds),
           ref.update_density_profile(temps, tds))
    np.testing.assert_array_equal(port.zone_centers, ref.zone_centers)
    for u in (0.0, 1e-7, 0.004, 0.05):
        _close(port.calculate_mixing_suppression(u),
               ref.calculate_mixing_suppression(u))
        for i in range(4):
            got, want = (m.calculate_richardson_number(i, u)
                         for m in (port, ref))
            assert got == want or abs(got - want) <= ATOL * abs(want)
            assert port.is_stratification_stable(i, u) == \
                ref.is_stratification_stable(i, u)
    for i in range(-1, 5):
        assert port.calculate_brunt_vaisala_frequency(i) == pytest.approx(
            ref.calculate_brunt_vaisala_frequency(i), abs=ATOL)
    assert port.identify_thermocline() == ref.identify_thermocline()
    assert port.calculate_water_density(12.0, 0.2) == pytest.approx(
        ref.calculate_water_density(12.0, 0.2), abs=ATOL)
    assert port.calculate_inlet_jet_penetration(0.8, 0.05) == pytest.approx(
        ref.calculate_inlet_jet_penetration(0.8, 0.05), abs=ATOL)
    assert port.calculate_inlet_jet_penetration(30.0, 0.05) == 2.0
    assert port.estimate_dead_zones([0.01, 0.0005, 0.002, 0.0, 0.3]) == \
        ref.estimate_dead_zones([0.01, 0.0005, 0.002, 0.0, 0.3]) == [1, 3]
    assert port.estimate_dead_zones() == []
    got, want = (m.calculate_spatial_gradients(temps) for m in (port, ref))
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], abs=ATOL), key
    assert isinstance(got["gradient_location"], int)
    for depth in (0.0, 0.1, 0.77, 1.0, 1.93, 2.0):
        assert port.interpolate_to_depth(temps, depth) == pytest.approx(
            ref.interpolate_to_depth(temps, depth), abs=ATOL)


def test_spatial_model_rejects_and_prints_like_jax(capsys):
    port, ref = tspatial.SpatialModel(5, 2.0), jspatial.SpatialModel(5, 2.0)
    with pytest.raises(ValueError, match="at least 2 zones"):
        tspatial.SpatialModel(1, 2.0)
    with pytest.raises(ValueError, match="Expected 5 temperatures"):
        port.update_density_profile(np.zeros(4))
    with pytest.raises(ValueError, match="Invalid zone index"):
        port.calculate_richardson_number(4, 0.01)
    with pytest.raises(ValueError, match="Expected 5 values"):
        port.calculate_spatial_gradients(np.zeros(3))
    with pytest.raises(ValueError, match="outside tank"):
        port.interpolate_to_depth(np.zeros(5), 2.5)
    for m in (port, ref):
        m.update_density_profile(np.array(PROFILES["thermocline"]))
        m.calculate_mixing_suppression(0.004)
    port.print_spatial_diagnostics()
    got = capsys.readouterr().out
    ref.print_spatial_diagnostics()
    assert got == capsys.readouterr().out
    off = tspatial.SpatialModel(5, 2.0, tspatial.StratificationParameters(
        enable_thermal_stratification=False))
    off.update_density_profile(np.array(PROFILES["thermocline"]))
    assert off.identify_thermocline() is None
    assert (off.calculate_mixing_suppression(0.001) == 1.0).all()


def test_spatial_functions_match_jax_on_tensors():
    rng = np.random.default_rng(9)
    rho = 998.0 + rng.normal(0.0, 0.3, (4, 6))
    profile = rng.uniform(6.5, 8.0, (4, 6))
    t = torch.from_numpy
    _close(tspatial.brunt_vaisala_squared(t(rho), 0.3),
           jspatial.brunt_vaisala_squared(jnp.asarray(rho), 0.3))
    _close(tspatial.jet_penetration(t(np.array([0.2, 1.5, 40.0])), 0.05, 2.0),
           jspatial.jet_penetration(jnp.asarray([0.2, 1.5, 40.0]), 0.05, 2.0))
    got = tspatial.spatial_gradients(t(profile), 0.3)
    want = jspatial.spatial_gradients(jnp.asarray(profile), 0.3)
    assert got.keys() == want.keys()
    for key in got:
        assert isinstance(got[key], torch.Tensor)
        _close(got[key], want[key])
    centers = (np.arange(6) + 0.5) * 0.3
    for elevation in (0.05, 0.15, 0.9, 1.7, 1.79):
        _close(tspatial.interpolate_to_elevation(t(profile), centers,
                                                 elevation),
               jspatial.interpolate_to_elevation(jnp.asarray(profile),
                                                 jnp.asarray(centers),
                                                 elevation))
    for u in (0.0, 0.004):
        _close(tspatial.richardson_number(rho, 0.3, u),
               jspatial.richardson_number(rho, 0.3, u))


# ---------------------------------------------------------------------------
# IntegratedCSTR
# ---------------------------------------------------------------------------

CFG = dict(volume=1000.0, n_zones=4, flow_rate=5.0, initial_pH=7.2,
           initial_chlorine=2.0, temperature=20.0)
BCV = dict(inlet_flow_rate=5.0, inlet_pH=7.4, inlet_chlorine=0.5,
           inlet_temperature=22.0, acid_flow_rate=0.2)


def _reactors(**extra):
    return (TR.IntegratedCSTR(TR.ReactorConfiguration(**CFG, **extra),
                              dtype=F64, device="cpu"),
            JR.IntegratedCSTR(JR.ReactorConfiguration(**CFG, **extra),
                              dtype="float64"))


def test_integrated_cstr_carries_the_sub_models():
    port, ref = _reactors()
    assert isinstance(port.thermo, tthermo.TemperatureDependentKinetics)
    assert isinstance(port.buffer, tchem.BufferSystem)
    assert isinstance(port.chemistry, tchem.AqueousChemistry)
    assert isinstance(port.transport, ttransport.TransportModel)
    assert isinstance(port.spatial, tspatial.SpatialModel)
    assert port.buffer == tchem.BufferSystem(
        ref.buffer.alkalinity, ref.buffer.total_carbonate,
        ref.buffer.temperature)
    assert abs(port.chemistry.calculate_pH()
               - ref.chemistry.calculate_pH()) <= ATOL
    _close(port.transport.k_exchange, ref.transport.k_exchange)
    np.testing.assert_array_equal(port.transport.K_matrix,
                                  ref.transport.K_matrix)
    assert port.transport.geometry.n_zones == port.spatial.n_zones == 4
    assert port.spatial.zone_height == ref.spatial.zone_height
    assert port.spatial.strat_params.enable_thermal_stratification is True
    off, _ = _reactors(enable_thermal_stratification=False)
    assert off.spatial.strat_params.enable_thermal_stratification is False


@pytest.mark.parametrize("stratified", [True, False])
def test_integrated_cstr_derivatives_match_jax(stratified):
    port, ref = _reactors(enable_thermal_stratification=stratified)
    y = np.concatenate([np.linspace(7.0, 7.3, 4), np.linspace(2.0, 1.5, 4),
                        np.linspace(20.0, 23.0, 4)])
    want = np.asarray(ref.derivatives(0.0, y, JR.BoundaryConditions(**BCV)))
    for packed in (y, torch.from_numpy(y)):
        got = port.derivatives(0.0, packed, TR.BoundaryConditions(**BCV))
        assert isinstance(got, torch.Tensor) and got.shape == (12,)
        _close(got, want, atol=1e-10)
    batch = np.stack([y, y + 0.01])
    got = port.derivatives(3.0, batch, TR.BoundaryConditions(**BCV))
    _close(got[0], want, atol=1e-10)
    assert got.shape == (2, 12)


def test_print_diagnostics_equals_jax_apart_from_the_banner(capsys):
    port, ref = _reactors()
    for _ in range(5):
        port.step(1.0, TR.BoundaryConditions(**BCV))
        ref.step(1.0, JR.BoundaryConditions(**BCV))
    port.print_diagnostics()
    got = capsys.readouterr().out.splitlines()
    ref.print_diagnostics()
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    banner = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert banner == [2]
    assert got[2] == "CSTR PHYSICS DIAGNOSTICS (PyTorch engine, cpu)"
    assert "TPU" not in "\n".join(got)


# ---------------------------------------------------------------------------
# every public name of the ported modules has a counterpart
# ---------------------------------------------------------------------------

# JAX-package names without a counterpart, each with where it waits.
WAITS = {
    "sensors.validation": {
        "kept once, in sensors/__init__.py": {
            "ChlorineSensorType", "FlowSensorType", "TemperatureSensorType"},
    },
    "ops.ph_solver": {
        "the port's solve_pH_kernel (no Pallas in the port)": {
            "solve_pH_pallas"},
    },
    "utils": {
        "one array library in the port: no namespace dispatch": {
            "array_namespace"},
    },
    "utils.backend_select": {
        "no CPU fallback in the port: the CPU only when the caller asks": {
            "pin_cpu"},
        "no XLA compile cache: ops/_build.py caches the kernels": {
            "enable_compile_cache"},
        "no JAX backends: the probe runs before any CUDA touch": {
            "backends_initialized"},
    },
}
PORTED = ("core", "core.thermodynamics", "core.chemistry", "core.transport",
          "core.spatial", "core.reactor", "core.nitrogen", "core.gas",
          "core.particles", "core.disinfection", "core.biofilm",
          "core.phase", "sensors", "sensors.electrical", "sensors.wrappers",
          "sensors.validation", "sensors.ammonia", "sensors.oxygen",
          "sensors.turbidity", "ops.ph_solver", "core.network",
          "sensors.sampleline", "control", "control.pid",
          "control.estimator", "control.closed_loop", "control.tuning",
          "control.ekf", "control.enkf", "control.mhe", "control.mpc",
          "models", "models.surrogate", "utils", "utils.checkpoint",
          "utils.history", "utils.profiling", "utils.backend_select",
          "utils.netreap", "modbus", "modbus.register_map",
          "modbus.protocols", "modbus.security", "modbus.slave",
          "modbus.client", "modbus.rtu", "modbus.native_slave", "opcua",
          "opcua.encoding", "opcua.messages", "opcua.server",
          "opcua.client", "__main__", "fleet", "parallel", "parallel.mesh",
          "parallel.fused", "parallel.multihost", "parallel.spatial")
PACKAGES = ("core", "sensors", "control", "models", "utils", "modbus",
            "opcua", "parallel")
# modules whose whole public surface is one class or one function
SINGLE_CLASS = ("utils.history", "utils.netreap", "modbus.client", "fleet")


def _public_names(module, package: bool):
    """Functions (jitted ones too), classes and upper-case constants a
    module defines; for a package, everything public it exports from the
    JAX package."""
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if callable(value):
            home = getattr(value, "__module__", "") or ""
            if home == module.__name__ or (
                    package and home.startswith("ics_wt_physicsengine_tpu")):
                yield name
        elif name.isupper():
            yield name


@pytest.mark.parametrize("name", PORTED)
def test_every_public_name_has_a_counterpart_or_waits(name):
    ref = importlib.import_module(f"ics_wt_physicsengine_tpu.{name}")
    port = importlib.import_module(f"ics_wt_physicsengine_torch.{name}")
    waits = set().union(*WAITS.get(name, {}).values())
    public = set(_public_names(ref, package=name in PACKAGES))
    assert len(public) >= (1 if name in SINGLE_CLASS else 3)
    missing = sorted(n for n in public - waits if not hasattr(port, n))
    assert not missing, f"{name}: no counterpart for {missing}"
    stale = sorted(n for n in waits if hasattr(port, n))
    assert not stale, f"{name}: listed as waiting but present: {stale}"
    assert waits <= public, f"{name}: not in the JAX module: {waits - public}"
