"""
Sensor-suite demo:

    python -m ics_wt_physicsengine_torch.sensors [--device cpu]

Builds the canonical 7-sensor suite on a 5-zone plant, runs three simulated
minutes with acid dosing (one reactor step and seven reads per second),
prints measured-vs-true tables, then demonstrates calibration, electrode
cleaning and consumable replacement. Runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import math


def run_demo(device=None, n_zones: int = 5, n_ticks: int = 180,
             verbose: bool = True):
    """The demo loop; returns ``(reactor, suite)`` for callers that inspect
    the histories."""
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.sensors import (
        create_realistic_sensor_suite)

    say = print if verbose else (lambda *a, **k: None)
    config = R.ReactorConfiguration(n_zones=n_zones, initial_pH=7.2,
                                    initial_chlorine=1.5)
    reactor = R.IntegratedCSTR(config, device=device)
    suite = create_realistic_sensor_suite(config, seed=42, device=device)
    bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5,
                              acid_flow_rate=0.2, acid_concentration=0.1)

    # Sensor clocks are independent of simulation time. Calibration restarts
    # warm-up, so calibrate at t=0 and start reads past the longest warm-up
    # window (pH: 30 min). Calibrating a cold sensor against the process
    # value bakes the start-up error into the offset (the flow sensor powers
    # on reading 0), so the flow and chlorine channels read high by that
    # offset below: behaviour kept from the reference simulator.
    for name, sensor in suite.items():
        ref = {"pH": 7.2, "chlorine": 1.5, "temp": 20.0,
               "flow": config.flow_rate}[name.split("_")[0]]
        sensor.calibrate(ref, current_time=0.0, operator_id="demo_init")
    t0 = 1801.0

    say("=" * 72)
    say(f"SENSOR SUITE DEMO: 7 instruments on a {n_zones}-zone dosed "
        f"reactor ({reactor.device})")
    say("=" * 72)
    header = (f"{'t[s]':>6} {'pH true':>8} {'pH meas':>8} "
              f"{'Cl true':>8} {'Cl meas':>8} {'T true':>7} {'T meas':>7} "
              f"{'Q meas':>7}")
    say(header)
    say("-" * len(header))

    for tick in range(n_ticks):
        state = reactor.step(1.0, bc)
        t = t0 + tick + 1.0
        readings = {name: s.read(state, current_time=t)
                    for name, s in suite.items()}
        if tick % 30 == 29:
            say(f"{float(state.time):>6.0f} "
                f"{float(state.pH[-1]):>8.3f} "
                f"{readings['pH_outlet'].value:>8.3f} "
                f"{float(state.chlorine[-1]):>8.3f} "
                f"{readings['chlorine_outlet'].value:>8.3f} "
                f"{float(state.temperature[-1]):>7.2f} "
                f"{readings['temp_outlet'].value:>7.2f} "
                f"{readings['flow_main'].value:>7.2f}")

    say("\nPer-sensor summary (last reading, 60 s statistics):")
    for name, sensor in suite.items():
        r = sensor.reading_history[-1]
        stats = sensor.get_statistics(window_seconds=60.0)
        say(f"  {name:<18} value={r.value:>8.3f} noise={r.noise:>+8.5f} "
            f"drift={r.drift:>+9.6f} sigma={stats['std']:>7.4f} "
            f"status={r.status.name}")

    t = t0 + n_ticks

    # Two-point calibration + slope health on the outlet pH electrode
    ph = suite["pH_outlet"]
    health = ph.check_slope_health()
    rec = ph.calibrate_two_point(4.0, 7.0, 4.02, 6.97, current_time=t + 1)
    say(f"\npH_outlet slope health: {health['slope_percentage']:.1f}% "
        f"({health['health']})")
    say(f"Two-point calibration:  offset={rec.offset:+.4f} "
        f"(slope {ph.slope_percentage:.1f}%)")
    ph.clean_electrode("water_rinse", current_time=t + 2)
    say(f"Electrode cleaned: fouling={ph.membrane_fouling:.4f}")

    # Consumable replacement on the DPD chlorine analyzer
    cl = suite["chlorine_outlet"]
    cl.replace_reagent(current_time=t + 3)
    say(f"DPD reagent replaced: potency={cl.reagent_potency:.3f}")

    flow_true = float(reactor.state.flow_rate)
    r = suite["flow_main"].read_flow(flow_true, current_time=t + 4)
    say(f"Direct flow read:     {r.value:.2f} L/min (true {flow_true:.2f})")
    if not math.isfinite(r.value):
        raise RuntimeError("the direct flow read is not finite")
    say("\nDemo complete.")
    return reactor, suite


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    run_demo(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
