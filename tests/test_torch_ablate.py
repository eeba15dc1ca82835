"""The port's two ablation tools (``tools/torch_ablate_fused_plant.py``,
``tools/torch_ablate_integrated.py``) on the CPU.

- Every edit of the B3 tool's ``ABLATIONS`` matches exactly once in the
  shipped ``csrc/``, so a kernel change that breaks an ablation fails
  here and not on the card; its variants are the JAX package's documented
  ``_ABLATE`` switches plus ``full``.
- The JAX kernel in interpret mode (5 zones x 8 steps, ``rng="bits"``)
  under each switch holds what the card's checks rest on: the physics is
  bit-equal to ``full``'s under every switch, and ``one_sensor``'s first
  sensor reads as in ``full``. JAX's ``no_store`` skips the carry
  write-back of every step (its kernel reads the carries back each step),
  so its carries stay as they came in and only its first reading equals
  ``full``'s; the port's carries live in registers and are stored once a
  launch, so its ``no_store`` keeps ``full``'s readings (held on the
  card). JAX's ``no_rand`` readings equal the port's plain ``plant_step``
  loop fed zero normals and 0.5 uniforms, within the B3 parity tests'
  tolerances (``tests/test_torch_fused_plant.py``: readings 1e-4, physics
  2e-5).
- ``torch_ablate_integrated.main`` on the CPU in float64 at 3 plants x 3
  steps: ``physics`` and ``norand`` within 1e-10 of the JAX tool's own
  calls (``tools/ablate_integrated.py:78-101``) made here; ``full``,
  ``noline`` and ``tap`` reactor states within 1e-10 of the physics, every
  sensor's last value finite.
- Both tools refuse a missing card with a non-zero exit, and the B3 tool
  refuses ``--device cpu`` with its reason."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.ops import fused_plant as JFP
from ics_wt_physicsengine_tpu.ops.fused_rollout import _LANES

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import reactor as TR
from ics_wt_physicsengine_torch.ops import _build
from ics_wt_physicsengine_torch.ops import fused_plant as TFP

from torch_port_util import assert_tree_close, to_numpy, tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_ablate_fused_plant as AB3  # noqa: E402
import torch_ablate_integrated as AI  # noqa: E402
from torch_rollout_compare import ablated_sources  # noqa: E402

torch.set_num_threads(1)

F32 = torch.float32
READ = 1e-4      # readings (tests/test_torch_fused_plant.py)
PHYS = 2e-5      # pH, chlorine, temperature (the same)
ATOL = 1e-10     # float64, the integrated tool against JAX
N_ZONES, N_STEPS = 5, 8
BC = dict(inlet_flow_rate=5.0, inlet_pH=7.2, inlet_chlorine=0.5,
          acid_flow_rate=0.1)
SENSORS = [name for name, _, _ in TFP.SENSORS]


# ---------------------------------------------------------------------------
# the B3 tool's edits and variants
# ---------------------------------------------------------------------------

EDITS = [(variant, k) for variant, edits in AB3.ABLATIONS.items()
         for k in range(len(edits))]


@pytest.mark.parametrize("variant,k", EDITS)
def test_every_edit_matches_once_in_the_shipped_sources(variant, k):
    name, text, replacement = AB3.ABLATIONS[variant][k]
    assert (_build.CSRC / name).read_text().count(text) == 1
    assert text != replacement


@pytest.mark.parametrize("variant", sorted(AB3.ABLATIONS))
def test_each_ablated_copy_differs_only_by_its_edits(variant, tmp_path):
    out = ablated_sources(_build.CSRC, tmp_path / variant,
                          AB3.ABLATIONS[variant])
    for src in _build.CSRC.iterdir():
        body = src.read_text()
        for name, text, replacement in AB3.ABLATIONS[variant]:
            if name == src.name:
                body = body.replace(text, replacement)
        assert (out / src.name).read_text() == body
    changed = {name for name, _, _ in AB3.ABLATIONS[variant]}
    assert changed == {"fused_plant.cu"}


def test_the_ablation_plant_delays_its_sample_lines():
    """``no_hist`` removes work only where a line delays its tap: the
    tool's plant at dt 1 s has such lines (the card checks it too)."""
    _, _, bc, params, plant = AB3.ablation_plant(torch.device("cpu"))
    tables = TFP.build_tables(params, plant, bc, dt=AB3.DT, n_steps=4)
    assert AB3.line_sensors(tables) == ["pH_inlet", "pH_outlet",
                                        "temp_inlet", "temp_outlet"]


def test_variants_are_the_jax_switches_and_full():
    source = Path(JFP.__file__).read_text()
    doc = re.search(r"Members:(.*?)\n_ABLATE = frozenset\(\)", source,
                    re.S).group(1)
    documented = set(re.findall(r'"(\w+)"', doc))
    assert documented == {"no_sensors", "no_rand", "no_taps", "no_store",
                          "no_hist", "one_sensor"}
    assert set(AB3.ABLATIONS) == documented
    assert set(AB3.VARIANTS) == documented | {"full"}
    assert AB3.VARIANTS[0] == "full" and len(AB3.VARIANTS) == 7
    assert {v for v in AB3.SUBSYSTEMS.values()} == documented


# ---------------------------------------------------------------------------
# the JAX kernel's switches in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """``{variant: (plant, readings)}`` of the JAX kernel under each
    switch, with the plant and the words they ran from."""
    cfg = JR.ReactorConfiguration(n_zones=N_ZONES)
    jp, js = JPL.make_plant(cfg, seed=11, dtype=jnp.float32)
    substeps = JR.default_substeps(cfg, 1.0)
    planes = np.random.default_rng(0).integers(
        -2 ** 31, 2 ** 31, size=(N_STEPS, JFP.N_WORDS, 8, _LANES),
        dtype=np.int32)
    runs = {}
    for v in AB3.VARIANTS:
        saved = JFP._ABLATE
        JFP._ABLATE = frozenset() if v == "full" else frozenset((v,))
        try:
            runs[v] = JFP.plant_rollout_fused(
                jp, js, JR.BoundaryConditions(**BC), dt=1.0,
                substeps=substeps, n_steps=N_STEPS, rng="bits", bits=planes,
                interpret=True)
        finally:
            JFP._ABLATE = saved
    return dict(runs=runs, params=jp, plant=js, substeps=substeps)


def _state(plant):
    return [np.asarray(getattr(plant.reactor, f))
            for f in ("pH", "chlorine", "temperature", "time")]


@pytest.mark.parametrize("variant", AB3.VARIANTS[1:])
def test_jax_physics_is_bit_equal_under_every_switch(jax_runs, variant):
    got, full = jax_runs["runs"][variant][0], jax_runs["runs"]["full"][0]
    for a, b in zip(_state(got), _state(full)):
        np.testing.assert_array_equal(a, b)


def test_jax_one_sensor_reads_its_sensor_as_full(jax_runs):
    runs = jax_runs["runs"]
    first = SENSORS[0]
    np.testing.assert_array_equal(np.asarray(runs["one_sensor"][1][first]),
                                  np.asarray(runs["full"][1][first]))


def test_jax_no_store_freezes_the_carries(jax_runs):
    """JAX's switch skips every step's write-back: the carries leave as
    they came, the first reading (read from the incoming carry) equals
    ``full``'s and later ones do not."""
    runs, plant = jax_runs["runs"], jax_runs["plant"]
    no_store, full = runs["no_store"], runs["full"]
    for _, attr, _ in TFP.SENSORS:
        carry_in, carry_out = getattr(plant, attr), getattr(no_store[0],
                                                            attr)
        for f in ("current_value", "last_value", "last_timestamp"):
            np.testing.assert_array_equal(
                np.asarray(getattr(carry_out.base, f)),
                np.asarray(getattr(carry_in.base, f)), err_msg=(attr, f))
    for name in SENSORS:
        a = np.asarray(no_store[1][name])
        b = np.asarray(full[1][name])
        np.testing.assert_array_equal(a[0], b[0], err_msg=name)
    assert any(not np.array_equal(np.asarray(no_store[1][n]),
                                  np.asarray(full[1][n]), equal_nan=True)
               for n in SENSORS)


def test_jax_no_rand_matches_the_ports_plain_loop(jax_runs):
    """JAX's ``no_rand`` kernel and the port's ``plant_step`` loop fed the
    same constant draws (the card's check of the ablated B3)."""
    tp = convert.plant_params_from_numpy(tree_to_numpy(jax_runs["params"]),
                                         dtype=F32, device="cpu")
    ts = convert.plant_state_from_numpy(tree_to_numpy(jax_runs["plant"]),
                                        dtype=F32, device="cpu")
    readings, final = AB3.plain_constant_draws(
        tp, ts, TR.BoundaryConditions(**BC), jax_runs["substeps"], N_STEPS)
    jplant, jreadings = jax_runs["runs"]["no_rand"]
    for name in SENSORS:
        a, b = to_numpy(readings[name]), np.asarray(jreadings[name])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=READ, err_msg=name)
    for f in ("pH", "chlorine", "temperature"):
        np.testing.assert_allclose(to_numpy(getattr(final.reactor, f)),
                                   np.asarray(getattr(jplant.reactor, f)),
                                   rtol=0, atol=PHYS, err_msg=f)
    # the constant draws moved the readings off the random run's
    assert not np.allclose(np.asarray(jreadings["pH_outlet"]),
                           np.asarray(jax_runs["runs"]["full"][1][
                               "pH_outlet"]))


# ---------------------------------------------------------------------------
# the integrated tool against the JAX tool's calls
# ---------------------------------------------------------------------------

PLANTS, STEPS, REPS = 3, 3, 1


@pytest.fixture(scope="module")
def integrated():
    rates, finals = AI.ablate(torch.device("cpu"), PLANTS, STEPS, REPS,
                              torch.float64)
    return {"plant_steps_per_s": rates, "final": finals}


def _jax_tool_calls():
    """``tools/ablate_integrated.py``'s physics and norand calls
    (:78-101), float64, chained over a warm-up and ``REPS`` calls."""
    config = JR.ReactorConfiguration(volume=1000, height=2.0, diameter=0.798,
                                     n_zones=20)
    m, s = JR.default_rkc_plan(config, 1.0, mode="fast")
    bc = JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.2,
                               inlet_chlorine=0.5, acid_flow_rate=0.1)
    params, plant = JPL.make_plant_batch(config, PLANTS, seed=1,
                                         dtype=jnp.float64)
    fn_phys = jax.jit(lambda st: JR.rollout(
        params.reactor, st, bc, dt=1.0, substeps=m, stages=s,
        n_steps=STEPS, record=False)[0])
    rand = {k: (jnp.zeros((PLANTS, nn), jnp.float64),
                jnp.full((PLANTS, nu), 0.5, jnp.float64))
            for k, nn, nu in JPL._RAND_LAYOUT}

    def roll_norand(p):
        def step1(prm, pl, rnd):
            return JPL.plant_step(prm, pl, bc, 1.0, m, stages=s,
                                  rand=rnd)[0]

        def body(pl, _):
            return jax.vmap(step1)(params, pl, rand), None

        return jax.lax.scan(body, p, None, length=STEPS)[0]

    finals = {}
    for name, fn, carry in (("physics", fn_phys, plant.reactor),
                            ("norand", jax.jit(roll_norand), plant)):
        for _ in range(1 + REPS):
            carry = fn(carry)
        finals[name] = carry
    return finals


def test_integrated_tool_matches_the_jax_tools_calls(integrated):
    assert set(integrated["plant_steps_per_s"]) == set(AI.VARIANTS)
    assert all(np.isfinite(v) and v > 0
               for v in integrated["plant_steps_per_s"].values())
    want = _jax_tool_calls()
    finals = integrated["final"]
    assert_tree_close(finals["physics"], want["physics"], atol=ATOL)
    assert_tree_close(finals["norand"].reactor, want["norand"].reactor,
                      atol=ATOL)
    for _, attr, _ in TFP.SENSORS:
        got, ref = getattr(finals["norand"], attr), getattr(want["norand"],
                                                            attr)
        for f in ("current_value", "last_value", "last_timestamp",
                  "status", "fault"):
            a, b = to_numpy(getattr(got.base, f)), np.asarray(
                getattr(ref.base, f))
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                       err_msg=(attr, f))


@pytest.mark.parametrize("variant", ["full", "noline", "tap"])
def test_integrated_instrumented_variants_keep_the_physics(integrated,
                                                           variant):
    physics = integrated["final"]["physics"]
    plant = integrated["final"][variant]
    for f in ("pH", "chlorine", "temperature", "time"):
        np.testing.assert_allclose(to_numpy(getattr(plant.reactor, f)),
                                   to_numpy(getattr(physics, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    for _, attr, _ in TFP.SENSORS:
        assert torch.isfinite(getattr(plant, attr).base.last_value).all(), \
            attr


def test_integrated_main_runs_the_cpu_when_asked(capsys):
    out = AI.main(["--device", "cpu", "--plants", "2", "--steps", "2",
                   "--reps", "1"])
    assert out["device"]["platform"] == "cpu" and out["dtype"] == "float32"
    assert list(out["plant_steps_per_s"]) == list(AI.VARIANTS)
    assert all(np.isfinite(v) and v > 0
               for v in out["plant_steps_per_s"].values())
    assert out["final"]["physics"].pH.dtype == torch.float32
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("# 2 plants x 2 steps, 20 zones")
    assert [line.split()[0] for line in printed[1:]] == list(AI.VARIANTS)


def test_noline_turns_every_sample_line_off():
    from ics_wt_physicsengine_torch.models import plant as TPL

    params, _ = TPL.make_plant(TR.ReactorConfiguration(n_zones=4),
                               device="cpu")
    off = AI.no_lines(params)
    lines = [f.name for f in dataclasses.fields(params)
             if getattr(getattr(params, f.name), "base", None) is not None
             and getattr(params, f.name).base.line_capacity > 0]
    assert lines        # the canonical plant has sample lines to turn off
    for name in lines:
        assert getattr(off, name).base.line_capacity == 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["torch_ablate_fused_plant.py",
                                  "torch_ablate_integrated.py"])
def test_tools_refuse_a_missing_card(tool):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / tool)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert "--device cuda: no CUDA device is available" in proc.stderr
    assert proc.stdout == ""


def test_b3_tool_refuses_the_cpu_with_its_reason(capsys):
    with pytest.raises(SystemExit) as exc:
        AB3.main(["--device", "cpu"])
    assert "no CPU mode" in str(exc.value)
    assert capsys.readouterr().out == ""
