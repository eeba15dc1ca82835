"""The port's surrogate studies (``examples_torch/surrogate_mpc.py``,
``surrogate_from_historian.py``) on the CPU, against the JAX examples, with
the JAX side's random draws injected into the port.

Everything slow starts together when the first test asks for it: the two
JAX examples and two runs of the port's historian, each a subprocess with a
600 s timeout (an EKF-bank tick of the port takes ~0.7 s on this CPU:
``torch.func.jacfwd`` through six RK4 substeps), while the surrogate_mpc
tests run here and the JAX historian loop is rebuilt here.

- ``surrogate_from_historian`` at the JAX test's ``--lanes 8 --steps 120
  --burn 20 --train-steps 400 --rollout-steps 50 --mpc-minutes 0``. JAX's
  draws are computed here as the JAX example makes them: the dose levels
  (``jax.random.uniform(PRNGKey(7), (8, 12))``), every tick's instrument
  draws (each lane's seven sensor keys from ``make_plant_batch(seed=0)``,
  split by ``sensors.base.draw_read_rand`` as each read splits them) and
  ``train_surrogate``'s (``PRNGKey(1)``: the initial weights, the
  minibatch indices and phase 2's windows, as ``train_surrogate`` draws
  them with its int32 indices). Stages: the port's commissioning and
  historian in float64 (``setup``, ``commission``, ``historian``) against
  the JAX example's loop rebuilt here in float64 (examples/
  surrogate_from_historian.py:109-201, the same draws): the calibration
  ``a`` and ``b`` within 1e-11 relative + 1e-11, the estimates ``Xhat`` and the true states
  ``Xtrue`` of every tick within 1e-9 relative + 1e-12 (float32 lies 8 ulp
  apart at the first tick). The JSON: the port's ``main`` (float32, the
  JAX example's type) with all of JAX's draws against the JAX example's
  printed JSON: the same keys, lanes and ticks; the EKF's mid-zone RMSE
  within 2e-4 mg/L (two units of its printed rounding), the abs RMSE of pH
  and temperature within 2e-5 and the chlorine skill within 0.01 (400 +
  50 float32 Adam steps on two packages' roundings: 0.893 against 0.895
  when written).
- ``surrogate_mpc`` at the JAX test's ``--traj 48 --minutes 15
  --train-steps 400 --rollout-steps 50``, both MPCs cut to 2 Adam
  iterations a re-plan on both sides (the JAX example through ``python -c``
  code that wraps ``control.run_mpc``, ``control.run_mpc_output_feedback``,
  ``control.mpc.run_mpc`` and ``models.surrogate.run_mpc_surrogate``,
  then runs it with ``runpy``; it also keeps what ``fit_plant_surrogate``
  returned and the held-out set, saved to a file; no JAX file changes). The
  port's ``validate`` and ``compare_mpc`` on JAX's fitted surrogate
  (``convert.surrogate_params_from_numpy``) and JAX's held-out set: the
  skill within 2e-3 (its printed rounding and float32), the drift within
  1e-4 mg/L, both MPC scores within 1e-4 relative. Then the port's own fit
  (its generator's draws) at those arguments: finite losses, the JSON's
  keys as JAX's, every value finite.
"""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.control import ekf as JEKF
from ics_wt_physicsengine_tpu.core import reactor as JR
from ics_wt_physicsengine_tpu.models import plant as JPL
from ics_wt_physicsengine_tpu.models import surrogate as JSG
from ics_wt_physicsengine_tpu.sensors import base as JB

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, REPO)

from examples_torch import surrogate_from_historian as H  # noqa: E402
from examples_torch import surrogate_mpc as SM  # noqa: E402
from ics_wt_physicsengine_torch import convert  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
HIST_ARGS = ["--lanes", "8", "--steps", "120", "--burn", "20",
             "--train-steps", "400", "--rollout-steps", "50",
             "--mpc-minutes", "0"]
SM_ARGS = ["--traj", "48", "--minutes", "15", "--train-steps", "400",
           "--rollout-steps", "50"]
MPC_ITERS = 2
TIMEOUT_S = 600
# the reading name of each instrument -> its PlantState attribute
SENSORS = {"pH_inlet": "ph_inlet", "pH_outlet": "ph_outlet",
           "chlorine_inlet": "chlorine_inlet",
           "chlorine_outlet": "chlorine_outlet", "flow_main": "flow_main",
           "temp_inlet": "temp_inlet", "temp_outlet": "temp_outlet"}
_STATS = ("x_mean", "x_std", "u_scale", "r_mean", "r_std", "lo", "hi")
# runs a JAX example with every MPC's Adam iterations forced to argv[1],
# then saves what fit_plant_surrogate returned and the last dataset made
# (the example's held-out set) to argv[2]
CUT_AND_KEEP = """
import functools, runpy, sys
import numpy as np
iters, path, script = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.argv = sys.argv[3:]
from ics_wt_physicsengine_tpu import control
from ics_wt_physicsengine_tpu.control import mpc
from ics_wt_physicsengine_tpu.models import surrogate

def cut(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        kwargs["iters"] = iters
        return fn(*args, **kwargs)
    return run

kept = {}

def keep(name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        kept[name] = fn(*args, **kwargs)
        return kept[name]
    return run

for module, name in ((control, "run_mpc"),
                     (control, "run_mpc_output_feedback"),
                     (mpc, "run_mpc"), (surrogate, "run_mpc_surrogate")):
    setattr(module, name, cut(getattr(module, name)))
surrogate.fit_plant_surrogate = keep("fit", surrogate.fit_plant_surrogate)
surrogate.make_surrogate_dataset = keep("data",
                                        surrogate.make_surrogate_dataset)
runpy.run_path(script, run_name="__main__")
sp = kept["fit"][0]
arrays = {f"w{i}": np.asarray(w) for i, w in enumerate(sp.weights)}
arrays.update({name: np.asarray(getattr(sp, name)) for name in
               ("x_mean", "x_std", "u_scale", "r_mean", "r_std", "lo",
                "hi")})
np.savez(path, Xv=np.asarray(kept["data"][0]),
         Uv=np.asarray(kept["data"][1]), **arrays)
"""


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


class Run:
    """A subprocess started now; ``stdout()`` waits for it."""

    def __init__(self, name, cmd):
        self.name = name
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        self.out = None

    def stdout(self):
        if self.out is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, (self.name, out[-2000:],
                                               err[-2000:])
            self.out = out
        return self.out

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# JAX's draws for the historian
# ---------------------------------------------------------------------------

def jax_historian_draws(lanes, steps, hold, burn, train_steps,
                        rollout_steps, zones=6):
    """Every draw the JAX example makes, as NumPy: ``dose_levels``,
    ``rand`` (each tick's ``{reading: (normals [L, k], uniforms [L, k])}``,
    the commissioning's ticks first), ``init_weights``, ``batch_indices``
    and ``rollout_indices``."""
    f32 = jnp.float32
    levels = np.array(jax.random.uniform(
        jax.random.PRNGKey(H.DOSE_SEED), (lanes, -(-steps // hold)), f32))
    _, plant = JPL.make_plant_batch(H.make_config(zones), lanes,
                                    seed=H.PLANT_SEED, dtype=f32,
                                    randomize=False, warmed_up=True)
    keys = {name: getattr(plant, attr).base.key
            for name, attr in SENSORS.items()}
    widths = {name: (nn - JB.BASE_NORMALS, nu - JB.BASE_UNIFORMS)
              for name, nn, nu in JPL._RAND_LAYOUT}

    @jax.jit
    def tick(keys):
        new, rand = {}, {}
        for name, (extra_n, extra_u) in widths.items():
            new[name], n, u = jax.vmap(lambda k: JB.draw_read_rand(
                k, f32, extra_n, extra_u))(keys[name])
            rand[name] = (n, u)
        return new, rand

    rand = []
    for _ in range(2 * max(2 * hold, 20) + steps):
        keys, r = tick(keys)
        rand.append({k: (np.array(n), np.array(u))
                     for k, (n, u) in r.items()})
    # train_surrogate(..., PRNGKey(1)): T = lanes trajectories of
    # S = steps - burn transitions, batch 2048, horizon 8
    T, S, n, H_ = lanes, steps - burn, 3 * zones, 8
    key, k_w = jax.random.split(jax.random.PRNGKey(H.TRAIN_SEED))
    weights = JSG._init_mlp(k_w, (n + 1, 128, 128, n), f32)
    k1 = jax.random.fold_in(key, 1)
    idx = np.stack([np.array(jax.random.randint(
        jax.random.fold_in(k1, i), (2048,), 0, T * S, dtype=jnp.int32))
        for i in range(train_steps)])
    k2 = jax.random.fold_in(key, 2)
    ks = [jax.random.fold_in(k2, i) for i in range(rollout_steps)]
    ti = np.stack([np.array(jax.random.randint(
        jax.random.fold_in(k, 0), (2048 // H_,), 0, T, dtype=jnp.int32))
        for k in ks])
    si = np.stack([np.array(jax.random.randint(
        jax.random.fold_in(k, 1), (2048 // H_,), 0, S - H_ + 1,
        dtype=jnp.int32)) for k in ks])
    return dict(dose_levels=levels, rand=rand,
                init_weights=[np.array(w) for w in weights],
                batch_indices=idx, rollout_indices=(ti, si))


def _torch_rand(rand, dtype):
    return [{k: tuple(torch.from_numpy(x).to(dtype) for x in v)
             for k, v in r.items()} for r in rand]


def port_child(argv):
    """The port's historian in a process of its own (``python -c``):
    ``mode`` ``main`` runs ``main`` with the draws (float32, printing its
    JSON); ``stages`` runs the commissioning and the historian in float64
    and saves ``a``, ``b``, ``Xhat`` and ``Xtrue`` to ``out``."""
    draws_path, mode, out, *args = argv
    with open(draws_path, "rb") as f:
        draws = pickle.load(f)
    if mode == "main":
        draws["rand"] = _torch_rand(draws["rand"], torch.float32)
        H.main(args, draws=draws)
        return
    a, b, Xhat, Xtrue = historian_stages(H.parse_args(args), draws, F64)
    np.savez(out, a=a.numpy(), b=b.numpy(), Xhat=Xhat.numpy(),
             Xtrue=Xtrue.numpy())


def historian_stages(args, draws, dtype):
    """The port's commissioning and historian on the CPU in ``dtype`` with
    the given draws."""
    ctx = H.setup(args, CPU, dtype)
    rand = _torch_rand(draws["rand"], dtype)
    n_cal = 2 * ctx.ticks
    u_seq = H.excitation(torch.from_numpy(draws["dose_levels"]).to(dtype),
                         args.hold, args.steps)
    plant, a, b = H.commission(ctx, ctx.plant, rand[:n_cal])
    Xhat, Xtrue = H.historian(ctx, plant, u_seq, a, b, rand[n_cal:])
    return a, b, Xhat, Xtrue


def _port_run(draws_path, mode, out, args):
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from test_torch_examples_surrogate import port_child; "
            "port_child(sys.argv[3:])")
    return Run(f"port {mode}", [sys.executable, "-c", code, TESTS, REPO,
                                draws_path, mode, out] + args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surrogate_examples")
    args = H.parse_args(["--device", "cpu"] + HIST_ARGS)
    draws = jax_historian_draws(args.lanes, args.steps, args.hold,
                                args.burn, args.train_steps,
                                args.rollout_steps)
    draws_path = str(tmp / "draws.pkl")
    with open(draws_path, "wb") as f:
        pickle.dump(draws, f)
    started = {"draws": draws, "kept": str(tmp / "kept.npz"),
               "stages": str(tmp / "stages.npz")}
    procs = {
        "jax_hist": Run("historian", [
            sys.executable,
            os.path.join(REPO, "examples", "surrogate_from_historian.py"),
            "--cpu"] + HIST_ARGS),
        "jax_sm": Run("surrogate_mpc", [
            sys.executable, "-c", CUT_AND_KEEP, str(MPC_ITERS),
            started["kept"], os.path.join(REPO, "examples",
                                          "surrogate_mpc.py"),
            "--cpu"] + SM_ARGS),
        "port_main": _port_run(draws_path, "main", "-",
                               ["--device", "cpu"] + HIST_ARGS),
        "port_stages": _port_run(draws_path, "stages", started["stages"],
                                 ["--device", "cpu"] + HIST_ARGS)}
    started.update(procs)
    yield started
    for proc in procs.values():
        proc.stop()


# ---------------------------------------------------------------------------
# surrogate_mpc
# ---------------------------------------------------------------------------

def test_surrogate_mpc_fits_on_the_cpu(runs, monkeypatch, capsys):
    infos = []
    fit = SM.SG.fit_plant_surrogate

    def kept_fit(*args, **kwargs):
        sp, info = fit(*args, **kwargs)
        infos.append(info)
        return sp, info

    monkeypatch.setattr(SM.SG, "fit_plant_surrogate", kept_fit)
    got = SM.main(["--device", "cpu"] + SM_ARGS,
                  mpc=SM.MPC[:2] + (MPC_ITERS,))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    want = _last_json(runs["jax_sm"].stdout())
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert set(got[key]) == set(value), key
    (info,) = infos
    assert info["one_step_loss"].shape == (400,)
    assert info["rollout_loss"].shape == (50,)
    for name in ("one_step_loss", "rollout_loss"):
        assert bool(torch.isfinite(info[name]).all()), name

    def numbers(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in numbers(v)]
        return [tree] if isinstance(tree, float) else []

    assert all(math.isfinite(x) for x in numbers(got))
    assert SM.MPC == (4, 15, 20)


def test_surrogate_mpc_on_the_jax_fit_matches_the_jax_example(runs):
    want = _last_json(runs["jax_sm"].stdout())
    kept = np.load(runs["kept"])
    n_weights = len([k for k in kept.files if k.startswith("w")])
    sp = convert.surrogate_params_from_numpy(
        {"weights": [kept[f"w{i}"] for i in range(n_weights)],
         **{name: kept[name] for name in _STATS}},
        dtype=torch.float32, device=CPU)
    Xv, Uv = (torch.from_numpy(kept[k]) for k in ("Xv", "Uv"))
    assert tuple(Xv.shape) == (32, 49, 18) and tuple(Uv.shape) == (32, 48, 1)
    skill, drift = SM.validate(sp, Xv, Uv, 6)
    assert set(skill) == set(want["one_step_skill_vs_identity"])
    for field, value in want["one_step_skill_vs_identity"].items():
        assert skill[field] == pytest.approx(value, abs=2e-3), field
    assert drift == pytest.approx(want["open_loop_drift_chlorine_mgL"],
                                  abs=1e-4)
    sur, phys, _, _ = SM.compare_mpc(SM.make_config(6), sp,
                                     SM.step_program(15), CPU,
                                     mpc=SM.MPC[:2] + (MPC_ITERS,))
    assert sur["score"] == pytest.approx(want["surrogate_mpc"]["score_ISE"],
                                         rel=1e-4)
    assert phys["score"] == pytest.approx(want["physics_mpc"]["score_ISE"],
                                          rel=1e-4)


# ---------------------------------------------------------------------------
# surrogate_from_historian
# ---------------------------------------------------------------------------

def _jax_historian_stages(args, draws):
    """The JAX example's commissioning and historian loop in float64
    (examples/surrogate_from_historian.py:109-201) with ``draws``
    injected: ``a``, ``b``, ``Xhat`` and ``Xtrue``."""
    dtype = jnp.float64
    L, S, Z, dt = args.lanes, args.steps, args.zones, H.DT
    config = H.make_config(Z)
    substeps = JR.default_substeps(config, dt)
    pparams, plant = JPL.make_plant_batch(config, L, seed=0, dtype=dtype,
                                          randomize=False, warmed_up=True)
    ekf_step = JEKF.make_ekf(JR.make_params(config, dtype=dtype), Z,
                             H.TAPS, dt, substeps,
                             process_noise=(1e-7, 1e-4, 1e-5),
                             measurement_noise=H.MEAS_NOISE)
    carry1 = JEKF.make_ekf_carry(JR.make_initial_state(config, dtype=dtype),
                                 p0=(0.05, 1.0, 4.0), n_zones=Z)
    ekf = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (L,) + a.shape).copy(), carry1)
    bc0 = JR.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.5,
                                inlet_chlorine=0.5, inlet_temperature=18.0)
    bc_lanes = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (L,)).copy(), bc0)
    tap_cols = jnp.asarray([JEKF.tap_index(f, z, Z) for f, z in H.TAPS])
    rand = [{k: tuple(jnp.asarray(x, dtype) for x in v)
             for k, v in r.items()} for r in draws["rand"]]
    u_seq = jnp.repeat(jnp.asarray(draws["dose_levels"], dtype), args.hold,
                       axis=1)[:, :S]

    @jax.jit
    def raw_tick(pl, u_t, r):
        bc = dataclasses.replace(bc_lanes, chlorine_flow_rate=u_t)
        pl, readings = JPL.plant_step_batched(pparams, pl, bc, dt, substeps,
                                              rand=r, boundary_axes=0)
        z = jnp.stack([readings[nm].value for nm in H.MEASURED], axis=-1)
        return pl, z, JEKF.flatten_state(pl.reactor)[:, tap_cols]

    C = max(2 * args.hold, 20)
    means = []
    for k, level in enumerate(H.COMMISSION_LEVELS):
        zs, ys = [], []
        for t in range(C):
            plant, z, y = raw_tick(plant, jnp.full((L,), level, dtype),
                                   rand[k * C + t])
            zs.append(z)
            ys.append(y)
        means.append((jnp.mean(jnp.stack(zs[C // 2:]), axis=0),
                      jnp.mean(jnp.stack(ys[C // 2:]), axis=0)))
    (z_lo, y_lo), (z_hi, y_hi) = means
    dy = y_hi - y_lo
    movable = jnp.abs(dy) > 0.05
    a = jnp.where(movable, (z_hi - z_lo) / jnp.where(movable, dy, 1.0), 1.0)
    b = jnp.where(movable, z_lo - a * y_lo,
                  0.5 * (z_lo - y_lo + z_hi - y_hi))

    @jax.jit
    def tick(pl, ekf, u_t, r):
        bc = dataclasses.replace(bc_lanes, chlorine_flow_rate=u_t)
        pl, readings = JPL.plant_step_batched(pparams, pl, bc, dt, substeps,
                                              rand=r, boundary_axes=0)
        z_raw = jnp.stack([readings[nm].value for nm in H.MEASURED],
                          axis=-1)
        ekf, x_hat = jax.vmap(ekf_step)(ekf, (z_raw - b) / a, bc)
        return pl, ekf, x_hat, JEKF.flatten_state(pl.reactor)

    xhat, xtrue = [], []
    for t in range(S):
        plant, ekf, x_hat, x_true = tick(plant, ekf, u_seq[:, t],
                                         rand[2 * C + t])
        xhat.append(x_hat)
        xtrue.append(x_true)
    return (np.asarray(a), np.asarray(b), np.stack(xhat, axis=1),
            np.stack(xtrue, axis=1))


def test_historian_main_prints_what_it_returns(capsys):
    got = H.main(["--device", "cpu", "--lanes", "2", "--steps", "4",
                  "--burn", "1", "--train-steps", "3", "--rollout-steps",
                  "0", "--mpc-minutes", "8"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert set(got) == {"historian", "fit_seconds",
                        "true_one_step_skill_vs_identity",
                        "true_one_step_abs_rmse",
                        "surrogate_mpc_on_true_plant"}
    assert got["historian"]["lanes"] == 2 and got["historian"]["ticks"] == 4
    mpc = got["surrogate_mpc_on_true_plant"]
    assert mpc["target_mgL"] == 2.5
    assert math.isfinite(mpc["tail_mean_abs_err_mgL"])
    assert math.isfinite(got["true_one_step_skill_vs_identity"]["chlorine"])


@pytest.mark.parametrize("burn", ["0", "4"])
def test_historian_refuses_a_burn_in_outside_the_run(burn):
    with pytest.raises(SystemExit, match=r"--burn must be in \[1, --steps\)"):
        H.parse_args(["--steps", "4", "--burn", burn])


def test_historian_draws_come_from_their_seeds():
    levels = H.dose_levels(3, 4, CPU)
    want = torch.rand((3, 4), generator=torch.Generator().manual_seed(7))
    assert torch.equal(levels, want)
    u = H.excitation(levels, 3, 10)
    assert u.shape == (3, 10)
    assert torch.equal(u[:, :3], levels[:, :1].expand(3, 3))
    assert torch.equal(u[:, 9], levels[:, 3])


def test_historian_stages_match_jax_in_float64(runs):
    args = H.parse_args(["--device", "cpu"] + HIST_ARGS)
    want = _jax_historian_stages(args, runs["draws"])
    runs["port_stages"].stdout()
    got = np.load(runs["stages"])
    for name, w in zip(("a", "b"), want[:2]):
        assert got[name].shape == w.shape == (8, 5), name
        np.testing.assert_allclose(got[name], w, rtol=1e-11, atol=1e-11,
                                   err_msg=name)
    # the dose moves the chlorine channels (a fitted gain) and not pH (a
    # single-point offset)
    assert (got["a"][:, 2:4] != 1.0).all() and (got["a"][:, :2]
                                               == 1.0).all()
    for name, w in zip(("Xhat", "Xtrue"), want[2:]):
        assert got[name].shape == w.shape == (8, 120, 18), name
        np.testing.assert_allclose(got[name], w, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_historian_json_with_jax_draws_matches_the_jax_example(runs):
    got = _last_json(runs["port_main"].stdout())
    want = _last_json(runs["jax_hist"].stdout())
    assert set(got) == set(want)
    for part in ("historian", "true_one_step_skill_vs_identity",
                 "true_one_step_abs_rmse"):
        assert set(got[part]) == set(want[part]), part
    assert got["historian"]["lanes"] == want["historian"]["lanes"] == 8
    assert got["historian"]["ticks"] == want["historian"]["ticks"] == 120
    assert got["historian"]["ekf_midzone_cl_rmse_mgL"] == pytest.approx(
        want["historian"]["ekf_midzone_cl_rmse_mgL"], abs=2e-4)
    for name, value in want["true_one_step_abs_rmse"].items():
        assert got["true_one_step_abs_rmse"][name] == pytest.approx(
            value, abs=2e-5), name
    assert got["true_one_step_skill_vs_identity"]["chlorine"] == \
        pytest.approx(want["true_one_step_skill_vs_identity"]["chlorine"],
                      abs=0.01)
