"""The port's Newton pH solve against the JAX package, on the CPU: the plain
version of kernel B4 (``ops.ph_solver.solve_pH_plain``) against the Pallas
kernel in interpret mode (as ``tests/test_ph_solver.py`` runs it), against
the masked-Newton loop and the host's scalar solver, and the wrappers around
them. Waters come from a NumPy seed as ``tests/test_ph_solver.py`` draws
them; both sides get the same float64 constants.

Tolerances. float64, plain version against the interpreted Pallas kernel:
1e-10. The two differ in the step cap's last bit (a table folded in double
against ``exp(i log 0.95)``), which only matters while the cap binds, and
in how a done element keeps its pH (selection against ``pH + 0 * delta``);
both leave differences of a few 1e-15. Against the loop (``10 ** -pH``
instead of ``exp(-ln10 pH)``) and the host solver: 2e-6, the JAX test's own
tolerance. float32: see ``test_float32_...``.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_wt_physicsengine_tpu.core import chemistry as jchem
from ics_wt_physicsengine_tpu.ops import ph_solver as jph

from ics_wt_physicsengine_torch import convert
from ics_wt_physicsengine_torch.core import chemistry as tchem
from ics_wt_physicsengine_torch.ops import kernel_checks as K
from ics_wt_physicsengine_torch.ops import ph_solver as PS

torch.set_num_threads(1)

F64 = torch.float64
KERNEL_ATOL = 1e-10
LOOP_ATOL = 2e-6
# A solve whose charge balance does not close (a water with more alkalinity
# than its carbonate can carry has no root; a large shift may leave Newton,
# started from the unshifted pH, short of one) ends where the last capped
# steps leave it. That path amplifies the last-bit differences of
# ``10 ** x`` between the two packages, so two such ends may lie a few last
# caps (``2 * 0.95 ** 99`` = 1.25e-2) apart. Seen at +-1 meq/L on the
# Monte-Carlo waters: 121 of 2048 solves unclosed, the same 121 in both
# packages, residuals >= 4.5e-7 eq/L against <= 4.5e-15 for the closed
# ones; 114 of them within 1e-6 of each other, the largest gap 2.5e-2.
UNCLOSED_ATOL = 5e-2


def _waters(shape, dtype=np.float64):
    """The same waters for both packages: ``(jax constants, port
    constants, numpy values)``."""
    n = int(np.prod(shape))
    values = {name: np.asarray(v, dtype).reshape(shape)
              for name, v in K.ph_waters_numpy(n).items()}
    jk = jchem.ChemistryConstants(**{name: jnp.asarray(v)
                                     for name, v in values.items()})
    tk = convert.chemistry_constants_from_numpy(
        values, dtype=torch.from_numpy(values["Kw"]).dtype, device="cpu")
    return jk, tk, values


@pytest.mark.parametrize("shape", [(1,), (7,), (129,), (1025,), (4, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_the_interpreted_pallas_kernel(shape):
    jk, tk, _ = _waters(shape)
    ref = np.asarray(jph.solve_pH_pallas(
        jk, jnp.full(shape, 7.0, jnp.float64), interpret=True))
    got = PS.solve_pH_plain(tk, torch.full(shape, 7.0, dtype=F64))
    assert got.shape == shape and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=KERNEL_ATOL)


@pytest.mark.parametrize("n", [7, 300])
def test_plain_matches_the_loop_of_both_packages(n):
    jk, tk, _ = _waters((n,))
    got = PS.solve_pH_plain(tk, torch.full((n,), 7.0, dtype=F64)).numpy()
    loop_jax = np.asarray(jchem.solve_pH(jk, jnp.full(n, 7.0, jnp.float64)))
    loop_port = tchem.solve_pH(tk, torch.full((n,), 7.0, dtype=F64)).numpy()
    np.testing.assert_allclose(got, loop_jax, rtol=0, atol=LOOP_ATOL)
    np.testing.assert_allclose(got, loop_port, rtol=0, atol=LOOP_ATOL)
    # the port's loop is the JAX loop, operation for operation
    np.testing.assert_allclose(loop_port, loop_jax, rtol=0, atol=KERNEL_ATOL)


def test_plain_and_host_solvers_agree_with_the_jax_host_solver():
    _, tk, values = _waters((16,))
    got = PS.solve_pH_plain(tk, torch.full((16,), 7.0, dtype=F64)).numpy()
    for i in range(16):
        one = {name: v[i] for name, v in values.items()}
        host_jax = jchem.solve_pH_host(jchem.ChemistryConstants(**one))
        host_port = tchem.solve_pH_host(tchem.ChemistryConstants(**one))
        assert abs(host_port - host_jax) <= 1e-12
        assert abs(got[i] - host_jax) <= LOOP_ATOL


def test_host_solver_raises_as_the_reference_does():
    _, _, values = _waters((1,))
    one = tchem.ChemistryConstants(**{n: v[0] for n, v in values.items()})
    with pytest.raises(RuntimeError, match="did not converge"):
        tchem.solve_pH_host(one, max_iter=1)
    flat = dataclasses.replace(one, Kw=0.0, C_T_mol=0.0)
    with pytest.raises(RuntimeError, match="Derivative too small"):
        tchem.solve_pH_host(flat, initial_guess=20.0)


def test_float32_agrees_within_the_documented_floor():
    """float32: a tolerance of 1e-6 lies below the resolution of pH near the
    root, so an element that cannot meet it keeps stepping inside the
    decayed cap, up to ~1e-2 (the JAX docstring's figure;
    ``2 * 0.95 ** 99`` = 1.25e-2 is the cap of the last iteration). Most
    elements converge: the plain version is held to 2.5e-2 everywhere, to
    1e-5 on at least 98% of the waters against its own float64 result, and
    to 2.5e-2 against the interpreted Pallas kernel in float32 (two
    non-converged elements need not step alike)."""
    n = 1025
    jk32, tk32, _ = _waters((n,), np.float32)
    _, tk64, _ = _waters((n,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = PS.solve_pH_kernel(tk32, torch.full((n,), 7.0))
    assert got.dtype == torch.float32
    wide = PS.solve_pH_plain(tk64, torch.full((n,), 7.0, dtype=F64))
    gap = (got.double() - wide).abs().numpy()
    assert gap.max() <= 2.5e-2
    share = float((gap < 1e-5).mean())
    assert share >= 0.98, share
    ref = np.asarray(jph.solve_pH_pallas(
        jk32, jnp.full(n, 7.0, jnp.float32), interpret=True))
    assert ref.dtype == np.float32
    assert np.abs(got.numpy() - ref).max() <= 2.5e-2
    assert float((np.abs(got.numpy() - ref) < 1e-5).mean()) >= 0.98


def test_float32_guess_below_resolution_warns():
    _, tk32, _ = _waters((7,), np.float32)
    with pytest.warns(RuntimeWarning, match="below float32 resolution"):
        PS.solve_pH_kernel(tk32, torch.full((7,), 7.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        PS.solve_pH_kernel(tk32, torch.full((7,), 7.0), tolerance=1e-5)
        _, tk64, _ = _waters((7,))
        PS.solve_pH_kernel(tk64, torch.full((7,), 7.0, dtype=F64))
        PS.solve_pH_auto(tk32, torch.full((7,), 7.0))


def test_kernel_wrapper_on_cpu_tensors_is_the_plain_version():
    _, tk, _ = _waters((4, 6))
    ph0 = torch.full((4, 6), 7.0, dtype=F64)
    PS.reset_launch_counts()
    assert torch.equal(PS.solve_pH_kernel(tk, ph0),
                       PS.solve_pH_plain(tk, ph0))
    assert PS.LAUNCHES == {"solve_pH_kernel": 0}


def test_auto_on_cpu_tensors_is_the_ports_loop():
    _, tk, _ = _waters((129,))
    ph0 = torch.full((129,), 7.0, dtype=F64)
    assert torch.equal(PS.solve_pH_auto(tk, ph0), tchem.solve_pH(tk, ph0))
    assert torch.equal(PS.solve_pH_auto(tk, 7.0), tchem.solve_pH(tk, 7.0))
    short = PS.solve_pH_auto(tk, ph0, iters=3, tolerance=1e-3)
    assert torch.equal(short, tchem.solve_pH(tk, ph0, tolerance=1e-3,
                                             max_iter=3))


def test_iters_and_tolerance_are_honoured():
    jk, tk, _ = _waters((129,))
    got = PS.solve_pH_plain(tk, torch.full((129,), 7.0, dtype=F64), iters=5,
                            tolerance=1e-3)
    ref = np.asarray(jph.solve_pH_pallas(
        jk, jnp.full(129, 7.0, jnp.float64), iters=5, tolerance=1e-3,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=KERNEL_ATOL)
    assert torch.equal(
        PS.solve_pH_plain(tk, torch.full((129,), 7.3, dtype=F64), iters=0),
        torch.full((129,), 7.3, dtype=F64))


def test_constants_and_guess_broadcast_to_one_shape():
    _, tk, _ = _waters((5,))
    column = dataclasses.replace(
        tk, **{f.name: getattr(tk, f.name)[:, None]
               for f in dataclasses.fields(tk)})
    guess = torch.linspace(6.5, 8.0, 3, dtype=F64)
    out = PS.solve_pH_plain(column, guess)
    assert out.shape == (5, 3)
    for j in range(3):
        np.testing.assert_allclose(
            out[:, j].numpy(),
            PS.solve_pH_plain(tk, torch.full((5,), float(guess[j]),
                                             dtype=F64)).numpy(),
            rtol=0, atol=0)
    assert PS.solve_pH_plain(tk, 7.0).shape == (5,)


def test_degenerate_waters_keep_nan_in_place():
    for dtype in (F64, torch.float32):
        k = K.ph_waters((300,), dtype, "cpu", degenerate=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = PS.solve_pH_kernel(k, torch.full((300,), 7.0, dtype=dtype))
        assert torch.isnan(got[1:3]).all()
        assert int(torch.isnan(got).sum()) == 2
        # pure water: the neutral pH of its temperature, 0.5 pKw
        assert abs(float(got[0]) + 0.5 * np.log10(float(k.Kw[0]))) < 1e-5


@pytest.mark.parametrize("n_plants,n_shifts", [(1, 1), (7, 5), (33, 16)])
def test_ph_after_alkalinity_shift_matches_jax(n_plants, n_shifts):
    """On CPU tensors the shift re-solves through the port's loop."""
    shape = (n_plants, 1)
    jk, tk, _ = _waters(shape)
    shifts = np.linspace(-2e-4, 2e-4, n_shifts)
    current = np.linspace(7.0, 7.6, n_plants).reshape(shape)
    # the JAX loop carries the guess's shape, so it gets the guess already
    # broadcast; the port broadcasts by itself
    ref = np.asarray(jchem.pH_after_alkalinity_shift(
        jk, jnp.asarray(shifts),
        jnp.asarray(np.broadcast_to(current, (n_plants, n_shifts)))))
    got = tchem.pH_after_alkalinity_shift(
        tk, torch.from_numpy(shifts), torch.from_numpy(current))
    assert got.shape == (n_plants, n_shifts)
    shifted = dataclasses.replace(tk, alk_eq=tk.alk_eq
                                  + torch.from_numpy(shifts))
    # at +-0.2 meq/L the one unclosed solve (7 x 5, plant 4) differs by 2.3e-9
    _same_solves(got, ref, shifted, unclosed_atol=1e-8)


def _same_solves(got, ref, shifted, unclosed_atol=UNCLOSED_ATOL):
    """The port's solves ``got`` against the JAX package's ``ref`` for the
    waters ``shifted``: the same elements fail to close the charge balance
    on both sides, every closed one agrees within ``KERNEL_ATOL`` and the
    unclosed ones within ``unclosed_atol``. Returns the unclosed mask and
    the gaps."""
    def unclosed(curve):
        residual = tchem.charge_balance_error(torch.from_numpy(curve),
                                              shifted)
        return (residual.abs() >= K.PH_RESIDUAL_TOL[F64]).numpy()

    ref = np.array(ref)
    mask = unclosed(ref)
    assert np.array_equal(unclosed(got.numpy()), mask)
    gap = np.abs(got.numpy() - ref)
    assert gap[~mask].max(initial=0.0) <= KERNEL_ATOL
    assert gap[mask].max(initial=0.0) <= unclosed_atol
    return mask, gap


def test_titration_of_the_monte_carlo_waters_matches_jax():
    """The waters and shifts of PH-TITR (``titration_waters``, +-1 meq/L)
    at 64 plants x 32 shifts, element by element against the JAX package,
    the solves that do not close included: the same elements fail to close
    the charge balance in both packages, every closed solve agrees at 1e-10
    and the unclosed ones within ``UNCLOSED_ATOL``."""
    k, shifts = K.titration_waters(64, 32, F64, "cpu")
    jk = jchem.ChemistryConstants(**{
        f.name: jnp.asarray(getattr(k, f.name).numpy())
        for f in dataclasses.fields(k)})
    base_j = jchem.solve_pH(jk, jnp.full((64, 1), 7.0, jnp.float64))
    base_t = PS.solve_pH_auto(k, 7.0)
    np.testing.assert_allclose(base_t.numpy(), np.asarray(base_j), rtol=0,
                               atol=KERNEL_ATOL)
    ref = np.asarray(jchem.pH_after_alkalinity_shift(
        jk, jnp.asarray(shifts.numpy()),
        jnp.broadcast_to(base_j, (64, 32))))
    got = tchem.pH_after_alkalinity_shift(k, shifts, base_t)
    assert got.shape == (64, 32)

    mask, gap = _same_solves(
        got, ref, dataclasses.replace(k, alk_eq=k.alk_eq + shifts))
    # the share that the check on the card allows for is the model's own
    assert 0.05 < mask.mean() < 0.07, mask.mean()
    assert float((gap[mask] <= 1e-6).mean()) >= 0.9


def test_titration_check_on_a_small_titration():
    """The check ``chip_smoke.py`` applies to PH-TITR, on 64 plants x 32
    shifts: most solves close the charge balance and closed neighbours
    rise with the shift; a curve reversed in the shift does not pass."""
    k, shifts = K.titration_waters(64, 32, F64, "cpu")
    curve = tchem.pH_after_alkalinity_shift(k, shifts,
                                            PS.solve_pH_auto(k, 7.0))
    verdict = K.titration_check(k, shifts, curve)
    assert verdict["finite"] and verdict["in_range"] and verdict["rising"]
    assert verdict["enough"], verdict
    wrong = K.titration_check(k, shifts, curve.flip(1))
    assert not wrong["rising"] or wrong["closed_share"] < 0.5


def test_inputs_on_different_devices_raise():
    """Constants on one device and a guess on another never solve on
    either: no input is copied across (the ``meta`` device stands in for
    the card here). A 0-dim CPU tensor is a scalar and follows the rest."""
    _, tk, _ = _waters((7,))
    elsewhere = torch.full((7,), 7.0, dtype=F64, device="meta")
    for solve in (PS.solve_pH_kernel, PS.solve_pH_auto, PS.solve_pH_plain):
        with pytest.raises(ValueError, match="different devices"):
            solve(tk, elsewhere)
    with pytest.raises(ValueError, match="different devices"):
        PS.solve_pH_auto(dataclasses.replace(tk, Kw=tk.Kw.to("meta")), 7.0)
    assert PS.inputs_device(tk, torch.tensor(7.0)) == torch.device("cpu")
    moved = dataclasses.replace(tk, **{
        f.name: getattr(tk, f.name).to("meta")
        for f in dataclasses.fields(tk)})
    assert PS.inputs_device(moved, torch.tensor(7.0)).type == "meta"
    assert PS.inputs_device(moved, 7.0).type == "meta"
    assert torch.equal(PS.solve_pH_auto(tk, torch.tensor(7.0, dtype=F64)),
                       tchem.solve_pH(tk, 7.0))


def test_launcher_refuses_cpu_tensors_and_bad_inputs():
    _, tk, _ = _waters((7,))
    args, _ = PS.broadcast_inputs(tk, torch.full((7,), 7.0, dtype=F64))
    with pytest.raises(ValueError, match="CUDA"):
        PS.ph_kernel(*args)
    assert PS.LAUNCHES["solve_pH_kernel"] == 0


def test_a_cuda_request_without_a_card_raises():
    """No fallback: asking for the card's path on a machine without one
    raises instead of solving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchem.make_chemistry_constants(100.0, 2.0, 20.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.ph_waters((4,), F64, None)


def test_op_and_byte_counts():
    assert PS.ph_ops(65536) == 65536 * 100 * PS.PH_OPS
    assert PS.ph_bytes(65536, 4) == (7 * 65536 + 100) * 4
    caps = PS.step_caps(100)
    assert caps[0] == 2.0 and caps[99] == 2.0 * 0.95 ** 99
    assert tchem.MAX_ITERATIONS == jchem.MAX_ITERATIONS == PS.DEFAULT_ITERS
    assert tchem.PH_TOLERANCE == jchem.PH_TOLERANCE
