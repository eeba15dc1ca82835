"""The float32 divisions of the shared physics (``csrc/fused_rollout.cuh``):
``div_fast`` and the per-plant window check that chooses it.

On the CPU: the windows in the header equal their mirror in
``ops/fused_rollout.py``; a float64 interval check, with the factor-2
margin, shows that every operand of an evaluation's divisions stays inside
``div_fast``'s window over the clipped state, for the whole of the
parameter windows (so the check is sound), the Monte-Carlo ranges and
``make_plant``'s defaults (so those plants take ``div_fast``); the
division counters' reset and read; and the edits of
``tools/torch_rollout_compare.py``. Marked ``gpu`` (skip without a card):
``div_fast`` against ``a / b`` bit for bit, the kernels bit-equal to their
plain versions with plants in and out of the windows, and the counters
on the benchmark cells' draws. On the card:

    python -m pytest -m gpu --noconftest -p no:randomly \\
        tests/test_torch_fast_division.py
"""

import contextlib
import ctypes
import math
import re
import sys
from pathlib import Path
from time import perf_counter

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import make_monte_carlo_batch
from ics_wt_physicsengine_torch.models import plant as P
from ics_wt_physicsengine_torch.models.monte_carlo import ParameterRanges
from ics_wt_physicsengine_torch.ops import _build
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import kernel_checks as K

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_rollout_compare as TRC  # noqa: E402

HEADER = _build.CSRC / "fused_rollout.cuh"
# div_fast's window less the factor of 2 on each side
LO, HI = 2.0 ** (1 - F.DIVISION_WINDOW_EXP), 2.0 ** (F.DIVISION_WINDOW_EXP - 1)
# the clipped state: h = 10^-pH for pH in [0, 14]; T in [0, 100] C
H = (1e-14, 1.0)
T_K = (273.15, 373.15)
G = 9.81

# the header's names of the Plant fields
HEADER_NAMES = {"ZoneHeight": "zone_height", "SafeU2": "safe_u2",
                "Ka1": "ka1", "Ka1Ka2": "ka1ka2", "Kw": "kw",
                "Ct2303": "ct2303", "KaHocl": "ka_hocl"}



def division_params(ptab: torch.Tensor) -> dict:
    """The plant fields the kernels' division check reads
    (``F.DIVISION_PARAM_WINDOWS``), from a ``[16, B]`` parameter table, as
    ``load_plant`` computes them in the table's type."""
    def col(name):
        return ptab[F.PARAM_COLS.index(name)]

    floor = torch.tensor(1e-6, dtype=ptab.dtype, device=ptab.device)
    us = torch.fmax(col("velocity_scale"), floor)
    return {"zone_height": col("zone_height"), "safe_u2": us * us,
            "ka1": col("Ka1"), "ka1ka2": col("Ka1") * col("Ka2"),
            "kw": col("Kw"),
            "ct2303": torch.tensor(2.303, dtype=ptab.dtype) * col("C_T_mol"),
            "ka_hocl": col("Ka_HOCl")}


def division_window_ok(ptab: torch.Tensor) -> torch.Tensor:
    """``[B]`` bool: which plants of a parameter table divide by
    ``div_fast`` (``load_plant``'s check; never in float64)."""
    ok = torch.full((ptab.shape[1],), ptab.dtype == torch.float32,
                    device=ptab.device)
    for name, x in division_params(ptab).items():
        lo, hi = F.DIVISION_PARAM_WINDOWS[name]
        ok &= (x >= (0.0 if lo is None else 2.0 ** lo)) & (x <= 2.0 ** hi)
    return ok

def test_window_constants_are_the_kernels():
    header = HEADER.read_text()
    assert int(re.search(r"constexpr int kDivWindowExp = (\d+);",
                         header).group(1)) == F.DIVISION_WINDOW_EXP
    windows = {HEADER_NAMES[name]: (None if lo == "kDivFromZero"
                                    else int(lo), int(hi))
               for name, lo, hi in re.findall(
                   r"constexpr DivWindow kDiv(\w+)\{(\w+|-?\d+), (-?\d+)\};",
                   header)}
    assert windows == F.DIVISION_PARAM_WINDOWS
    checked = re.findall(r"in_window\(p\.(\w+), kDiv(\w+)\)", header)
    assert sorted(field for field, _ in checked) \
        == sorted(F.DIVISION_PARAM_WINDOWS)
    assert all(HEADER_NAMES[name] == field for field, name in checked)


def water_density_range():
    """Lowest and highest density of the clipped temperatures, through the
    kernels' float32 formula on a fine grid and both ends."""
    t = torch.cat([torch.linspace(0.0, 100.0, 200001), torch.tensor(
        [0.0, 4.0, 8.0, float(np.nextafter(np.float32(8.0), 9.0)),
         100.0])]).float()
    tc = t - 4.0
    cold = 999.97 - 0.008 * (tc * tc)
    warm = 998.2 * (1.0 - 2.1e-4 * (t - 20.0))
    rho = torch.where(t <= 8.0, cold, warm)
    return float(rho.min()), float(rho.max())


def operand_bounds(p: dict) -> dict:
    """Per division of an evaluation, the float64 bounds ``(lo, hi)`` of
    |dividend|, divisor and |quotient| over every clipped state, for
    parameters in ``p`` (``{field: (lo, hi)}``, as ``division_params``
    names them). Each bound holds for every h in ``H`` and T in [0, 100]."""
    rho_lo, rho_hi = water_density_range()
    assert 512.0 <= rho_lo and rho_hi < 1024.0   # one float32 binade
    drho = (2.0 ** -14, rho_hi - rho_lo)         # its spacing, or zero
    (zh, u2, ka1, ka12, kw, ct, kh) = (
        p[k] for k in ("zone_height", "safe_u2", "ka1", "ka1ka2", "kw",
                       "ct2303", "ka_hocl"))
    d = (ka12[0], 1.0 + ka1[1] + ka12[1])        # h^2 + ka1 h + ka1ka2
    beta = (2.303 * H[0],                        # a0a1 + 4a1a2 + a0a2 <= 6
            2.303 * (1.0 + kw[1] / H[0]) + 6.0 * ct[1])
    ops = {
        "k_iface": ((G * drho[0] * zh[0], G * drho[1] * zh[1]),
                    (rho_lo * u2[0], rho_hi * u2[1])),
        "h*h/d": ((H[0] ** 2, 1.0), d),
        "ka1*h/d": ((ka1[0] * H[0], ka1[1]), d),
        "ka1ka2/d": (ka12, d),
        "kw/h": (kw, H),
        "1/(beta*ln10)": ((1.0, 1.0), (beta[0] * math.log(10.0),
                                       beta[1] * math.log(10.0))),
        "1/t_k": ((1.0, 1.0), T_K),
        "h/(h+ka_hocl)": (H, (H[0] + kh[0], 1.0 + kh[1])),
    }
    return {name: dict(dividend=a, divisor=b, quotient=(a[0] / b[1],
                                                        a[1] / b[0]))
            for name, (a, b) in ops.items()}


def assert_inside(bounds: dict):
    for name, parts in bounds.items():
        for part, (lo, hi) in parts.items():
            assert LO <= lo <= hi <= HI, (name, part, lo, hi)


def test_the_windows_keep_every_operand_inside():
    """The corners of ``DIVISION_PARAM_WINDOWS``: any plant the kernels
    send through ``div_fast`` divides inside its window, with margin."""
    p = {name: (0.0 if lo is None else 2.0 ** lo, 2.0 ** hi)
         for name, (lo, hi) in F.DIVISION_PARAM_WINDOWS.items()}
    assert_inside(operand_bounds(p))


def _ranges_of(ptab: torch.Tensor) -> dict:
    return {name: (float(x.min()), float(x.max()))
            for name, x in division_params(ptab).items()}


@pytest.mark.parametrize("source", [
    "monte-carlo", "monte-carlo-corners", "make_plant", "make_plant_batch"])
def test_the_benchmarks_plants_lie_inside(source):
    """The Monte-Carlo ranges (4096 draws, and the ranges' extremes: the
    slowest and fastest flows, coldest and warmest water, least and most
    carbonate) and ``make_plant``'s defaults: every division operand is
    inside the window with margin, and the float32 check passes."""
    cfg = R.ReactorConfiguration(n_zones=20)
    if source == "monte-carlo":
        params, _ = make_monte_carlo_batch(cfg, 4096, seed=3,
                                           dtype=torch.float64, device="cpu")
        ptab = F.param_table(params, 4096, torch.float64, "cpu")
    elif source == "monte-carlo-corners":
        # every range at its low end, its high end, and alternating both ways
        ranges = list(ParameterRanges().ranges.items())
        tabs = []
        for pick in ((0,) * 6, (1,) * 6, (0, 1) * 3, (1, 0) * 3):
            corner = {k: (r[j], r[j]) for (k, r), j in zip(ranges, pick)}
            prm, _ = make_monte_carlo_batch(
                cfg, 16, seed=1, dtype=torch.float64, device="cpu",
                ranges=ParameterRanges(ranges=corner))
            tabs.append(F.param_table(prm, 16, torch.float64, "cpu"))
        ptab = torch.cat(tabs, dim=1)
    else:
        n = 1 if source == "make_plant" else 256
        params, _ = P.make_plant(cfg, dtype=torch.float64, device="cpu") \
            if n == 1 else P.make_plant_batch(cfg, n, seed=1,
                                              dtype=torch.float64,
                                              device="cpu")
        ptab = F.param_table(params.reactor, n, torch.float64, "cpu")
    assert_inside(operand_bounds(_ranges_of(ptab)))
    assert bool(division_window_ok(ptab.float()).all())


def test_the_check_refuses_what_lies_outside():
    """``division_window_ok`` (``load_plant``'s check): a subnormal Kw, an
    extreme zone height or velocity, a NaN or negative parameter fail it;
    float64 never takes ``div_fast``."""
    cfg = R.ReactorConfiguration(n_zones=20)
    params, _ = make_monte_carlo_batch(cfg, 8, seed=0, device="cpu",
                                       dtype=torch.float32)
    ptab = F.param_table(params, 8, torch.float32, "cpu")
    col = {name: F.PARAM_COLS.index(name) for name in F.PARAM_COLS}
    ptab[col["Kw"], 1] = 1e-40
    ptab[col["zone_height"], 2] = 2.0 ** 40
    ptab[col["velocity_scale"], 3] = 1e20
    ptab[col["Ka1"], 4] = float("nan")
    ptab[col["Ka_HOCl"], 5] = -1e-8
    ptab[col["C_T_mol"], 6] = 0.0                 # may be zero
    ok = division_window_ok(ptab)
    assert ok.tolist() == [True, False, False, False, False, False, True,
                           True]
    assert not bool(division_window_ok(ptab.double()).any())


class _FakeCounter:
    """A kernel library's division counter, without a card."""

    def __init__(self, prefix, value):
        self.value = value

        def read(out):
            ctypes.cast(out, ctypes.POINTER(ctypes.c_ulonglong))[0] = \
                self.value
            return 0

        def reset():
            self.value = 0
            return 0
        setattr(self, f"{prefix}division_fallbacks", read)
        setattr(self, f"{prefix}reset_division_fallbacks", reset)


@pytest.mark.parametrize("module,name,prefix", [
    (F, "fused_rollout", "wt_"), (FP, "fused_plant", "wt_plant_")])
def test_reset_launch_counts_zeroes_the_division_counter(monkeypatch, module,
                                                         name, prefix):
    lib = _FakeCounter(prefix, 5)
    monkeypatch.setitem(_build._libs, name, lib)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(module, "_DIVISION_DEVICES", {0})
    assert module.division_fallbacks() == 5
    module.LAUNCHES[next(iter(module.LAUNCHES))] = 3
    module.reset_launch_counts()
    assert lib.value == 0 and module._DIVISION_DEVICES == set()
    assert set(module.LAUNCHES.values()) == {0}
    lib.value = 7                  # no launch since: nothing to read
    assert module.division_fallbacks() == 0


@pytest.mark.parametrize("module", [F, FP])
def test_the_division_counter_refuses_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(module, "_DIVISION_DEVICES", set())
    module.reset_launch_counts()   # nothing launched: needs no card
    with pytest.raises(RuntimeError, match="CUDA card"):
        module.division_fallbacks()


EDITS = [(variant, k) for table in (TRC.ABLATIONS, TRC.DIVISION_ABLATIONS)
         for variant, edits in table.items() for k in range(len(edits))]


@pytest.mark.parametrize("variant,k", EDITS)
def test_every_compare_edit_matches_once(variant, k):
    table = TRC.DIVISION_ABLATIONS if variant in TRC.DIVISION_ABLATIONS \
        else TRC.ABLATIONS
    name, text, replacement = table[variant][k]
    assert (_build.CSRC / name).read_text().count(text) == 1
    assert text != replacement


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    """tools/torch_rollout_probe.cu built with the package's flags: its
    ``wt_div_check`` counts the pairs where div_fast and a / b differ."""
    import torch_rollout_probe as TRP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe is a CUDA build")
    lib = ctypes.CDLL(str(TRP.build_probe(tmp_path_factory.mktemp("probe"))))
    lib.wt_div_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.wt_div_check.restype = ctypes.c_int
    return lib


def mismatches(lib, a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.float().contiguous(), b.float().contiguous()
    count = torch.zeros(1, dtype=torch.int64, device=a.device)
    assert lib.wt_div_check(a.data_ptr(), b.data_ptr(), a.numel(),
                            count.data_ptr(),
                            torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return int(count[0])


def _edges(device):
    """Operands at the window's ends and around 1, both signs of the
    dividend, with every pair kept whose quotient lies in the window."""
    e = F.DIVISION_WINDOW_EXP
    one_ulp = 2.0 ** -23
    mags = [2.0 ** -e, 2.0 ** -e * (1 + one_ulp), 2.0 ** -e * 1.5,
            2.0 ** -e * (2 - one_ulp), 2.0 ** (e - 1) * (2 - one_ulp),
            2.0 ** e, 2.0 ** e * (1 - one_ulp / 2), 1.0, 1.0 - one_ulp / 2,
            1.0 + one_ulp, 3.0, 1.0 / 3.0, 2.0 ** -60, 2.0 ** 60 * 1.75]
    mags = np.array(mags, np.float32).astype(np.float64)
    a = np.concatenate([mags, -mags])[:, None] * np.ones(len(mags))
    b = np.ones(2 * len(mags))[:, None] * mags
    q = np.abs(a / b)
    keep = (q >= 2.0 ** -e) & (q <= 2.0 ** e)
    return (torch.tensor(a[keep], device=device),
            torch.tensor(b[keep], device=device))


@pytest.mark.gpu
def test_div_fast_is_the_ieee_quotient_at_the_windows_edges(cuda,
                                                            probe_lib):
    a, b = _edges(cuda)
    assert a.numel() > 250
    assert mismatches(probe_lib, a, b) == 0
    # a zero dividend over a positive divisor: +0, as IEEE gives it
    zero = torch.zeros(4, device=cuda)
    assert mismatches(probe_lib, zero, torch.tensor(
        [2.0 ** -100, 1.0, 3.0, 2.0 ** 100], device=cuda)) == 0


@pytest.mark.gpu
def test_div_fast_is_the_ieee_quotient_inside_its_window(cuda, probe_lib):
    """2^24 pairs, log-uniform: b over the window, a over the part of it
    that keeps a / b inside, either sign."""
    e = F.DIVISION_WINDOW_EXP
    gen = torch.Generator(device=cuda).manual_seed(24)
    n = 1 << 24

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=cuda,
                                           dtype=torch.float64)
    log_b = uniform(-e, e)
    log_a = uniform(torch.clamp(log_b - e, min=-e),
                    torch.clamp(log_b + e, max=e))
    sign = torch.where(torch.rand(n, generator=gen, device=cuda) < 0.5,
                       -1.0, 1.0).double()
    lo, hi = 2.0 ** -e, 2.0 ** e
    b = torch.exp2(log_b).float().clamp(lo, hi)
    a = (sign * torch.exp2(log_a)).float()
    a = torch.sign(a) * a.abs().clamp(lo, hi)
    q = (a.double() / b.double()).abs()
    keep = (q >= lo) & (q <= hi)
    assert int(keep.sum()) > n * 0.999
    assert mismatches(probe_lib, a[keep], b[keep]) == 0


@pytest.mark.gpu
def test_div_fast_is_the_ieee_quotient_on_the_kernels_operands(cuda,
                                                               probe_lib):
    """The operand pairs of an evaluation's divisions as the kernels form
    them, in float32, over 2^21 clipped states and Monte-Carlo plants."""
    n = 1 << 21
    gen = torch.Generator(device=cuda).manual_seed(5)
    params, _ = make_monte_carlo_batch(R.ReactorConfiguration(n_zones=20),
                                       4096, seed=9, dtype=torch.float32,
                                       device=cuda)
    ptab = F.param_table(params, 4096, torch.float32, cuda)
    p = {k: v[torch.randint(0, 4096, (n,), generator=gen, device=cuda)]
         for k, v in division_params(ptab).items()}
    ph = 14.0 * torch.rand(n, generator=gen, device=cuda)
    t = 100.0 * torch.rand(n, generator=gen, device=cuda)
    t2 = 100.0 * torch.rand(n, generator=gen, device=cuda)
    h = torch.exp(-math.log(10.0) * ph)

    def rho(t):
        tc = t - 4.0
        return torch.where(t <= 8.0, 999.97 - 0.008 * (tc * tc),
                           998.2 * (1.0 - 2.1e-4 * (t - 20.0)))
    r1, r2 = rho(t), rho(t2)
    num = G * (r2 - r1) * p["zone_height"]
    d = h * h + p["ka1"] * h + p["ka1ka2"]
    kw_h = p["kw"] / h
    a0, a1, a2 = h * h / d, p["ka1"] * h / d, p["ka1ka2"] / d
    beta = 2.303 * (h + kw_h) + p["ct2303"] * (a0 * a1 + 4.0 * a1 * a2
                                              + a0 * a2)
    one = torch.ones_like(h)
    pairs = [(num, 0.5 * (r2 + r1) * p["safe_u2"]), (h * h, d),
             (p["ka1"] * h, d), (p["ka1ka2"], d), (p["kw"], h),
             (one, beta * math.log(10.0)), (one, t + 273.15),
             (h, h + p["ka_hocl"])]
    for a, b in pairs:
        assert mismatches(probe_lib, a, b) == 0


def _tables_with_outliers(n_zones, n_plants, device):
    """``K.tables`` with two plants outside the windows: a subnormal Kw
    (plant 3) and a zone height of 2^40 m (plant n - 2)."""
    ptab, btab, y = K.tables(n_zones, n_plants, torch.float32, device)
    ptab[F.PARAM_COLS.index("Kw"), 3] = 1e-40
    ptab[F.PARAM_COLS.index("zone_height"), n_plants - 2] = 2.0 ** 40
    return ptab, btab, y


def predicted_fallbacks(ok: torch.Tensor, g, n_zones: int) -> int:
    """The counter a B1/B2 launch of geometry ``g`` adds: plants of warps
    (warp layout) or blocks (packed) holding a plant outside the windows."""
    ok = ok.tolist()
    batch = len(ok)
    if g.layout == F.PACKED:
        groups = [range(s, min(s + g.plants_per_block, batch))
                  for s in range(0, batch, g.plants_per_block)]
        return sum(not all(ok[i] for i in grp) for grp in groups)
    per_warp = F.WARP_SIZE // n_zones
    groups = [range(s, min(s + per_warp, batch))
              for s in range(0, batch, per_warp)]
    return sum(len(grp) for grp in groups if not all(ok[i] for i in grp))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "warp"])
@pytest.mark.parametrize("substeps,stages", [(3, None), (1, 4)])
def test_b1_b2_stay_bit_equal_in_and_out_of_the_windows(
        cuda, monkeypatch, layout, substeps, stages):
    """B1 (RK4 and RKC2) and B2 in either layout with two plants outside
    the windows: bit-equal to the plain versions, and the counter holds
    what the geometry predicts (the outliers' warps or blocks)."""
    n_zones, n_plants = 20, 50
    make = F.packed_geometry if layout == "packed" else F.warp_geometry
    monkeypatch.setattr(F, "rollout_geometry", make)
    ptab, btab, y = _tables_with_outliers(n_zones, n_plants, cuda)
    ok = division_window_ok(ptab)
    assert ok.sum() == n_plants - 2
    want = predicted_fallbacks(ok, make(n_zones, n_plants), n_zones)
    assert want >= 2
    kw = dict(dt=K.DT, substeps=substeps, stages=stages, record_every=5)
    sched = F.schedule_table(K.bench_schedule(30), 30, torch.float32, cuda)
    F.reset_launch_counts()
    got = F.rollout_kernel(ptab, btab, *y, n_steps=30, **kw)
    assert F.division_fallbacks() == want
    assert K.max_err(got, F.rollout_plain(ptab, btab, *y, n_steps=30,
                                          **kw)) == 0.0
    got = F.scheduled_kernel(ptab, sched, *y, **kw)
    assert F.division_fallbacks() == 2 * want
    assert K.max_err(got, F.scheduled_plain(ptab, sched, *y, **kw)) == 0.0
    F.reset_launch_counts()
    assert F.division_fallbacks() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", ["rk4", "fast"])
def test_b3_stays_bit_equal_in_and_out_of_the_windows(cuda, integrator):
    """B3 with two plants outside the windows: bit-equal to its plain
    version, and the counter holds the blocks that hold them."""
    n_zones, n_plants, n_steps = 20, 24, 40
    params, plant = K.plant_case(n_zones, n_plants, torch.float32, cuda)
    tables = FP.build_tables(params, plant, K.BC, dt=K.DT, n_steps=n_steps)
    tables.ptab[F.PARAM_COLS.index("Kw"), 3] = 1e-40
    tables.ptab[F.PARAM_COLS.index("zone_height"), n_plants - 2] = 2.0 ** 40
    substeps, stages = K.plant_plan(n_zones, integrator)
    kw = dict(dt=K.DT, substeps=substeps, stages=stages, n_steps=n_steps,
              record_every=10, seed=7)
    per_block = FP.plant_geometry(n_zones, n_plants).plants_per_block
    ok = division_window_ok(tables.ptab).tolist()
    want = sum(not all(ok[s:s + per_block])
               for s in range(0, n_plants, per_block))
    assert want == 2
    FP.reset_launch_counts()
    got = FP.plant_kernel(tables, **kw)
    assert FP.division_fallbacks() == want
    diff = K.plant_diff(got, FP.plant_plain(tables, **kw))
    assert diff["max_abs_err"] == 0.0 and diff["nan_equal"] \
        and diff["ints_equal"], diff


# each cell of the benchmark at a size a test run holds
SMALL_CELLS = {
    "mc4096.b1": dict(plants=256, steps_per_call=100),
    "mc32768.b1_rkc": dict(plants=512, steps_per_call=100),
    "plant4096.b3": dict(plants=256, steps_per_call=200, record_every=100),
    "plant1.serve3600": dict(steps_per_chunk=120)}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL_CELLS))
def test_the_benchmark_cells_take_no_fallback(cuda, workload):
    """Each cell's parameter draws at a small batch: every plant divides
    by div_fast (the counters stay at 0) and the run is correct."""
    from benchmark import run as RUN
    from benchmark.harness import cells

    traffic = dict(cells.cell(workload).traffic, **SMALL_CELLS[workload])
    F.reset_launch_counts()
    FP.reset_launch_counts()
    result = RUN.run(workload, 2 ** 31 + 11, 0.5, False, device=str(cuda),
                     traffic=traffic, t_start=perf_counter())
    assert result["correct"], result["checks"]
    assert sum(F.LAUNCHES.values()) + sum(FP.LAUNCHES.values()) > 0
    assert F.division_fallbacks() == 0
    assert FP.division_fallbacks() == 0
