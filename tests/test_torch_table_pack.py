"""The table pack (``ops/fused_plant.py::pack_tables``,
``csrc/fused_plant.cu::pack_tables_kernel``): B3's tables made on the card
in one launch from a descriptor of the leaves ``build_tables`` reads.

On the CPU (the kernel has no CPU mode): the descriptor names exactly the
leaves ``build_tables`` reads, in table order, with their element types
and batch strides; an emulation of the kernel in PyTorch that reads only
the descriptor (each leaf's value, type and stride, the layout) rebuilds
``build_tables``' tables bit for bit, the lead-in by the kernel's own loop
over the ring's slots; a changed leaf changes both alike; the route counts
``TABLE_PACKS``. On the card (``gpu``): the pack kernel's tables bit-equal
to ``build_tables``', and a served chunk that queues nothing before B3 but
the pack and one copy. Run the card's tests there with

    python -m pytest -m gpu --noconftest -p no:randomly tests/test_torch_table_pack.py
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ics_wt_physicsengine_torch import __main__ as M
from ics_wt_physicsengine_torch.core import reactor as R
from ics_wt_physicsengine_torch.models import plant as PL
from ics_wt_physicsengine_torch.ops import fused_plant as FP
from ics_wt_physicsengine_torch.ops import fused_rollout as F
from ics_wt_physicsengine_torch.ops import kernel_checks as K

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [torch.float32, torch.float64]
TABLES = ("ptab", "forcing", "sensor_params", "carry_float", "carry_int",
          "delay_steps", "ph", "cl", "t", "time")


def bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_floating_point:
        t = t.contiguous().view({4: torch.int32, 8: torch.int64}[
            t.element_size()])
    return t


def assert_bits(a: torch.Tensor, b: torch.Tensor, what=""):
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape,
                                                       b.shape)
    assert a.device == b.device, what
    assert torch.equal(bits(a), bits(b)), (what, a, b)


def assert_tables_equal(got: FP.PlantTables, want: FP.PlantTables):
    """Every table of ``PlantTables`` bit for bit (NaN payloads too)."""
    assert got.statics == want.statics and got.scheduled == want.scheduled
    for name in TABLES:
        assert_bits(getattr(got, name), getattr(want, name), name)
    assert len(got.lead) == len(want.lead) == len(FP._LINE_ATTRS)
    for i, (a, b) in enumerate(zip(got.lead, want.lead)):
        assert_bits(a, b, f"lead[{i}]")


def resolve(name, params, plant, boundary):
    """The object a ``PACK_LEAVES`` entry names."""
    src = name[0]
    if src == "params":
        return FP._leaf(getattr(params, name[1]), name[2], name[3])
    if src == "plant":
        return FP._leaf(getattr(plant, name[1]), name[2], name[3])
    if src == "reactor":
        return getattr(params.reactor.chem if name[1] else params.reactor,
                       name[2])
    if src == "boundary":
        return getattr(boundary, name[1])
    return plant.reactor.time


# ---------------------------------------------------------------------------
# The kernel in PyTorch: reads the descriptor only
# ---------------------------------------------------------------------------


def load(desc, k, index, dtype):
    """Elements ``index`` (an int64 tensor of element offsets) of leaf
    ``k`` as ``dtype``, converted as the kernel converts them."""
    x, kind = desc.leaves[k], desc.kinds[k]
    if kind == FP.HOST_FLOAT:
        v = torch.tensor(x, dtype=torch.float64)
    elif kind == FP.HOST_INT:
        v = torch.tensor(int(x), dtype=torch.int64)
    else:
        assert FP.LEAF_KINDS[x.dtype] == kind
        top = int(index.max()) + 1 if index.numel() else 1
        v = x.as_strided((top,), (1,))[index]
    return v.to(dtype).expand(index.shape)


def emulate(desc, dtype, dt):
    """The pack kernel's tables from ``desc`` by its own arithmetic: each
    column element converted, the schedule by step (and plant) strides,
    each delay rounded from an IEEE quotient, each lead-in slot resolved
    by a loop over the ring's filled slots with the kernel's argmin."""
    lay = desc.layout
    batch, n_steps = lay["batch"], lay["n_steps"]
    plants = torch.arange(batch)
    n_cols = FP.N_PCOLS + FP.N_CCOLS + len(F.PARAM_COLS)
    first_bnd = n_cols
    clock = first_bnd + len(F.BOUNDARY_FIELDS)

    def column(k, to=dtype, at=plants):
        return load(desc, k, at * desc.strides[k], to)

    cols = [column(k, torch.int32 if FP.N_PCOLS + FP.N_FLOAT_CCOLS <= k
                   < FP.N_PCOLS + FP.N_CCOLS else dtype)
            for k in range(n_cols)]
    out = {"sensor_params": torch.stack(cols[:FP.N_PCOLS]),
           "carry_float": torch.stack(
               cols[FP.N_PCOLS:FP.N_PCOLS + FP.N_FLOAT_CCOLS]),
           "carry_int": torch.stack(
               cols[FP.N_PCOLS + FP.N_FLOAT_CCOLS:FP.N_PCOLS + FP.N_CCOLS]),
           "ptab": torch.stack(cols[FP.N_PCOLS + FP.N_CCOLS:]),
           "time": column(clock)}
    scheduled = lay["scheduled"]
    steps = torch.arange(n_steps)
    rows = []
    for c in range(len(F.BOUNDARY_FIELDS)):
        k = first_bnd + c
        if scheduled == FP.FORCING_CONSTANT:
            rows.append(column(k))
        elif scheduled == FP.FORCING_SHARED:
            rows.append(load(desc, k, steps * desc.strides[k], dtype))
        else:
            at = steps[:, None] * desc.strides[k] \
                + plants[None, :] * lay["forcing_plant_stride"][c]
            rows.append(load(desc, k, at, dtype))
    out["forcing"] = torch.stack(rows, dim=0 if scheduled
                                 == FP.FORCING_CONSTANT else 1)

    def leaf_of(line, which):
        return clock + 1 + line * 5 + which

    delays, leads = [], []
    for line in range(len(FP._LINE_ATTRS)):
        d_max = lay["d_max"][line]
        delay = column(leaf_of(line, 4))
        r = torch.round(delay / torch.full_like(delay, dt))
        r = torch.where(torch.isnan(r), r, torch.clamp(r, 0.0, float(d_max)))
        d = r.to(torch.int32)
        delays.append(d)
        cap = d_max + 1
        nan = torch.full((cap, batch), math.nan, dtype=dtype)
        if not lay["lead"][line]:
            leads.append(nan)
            continue
        g = torch.arange(cap)[:, None] - 1 - (d_max - d.to(torch.int64))
        ok = (g >= 0) & (g < d.to(torch.int64))
        gf = g.to(dtype)
        t0 = column(clock)
        target = (t0 + (gf + 1.0) * dt) - delay
        count = column(leaf_of(line, 2), torch.int64)
        ptr = column(leaf_of(line, 3), torch.int64)
        slots = lay["slots"][line]
        filled = torch.clamp(count, max=slots)
        best = torch.full((cap, batch), math.inf, dtype=dtype)
        best_slot = torch.zeros((cap, batch), dtype=torch.int64)
        for c in range(slots):
            over = torch.remainder(c - ptr, slots)
            times = load(desc, leaf_of(line, 1),
                         plants * desc.strides[leaf_of(line, 1)]
                         + c * lay["time_slot_stride"][line], dtype)
            dist = torch.where((c < filled) & (over > g),
                               (times - target).abs(), math.inf)
            take = torch.where(torch.isnan(dist), ~torch.isnan(best),
                               dist < best)
            best = torch.where(take, dist, best)
            best_slot = torch.where(take, c, best_slot)
        dist0 = (delay - gf * dt).abs()
        use = ok & ((best < dist0) | ((best == dist0) & (best_slot < ptr)))
        values = load(desc, leaf_of(line, 0),
                      plants * desc.strides[leaf_of(line, 0)]
                      + best_slot * lay["value_slot_stride"][line], dtype)
        leads.append(torch.where(use, values, nan))
    out["delay_steps"] = torch.stack(delays)
    out["lead"] = leads
    return out


def assert_emulation_equal(params, plant, boundary, *, dt, n_steps,
                           consume_line=True):
    want = FP.build_tables(params, plant, boundary, dt=dt, n_steps=n_steps,
                           consume_line=consume_line)
    desc = FP.describe_tables(params, plant, boundary, want.statics, dt=dt,
                              n_steps=n_steps, consume_line=consume_line)
    got = emulate(desc, plant.reactor.pH.dtype, dt)
    for name, table in got.items():
        if name == "lead":
            for i, (a, b) in enumerate(zip(table, want.lead)):
                assert_bits(a, b, f"lead[{i}]")
        else:
            assert_bits(table, getattr(want, name), name)
    return want, desc


# ---------------------------------------------------------------------------
# Cases: (params, plant, boundary, n_steps, consume_line) on a device
# ---------------------------------------------------------------------------


def _partly_filled(params, plant, dtype, device, count=37, ptr=61):
    """The four rings half filled, their pointer past the filled slots,
    the samples around the plant's clock (so that the nearest-sample rule
    has choices to make), per-plant delays."""
    gen = torch.Generator().manual_seed(5)
    changes = {}
    for attr in FP._LINE_ATTRS:
        base = getattr(plant, attr).base
        shape = tuple(base.line_values.shape)
        times = plant.reactor.time.reshape(-1)[:, None].cpu() \
            - 45.0 + 60.0 * torch.rand(shape[:-1] + (shape[-1],),
                                       generator=gen, dtype=torch.float64) \
            .reshape(-1, shape[-1])
        changes[attr] = dataclasses.replace(
            getattr(plant, attr), base=dataclasses.replace(
                base,
                line_values=torch.randn(shape, generator=gen, dtype=dtype)
                .to(device),
                line_times=times.reshape(shape).to(dtype).to(device),
                line_count=torch.full_like(base.line_count, count),
                line_ptr=torch.full_like(base.line_ptr, ptr)))
    return dataclasses.replace(plant, **changes)


def _served(params, plant, sizes, device):
    """The plant after served chunks of ``sizes`` steps on the plain path
    (a chunk shorter than a line joins its ring with the one before)."""
    step0 = 0
    for n in sizes:
        sched, _ = M.build_chunk_schedule(
            K.BC, dataclasses.replace(K.BC, acid_flow_rate=0.3), n, K.DT,
            30.0, device=device)
        plant = FP._rollout_with(
            FP.tensor_route(), params, plant, sched, dt=K.DT, substeps=2,
            n_steps=n, stages=None, record_every=1, bits=None, seed=3,
            consume_line=True, step0=step0, served=True)[0]
        step0 += n
    return plant


def _python_float(params, attr="temp_outlet", field="rtd_alpha"):
    x = 0.1 + 2.0 ** -40
    return dataclasses.replace(params, **{attr: dataclasses.replace(
        getattr(params, attr), **{field: x})})


def make_case(name, dtype, device):
    """``(params, plant, boundary, n_steps, consume_line)`` of one case."""
    one = R.ReactorConfiguration(n_zones=5)
    n_plants = {"plants4096": 4096, "plants1": 1}.get(name, 3)
    n_steps = 12
    boundary = K.BC
    consume = True
    if n_plants == 1:
        params, plant = PL.make_plant(one, dtype=dtype, device=device)
    else:
        params, plant = K.plant_case(5, n_plants, dtype, device,
                                     delays=True, clocks=True)
    if name == "plants1":
        boundary, _ = M.build_chunk_schedule(
            K.BC, dataclasses.replace(K.BC, acid_flow_rate=0.3), 40, K.DT,
            30.0, device=device)
        n_steps = 40
    elif name == "shared":
        boundary = K.bench_schedule(n_steps)
    elif name == "per_plant":
        boundary = K.fleet_schedule(n_steps, n_plants)
    elif name == "d_max0":
        params = dataclasses.replace(params, **{
            attr: K._with_base(getattr(params, attr),
                               line_delay_s=torch.zeros(
                                   (n_plants,), dtype=dtype, device=device))
            for attr in FP._LINE_ATTRS})
    elif name == "no_consume":
        consume = False
    elif name == "python_float":
        params = _python_float(params)
    elif name in ("partly_filled", "plants4096"):
        plant = _partly_filled(params, plant, dtype, device)
    elif name == "joined":
        params, plant = PL.make_plant(one, dtype=dtype, device=device)
        plant = _served(params, plant, (8, 8), device)
        boundary, _ = M.build_chunk_schedule(K.BC, K.BC, 8, K.DT, 0.0,
                                             device=device)
        n_steps = 8
    elif name == "fresh":
        params, plant = PL.make_plant(one, dtype=dtype, t0=3600.0,
                                      device=device)
    return params, plant, boundary, n_steps, consume


CPU_CASES = ["plants1", "constant", "shared", "per_plant", "d_max0",
             "no_consume", "python_float", "partly_filled", "joined",
             "fresh"]
CARD_CASES = CPU_CASES + ["plants4096"]


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def test_the_leaves_are_build_tables_leaves_in_table_order():
    names = list(FP.PACK_LEAVES)
    n_cols = FP.N_PCOLS + FP.N_CCOLS + len(F.PARAM_COLS) \
        + len(F.BOUNDARY_FIELDS) + 1
    assert len(names) == n_cols + 5 * len(FP._LINE_ATTRS)
    assert names[:FP.N_PCOLS] == [("params",) + c for c in FP._PCOLS]
    assert names[FP.N_PCOLS:FP.N_PCOLS + FP.N_CCOLS] == \
        [("plant",) + c[:3] for c in FP._FLOAT_CCOLS + FP._INT_CCOLS]
    reactor = names[FP.N_PCOLS + FP.N_CCOLS:n_cols - 11]
    assert [n[2] for n in reactor] == list(F.PARAM_COLS)
    assert [n[1] for n in names[n_cols - 11:n_cols - 1]] == \
        list(F.BOUNDARY_FIELDS)
    assert names[n_cols - 1] == ("clock",)
    lines = names[n_cols:]
    for i, attr in enumerate(FP._LINE_ATTRS):
        assert lines[5 * i:5 * i + 5] == [
            ("plant", attr, "base", "line_values"),
            ("plant", attr, "base", "line_times"),
            ("plant", attr, "base", "line_count"),
            ("plant", attr, "base", "line_ptr"),
            ("params", attr, "base", "line_delay_s")]
    # the reactor parameters as param_table reads them
    params, _ = K.plant_case(5, 3, torch.float32, "cpu")
    want = F.param_table(params.reactor, 3, torch.float32, "cpu")
    got = torch.stack([F._column(resolve(n, params, None, None), 3,
                                 torch.float32, "cpu") for n in reactor])
    assert_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["plants1", "constant", "per_plant",
                                  "no_consume"])
def test_the_descriptor_holds_each_leaf_with_its_type_and_stride(case,
                                                                 dtype):
    params, plant, boundary, n_steps, consume = make_case(case, dtype,
                                                          "cpu")
    statics = FP.sensor_statics(params, K.DT)
    desc = FP.describe_tables(params, plant, boundary, statics, dt=K.DT,
                              n_steps=n_steps, consume_line=consume)
    batch = desc.layout["batch"]
    assert len(desc.leaves) == len(desc.kinds) == len(desc.strides) \
        == len(FP.PACK_LEAVES) == desc.layout["n_leaves"]
    ring_leaves = {"line_values", "line_times", "line_count", "line_ptr"}
    for name, x, kind, stride in zip(FP.PACK_LEAVES, desc.leaves,
                                     desc.kinds, desc.strides):
        leaf = resolve(name, params, plant, boundary)
        if x is None:       # a ring not consumed: nothing read
            assert not consume and name[-1] in ring_leaves
            continue
        if isinstance(x, torch.Tensor):
            if isinstance(leaf, torch.Tensor):
                assert x is leaf or (x.data_ptr() == leaf.data_ptr()
                                     and x.numel() == leaf.numel()), name
            else:   # host data of many values, copied once as _column does
                assert torch.equal(x, torch.as_tensor(np.asarray(leaf))), name
                leaf = x
            assert kind == FP.LEAF_KINDS[leaf.dtype], name
            if name[-1] in ("line_values", "line_times"):
                want = leaf.stride(0) if leaf.ndim == 2 \
                    and leaf.shape[0] > 1 else 0
            elif name[0] == "boundary" and desc.layout["scheduled"]:
                want = leaf.stride(0) if leaf.ndim and leaf.shape[0] > 1 \
                    else 0
            else:
                want = leaf.reshape(-1).stride(0) if leaf.numel() == batch \
                    and batch > 1 else 0
            assert stride == want, name
        else:
            # a host number, kept as _column keeps it (float64 or int64)
            assert kind in (FP.HOST_FLOAT, FP.HOST_INT), name
            assert stride == 0 and x == leaf, name
    assert desc.layout["lead"] == [
        int(consume and d > 0) for d in desc.layout["d_max"]]
    at, code, layout = desc.arrays()
    assert at.dtype == np.uint64 and code.dtype == np.uint32 \
        and layout.dtype == np.int64
    assert list(code & 15) == desc.kinds
    assert list(code >> 4) == desc.strides
    assert len(layout) == len(FP.PACK_FIELDS) - 7 + 10 + 6 * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CPU_CASES)
def test_an_emulation_of_the_kernel_rebuilds_the_tables(case, dtype):
    """The kernel's arithmetic in PyTorch on the descriptor alone gives
    ``build_tables``' tables bit for bit, lead-ins included."""
    params, plant, boundary, n_steps, consume = make_case(case, dtype,
                                                          "cpu")
    want, desc = assert_emulation_equal(params, plant, boundary, dt=K.DT,
                                        n_steps=n_steps,
                                        consume_line=consume)
    if case in ("partly_filled", "joined"):
        # the rings were read: some slot resolved to a pre-rollout sample
        assert any(bool(torch.isfinite(x).any()) for x in want.lead)
    if case == "python_float":
        k = FP.PACK_LEAVES.index(("params", "temp_outlet", None,
                                  "rtd_alpha"))
        assert desc.kinds[k] == FP.HOST_FLOAT
        assert desc.leaves[k] == 0.1 + 2.0 ** -40


# One leaf of each region, changed in the plant the emulation reads: the
# tables of both change alike.
CHANGED = [("params", "ph_inlet", "base", "drift_rate"),
           ("params", "chlorine_outlet", None, "ozone_sensitivity"),
           ("plant", "temp_inlet", "base", "current_value"),
           ("plant", "flow_main", None, "electrode_fouling"),
           ("plant", "ph_outlet", "base", "status"),
           ("plant", "chlorine_inlet", "base", "has_history"),
           ("reactor", "chem", "Ka1"), ("reactor", None, "ri_crit"),
           ("boundary", "acid_flow_rate"), ("clock",),
           ("plant", "ph_inlet", "base", "line_times"),
           ("plant", "temp_outlet", "base", "line_ptr"),
           ("params", "ph_outlet", "base", "line_delay_s")]


@pytest.mark.parametrize("name", CHANGED, ids=lambda n: ".".join(
    str(p) for p in n))
def test_a_changed_leaf_changes_both_tables_alike(name):
    params, plant, boundary, n_steps, consume = make_case(
        "partly_filled", torch.float32, "cpu")
    before = FP.build_tables(params, plant, boundary, dt=K.DT,
                             n_steps=n_steps)
    leaf = resolve(name, params, plant, boundary)
    if name[-1] == "line_ptr":
        new = leaf + 17
    elif name[-1] == "line_delay_s":
        new = leaf * 0.5
    elif not isinstance(leaf, torch.Tensor):
        new = leaf + 0.25
    elif leaf.dtype == torch.bool:
        new = ~leaf
    else:
        new = leaf + 3
    if name[0] == "params":
        sp = getattr(params, name[1])
        sp = K._with_base(sp, **{name[3]: new}) if name[2] == "base" \
            else dataclasses.replace(sp, **{name[3]: new})
        params = dataclasses.replace(params, **{name[1]: sp})
    elif name[0] == "plant":
        sc = getattr(plant, name[1])
        sc = dataclasses.replace(sc, base=dataclasses.replace(
            sc.base, **{name[3]: new})) if name[2] == "base" \
            else dataclasses.replace(sc, **{name[3]: new})
        plant = dataclasses.replace(plant, **{name[1]: sc})
    elif name[0] == "reactor":
        rp = params.reactor
        rp = dataclasses.replace(rp, chem=dataclasses.replace(
            rp.chem, **{name[2]: new})) if name[1] \
            else dataclasses.replace(rp, **{name[2]: new})
        params = dataclasses.replace(params, reactor=rp)
    elif name[0] == "boundary":
        boundary = dataclasses.replace(boundary, **{name[1]: new})
    else:
        plant = dataclasses.replace(plant, reactor=dataclasses.replace(
            plant.reactor, time=new))
    after, _ = assert_emulation_equal(params, plant, boundary, dt=K.DT,
                                      n_steps=n_steps)
    changed = [n for n in TABLES[:6] if not torch.equal(
        bits(getattr(before, n)), bits(getattr(after, n)))]
    changed += [f"lead[{i}]" for i, (a, b) in enumerate(zip(
        before.lead, after.lead)) if not torch.equal(bits(a), bits(b))]
    assert changed, name


@pytest.mark.parametrize("case", CPU_CASES)
def test_build_tables_lead_ins_are_views_of_one_block(case):
    """``build_tables``' four lead-ins are views of ``lead_block`` in line
    order, as the pack's are, so B3's histories start as one copy."""
    params, plant, boundary, n_steps, consume = make_case(
        case, torch.float32, "cpu")
    tables = FP.build_tables(params, plant, boundary, dt=K.DT,
                             n_steps=n_steps, consume_line=consume)
    block = tables.lead_block
    assert block.ndim == 1 and block.is_contiguous()
    at = 0
    for x in tables.lead:
        assert x.is_contiguous() and x.untyped_storage().data_ptr() \
            == block.untyped_storage().data_ptr()
        assert x.storage_offset() == block.storage_offset() + at
        at += x.numel()
    assert at == block.numel()
    assert_bits(block, torch.cat([x.reshape(-1) for x in tables.lead]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_per_plant_schedule_keeps_a_python_float_in_float64(dtype):
    """A Python float in a per-plant schedule reaches the forcing table as
    ``_column`` converts it, float64 until the cast to the plant's type, on
    both routes (the descriptor carries it as a float64 host number)."""
    params, plant = K.plant_case(5, 3, dtype, "cpu", delays=True)
    x = 0.3 + 2.0 ** -40
    boundary = dataclasses.replace(K.fleet_schedule(12, 3), inlet_pH=x)
    table = FP.plant_schedule_table(boundary, 12, 3, dtype, "cpu")
    col = F.BOUNDARY_FIELDS.index("inlet_pH")
    want = torch.tensor(x, dtype=torch.float64).to(dtype)
    assert_bits(table[:, col], want.expand(12, 3))
    if dtype == torch.float64:
        assert float(table[0, col, 0]) == x
    tables, desc = assert_emulation_equal(params, plant, boundary, dt=K.DT,
                                          n_steps=12)
    assert tables.scheduled == FP.FORCING_PER_PLANT
    k = FP.PACK_LEAVES.index(("boundary", "inlet_pH"))
    assert desc.kinds[k] == FP.HOST_FLOAT and desc.leaves[k] == x


def test_the_route_counts_table_packs_and_a_cpu_plant_never_packs():
    cfg = R.ReactorConfiguration(n_zones=5)
    params, plant = PL.make_plant(cfg, device="cpu")
    FP.reset_launch_counts()
    assert FP.TABLE_PACKS == {"kernel": 0, "tensors": 0}
    new, _ = FP.plant_rollout_fused(params, plant, K.BC, dt=1.0, substeps=2,
                                    n_steps=4, seed=1)
    sched, _ = M.build_chunk_schedule(K.BC, K.BC, 6, 1.0, 0.0, device="cpu")
    PL.plant_serve_chunk(params, new, sched, dt=1.0, substeps=2, seed=1,
                         step0=4)
    assert FP.TABLE_PACKS == {"kernel": 0, "tensors": 2}
    assert FP.LAUNCHES == {"plant_rollout_fused": 0, "pack_tables": 0}
    # one place pairs each builder with its runner
    assert FP.table_runner(params, plant) == FP.tensor_route() \
        == (FP.build_tables, FP.plant_plain)
    assert FP.kernel_route() == (FP.pack_tables, FP.plant_kernel)
    FP.build_tables(params, plant, K.BC, dt=1.0, n_steps=4)
    assert FP.TABLE_PACKS == {"kernel": 0, "tensors": 3}
    with pytest.raises(ValueError, match="CUDA"):
        FP.pack_tables(params, plant, K.BC, dt=1.0, n_steps=4)
    with pytest.raises(ValueError, match="CUDA"):
        FP._rollout_with(FP.kernel_route(), params, plant, K.BC, dt=1.0,
                         substeps=2, n_steps=4, stages=None, record_every=1,
                         bits=None, seed=1, consume_line=True)
    assert FP.TABLE_PACKS == {"kernel": 0, "tensors": 3}
    FP.reset_launch_counts()
    assert FP.TABLE_PACKS == {"kernel": 0, "tensors": 0}


def test_the_descriptor_refuses_what_build_tables_refuses():
    params, plant = K.plant_case(5, 3, torch.float32, "cpu")
    statics = FP.sensor_statics(params, K.DT)
    with pytest.raises(ValueError, match="length"):
        FP.describe_tables(params, plant, K.bench_schedule(7), statics,
                           dt=K.DT, n_steps=8)
    with pytest.raises(ValueError, match="per-plant"):
        FP.describe_tables(params, plant, K.fleet_schedule(8, 2), statics,
                           dt=K.DT, n_steps=8)
    wide = dataclasses.replace(plant, ph_inlet=dataclasses.replace(
        plant.ph_inlet, membrane_fouling=torch.zeros(4)))
    with pytest.raises(ValueError, match="1 or 3"):
        FP.describe_tables(params, wide, K.BC, statics, dt=K.DT, n_steps=8)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pack kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CARD_CASES)
def test_the_pack_kernel_equals_build_tables_on_the_card(cuda, case, dtype):
    params, plant, boundary, n_steps, consume = make_case(case, dtype, cuda)
    want = FP.build_tables(params, plant, boundary, dt=K.DT,
                           n_steps=n_steps, consume_line=consume)
    got = FP.pack_tables(params, plant, boundary, dt=K.DT, n_steps=n_steps,
                         consume_line=consume)
    torch.cuda.synchronize(cuda)
    assert_tables_equal(got, want)
    # the four lead-ins are one block, in order
    assert_bits(got.lead_block, torch.cat([x.reshape(-1) for x in got.lead]))
    # and B3 takes either set of tables alike
    kw = dict(dt=K.DT, substeps=2, n_steps=n_steps, seed=3)
    a, b = FP.plant_kernel(got, **kw), FP.plant_kernel(want, **kw)
    for x, y in zip(K.tree_leaves(a), K.tree_leaves(b)):
        assert_bits(x[1], y[1], x[0])


@pytest.mark.gpu
def test_a_served_chunk_queues_only_the_pack_and_a_copy_before_b3(cuda):
    """From a served chunk's call to B3's launch the card is given the pack
    kernel and at most one copy (the histories' start), nothing else, and
    each chunk packs once (``TABLE_PACKS``). Traced under
    ``torch.profiler`` in a child process (``kernel_checks.
    served_chunk_trace``), so that no profiler state stays behind in this
    one for a later test's session."""
    run = subprocess.run(
        [sys.executable, "-c", "import json; from ics_wt_physicsengine_torch"
         ".ops import kernel_checks as K; print(json.dumps("
         "K.served_chunk_trace('cuda')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    trace = json.loads(run.stdout.splitlines()[-1])
    assert len(trace["chunks"]) == 2
    for names in trace["chunks"]:
        b3 = [i for i, n in enumerate(names) if "plant_kernel" in n]
        assert len(b3) == 1, names
        before = names[:b3[0]]
        assert before and "pack_tables_kernel" in before[0], names
        assert len(before) <= 2 and all("emcpy" in n for n in before[1:]), \
            before
        assert sum("pack_tables_kernel" in n for n in names) == 1
    assert trace["table_packs"] == {"kernel": 2, "tensors": 0}
    assert trace["launches"] == {"plant_rollout_fused": 2, "pack_tables": 2}
