"""b3_roofline: the least time of a call's work on the card (operations of
the tank, the instruments and their Philox words over 67 TFLOP/s, or its
bytes over 3.35 TB/s; ``harness/roofline.py``) as a percentage of the
device time of ``fused_plant.cu``'s kernels a call (``torch.profiler``).
Traced run."""

from benchmark.harness import roofline as RL
from benchmark.reference import instruments as I
from benchmark.reference import physics as PH


def read(ctx):
    t = ctx.cell.traffic
    if ctx.trace is None or t["entry"] != "plant_rollout_fused" \
            or not ctx.traced_calls:
        return None
    kernel = ctx.trace.kernel_s(*ctx.kernels) / ctx.traced_calls
    if kernel <= 0:
        return None
    cfg = ctx.cell.config
    z, integ = int(cfg["reactor"]["n_zones"]), PH.integrator(cfg)
    d = int(round(I.line_delay_s(cfg) / integ["dt"]))
    lines = sum(bool(i.get("sample_line")) for i in cfg["instruments"])
    bound, _ = RL.bound_s(
        RL.plant_ops(t["plants"], z, t["steps_per_call"], integ["substeps"],
                     integ["stages"]),
        RL.plant_bytes(t["plants"], z, t["steps_per_call"],
                       t["record_every"], lines * (d + 1), 0))
    return 100.0 * bound / kernel
