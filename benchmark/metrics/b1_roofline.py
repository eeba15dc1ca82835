"""b1_roofline: the least time of a call's work on the card (the larger of
its operations over 67 TFLOP/s and its bytes over 3.35 TB/s;
``harness/roofline.py``, RK4 or RKC2 as the configuration states) as a
percentage of B1's device time a call (``torch.profiler``). Traced run."""

from benchmark.harness import roofline as RL
from benchmark.reference import physics as PH


def read(ctx):
    t = ctx.cell.traffic
    if ctx.trace is None or t["entry"] != "rollout_fused" \
            or not ctx.traced_calls:
        return None
    kernel = ctx.trace.kernel_s(*ctx.kernels) / ctx.traced_calls
    if kernel <= 0:
        return None
    z = int(ctx.cell.config["reactor"]["n_zones"])
    integ = PH.integrator(ctx.cell.config)
    bound, _ = RL.bound_s(
        RL.rollout_ops(t["plants"], z, t["steps_per_call"],
                       integ["substeps"], integ["stages"]),
        RL.rollout_bytes(t["plants"], z))
    return 100.0 * bound / kernel
