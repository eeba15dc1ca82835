"""
The control of each cell's comparison, on the card at the cell's own
size: for each seed, a short window of the program's timed path (its
numbers are the lower readings), then the plain reference computed in
bfloat16 put in the program's place (its numbers are the upper readings;
float32 is what the configurations state). The benchmark's own runs never
run this.

    python3 benchmark/controls.py --workload mc4096.b1 --seeds 11,12,13

One JSON line a seed: ``program`` and ``bfloat16`` (with ``--witnesses
bfloat16,float32`` also ``float32``), each number by name.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, device="cuda",
             traffic: dict = None, witnesses=("bfloat16",)) -> dict:
    """One seed's numbers: the program's, and those of the reference
    computed in each precision of ``witnesses`` in its place (bfloat16:
    the control; float32: a second witness of what float32 alone gives
    from the same inputs)."""
    import torch

    from benchmark.harness import cells, drivers
    from benchmark.run import measure

    cell = cells.cell(workload)
    driver = drivers.load(cell.traffic["entry"])(
        cell.config, traffic or cell.traffic, seed, device)
    driver.warm()
    calls, _, _ = measure(driver, seconds)
    driver.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    program = driver.check()
    out = {"seed": seed, "calls": calls, "program": program}
    for name in witnesses:
        driver.control = name
        out[name] = driver.check()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--witnesses", default="bfloat16",
                    help="precisions of the reference put in the "
                         "program's place, comma-separated")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  witnesses=args.witnesses.split(","))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
