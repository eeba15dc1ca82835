#!/usr/bin/env python3
"""
Multi-process demo of the PyTorch port: a Monte-Carlo plant batch sharded
over N processes that form one ``torch.distributed`` group, checked against
the single-process engine (the port of ``tools/multihost_demo.py``).

Each process keeps its hosts-major slice of the global batch
(``parallel/multihost.py``: ``local_plant_slice``, ``shard_batch_multihost``)
on its local devices and steps it (``parallel/mesh.py::sharded_rollout``);
the ensemble mean crosses processes in one all-reduce.

- ``--device cuda`` (the default): one card a rank, joined with NCCL. The
  ranks need as many visible cards: NCCL refuses two ranks on one card, and
  nothing moves to gloo or the CPU.
- ``--device cpu``: the stand-in for a cluster, gloo between the
  processes, each with four shards of the CPU (the JAX demo's four virtual
  devices a process).

Run (self-spawning):   python tools/torch_multihost_demo.py [--nprocs 2]
                           [--device {cuda,cpu}]
Run (one rank):        python tools/torch_multihost_demo.py --rank R
                           --nprocs N --coord HOST:PORT [--device ...]

Prints, from rank 0: each process's shards, the ensemble-mean pH after the
sharded rollout (an all-reduce), and the max |difference| of the local
shards against a single-process rollout of the whole batch (expected: 0);
then the same for one step of the instrumented plant batch, its instrument
noise drawn once for the whole batch and each shard taking its plants'
rows (the JAX demo's key leaves; the port has no keys).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ics_wt_physicsengine_torch.device import cli_device  # noqa: E402

N_PLANTS = 16
N_ZONES = 4
N_STEPS = 5
SUBSTEPS = 4
# shards of the CPU a process (the JAX demo's virtual devices); a CUDA
# rank holds its one card
CPU_SHARDS = 4
# seconds a rank may take (its start included)
RANK_TIMEOUT_S = 600


def worker(rank: int, nprocs: int, coord: str, device_type: str) -> None:
    import torch.distributed as dist

    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.models.monte_carlo import (
        make_monte_carlo_batch)
    from ics_wt_physicsengine_torch.models.plant import (
        draw_packed_rand, make_plant_batch, plant_step_batched)
    from ics_wt_physicsengine_torch.parallel import (
        initialize_multihost, local_plant_slice, make_mesh,
        shard_batch_multihost, sharded_rollout)
    from ics_wt_physicsengine_torch.parallel.mesh import shard_bounds

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        local = [torch.device("cuda", rank)]
    else:
        local = [torch.device("cpu")] * CPU_SHARDS
    initialize_multihost(coord, num_processes=nprocs, process_id=rank,
                         device=None if device_type == "cuda" else "cpu")
    try:
        mesh = make_mesh(devices=local)
        print(f"[rank {rank}] {dist.get_backend()}: {mesh.size} local "
              f"shard(s) on {local[0]}, {nprocs * mesh.size} in all",
              flush=True)

        base = R.ReactorConfiguration(n_zones=N_ZONES)
        # Host construction, identical on every process (same seed).
        params, state = make_monte_carlo_batch(
            base, N_PLANTS, seed=3, dtype=torch.float32, device="cpu")
        bc = R.BoundaryConditions(inlet_flow_rate=5.0, inlet_pH=7.3,
                                  inlet_chlorine=0.4, acid_flow_rate=0.05)
        mine = local_plant_slice(N_PLANTS)
        blocks = [slice(mine.start + b.start, mine.start + b.stop)
                  for b in shard_bounds(mine.stop - mine.start, mesh)]

        fn = sharded_rollout(mesh, dt=1.0, substeps=SUBSTEPS,
                             n_steps=N_STEPS)
        out = fn(shard_batch_multihost(params, mesh),
                 shard_batch_multihost(state, mesh), bc)[0]

        # ensemble mean pH: a cross-process all-reduce
        total = sum(s.pH.sum().to(local[0]) for s in out)
        dist.all_reduce(total)
        mean_ph = float(total) / (N_PLANTS * N_ZONES)

        # the local shards against a single-process rollout of the whole
        # batch, on the same device
        oracle = R.rollout(*(x for x in _to(local[0], params, state)), bc,
                           dt=1.0, substeps=SUBSTEPS, n_steps=N_STEPS,
                           record=False)[0]
        worst = max(float((s.pH - oracle.pH[b]).abs().max())
                    for s, b in zip(out, blocks))
        if rank == 0:
            print(f"[rank 0] ensemble mean pH after {N_STEPS} steps: "
                  f"{mean_ph:.6f}", flush=True)
            print(f"[rank 0] max |sharded - single-process| on local "
                  f"shards: {worst:.3g}", flush=True)
        if not (mean_ph == mean_ph and worst == 0.0):
            raise SystemExit(f"[rank {rank}] mean pH {mean_ph}, max |diff| "
                             f"{worst}")

        # The instrumented plant batch: the instruments' draws are made
        # once for the whole batch and each shard takes its plants' rows.
        p_params, p_state = make_plant_batch(base, N_PLANTS, seed=3,
                                             dtype=torch.float32,
                                             device="cpu")
        gen = torch.Generator().manual_seed(5)
        rand = draw_packed_rand(gen, (N_PLANTS,), torch.float32, "cpu")
        gp = shard_batch_multihost(p_params, mesh)
        gs = shard_batch_multihost(p_state, mesh)
        worst_r = 0.0
        op, ost = _to(local[0], p_params, p_state)
        oracle_r = plant_step_batched(op, ost, bc, 1.0, SUBSTEPS, rand={
            k: (n.to(local[0]), u.to(local[0]))
            for k, (n, u) in rand.items()})[1]
        for pp, ss, b, dev in zip(gp, gs, blocks, mesh.devices):
            shard_rand = {k: (n[b].to(dev), u[b].to(dev))
                          for k, (n, u) in rand.items()}
            readings = plant_step_batched(pp, ss, bc, 1.0, SUBSTEPS,
                                          rand=shard_rand)[1]
            for name, r in readings.items():
                got, want = r.value, oracle_r[name].value[b]
                both_nan = torch.isnan(got) & torch.isnan(want.to(dev))
                diff = torch.where(both_nan, torch.zeros_like(got),
                                   (got - want.to(dev)).abs())
                worst_r = max(worst_r, float(diff.max()))
        if rank == 0:
            print(f"[rank 0] plant batch (draws split by plant): max "
                  f"local-shard |diff| vs single-process = {worst_r:.3g}",
                  flush=True)
        if worst_r != 0.0:
            raise SystemExit(f"[rank {rank}] readings differ by {worst_r}")
        dist.barrier()
        print(f"[rank {rank}] OK", flush=True)
    finally:
        dist.destroy_process_group()


def _to(device, *trees):
    from ics_wt_physicsengine_torch.parallel.mesh import _map

    return [_map(lambda x: x.to(device), t) for t in trees]


def _free_port() -> int:
    """Bind-then-release an ephemeral port: a fixed port collides with
    concurrent sessions or a stale worker from an aborted run."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_multihost_demo.py")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--coord", type=str, default=None,
                    help="coordinator address HOST:PORT (chosen "
                         "automatically when self-spawning)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default: one card a rank, NCCL; no "
                         "fallback) or cpu (gloo)")
    args = ap.parse_args(argv)
    cli_device(args.device)
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if args.nprocs > cards:
            raise SystemExit(
                f"--device cuda: --nprocs {args.nprocs} needs one card a "
                f"rank and {cards} are visible (NCCL refuses two ranks on "
                "one card); pass --device cpu for gloo on the CPU")

    if args.rank is not None:
        worker(args.rank, args.nprocs, args.coord, args.device)
        return 0

    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--nprocs", str(args.nprocs), "--coord", coord,
         "--device", args.device], cwd=REPO) for r in range(args.nprocs)]
    rc = []
    try:
        for p in procs:
            rc.append(p.wait(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if any(rc) or len(rc) < len(procs):
        raise SystemExit(f"worker exit codes: {rc}")
    print("multihost demo: all ranks OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
