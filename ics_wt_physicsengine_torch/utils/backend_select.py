"""
Deadline-bounded CUDA device selection for the entry points (port of
``ics_wt_physicsengine_tpu/utils/backend_select.py``).

A driver or a CUDA context that cannot come up may hang the process that
touches it, and once a process is stuck inside the CUDA runtime nothing in
it can rescue it. So the card is first proven in a SUBPROCESS under a hard
deadline: the child needs a CUDA device, makes one tensor round trip and
prints the device count and name; a child that hangs is killed at the
deadline, and the parent never touched the card.

There is no fallback: when the probe fails, selection raises. The CPU is
used only when the caller asks for it (``device="cpu"``, ``device.py``),
never because the card failed.
"""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass

import torch

_PROBE_CODE = (
    "import torch\n"
    "n = torch.cuda.device_count()\n"
    "x = torch.arange(8, dtype=torch.float32, device='cuda')\n"
    "assert float((x + 1).sum().cpu()) == 36.0\n"
    "print('PROBE_OK', 'gpu', n, torch.cuda.get_device_name(0), "
    "flush=True)\n"
)


def _null_log(msg):  # pragma: no cover - default sink
    pass


@dataclass
class ProbeResult:
    ok: bool
    platform: str | None
    n_devices: int
    reason: str
    device_name: str | None = None


def probe_default_backend(deadline: float = 45.0, retries: int = 2,
                          log=_null_log, _code: str | None = None,
                          _runner=None) -> ProbeResult:
    """Prove (in a killable subprocess) that a CUDA device can be
    enumerated and round-trip a tensor within ``deadline`` seconds.

    ``_code``/``_runner`` are test seams: tests substitute a sleeping, a
    crashing and a healthy child.

    The deadline ESCALATES per attempt (1x, 2x, 3x...): a healthy but slow
    start (a loaded host) must not burn every retry at the same short
    deadline; a truly wedged card is still bounded by the sum of the
    escalated deadlines.
    """
    reason = "probe never ran"
    runner = _runner or subprocess.run
    for attempt in range(max(1, retries)):
        t0 = time.monotonic()
        attempt_deadline = deadline * (attempt + 1)
        try:
            r = runner([sys.executable, "-c", _code or _PROBE_CODE],
                       capture_output=True, text=True,
                       timeout=attempt_deadline)
        except subprocess.TimeoutExpired:
            reason = (f"device probe hit the {attempt_deadline:.0f}s "
                      f"deadline (wedged device init, attempt "
                      f"{attempt + 1})")
            log(reason)
            continue
        dt = time.monotonic() - t0
        out = (r.stdout or "").strip().splitlines()
        mark = [ln for ln in out if ln.startswith("PROBE_OK")]
        if r.returncode == 0 and mark:
            _, platform, count, *name = mark[-1].split()
            log(f"device probe ok in {dt:.1f}s: {platform} x{count}")
            return ProbeResult(True, platform, int(count), "ok",
                               " ".join(name) or None)
        err = (r.stderr or "").strip().splitlines()
        reason = (f"device probe failed rc={r.returncode} in {dt:.1f}s"
                  + (f": {err[-1][:200]}" if err else ""))
        log(reason)
        time.sleep(min(2.0, deadline / 10))
    return ProbeResult(False, None, 0, reason)


def _require(res: ProbeResult, n_devices: int) -> None:
    if not res.ok:
        raise RuntimeError(
            f"no working CUDA device ({res.reason}); pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if res.n_devices < n_devices:
        raise RuntimeError(
            f"{n_devices} CUDA devices requested; the probe found "
            f"{res.n_devices} ({res.device_name})")


def select_devices(n_devices: int, probe_deadline: float = 45.0,
                   log=_null_log):
    """``n_devices`` *working* CUDA devices, or raise.

    The subprocess probe proves the card first; then each selected device
    makes one tensor round trip in this process (a device that enumerates
    but cannot execute fails here, not later)."""
    _require(probe_default_backend(probe_deadline, log=log), n_devices)
    devs = [torch.device("cuda", i) for i in range(n_devices)]
    for d in devs:
        try:
            x = torch.arange(8, dtype=torch.float32, device=d)
            ok = float((x + 1).sum().cpu()) == 36.0
        except Exception as e:
            raise RuntimeError(f"{d} failed its round trip: {e}") from e
        if not ok:
            raise RuntimeError(f"{d} returned a wrong sum")
    return devs


def ensure_default_backend(min_devices: int = 1, probe_deadline: float = 60.0,
                           retries: int = 2, log=_null_log):
    """For whole-program consumers: prove that at least ``min_devices``
    CUDA devices work before the first touch in this process. Returns
    ``("gpu", "ok")``; raises when the probe fails."""
    _require(probe_default_backend(probe_deadline, retries=retries,
                                   log=log), min_devices)
    return "gpu", "ok"
