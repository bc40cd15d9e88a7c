"""Fault injectors (the port of ``dryad_tpu/chaos/faults.py``): the two
failure modes the durable service promises to survive — an uncooperative
process death and a torn trailing write.  Both are REAL (a SIGKILL,
actual bytes on disk), not monkeypatches, so the recovery path under
test is the production one."""

from __future__ import annotations

import os
import signal
import time

__all__ = ["sigkill", "torn_tail", "chop_tail"]


def sigkill(pid: int, wait_s: float = 10.0) -> bool:
    """SIGKILL ``pid`` and reap it (when it is our child).  Returns
    False if the process was already gone."""
    try:
        os.kill(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        return False
    deadline = time.time() + wait_s
    while time.time() < deadline:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return True          # not our child / already reaped
        if done == pid:
            return True
        time.sleep(0.02)
    return True


def torn_tail(path: str, nbytes: int = 40) -> None:
    """Append a PARTIAL record — what a crash mid-append leaves behind:
    valid-looking JSON prefix, no closing brace, no newline.  Recovery
    must truncate exactly this and replay the rest."""
    frag = ('{"rec": "job_terminal", "id": "torn-'
            + "x" * max(1, int(nbytes)))
    with open(path, "a") as f:
        f.write(frag)
        f.flush()
        os.fsync(f.fileno())


def chop_tail(path: str, nbytes: int) -> None:
    """Truncate the last ``nbytes`` bytes mid-record — the other shape
    of a torn write (the tail of the final record never hit the
    platter)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - max(1, int(nbytes))))
