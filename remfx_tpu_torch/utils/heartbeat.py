"""Liveness heartbeat for supervised runs (``remfx_tpu/utils/heartbeat.py``).

Hot loops (render batches, train steps) call :func:`beat`, which touches
the file named by ``$REMFX_HEARTBEAT``; a supervisor that watches the
file's age can kill and relaunch a run that hangs. With the variable
unset, a call costs one environment lookup, made once.
"""

from __future__ import annotations

import os

_path: str | None = None
_checked = False


def beat() -> None:
    global _path, _checked
    if not _checked:
        _path = os.environ.get("REMFX_HEARTBEAT") or None
        _checked = True
        if _path:
            # created at once, so that a supervisor sees liveness from t=0
            open(_path, "a").close()
    if _path:
        try:
            os.utime(_path, None)
        except FileNotFoundError:
            open(_path, "a").close()
