"""Device-init watchdog for card-facing entry points.

Port of ``fer_vit_tpu/utils/watchdog.py``. A wedged CUDA stack or card can
make the first CUDA call hang rather than fail, which would stall a script
with no end. Arm the watchdog before the first ``torch.cuda`` call that touches
the card and cancel it as soon as that call returns: if it does not return
in time, the process exits with code 2 and a diagnosis.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional


def arm_device_init_watchdog(seconds: Optional[float] = None,
                             env_var: str = "FERVIT_INIT_TIMEOUT",
                             default: float = 300) -> threading.Timer:
    """Start a daemon timer that ends the process unless cancelled first;
    ``seconds`` defaults to ``$FERVIT_INIT_TIMEOUT`` or ``default``.
    Returns the timer: call ``.cancel()`` once device init has returned."""
    if seconds is None:
        seconds = float(os.environ.get(env_var, str(default)))

    def _abort():
        print(f"device-init watchdog: CUDA device init exceeded {seconds} s "
              "(CUDA stack or card hung? probe: nvidia-smi)", flush=True,
              file=sys.stderr)
        os._exit(2)

    t = threading.Timer(seconds, _abort)
    t.daemon = True
    t.start()
    return t
