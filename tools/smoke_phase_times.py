#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with each phase's wall time kept.

Usage, on a machine with one card::

    python3 tools/smoke_phase_times.py [CHECKOUT]

``CHECKOUT`` is the root of a checkout of this repository (the one this
file is in by default). The script loads that checkout's
``chip_smoke.py`` as a module, wraps every top-level ``phase_*``
function so that its wall time is kept (a phase called from inside
another counts toward the outer one only), and runs its ``main()``
unchanged: the output is the smoke test's own, followed by one line
``[phase times] {"name": seconds, ...}`` in call order. The exit code is
``main()``'s. Two checkouts (say a commit and its parent) timed in one
call show which phases differ on the same host.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else Path(__file__).parent.parent).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    times, depth = {}, [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return run

    for name in [n for n in vars(smoke) if n.startswith("phase_")]:
        fn = getattr(smoke, name)
        if callable(fn):
            setattr(smoke, name, timed(name[len("phase_"):], fn))
    rc = smoke.main()
    print("[phase times] " + json.dumps({k: round(v, 1) for k, v in times.items()}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
