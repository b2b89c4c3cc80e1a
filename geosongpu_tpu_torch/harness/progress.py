"""Progress logging context manager (geosongpu_tpu/harness/progress.py):
each message prefixed, each timed block with its elapsed seconds."""
from __future__ import annotations

import time

PREFIX = "[GEOSONTPU]"


class Progress:
    def __init__(self, label: str):
        self.label = label
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.time()
        print(f"{PREFIX}: Running {self.label}...", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self._t0
        status = "FAILED" if exc_type else "Done"
        print(f"{PREFIX}: {status} {self.label} in {dt:.2f}s", flush=True)
        return False

    @staticmethod
    def log(message: str) -> None:
        print(f"{PREFIX}: {message}", flush=True)
