"""Helpers of the benchmark's tests."""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def small_cell(name: str, npx: int = 12, npz: int = 8):
    """The cell `name` of BENCHMARK.json at a small size: its configuration
    with npx and npz set, and its window's compared steps drawn among the
    first four."""
    from portbench import spec

    c = spec.cell(name)
    c.config["dycore"].update(npx=npx, npz=npz)
    c.traffic.update(pick_steps=4, trace_steps=2)
    return c


def load_run():
    """portbench/run.py as a module."""
    import importlib.util

    s = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(ROOT, "portbench", "run.py"))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod
