"""The port's dycore behind the generated bridge of interop/def_dycore.json.

A Fortran (or C) host holds the state of all six faces in column-major
arrays with the face index last:

    rank 3  a(i, j, face)              ps, phis
    rank 4  a(i, j, k, face)           u, v, w, delz, pt, delp, omga, ...
    rank 5  a(i, j, k, tracer, face)   q

i runs along x, j along y, k from the model top down.  The bridge passes
each array's dims reversed (generator.py), so the hook sees a zero-copy
C-order view of shape (face, j, i), (face, k, j, i) or
(face, tracer, k, j, i); VIEW_TO_PORT permutes such a view into the port's
[face, y, x, K(, tracer)] layout, PORT_TO_VIEW back.  A square c48 field
has the right shape under a wrong permutation too, so LayoutCheckHook
holds every element to its Fortran indices (`stamp`).

`DycoreHook` is the bridge's hook for a model of the port: `init` builds
the preset's model on its device, `run` moves the 14 DycoreState fields of
the views onto the device, takes one step and writes them back, and
`finalize` writes the kernel launches of the process and the milliseconds
of each run's three parts (copies in, step, copies out) to hook.json.
`dycore_host.c` is a host that drives the bridge as a Fortran program
would; `build_host` compiles it against the generated bridge and libpython.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sysconfig
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

# the fields of DycoreState, in the definition's order
STATE_FIELDS = ("u", "v", "w", "delz", "pt", "delp", "q", "ps", "phis",
                "omga", "ua", "va", "mfx", "mfy")
# the definition's other inout arrays: the port's state has no such field,
# and the hook leaves them as the host passed them
UNTOUCHED = ("pe", "pk", "peln", "pkz", "q_con", "uc", "vc", "cx", "cy",
             "diss_est")
# bridge view (reversed Fortran dims) -> the port's layout, by rank
VIEW_TO_PORT = {3: (0, 1, 2), 4: (0, 2, 3, 1), 5: (0, 3, 4, 2, 1)}
PORT_TO_VIEW = {r: tuple(int(a) for a in np.argsort(p))
                for r, p in VIEW_TO_PORT.items()}
HOST_SOURCE = os.path.join(os.path.dirname(__file__), "dycore_host.c")


def to_port(view: np.ndarray, device="cpu") -> torch.Tensor:
    """A bridge view as a new contiguous tensor on `device` in the port's
    layout: the view's memory is copied as it lies, and permuted on the
    device (a transposing copy on the host costs more than the transfer)."""
    t = torch.from_numpy(view).to(device).permute(VIEW_TO_PORT[view.ndim])
    return t.clone(memory_format=torch.contiguous_format)


def to_view(t: torch.Tensor, view: np.ndarray) -> None:
    """Write a port-layout tensor (on any device) into a bridge view: the
    permutation is made on the tensor's device, then copied into the view
    as it lies."""
    torch.from_numpy(view).copy_(t.permute(PORT_TO_VIEW[t.dim()]))


def write_fortran(path: str, a: np.ndarray) -> None:
    """A port-layout array as a raw float32 file in Fortran order."""
    np.ascontiguousarray(np.transpose(a, PORT_TO_VIEW[a.ndim]),
                         dtype=np.float32).tofile(path)


def read_fortran(path: str, shape: Tuple[int, ...]) -> np.ndarray:
    """A raw float32 Fortran-order file as an array of port `shape`."""
    view_shape = tuple(shape[i] for i in PORT_TO_VIEW[len(shape)])
    a = np.fromfile(path, np.float32).reshape(view_shape)
    return np.ascontiguousarray(np.transpose(a, VIEW_TO_PORT[len(shape)]))


def stamp(shape: Tuple[int, ...]) -> np.ndarray:
    """The coordinate stamp of a port-layout array: each element set from
    the 1-based Fortran indices of its host element,
    i + 16 (j + 16 (k + 16 (tracer + 4 face))), with k and tracer 0 where
    the rank has none (as dycore_host.c fills it)."""
    idx = np.indices(shape) + 1
    face, j, i = idx[0], idx[1], idx[2]
    k = idx[3] if len(shape) > 3 else 0
    t = idx[4] if len(shape) > 4 else 0
    return (i + 16 * (j + 16 * (k + 16 * (t + 4 * face)))).astype(np.float32)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available")
    return device


class DycoreHook:
    """init / run / finalize of the bridge for a preset of the port
    (cli.PRESETS) at the host's npx, npz, time step and tracer count.

    run() moves the 14 DycoreState fields onto the device, takes one
    model.step and writes them back.  The definition's other arrays (pe,
    pk, peln, pkz, q_con, uc, vc, cx, cy, diss_est) are left untouched: the
    port's state carries none of them."""

    PARTS = ("copy_in", "step", "copy_out")

    def __init__(self, preset: str, device, directory: str):
        self.preset = preset
        self.device = _device(device)
        self.directory = directory
        self.model = None
        self.ms = {p: [] for p in self.PARTS}

    def init(self, mesh=None, npx=None, npy=None, npz=None, ntiles=None,
             bdt=None, nq_tot=None, **_):
        from ..cli import PRESETS, build_model_for
        from ..ops.kernels import reset_launch_counts

        if npx != npy or ntiles != 6:
            raise ValueError(f"the port runs six square faces, not "
                             f"{ntiles} of {npx} x {npy}")
        cfg = dataclasses.replace(PRESETS[self.preset], npx=npx, npz=npz,
                                  dt=bdt, ntracers=nq_tot)
        self.model = build_model_for(self.preset)(cfg, self.device)
        reset_launch_counts()

    def run(self, mesh=None, npx=None, npy=None, npz=None, ntiles=None,
            bdt=None, ptop=None, ks=None, adiabatic=0, ak=None, bk=None,
            **arrays):
        from ..core.state import DycoreState

        model = self.model
        cfg = model.config
        # bdt and ptop come as C floats
        if (npx, npz, bdt, ptop) != (cfg.npx, cfg.npz, float(np.float32(
                cfg.dt)), float(np.float32(cfg.ptop))):
            raise ValueError(f"run(npx={npx}, npz={npz}, bdt={bdt}, ptop="
                             f"{ptop}) is not the model of init: {cfg}")
        if adiabatic:
            raise ValueError("adiabatic runs are not supported: the hook "
                             "takes the model's full step")
        if not (np.array_equal(ak, np.float32(model.ak))
                and np.array_equal(bk, np.float32(model.bk))):
            raise ValueError("the host's ak, bk are not the model's")
        marks = [time.perf_counter()]
        state = DycoreState(**{f: to_port(arrays[f], self.device)
                               for f in STATE_FIELDS})
        state.check_f32()
        marks.append(self._synchronized())
        state = model.step(state)
        marks.append(self._synchronized())
        for f in STATE_FIELDS:
            to_view(getattr(state, f), arrays[f])
        marks.append(time.perf_counter())
        for p, t0, t1 in zip(self.PARTS, marks, marks[1:]):
            self.ms[p].append((t1 - t0) * 1e3)

    def _synchronized(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def finalize(self):
        from ..ops.kernels import launch_counts

        with open(os.path.join(self.directory, "hook.json"), "w") as f:
            json.dump({"launches": launch_counts(), "ms": self.ms}, f)
        self.model = None


class LayoutCheckHook:
    """A hook that checks the bridge's layout instead of stepping: run()
    holds each array (all 24 of the definition), moved to `device` in the
    port's layout, to its coordinate stamp element for element, and writes
    the negated stamp back into the 14 DycoreState fields."""

    def __init__(self, device):
        self.device = _device(device)

    def init(self, **_):
        pass

    def run(self, ak=None, bk=None, **arrays):
        for name in STATE_FIELDS + UNTOUCHED:
            t = to_port(arrays[name], self.device)
            want = torch.from_numpy(stamp(tuple(t.shape))).to(self.device)
            if not torch.equal(t, want):
                bad = int((t != want).sum())
                raise ValueError(f"{name}: {bad} of {t.numel()} elements "
                                 "are not at their Fortran indices")
        for name in STATE_FIELDS:
            t = to_port(arrays[name], self.device)
            to_view(-t, arrays[name])

    def finalize(self):
        pass


def write_hook(directory: str, hook: str) -> str:
    """Write the bridge's hook module geos_tpufv3_hook.py into `directory`
    (after Bridge.write, which leaves an existing hook as it is): `hook` is
    the Python expression of the hook object, e.g.
    'DycoreHook("held_suarez_c48_l72_fused", "cuda", HERE)'."""
    path = os.path.join(directory, "geos_tpufv3_hook.py")
    with open(path, "w") as f:
        f.write(
            '"""Hook of the geos_tpufv3 bridge: the port\'s dycore '
            '(geosongpu_tpu_torch/interop/dycore.py)."""\n'
            "import os\n\n"
            "from geosongpu_tpu_torch.interop.dycore import (DycoreHook,\n"
            "                                                LayoutCheckHook)"
            "\n\n"
            "HERE = os.path.dirname(os.path.abspath(__file__))\n"
            f"_hook = {hook}\n"
            "init = _hook.init\n"
            "run = _hook.run\n"
            "finalize = _hook.finalize\n")
    return path


def embed_flags() -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) that embed this interpreter in a C
    program: its libpython, shared where the build has one, else static.
    Raises if the headers or the library are missing."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"no Python.h under {inc}: cannot embed CPython")
    var = sysconfig.get_config_var
    ver = var("LDVERSION")
    libdir = var("LIBDIR")
    shared = os.path.join(libdir or "", f"libpython{ver}.so")
    if var("Py_ENABLE_SHARED") and os.path.exists(shared):
        return [f"-I{inc}"], [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                              f"-lpython{ver}", "-lm"]
    for d in (var("LIBPL"), libdir):
        static = os.path.join(d or "", f"libpython{ver}.a")
        if os.path.exists(static):
            extra = " ".join(var(k) or "" for k in ("LIBS", "SYSLIBS",
                                                    "LINKFORSHARED"))
            return [f"-I{inc}"], [static] + extra.split() + ["-lm"]
    raise RuntimeError(f"no libpython{ver} (shared or static) under "
                       f"{libdir} or {var('LIBPL')}: cannot embed CPython")


def build_host(bridge_dir: str) -> str:
    """Compile dycore_host.c with the generated geos_tpufv3_bridge.c of
    `bridge_dir` into `bridge_dir`/dycore_host; returns its path."""
    cflags, ldflags = embed_flags()
    out = os.path.join(bridge_dir, "dycore_host")
    cmd = ["gcc", "-O2", "-o", out, HOST_SOURCE,
           os.path.join(bridge_dir, "geos_tpufv3_bridge.c"),
           f"-I{bridge_dir}"] + cflags + ldflags
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr}")
    return out


def host_env(bridge_dir: str, **extra: str) -> Dict[str, str]:
    """The host process's environment: the bridge's directory and the
    checkout that holds this package on PYTHONPATH."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (bridge_dir, root, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def write_inputs(data_dir: str, state: Dict[str, np.ndarray], ak, bk
                 ) -> None:
    """The host's input files: each DycoreState field as in_<name>.bin in
    Fortran order, ak.bin and bk.bin."""
    os.makedirs(data_dir, exist_ok=True)
    for f in STATE_FIELDS:
        write_fortran(os.path.join(data_dir, f"in_{f}.bin"), state[f])
    np.asarray(ak, np.float32).tofile(os.path.join(data_dir, "ak.bin"))
    np.asarray(bk, np.float32).tofile(os.path.join(data_dir, "bk.bin"))


def read_outputs(data_dir: str, shapes: Dict[str, Tuple[int, ...]]
                 ) -> Dict[str, np.ndarray]:
    """The host's out_<name>.bin files as port-layout arrays."""
    return {f: read_fortran(os.path.join(data_dir, f"out_{f}.bin"),
                            shapes[f]) for f in STATE_FIELDS}
