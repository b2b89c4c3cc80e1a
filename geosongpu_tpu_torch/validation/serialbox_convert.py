"""Serialbox savepoint -> NetCDF/npz converter (the port's copy of
geosongpu_tpu/validation/serialbox_convert.py).

As the reference's tcn/validation/serialbox/serialbox_dat_to_netcdf.py:
rank count from the model layout x 6 tiles (:91-93), per-savepoint output
files, 1e40 sentinel -> 0 (:51), 3-cell tracer-halo trims for
FVDynamics/Driver savepoints (:150-161), SERIALBOX_PYTHON gating (:75-79).

The card's machine has no serialbox build either, so the import stays
gated exactly like the reference's; the assembly is serializer-agnostic
(dependency-injected): validation/serialbox_binary.py reads the on-disk
layout without serialbox, and tests/test_torch_validation.py holds the
conversion to the JAX package's.  assemble_ranks concatenates blocks
without dropping the interfaces two blocks share, so a staggered field
([bny+1, bnx] blocks) stitches to n + ly rows, as in the reference.
"""
from __future__ import annotations

import os
import re
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

SENTINEL = 1.0e40
NTILES = 6


def _import_serialbox():
    sb_path = os.environ.get("SERIALBOX_PYTHON")
    if not sb_path:
        raise RuntimeError(
            "SERIALBOX_PYTHON must point at serialbox's python dir "
            "(same contract as the reference converter)")
    if sb_path not in sys.path:
        sys.path.append(sb_path)
    import serialbox  # type: ignore

    return serialbox


def _default_serializer_factory(dat_dir: str):
    serialbox = _import_serialbox()

    def make(rank: int):
        return serialbox.Serializer(serialbox.OpenModeKind.Read, dat_dir,
                                    f"Generator_rank{rank}")

    return make


def clean_sentinels(a: np.ndarray) -> np.ndarray:
    """Reference behavior: 1e40 'undefined' values -> 0."""
    out = np.array(a)
    out[np.abs(out) >= SENTINEL] = 0.0
    return out


def trim_halo(a: np.ndarray, halo: int = 3) -> np.ndarray:
    """Trim per-rank tracer halos (reference trims 3 cells for
    FVDynamics/Driver savepoints, :150-161)."""
    if a.ndim < 2 or min(a.shape[:2]) <= 2 * halo:
        return a
    return a[halo:-halo, halo:-halo]


def layout_from_nml(nml_path: str) -> Tuple[int, int]:
    """Rank layout from an input.nml (`layout = NX, NY` in fv_core_nml) -
    the reference derives rank count the same way (:91-93).  Uses f90nml
    when available, a tolerant regex otherwise."""
    try:
        import f90nml  # type: ignore

        nml = f90nml.read(nml_path)
        lay = nml["fv_core_nml"]["layout"]
        return int(lay[0]), int(lay[1])
    except Exception:
        pass
    with open(nml_path) as f:
        text = f.read()
    m = re.search(r"layout\s*=\s*(\d+)\s*,\s*(\d+)", text)
    if not m:
        raise ValueError(f"no `layout = NX, NY` found in {nml_path}")
    return int(m.group(1)), int(m.group(2))


def _needs_trim(sp_name: str) -> bool:
    return "FVDynamics" in sp_name or "Driver" in sp_name


def assemble_ranks(per_rank: List[np.ndarray], lx: int, ly: int
                   ) -> np.ndarray:
    """Stitch one tile's rank subdomains [ly*lx blocks of (ny, nx, ...)]
    into the tile array [ny*ly, nx*lx, ...].  Rank order: x-major within
    the tile (rank = by*lx + bx), the MPI layout convention the
    reference's `input.nml` layouts imply."""
    assert len(per_rank) == lx * ly
    rows = []
    for by in range(ly):
        rows.append(np.concatenate(per_rank[by * lx:(by + 1) * lx], axis=1))
    return np.concatenate(rows, axis=0)


def convert(dat_dir: str, out_dir: str, layout: Tuple[int, int] = (1, 1),
            nml: Optional[str] = None, savepoint: Optional[str] = None,
            halo: int = 3, fmt: str = "auto",
            serializer_factory: Optional[Callable] = None) -> List[str]:
    """Convert a Serialbox dump directory into one file per savepoint.

    All `6 * lx * ly` rank dumps are read; per-field rank subdomains are
    halo-trimmed (driver savepoints), sentinel-cleaned, stitched into
    [tile, ny, nx, ...] global arrays, and written as NetCDF (xarray, if
    installed) or .npz.  Returns the written paths."""
    if nml:
        layout = layout_from_nml(nml)
    lx, ly = layout
    nranks = NTILES * lx * ly
    make = serializer_factory or _default_serializer_factory(dat_dir)
    sers = [make(r) for r in range(nranks)]

    sp_names: List[str] = []
    for sp in sers[0].savepoint_list():
        name = sp.name if hasattr(sp, "name") else str(sp)
        if savepoint and savepoint not in name:
            continue
        sp_names.append(name)

    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for spi, sp in enumerate(s for s in sers[0].savepoint_list()
                             if (s.name if hasattr(s, "name") else str(s))
                             in sp_names):
        name = sp.name if hasattr(sp, "name") else str(sp)
        fields: Dict[str, np.ndarray] = {}
        for field in sers[0].fields_at_savepoint(sp):
            tiles = []
            for tile in range(NTILES):
                blocks = []
                for rr in range(lx * ly):
                    rank = tile * lx * ly + rr
                    data = clean_sentinels(
                        np.asarray(sers[rank].read(field, sp)))
                    if _needs_trim(name):
                        data = trim_halo(data, halo)
                    blocks.append(data)
                tiles.append(assemble_ranks(blocks, lx, ly))
            fields[field] = np.stack(tiles, axis=0)

        base = os.path.join(out_dir, f"{name}".replace("/", "_"))
        use_nc = fmt == "nc" or (fmt == "auto" and _have_xarray())
        if use_nc:
            path = base + ".nc4"
            _write_netcdf(path, fields)
        else:
            path = base + ".npz"
            np.savez_compressed(path, **fields)
        written.append(path)
    return written


def _have_xarray() -> bool:
    try:
        import xarray  # noqa: F401

        return True
    except Exception:
        return False


def _write_netcdf(path: str, fields: Dict[str, np.ndarray]) -> None:
    import xarray as xr

    ds = {}
    for k, v in fields.items():
        dims = ["tile", "y", "x", "z", "n4", "n5"][:v.ndim]
        ds[k] = xr.DataArray(v, dims=dims)
    xr.Dataset(ds).to_netcdf(path)
