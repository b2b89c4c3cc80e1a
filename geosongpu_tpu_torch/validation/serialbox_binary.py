"""Minimal reader/writer for Serialbox-2 style binary dump directories
(the port's copy of geosongpu_tpu/validation/serialbox_binary.py).

The converter (serialbox_convert.py) is serializer-agnostic; where a
serialbox build exists it injects the real `serialbox` python module (the
reference's tcn/validation/serialbox/serialbox_dat_to_netcdf.py:75-79).
Neither this repository's hosts nor the card's machine have one, so this
module implements the serialbox-2 ON-DISK layout (BinaryArchive,
uncompressed) itself:

    <dir>/MetaData-<prefix>.json         savepoints + field map
    <dir>/ArchiveMetaData-<prefix>.json  per-field record table
    <dir>/<prefix>_<field>.dat           raw records, appended in
                                         invocation order (little-endian,
                                         C layout, no headers)

`BinaryDatSerializer` exposes the same duck-typed surface the converter
uses (`savepoint_list`, `fields_at_savepoint`, `read`), so
``convert(..., serializer_factory=binary_serializer_factory(dir))``
parses real bytes end-to-end.  `write_fixture` produces directories in
the same layout (used by the fixture-generation test and usable to
round-trip recorded data).  JSON key variants used by different
serialbox minor versions ("__name" vs "name", ...) are read tolerantly;
the raw `.dat` record layout (the part that matters for bit-correct
field recovery) is the BinaryArchive one: tightly packed C-order
records at offsets recorded in the archive table.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

_TYPE_MAP = {
    "int": np.int32,
    "int32": np.int32,
    "int64": np.int64,
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
}


class _Savepoint:
    def __init__(self, name: str, meta: Optional[dict] = None):
        self.name = name
        self.metainfo = meta or {}

    def __repr__(self):
        return self.name


class BinaryDatSerializer:
    """Read-only serializer over a serialbox-style binary directory."""

    def __init__(self, directory: str, prefix: str):
        self.directory = directory
        self.prefix = prefix
        with open(os.path.join(directory, f"MetaData-{prefix}.json")) as f:
            self.meta = json.load(f)
        with open(os.path.join(directory,
                               f"ArchiveMetaData-{prefix}.json")) as f:
            self.archive = json.load(f)
        self._field_map = self.meta.get("field_map", {})
        self._sp_raw = self.meta.get("savepoint_vector", [])
        # fields_table: field -> list of [invocation, offset, checksum]
        self._table = self.archive.get("fields_table", {})

    # -- converter surface -------------------------------------------------
    def savepoint_list(self) -> List[_Savepoint]:
        out = []
        for sp in self._sp_raw:
            name = sp.get("__name", sp.get("name"))
            out.append(_Savepoint(name, sp.get("__meta_info",
                                               sp.get("meta_info"))))
        return out

    def fields_at_savepoint(self, sp) -> List[str]:
        name = sp.name if hasattr(sp, "name") else str(sp)
        for raw in self._sp_raw:
            if raw.get("__name", raw.get("name")) == name:
                flds = raw.get("fields", {})
                return list(flds.keys())
        return []

    def _sp_invocation(self, sp, field: str) -> int:
        name = sp.name if hasattr(sp, "name") else str(sp)
        for raw in self._sp_raw:
            if raw.get("__name", raw.get("name")) == name:
                entry = raw.get("fields", {}).get(field)
                if entry is None:
                    raise KeyError(f"{field} not at savepoint {name}")
                # [field_id, invocation] pair or bare invocation
                return int(entry[1]) if isinstance(entry, (list, tuple)) \
                    else int(entry)
        raise KeyError(name)

    def read(self, field: str, sp) -> np.ndarray:
        info = self._field_map[field]
        dims = info.get("__dims", info.get("dims"))
        tname = info.get("__type", info.get("type", "double"))
        dtype = _TYPE_MAP[str(tname)]
        inv = self._sp_invocation(sp, field)
        nbytes = int(np.prod(dims)) * np.dtype(dtype).itemsize
        offset = None
        for rec in self._table.get(field, []):
            if int(rec[0]) == inv:
                offset = int(rec[1])
                break
        if offset is None:
            # BinaryArchive default: fixed-size records in invocation order
            offset = inv * nbytes
        path = os.path.join(self.directory, f"{self.prefix}_{field}.dat")
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise IOError(f"short read for {field}@{inv} in {path}")
        return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<")
                             ).reshape(dims).copy()


def binary_serializer_factory(dat_dir: str, prefix_fmt:
                              str = "Generator_rank{rank}"):
    """serializer_factory for serialbox_convert.convert over a binary
    dump directory (the no-serialbox-host path)."""

    def make(rank: int):
        return BinaryDatSerializer(dat_dir, prefix_fmt.format(rank=rank))

    return make


# --------------------------------------------------------------------------
# fixture / round-trip writer
# --------------------------------------------------------------------------

def write_fixture(directory: str, prefix: str,
                  savepoints: List[str],
                  fields: Dict[str, List[np.ndarray]]) -> None:
    """Write a serialbox-style binary directory.

    fields: name -> per-savepoint arrays (same shape/dtype per field).
    Records are appended raw (little-endian, C order) to
    `<prefix>_<field>.dat`; offsets and sizes go into the archive
    table; savepoint/field metadata into MetaData-<prefix>.json."""
    os.makedirs(directory, exist_ok=True)
    field_map = {}
    table: Dict[str, list] = {}
    for name, arrays in fields.items():
        assert len(arrays) == len(savepoints)
        a0 = np.ascontiguousarray(arrays[0])
        tname = {np.dtype(np.float64): "double",
                 np.dtype(np.float32): "float",
                 np.dtype(np.int32): "int",
                 np.dtype(np.int64): "int64"}[a0.dtype]
        field_map[name] = {"__id": len(field_map),
                           "__type": tname,
                           "__dims": list(a0.shape),
                           "__meta_info": {}}
        path = os.path.join(directory, f"{prefix}_{name}.dat")
        offs = []
        with open(path, "wb") as f:
            for inv, a in enumerate(arrays):
                a = np.ascontiguousarray(a, dtype=a0.dtype)
                offs.append([inv, f.tell(), ""])
                f.write(a.astype(a.dtype.newbyteorder("<"),
                                 copy=False).tobytes())
        table[name] = offs

    sp_vec = []
    for i, sp in enumerate(savepoints):
        sp_vec.append({
            "__name": sp,
            "__meta_info": {},
            "fields": {name: [field_map[name]["__id"], i]
                       for name in fields},
        })
    meta = {
        "serialbox_version": 213,
        "prefix": prefix,
        "global_meta_info": {},
        "savepoint_vector": sp_vec,
        "field_map": field_map,
    }
    with open(os.path.join(directory, f"MetaData-{prefix}.json"),
              "w") as f:
        json.dump(meta, f, indent=1)
    archive = {
        "archive_name": "Binary",
        "serialbox_version": 213,
        "extension": ".dat",
        "fields_table": table,
    }
    with open(os.path.join(directory,
                           f"ArchiveMetaData-{prefix}.json"), "w") as f:
        json.dump(archive, f, indent=1)
