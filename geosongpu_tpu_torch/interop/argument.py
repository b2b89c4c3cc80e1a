"""Argument model for the host-bridge generator (the port's copy of
geosongpu_tpu/interop/argument.py).

Definition type names -> C types / Python hints / dim expressions, and
reserved-word sanitizing.  The MPI communicator of a Fortran host becomes
`mesh`: an opaque integer handle, passed through to the hook.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

C_RESERVED = {
    "auto", "break", "case", "char", "const", "continue", "default", "do",
    "double", "else", "enum", "extern", "float", "for", "goto", "if", "int",
    "long", "register", "return", "short", "signed", "sizeof", "static",
    "struct", "switch", "typedef", "union", "unsigned", "void", "volatile",
    "while", "is",
}

_TYPES = {
    "int": {"c": "int", "py": "int", "np": None, "array": False},
    "float": {"c": "float", "py": "float", "np": None, "array": False},
    "double": {"c": "double", "py": "float", "np": None, "array": False},
    "array_float": {"c": "float*", "py": "np.ndarray", "np": "float32",
                    "array": True},
    "array_double": {"c": "double*", "py": "np.ndarray", "np": "float64",
                     "array": True},
    "array_int": {"c": "int*", "py": "np.ndarray", "np": "int32",
                  "array": True},
    "mesh": {"c": "long long", "py": "int", "np": None, "array": False},
}


@dataclass
class Argument:
    name: str
    type: str
    rank: int = 1  # arrays only
    intent: str = "in"  # in | inout | out

    def __post_init__(self):
        if self.type not in _TYPES:
            raise ValueError(f"unknown argument type '{self.type}' "
                             f"(known: {sorted(_TYPES)})")
        if self.name in C_RESERVED:
            self.name = self.name + "_"

    @property
    def is_array(self) -> bool:
        return _TYPES[self.type]["array"]

    @property
    def c_type(self) -> str:
        return _TYPES[self.type]["c"]

    @property
    def np_dtype(self) -> str:
        return _TYPES[self.type]["np"]

    @property
    def ctypes_type(self) -> str:
        return {"array_float": "c_float", "array_double": "c_double",
                "array_int": "c_int32"}[self.type]

    def c_params(self) -> List[str]:
        """C parameter list entries for this argument."""
        if not self.is_array:
            return [f"{self.c_type} {self.name}"]
        dims = [f"int {self.name}_n{d}" for d in range(self.rank)]
        return [f"{self.c_type} {self.name}"] + dims

    def py_params(self) -> List[str]:
        if not self.is_array:
            return [self.name]
        return [f"{self.name}_ptr"] + [f"{self.name}_n{d}"
                                       for d in range(self.rank)]


def parse_arguments(spec: dict, intent: str) -> List[Argument]:
    """spec: {name: type} or {name: {type:, rank:}} mapping."""
    out = []
    for name, t in (spec or {}).items():
        if isinstance(t, dict):
            out.append(Argument(name=name, type=t["type"],
                                rank=int(t.get("rank", 1)), intent=intent))
        else:
            out.append(Argument(name=name, type=str(t), intent=intent))
    return out
