"""Host-bridge generator: C ABI <-> embedded Python <-> the port (the
port's counterpart of geosongpu_tpu/interop/generator.py, writing the same
files).

From an interface definition (JSON; YAML where pyyaml is installed) it
generates:

  {p}_bridge.h   C header: int {p}_{fn}(...) per function + validation
  {p}_bridge.c   CPython-embedding trampolines (Py_Initialize once, GIL
                 handling, pointer+shape marshaling)
  {p}_bridge.py  dispatcher: zero-copy numpy views -> user hook
  {p}_hook.py    user-editable springboard (default: no-op); a hook moves
                 the views to the card with torch (interop/dycore.py is
                 the dycore's)
  {p}_interface.f90  Fortran bind(c) module + generated dual-execution
                 validate_{fn} subroutines, so a GEOS-style Fortran host
                 consumes the bridge without hand-written declarations
  CMakeLists_{p}.txt  build fragment linking libpython

Validation mode (dual execution on deep copies): for each function with
`validation: true`, the C side also gets {p}_validate_{fn}(ref_buf,
test_buf, n, rtol) which calls the Python comparator and returns 0/1, and
the Fortran module gets `validate_{fn}` which deep-copies every inout/out
array, runs a caller-supplied reference procedure on one copy and the
bridged Python on the other, and compares them through the same
comparator.

Fortran <-> Python layout: the generated wrappers pass array dims
REVERSED (size(a, rank) ... size(a, 1)), so the zero-copy C-order numpy
view in the hook has shape (n_rank, ..., n_1) over the same memory -
Fortran element a(i, j) is Python a[j-1, i-1].  No copies, no transposes.
"""
from __future__ import annotations

import json
import os
import sysconfig
from dataclasses import dataclass
from typing import Dict, List

from .argument import Argument, parse_arguments


@dataclass
class Function:
    name: str
    inputs: List[Argument]
    inouts: List[Argument]
    outputs: List[Argument]
    validation: bool = False

    @property
    def all_args(self) -> List[Argument]:
        return self.inputs + self.inouts + self.outputs


class Bridge:
    def __init__(self, prefix: str, functions: List[Function]):
        self.prefix = prefix
        self.functions = functions

    @classmethod
    def from_file(cls, path: str) -> "Bridge":
        """The definition at `path`: JSON, or YAML (a .yaml or .yml file)
        where pyyaml is installed."""
        with open(path) as f:
            text = f.read()
        if not path.endswith((".yaml", ".yml")):
            return cls.from_spec(json.loads(text))
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"{path}: reading a YAML definition needs pyyaml, which is "
                "not installed; give the definition as JSON") from None
        return cls.from_spec(yaml.safe_load(text))

    @classmethod
    def from_spec(cls, spec: dict) -> "Bridge":
        prefix = spec["name"]
        fns = []
        for fname, fspec in (spec.get("functions") or {}).items():
            fspec = fspec or {}
            fns.append(Function(
                name=fname,
                inputs=parse_arguments(fspec.get("inputs"), "in"),
                inouts=parse_arguments(fspec.get("inouts"), "inout"),
                outputs=parse_arguments(fspec.get("outputs"), "out"),
                validation=bool(fspec.get("validation", False)),
            ))
        return cls(prefix, fns)

    # ------------------------------------------------------------------
    def c_header(self) -> str:
        p = self.prefix
        lines = [
            f"/* generated by geosongpu_tpu_torch.interop - do not edit */",
            f"#ifndef {p.upper()}_BRIDGE_H",
            f"#define {p.upper()}_BRIDGE_H",
            "#ifdef __cplusplus",
            'extern "C" {',
            "#endif",
            "",
            f"int {p}_bridge_init(const char* python_dir);",
            f"void {p}_bridge_finalize(void);",
            "",
        ]
        for fn in self.functions:
            params = []
            for a in fn.all_args:
                params.extend(a.c_params())
            lines.append(f"int {p}_{fn.name}({', '.join(params) or 'void'});")
            if fn.validation:
                lines.append(
                    f"int {p}_validate_{fn.name}(const double* ref, "
                    f"const double* test, int n, double rtol);")
        lines += ["", "#ifdef __cplusplus", "}", "#endif", "#endif", ""]
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def c_source(self) -> str:
        p = self.prefix
        out = [
            f"/* generated by geosongpu_tpu_torch.interop - do not edit */",
            "#include <Python.h>",
            "#include <stdio.h>",
            "#include <stdint.h>",
            f'#include "{p}_bridge.h"',
            "",
            "static PyObject* g_mod = NULL;",
            "static int g_owns_interp = 0;",
            "",
            f"int {p}_bridge_init(const char* python_dir) {{",
            "    if (!Py_IsInitialized()) { Py_Initialize(); g_owns_interp = 1; }",
            "    PyGILState_STATE st = PyGILState_Ensure();",
            "    PyObject* sys_path = PySys_GetObject(\"path\");",
            "    if (python_dir) {",
            "        PyObject* d = PyUnicode_FromString(python_dir);",
            "        PyList_Append(sys_path, d);",
            "        Py_DECREF(d);",
            "    }",
            f"    g_mod = PyImport_ImportModule(\"{p}_bridge\");",
            "    if (!g_mod) { PyErr_Print(); PyGILState_Release(st); return 1; }",
            "    PyGILState_Release(st);",
            "    return 0;",
            "}",
            "",
            f"void {p}_bridge_finalize(void) {{",
            "    Py_XDECREF(g_mod);",
            "    g_mod = NULL;",
            "}",
            "",
        ]
        for fn in self.functions:
            params = []
            fmt = []
            callargs = []
            for a in fn.all_args:
                params.extend(a.c_params())
                if a.is_array:
                    fmt.append("K")
                    callargs.append(
                        f"(unsigned long long)(uintptr_t){a.name}")
                    for d in range(a.rank):
                        fmt.append("i")
                        callargs.append(f"{a.name}_n{d}")
                elif a.type == "int":
                    fmt.append("i")
                    callargs.append(a.name)
                elif a.type == "mesh":
                    fmt.append("L")
                    callargs.append(a.name)
                else:
                    fmt.append("d")
                    callargs.append(a.name)
            fmt_s = "(" + "".join(fmt) + ")" if fmt else "()"
            arglist = (", " + ", ".join(callargs)) if callargs else ""
            out += [
                f"int {p}_{fn.name}({', '.join(params) or 'void'}) {{",
                "    if (!g_mod) { fprintf(stderr, \"bridge not initialized\\n\"); return 2; }",
                "    PyGILState_STATE st = PyGILState_Ensure();",
                f"    PyObject* r = PyObject_CallMethod(g_mod, \"{fn.name}\", \"{fmt_s}\"{arglist});",
                "    int rc = 0;",
                "    if (!r) { PyErr_Print(); rc = 1; } else { Py_DECREF(r); }",
                "    PyGILState_Release(st);",
                "    return rc;",
                "}",
                "",
            ]
            if fn.validation:
                out += [
                    f"int {p}_validate_{fn.name}(const double* ref, const double* test, int n, double rtol) {{",
                    "    if (!g_mod) return 2;",
                    "    PyGILState_STATE st = PyGILState_Ensure();",
                    f"    PyObject* r = PyObject_CallMethod(g_mod, \"validate_{fn.name}\", \"(KKid)\",",
                    "        (unsigned long long)(uintptr_t)ref,",
                    "        (unsigned long long)(uintptr_t)test, n, rtol);",
                    "    int rc = 3;",
                    "    if (!r) { PyErr_Print(); } else { rc = (int)PyLong_AsLong(r); Py_DECREF(r); }",
                    "    PyGILState_Release(st);",
                    "    return rc;",
                    "}",
                    "",
                ]
        return "\n".join(out)

    # ------------------------------------------------------------------
    def py_source(self) -> str:
        p = self.prefix
        out = [
            f'"""generated by geosongpu_tpu_torch.interop - do not edit."""',
            "import ctypes",
            "import numpy as np",
            "",
            f"import {p}_hook as hook",
            "",
            "",
            "def _view(ptr, dtype, shape):",
            "    ct = {'float32': ctypes.c_float, 'float64': ctypes.c_double,",
            "          'int32': ctypes.c_int32}[dtype]",
            "    n = 1",
            "    for s in shape:",
            "        n *= s",
            "    buf = ctypes.cast(ptr, ctypes.POINTER(ct * n)).contents",
            "    return np.frombuffer(buf, dtype=dtype).reshape(shape)",
            "",
        ]
        for fn in self.functions:
            sig = []
            body = []
            hook_args = []
            for a in fn.all_args:
                if a.is_array:
                    dims = [f"{a.name}_n{d}" for d in range(a.rank)]
                    sig.extend([f"{a.name}_ptr"] + dims)
                    body.append(
                        f"    {a.name} = _view({a.name}_ptr, "
                        f"'{a.np_dtype}', ({', '.join(dims)},))")
                else:
                    sig.append(a.name)
                hook_args.append(f"{a.name}={a.name}")
            out += [
                f"def {fn.name}({', '.join(sig)}):",
                *body,
                f"    hook.{fn.name}({', '.join(hook_args)})",
                "    return 0",
                "",
                "",
            ]
            if fn.validation:
                out += [
                    f"def validate_{fn.name}(ref_ptr, test_ptr, n, rtol):",
                    "    ref = _view(ref_ptr, 'float64', (n,))",
                    "    test = _view(test_ptr, 'float64', (n,))",
                    "    ok = np.allclose(test, ref, rtol=rtol, atol=rtol)",
                    "    if not ok:",
                    "        bad = np.abs(test - ref)",
                    f"        print('validate_{fn.name}: max |diff| =', bad.max())",
                    "    return 0 if ok else 1",
                    "",
                    "",
                ]
        return "\n".join(out)

    # ------------------------------------------------------------------
    def hook_source(self) -> str:
        p = self.prefix
        out = [
            f'"""User hook for the {p} bridge - edit me.',
            "",
            "Arrays arrive as zero-copy numpy views of the host buffers;",
            "convert with torch.from_numpy(view).to(device), write "
            "results back",
            "into the views to return data to the host (the reference's",
            "hook.py.jinja2 contract).",
            '"""',
            "",
        ]
        for fn in self.functions:
            args = ", ".join(f"{a.name}=None" for a in fn.all_args)
            out += [
                f"def {fn.name}({args}):",
                f"    # TODO: implement {fn.name}",
                "    pass",
                "",
                "",
            ]
        return "\n".join(out)

    # ------------------------------------------------------------------
    def f90_source(self) -> str:
        """Fortran bind(c) interface module + dual-execution validation.

        A Fortran host calls `{p}_{fn}_f(...)` with its native arrays;
        `validate_{fn}_f` deep-copies every inout/out array, runs a
        caller-supplied reference procedure on one copy and the bridged
        Python on the other, and compares them elementwise within rtol.
        """
        p = self.prefix

        def f_type(a: Argument) -> str:
            return {
                "int": "integer(c_int)",
                "float": "real(c_float)",
                "double": "real(c_double)",
                "mesh": "integer(c_long_long)",
                "array_float": "real(c_float)",
                "array_double": "real(c_double)",
                "array_int": "integer(c_int)",
            }[a.type]

        def dims(a: Argument) -> str:
            return ", ".join([":"] * a.rank)

        def intent(a: Argument) -> str:
            return {"in": "in", "inout": "inout", "out": "inout"}[a.intent]
            # (out arrays are intent(inout) at the wrapper level: the C side
            # writes through the pointer; `out` would let Fortran skip the
            # copy-in of an unsaved actual argument)

        lines = [
            f"! generated by geosongpu_tpu_torch.interop - do not edit",
            f"module {p}_interface_mod",
            "    use iso_c_binding, only: c_int, c_float, c_double, "
            "c_char, c_long_long, c_null_char, c_loc",
            "    implicit none",
            "    private",
            f"    public :: {p}_bridge_init_f, {p}_bridge_finalize_f",
        ]
        for fn in self.functions:
            lines.append(f"    public :: {p}_{fn.name}_f")
            if fn.validation:
                lines.append(f"    public :: validate_{p}_{fn.name}_f")
        lines += [
            "",
            "    interface",
            f"        function {p}_bridge_init_c(python_dir) "
            f"bind(c, name='{p}_bridge_init') result(rc)",
            "            import c_int, c_char",
            "            character(kind=c_char), dimension(*), "
            "intent(in) :: python_dir",
            "            integer(c_int) :: rc",
            f"        end function {p}_bridge_init_c",
            "",
            f"        subroutine {p}_bridge_finalize_f() "
            f"bind(c, name='{p}_bridge_finalize')",
            f"        end subroutine {p}_bridge_finalize_f",
            "",
        ]
        # bind(c) interfaces to the C trampolines
        for fn in self.functions:
            args = []
            decls = []
            for a in fn.all_args:
                if a.is_array:
                    args.append(a.name)
                    args.extend(f"{a.name}_n{d}" for d in range(a.rank))
                    decls.append(f"            {f_type(a)}, "
                                 f"intent(inout) :: {a.name}(*)")
                    decls.extend(
                        f"            integer(c_int), value :: {a.name}_n{d}"
                        for d in range(a.rank))
                else:
                    args.append(a.name)
                    decls.append(f"            {f_type(a)}, value :: {a.name}")
            arg_s = ", ".join(args)
            lines += [
                f"        function {p}_{fn.name}_c({arg_s}) "
                f"bind(c, name='{p}_{fn.name}') result(rc)",
                "            import c_int, c_float, c_double, c_long_long",
                *decls,
                "            integer(c_int) :: rc",
                f"        end function {p}_{fn.name}_c",
                "",
            ]
            if fn.validation:
                lines += [
                    f"        function {p}_validate_{fn.name}_c"
                    f"(ref, test, n, rtol) "
                    f"bind(c, name='{p}_validate_{fn.name}') result(rc)",
                    "            import c_int, c_double",
                    "            real(c_double), intent(in) :: ref(*), test(*)",
                    "            integer(c_int), value :: n",
                    "            real(c_double), value :: rtol",
                    "            integer(c_int) :: rc",
                    f"        end function {p}_validate_{fn.name}_c",
                    "",
                ]
        lines += ["    end interface", "", "contains", ""]

        # init helper (null-terminates the path)
        lines += [
            f"    function {p}_bridge_init_f(python_dir) result(rc)",
            "        character(len=*), intent(in) :: python_dir",
            "        integer :: rc",
            f"        rc = {p}_bridge_init_c(trim(python_dir)//c_null_char)",
            f"    end function {p}_bridge_init_f",
            "",
        ]

        def wrapper_sig(fn: Function):
            """(arg names, dummy declarations) for the typed wrapper."""
            names, decls = [], []
            for a in fn.all_args:
                names.append(a.name)
                if a.is_array:
                    decls.append(
                        f"        {f_type(a)}, intent({intent(a)}), "
                        f"contiguous, target :: {a.name}({dims(a)})")
                else:
                    decls.append(
                        f"        {f_type(a)}, intent(in) :: {a.name}")
            return names, decls

        def c_call_args(fn: Function, rename=None) -> str:
            """Actual-argument list for the bind(c) call; dims REVERSED so
            the Python C-order view matches Fortran column-major memory."""
            rename = rename or {}
            parts = []
            for a in fn.all_args:
                nm = rename.get(a.name, a.name)
                if a.is_array:
                    parts.append(nm)
                    parts.extend(
                        f"int(size({nm}, {d}), c_int)"
                        for d in range(a.rank, 0, -1))
                else:
                    parts.append(a.name)
            return ", ".join(parts)

        # typed wrappers
        for fn in self.functions:
            names, decls = wrapper_sig(fn)
            lines += [
                f"    subroutine {p}_{fn.name}_f({', '.join(names + ['rc'])})",
                *decls,
                "        integer, intent(out) :: rc",
                f"        rc = {p}_{fn.name}_c({c_call_args(fn)})",
                f"    end subroutine {p}_{fn.name}_f",
                "",
            ]

        # dual-execution validation subroutines
        for fn in self.functions:
            if not fn.validation:
                continue
            names, decls = wrapper_sig(fn)
            mutable = [a for a in fn.all_args
                       if a.is_array and a.intent in ("inout", "out")]
            copy_decls = []
            for a in mutable:
                copy_decls += [
                    f"        {f_type(a)}, allocatable :: "
                    f"{a.name}_fref({dims(a)}), {a.name}_py({dims(a)})",
                ]
            body = []
            for a in mutable:
                body += [
                    f"        {a.name}_fref = {a.name}",
                    f"        {a.name}_py = {a.name}",
                ]
            rename = {a.name: f"{a.name}_py" for a in mutable}
            ref_args = [f"{a.name}_fref" if a.name in rename else a.name
                        for a in fn.all_args]
            body += [
                f"        call ref_impl({', '.join(ref_args)})",
                f"        rc = {p}_{fn.name}_c({c_call_args(fn, rename)})",
                "        if (rc /= 0) return",
            ]
            for a in mutable:
                body += [
                    f"        rc = max(rc, {p}_validate_{fn.name}_c( &",
                    f"            real(reshape({a.name}_fref, "
                    f"[size({a.name}_fref)]), c_double), &",
                    f"            real(reshape({a.name}_py, "
                    f"[size({a.name}_py)]), c_double), &",
                    f"            int(size({a.name}_py), c_int), rtol))",
                ]
            # the reference procedure's dummy interface mirrors the
            # in/inout/out argument list (no rc)
            iface_decls = []
            for a, d in zip(fn.all_args, decls):
                iface_decls.append("    " + d.replace(", target", ""))
            lines += [
                f"    subroutine validate_{p}_{fn.name}_f("
                f"{', '.join(names + ['ref_impl', 'rtol', 'rc'])})",
                *decls,
                "        interface",
                f"            subroutine ref_impl({', '.join(names)})",
                "                import c_int, c_float, c_double, "
                "c_long_long",
                *iface_decls,
                "            end subroutine ref_impl",
                "        end interface",
                "        real(c_double), intent(in) :: rtol",
                "        integer, intent(out) :: rc",
                *copy_decls,
                *body,
            ]
            # write the python result back into the caller's arrays (the
            # bridged implementation is the production path)
            for a in mutable:
                lines.append(f"        {a.name} = {a.name}_py")
            lines += [
                f"    end subroutine validate_{p}_{fn.name}_f",
                "",
            ]

        lines += [f"end module {p}_interface_mod", ""]
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def cmake_fragment(self) -> str:
        p = self.prefix
        inc = sysconfig.get_paths()["include"]
        libdir = sysconfig.get_config_var("LIBDIR")
        ver = sysconfig.get_config_var("LDVERSION")
        return "\n".join([
            f"# generated by geosongpu_tpu_torch.interop",
            f"add_library({p}_bridge SHARED {p}_bridge.c)",
            f"target_include_directories({p}_bridge PRIVATE {inc})",
            f"target_link_directories({p}_bridge PRIVATE {libdir})",
            f"target_link_libraries({p}_bridge PRIVATE python{ver})",
            "",
        ])

    # ------------------------------------------------------------------
    def write(self, directory: str) -> Dict[str, str]:
        os.makedirs(directory, exist_ok=True)
        p = self.prefix
        files = {
            f"{p}_bridge.h": self.c_header(),
            f"{p}_bridge.c": self.c_source(),
            f"{p}_bridge.py": self.py_source(),
            f"{p}_interface.f90": self.f90_source(),
            f"CMakeLists_{p}.txt": self.cmake_fragment(),
        }
        hook = os.path.join(directory, f"{p}_hook.py")
        if not os.path.exists(hook):  # never clobber user edits
            files[f"{p}_hook.py"] = self.hook_source()
        out = {}
        for name, content in files.items():
            path = os.path.join(directory, name)
            with open(path, "w") as f:
                f.write(content)
            out[name] = path
        return out
