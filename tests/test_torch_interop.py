"""The port's host bridge (geosongpu_tpu_torch/interop) against the JAX
package's generator, and the port's dycore behind it.

The port's generator writes the reference's files line for line, but for
the banner that names the package and the default hook's line on moving
the views; its JSON definition of the dycore is the reference's YAML.  A C
host compiled against the generated bridge and libpython then drives the
toy hook of tests/test_interop.py, the layout check (each element stamped
from its Fortran indices, checked in the port's layout and written back
negated) and the eager Held-Suarez model at c8-L10, whose 2 bridged steps
must equal 2 direct steps bit for bit."""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from geosongpu_tpu.interop.generator import Bridge as JaxBridge  # noqa: E402
from geosongpu_tpu_torch.interop import dycore  # noqa: E402
from geosongpu_tpu_torch.interop.generator import Bridge  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REF_DEF = os.path.join(ROOT, "geosongpu_tpu", "interop", "def_dycore.yaml")
PORT_DEF = os.path.join(ROOT, "geosongpu_tpu_torch", "interop",
                        "def_dycore.json")

# the definition, the hook and the host of tests/test_interop.py
TEST_YAML = """\
name: testbr
functions:
  work:
    validation: true
    inputs:
      n: int
      scale: double
    inouts:
      data: {type: array_double, rank: 2}
  nothing: {}
"""
TEST_DEF = yaml.safe_load(TEST_YAML)

TOY_HOOK = """\
import numpy as np

def work(n=None, scale=None, data=None):
    # mutate through the zero-copy view: host must observe 11 * scale
    data[...] = 11.0 * scale

def nothing():
    pass
"""

TOY_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <math.h>
#include "testbr_bridge.h"

int main(void) {
    if (testbr_bridge_init(".")) { fprintf(stderr, "init failed\n"); return 10; }

    double data[6];
    for (int i = 0; i < 6; i++) data[i] = 1.0;
    if (testbr_work(7, 2.0, data, 2, 3)) return 11;
    for (int i = 0; i < 6; i++) {
        if (fabs(data[i] - 22.0) > 1e-12) {
            fprintf(stderr, "python write not observed: %f\n", data[i]);
            return 12;
        }
    }
    if (testbr_nothing()) return 13;

    /* dual-execution validation path */
    double ref[4] = {1.0, 2.0, 3.0, 4.0};
    double good[4] = {1.0, 2.0, 3.0, 4.0};
    double bad[4] = {1.0, 2.0, 3.5, 4.0};
    if (testbr_validate_work(ref, good, 4, 1e-9) != 0) return 14;
    if (testbr_validate_work(ref, bad, 4, 1e-9) != 1) return 15;

    testbr_bridge_finalize();
    printf("BRIDGE_OK\n");
    return 0;
}
"""

# the lines where the port's files differ on purpose: the banner names the
# port's package, and the default hook moves the views with torch
BANNER = ("geosongpu_tpu.interop", "geosongpu_tpu_torch.interop")
HOOK_LINE = ("convert with jnp.asarray to move to TPU, write results back",
             "convert with torch.from_numpy(view).to(device), write results "
             "back")


def _embeddable():
    if shutil.which("gcc") is None:
        return "no gcc"
    try:
        dycore.embed_flags()
    except RuntimeError as e:
        return str(e)
    return None


needs_embedding = pytest.mark.skipif(_embeddable() is not None,
                                     reason=f"cannot embed CPython here: "
                                            f"{_embeddable()}")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the generator against the reference's --------------------------------

@pytest.mark.parametrize("definition", ["test", "dycore"])
def test_generated_files_equal_the_reference(definition, tmp_path):
    if definition == "test":
        ref_bridge = JaxBridge.from_yaml(_write_yaml(tmp_path, TEST_YAML))
        port_bridge = Bridge.from_spec(TEST_DEF)
    else:
        ref_bridge = JaxBridge.from_yaml(REF_DEF)
        port_bridge = Bridge.from_file(PORT_DEF)
    ref = ref_bridge.write(str(tmp_path / "jax"))
    port = port_bridge.write(str(tmp_path / "torch"))
    assert sorted(ref) == sorted(port) and len(port) == 6
    changed = 0
    for name in ref:
        a = open(ref[name]).read().splitlines()
        b = open(port[name]).read().splitlines()
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            if x == y:
                continue
            changed += 1
            assert (x.replace(*BANNER) == y and i == 0) or \
                (x.strip(), y.strip()) == HOOK_LINE, (name, i, x, y)
    # the five banners and the hook's line
    assert changed == 6


def _write_yaml(tmp_path, text):
    path = tmp_path / "def.yaml"
    path.write_text(text)
    return str(path)


def test_json_definition_equals_the_yaml():
    with open(REF_DEF) as f:
        ref = yaml.safe_load(f)
    with open(PORT_DEF) as f:
        assert json.load(f) == ref


def test_from_file_reads_yaml_only_with_pyyaml(tmp_path, monkeypatch):
    path = _write_yaml(tmp_path, TEST_YAML)
    assert Bridge.from_file(path).c_source() == \
        Bridge.from_spec(TEST_DEF).c_source()
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    with pytest.raises(RuntimeError, match="needs pyyaml"):
        Bridge.from_file(path)
    # JSON needs no yaml
    Bridge.from_file(PORT_DEF)


def test_generator_imports_no_yaml_at_module_level():
    tree = ast.parse(open(os.path.join(ROOT, "geosongpu_tpu_torch",
                                       "interop", "generator.py")).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + \
        [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(n.split(".")[0] == "yaml" for n in names)


def test_cli_writes_the_bridge(tmp_path, capsys):
    from geosongpu_tpu_torch.interop.cli import main

    assert main([PORT_DEF, str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for name in ("geos_tpufv3_bridge.c", "geos_tpufv3_bridge.h",
                 "geos_tpufv3_bridge.py", "geos_tpufv3_hook.py",
                 "geos_tpufv3_interface.f90", "CMakeLists_geos_tpufv3.txt"):
        assert (tmp_path / name).is_file() and name in out
    h = (tmp_path / "geos_tpufv3_bridge.h").read_text()
    for var in dycore.STATE_FIELDS + dycore.UNTOUCHED:
        assert f"float* {var}" in h, var


# ---- the Fortran module (tests/test_interop_f90.py on the port) ----------

F90_MAIN = """\
program host
    use iso_c_binding, only: c_double, c_int
    use testbr_interface_mod
    implicit none
    real(c_double) :: data(2, 3)
    integer :: rc
    rc = testbr_bridge_init_f(".")
    if (rc /= 0) stop 10

    data = 1.0_c_double
    call testbr_work_f(7, 2.0_c_double, data, rc)
    if (rc /= 0) stop 11
    if (any(abs(data - 22.0_c_double) > 1e-12_c_double)) stop 12

    data = 1.0_c_double
    call validate_testbr_work_f(7, 2.0_c_double, data, ref_good, &
                                1e-9_c_double, rc)
    if (rc /= 0) stop 13
    if (any(abs(data - 22.0_c_double) > 1e-12_c_double)) stop 14

    data = 1.0_c_double
    call validate_testbr_work_f(7, 2.0_c_double, data, ref_bad, &
                                1e-9_c_double, rc)
    if (rc == 0) stop 15

    call testbr_bridge_finalize_f()
    print *, "F90_BRIDGE_OK"
contains
    subroutine ref_good(n, scale, data)
        use iso_c_binding, only: c_int, c_double
        integer(c_int), intent(in) :: n
        real(c_double), intent(in) :: scale
        real(c_double), intent(inout), contiguous :: data(:, :)
        data = 11.0_c_double * scale
    end subroutine ref_good
    subroutine ref_bad(n, scale, data)
        use iso_c_binding, only: c_int, c_double
        integer(c_int), intent(in) :: n
        real(c_double), intent(in) :: scale
        real(c_double), intent(inout), contiguous :: data(:, :)
        data = 999.0_c_double
    end subroutine ref_bad
end program host
"""


@pytest.fixture
def toy_dir(tmp_path):
    Bridge.from_spec(TEST_DEF).write(str(tmp_path))
    (tmp_path / "testbr_hook.py").write_text(TOY_HOOK)
    return tmp_path


def test_f90_module_structure(toy_dir):
    src = (toy_dir / "testbr_interface.f90").read_text()
    assert "bind(c, name='testbr_work')" in src
    assert "bind(c, name='testbr_validate_work')" in src
    assert "bind(c, name='testbr_bridge_init')" in src
    assert "subroutine testbr_work_f(n, scale, data, rc)" in src
    assert "contiguous, target :: data(:, :)" in src
    assert "int(size(data, 2), c_int), int(size(data, 1), c_int)" in src
    assert "data_fref = data" in src and "data_py = data" in src
    assert "call ref_impl(n, scale, data_fref)" in src
    assert "data = data_py" in src


def _link_flags():
    cflags, ldflags = dycore.embed_flags()
    return cflags + ldflags


@pytest.mark.skipif(shutil.which("gfortran") is None,
                    reason="no Fortran compiler in this image")
@needs_embedding
def test_f90_bridge_end_to_end(toy_dir):
    (toy_dir / "main.f90").write_text(F90_MAIN)
    cmd = ["gfortran", "-o", str(toy_dir / "host"),
           str(toy_dir / "testbr_interface.f90"), str(toy_dir / "main.f90"),
           str(toy_dir / "testbr_bridge.c")] + _link_flags()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=toy_dir)
    assert r.returncode == 0, f"compile failed:\n{r.stderr}"
    r = subprocess.run([str(toy_dir / "host")], capture_output=True,
                       text=True, cwd=toy_dir,
                       env=dycore.host_env(str(toy_dir)), timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr, r.stdout)
    assert "F90_BRIDGE_OK" in r.stdout


# ---- C hosts ----------------------------------------------------------------

@needs_embedding
def test_toy_bridge_end_to_end(toy_dir):
    (toy_dir / "main.c").write_text(TOY_MAIN)
    cmd = ["gcc", "-o", str(toy_dir / "host"), str(toy_dir / "main.c"),
           str(toy_dir / "testbr_bridge.c"), f"-I{toy_dir}"] + _link_flags()
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, f"compile failed:\n{r.stderr}"
    r = subprocess.run([str(toy_dir / "host")], capture_output=True,
                       text=True, cwd=toy_dir,
                       env=dycore.host_env(str(toy_dir)), timeout=120)
    assert r.returncode == 0, f"rc={r.returncode}:\n{r.stderr}\n{r.stdout}"
    assert "BRIDGE_OK" in r.stdout


@pytest.fixture(scope="module")
def dycore_host(tmp_path_factory):
    """dycore_host.c compiled against the generated dycore bridge."""
    d = tmp_path_factory.mktemp("host")
    Bridge.from_file(PORT_DEF).write(str(d))
    return dycore.build_host(str(d))


def _bridge_dir(tmp_path, hook):
    Bridge.from_file(PORT_DEF).write(str(tmp_path))
    dycore.write_hook(str(tmp_path), hook)
    return str(tmp_path)


def _host(args, bridge_dir, timeout=300):
    r = subprocess.run(args, capture_output=True, text=True, cwd=bridge_dir,
                       env=dycore.host_env(bridge_dir, OMP_NUM_THREADS="1"),
                       timeout=timeout)
    assert r.returncode == 0, f"rc={r.returncode}:\n{r.stderr}\n{r.stdout}"
    assert "HOST_OK" in r.stdout
    return r.stdout


def test_stamp_matches_the_host_layout():
    """dycore.stamp is the host's formula on each rank's index order."""
    a = dycore.stamp((6, 3, 2, 4))       # [face, y, x, K]
    assert a[0, 0, 0, 0] == 1 + 16 * (1 + 16 * (1 + 16 * 4))
    assert a[5, 2, 1, 3] == 2 + 16 * (3 + 16 * (4 + 16 * 24))
    q = dycore.stamp((6, 3, 2, 4, 2))    # [face, y, x, K, tracer]
    assert q[1, 0, 1, 2, 1] == 2 + 16 * (1 + 16 * (3 + 16 * (2 + 8)))
    ps = dycore.stamp((6, 3, 2))
    assert ps[2, 1, 0] == 1 + 16 * (2 + 16 * 16 * 12)
    # a Fortran-order file reads back as the port's layout
    for shape in ((6, 3, 2), (6, 4, 3, 5), (6, 3, 3, 2, 2)):
        want = dycore.stamp(shape)
        view = np.transpose(want, dycore.PORT_TO_VIEW[len(shape)])
        assert np.array_equal(dycore.to_port(np.ascontiguousarray(view))
                              .numpy(), want)


@needs_embedding
def test_coordinate_stamp_through_the_host(dycore_host, tmp_path):
    """Every array of the definition, each element set by the host from its
    Fortran indices, is checked element for element in the port's layout
    by the hook, which writes the negated stamp back into the 14 state
    fields; the host checks all 24 arrays."""
    d = _bridge_dir(tmp_path, 'LayoutCheckHook("cpu")')
    _host([dycore_host, "stamp", d, "5", "4", "2"], d)


@needs_embedding
def test_dycore_hook_steps_equal_direct_steps(dycore_host, tmp_path):
    """2 bridged steps of the eager Held-Suarez model at c8-L10 equal 2
    direct steps bit for bit, one torch thread on both sides; no kernel
    is launched on the CPU."""
    from geosongpu_tpu_torch.cli import PRESETS, build_model_for
    from geosongpu_tpu_torch.core.state import state_to_numpy

    preset = "held_suarez_c48_l72"
    cfg = dataclasses.replace(PRESETS[preset], npx=8, npz=10)
    model = build_model_for(preset)(cfg, torch.device("cpu"))
    s = model.init(perturb=1e-3, seed=0)
    data = str(tmp_path / "data")
    dycore.write_inputs(data, state_to_numpy(s), model.ak, model.bk)
    d = _bridge_dir(tmp_path, f'DycoreHook("{preset}", "cpu", HERE)')
    out = _host([dycore_host, "run", d, data, "8", "10",
                 str(cfg.ntracers), "2", str(cfg.dt), str(cfg.ptop)], d)
    assert out.count(" ms\n") == 2 and "equal copy 0, changed copy 1" in out
    want = state_to_numpy(model.run(s, 2))
    got = dycore.read_outputs(data, {k: v.shape for k, v in want.items()})
    for name in dycore.STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert float(np.abs(got["u"]).max()) > 0.0
    with open(os.path.join(d, "hook.json")) as f:
        hook = json.load(f)
    assert not any(hook["launches"].values())
    assert sorted(hook["ms"]) == ["copy_in", "copy_out", "step"]
    assert all(len(v) == 2 and min(v) > 0.0 for v in hook["ms"].values())


def test_dycore_hook_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dycore.DycoreHook("held_suarez_c48_l72_fused", "cuda", ".")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dycore.LayoutCheckHook("cuda")


def test_embed_flags_name_this_interpreter():
    if _embeddable() is not None:
        pytest.skip(_embeddable())
    cflags, ldflags = dycore.embed_flags()
    assert cflags == [f"-I{sysconfig.get_paths()['include']}"]
    ver = sysconfig.get_config_var("LDVERSION")
    assert f"-lpython{ver}" in ldflags or any(
        f.endswith(f"libpython{ver}.a") for f in ldflags)
