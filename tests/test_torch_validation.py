"""The port's validation modules (geosongpu_tpu_torch/validation/{analysis,
serialbox_binary,serialbox_convert,cli}.py) against the JAX package's.

The same seeded fields through both packages' analysis give equal
DiffReports; a Serialbox directory written by either package's
write_fixture converts to identical arrays through either converter (the
cases of tests/test_serialbox_convert.py on the port); the sharded step's
block layout (stack_blocks at c8 on (2, 4)) assembles back into the global
centred fields bit for bit, and staggered fields come out n + py rows in
both packages; both CLIs print the same reports and exit codes."""
import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from geosongpu_tpu.parallel import subtile as j_subtile  # noqa: E402
from geosongpu_tpu.validation import analysis as j_analysis  # noqa: E402
from geosongpu_tpu.validation import cli as j_cli  # noqa: E402
from geosongpu_tpu.validation import serialbox_binary as j_binary  # noqa: E402
from geosongpu_tpu.validation import serialbox_convert as j_convert  # noqa: E402
from geosongpu_tpu_torch.parallel import subtile as t_subtile  # noqa: E402
from geosongpu_tpu_torch.validation import analysis as t_analysis  # noqa: E402
from geosongpu_tpu_torch.validation import cli as t_cli  # noqa: E402
from geosongpu_tpu_torch.validation import \
    serialbox_binary as t_binary  # noqa: E402
from geosongpu_tpu_torch.validation import \
    serialbox_convert as t_convert  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERIALBOX_PYTHON = str(ROOT / "geosongpu_tpu_torch" / "validation"
                       / "serialbox_python")
PACKAGES = {"jax": (j_analysis, j_binary, j_convert, j_cli),
            "torch": (t_analysis, t_binary, t_convert, t_cli)}


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    a = {"t": rng.standard_normal((6, 8, 8)).astype(np.float32),
         "u": (10.0 * rng.standard_normal((3, 6, 4, 4, 5))).astype(
             np.float32)}
    return a


# ---- analysis (tests/test_harness.py::test_validation_analysis) ---------

@pytest.mark.parametrize("shift,time_idx,var", [
    (1e-6, None, "t"), (0.5, None, "t"), (0.25, 1, "u"), ("nan", None, "t"),
    ("noise", 2, "u")])
def test_analysis_reports_equal(shift, time_idx, var):
    ref = _fields()
    comp = {k: v.copy() for k, v in ref.items()}
    if shift == "nan":
        comp[var][0, 1, 2] = np.nan
        comp[var] += 1e-3
    elif shift == "noise":
        comp[var] += np.random.default_rng(1).standard_normal(
            comp[var].shape).astype(np.float32) * 1e-2
    else:
        comp[var] += shift
    j = j_analysis.analysis(ref, comp, var, time_idx)
    t = t_analysis.analysis(ref, comp, var, time_idx)
    assert type(t).__name__ == "DiffReport"
    assert vars(t) == vars(j)
    assert str(t) == str(j)


@pytest.mark.parametrize("shift,passes", [(1e-6, True), (0.5, False),
                                          ("nan", False)])
def test_check_tolerance_equal(shift, passes, capsys):
    ref = _fields()
    comp = {"t": ref["t"] + (np.nan if shift == "nan" else shift)}
    got = [mod.check_tolerance(ref, comp, ["t"], rel_tol=1e-4)
           for mod in (j_analysis, t_analysis)]
    assert got == [passes, passes]
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


def test_analysis_shape_mismatch_raises():
    ref = _fields()
    with pytest.raises(ValueError, match="shape mismatch"):
        t_analysis.analysis(ref, {"t": ref["t"][:3]}, "t")


def test_load_dataset_npz_and_netcdf_gate(tmp_path):
    ref = _fields()
    path = str(tmp_path / "state.npz")
    np.savez(path, **ref)
    j, t = j_analysis.load_dataset(path), t_analysis.load_dataset(path)
    assert sorted(j) == sorted(t) == sorted(ref)
    for k in ref:
        assert np.array_equal(t[k], ref[k])
    try:
        import xarray  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="xarray"):
            t_analysis.load_dataset(str(tmp_path / "state.nc"))


@pytest.mark.parametrize("extra,rc", [([], 0), (["--rel_tol", "1e-4"], 1),
                                      (["--rel_tol", "1e-2"], 0),
                                      (["-st", "1", "--rel_tol", "1e-1"], 0)])
def test_validate_cli_equal(tmp_path, capsys, extra, rc):
    ref = _fields()
    comp = {k: v + np.float32(1e-3) * np.abs(v) for k, v in ref.items()}
    pa, pb = str(tmp_path / "ref.npz"), str(tmp_path / "comp.npz")
    np.savez(pa, **ref)
    np.savez(pb, **comp)
    var = "u" if "-st" in extra else "t"
    out = []
    for cli in (j_cli, t_cli):
        assert cli.main(["validate", pa, pb, var] + extra) == rc
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].startswith(f"{var}: max")


# ---- Serialbox (tests/test_serialbox_convert.py on the port) ------------

class _FakeSavepoint:
    def __init__(self, name):
        self.name = name


class _FakeSerializer:
    """Rank r's subdomain of a global field encoding (tile, y, x)."""

    def __init__(self, rank, lx, ly, ny, nx, halo, savepoints):
        self.rank, self.lx, self.ly, self.ny, self.nx = rank, lx, ly, ny, nx
        self.halo = halo
        self._sps = [_FakeSavepoint(n) for n in savepoints]

    def savepoint_list(self):
        return list(self._sps)

    def fields_at_savepoint(self, sp):
        return ["u", "ps"]

    def read(self, field, sp):
        tile = self.rank // (self.lx * self.ly)
        by, bx = divmod(self.rank % (self.lx * self.ly), self.lx)
        yy, xx = np.meshgrid(np.arange(self.ny), np.arange(self.nx),
                             indexing="ij")
        data = (1000.0 * tile + 10.0 * (yy + by * self.ny)
                + (xx + bx * self.nx))
        if field == "u":
            data = np.repeat(data[..., None], 3, axis=-1)
        if "FVDynamics" in sp.name:
            h = self.halo
            data = np.pad(data, [(h, h), (h, h)] + [(0, 0)] * (data.ndim - 2),
                          constant_values=1.0e40)
        return data


def _expected(tile, NY, NX):
    yy, xx = np.meshgrid(np.arange(NY), np.arange(NX), indexing="ij")
    return 1000.0 * tile + 10.0 * yy + xx


def test_clean_sentinels_trim_and_layout(tmp_path):
    a = np.full((8, 8), 1.0e40)
    a[4, 4] = 2.0
    for mod in (j_convert, t_convert):
        c = mod.clean_sentinels(a)
        assert c[0, 0] == 0.0 and c[4, 4] == 2.0
        assert mod.trim_halo(np.arange(100.0).reshape(10, 10), 3).shape == \
            (4, 4)
    p = tmp_path / "input.nml"
    p.write_text("&fv_core_nml\n  npx = 49\n  layout = 3, 4\n/\n")
    assert t_convert.layout_from_nml(str(p)) == \
        j_convert.layout_from_nml(str(p)) == (3, 4)


def test_assemble_ranks_orders_blocks():
    lx, ly, ny, nx = 2, 2, 3, 4
    blocks = []
    for by in range(ly):
        for bx in range(lx):
            yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
            blocks.append(10.0 * (yy + by * ny) + (xx + bx * nx))
    out = t_convert.assemble_ranks(blocks, lx, ly)
    np.testing.assert_array_equal(out, _expected(0, ny * ly, nx * lx))
    np.testing.assert_array_equal(out, j_convert.assemble_ranks(blocks, lx,
                                                                ly))


@pytest.mark.parametrize("lx,ly", [(1, 1), (2, 2), (2, 1)])
def test_convert_assembles_all_tiles(tmp_path, lx, ly):
    ny, nx, halo = 6, 6, 3
    sps = ["Driver-In-FVDynamics", "Plain-Out"]

    def make(rank):
        return _FakeSerializer(rank, lx, ly, ny, nx, halo, sps)

    paths = {name: mod.convert("unused", str(tmp_path / name),
                               layout=(lx, ly), halo=halo, fmt="npz",
                               serializer_factory=make)
             for name, mod in (("jax", j_convert), ("torch", t_convert))}
    assert len(paths["torch"]) == 2
    for pt, pj in zip(paths["torch"], paths["jax"]):
        assert os.path.basename(pt) == os.path.basename(pj)
        d, dj = np.load(pt), np.load(pj)
        NY, NX = ny * ly, nx * lx
        assert d["ps"].shape == (6, NY, NX) and d["u"].shape == (6, NY, NX, 3)
        for tile in range(6):
            np.testing.assert_array_equal(d["ps"][tile],
                                          _expected(tile, NY, NX))
        assert np.abs(d["u"]).max() < 1.0e40
        for k in ("u", "ps"):
            assert np.array_equal(d[k], dj[k])


def test_convert_savepoint_filter(tmp_path):
    sps = ["Driver-In-FVDynamics", "Plain-Out"]
    paths = t_convert.convert(
        "unused", str(tmp_path), layout=(1, 1), fmt="npz", savepoint="Plain",
        serializer_factory=lambda r: _FakeSerializer(r, 1, 1, 4, 4, 3, sps))
    assert len(paths) == 1 and "Plain" in paths[0]


def _write_dump(binary, dat, lx, ly, truth):
    """The global truth [6, ny*ly, nx*lx, nz] as 6*lx*ly rank dumps."""
    ny, nx = truth.shape[1] // ly, truth.shape[2] // lx
    for tile in range(6):
        for by in range(ly):
            for bx in range(lx):
                rank = tile * lx * ly + by * lx + bx
                block = truth[tile, by * ny:(by + 1) * ny,
                              bx * nx:(bx + 1) * nx]
                binary.write_fixture(
                    str(dat), f"Generator_rank{rank}",
                    ["MoistPhysics-In", "MoistPhysics-Out"],
                    {"t_field": [block[..., 0], block[..., 1]],
                     "q3d": [block, block * 2.0]})


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("lx,ly", [(2, 1), (1, 2), (2, 2)])
def test_binary_dump_converts_identically(tmp_path, writer, lx, ly):
    """A dump written by either package's write_fixture: the same files,
    and the same arrays through either package's convert and reader (the
    reference's layout, stitching and sentinel semantics)."""
    rng = np.random.RandomState(7)
    truth = rng.randn(6, 4 * ly, 3 * lx, 2)
    truth[0, 0, 0, 0] = 1.0e40
    dat = tmp_path / "dump"
    _write_dump(PACKAGES[writer][1], dat, lx, ly, truth)
    other = tmp_path / "dump_other"
    _write_dump(PACKAGES["jax" if writer == "torch" else "torch"][1], other,
                lx, ly, truth)
    for f in sorted(os.listdir(dat)):
        assert (dat / f).read_bytes() == (other / f).read_bytes(), f
    expect = truth.copy()
    expect[np.abs(expect) >= 1.0e40] = 0.0
    got = {}
    for name, (_, binary, convert, _) in PACKAGES.items():
        written = convert.convert(
            str(dat), str(tmp_path / f"out_{name}"), layout=(lx, ly),
            fmt="npz",
            serializer_factory=binary.binary_serializer_factory(str(dat)))
        assert len(written) == 2
        got[name] = {os.path.basename(w): dict(np.load(w)) for w in written}
    assert got["jax"].keys() == got["torch"].keys()
    for sp, d in got["torch"].items():
        for k, v in d.items():
            assert np.array_equal(v, got["jax"][sp][k]), (sp, k)
    d_in = got["torch"]["MoistPhysics-In.npz"]
    np.testing.assert_array_equal(d_in["q3d"], expect)
    np.testing.assert_array_equal(d_in["t_field"], expect[..., 0])
    np.testing.assert_array_equal(got["torch"]["MoistPhysics-Out.npz"]["q3d"],
                                  expect * 2.0)


def test_serialbox_cli_with_the_binary_reader(tmp_path, monkeypatch, capsys):
    """Both CLIs convert a binary dump where SERIALBOX_PYTHON names the
    port's reader of that layout (validation/serialbox_python), to the
    arrays of convert with binary_serializer_factory; without
    SERIALBOX_PYTHON the gate refuses, as the reference's."""
    lx, ly = 2, 1
    truth = np.random.RandomState(3).randn(6, 4, 6, 2).astype(np.float32)
    dat = tmp_path / "dump"
    _write_dump(t_binary, dat, lx, ly, truth)
    monkeypatch.delenv("SERIALBOX_PYTHON", raising=False)
    with pytest.raises(RuntimeError, match="SERIALBOX_PYTHON"):
        t_cli.main(["serialbox", str(dat), str(tmp_path / "x"), "-l", "2,1"])
    monkeypatch.setenv("SERIALBOX_PYTHON", SERIALBOX_PYTHON)
    want = t_convert.convert(
        str(dat), str(tmp_path / "direct"), layout=(lx, ly), fmt="npz",
        serializer_factory=t_binary.binary_serializer_factory(str(dat)))
    for name, cli in (("jax", j_cli), ("torch", t_cli)):
        out = tmp_path / f"cli_{name}"
        assert cli.main(["serialbox", str(dat), str(out), "-l", "2,1",
                         "-f", "npz", "-s", "In"]) == 0
        assert "wrote" in capsys.readouterr().out
        (path,) = [str(out / f) for f in os.listdir(out)]
        d, w = np.load(path), np.load([p for p in want if "In" in p][0])
        assert sorted(d.files) == sorted(w.files)
        for k in d.files:
            assert d[k].dtype == np.float32 and np.array_equal(d[k], w[k])
    import serialbox
    with pytest.raises(NotImplementedError):
        serialbox.Serializer(serialbox.OpenModeKind.Write, str(dat),
                             "Generator_rank0")


@pytest.mark.parametrize("face_sharded", [False, True])
def test_stacked_blocks_as_serialbox_ranks(tmp_path, face_sharded):
    """The port's stack_blocks at c8 on (2, 4) (and (6, 2, 4)), each block
    written as the Serialbox rank of its face and block: centred fields
    assemble into the global field bit for bit through either converter;
    a staggered field ([bny + 1, bnx] blocks, shared interfaces repeated)
    comes out n + py rows in both packages, as the reference's converter
    concatenates without dropping them."""
    n, py, px, K = 8, 2, 4, 3
    rng = np.random.default_rng(11)
    centred = rng.standard_normal((6, n, n, K)).astype(np.float32)
    stag = rng.standard_normal((6, n + 1, n, K)).astype(np.float32)
    lays = [mod.SubtileLayout(n=n, h=3, py=py, px=px,
                              face_sharded=face_sharded)
            for mod in (t_subtile, j_subtile)]
    lay = lays[0]
    blocks = {"pt": t_subtile.stack_blocks(lay, centred),
              "u": t_subtile.stack_blocks(lay, stag)}
    for k in blocks:
        assert np.array_equal(blocks[k], j_subtile.stack_blocks(
            lays[1], centred if k == "pt" else stag))
    dat = tmp_path / "dump"
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        for s in range(lay.nslots):
            face = fd if face_sharded else s
            t_binary.write_fixture(
                str(dat), f"Generator_rank{face * px * py + by * px + bx}",
                ["Step-Out"], {k: [v[d, s]] for k, v in blocks.items()})
    for name, (_, binary, convert, _) in PACKAGES.items():
        (path,) = convert.convert(
            str(dat), str(tmp_path / name), layout=(px, py), fmt="npz",
            serializer_factory=binary.binary_serializer_factory(str(dat)))
        d = np.load(path)
        assert np.array_equal(d["pt"], centred)
        assert d["u"].shape == (6, n + py, n, K)
        # each block row repeats the interface row it shares with the next
        assert np.array_equal(d["u"][:, :n // py + 1], stag[:, :n // py + 1])
        assert np.array_equal(d["u"][:, n // py + 1:], stag[:, n // py:])
