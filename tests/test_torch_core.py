"""The port's own copies of the numpy core modules against the reference's.

geosongpu_tpu_torch/core/{config,topology,grid,vertical,chart_corners}.py
are copies of the JAX package's numpy-only modules, so that the port
imports nothing of that package.  They run the same numpy operations on the
same inputs, so every comparison here is bit for bit, with no tolerance:
every field of build_grid at c8 and c12, the halo gather tables and the
shared-edge twins, every chart-corner table, the chart metric overrides and
corner weights, the vertical coordinates, the physical constants, and the
configuration tree's field names and defaults."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from geosongpu_tpu.core import chart_corners as jcc  # noqa: E402
from geosongpu_tpu.core import config as jcfg  # noqa: E402
from geosongpu_tpu.core import grid as jgrid  # noqa: E402
from geosongpu_tpu.core import topology as jtopo  # noqa: E402
from geosongpu_tpu.core import vertical as jvert  # noqa: E402
from geosongpu_tpu_torch.core import chart_corners as tcc  # noqa: E402
from geosongpu_tpu_torch.core import config as tcfg  # noqa: E402
from geosongpu_tpu_torch.core import grid as tgrid  # noqa: E402
from geosongpu_tpu_torch.core import topology as ttopo  # noqa: E402
from geosongpu_tpu_torch.core import vertical as tvert  # noqa: E402

SIZES = [(8, 3), (12, 3)]


def _same(name, a, b):
    """Bit-for-bit equality of two values of a table dataclass."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif dataclasses.is_dataclass(a):
        _same_dataclass(name, a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for n, (x, y) in enumerate(zip(a, b)):
            _same(f"{name}[{n}]", x, y)
    else:
        assert a == b, name


def _same_dataclass(name, a, b):
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)], name
    n_arrays = 0
    for f in fa:
        x = getattr(a, f)
        n_arrays += isinstance(x, np.ndarray)
        _same(f"{name}.{f}", x, getattr(b, f))
    return n_arrays


@pytest.mark.parametrize("cls", ["DycoreConfig", "MeshConfig", "RunConfig",
                                 "ExperimentConfig"])
def test_config_fields_and_defaults_match(cls):
    """Same field names, in order, with the same defaults: one dict of
    keyword arguments builds the same configuration in both packages."""
    ref, got = getattr(jcfg, cls), getattr(tcfg, cls)
    assert got is not ref

    def spec(c):
        out = []
        for f in dataclasses.fields(c):
            default = f.default
            if f.default_factory is not dataclasses.MISSING:
                default = dataclasses.asdict(f.default_factory()) \
                    if dataclasses.is_dataclass(f.default_factory()) \
                    else f.default_factory()
            out.append((f.name, default))
        return out

    assert spec(got) == spec(ref)


def test_config_replace_and_derived_values_match():
    kw = dict(npx=48, npz=72, dt=600.0, n_split=6, hord_tm=6,
              hydrostatic=False, z_tracer=False, pallas_dycore=True)
    ref, got = jcfg.DycoreConfig(**kw), tcfg.DycoreConfig(**kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    assert got.grid_points == ref.grid_points == 6 * 48 * 48 * 72


def test_physical_constants_match():
    for name in ("RADIUS", "OMEGA", "GRAV", "RDGAS", "CP_AIR", "KAPPA"):
        assert getattr(tgrid, name) == getattr(jgrid, name), name
    assert ttopo.NFACES == jtopo.NFACES == 6
    np.testing.assert_array_equal(np.asarray(ttopo.FACE_FRAMES),
                                  np.asarray(jtopo.FACE_FRAMES))


@pytest.mark.parametrize("n,h", SIZES)
def test_build_grid_bit_exact(n, h):
    ref, got = jgrid.build_grid(n, h), tgrid.build_grid(n, h)
    assert _same_dataclass("grid", ref, got) == 38   # every array field


@pytest.mark.parametrize("n,h", SIZES)
def test_halo_spec_bit_exact(n, h):
    assert _same_dataclass("halo_spec", jtopo.halo_spec(n, h),
                           ttopo.halo_spec(n, h)) >= 18


@pytest.mark.parametrize("n", [8, 12])
def test_edge_twins_bit_exact(n):
    ref, got = jtopo.edge_twins(n), ttopo.edge_twins(n)
    assert len(ref) == len(got) == 3
    for k, (a, b) in enumerate(zip(ref, got)):
        _same(f"edge_twins[{k}]", a, b)
    # 12 cube edges of n shared staggered entries each
    assert ref[0].shape == (12 * n,)


def test_edge_table_and_affine_maps_match():
    ref, got = jtopo.edge_table(), ttopo.edge_table()
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert dataclasses.astuple(ref[key]) == dataclasses.astuple(got[key])
        f, e = key
        a, b = jtopo.edge_affine(f, e, 8), ttopo.edge_affine(f, e, 8)
        _same(f"edge_affine{key}", dataclasses.astuple(a),
              dataclasses.astuple(b))


@pytest.mark.parametrize("n,h", SIZES)
def test_chart_tables_bit_exact(n, h):
    ref, got = jcc.build_chart_tables(n, h), tcc.build_chart_tables(n, h)
    assert type(got) is tcc.ChartCornerTables
    assert _same_dataclass("chart_tables", ref, got) == 9   # every table


@pytest.mark.parametrize("n,h", SIZES)
def test_chart_cosa_overrides_bit_exact(n, h):
    ref, got = jcc.chart_cosa_overrides(n, h), tcc.chart_cosa_overrides(n, h)
    assert sorted(ref) == sorted(got) == ["cosa_c", "cosa_cn", "cosa_i",
                                          "cosa_j"]
    for name in ref:
        for k, part in enumerate(("values", "mask")):
            _same(f"{name}.{part}", ref[name][k], got[name][k])


@pytest.mark.parametrize("n,h", SIZES)
def test_chart_corner_dw_bit_exact(n, h):
    ref, got = jcc.chart_corner_dw(n, h), tcc.chart_corner_dw(n, h)
    assert got.dtype == np.float32 and got.shape == (4, 6, n + 2 * h + 1,
                                                     n + 2 * h + 1)
    np.testing.assert_array_equal(ref, got)


def test_chart_helpers_match():
    for h in (2, 3):
        assert tcc._patch_width(h) == jcc._patch_width(h)
    for cid in range(4):
        assert tcc._corner_patch_slices(18, 19, 7, 7, cid) \
            == jcc._corner_patch_slices(18, 19, 7, 7, cid)


@pytest.mark.parametrize("nz", [8, 72])
@pytest.mark.parametrize("kind", ["hybrid_coordinate", "sigma_coordinate"])
def test_vertical_coordinates_bit_exact(kind, nz):
    ref = getattr(jvert, kind)(nz, 100.0)
    got = getattr(tvert, kind)(nz, 100.0)
    assert len(ref) == len(got) == 2
    for name, a, b in zip(("ak", "bk"), ref, got):
        _same(name, np.asarray(a), np.asarray(b))
        assert np.asarray(b).shape == (nz + 1,)


def test_copies_are_separate_modules_with_their_own_caches():
    """The copies share no state with the reference: their cached functions
    return their own objects."""
    assert tgrid.build_grid is not jgrid.build_grid
    assert tgrid.build_grid(8, 3) is tgrid.build_grid(8, 3)
    assert tgrid.build_grid(8, 3) is not jgrid.build_grid(8, 3)
    assert type(tgrid.build_grid(8, 3).spec) is ttopo.HaloSpec
