"""The port's file formats (lightpycl_tpu_torch/io: stl, obj + ply, scene,
dxf, ies, zmx, seq) against the reference's.

  * Every format is written by one package and read by the other, and the
    reverse: the files are byte for byte the same, and what either package
    reads back is the same (meshes bit for bit, every GeoObject field).
  * load_zmx / load_seq of the same files give equal prescriptions;
    zmx_to_scene / seq_to_scene give bit-equal meshes and equal info;
    zmx_paraxial / seq_paraxial are equal.
  * The IES round trip and ies_source's samples are equal.
  * The reference's round-5 cases hold in the port: the default cement gap
    max(1e-6 track, 5e-4) and the Mangin refusal.
"""

import enum
import math

import numpy as np
import pytest

import lightpycl_tpu as L
import lightpycl_tpu.io as RIO
import lightpycl_tpu_torch as P
import lightpycl_tpu_torch.io as PIO
from lightpycl_tpu import materials
from torch_port_common import assert_same

PKGS = {"ref": (L, RIO), "port": (P, PIO)}


def assert_same_geo(a, b, where="element"):
    """Two GeoObjects (one of each package, or two of one) field by field:
    the enums by name and value, everything else bit for bit."""
    assert type(a).__name__ == type(b).__name__ == "GeoObject", where
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, enum.Enum):
            assert (x.name, x.value) == (y.name, y.value), (where, f)
        else:
            assert_same(x, y, f"{where}.{f}")


def assert_same_elements(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert_same_geo(x, y, f"element {i}")


def scene(pkg):
    oe = pkg.optical_elements(n_segments=16, n_radial=6)
    lens = oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 0.5),
                            name="lens", coating=[(1.38, 0.1)])
    lens.dispersion_b = 0.004
    return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9, name="mirror"),
            lens,
            oe.rectangle(1.0, 1.0, center=(1.0, 0, 1.0), material="grating",
                         axis=(1.0, 0.0, 0.0), grating_period=1.5,
                         name="grating"),
            oe.hemisphere(radius=6.0, name="dome")]


def write_with(name, kind, path):
    """Write `kind` of scene(`name`'s package) to path with that package."""
    pkg, io = PKGS[name]
    els = scene(pkg)
    if kind == "stl":
        io.save_stl(path, els[0])
    elif kind == "obj":
        io.save_obj(path, els)
    elif kind == "ply":
        io.save_ply(path, els[1])
    elif kind == "scene":
        io.save_scene(path, els)
    elif kind == "dxf":
        rng = np.random.default_rng(1)
        seg = [(rng.normal(size=(20, 3)), rng.normal(size=(20, 3)),
                rng.uniform(size=20) > 0.3)]
        io.save_traced_scene(path, els + [pkg.analytic_disc(
            0.4, vertex=(0, 0, 2.0), name="flat")], seg)
    elif kind == "polyface":
        w = io.DXFWriter()
        w.add_polyface(els[0].vertices, els[0].triangles, layer="mirror")
        w.add_polyface(els[3].vertices, els[3].triangles, layer="dome")
        w.save(path)


def read_with(name, kind, path):
    pkg, io = PKGS[name]
    if kind == "stl":
        return [io.load_stl(path, material="mirror")]
    if kind == "obj":
        return ([io.load_obj(path)]
                + io.load_obj_scene(path, {
                    "lens": dict(material="refractive", ior=1.7),
                    "dome": dict(material="measure", name="det")},
                    default_material="terminator"))
    if kind == "ply":
        return [io.load_ply(path, material="refractive", ior=1.6)]
    if kind == "scene":
        return io.load_scene(path)
    if kind == "dxf":
        return ([io.load_dxf_mesh(path, units="mm")]
                + io.load_dxf_scene(path, {"lens": dict(
                    material="refractive", ior=1.5)},
                    default_material="terminator"))
    if kind == "polyface":
        return io.load_dxf_scene(path, {"mirror": dict(material="mirror"),
                                        "dome": dict(material="measure")})
    raise KeyError(kind)


KINDS = ["stl", "obj", "ply", "scene", "dxf", "polyface"]
SUFFIX = {"polyface": "dxf"}


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_formats_cross_read(kind, tmp_path):
    sfx = SUFFIX.get(kind, kind if kind != "scene" else "npz")
    files = {}
    for writer in PKGS:
        files[writer] = tmp_path / f"{writer}.{sfx}"
        write_with(writer, kind, str(files[writer]))
    assert files["ref"].read_bytes() == files["port"].read_bytes()
    reads = {(w, r): read_with(r, kind, str(files[w]))
             for w in PKGS for r in PKGS}
    base = reads[("ref", "ref")]
    assert len(base) >= 1
    for key, els in reads.items():
        assert_same_elements(base, els)
    if kind == "scene":
        # the full optical state, not only the geometry, survives
        assert_same_elements(scene(L), base)


# ---- Zemax / CODE V --------------------------------------------------------

WL = materials.D_LINE


def achromat():
    """The example_zmx achromat, built with the port's classes."""
    from lightpycl_tpu_torch.io.zmx import ZmxPrescription, ZmxSurface

    R1, R2, R3 = 61.5, -61.5, -260.0
    return ZmxPrescription(
        name="BK7+F2 achromat", unit="MM",
        wavelengths_um=[materials.F_LINE, WL, materials.C_LINE],
        primary_wl_index=2, enpd=20.0,
        surfaces=[ZmxSurface(0, disz=math.inf),
                  ZmxSurface(1, curv=1 / R1, disz=4.0, glass="N-BK7",
                             semi_diam=11.0, comment="crown"),
                  ZmxSurface(2, curv=1 / R2, disz=0.5, semi_diam=11.0),
                  ZmxSurface(3, curv=1 / R2, disz=2.5, glass="F2",
                             semi_diam=11.0, comment="flint", conic=-0.3,
                             parm={2: 1e-6, 3: -2e-9}),
                  ZmxSurface(4, curv=1 / R3, disz=95.0, semi_diam=11.0),
                  ZmxSurface(5, semi_diam=4.0)])


CASSEGRAIN = "\n".join([
    "MODE SEQ", "NAME classical cassegrain m=3",
    "UNIT MM X W X CM MR CPMM", "WAVM 1 0.5876 1", "PWAV 1",
    "SURF 0", "  TYPE STANDARD", "  DISZ INFINITY",
    "SURF 1", "  TYPE STANDARD", "  COMM primary", "  CURV -0.005",
    "  CONI -1", "  DISZ -60", "  GLAS MIRROR",
    "  DIAM 25 1 0 0 1 \"\"", "  OBSC 0 9",
    "SURF 2", "  TYPE STANDARD", "  COMM secondary",
    f"  CURV {-1.0 / 120.0:.17g}", "  CONI -4",
    "  DISZ 120", "  GLAS MIRROR", "  DIAM 11 1 0 0 1 \"\"",
    "SURF 3", "  TYPE STANDARD", "  DISZ 0", "  DIAM 2 1 0 0 1 \"\"",
])


def doublet_zmx(r1=20.0, r2=-15.0, r3=-60.0, t1=4.0, t2=2.0, back=30.0):
    return "\n".join([
        "MODE SEQ", "UNIT MM X W X CM MR CPMM", "WAVM 1 0.5876 1",
        "SURF 0", "  TYPE STANDARD", "  DISZ INFINITY",
        "SURF 1", "  TYPE STANDARD", f"  CURV {1/r1}", f"  DISZ {t1}",
        "  GLAS N-BK7", "  DIAM 6 1 0 0 1 \"\"",
        "SURF 2", "  TYPE STANDARD", f"  CURV {1/r2}", f"  DISZ {t2}",
        "  GLAS F2", "  DIAM 6 1 0 0 1 \"\"",
        "SURF 3", "  TYPE STANDARD", f"  CURV {1/r3}", f"  DISZ {back}",
        "  DIAM 6 1 0 0 1 \"\"",
        "SURF 4", "  TYPE STANDARD", "  DISZ 0", "  DIAM 3 1 0 0 1 \"\"",
    ])


def both_scenes(fn_name, path, **kw):
    out = []
    for name in ("ref", "port"):
        out.append(getattr(PKGS[name][1], fn_name)(path, **kw))
    (ea, ia), (eb, ib) = out
    assert_same_elements(ea, eb)
    assert_same(ia, ib)
    return eb, ib


def test_zmx_cross_read_paraxial_and_scene(tmp_path):
    files = {"port": tmp_path / "port.zmx", "ref": tmp_path / "ref.zmx"}
    PIO.save_zmx(files["port"], achromat())
    RIO.save_zmx(files["ref"], PIO.load_zmx(files["port"]))
    assert files["port"].read_bytes() == files["ref"].read_bytes()
    a, b = RIO.load_zmx(files["port"]), PIO.load_zmx(files["ref"])
    assert_same(a, b)
    assert_same(RIO.zmx_paraxial(a), PIO.zmx_paraxial(b))
    assert_same(RIO.zmx_paraxial(a, wavelength_um=materials.F_LINE),
                PIO.zmx_paraxial(b, wavelength_um=materials.F_LINE))
    els, info = both_scenes("zmx_to_scene", files["port"], n_segments=32,
                            n_radial=12, detector_scale=2.0)
    assert [e.name for e in els] == ["crown", "flint", "image"]
    both_scenes("zmx_to_scene", files["port"], n_segments=16, n_radial=6,
                wavelength_um=materials.C_LINE, include_stop=False,
                glass_overrides={"F2": 1.62,
                                 "N-BK7": {"ior": 1.5, "dispersion_b": 0.004}})
    cass = tmp_path / "cass.zmx"
    cass.write_text(CASSEGRAIN)
    assert_same(RIO.zmx_paraxial(RIO.load_zmx(cass)),
                PIO.zmx_paraxial(PIO.load_zmx(cass)))
    els, info = both_scenes("zmx_to_scene", cass, n_segments=32, n_radial=12,
                            detector_scale=5.0)
    assert any("central hole" in s for s in info["warnings"])
    both_scenes("zmx_to_scene", cass, holes={1: 7.0}, detector=False)


def test_zmx_cement_gap_default_and_explicit(tmp_path):
    t1 = 4.0
    p = tmp_path / "doublet.zmx"
    p.write_text(doublet_zmx(t1=t1))
    els, info = both_scenes("zmx_to_scene", p, cement_gap=0.01)
    assert [e.name for e in els] == ["lens_s1", "lens_s2", "image"]
    assert dict(info["positions"])["lens_s2"] == pytest.approx(t1 + 0.01)
    assert "cemented" in info["warnings"][0]
    els, info = both_scenes("zmx_to_scene", p, n_segments=16, n_radial=6)
    gap = dict(info["positions"])["lens_s2"] - t1
    track = t1 + 2.0 + 30.0
    # the round-5 default: max(1e-6 * track, 5e-4), above the eps guard
    assert gap == pytest.approx(max(1e-6 * track, 5e-4))
    assert 1e-4 < gap < 1e-2


def test_zmx_mangin_refused_in_both(tmp_path):
    text = "\n".join([
        "MODE SEQ", "WAVM 1 0.5876 1",
        "SURF 0", "  TYPE STANDARD", "  DISZ INFINITY",
        "SURF 1", "  TYPE STANDARD", "  CURV 0.02", "  DISZ 3",
        "  GLAS N-BK7", "  DIAM 6 1 0 0 1 \"\"",
        "SURF 2", "  TYPE STANDARD", "  CURV 0.01", "  DISZ -3",
        "  GLAS MIRROR", "  DIAM 6 1 0 0 1 \"\"",
        "SURF 3", "  TYPE STANDARD", "  CURV 0.02", "  DISZ -20",
        "  DIAM 6 1 0 0 1 \"\"",
        "SURF 4", "  TYPE STANDARD", "  DISZ 0", "  DIAM 3 1 0 0 1 \"\"",
    ])
    p = tmp_path / "mangin.zmx"
    p.write_text(text)
    msgs = []
    for io in (RIO, PIO):
        with pytest.raises(ValueError, match="Mangin") as e:
            io.zmx_to_scene(p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    props = PIO.zmx_paraxial(PIO.load_zmx(p))
    assert np.isfinite(props["efl"])
    assert_same(RIO.zmx_paraxial(RIO.load_zmx(p)), props)


SEQS = {
    "singlet": "\n".join([
        "LEN", "TITLE 'codev biconvex singlet'", "DIM M", "EPD 10",
        "WL 587.6", "SO 0 INFINITY", "S 30 5 NBK7_SCHOTT", "  STO; CIR 8",
        "S -30 28.5", "  CIR 8", "SI 0 0", "  CIR 3", "GO"]),
    "doublet": "\n".join([
        "LEN", "TITLE 'achromat'", "WL 486.1 587.6 656.3", "REF 2",
        "SO 0 INF", "S 20 4 NBK7_SCHOTT", "  CIR 6",
        "S -15 2 SF10_SCHOTT", "  CIR 6", "S -60 30", "  CIR 6",
        "SI 0 0", "  CIR 3"]),
    "asphere": "\n".join([
        "LEN", "WL 587.6", "SO 0 INF", "S 25 4 NBK7_SCHOTT",
        "  K -0.5; A 1e-5; B -2e-8; CIR 6", "S 0 40", "  CIR 6",
        "SI 0 0", "  CIR 3"]),
    "mirror": "\n".join([
        "LEN", "WL 587.6", "SO 0 INF", "S -2000 -1000 REFL",
        "  K -1; CIR 100", "SI 0 0", "  CIR 2"]),
}


@pytest.mark.parametrize("name", sorted(SEQS))
def test_seq_load_paraxial_and_scene(name, tmp_path):
    p = tmp_path / f"{name}.seq"
    p.write_text(SEQS[name])
    a, b = RIO.load_seq(p), PIO.load_seq(p)
    assert_same(a, b)
    assert_same(RIO.seq_paraxial(a), PIO.seq_paraxial(b))
    els, info = both_scenes("seq_to_scene", p, n_segments=24, n_radial=8)
    assert len(els) >= 2
    if name == "doublet":
        assert any("cemented" in w for w in info["warnings"])


# ---- IES LM-63 ---------------------------------------------------------------

def luminaire_rays(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) * 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d, rng.uniform(0.5, 1.5, n) / n, rng.uniform(0.45, 0.65, n)


def test_ies_round_trip_and_source(tmp_path):
    d, p, wl = luminaire_rays()
    files = {}
    for name, (_, io) in PKGS.items():
        files[name] = tmp_path / f"{name}.ies"
        lm = io.save_ies(files[name], d, p, wavelengths=wl, n_vertical=19,
                         n_horizontal=13, keywords={"LUMINAIRE": "bowl"})
        files[name + "_lm"] = lm
    assert files["ref_lm"] == files["port_lm"]
    assert files["ref"].read_bytes() == files["port"].read_bytes()
    datas = {(w, r): PKGS[r][1].load_ies(files[w]) for w in ("ref", "port")
             for r in PKGS}
    for data in datas.values():
        assert_same(datas[("ref", "ref")], data)
    data = datas[("ref", "port")]
    assert data.total_lumens == datas[("ref", "ref")].total_lumens
    assert_same(RIO.luminous_intensity_grid(d, p, lm_per_watt=300.0,
                                            n_vertical=10, n_horizontal=4,
                                            axis=(0.2, 0.0, 1.0)),
                PIO.luminous_intensity_grid(d, p, lm_per_watt=300.0,
                                            n_vertical=10, n_horizontal=4,
                                            axis=(0.2, 0.0, 1.0)))
    # explicit web, then the web as a light source: same rays
    vdeg = np.linspace(0, 90, 10)
    c = (np.cos(np.radians(vdeg))[None, :] * [[100.0], [80.0], [60.0]])
    for name, (_, io) in PKGS.items():
        io.save_ies(tmp_path / f"web_{name}.ies", candela=c,
                    vertical_deg=vdeg, horizontal_deg=[0.0, 90.0, 180.0])
    assert ((tmp_path / "web_ref.ies").read_bytes()
            == (tmp_path / "web_port.ies").read_bytes())
    kw = dict(center=(0.0, 0.0, 1.0), direction=(0.0, 0.3, -1.0),
              ray_count=2000, seed=4)
    for mode in ("weighted", "sampled"):
        a = RIO.ies_source(tmp_path / "web_ref.ies", mode=mode, **kw)
        b = PIO.ies_source(tmp_path / "web_ref.ies", mode=mode, **kw)
        assert_same(a.sample(), b.sample())
        assert a.power == b.power == pytest.approx(
            RIO.load_ies(tmp_path / "web_ref.ies").total_lumens)


def test_ies_refusals_match(tmp_path):
    bad = tmp_path / "tilt.ies"
    bad.write_text("IESNA:LM-63-2002\nTILT=INCLUDE\n1 2 3\n")
    msgs = []
    for io in (RIO, PIO):
        with pytest.raises(ValueError) as e:
            io.load_ies(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
