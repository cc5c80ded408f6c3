"""The port's io modules (checkpoint, LPR1 ray files) against the JAX
package's: round trips, each package reading the other's files, the schema
rules, and RayFileSource's host replay."""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.io import checkpoint as RC
from lightpycl_tpu.io import rayfile as RR
from lightpycl_tpu.tracer.rays import DetectorState as RefDet
from lightpycl_tpu.tracer.rays import Ledger as RefLedger
from lightpycl_tpu_torch.io import checkpoint as PC
from lightpycl_tpu_torch.io import rayfile as PR
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger

torch.set_num_threads(1)
CPU = torch.device("cpu")


def state(seed):
    """A reference (rays, detector, ledger) triple with every map on, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    n = 64
    d = rng.normal(size=(n, 3))
    rays = L.RayBatch.from_arrays(rng.uniform(-1, 1, (n, 3)),
                                  d / np.linalg.norm(d, axis=1)[:, None],
                                  rng.uniform(0, 1, n), capacity=80,
                                  wavelengths=rng.uniform(0.4, 0.7, n))
    det = RefDet(*(rng.uniform(0, 1, np.asarray(a).shape).astype(np.float32)
                   for a in RefDet.zeros(6, 3, 2, 4, coherent=True, n_tris=7,
                                         time_bins=5)))
    led = RefLedger(*rng.uniform(0, 1, 5).astype(np.float32))
    return rays, det, led


def assert_fields_equal(a, b, computed=()):
    """Equal field for field; the `computed` fields (made by each package's
    own arithmetic) to 1e-6."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, f
        if f in computed:
            assert np.allclose(x, y, rtol=0, atol=1e-6), f
        else:
            assert np.array_equal(x, y), f


EXTRA = dict(hist64=np.arange(6.0).reshape(2, 3), next_batch=3,
             led64=np.linspace(0, 1, 5))


def test_checkpoint_round_trip(tmp_path):
    rays, det, led = state(0)
    p_rays = P.RayBatch.from_reference(rays, CPU)
    p_det = DetectorState.from_reference(det, CPU)
    p_led = Ledger(*(torch.tensor(float(x)) for x in led))
    path = PC.save_state(str(tmp_path / "ck"), rays=p_rays, detector=p_det,
                         ledger=p_led, **EXTRA)
    assert path.endswith(".npz")
    back = PC.load_state(str(tmp_path / "ck"), device=CPU)
    assert_fields_equal(p_rays, back["rays"])
    assert_fields_equal(p_det, back["detector"])
    assert_fields_equal(p_led, back["ledger"])
    assert int(back["extra"]["next_batch"]) == 3
    assert int(back["extra"]["schema_version"]) == PC.SCHEMA_VERSION == \
        RC.SCHEMA_VERSION
    assert np.array_equal(back["extra"]["hist64"], EXTRA["hist64"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_read_by_the_other_package(tmp_path, writer):
    rays, det, led = state(1)
    path = str(tmp_path / "ck.npz")
    if writer == "reference":
        RC.save_state(path, rays=rays, detector=det, ledger=led, **EXTRA)
        back = PC.load_state(path, device=CPU)
    else:
        PC.save_state(path, rays=P.RayBatch.from_reference(rays, CPU),
                      detector=DetectorState.from_reference(det, CPU),
                      ledger=Ledger(*(torch.from_numpy(np.array(x))
                                      for x in led)), **EXTRA)
        back = RC.load_state(path)
    for key, ref_state in (("rays", rays), ("detector", det),
                           ("ledger", led)):
        assert_fields_equal(ref_state, back[key])
    for k, v in EXTRA.items():
        assert np.array_equal(back["extra"][k], v), k


def test_checkpoint_forward_fill_and_refusal(tmp_path):
    rays, det, led = state(2)
    # a schema-2 file: no basis / wavelength / medium columns, no
    # image_amp / tri_flux / time_hist
    old = {f"rays_{f}": np.asarray(getattr(rays, f))
           for f in L.RayBatch._fields
           if f not in ("basis", "wavelength", "medium")}
    old.update({f"det_{f}": np.asarray(getattr(det, f))
                for f in ("hist", "per_detector", "image")})
    old["extra_schema_version"] = np.asarray(2)
    np.savez(tmp_path / "old.npz", **old)
    ref = RC.load_state(str(tmp_path / "old.npz"))
    port = PC.load_state(str(tmp_path / "old.npz"), device=CPU)
    # the forward-filled basis is each package's default_basis (a cross
    # product and a norm in f32)
    assert_fields_equal(ref["rays"], port["rays"], computed=("basis",))
    assert_fields_equal(ref["detector"], port["detector"])
    assert port["detector"].tri_flux.shape == (1,)
    assert port["detector"].time_hist.shape == (1, 1)
    assert port["detector"].image_amp.shape == (2, 1, 1)
    assert torch.equal(port["rays"].medium, torch.full((80,), -1.0))
    assert port["ledger"] is None
    # a newer schema is refused by both
    np.savez(tmp_path / "new.npz", extra_schema_version=np.asarray(5))
    for load in (RC.load_state, lambda p: PC.load_state(p, device=CPU)):
        with pytest.raises(ValueError, match="newer"):
            load(str(tmp_path / "new.npz"))


def rays_file_arrays(seed, n=300):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return dict(origins=rng.uniform(-1, 1, (n, 3)),
                directions=d / np.linalg.norm(d, axis=1)[:, None],
                powers=rng.uniform(0, 1, n),
                wavelengths=rng.uniform(0.4, 0.7, n),
                stokes=rng.uniform(-0.5, 0.5, (n, 3)),
                opl=rng.uniform(0, 10, n))


@pytest.mark.parametrize("blocks", [(), ("wavelengths",),
                                    ("wavelengths", "stokes", "opl")])
def test_rayfiles_byte_identical_and_cross_read(tmp_path, blocks):
    a = rays_file_arrays(4)
    kw = {k: a[k] for k in blocks}
    ref_path, port_path = tmp_path / "ref.lpr", tmp_path / "port.lpr"
    assert RR.save_rayfile(ref_path, a["origins"], a["directions"],
                           a["powers"], **kw) == 300
    assert PR.save_rayfile(port_path, a["origins"], a["directions"],
                           a["powers"], **kw) == 300
    assert ref_path.read_bytes() == port_path.read_bytes()
    for reader, path in ((PR.load_rayfile, ref_path),
                         (RR.load_rayfile, port_path)):
        got = reader(path)
        for k in ("origins", "directions", "powers", "wavelengths", "stokes",
                  "opl"):
            want = a[k] if k in ("origins", "directions", "powers") or \
                k in blocks else None
            if want is None:
                assert getattr(got, k) is None
            else:
                assert np.array_equal(getattr(got, k),
                                      np.asarray(want, np.float32)), k


def test_rayfile_refuses_damage(tmp_path):
    a = rays_file_arrays(5, n=10)
    path = tmp_path / "r.lpr"
    PR.save_rayfile(path, a["origins"], a["directions"], a["powers"])
    raw = path.read_bytes()
    (tmp_path / "bad_magic.lpr").write_bytes(b"XXXX" + raw[4:])
    (tmp_path / "short.lpr").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="magic"):
        PR.load_rayfile(tmp_path / "bad_magic.lpr")
    with pytest.raises(ValueError, match="truncated"):
        PR.load_rayfile(tmp_path / "short.lpr")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ray_count=500, power=2.0, seed=3),
    dict(rotate=((0, 1, 1), 0.4), translate=(0.5, -1.0, 2.0), power=0.7),
])
def test_rayfile_source_host_replay_matches_reference(tmp_path, kw):
    a = rays_file_arrays(6)
    path = tmp_path / "src.lpr"
    RR.save_rayfile(path, a["origins"], a["directions"], a["powers"],
                    wavelengths=a["wavelengths"], stokes=a["stokes"])
    ref, port = RR.RayFileSource(str(path), **kw), PR.RayFileSource(
        str(path), **kw)
    for r, p in zip(ref.sample(), port.sample()):
        assert np.array_equal(r, p)
    assert np.array_equal(ref.sample_wavelengths(), port.sample_wavelengths())
    for r, p in zip(ref.stokes, port.stokes):
        assert np.array_equal(r, p)


def test_measured_rays_export_and_replay(tmp_path):
    # a host-mode trace's measured rays written by the port, read by both,
    # and traced again from the file as a source
    oe = P.optical_elements(16, 6)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           oe.hemisphere(10.0, name="dome")]
    src = P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                         ray_count=256, seed=1)
    res = P.Tracer(device=CPU).trace(src, els, trace_iterations=3)
    path = tmp_path / "dome.lpr"
    n = PR.save_measured_rayfile(path, res, detector="dome", flip=True)
    assert n == len(res.measured_power) > 0
    assert np.array_equal(RR.load_rayfile(path).powers,
                          res.measured_power.astype(np.float32))
    data = PR.load_rayfile(path)
    assert np.allclose(data.directions, -res.measured_dir)
    assert data.stokes is None  # unpolarized trace
    replay = P.Tracer(device=CPU).trace(PR.RayFileSource(str(path)),
                                        [oe.sphere(20.0, material="measure",
                                                   name="shell")],
                                        trace_iterations=2)
    assert replay.ledger["measured"] == pytest.approx(data.total_power,
                                                      rel=1e-5)
