"""The port's application layer (tpuva_torch/app, compose, analysis/curves,
cli) against tpuva's on the CPU.

``Parameters`` and ``TrackCollection`` on the scenes of
``tests/test_app.py``; ``TrackingProject.run`` on the same 40-frame
120 x 160 clip in both packages (``device="cpu"`` in the port): the
report and CSV byte for byte, the HDF5 datasets equal, the pass-4 movie's
decoded frames equal, and tpuva's pass-1 file resumed by the port; the
command line on an encoded file, byte for byte against ``tpuva.cli``.
"""

import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

import tpuva.analysis.curves as jcurves
import tpuva.app as japp
import tpuva.app.passes as jpasses
import tpuva.cli as jcli
import tpuva.graph.config as jconfig
import tpuva.io as jio
import tpuva_torch.analysis.curves as tcurves
import tpuva_torch.app as tapp
import tpuva_torch.app.passes as tpasses
import tpuva_torch.cli as tcli
import tpuva_torch.graph.config as tconfig
import tpuva_torch.io as tio
from refimpl.synthetic import multi_blob_clip
from test_app import _track
from test_torch_export import assert_same_datasets
from test_torch_kernels import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parameters_match_tpuva():
    data = {"a": {"b": 1, "c": [2, 3]}, "d": 3.5}
    ps = [tapp.Parameters(data), japp.Parameters(data)]
    out = []
    for p in ps:
        q = p.with_overrides({"a": {"b": 10, "e": {"f": 7}}, "g": "x"})
        q["a.h.i"] = 9
        r = type(p).from_json(q.to_json())
        out.append((p.to_dict(), q.to_json(), r.to_dict(), q["a.e.f"], q.get("a.zz", -1),
                    "a.c" in q, "zz" in q, repr(r)))
    assert out[0] == out[1]
    assert tpasses.DEFAULTS.to_json() == jpasses.DEFAULTS.to_json()


# the scenes of tests/test_app.py: (rows, stitch kwargs)
SCENES = {
    "gap_and_far": (
        [(1, t, 10.0 + t, 20.0, 30) for t in range(10)]
        + [(2, t, 10.0 + t, 20.5, 30) for t in range(14, 25)]
        + [(3, t, 200.0, 200.0, 40) for t in range(12, 20)], dict(max_gap=10, max_dist=10.0)),
    "conflict_cheapest": (
        _track(1, 0, [(0, 0)] * 5) + _track(2, 0, [(0, 3)] * 5)
        + _track(9, 8, [(0, 5), (0, 6)]), dict(max_gap=10, max_dist=10.0)),
    "tie_smaller_gap": (
        _track(1, 0, [(0, 0)] * 4) + _track(2, 0, [(10, 0)] * 6) + _track(9, 8, [(5, 0)]),
        dict(max_gap=10, max_dist=10.0)),
    "tie_lower_id": (
        _track(4, 0, [(0, 0)] * 4) + _track(3, 0, [(10, 0)] * 4) + _track(9, 6, [(5, 0)]),
        dict(max_gap=10, max_dist=10.0)),
    "time_overlap": (
        _track(1, 0, [(0, 0)] * 10) + _track(2, 9, [(0, 0), (0, 1)])
        + _track(3, 5, [(0, 0)] * 5), dict(max_gap=10, max_dist=10.0)),
    "gap_boundary": (_track(1, 0, [(0, 0)] * 3) + _track(2, 7, [(0, 0)]), dict(max_gap=5, max_dist=1)),
    "gap_past": (_track(1, 0, [(0, 0)] * 3) + _track(2, 8, [(0, 0)]), dict(max_gap=5, max_dist=1)),
    "dist_boundary": (_track(1, 0, [(0, 0)] * 3) + _track(2, 4, [(3, 4)]),
                      dict(max_gap=5, max_dist=5.0)),
    "dist_past": (_track(1, 0, [(0, 0)] * 3) + _track(2, 4, [(3, 4.001)]),
                  dict(max_gap=5, max_dist=5.0)),
    "chain": (
        _track(1, 0, [(0, 0), (1, 0), (2, 0)]) + _track(2, 5, [(4, 0), (5, 0), (6, 0)])
        + _track(3, 10, [(8, 0)]), dict(max_gap=5, max_dist=4.0)),
    "loser_attaches": (
        _track(1, 0, [(0, 0)] * 3) + _track(2, 4, [(0, 1), (0, 2)]) + _track(3, 7, [(0, 3)]),
        dict(max_gap=3, max_dist=5.0)),
    "noisy_line": (
        [(1, int(t), 1.5 * t + n[0], 7.0 + n[1], 1.0 + (t % 3))
         for t, n in zip(range(41), np.random.default_rng(0).normal(0, 1.0, (41, 2)))
         if t % 7 != 3], dict(max_gap=10, max_dist=40.0)),
}


def collection_outputs(pkg, rows, stitch_kw):
    tc = pkg.TrackCollection.from_rows(rows)
    st = tc.stitch(**stitch_kw)
    out = [tc.to_rows(), st.to_rows(), tc.summary(), st.summary(),
           st.filter_short(3).to_rows()]
    for t in st:
        ti, ts = t.interpolated(), t.smoothed(5)
        out += [ti.to_rows(), ts.to_rows(), t.position_at((t.start + t.end) / 2),
                (t.path_length(), t.displacement(), t.mean_speed(), t.mean_area(), t.duration,
                 t.first_position, t.last_position)]
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_track_collection_matches_tpuva(scene):
    rows, kw = SCENES[scene]
    got = collection_outputs(tapp, rows, kw)
    ref = collection_outputs(japp, rows, kw)
    assert repr(got) == repr(ref)


def test_curves_match_tpuva():
    rng = np.random.default_rng(3)
    curve = np.cumsum(rng.normal(0, 2, (30, 2)), axis=0)
    for name, args in (("curve_length", (curve,)), ("smooth_curve", (curve, 5)),
                       ("make_curve_equidistant", (curve, None, 17)),
                       ("simplify_curve", (curve, 1.5)), ("curve_distance", ((3.0, -2.0), curve)),
                       ("average_normalized_curves", ([curve, curve[::-1]], 12)),
                       ("fit_spline", (curve, 25, 1.0))):
        got, ref = getattr(tcurves, name)(*args), getattr(jcurves, name)(*args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=name)
    # tpuva's skeleton calls ndarray.ptp, gone in NumPy 2; the port's
    # np.ptp gives the column means of a horizontal bar
    mask = np.zeros((9, 12), np.uint8)
    mask[3:6, 2:10] = 1
    np.testing.assert_array_equal(tcurves.curve_from_mask_skeleton(mask),
                                  np.stack([np.arange(2, 10), np.full(8, 4.0)], axis=1))


# --------------------------------------------------------- the whole project
def project_clip():
    clip, _alive, _truth, plate = multi_blob_clip(
        h=120, w=160, frames=40, n_blobs=2, radius=8, births_deaths=False
    )
    return clip, plate


def project_cfg(C):
    return C.PipelineConfig(
        background=C.BackgroundConfig(alpha=0.0),
        segment=C.SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=C.TrackConfig(max_dist=40.0, death_patience=3, max_tracks=8),
        batch=8,
    )


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """tpuva's and the port's TrackingProject.run (pass 4 on) on one clip."""
    clip, plate = project_clip()
    base = tmp_path_factory.mktemp("projects")
    overrides = {"pass4": {"enabled": True}}
    jp = japp.TrackingProject(str(base / "tpuva"), project_cfg(jconfig), overrides=overrides)
    tp = tapp.TrackingProject(str(base / "port"), project_cfg(tconfig), overrides=overrides,
                              device="cpu")
    reports = (tp.run(tio.VideoMemory(clip), background0=plate),
               jp.run(jio.VideoMemory(clip), background0=plate))
    return tp, jp, reports


def test_project_report_and_csv_bytes_equal(projects):
    tp, jp, (rep_t, rep_j) = projects
    assert rep_t == rep_j and rep_t["n_tracks"] == 2
    for name in ("report.json", "pass2_tracks.csv"):
        with open(tp.path(name), "rb") as a, open(jp.path(name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("name", ["pass1_tracks.h5", "pass2_tracks.h5"])
def test_project_hdf5_datasets_equal(projects, name):
    tp, jp, _ = projects
    assert_same_datasets(tp.path(name), jp.path(name))


def test_project_movie_frames_equal(projects):
    tp, jp, _ = projects
    a, b = cv2.VideoCapture(tp.path("debug.avi")), cv2.VideoCapture(jp.path("debug.avi"))
    n = 0
    while True:
        ok_a, fa = a.read()
        ok_b, fb = b.read()
        assert ok_a == ok_b
        if not ok_a:
            break
        np.testing.assert_array_equal(fa, fb)
        n += 1
    a.release()
    b.release()
    assert n == 40


def test_tpuva_pass1_resumes_in_the_port(projects, tmp_path):
    """tpuva's pass1_tracks.h5 in a fresh directory for each package: the
    port's pass 1 reads it instead of running the pipeline, and its passes
    2-3 give the bytes tpuva's give from the same file."""
    _tp, jp, _ = projects
    clip, plate = project_clip()

    class NoFrames(tio.VideoMemory):
        def get_frame(self, index):
            raise AssertionError("pass 1 ran instead of resuming")

    outs = {}
    for name, pkg, C, kw in (("port", tapp, tconfig, dict(device="cpu")),
                             ("tpuva", japp, jconfig, {})):
        out = tmp_path / name
        out.mkdir()
        shutil.copy(jp.path("pass1_tracks.h5"), out / "pass1_tracks.h5")
        proj = pkg.TrackingProject(str(out), project_cfg(C), **kw)
        t1 = proj.pass1(NoFrames(clip), background0=plate, resume=True)
        proj.pass3(proj.pass2(t1))
        outs[name] = out
    for name in ("report.json", "pass2_tracks.csv"):
        assert (outs["port"] / name).read_bytes() == (outs["tpuva"] / name).read_bytes(), name
    assert_same_datasets(str(outs["port"] / "pass2_tracks.h5"),
                         str(outs["tpuva"] / "pass2_tracks.h5"))


def test_project_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.TrackingProject(os.devnull + "_never_made", project_cfg(tconfig))


def test_cli_on_encoded_file_matches_tpuva(tmp_path, monkeypatch):
    """The port's CLI (`--device cpu`) and tpuva's on the same encoded
    file and flags: report and CSV byte for byte, HDF5 datasets equal.
    The file's frames reach pass 1 through the C++ ring."""
    from tpuva_torch.io.native import NativeBatcher

    pops, pop = [], NativeBatcher.pop
    monkeypatch.setattr(NativeBatcher, "pop", lambda self: pops.append(pop(self)) or pops[-1])
    clip, _alive, _truth, _plate = multi_blob_clip(
        h=96, w=128, frames=32, n_blobs=2, radius=8, births_deaths=False
    )
    path = str(tmp_path / "in.avi")
    with tio.VideoFileWriter(path, fps=25.0) as w:
        for f in clip:
            w.write_frame(f)
    flags = ["--threshold", "40", "--min-area", "20", "--alpha", "0"]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "tpuva")
    assert tcli.main([path, out_t, *flags, "--device", "cpu"]) == 0
    assert [n for _s, n in pops] == [32, 0]  # one batch of 32, then the end
    assert jcli.main([path, out_j, *flags]) == 0
    for name in ("report.json", "pass2_tracks.csv"):
        with open(os.path.join(out_t, name), "rb") as a, open(os.path.join(out_j, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out_t, "report.json")) as fh:
        assert json.load(fh)["n_tracks"] >= 2
    for name in ("pass1_tracks.h5", "pass2_tracks.h5"):
        assert_same_datasets(os.path.join(out_t, name), os.path.join(out_j, name))
    assert tcli.build_parser().parse_args(["x"]).device == "cuda"


def test_cli_help_loads_no_torch_or_jax():
    probe = ("import sys, contextlib, io\n"
             "from tpuva_torch import cli\n"
             "with contextlib.redirect_stdout(io.StringIO()) as out:\n"
             "    try: cli.main(['--help'])\n"
             "    except SystemExit: pass\n"
             "assert '--device' in out.getvalue()\n"
             "print(sorted(m for m in ('torch', 'jax', 'cv2', 'h5py') if m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
