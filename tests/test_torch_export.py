"""The port's trajectory exports (tpuva_torch/export) against tpuva's.

h5py stores object timestamps, so two HDF5 files with the same data can
differ in bytes: each package's reader reads the other's files, and the
datasets, their dtypes and the ``columns`` attribute are compared. CSV
files are compared byte for byte.
"""

import h5py
import numpy as np
import pytest

import tpuva.export.csvio as jcsv
import tpuva.export.hdf5io as jh5
import tpuva_torch.export as texport
import tpuva_torch.export.csvio as tcsv
import tpuva_torch.export.hdf5io as th5

PKG = {"port": th5, "tpuva": jh5}


def track_rows(seed, n=40):
    """(track_id, frame, x, y, area) rows, unsorted, x/y past 3 decimals."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 6)), int(f), float(rng.uniform(0, 1920)),
             float(rng.uniform(0, 1080)), float(rng.integers(20, 900)))
            for f in rng.permutation(n)]


def stream_rows(seed, n=30):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 3)),) + r for r in track_rows(seed + 1, n)]


def datasets(path):
    """{name: (array, dtype, attrs)} of every dataset in the file."""
    out = {}
    with h5py.File(path, "r") as f:
        for name in f:
            d = f[name]
            out[name] = (d[...], d.dtype, {k: [str(v) for v in d.attrs[k]] for k in d.attrs})
    return out


def assert_same_datasets(a, b):
    da, db = datasets(a), datasets(b)
    assert sorted(da) == sorted(db)
    for name in da:
        (xa, ta, aa), (xb, tb, ab) = da[name], db[name]
        assert ta == tb and xa.shape == xb.shape and aa == ab
        np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("rows", ["tracks", "empty", "one"])
@pytest.mark.parametrize("kind", ["single", "multistream"])
@pytest.mark.parametrize("writer", sorted(PKG))
def test_hdf5_files_read_across_packages(tmp_path, writer, kind, rows):
    make = stream_rows if kind == "multistream" else track_rows
    data = {"tracks": make(0), "empty": [], "one": make(1, 1)}[rows]
    w = PKG[writer]
    other = PKG["tpuva" if writer == "port" else "port"]
    path, ref = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    if kind == "single":
        w.write_tracks_hdf5(path, data)
        other.write_tracks_hdf5(ref, data)
        got = [th5.read_tracks_hdf5(path), jh5.read_tracks_hdf5(path)]
        assert sorted(datasets(path)) == ["tracks", "trajectories"]
    else:
        w.write_multistream_hdf5(path, data)
        other.write_multistream_hdf5(ref, data)
        got = [th5.read_multistream_hdf5(path), jh5.read_multistream_hdf5(path)]
    assert_same_datasets(path, ref)
    for arr in got:
        assert arr.dtype == np.float64 and arr.shape == (len(data), 6 if kind == "multistream" else 5)
    np.testing.assert_array_equal(got[0], got[1])


def test_export_names_and_csv_across_packages(tmp_path):
    rows = track_rows(2)
    assert texport.write_tracks_hdf5 is th5.write_tracks_hdf5
    assert texport.read_tracks_csv is tcsv.read_tracks_csv
    assert th5.COLUMNS == jh5.COLUMNS and th5.MS_COLUMNS == jh5.MS_COLUMNS
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    texport.write_tracks_csv(str(a), rows)
    jcsv.write_tracks_csv(str(b), rows)
    assert a.read_bytes() == b.read_bytes()
    for path in (a, b):
        np.testing.assert_array_equal(tcsv.read_tracks_csv(str(path)), jcsv.read_tracks_csv(str(path)))
    empty = tmp_path / "e.csv"
    texport.write_tracks_csv(str(empty), [])
    assert tcsv.read_tracks_csv(str(empty)).shape == (0, 5) == jcsv.read_tracks_csv(str(empty)).shape
