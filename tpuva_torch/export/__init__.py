"""tpuva_torch.export — trajectory CSV and HDF5 writers (the names of
``tpuva/export/__init__.py``). h5py is imported when a file is opened."""

from tpuva_torch.export.csvio import write_tracks_csv, read_tracks_csv  # noqa: F401
from tpuva_torch.export.hdf5io import write_tracks_hdf5, read_tracks_hdf5  # noqa: F401
