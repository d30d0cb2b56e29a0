from .volume import load_volume, normalize_volume, VolumeMeta, lattice_coords
from .cvol import read_cvol, write_cvol
