"""The port's native I/O helper (``lib``: LZ4, bit packing, 1-D k-means)."""

from . import lib  # noqa: F401
