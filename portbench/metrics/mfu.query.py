"""The query path's share of the float32 peak over its requests' own time,
sending to output (counts/model.py)."""
from portbench.layer import mfu


def read(run):
    return mfu(run, 'query')
