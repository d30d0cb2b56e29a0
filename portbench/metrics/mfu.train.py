"""The training step's share of the float32 peak (counts/model.py)."""
from portbench.layer import mfu


def read(run):
    return mfu(run, 'train')
