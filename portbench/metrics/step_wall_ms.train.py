"""A training step's wall time while the card sets the pace (the program's
spans): from the start of a chunk's steps to the end of its device read,
over its steps."""
from portbench.spans import median


def wall(u):
    steps, ms = u.parts.get('train.steps'), u.ms('train.steps', 'train.read')
    return ms / steps.n if ms is not None and steps.n else None


def read(run):
    return median(run, 'train', wall)
