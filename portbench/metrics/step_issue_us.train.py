"""The host's time to launch one training step (the program's spans): a
chunk's ``train.steps`` over its steps, in us."""
from portbench.spans import median


def per_step(u):
    steps = u.parts.get('train.steps')
    return (steps.end_ns - steps.start_ns) * 1e-3 / steps.n if steps and steps.n else None


def read(run):
    return median(run, 'train', per_step)
