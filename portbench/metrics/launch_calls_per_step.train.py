"""Host calls that launched device work (a kernel or a CUDA graph) a
training step, over a traced chunk: its draws, loads, steps and read."""
from portbench.layer import launch_calls


def read(run):
    return launch_calls(run, 'train', lambda s: s.units)
