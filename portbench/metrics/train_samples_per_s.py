"""Samples of every training step the window took, over its wall time."""


def read(run):
    return run.work / run.window_s if run.kind == 'train' and run.window_s > 0 else None
