"""Voxels of every reconstruction completed in the window, over its wall time."""


def read(run):
    return run.work / run.window_s if run.kind == 'decompress' and run.window_s > 0 else None
