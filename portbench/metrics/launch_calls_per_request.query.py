"""Host calls that launched device work per traced query request."""
from portbench.layer import launch_calls


def read(run):
    return launch_calls(run, 'query', lambda s: s.units)
