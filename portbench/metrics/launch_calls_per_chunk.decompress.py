"""Host calls that launched device work per lattice chunk of a traced
reconstruction (its decode, warm-up chunk and capture included)."""
import math

from portbench.layer import launch_calls

CHUNK = 1 << 18


def read(run):
    chunks = math.ceil(run.config['volume']['n'] ** 3 / CHUNK)
    return launch_calls(run, 'decompress', lambda s: s.units * chunks)
