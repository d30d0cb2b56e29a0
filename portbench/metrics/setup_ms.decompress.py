"""A reconstruction's set-up (the program's spans: ``eval.setup``): the
grid's decode, made channel-minor, the lattice's constants and the buffers."""
from portbench.spans import median


def read(run):
    return median(run, 'decompress', lambda u: u.ms('eval.setup', 'eval.setup'))
