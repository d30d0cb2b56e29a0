"""A lattice chunk's wall time in a reconstruction (the program's spans):
from the start of the chunks' launches to the end of the release, which
waits for the card, over the chunks; where nothing is released (eager
calls), to the end of the launches."""
from portbench.spans import median


def wall(u):
    chunks = u.parts.get('eval.chunks')
    last = 'eval.release' if 'eval.release' in u.parts else 'eval.chunks'
    ms = u.ms('eval.chunks', last)
    return ms / chunks.n if ms is not None and chunks.n else None


def read(run):
    return median(run, 'decompress', wall)
