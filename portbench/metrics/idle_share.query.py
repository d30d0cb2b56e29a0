"""The share of the traced requests' spans (sent to output) in which the
card ran nothing; the making of the next plane between requests is not
counted."""
from portbench.layer import idle_share


def read(run):
    return idle_share(run, 'query', spans=True)
