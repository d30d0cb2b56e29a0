"""The share of a traced training chunk in which the card ran nothing."""
from portbench.layer import idle_share


def read(run):
    return idle_share(run, 'train')
