"""A query request's head on the decoded grid (the program's spans:
``query.predict``): the fetch, the MLP and the clamp, launched."""
from portbench.spans import median


def read(run):
    return median(run, 'query', lambda u: u.ms('query.predict', 'query.predict'))
