"""A query request's decode of the grid, made channel-minor (the program's
spans: ``query.decode``)."""
from portbench.spans import median


def read(run):
    return median(run, 'query', lambda u: u.ms('query.decode', 'query.decode'))
