"""The host's time to launch one query request's work (the program's
spans): its ``query.request`` span, which holds no wait for the card."""
from portbench.spans import median


def read(run):
    return median(run, 'query', lambda u: (u.span.end_ns - u.span.start_ns) * 1e-6)
