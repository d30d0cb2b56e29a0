"""Set-up: from the process's start to the window's (host clock)."""


def read(run):
    return run.setup_s
