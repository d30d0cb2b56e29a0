"""A reconstruction's capture of its chunk graph (the program's spans): its
warm-up chunk, the capture and the instantiation.  None where no call
captured (eager calls, the CPU)."""
from portbench.spans import median


def read(run):
    return median(run, 'decompress', lambda u: u.ms('eval.capture', 'eval.capture'))
