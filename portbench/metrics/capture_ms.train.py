"""A training phase's capture of its step graph (the program's spans:
``train.capture``, in each phase's first chunk): the warm-up steps on a
scratch state, the capture and the instantiation.  None where no chunk of
the window captured (eager steps, the CPU)."""
from portbench.spans import median


def read(run):
    return median(run, 'train', lambda u: u.ms('train.capture', 'train.capture'))
