"""The share of the ``pairwise`` stage's wall in which the device ran no
kernel, copy or set, from the device trace."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "pairwise_s"
STAGE = "pairwise"


def read(win):
    return readers.idle_share(win, STAGE)
