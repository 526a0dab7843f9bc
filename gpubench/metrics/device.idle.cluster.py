"""The share of the ``cluster`` stage's wall in which the device ran no
kernel, copy or set, from the device trace."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.idle_share(win, STAGE)
