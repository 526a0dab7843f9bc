"""Host ms per ``cluster`` job folding edges into the component labels: the
program's ``kspider.cc`` ranges (star edges, the copy to the device, the
label propagation rounds and the labels' copy back)."""

from gpubench import readers

LAYER = "CC"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.cc",))
