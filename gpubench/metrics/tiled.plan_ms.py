"""Host ms per ``cluster`` job building the panel-streamed engine's panel
plan: the program's ``kspider.plan`` range."""

from gpubench import readers

LAYER = "tiled engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.plan",))
