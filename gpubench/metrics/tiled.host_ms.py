"""Host ms per ``cluster`` job in the panel-streamed engine's dispatch and
extract ranges (``kspider.dispatch``, ``kspider.extract``), on the thread
that drives the card."""

from gpubench import readers

LAYER = "tiled engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.dispatch", "kspider.extract"))
