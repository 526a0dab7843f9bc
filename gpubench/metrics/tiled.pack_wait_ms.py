"""Host ms per ``cluster`` job in which the thread that drives the card waits
for the panel-streamed engine's pack thread: the program's
``kspider.pack_wait`` ranges, one per panel pair."""

from gpubench import readers

LAYER = "tiled engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.pack_wait",))
