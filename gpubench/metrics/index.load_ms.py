"""Host ms per ``cluster`` job reading the stage's input artifacts from disk:
the program's ``kspider.load`` ranges (``--from-index``: the index)."""

from gpubench import readers

LAYER = "CLI"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.load",))
