"""Host ms per ``cluster`` job reading the pairwise TSV back: the program's
``kspider.tsv_read`` ranges, one per chunk (the pandas parse and the cutoff
mask)."""

from gpubench import readers

LAYER = "TSV reader"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.tsv_read",))
