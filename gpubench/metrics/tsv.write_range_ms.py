"""The pairwise TSV's write per ``pairwise`` job on the dense engine, in the
program's own ``kspider.tsv`` range around the writer (the native writer
formats every pair of the int64 matrix)."""

from gpubench import readers

LAYER = "TSV writer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "pairwise_s"
STAGE = "pairwise"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.tsv",))
