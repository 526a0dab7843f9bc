"""Host ms per ``cluster`` job in the cluster driver's own work: the
``kspider.containment`` ranges (``--from-index``: each pair's containment,
cutoff mask and edge buffers) and the ``kspider.clusters`` range (the
components as lists and the clusters file)."""

from gpubench import readers

LAYER = "cluster driver"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "cluster_s"
STAGE = "cluster"


def read(win):
    return readers.range_ms(win, STAGE, ("kspider.containment", "kspider.clusters"))
