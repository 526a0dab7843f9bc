"""The pairwise TSV's write per ``pairwise`` job on the dense engine: from
the end of the last ``kspider.recombine`` range to the end of the stage
(the native writer formats every pair of the int64 matrix)."""

LAYER = "TSV writer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "pairwise_s"
STAGE = "pairwise"


def read(win):
    ends = win.ranges_in(STAGE, "kspider.recombine")
    stages = win.stages.get(STAGE, [])
    spans = [(max(e["ts"] + e["dur"] for e in r), s + d)
             for r, (s, d) in zip(ends, stages) if r]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1000.0
