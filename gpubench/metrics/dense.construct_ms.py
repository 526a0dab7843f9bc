"""The dense engine's matrix construction per ``pairwise`` job: from the
start of its first ``kspider.pack`` range to the end of its last
``kspider.recombine`` range (host pack, Gram launches, limb recombine,
mirror and the matrix's copy to the host)."""

LAYER = "dense engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "pairwise_s"
STAGE = "pairwise"


def read(win):
    packs = win.ranges_in(STAGE, "kspider.pack")
    ends = win.ranges_in(STAGE, "kspider.recombine")
    spans = [(p[0]["ts"], max(e["ts"] + e["dur"] for e in r))
             for p, r in zip(packs, ends) if p and r]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1000.0
