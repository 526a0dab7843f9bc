"""The Gram kernel's share of its roofline in the ``cluster`` stage: the least
time its Gram work needs on this card (counted from the drawn index by
``roofline.py``, at the card's published int8 and memory peaks) over the
device time of the kernel events named below, per job."""

from gpubench import readers

LAYER = "Gram kernel"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "cluster_s"
STAGE = "cluster"
#: the kernel events of the Gram product's two forms
KERNELS = ("gram_int8_wgmma_kernel", "gram_bf16_wgmma_kernel")


def read(win):
    return readers.roofline_share(win, STAGE, KERNELS)
