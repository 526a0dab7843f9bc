"""Exact shared-k-mer matrix S = A^T diag(w) A.

Counterpart of ``kspider_tpu/ops/pairwise.py``.  ``A`` is the
(colors x samples) 0/1 membership matrix and ``w_c`` the number of k-mers of
color ``c``.  The product runs as int8 tensor-core products with int32
accumulation: weights are split into base-128 limbs so every scaled entry
fits int8, and limb sums are recombined in int64.

Exactness: one limb term adds at most 127 per color, so fewer than
``2**31 / 127`` colors per accumulation keep int32 exact; callers split
larger inputs into super-blocks.  The scatter engine of the JAX module is
not ported yet.
"""

import numpy as np

# int32 accumulator safety bound: 127 * MAX_COLORS_PER_CALL < 2**31
_MAX_COLORS_PER_CALL = (2**31 - 1) // 127


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def weight_limbs(weights: np.ndarray) -> np.ndarray:
    """Decompose int64 weights into base-128 int8 limbs, shape (C, L)."""
    w = np.asarray(weights, dtype=np.int64)
    if w.size == 0:
        return np.zeros((0, 1), dtype=np.int8)
    max_w = int(w.max(initial=0))
    n_limbs = 1
    while max_w >= 128**n_limbs:
        n_limbs += 1
    limbs = np.empty((len(w), n_limbs), dtype=np.int8)
    rem = w.copy()
    for l in range(n_limbs):
        limbs[:, l] = (rem % 128).astype(np.int8)
        rem //= 128
    return limbs


def shared_kmer_matrix(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    device,
    block: int = 1024,
    drop_singletons: bool = True,
) -> np.ndarray:
    """Exact shared-k-mer matrix S (int64, NxN, symmetric, zero diagonal).

    Input is the color-class CSR of :class:`kspider_tpu.core.index.ColorIndex`:
    ``members[offsets[c]:offsets[c+1]]`` lists the 0-based sample ids of
    color ``c`` and ``weights[c]`` its k-mer count.  The Gram product runs
    on ``device``: the hand-written kernel on a CUDA device, its plain
    torch version on the CPU."""
    from kspider_tpu_torch.ops.cuda_pairwise import shared_kmer_matrix_cuda

    return shared_kmer_matrix_cuda(
        offsets, members, weights, n, device=device, block=block,
        drop_singletons=drop_singletons,
    )


def shared_kmer_matrix_numpy(
    offsets: np.ndarray, members: np.ndarray, weights: np.ndarray, n: int
) -> np.ndarray:
    """Pure-numpy reference implementation (exact, for tests and ``--cpu``)."""
    s = np.zeros((n, n), dtype=np.int64)
    offsets = np.asarray(offsets)
    for c in range(len(offsets) - 1):
        ms = members[offsets[c] : offsets[c + 1]]
        if len(ms) < 2:
            continue
        w = int(weights[c])
        s[np.ix_(ms, ms)] += w
    np.fill_diagonal(s, 0)
    return s
