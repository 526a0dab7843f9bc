"""The two cells' configurations draw, and their reference works out, the
same bytes as before ``species_sizes`` existed: SHA-256 of each array,
recorded with the generator and the reference of commit 8f7844b."""

import hashlib
import json
import os

import numpy as np
import pytest

from conftest import ROOT
from gpubench import datagen, reference, run

DIGESTS = {
    ("gtdb-derep-8k", 2147483651): {
        "offsets": "360b873b45a1224401cb7258621f49932e224b2b82a032dfaa8c9374f5c0f837",
        "members": "c2a947864d7891a040a63298c8948b6f12a74130fc5009dab559926814000880",
        "counts": "527ba0b9ec93a06483f5d292fca8b503472ec04a1b53445479ab034324a66e46",
        "kmer_counts": "93ebdc1c14e3a3b7bdf9fcf27c0211d42cf9d59049bf560242f659bf0eaadde5",
        "pairs.i": "29c40f7277739c72fc405e3e26d9b28d4c58ecd52dfbb6699493ef8d2b26adb2",
        "pairs.j": "163c20699ee551213ed0aac261e58a910d25929ab248b4fdf0db88688557c1b9",
        "pairs.shared": "016c283184f3a6cedcc8ec57ed21ca9801a2218a0975c754756def7b0e90fe0c",
    },
    ("gtdb-derep-8k", -5): {
        "offsets": "ee1334344afe67b98af21552ce785277d5af2ef5b1ad9e32d552e53099d36c8d",
        "members": "91cf0ec8609645abd08f9fb7e1be3c33ec524d4aea80ab64dda76d92b521f162",
        "counts": "fcdfa900b3ab637bda542cca30cc4b70d37c18828eea307f03e1af4f513b3d53",
        "kmer_counts": "b2cd8371900b71ff1cfa6e687eff311b50e15a974561c31ed590ecde2b150878",
        "pairs.i": "efc784dd3896a50d35fabfe324a0d34e64db2a820c42b40bdef91d0c23ae4c2e",
        "pairs.j": "6cff39c50747e1d565662e39285954ff6f850431fb74cb41329603c7be43e1d5",
        "pairs.shared": "2853732508ed93346f27454d11eb204d626acfb226690afb7e7dd44ab54238e7",
    },
    ("gtdb-derep-32k", 2147483651): {
        "offsets": "8a3e1182aaa0955b10239138afdf5f0fbd53f99b203bb3a10935f32d95bc4036",
        "members": "c835ce8b83943366600a4194d256ef9528dc1b3c2f6673e9442bba87341600e4",
        "counts": "26192a56cb3df60606b8a7fa7dee0127a75c98b1e36049808a7c221ea8b003d9",
        "kmer_counts": "1513095c60a20618d6404f24351189da011f9ad6cc7a34de60ccff3240a1cc35",
        "pairs.i": "2584fcad4dd0f9e78c803ce2262174bab7e077136ac7721746d034c699fa52cc",
        "pairs.j": "bcb9bb679a9afc3f37fcd8d8b5fd1b1f35e1b1dd140ac29dd6de63eecbfeba88",
        "pairs.shared": "ff08baa37edefc2b6233d658ee6f999f5ab8f79f34fb6a3803707896fc1b471b",
    },
    ("gtdb-derep-32k", -5): {
        "offsets": "e24bcdee75dee706e9aed0260c425799700dee0499b141095a193fe65abcc628",
        "members": "9c7d6c07e8b0b2b9c11bd60f2bb7724e1901f5d9aa32867fe3a4ae9f8c6317a7",
        "counts": "71f4102699bca45715943eccf78beffa5a812f5593ffbdd722f79180a5152aee",
        "kmer_counts": "365d2fda091a3cfc044fc831fb56aa08766c5e8ab321542f96b0d129bda4e9da",
        "pairs.i": "c2a79da280ad087ef967046d1ac9a0d8edd21edf83a7f7468a8a65527358299f",
        "pairs.j": "e103730f12669eac4722453fce7c5a0d93efefeb0b7bce1bcbebb88932dc5a37",
        "pairs.shared": "e6365c329d0f41e4a4bcc5cb978cf11f4dc72ca0d81f060ff458952be53b2cf4",
    },
}


def sha256(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_cells_draw_and_reference_the_same_bytes(name, seed):
    with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as f:
        config = json.load(f)
    col = datagen.generate(config, run.seed_rng_key(seed))
    # no group: every color takes the pair-by-pair path, as before
    label = reference.groups(col.offsets, col.members, col.n)
    assert (label == np.arange(col.n)).all()
    p = reference.pairs(col.offsets, col.members, col.counts, col.n)
    got = {field: sha256(getattr(col, field))
           for field in ("offsets", "members", "counts", "kmer_counts")}
    got.update({"pairs." + field: sha256(getattr(p, field))
                for field in ("i", "j", "shared")})
    assert got == DIGESTS[(name, seed)]
