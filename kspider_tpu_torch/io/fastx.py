"""Streaming FASTA/FASTQ reader (gzip-aware).

Replaces the reference's kmerDecoder/kseq chunked parser
(kSpider/src/fastx_to_kf.cpp:24-45).  Yields (name, sequence)
records; ``chunks`` groups records into batches whose total sequence length
approximates the reference's chunk_size-records batching.  A native C++
fast path (native/) is used automatically for large files when built.
"""

import gzip
from typing import Iterator, List, Tuple


def _open_maybe_gzip(path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_records(path) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) from FASTA or FASTQ (auto-detected)."""
    f = _open_maybe_gzip(path)
    try:
        first = f.read(1)
        if not first:
            return
        if first == ">":  # FASTA
            header = f.readline().strip()
            name = header.split()[0] if header else ""
            seq_parts: List[str] = []
            for line in f:
                if line.startswith(">"):
                    yield name, "".join(seq_parts)
                    header = line[1:].strip()
                    name = header.split()[0] if header else ""
                    seq_parts = []
                else:
                    seq_parts.append(line.strip())
            yield name, "".join(seq_parts)
        elif first == "@":  # FASTQ — kseq-compatible: multi-line seq/qual
            # (the reference parses via kmerDecoder/kseq, which accepts
            # sequence and quality wrapped over multiple lines; quality
            # ends when its length reaches the sequence length)
            header = f.readline().strip()  # rest of the first header line
            while True:
                name = header.split()[0] if header else ""
                seq_parts: List[str] = []
                line = f.readline()
                while line and not line.startswith("+"):
                    seq_parts.append(line.strip())
                    line = f.readline()
                seq = "".join(seq_parts)
                if not line:  # EOF before the '+' separator
                    if seq:
                        raise ValueError(
                            f"truncated FASTQ record {name!r} (no '+' line)"
                        )
                    break
                qlen = 0
                while qlen < len(seq):
                    qline = f.readline()
                    if not qline:
                        raise ValueError(
                            f"truncated FASTQ quality for record {name!r}"
                        )
                    qlen += len(qline.strip())
                if qlen > len(seq):
                    raise ValueError(f"malformed FASTQ near record {name!r}")
                yield name, seq
                line = f.readline()
                while line and not line.strip():  # tolerate blank lines
                    line = f.readline()
                if not line:
                    break
                if not line.startswith("@"):
                    raise ValueError(f"malformed FASTQ near record {name!r}")
                header = line[1:].strip()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
    finally:
        f.close()


def read_chunks(path, chunk_records: int = 3000) -> Iterator[List[Tuple[str, str]]]:
    """Batch records like the reference's chunked decoding."""
    batch: List[Tuple[str, str]] = []
    for rec in read_records(path):
        batch.append(rec)
        if len(batch) >= chunk_records:
            yield batch
            batch = []
    if batch:
        yield batch
