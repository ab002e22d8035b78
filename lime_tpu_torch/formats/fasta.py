"""Minimal FASTA IO + reverse complement (copy of
``lime_tpu/formats/fasta.py``).

The reference delegates reverse-complementing to seqtk (Preprocessing.sh:55)
and FASTA parsing to the external index builders; lime-tpu vendors both so
the pipeline is self-contained.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

_RC_TABLE = bytes.maketrans(
    b"ACGTURYSWKMBDHVNacgturyswkmbdhvn",
    b"TGCAAYRSWMKVHDBNtgcaayrswmkvhdbn",
)


def reverse_complement(seq: bytes) -> bytes:
    """IUPAC-aware reverse complement (matches seqtk seq -r)."""
    return seq.translate(_RC_TABLE)[::-1]


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Iterate (title, sequence) records from FASTA or FASTQ.

    FASTQ (first byte '@', fixed 4-line records — the reference's
    dataset workflow feeds .fq files straight into preprocessing,
    Datasets/README.md) yields the same (title, sequence) pairs;
    quality lines are ignored.
    """
    with open(path, "rb") as f:
        first = f.read(1)
        f.seek(0)
        if first == b"@":  # FASTQ
            while True:
                head = f.readline()
                if not head:
                    break
                if not head.rstrip(b"\r\n"):
                    continue  # blank lines between records (trailing
                    # newlines from editors/concatenation) are not headers
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                if not plus.startswith(b"+"):
                    raise ValueError(
                        f"{path}: malformed FASTQ (expected '+' "
                        "separator; wrapped multi-line records are not "
                        "supported)")
                f.readline()  # quality
                yield head[1:].rstrip(b"\r\n").decode(), seq
            return
        name = None
        chunks: List[bytes] = []
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].decode()
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def read_fasta(path: str) -> Tuple[List[str], List[bytes]]:
    names, seqs = [], []
    for name, seq in iter_fasta(path):
        names.append(name)
        seqs.append(seq)
    return names, seqs


def write_fasta(path: str, names: Sequence[str], seqs: Sequence[bytes],
                width: int = 0) -> None:
    with open(path, "wb") as f:
        for name, seq in zip(names, seqs):
            f.write(b">" + name.encode() + b"\n")
            if width > 0:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + b"\n")
            else:
                f.write(seq + b"\n")


def reverse_complement_fasta(src: str, dst: str) -> int:
    """Write the reverse complement of every sequence (seqtk seq -r)."""
    n = 0
    with open(dst, "wb") as f:
        for name, seq in iter_fasta(src):
            f.write(b">" + name.encode() + b"\n")
            f.write(reverse_complement(seq) + b"\n")
            n += 1
    return n
