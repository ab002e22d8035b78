"""Order-preserving FASTA/FASTQ filter by a list of sequence titles (copy of
``lime_tpu/utils/filter_fasta.py``).

Equivalent of the reference's Datasets/filter_by_headers.pl:34-55: keep the
records whose title appears in the given list, preserving input order.
"""

from __future__ import annotations


def _load_titles(path: str) -> set:
    titles = set()
    with open(path) as f:
        for line in f:
            t = line.strip()
            if t:
                titles.add(t.lstrip("@>").split()[0])
    return titles


def filter_fasta_by_titles(titles_path: str, src: str, dst: str) -> int:
    """Filter FASTA or FASTQ ``src`` into ``dst``; returns records kept."""
    titles = _load_titles(titles_path)
    kept = 0
    with open(src) as f, open(dst, "w") as out:
        first = f.read(1)
        f.seek(0)
        if first == ">":  # FASTA
            keep = False
            for line in f:
                if line.startswith(">"):
                    keep = line[1:].split()[0].strip() in titles
                    kept += keep
                if keep:
                    out.write(line)
        else:  # FASTQ: fixed 4-line records
            while True:
                rec = [f.readline() for _ in range(4)]
                if not rec[0]:
                    break
                if rec[0][1:].split()[0].strip() in titles:
                    out.writelines(rec)
                    kept += 1
    return kept
