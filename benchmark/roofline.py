"""The least device time a classification job needs, counted from its
inputs alone (no program counter enters it), and the card's peaks.

A job's device work, whatever kernel or route does it:

- the DA and eBWT bytes (4 + 1) of every index row inside a kept
  alpha-cluster, read once;
- the score planes, one byte per (read, padded genome) cell and file,
  written once;
- the same planes, read once by the classify cascade.

Genomes are padded to 128 lanes (at least one lane group), the plane
width the cascade reads.  The least time moves those bytes at the card's
published memory rate; the job does no work that the tensor cores would
bound sooner.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, HBM3 (NVIDIA's data sheet), at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12

#: bytes of index read per row of a kept cluster: u32 document id, u8 symbol
ROW_BYTES = 5


def g_pad(num_genomes: int) -> int:
    """Plane width: genomes rounded up to 128 lanes, 128 at least."""
    return max(128, -(-num_genomes // 128) * 128)


def job_bytes(cluster_rows: int, num_reads: int, num_genomes: int,
              files: int) -> int:
    """Device bytes one job must move: its kept clusters' rows read once,
    and ``files`` one-byte planes of ``num_reads x g_pad`` cells written
    once and read once."""
    return (ROW_BYTES * cluster_rows
            + 2 * files * num_reads * g_pad(num_genomes))


def least_seconds(nbytes: int) -> float:
    """Time to move ``nbytes`` at the published memory rate."""
    return nbytes / HBM_BYTES_PER_S
