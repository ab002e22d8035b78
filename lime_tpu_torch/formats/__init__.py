"""Binary on-disk formats shared with the reference pipeline.

Copies of ``lime_tpu/formats/``'s readers and writers, re-exported under
the same names, so the port reads and writes the same files:

- index arrays ``.ebwt`` / ``.lcp`` / ``.da``  (:mod:`.arrays`)
- cluster list ``.<alpha>.clrs`` + aux ``.out``  (:mod:`.arrays`)
- score results ``.res.bin`` / ``.res.pos`` / ``.res.txt``  (:mod:`.res`)
- lineage CSV  (:mod:`.lineage`)
- FASTA  (:mod:`.fasta`)
- egsa ``.gesa`` interleaved records  (:mod:`.gesa`)
"""

from .arrays import (  # noqa: F401
    AuxMetadata,
    aux_path_for,
    clusters_path_for,
    read_aux,
    read_clusters,
    read_docs,
    open_da,
    open_ebwt,
    open_lcp,
    write_aux,
    write_clusters,
    write_docs,
    write_index_arrays,
)
from .lineage import Lineage, read_lineage  # noqa: F401
from .fasta import read_fasta, write_fasta, reverse_complement  # noqa: F401
from .res import (  # noqa: F401
    read_results_bin,
    read_results_txt,
    write_results_bin,
    write_results_txt,
)
from .gesa import convert_gesa  # noqa: F401
