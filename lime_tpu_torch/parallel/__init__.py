"""Multi-device SPMD execution on torch.distributed, one process per rank.

The reference scales with OpenMP byte-range chunking over shared files
(SURVEY.md §2 parallelism table); here, as in ``lime_tpu/parallel``, the
same decomposition becomes a 2D (sp, dp) mesh, of ranks:

- axis ``sp`` (position parallel): the eBWT position stream is
  range-sharded; the reference's boundary-straddle protocol
  (src/ClusterLCP.cpp:196-264) becomes a halo all-gather (banded engine)
  or copy-aligned chunks (pair engine);
- axis ``dp`` (read parallel): the similarity matrix is row-sharded by
  read; each rank keeps only its read rows, so the cross-rank reduction
  is an all-reduce over ``sp`` (after a reduce-scatter over ``dp`` in the
  banded engine), and classification runs on local rows.

``python -m lime_tpu_torch.cli run-sharded`` under ``torchrun`` runs it
from the command line; :mod:`.dryrun` checks both engines against each
other and the host reference inside every rank.
"""

from . import dryrun  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .multihost import (  # noqa: F401
    extend_range_to_cluster_boundaries,
    host_position_range,
    init_distributed,
    plan_host_range,
    plan_host_range_pairs,
)
from .sharded import (  # noqa: F401
    banded_fused_step,
    make_pair_sharded_pipeline,
    make_sharded_pipeline,
    pair_comm_model,
    pair_rows_local,
    run_sharded,
    run_sharded_pairs,
)
