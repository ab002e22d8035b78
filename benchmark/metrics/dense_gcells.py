"""Fused pipeline: billions of read-lane x genome-column cells the dense
products compute per job (``counts["dense_cells"]``: every lane of a
computed dense chunk over the columns of its genome-column tiles, which
are the plane width up to G_pad 3,456 and the tiles' widths summed past
it), which the width sets; None where no job has the counter."""


def read(ctx):
    cells = ctx.phase_mean("fused", "counts", "dense_cells")
    return None if cells is None else cells / 1e9
