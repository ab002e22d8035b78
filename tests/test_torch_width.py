"""The port at the reference's widest database: 3,423 genomes.

The SRR1804065 sample's database has 3,423 accessions, the widest the
reference publishes.  Past 1,024 genome lanes the port meets paths no
narrower check reaches: g_pad 3,456, the u16 per-copy genome column of
the packed pair streams and the 12-bit columns of coo24 chains (the
host planes' uplink under 4,096 genomes).  tests/test_srr_width.py holds
lime_tpu there against the reference binaries; this file holds the port
against lime_tpu's fused run and its host executor, byte for byte, with
no binaries needed.
"""

import numpy as np
import pytest
import torch

from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu_torch import LimeConfig, host, run_paired
from lime_tpu_torch.ops import fused_pipeline as tfp

from .synth import make_dataset
from .test_torch_selfcontained import ensure_reference_native, jax_config

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

SRR_GENOMES = 3423
FUSED = LimeConfig(fused=True)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def srr_width(tmp_path_factory):
    """tests/test_srr_width.py's dataset, draw for draw, and its host
    executor's CSV."""
    root = str(tmp_path_factory.mktemp("srr_width"))
    rng = np.random.default_rng(99)
    lens = [int(v) for v in rng.integers(180, 260, SRR_GENOMES)]
    ds = make_dataset(root, num_pairs=1500, read_len=60, genome_lens=lens,
                      seed=99, mutation_rate=0.01, negative_fraction=0.1,
                      degenerate_rate=0.001, insert_len=150)
    host_csv = f"{root}/host.csv"
    jax_run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len,
                   jax_config(LimeConfig(executor="host")))
    return ds, _read(host_csv)


@pytest.mark.parametrize("frac,budget,plane", [
    (0.0, None, False),   # pair streams (u16 genome columns) + rescue
    (0.5, None, False),   # hybrid, the host share as sparse COO
    (0.5, None, True),    # hybrid through a host plane: a coo24 chain
    (1.0, None, False),   # all-host job shop: chains as corrections
    (0.5, "1", False),    # row-blocked hybrid: coo24 per block
], ids=["device", "hybrid", "hybrid-plane", "all-host", "blocked-hybrid"])
def test_width_matches_jax_and_host(srr_width, tmp_path, monkeypatch, frac,
                                    budget, plane):
    ds, want = srr_width
    assert ds.num_genomes == SRR_GENOMES
    if budget is not None:
        monkeypatch.setenv("LIME_HBM_BUDGET", budget)
    if plane:
        # every host-scored set takes the host plane, in both packages
        monkeypatch.setattr(host, "_COO_POSITION_CAP", 1)
        monkeypatch.setattr(jfp, "_COO_POSITION_CAP", 1)
    cfg = FUSED.replace(host_frac=frac)
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    run_paired(ds.collections, a, *args, cfg, device="cpu")
    stats = dict(tfp.LAST_RUN)
    jax_run_paired(ds.collections, b, *args, jax_config(cfg))
    assert _read(a) == _read(b) == want
    assert stats["host_num"] == round(frac * 256)
    assert (sum(stats["chunks_per_bucket"]) > 0) == (frac < 1.0)
    # coo24 uploads, 3 B an entry; a small all-host run (at most 2^25
    # cells) sends its chains through the classify program instead
    assert (stats["chain_bytes"] > 0) == (plane or budget is not None)
    assert stats["chain_bytes"] % 3 == 0
    assert (stats["engine"] == "all_host") == (frac == 1.0)
