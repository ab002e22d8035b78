"""The port's one-byte-per-row pair path, dense scoring entry point and
native bindings against the JAX package, on the same numpy inputs.

``pair_score_into`` (the stream of ``native.plan_pairs``, reordered and
re-encoded for the pair-hit kernel, whose plain version runs here) is
held against ``lime_tpu``'s XLA band path on ``tests/test_pair_score.py``'s
cases and on a stream cut into several chunks; ``dense_score_into`` on
``tests/test_dense_score.py``'s; ``plan_pairs``, ``plan_score_coo`` and
``pair_hits_host`` against their originals.  Every check is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu import native as jnative
from lime_tpu.config import LimeConfig
from lime_tpu.ops import dense_score as jds
from lime_tpu.ops import pair_score as jps
from lime_tpu.ops.fused_pass import _DEGENERATE_BYTE
from lime_tpu_torch import native
from lime_tpu_torch.constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
from lime_tpu_torch.ops import dense_score as tds
from lime_tpu_torch.ops import pair_kernels as pk
from lime_tpu_torch.ops import pair_score as tps

from .test_torch_selfcontained import ensure_reference_native

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
torch.set_num_threads(1)

from .test_dense_score import _clusters, _random_stream  # noqa: E402
from .test_pair_score import _exact_matrix, _random_index  # noqa: E402

DEG8 = _DEGENERATE_BYTE.astype(np.uint8)
HOST = LimeConfig(executor="host")


def _g_pad(num_genomes):
    return max(128, -(-num_genomes // 128) * 128)


def _plan(lcp, da, ebwt, num_reads, g_pad, dense_min=16):
    return native.plan_pairs(lcp, da, ebwt, num_reads, 16, g_pad,
                             SYMBOL_RANK_LUT, DEG8, dense_min=dense_min)


def _planes(lcp, da, ebwt, num_reads, num_genomes, dense_min=16,
            wide=False):
    """(port plane, lime_tpu plane) of the pair path alone, first
    ``num_reads`` rows as their unsigned values, and the port's plan."""
    g_pad = _g_pad(num_genomes)
    plan = _plan(lcp, da, ebwt, num_reads, g_pad, dense_min)
    dt = (torch.int32, jnp.int32) if wide else (torch.int8, jnp.int8)
    sim = torch.zeros((num_reads + 1, g_pad), dtype=dt[0])
    tps.pair_score_into(sim, plan[0], num_reads, g_pad)
    want = jps.pair_score_into(jnp.zeros((num_reads + 1, g_pad), dt[1]),
                               plan[0], num_reads, g_pad)
    view = np.uint32 if wide else np.uint8
    return (sim.numpy()[:num_reads].view(view),
            np.asarray(want)[:num_reads].view(view), plan)


def _full_matrix(plane, plan, da, ebwt, num_reads, num_genomes):
    """The pair plane plus the exact native scorer on the dense and
    rescue lists: the whole (R, G) u8 matrix."""
    got = plane[:, :num_genomes].copy()
    for s, n in ((plan[1], plan[2]), (plan[3], plan[4])):
        if len(s):
            got += native.score_clusters_native(
                s, n, da, ebwt, num_reads, num_genomes, SYMBOL_RANK_LUT,
                DEG8, IUPAC_WATERFALL_PAIRS, threads=1)
    return got


def _case(kind):
    """tests/test_pair_score.py's inputs: (lcp, da, ebwt, R, G, config,
    dense_min)."""
    if kind == "wrap":
        reps = 300
        lcp = np.zeros(4 * reps, np.uint32)
        da = np.zeros(4 * reps, np.uint32)
        ebwt = np.full(4 * reps, ord("A"), np.uint8)
        for i in range(reps):
            lcp[4 * i + 1] = 20
            da[4 * i + 1] = 1
        return lcp, da, ebwt, 1, 1, HOST, 16
    if kind in ("ebwt", "no_ebwt"):
        rng = np.random.default_rng(11)
        lcp, da, ebwt = _random_index(rng, 30000, 200, 50, 16)
        return (lcp, da, ebwt, 200, 50,
                HOST.replace(use_ebwt=kind == "ebwt"), 16)
    if kind == "degenerate_dense":
        rng = np.random.default_rng(23)
        lcp, da, ebwt = _random_index(rng, 40000, 150, 40, 16,
                                      deg_frac=0.01)
        return lcp, da, ebwt, 150, 40, HOST, 4
    rng = np.random.default_rng(31)
    lcp, da, ebwt = _random_index(rng, 20000, 100, 20, 16,
                                  symbols=b"ACGT$\x00")
    return lcp, da, ebwt, 100, 20, HOST, 16


@pytest.mark.parametrize("kind", ["ebwt", "no_ebwt", "degenerate_dense",
                                  "terminators", "wrap"])
def test_pair_score_into_matches_lime_tpu(kind):
    lcp, da, ebwt, R, G, config, dense_min = _case(kind)
    eb = ebwt if config.use_ebwt else None
    got, want, plan = _planes(lcp, da, eb, R, G, dense_min)
    assert plan[0]
    assert np.array_equal(got, want)
    exact = _exact_matrix(lcp, da, ebwt, R, G, config)
    assert np.array_equal(_full_matrix(got, plan, da, eb, R, G), exact)
    chunks = tps.LAST_RUN["chunks"]
    assert sum(chunks.values()) == len(plan[0])
    assert (tps.LAST_RUN["host_copies"] > 0) == (kind == "terminators")
    if kind == "wrap":
        assert exact[0, 0] == 300 % 256
    if kind == "degenerate_dense":
        assert len(plan[3]) and len(plan[1])


def test_pair_score_into_wide_counters():
    lcp, da, ebwt, R, G, _, _ = _case("ebwt")
    got, want, _ = _planes(lcp, da, ebwt, R, G, wide=True)
    assert got.any() and np.array_equal(got, want)


def test_pair_score_into_many_chunks(monkeypatch):
    """Both packages' chunk sizes patched small: every bucket is cut at
    copy boundaries into several chunks, the same cuts in both."""
    for mod in (jps, tps):
        monkeypatch.setattr(mod, "PAIR_CHUNK_SMALL", pk.PAIR_TILE)
        monkeypatch.setattr(mod, "PAIR_CHUNK", 2 * pk.PAIR_TILE)
    rng = np.random.default_rng(5)
    lcp, da, ebwt = _random_index(rng, 150000, 300, 60, 16,
                                  symbols=b"ACGT\x00")
    got, want, plan = _planes(lcp, da, ebwt, 300, 60)
    assert np.array_equal(got, want)
    n_chunks = sum(tps.LAST_RUN["chunks"].values())
    assert n_chunks > len(plan[0]) + 2
    assert tps.LAST_RUN["host_copies"] > 0
    assert tps.LAST_RUN["rows"] == sum(
        len(c[0]) for c in tps.unpacked_chunks(plan[0], 300, 128))


def _genome_not_last(packed):
    """Copies whose genome run is not their last run."""
    copy = np.cumsum((packed & 0x40) == 0)
    gs = (packed & 0x10) != 0
    last = np.flatnonzero(np.append(copy[1:] != copy[:-1], True))
    return int(np.sum(~gs[last]))


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_reorder_and_reencode_match_band_core(use_ebwt):
    """Each chunk reordered (genome run last) and re-encoded, through the
    plain version of the kernel, equals ``lime_tpu``'s ``_pair_hits_core``
    on the original stream, read row by read row."""
    rng = np.random.default_rng(17)
    lcp, da, ebwt = _random_index(rng, 30000, 200, 50, 16)
    buckets = _plan(lcp, da, ebwt if use_ebwt else None, 200, 128)[0]
    moved = 0
    for chunk_p, _, window, cap, host, _ in tps.unpacked_chunks(
            buckets, 200, 128):
        assert host is None
        moved += _genome_not_last(chunk_p)
        codes, perm = tps.kernel_codes(torch.from_numpy(chunk_p))
        sorted_hits = pk.pair_hits_plain(codes, window, cap).numpy()
        got = np.empty_like(sorted_hits)
        got[perm.numpy()] = sorted_hits
        want = np.asarray(jps.pair_hits(jnp.asarray(chunk_p),
                                        jnp.int32(window)))
        read = (chunk_p & 0x10) == 0
        assert np.array_equal(got[read], want[read])
        # every copy now ends in its one genome run
        c = codes.numpy()
        ends = np.flatnonzero(np.append((c[1:] & 4) == 0, True))
        assert np.all(c[ends] & 0x10)
    assert moved > 0


def test_pair_hits_host_matches_original():
    lcp, da, ebwt, R, G, _, _ = _case("terminators")
    for packed, _, _ in _plan(lcp, da, ebwt, R, _g_pad(G))[0]:
        assert np.array_equal(tps.pair_hits_host(packed),
                              jps.pair_hits_host(packed))
    assert len(tps.pair_hits_host(np.zeros(0, np.uint8))) == 0


@pytest.mark.parametrize("kind,use_ebwt", [("ebwt", True),
                                           ("ebwt", False),
                                           ("degenerate_dense", True),
                                           ("terminators", True)])
def test_plan_pairs_matches_lime_tpu(kind, use_ebwt):
    lcp, da, ebwt, R, G, _, dense_min = _case(kind)
    eb = ebwt if use_ebwt else None
    args = (lcp, da, eb, R, 16, _g_pad(G), SYMBOL_RANK_LUT, DEG8)
    got = native.plan_pairs(*args, dense_min=dense_min)
    want = jnative.plan_pairs(*args, dense_min=dense_min)
    assert len(got[0]) == len(want[0])
    for (gp, gf, gw), (wp, wf, ww) in zip(got[0], want[0]):
        assert gw == ww
        assert np.array_equal(gp, wp) and np.array_equal(gf, wf)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


def test_plan_pairs_refuses_int32_overflow():
    lcp, da, ebwt, *_ = _case("ebwt")
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="int32 scatter range"):
            mod.plan_pairs(lcp, da, ebwt, 1 << 20, 16, 4096,
                           SYMBOL_RANK_LUT, DEG8)


@pytest.mark.parametrize("threads,use_ebwt", [(1, True), (3, True),
                                              (2, False)])
def test_plan_score_coo_matches_lime_tpu(threads, use_ebwt):
    rng = np.random.default_rng(7)
    for _ in range(3):
        n = int(rng.integers(300, 5000))
        R, G = int(rng.integers(3, 60)), int(rng.integers(2, 40))
        lcp = rng.integers(0, 8, n).astype(np.uint32)
        da = rng.integers(0, R + G, n).astype(np.uint32)
        ebwt = rng.choice(np.frombuffer(b"ACGTNRYKM", np.uint8), n)
        eb = ebwt.astype(np.uint8) if use_ebwt else None
        args = (lcp, da, eb, R, G, 4, SYMBOL_RANK_LUT, DEG8,
                IUPAC_WATERFALL_PAIRS)
        got = native.plan_score_coo(*args, threads=threads)
        want = jnative.plan_score_coo(*args, threads=threads)
        assert got[1:] == want[1:]
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            assert got[0][0] == want[0][0]
            for a, b in zip(got[0][1:], want[0][1:]):
                assert np.array_equal(a, b)


def test_plan_score_coo_refuses_oversized_cluster():
    n = 70000
    lcp = np.full(n, 9, np.uint32)
    lcp[0] = 0
    da = np.zeros(n, np.uint32)
    da[1::2] = 1
    ebwt = np.full(n, ord("A"), np.uint8)
    with pytest.raises(RuntimeError, match="-2"):
        native.plan_score_coo(lcp, da, ebwt, 1, 1, 4, SYMBOL_RANK_LUT,
                              DEG8, IUPAC_WATERFALL_PAIRS)


def _dense_case(kind):
    """tests/test_dense_score.py's inputs: (starts, lens, da, ebwt, R,
    G)."""
    if kind in ("ebwt", "no_ebwt"):
        rng = np.random.default_rng(5)
        da, ebwt = _random_stream(rng, 20000, 300, 40)
        starts, lens = _clusters(rng, 20000, 120, 400)
        return (starts, lens, da, ebwt if kind == "ebwt" else None, 300,
                40)
    if kind == "invalid":
        R, K = 4, jds.K
        da = np.array([0] * (K + 2) + [R, R + 1], np.uint32)
        ebwt = np.frombuffer(b"A" * (K + 2) + b"CA", np.uint8).copy()
        return (np.array([0], np.int64), np.array([len(da)], np.int64), da,
                ebwt, R, 3)
    rng = np.random.default_rng(11)
    genomes = rng.integers(64, 80, 40).astype(np.uint32)
    da = np.concatenate([np.arange(64, dtype=np.uint32), genomes])
    rng.shuffle(da)
    ebwt = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, len(da))
                                            ].copy()
    return (np.array([0], np.int64), np.array([len(da)], np.int64), da,
            ebwt, 64, 16)


@pytest.mark.parametrize("kind", ["ebwt", "no_ebwt", "invalid",
                                  "multi_entry"])
def test_dense_score_into_matches_lime_tpu(kind):
    starts, lens, da, ebwt, R, G = _dense_case(kind)
    rows = R + 9 if kind in ("ebwt", "no_ebwt") else R + 1
    sim = torch.zeros((rows, 128), dtype=torch.int32)
    out, left_s, left_l = tds.dense_score_into(sim, starts, lens, da, ebwt,
                                               R, G, 128)
    want, want_s, want_l = jds.dense_score_into(
        jnp.zeros((rows, 128), jnp.int32), starts, lens, da, ebwt, R, G,
        128)
    assert out is sim
    assert np.array_equal(sim.numpy()[:R], np.asarray(want)[:R])
    assert np.array_equal(left_s, want_s) and np.array_equal(left_l, want_l)
    if kind == "invalid":
        assert list(left_s) == [0] and not sim.numpy().any()
    else:
        assert sim.numpy()[:R].any()


def test_pair_score_into_rejects_a_plane_without_drop_row():
    lcp, da, ebwt, R, G, _, _ = _case("ebwt")
    buckets = _plan(lcp, da, ebwt, R, 128)[0]
    for shape in ((R, 128), (R + 1, 256)):
        with pytest.raises(ValueError):
            tps.pair_score_into(torch.zeros(shape, dtype=torch.int8),
                                buckets, R, 128)
