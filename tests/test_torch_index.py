"""Index construction: the torch port vs lime_tpu.

The port's device builder (``build_index_torch``, here on the CPU)
against ``lime_tpu``'s JAX builder and its numpy builder; the port's
``build_index`` under every engine, its beyond-RAM external build, its
format helpers (``.gesa``, ``.docs``, FASTA/FASTQ filter) and its
``preprocess`` / ``gesa-convert`` / ``create-docs`` / ``filter-fasta``
subcommands against ``lime_tpu``'s on the same inputs.  Every
comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from lime_tpu import cli as jax_cli
from lime_tpu import preprocessing as jax_preprocessing
from lime_tpu.formats import arrays as jax_arrays
from lime_tpu.formats import gesa as jax_gesa
from lime_tpu.index import builder as jax_builder
from lime_tpu.index import external as jax_external
from lime_tpu.index.tpu_builder import build_index_tpu
from lime_tpu.utils.filter_fasta import filter_fasta_by_titles as jax_filter
from lime_tpu_torch import cli as torch_cli
from lime_tpu_torch import preprocessing
from lime_tpu_torch.formats import arrays, gesa
from lime_tpu_torch.formats.fasta import read_fasta, write_fasta
from lime_tpu_torch.index import build_index, builder, external
from lime_tpu_torch.index import torch_builder
from lime_tpu_torch.utils.filter_fasta import filter_fasta_by_titles

from .test_torch_selfcontained import ensure_reference_native
from .test_tpu_index_builder import CASES

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
torch.set_num_threads(1)

_EXTS = (".ebwt", ".lcp", ".da")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _random_set(seed=9, count=30):
    """``tests/test_tpu_index_builder.py``'s random set."""
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(20, 200))))
            for _ in range(count)]


def _reads_and_genomes(seed, num_reads, read_len, genome_lens):
    """Reads sampled from random genomes, then the genomes (as
    ``tests/test_external_build.py``'s generator)."""
    rng = np.random.default_rng(seed)
    genomes = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
               .tobytes() for n in genome_lens]
    reads = []
    for i in range(num_reads):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - read_len))
        reads.append(g[p:p + read_len])
    return reads + genomes


def _assert_same(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


DEVICE_CASES = CASES + [_random_set(), [], [b""], [b"", b"ACG", b""],
                        [b"A" * 5000, b"ACGT"]]


@pytest.mark.parametrize("seqs", DEVICE_CASES, ids=range(len(DEVICE_CASES)))
def test_device_builder_matches_jax_and_numpy(seqs):
    """On the CPU the torch builder writes lime_tpu's device builder's and
    its numpy builder's bytes: CASES and the random set of
    ``tests/test_tpu_index_builder.py``, no sequences, empty sequences,
    and a 5,000-base repeat that takes 13 doubling rounds."""
    got = torch_builder.build_index_torch(seqs, device="cpu")
    _assert_same(got, build_index_tpu(seqs))
    _assert_same(got, jax_builder.build_index(seqs))
    if seqs:
        assert torch_builder.LAST_RUN["positions"] == sum(
            len(s) + 1 for s in seqs)
    if seqs and len(seqs[0]) == 5000:
        assert torch_builder.LAST_RUN["rounds"] == 13


def test_device_builder_refuses_int32_overflow(monkeypatch):
    """Ranks are int32, as in lime_tpu: past that limit the builder
    raises instead of widening (the limit is lowered to 10 here)."""
    monkeypatch.setattr(torch_builder, "MAX_POSITIONS", 10)
    with pytest.raises(ValueError, match="int32 ranks"):
        torch_builder.build_index_torch([b"ACGT", b"ACGTA"], device="cpu")
    torch_builder.build_index_torch([b"ACGT", b"ACG"], device="cpu")


def test_device_engine_needs_the_card(monkeypatch):
    """``engine="tpu"`` defaults to the GPU; without a card it raises and
    builds nothing on the CPU or with the native library."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build_index([b"ACGT"], engine="tpu")
    with pytest.raises(RuntimeError, match="is_available"):
        torch_builder.build_index_torch([b"ACGT"])


@pytest.mark.parametrize("engine", ["numpy", "native", "tpu", "auto"])
def test_build_index_engines_match_jax(engine):
    """The port's build_index under each of lime_tpu's engine names
    (``tpu`` = the torch builder, here on the CPU) writes lime_tpu's
    bytes under the same name."""
    seqs = _random_set(seed=3, count=40) + [b"ACGNRYACG", b"NNNN", b"GATTACA"]
    got = build_index(seqs, engine=engine, device="cpu")
    _assert_same(got, jax_builder.build_index(seqs, engine=engine))
    _assert_same(got, jax_builder.build_index(seqs, engine="numpy"))


@pytest.mark.parametrize("max_lcp", [None, 8])
def test_build_index_files_match_jax(tmp_path, max_lcp):
    seqs = _reads_and_genomes(4, 200, 50, (3000, 2000))
    a, b = str(tmp_path / "torch.fasta"), str(tmp_path / "jax.fasta")
    assert builder.build_index_files(a, seqs, max_lcp=max_lcp) == \
        jax_builder.build_index_files(b, seqs, max_lcp=max_lcp)
    for ext in _EXTS:
        assert _read(a + ext) == _read(b + ext), ext


@pytest.mark.parametrize("max_lcp", [None, 20])
def test_external_build_matches_in_ram(tmp_path, max_lcp):
    """The blockwise build and on-disk merge under a budget of several
    blocks writes the in-RAM build's bytes, and lime_tpu's external
    build's, with the same merge pass count."""
    seqs = _reads_and_genomes(5, 3000, 90, (20000, 15000))
    budget = 8 << 20
    ends = external.plan_blocks([len(s) for s in seqs], budget)
    assert ends == jax_external.plan_blocks([len(s) for s in seqs], budget)
    assert len(ends) >= 2
    ram, ext_t, ext_j = (str(tmp_path / f"{n}.fasta")
                         for n in ("ram", "torch", "jax"))
    builder.build_index_files(ram, seqs, max_lcp=max_lcp)
    passes = external.build_index_files_external(
        ext_t, seqs, mem_budget=budget, max_lcp=max_lcp)
    assert passes > 1
    assert passes == jax_external.build_index_files_external(
        ext_j, seqs, mem_budget=budget, max_lcp=max_lcp)
    for ext in _EXTS:
        assert _read(ext_t + ext) == _read(ram + ext), ext
        assert _read(ext_t + ext) == _read(ext_j + ext), ext


def test_external_build_refuses_low_bytes(tmp_path):
    with pytest.raises(ValueError, match="0x24"):
        external.build_index_files_external(
            str(tmp_path / "x.fasta"), [b"ACGT", b"AC$T"])


@pytest.mark.parametrize("guard", ["native", "tpu", "kasai"])
def test_memory_guards_match_jax(guard):
    """The in-process builders' RAM guard (``tests/test_gesa.py``'s probe
    of lime_tpu's) and the Kasai floor of the external build."""
    if guard == "kasai":
        checks = (external._check_kasai_floor, jax_external._check_kasai_floor)
        args = ()
    else:
        checks = (builder._check_build_memory, jax_builder._check_build_memory)
        args = (guard,)
    for check in checks:
        with pytest.raises(MemoryError):
            check(1 << 44, *args)  # ~700 TB: always too big
        check(1 << 10, *args)  # tiny: always fine


def test_gesa_and_docs_match_jax(tmp_path):
    """convert_gesa splits the same 13-byte records into the same files
    (in chunks of 3 records here), and ``.docs`` reads both ways."""
    assert gesa.GESA_RECORD == jax_gesa.GESA_RECORD
    rng = np.random.default_rng(2)
    rec = np.zeros(10, gesa.GESA_RECORD)
    for field, hi in (("text", 50), ("suff", 1000), ("lcp", 300),
                      ("bwt", 256)):
        rec[field] = rng.integers(0, hi, 10)
    a, b = str(tmp_path / "torch.fasta"), str(tmp_path / "jax.fasta")
    for path in (a, b):
        rec.tofile(f"{path}.50.gesa")
    assert gesa.convert_gesa(a, 50, chunk_records=3) == \
        jax_gesa.convert_gesa(b, 50, chunk_records=3) == 10
    for ext in _EXTS:
        assert _read(a + ext) == _read(b + ext), ext
    arrays.write_docs(a, 12345)
    jax_arrays.write_docs(b, 12345)
    assert _read(a + ".docs") == _read(b + ".docs")
    assert arrays.read_docs(b) == jax_arrays.read_docs(a) == 12345


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_filter_fasta_matches_jax(tmp_path, fmt):
    names = ["a x", "b", "c desc", "d"]
    seqs = [b"ACGT", b"GGGG", b"TTTT", b"CA"]
    src = str(tmp_path / f"in.{fmt}")
    if fmt == "fasta":
        write_fasta(src, names, seqs, width=3)
    else:
        with open(src, "w") as f:
            for n, s in zip(names, seqs):
                f.write(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    titles = str(tmp_path / "titles.txt")
    with open(titles, "w") as f:
        f.write(">c\n\n@a extra\nzz\n")
    a, b = str(tmp_path / "torch.out"), str(tmp_path / "jax.out")
    assert filter_fasta_by_titles(titles, src, a) == \
        jax_filter(titles, src, b) == 2
    assert _read(a) == _read(b)
    assert read_fasta(a) == (["a x", "c desc"], [b"ACGT", b"TTTT"])


def _write_inputs(ds, root):
    """The dataset's reads and genomes as FASTA files: (reads1, reads2,
    genomes) paths."""
    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, f) for f in ("r1.fasta", "r2.fasta",
                                             "refs.fasta")]
    write_fasta(paths[0], [f"r{i}/1" for i in range(ds.num_reads)],
                ds.reads1)
    write_fasta(paths[1], [f"r{i}/2" for i in range(ds.num_reads)],
                ds.reads2)
    write_fasta(paths[2], [f"G{j:03d}" for j in range(ds.num_genomes)],
                ds.genomes)
    return paths


def _preprocess_both(main_args, tmp_path, capsys):
    """Run ``preprocess`` through both CLIs into their own directories;
    return (port collections, lime_tpu collections)."""
    out = {}
    for name, main in (("torch", torch_cli.main), ("jax", jax_cli.main)):
        out_dir = str(tmp_path / name)
        assert main(["preprocess", *main_args, "--out-dir", out_dir]) == 0
        out[name] = capsys.readouterr().out.split()
        assert all(os.path.dirname(p) == out_dir for p in out[name])
    assert ([os.path.basename(p) for p in out["torch"]]
            == [os.path.basename(p) for p in out["jax"]])
    for a, b in zip(out["torch"], out["jax"]):
        for ext in ("",) + _EXTS + (".docs",):
            assert _read(a + ext) == _read(b + ext), a + ext
    return out["torch"], out["jax"]


@pytest.mark.parametrize("mode", ["paired", "single", "trlcp"])
def test_cli_preprocess_matches_jax(dataset, tmp_path, capsys, mode):
    """Paired-end (1F/1RC/2F/2RC), single-end (F/RC) and ``--trlcp``:
    the same printed paths and byte-identical ``col_*.fasta``, ``.ebwt``,
    ``.lcp``, ``.da`` and ``.docs``; on the paired collections the port's
    ``run-paired --fused --device cpu`` writes lime_tpu's fused CSV."""
    r1, r2, g = _write_inputs(dataset, str(tmp_path / "in"))
    main_args = {"paired": [r1, g, "--reads2", r2], "single": [r1, g],
                 "trlcp": [r1, g, "--reads2", r2, "--trlcp", "20"]}[mode]
    cols, jax_cols = _preprocess_both(main_args, tmp_path, capsys)
    tags = ["F", "RC"] if mode == "single" else ["1F", "1RC", "2F", "2RC"]
    assert [os.path.basename(c) for c in cols] == [f"col_{t}.fasta"
                                                   for t in tags]
    assert arrays.read_docs(cols[0]) == dataset.num_reads + dataset.num_genomes
    if mode != "paired":
        return
    args = [str(dataset.num_reads), str(dataset.num_genomes),
            dataset.lineage_path, str(dataset.read_len), "--fused"]
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    assert torch_cli.main(["run-paired", *cols, a, *args, "--device",
                           "cpu"]) == 0
    assert jax_cli.main(["run-paired", *jax_cols, b, *args]) == 0
    assert _read(a) == _read(b)


@pytest.mark.parametrize("cmd", ["gesa-convert", "create-docs",
                                 "filter-fasta"])
def test_cli_host_commands_match_jax(tmp_path, capsys, cmd):
    """The same printed lines and files from both CLIs."""
    outs = {}
    for name, main in (("torch", torch_cli.main), ("jax", jax_cli.main)):
        root = tmp_path / name
        root.mkdir()
        fasta = str(root / "x.fasta")
        write_fasta(fasta, ["a", "b", "c"], [b"ACGT", b"GGGG", b"TTTT"])
        if cmd == "gesa-convert":
            rec = np.zeros(3, gesa.GESA_RECORD)
            rec["text"], rec["lcp"], rec["bwt"] = [0, 1, 2], [0, 4, 2], \
                [65, 36, 67]
            rec.tofile(fasta + ".3.gesa")
            argv = [cmd, fasta, "3"]
        elif cmd == "create-docs":
            argv = [cmd, fasta, "5"]
        else:
            titles = str(root / "t.txt")
            with open(titles, "w") as f:
                f.write("c\na\n")
            argv = [cmd, titles, fasta, str(root / "out.fasta")]
        assert main(argv) == 0
        outs[name] = (capsys.readouterr().out.replace(str(root), "ROOT"),
                      {f: _read(str(root / f))
                       for f in sorted(os.listdir(root))})
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"][1]) > 1


def test_preprocess_falls_back_to_external_build(dataset, tmp_path,
                                                 monkeypatch):
    """On MemoryError from the in-RAM guard, preprocess builds each
    collection blockwise under ``LIME_BUILD_MEM`` (here three blocks), as
    lime_tpu's does, and writes the in-RAM build's bytes."""
    r1, r2, g = _write_inputs(dataset, str(tmp_path / "in"))
    ram = preprocessing.preprocess(r1, r2, g, str(tmp_path / "ram"))

    def refuse(total_positions, engine):
        raise MemoryError("pretend the collection exceeds RAM")

    calls = []
    real = external.build_index_files_external

    def spy(*a, **kw):
        calls.append(kw["mem_budget"])
        return real(*a, **kw)

    budget = 2 << 20
    monkeypatch.setenv("LIME_BUILD_MEM", str(budget))
    monkeypatch.setattr(builder, "_check_build_memory", refuse)
    monkeypatch.setattr(jax_builder, "_check_build_memory", refuse)
    monkeypatch.setattr(external, "build_index_files_external", spy)
    lens = [len(s) for s in dataset.reads1 + dataset.genomes]
    assert len(external.plan_blocks(lens, budget)) >= 2
    with pytest.raises(MemoryError):
        builder.build_index_files(str(tmp_path / "x.fasta"), [b"ACGT"])
    cols = preprocessing.preprocess(r1, r2, g, str(tmp_path / "ext"))
    jax_cols = jax_preprocessing.preprocess(r1, r2, g, str(tmp_path / "jax"))
    assert calls == [budget] * 4
    for a, b, c in zip(cols, jax_cols, ram, strict=True):
        for ext in ("",) + _EXTS + (".docs",):
            assert _read(a + ext) == _read(c + ext), a + ext
            assert _read(a + ext) == _read(b + ext), a + ext
