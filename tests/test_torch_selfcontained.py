"""The port stands alone: it imports nothing of jax, ``lime_tpu`` or the
tests, and its copies of ``lime_tpu``'s host modules hold the same
bytes, fields and constants as their originals.

Also here, for every torch test file: :func:`ensure_reference_native`,
the guard that loads ``lime_tpu``'s own native library safely when many
test processes start at once, :func:`jax_config`, which builds the
JAX package's config from the port's, and :func:`run_ranks`, which runs
``tests/_torch_dist_worker.py`` in one process per rank.  The file imports no jax at module
level, so the CUDA tests (run without the suite's conftest) import it.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import lime_tpu_torch
from lime_tpu_torch import native

from .synth import make_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lime_tpu_torch")


def ensure_reference_native():
    """Load ``lime_tpu.native``, building it if needed; raise if it cannot.

    ``lime_tpu.native._load`` compiles straight onto the library's final
    path without a lock and, if ``ctypes.CDLL`` then fails (say on a file
    another process is still writing), marks the library failed for the
    rest of the process.  This builds it with the port's
    :func:`native.locked_build` (an ``fcntl`` lock, a pid-suffixed temp
    file renamed onto the library, a stamp of the finished file), clears
    the failure and loads it again; a load that still fails rebuilds.
    """
    from lime_tpu import native as ref

    for attempt in range(3):
        if ref._lib is not None:
            return ref._lib
        native.locked_build(ref._SRC, ref._LIB, rebuild=attempt > 0)
        ref._failed = False
        ref._load()
    raise RuntimeError(f"native library {ref._LIB} cannot be loaded")


def jax_config(cfg):
    """``lime_tpu``'s LimeConfig with the fields of the port's ``cfg``."""
    from lime_tpu.config import LimeConfig as JaxConfig

    return JaxConfig(**dataclasses.asdict(cfg))


# build and load lime_tpu's native library before any test, whatever the
# other test processes do
ensure_reference_native()


def run_ranks(root, spec: dict, world: int, timeout: float = 300) -> list:
    """Run ``spec`` (see ``tests/_torch_dist_worker.py``) in ``world``
    gloo ranks, one process each, under ``root``; every rank is killed
    after ``timeout`` seconds.  Returns each rank's ``out.<rank>.json``."""
    import json

    from lime_tpu_torch.parallel.dryrun import spawn_ranks

    os.makedirs(root, exist_ok=True)
    path = os.path.join(str(root), "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    spawn_ranks([sys.executable, "-m", "tests._torch_dist_worker", path],
                world, timeout, env=env, cwd=ROOT)
    out = []
    for r in range(world):
        with open(os.path.join(str(root), f"out.{r}.json")) as f:
            out.append(json.load(f))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _port_sources():
    for d, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_nothing_of_jax_lime_tpu_or_tests():
    bad = []
    sources = list(_port_sources())
    scanned = {os.path.relpath(p, PORT) for p in sources}
    assert {"preprocessing.py", "index/builder.py", "index/external.py",
            "index/torch_builder.py", "formats/fasta.py", "formats/gesa.py",
            "utils/filter_fasta.py", "parallel/mesh.py",
            "parallel/multihost.py", "parallel/sharded.py",
            "parallel/dryrun.py", "synth.py", "utils/memory.py"} <= scanned
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("jax", "lime_tpu", "tests")]
    assert not bad


def test_package_reexports_match():
    """``formats`` re-exports ``lime_tpu.formats``' names, and ``ops``
    ``lime_tpu.ops``' four (``find_clusters``, ``normalize_scores``,
    ``score_clusters``, ``classify_reads``), from the port's own
    modules."""
    import lime_tpu.formats as jformats
    import lime_tpu.ops as jops
    import lime_tpu_torch.formats as formats
    from lime_tpu_torch import ops
    from lime_tpu_torch.ops import classify_ops, cluster_scan, scoring

    public = {n for n in dir(jformats) if not n.startswith("_")
              and not isinstance(getattr(jformats, n), type(jformats))}
    assert public <= set(dir(formats))
    for n in public:
        assert getattr(formats, n).__module__.startswith("lime_tpu_torch.")
    assert ops.find_clusters is cluster_scan.find_clusters
    assert ops.normalize_scores is scoring.normalize_scores
    assert ops.score_clusters is scoring.score_clusters
    assert ops.classify_reads is classify_ops.classify_reads
    functions = {n for n in dir(jops) if not n.startswith("_")
                 and callable(getattr(jops, n))}
    assert functions == set(ops.__all__)
    with pytest.raises(AttributeError):
        ops.iupac_waterfall


def test_native_source_is_byte_identical():
    assert _read(os.path.join(PORT, "native", "csrc", "lime_native.cpp")) \
        == _read(os.path.join(ROOT, "lime_tpu", "native", "csrc",
                              "lime_native.cpp"))


@pytest.mark.parametrize("module,name", [
    ("ops.cluster_scan", "find_clusters"),
    ("ops.cluster_scan", "cluster_metadata"),
    ("ops.scoring", "_expand_positions"),
    ("ops.scoring", "_segment_stats"),
    ("ops.scoring", "_pair_indices"),
    ("ops.scoring", "iupac_waterfall"),
    ("ops.scoring", "normalize_scores"),
    ("ops.fused_pipeline", "_plan_python"),
])
def test_numpy_fallbacks_are_verbatim_copies(module, name):
    """The port's copies of ``lime_tpu``'s numpy fallbacks hold their
    originals' source, byte for byte (``score_clusters``, whose pairs
    score in groups on a thread pool, is held by its outputs in
    ``test_torch_no_native.py``)."""
    import importlib
    import inspect

    got = importlib.import_module(f"lime_tpu_torch.{module}")
    want = importlib.import_module(f"lime_tpu.{module}")
    assert inspect.getsource(getattr(got, name)) == \
        inspect.getsource(getattr(want, name))


def test_native_builds_into_its_own_path():
    assert native._LIB == os.path.join(ROOT, "build", "lime_tpu_torch",
                                       "native", "liblime_native.so")
    native._load()
    assert os.path.exists(native._LIB + ".ok")


def test_failed_native_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.locked_build(str(src), str(tmp_path / "lib" / "libx.so"))
    assert not os.path.exists(tmp_path / "lib" / "libx.so")


def test_config_fields_and_defaults_match():
    from lime_tpu.config import LimeConfig as JaxConfig

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(lime_tpu_torch.LimeConfig) == spec(JaxConfig)
    assert (dataclasses.asdict(lime_tpu_torch.DEFAULT_CONFIG)
            == dataclasses.asdict(JaxConfig()))
    cfg = lime_tpu_torch.LimeConfig(wide_sim=True, alpha=20)
    assert dataclasses.asdict(jax_config(cfg)) == dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        lime_tpu_torch.LimeConfig(executor="gpu")


def test_constants_match():
    from lime_tpu import constants as want
    from lime_tpu_torch import constants as got

    names = [n for n in vars(want) if n.isupper()]
    assert names == [n for n in vars(got) if n.isupper()]
    for n in names:
        a, b = getattr(got, n), getattr(want, n)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        else:
            assert a == b, n


def test_synth_big_matches_the_tests_copy(tmp_path):
    from lime_tpu_torch import synth_big as port

    from . import synth_big as orig

    kw = dict(num_pairs=150, num_genomes=5, genome_len=1500, seed=4)
    a = port.make_big_dataset(str(tmp_path / "port"), **kw)
    b = orig.make_big_dataset(str(tmp_path / "tests"), **kw)
    files = sorted(os.listdir(b.root))
    assert files == sorted(os.listdir(a.root))
    assert any(f.endswith(".ebwt") for f in files)
    for f in files:
        assert _read(os.path.join(a.root, f)) == \
            _read(os.path.join(b.root, f)), f
    paths = ("root", "collections", "lineage_path")
    assert ({k: v for k, v in dataclasses.asdict(a).items()
             if k not in paths}
            == {k: v for k, v in dataclasses.asdict(b).items()
                if k not in paths})


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("small")),
                        num_pairs=160, genome_lens=(3000, 2500, 2000),
                        seed=13)


_EXTS = (".16.clrs", ".out", ".res.bin", ".res.pos", ".res.txt")


def _artifacts(cols):
    """Every stage checkpoint next to ``cols``, read and then removed."""
    out = {}
    for c in cols:
        for ext in _EXTS:
            if os.path.exists(c + ext):
                out[os.path.basename(c) + ext] = _read(c + ext)
                os.remove(c + ext)
    return out


@pytest.mark.parametrize("kw,env", [
    (dict(fused=True), {}), (dict(), {}), (dict(executor="host"), {}),
    (dict(fused=True), {"LIME_HBM_BUDGET": "1",
                        "LIME_STREAM_BUDGET": "4096"}),
    (dict(fused=True, host_frac=1.0), {}),
], ids=["fused", "staged", "host", "blocked", "all_host"])
def test_port_runs_without_jax_and_lime_tpu(small, tmp_path, monkeypatch,
                                            kw, env):
    """In a process where ``jax`` and ``lime_tpu`` cannot be imported,
    the port's run_paired writes the CSV and checkpoint bytes that
    lime_tpu's run writes (``blocked``: the row-blocked mode in owner
    passes, in both; ``all_host``: the job shop's host workers)."""
    from lime_tpu.pipeline import run_paired as jax_run_paired

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cols = small.collections
    args = (small.num_reads, small.num_genomes, small.lineage_path,
            small.read_len)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    _artifacts(cols)
    jax_run_paired(cols, b, *args,
                   jax_config(lime_tpu_torch.LimeConfig(**kw)))
    want = _artifacts(cols)
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["lime_tpu"] = None
import torch
torch.set_num_threads(1)
from lime_tpu_torch import LimeConfig, run_paired
from lime_tpu_torch.ops.fused_pipeline import LAST_RUN
run_paired({cols!r}, {a!r}, *{args!r}, LimeConfig(**{kw!r}), device="cpu")
print("ran", LAST_RUN.get("engine"), LAST_RUN.get("n_pass"))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0 and "ran" in out.stdout, out.stderr[-3000:]
    if env:
        engine, n_pass = out.stdout.split()[-2:]
        assert engine == "blocked" and int(n_pass) >= 2
    assert _read(a) == _read(b)
    assert _artifacts(cols) == want
    assert bool(want) != bool(kw.get("fused"))


def test_port_builds_index_without_jax_and_lime_tpu(small, tmp_path,
                                                    capsys):
    """In a process where ``jax`` and ``lime_tpu`` cannot be imported,
    the port's ``preprocess`` and its device builder (on the CPU) write
    the bytes of lime_tpu's ``preprocess``."""
    from lime_tpu.cli import main as jax_main
    from lime_tpu_torch.formats.fasta import write_fasta

    files = [str(tmp_path / f) for f in ("r1.fasta", "r2.fasta", "g.fasta")]
    write_fasta(files[0], [f"r{i}" for i in range(small.num_reads)],
                small.reads1)
    write_fasta(files[1], [f"r{i}" for i in range(small.num_reads)],
                small.reads2)
    write_fasta(files[2], [f"G{j}" for j in range(small.num_genomes)],
                small.genomes)
    args = [files[0], files[2], "--reads2", files[1], "--out-dir"]
    assert jax_main(["preprocess", *args, str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out.split()
    out_dir, device_col = str(tmp_path / "torch"), str(tmp_path / "dev.fasta")
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["lime_tpu"] = None
from lime_tpu_torch.cli import main
from lime_tpu_torch.formats.arrays import write_index_arrays
from lime_tpu_torch.formats.fasta import read_fasta
from lime_tpu_torch.index import build_index
assert main(["preprocess", *{args!r}, {out_dir!r}]) == 0
seqs = read_fasta({out_dir!r} + "/col_1F.fasta")[1]
write_index_arrays({device_col!r},
                   *build_index(seqs, engine="tpu", device="cpu"))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    got = out.stdout.split()
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and len(got) == 4
    for a, b in zip(got, want):
        for ext in ("", ".ebwt", ".lcp", ".da", ".docs"):
            assert _read(a + ext) == _read(b + ext), a + ext
    for ext in (".ebwt", ".lcp", ".da"):
        assert _read(device_col + ext) == _read(want[0] + ext), ext
