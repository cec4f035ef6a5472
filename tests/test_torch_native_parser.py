"""The port's native LETOR parser (data/native_parser.py over
native/letor_parser.cpp, built by utils/native_build.py) and the dataset
statistics CLI (data/stats.py), against the port's Python parser and the JAX
package's."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from ptranking_tpu.data import stats as jax_stats
from ptranking_tpu.data.dataset import make_synthetic_queries as jax_synthetic
from ptranking_tpu.data.letor import load_letor_file as jax_load
from ptranking_tpu.data.letor import parse_letor_lines as jax_parse
from ptranking_tpu_torch.data import letor, native_parser, stats
from ptranking_tpu_torch.utils import native_build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rows of LETOR text: ids 1- or 0-indexed, '#' comments with and without the
# 'docid = X' form, missing (sparse) features, a wider last row
ONE_INDEXED = [
    "2 qid:10 1:0.5 2:-1.25 3:3e-2 # docid = GX001 inc = 1",
    "0 qid:10 1:1 3:4.5 #docid = GX002",
    "1 qid:7 2:0.125 5:-7 # onlyone",
    "0 qid:7 1:2.5",
    "3 qid:abc 1:1e3 2:2 3:3 4:4 5:5 6:6 # docid = Z",
]
ZERO_INDEXED = [line.replace(" 1:", " 0:").replace(" 2:", " 1:") for line in ONE_INDEXED]


def _write(tmp_path, lines, name="in.txt"):
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n", encoding="iso-8859-1")
    return str(p)


@pytest.mark.parametrize("lines,one_indexed", [(ONE_INDEXED, True), (ZERO_INDEXED, False)],
                         ids=["one_indexed", "zero_indexed"])
@pytest.mark.parametrize("has_comment", [True, False])
def test_native_parse_equals_python_and_jax(tmp_path, lines, one_indexed, has_comment):
    """The same arrays, qids and docids, bit for bit, as the port's and the
    JAX package's Python parsers (comments stripped when the file has none)."""
    if not has_comment:
        lines = [line.partition("#")[0].rstrip() for line in lines]
    path = _write(tmp_path, lines)
    got = native_parser.parse_letor_file_native(path, one_indexed=one_indexed,
                                                has_comment=has_comment)
    assert got is not None, "the native parser did not build or load"
    with open(path, encoding="iso-8859-1") as f:
        py = letor.parse_letor_lines(f, one_indexed=one_indexed, has_comment=has_comment)
    with open(path, encoding="iso-8859-1") as f:
        jx = jax_parse(f, one_indexed=one_indexed, has_comment=has_comment)
    assert len(got) == len(py) == len(jx) == (4 if has_comment else 3)
    for want in (py, jx):
        assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert list(got[2]) == list(want[2])
        if has_comment:
            assert list(got[3]) == list(want[3])


def test_native_parse_of_written_synthetic_file(tmp_path):
    """A file as write_letor_file writes it (136 features, %.6g values,
    '#docid' comments): the native parse equals the Python parse."""
    qs = jax_synthetic(num_queries=20, num_features=136, seed=5)
    path = letor.write_letor_file(qs, str(tmp_path / "syn.txt"))
    got = native_parser.parse_letor_file_native(path, has_comment=True)
    with open(path, encoding="iso-8859-1") as f:
        want = letor.parse_letor_lines(f, has_comment=True)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_native_parser_rejects_a_malformed_file(tmp_path):
    assert native_parser.parse_letor_file_native(_write(tmp_path, ["1 noqid 1:2"])) is None
    assert native_parser.parse_letor_file_native(str(tmp_path / "absent.txt")) is None


def test_build_lands_in_build_native():
    """The port builds its library under build/native/ at the repository
    root, never into native/build/ (the JAX package's)."""
    assert native_parser.native_parser_available()
    assert native_parser.LIB_PATH == os.path.join(REPO, "build", "native",
                                                  "libletor_parser.so")
    assert os.path.isfile(native_parser.LIB_PATH)
    assert native_build.NATIVE_BUILD_DIR != os.path.join(REPO, "native", "build")


def test_build_native_is_atomic_and_cached(tmp_path):
    """A build compiles once and reuses the artifact while the source is
    older; a missing source gives None."""
    src = tmp_path / "hello.cpp"
    src.write_text('int main() { return 0; }\n')
    out = str(tmp_path / "out" / "hello")
    assert native_build.build_native(str(src), out) == out
    first = os.path.getmtime(out)
    assert native_build.build_native(str(src), out) == out
    assert os.path.getmtime(out) == first
    assert not [p for p in os.listdir(tmp_path / "out") if ".tmp." in p]
    assert native_build.build_native(str(tmp_path / "missing.cpp"), out) is None


@pytest.mark.parametrize("data_id", ["MQ2008_Super", "MSLRWEB30K"])
def test_load_letor_file_parses_natively(tmp_path, monkeypatch, data_id):
    """load_letor_file goes through the native parser (the Python parser is
    not called) and gives the JAX package's queries."""
    qs = jax_synthetic(num_queries=12, num_features=46 if data_id.startswith("MQ") else 136,
                       seed=2)
    path = letor.write_letor_file(qs, str(tmp_path / "f.txt"))
    want = jax_load(path, data_id=data_id, presort=False)
    for f in tmp_path.glob("*.npz"):
        f.unlink()  # the JAX load's cache would be read instead of the file

    def refuse(*a, **k):
        raise AssertionError("the Python parser ran")

    monkeypatch.setattr(letor, "parse_letor_lines", refuse)
    got = letor.load_letor_file(path, data_id=data_id, presort=False)
    assert [q[0] for q in got] == [q[0] for q in want]
    for (_, fa, la), (_, fb, lb) in zip(got, want):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_load_letor_file_falls_back_to_python(tmp_path, monkeypatch):
    """Without the native library the Python parser gives the same queries."""
    qs = jax_synthetic(num_queries=8, num_features=46, seed=3)
    path = letor.write_letor_file(qs, str(tmp_path / "f.txt"))
    native = letor.load_letor_file(path, data_id="MQ2008_Super", presort=False)
    for f in tmp_path.glob("*.npz"):
        f.unlink()
    monkeypatch.setattr(letor, "parse_letor_file_native", lambda *a, **k: None)
    python = letor.load_letor_file(path, data_id="MQ2008_Super", presort=False)
    for (qa, fa, la), (qb, fb, lb) in zip(native, python):
        assert qa == qb
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_dataset_statistics_match_jax():
    qs = jax_synthetic(num_queries=30, num_features=46, seed=9)
    assert stats.dataset_statistics(qs) == jax_stats.dataset_statistics(qs)
    assert stats.dataset_statistics([]) == jax_stats.dataset_statistics([]) == {"num_queries": 0}


def _printed(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().replace("ptranking_tpu_torch", "ptranking_tpu")


@pytest.mark.parametrize("source", ["file", "synthetic"])
def test_stats_cli_output_matches_jax(tmp_path, source):
    """`python -m ptranking_tpu_torch.data.stats` prints what the JAX
    package's CLI prints, for a LETOR file and for synthetic data."""
    if source == "file":
        qs = jax_synthetic(num_queries=15, num_features=136, seed=11)
        path = letor.write_letor_file(qs, str(tmp_path / "train.txt"))
        argv = ["-data", "MSLRWEB30K", "-file", path]
    else:
        argv = ["-data", "SyntheticMQ"]
    want = _printed(jax_stats.main, argv)
    for f in tmp_path.glob("*.npz"):
        f.unlink()
    assert _printed(stats.main, argv) == want
    assert "num_docs" in want and "label_distribution" in want
