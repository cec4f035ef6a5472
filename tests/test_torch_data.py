"""The port's data layer against the JAX package's: the same LETOR file gives
the same queries, and the same batches in the same order."""

import shutil

import numpy as np
import pytest
import torch

from ptranking_tpu.data import dataset as jds
from ptranking_tpu.data import letor as jletor
from ptranking_tpu_torch.data import dataset as tds
from ptranking_tpu_torch.data import letor as tletor

torch.set_num_threads(1)


def _assert_same_queries(a, b):
    assert [q[0] for q in a] == [q[0] for q in b]
    for (_, fa, la), (_, fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_synthetic_queries_and_writer_match():
    jq = jds.make_synthetic_queries(12, num_features=7, seed=5)
    tq = tds.make_synthetic_queries(12, num_features=7, seed=5)
    _assert_same_queries(jq, tq)


@pytest.mark.parametrize("data_id,with_comment", [
    ("MQ2008_Super", True),   # '#docid' comments, presort with shuffled ties
    ("MSLRWEB30K", False),    # query-level StandardScaler
    ("LETOR", False),         # generic id, no scaling
])
def test_letor_file_gives_same_queries_and_batches(tmp_path, data_id, with_comment):
    queries = jds.make_synthetic_queries(30, num_features=9, max_label=4,
                                         min_docs=3, max_docs=70, seed=2)
    jpath = jletor.write_letor_file(queries, str(tmp_path / "j" / "train.txt"),
                                    with_comment=with_comment)
    tpath = tletor.write_letor_file(queries, str(tmp_path / "t" / "train.txt"),
                                    with_comment=with_comment)
    with open(jpath) as fj, open(tpath) as ft:
        assert fj.read() == ft.read()

    kw = dict(min_docs=1, min_rele=1, seed=11)
    jq = jletor.load_letor_file(jpath, data_id=data_id, **kw)
    tq = tletor.load_letor_file(tpath, data_id=data_id, **kw)
    _assert_same_queries(jq, tq)
    # the second load reads the port's .npz cache
    _assert_same_queries(tq, tletor.load_letor_file(tpath, data_id=data_id, **kw))

    jd = jds.BucketedDataset(jq, batch_docs=96, num_features=9)
    td = tds.BucketedDataset(tq, batch_docs=96, num_features=9)
    assert jd.buckets == td.buckets and len(jd) == len(td)
    for shuffle, epoch in ((False, 0), (True, 3)):
        jb = list(jd.batches(shuffle=shuffle, epoch=epoch))
        tb = list(td.batches(shuffle=shuffle, epoch=epoch))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert ([jd.qid_for(a, r) for r in range(a.num_queries)]
                    == [td.qid_for(b, r) for r in range(b.num_queries)])


def test_jax_cache_file_reads_in_the_port(tmp_path):
    """Both packages name and pack the .npz parse cache alike, so a cache the
    JAX package wrote loads in the port unchanged."""
    queries = jds.make_synthetic_queries(6, num_features=5, seed=3)
    path = jletor.write_letor_file(queries, str(tmp_path / "a.txt"))
    jq = jletor.load_letor_file(path, data_id="MQ2008_Super", min_docs=1)
    shutil.copy(path, tmp_path / "b.txt")  # same settings, fresh parse in the port
    tq_fresh = tletor.load_letor_file(str(tmp_path / "b.txt"), data_id="MQ2008_Super", min_docs=1)
    tq_cached = tletor.load_letor_file(path, data_id="MQ2008_Super", min_docs=1)
    _assert_same_queries(jq, tq_fresh)
    _assert_same_queries(jq, tq_cached)
