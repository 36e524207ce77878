"""The port's host engine (ganmf_tpu_torch/ops/host.py, the C++ source copied
from the JAX package) against ganmf_tpu.ops.host, on the CPU: the library
builds with g++ into build/ganmf_tpu_torch/ (never beside its source), each
function gives the JAX package's result for the same input and seed (the
same source: bitwise), the numpy paths do where the library is missing, and
the reader's native parse equals its Python path."""

import numpy as np
import pytest

from ganmf_tpu.data.reader import read_interactions as jax_read_interactions
from ganmf_tpu.ops import host as jhost
from ganmf_tpu_torch.data import reader as preader
from ganmf_tpu_torch.ops import host
from tests.conftest import random_urm


@pytest.fixture(scope="module")
def urm():
    return random_urm(50, 70, density=0.25, seed=4)


def test_library_builds_into_the_build_directory():
    lib = host.get_lib()
    assert lib is not None, host.build_error
    assert lib.cf_host_version() == jhost.get_lib().cf_host_version() == 2
    path = host.library_path()
    assert path.exists() and path.parent == host.BUILD_DIR and path.parent.name == "ganmf_tpu_torch"
    assert not list(host.SRC.parent.glob("*.so"))
    assert host.SRC.read_bytes() == open(jhost._SRC, "rb").read()  # a verbatim copy


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_each_function_equals_jax(urm, native, monkeypatch):
    if not native:
        monkeypatch.setattr(host, "get_lib", lambda: None)
        monkeypatch.setattr(jhost, "get_lib", lambda: None)
    rows = np.array([0, 3, 3, 49, 17])
    np.testing.assert_array_equal(host.csr_gather_dense(urm, rows), jhost.csr_gather_dense(urm, rows))
    np.testing.assert_array_equal(host.csr_gather_dense(urm, rows), urm[rows].toarray())
    got, want = host.get_non_interactions(urm), jhost.get_non_interactions(urm)
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
    for seed in (9, 10):
        np.testing.assert_array_equal(host.sample_negative_mask(urm, 0.3, seed),
                                      jhost.sample_negative_mask(urm, 0.3, seed))
    cdf = np.cumsum(np.random.RandomState(0).dirichlet(np.ones(12), size=5), axis=1).astype(np.float32)
    draw_rows = np.random.RandomState(1).randint(0, 5, 300).astype(np.int32)
    np.testing.assert_array_equal(host.random_choice_cdf(cdf, draw_rows, 3), jhost.random_choice_cdf(cdf, draw_rows, 3))
    for a, b in zip(host.shuffled_interactions(urm, 5), jhost.shuffled_interactions(urm, 5)):
        np.testing.assert_array_equal(a, b)
    mask = host.sample_negative_mask(urm, 0.3, 9)
    n_zeros = urm.shape[1] - np.ediff1d(urm.indptr)
    np.testing.assert_array_equal(mask.sum(1), (n_zeros * 0.3).astype(int))
    assert not (mask.astype(bool) & (urm.toarray() > 0)).any()


def _ratings_file(tmp_path, delim, header, seed=42):
    rng = np.random.RandomState(seed)
    lines = [delim.join(["userId", "movieId", "rating", "timestamp"])] if header else []
    for _ in range(500):
        u, i = rng.randint(1, 900), rng.randint(1, 400)
        lines.append(delim.join([str(u), str(i), str(rng.choice([0.5, 1.0, 2.5, 4.5, 5.0])),
                                 str(rng.randint(1e9))]))
    lines.insert(5, "")  # an empty line mid-file
    lines.append("   ")  # a whitespace-only line
    path = tmp_path / f"ratings_{len(delim)}.dat"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("delim,header", [(",", True), ("::", False), ("\t", False)])
def test_native_parse_equals_the_python_path_and_jax(tmp_path, delim, header):
    path = _ratings_file(tmp_path, delim, header)
    got = host.parse_interactions_file(path, delimiter=delim, header=header)
    assert got is not None
    for g, p, j in zip(got, preader.parse_interactions_python(path, delimiter=delim, header=header),
                       jhost.parse_interactions_file(path, delimiter=delim, header=header)):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)
    for keep in ("first", "last"):
        for g, j in zip(preader.read_interactions(path, delimiter=delim, header=header, duplicate=keep),
                        jax_read_interactions(path, delimiter=delim, header=header, duplicate=keep)):
            np.testing.assert_array_equal(g, j)
    # no trailing newline and no rating column
    path2 = tmp_path / "pairs.csv"
    path2.write_bytes(b"3,7\n9,2,\n5,5")
    cols = {"user_id": 0, "item_id": 1}
    for g, p in zip(host.parse_interactions_file(str(path2), use_cols=cols),
                    preader.parse_interactions_python(str(path2), use_cols=cols)):
        np.testing.assert_array_equal(g, p)


def test_reader_takes_the_python_path_without_the_library(tmp_path, monkeypatch):
    path = _ratings_file(tmp_path, ",", False, seed=3)
    want = preader.read_interactions(path)
    monkeypatch.setattr(host, "get_lib", lambda: None)
    assert host.parse_interactions_file(path) is None
    for g, w in zip(preader.read_interactions(path), want):
        np.testing.assert_array_equal(g, w)
