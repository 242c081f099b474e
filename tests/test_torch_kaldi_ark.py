"""The port's own Kaldi ark/scp copy (xvector_tpu_torch.io.kaldi_ark)
against the JAX package's reader and writer: cross round trips must be
exact for FM/DM matrices and float vectors; compressed matrices written
by the JAX package decode identically in the port."""

import numpy as np
import pytest

from xvector_tpu.io import kaldi_ark as J
from xvector_tpu_torch.io import kaldi_ark as P

DIRECTIONS = {"port_to_jax": (P, J), "jax_to_port": (J, P)}


def _mats(dtype=np.float32):
    rng = np.random.RandomState(0)
    return {f"utt{i}": (rng.randn(5 + 7 * i, 23) * 4).astype(dtype)
            for i in range(4)}


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matrix_ark_round_trip(tmp_path, direction, dtype):
    writer, reader = DIRECTIONS[direction]
    mats = _mats(dtype)
    ark = str(tmp_path / "m.ark")
    with open(ark, "wb") as f:
        for k, m in mats.items():
            writer.write_mat(f, m, key=k)
    got = dict(reader.read_mat_ark(ark))
    assert list(got) == list(mats)
    for k in mats:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], mats[k].astype(np.float32))
    pipe = dict(reader.read_mat_ark(f"cat {ark} |"))
    np.testing.assert_array_equal(pipe["utt3"], got["utt3"])


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_vector_ark_round_trip(tmp_path, direction):
    writer, reader = DIRECTIONS[direction]
    rng = np.random.RandomState(1)
    vecs = {f"s{i}": rng.randn(512).astype(np.float32) for i in range(5)}
    ark = str(tmp_path / "v.ark")
    with open(ark, "wb") as f:
        for k, v in vecs.items():
            writer.write_vec_flt(f, v, key=k)
    got = dict(reader.read_vec_flt_ark(ark))
    assert list(got) == list(vecs)
    for k in vecs:
        np.testing.assert_array_equal(got[k], vecs[k])


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_ark_writer_scp_round_trip(tmp_path, direction):
    """ArkWriter's scp offsets point at each entry; vectors and a matrix
    in one ark, read back through scp files split by entry type."""
    writer, reader = DIRECTIONS[direction]
    rng = np.random.RandomState(2)
    entries = {"a": rng.randn(512).astype(np.float32),
               "b": rng.randn(9, 23).astype(np.float32),
               "c": rng.randn(512).astype(np.float32)}
    ark, scp = str(tmp_path / "x.ark"), str(tmp_path / "x.scp")
    with writer.ArkWriter(ark, scp) as w:
        for k, v in entries.items():
            w.write(k, v)
    lines = (tmp_path / "x.scp").read_text().splitlines()
    vec_scp, mat_scp = tmp_path / "vec.scp", tmp_path / "mat.scp"
    vec_scp.write_text("".join(f"{ln}\n" for ln in lines
                               if not ln.startswith("b ")))
    mat_scp.write_text("".join(f"{ln}\n" for ln in lines
                               if ln.startswith("b ")))
    vecs = dict(reader.read_vec_flt_scp(str(vec_scp)))
    mats = dict(reader.read_mat_scp(str(mat_scp)))
    assert set(vecs) == {"a", "c"} and set(mats) == {"b"}
    for k, v in {**vecs, **mats}.items():
        np.testing.assert_array_equal(v, entries[k])


@pytest.mark.parametrize("rows", [6, 200])
def test_compressed_matrix_from_jax_writer(tmp_path, rows):
    """rows ≤ 8 → CM2, more → CM (percentile format)."""
    rng = np.random.RandomState(rows)
    mat = (rng.randn(rows, 23) * 4 - 2).astype(np.float32)
    ark = str(tmp_path / "c.ark")
    with open(ark, "wb") as f:
        J.write_mat(f, mat, key="u", compress=True)
    (k, got), = list(P.read_mat_ark(ark))
    (_, want), = list(J.read_mat_ark(ark))
    assert k == "u"
    np.testing.assert_array_equal(got, want)
    span = float(mat.max() - mat.min())
    tol = span / 60.0 if rows > 8 else span / 30000.0   # JAX package's bound
    assert np.abs(got - mat).max() < tol
