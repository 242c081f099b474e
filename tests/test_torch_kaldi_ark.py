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


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("binary", [True, False])
def test_int_vectors_round_trip(tmp_path, direction, binary):
    """write_vec_int / read_vec_int / read_vec_int_ark across packages
    (binary entries, and a text vector for read_vec_int)."""
    writer, reader = DIRECTIONS[direction]
    rng = np.random.RandomState(4)
    vecs = {f"u{i}": rng.randint(-2**31, 2**31 - 1, size=3 + 5 * i,
                                 dtype=np.int64).astype(np.int32)
            for i in range(4)}
    ark = str(tmp_path / "i.ark")
    with open(ark, "wb") as f:
        for k, v in vecs.items():
            writer.write_vec_int(f, v, key=k)
    got = dict(reader.read_vec_int_ark(ark))
    assert list(got) == list(vecs)
    for k in vecs:
        np.testing.assert_array_equal(got[k], vecs[k])
    one = str(tmp_path / "one")
    if binary:
        writer.write_vec_int(one, vecs["u2"])
    else:
        (tmp_path / "one").write_text(
            "[ " + " ".join(str(x) for x in vecs["u2"]) + " ]\n")
    np.testing.assert_array_equal(reader.read_vec_int(one), vecs["u2"])
    np.testing.assert_array_equal(P.read_vec_int(one), J.read_vec_int(one))


def _post_ark(path, posts):
    """Kaldi Posterior binary entries, written by hand (no writer in
    either package)."""
    import struct
    with open(path, "wb") as f:
        for key, post in posts.items():
            f.write(key.encode() + b" \x00B")
            f.write(b"\x04" + struct.pack("<i", len(post)))
            for frame in post:
                f.write(b"\x04" + struct.pack("<i", len(frame)))
                for idx, w in frame:
                    f.write(b"\x04" + struct.pack("<i", idx) + b"\x04"
                            + struct.pack("<f", w))


def test_read_post_ark_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    posts = {f"utt{i}": [[(int(rng.randint(2048)),
                           float(np.float32(rng.rand())))
                          for _ in range(rng.randint(0, 4))]
                         for _ in range(rng.randint(1, 9))]
             for i in range(5)}
    ark = str(tmp_path / "post.ark")
    _post_ark(ark, posts)
    got = list(P.read_post_ark(ark))
    assert got == list(J.read_post_ark(ark))
    assert dict(got) == posts
    assert list(P.read_post_ark(f"cat {ark} |")) == got


@pytest.mark.parametrize("text", [
    "seg1 rec 0.00 1.25\nseg2 rec 2.005 3.5\n",
    "a rec 0.5 0.75\nbad line\nb rec 10.0 10.01\n",
    ""])
def test_read_segments_as_bool_vec_matches_jax(tmp_path, text):
    path = tmp_path / "segments"
    path.write_text(text)
    got = P.read_segments_as_bool_vec(str(path))
    want = J.read_segments_as_bool_vec(str(path))
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compress", [False, True])
def test_read_mat_ark_fast_matches_jax_reader(tmp_path, compress):
    """The fast reader (native route for files and pipes) against the JAX
    package's Python reader, FM and compressed entries."""
    mats = _mats()
    ark = str(tmp_path / "m.ark")
    with P.ArkWriter(ark, compress=compress) as w:
        for k, m in mats.items():
            w.write(k, m)
    for spec in (ark, f"ark:{ark}", f"cat {ark} |"):
        got = list(P.read_mat_ark_fast(spec))
        want = list(J.read_mat_ark(ark))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
