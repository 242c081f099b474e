"""The port's libxta (xvector_tpu_torch.runtime.native, csrc/xta_io.cc)
and the plan functions of data/archives.py.

The native reads must give the same bits as the port's Python readers and
the JAX package's Python readers (the referee is the JAX *Python* path,
never its own libxta build).  These tests do not skip when the library is
missing: a compiler is present wherever the suite runs, so a failed build
fails them.  Archives: the port writes XTA files byte-identical to the JAX
package's from the same plan and ``fetch``, natively or not, and the
streaming route yields the materialised sequence.  Builds are atomic: six
processes loading a fresh build directory at once all succeed."""

import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import shorten_ref as enc  # noqa: E402

from xvector_tpu.data import allocator as JA  # noqa: E402
from xvector_tpu.data import archives as JAR  # noqa: E402
from xvector_tpu.io import kaldi_ark as J  # noqa: E402
from xvector_tpu.io import shorten as JS  # noqa: E402
from xvector_tpu_torch.data import allocator as PA  # noqa: E402
from xvector_tpu_torch.data import archives as PAR  # noqa: E402
from xvector_tpu_torch.io import kaldi_ark as P  # noqa: E402
from xvector_tpu_torch.io import shorten as PS  # noqa: E402
from xvector_tpu_torch.io import wav as PW  # noqa: E402
from xvector_tpu_torch.runtime import native  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _offsets(scp):
    out = {}
    for line in open(scp):
        key, loc = line.split()
        path, off = loc.rsplit(":", 1)
        out[key] = (path, int(off))
    return out


def _cm3_entry(mat):
    """A hand-made CM3 (flat uint8) payload: neither writer emits one."""
    gmin, grange = float(mat.min()), float(mat.max() - mat.min())
    codes = np.rint((mat - gmin) / grange * 255).astype(np.uint8)
    return (b"CM3" + struct.pack("<ffii", gmin, grange, *mat.shape)
            + codes.tobytes())


@pytest.fixture(scope="module")
def ark(tmp_path_factory):
    """One ark of every matrix format: FM, DM, CM (> 8 rows), CM2 (<= 8
    rows), CM3; returns (ark, {key: offset})."""
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    path = str(tmp / "all.ark")
    with open(path, "wb") as f:
        for i in range(3):
            P.write_mat(f, (rng.randn(10 + 7 * i, 23) * 4).astype(np.float32),
                        key=f"fm{i}")
        P.write_mat(f, rng.randn(9, 5) * 3, key="dm")
        for i, rows in enumerate((40, 6, 123)):
            P.write_mat(f, (rng.randn(rows, 23) * 5 - 1).astype(np.float32),
                        key=f"cm{i}", compress=True)
        f.write(b"cm3 \x00B" + _cm3_entry(rng.randn(17, 4) * 2))
    data = open(path, "rb").read()
    offs = {}
    for key in ("fm0", "fm1", "fm2", "dm", "cm0", "cm1", "cm2", "cm3"):
        offs[key] = data.index(key.encode() + b" \x00B") + len(key) + 1
    return path, offs


KEYS = ("fm0", "fm1", "fm2", "dm", "cm0", "cm1", "cm2", "cm3")


def test_library_is_built_here():
    """A compiler is present here and on the card's machine: the library
    must build and load, into the port's own _build directory."""
    assert native.available() and native.threads() >= 1
    lib = native.lib_path(native._compiler())
    assert lib.exists() and "_build" in lib.parts
    assert native.get_lib().xta_version() == 3


@pytest.mark.parametrize("key", KEYS)
def test_read_mat_bits_equal_python(ark, key):
    path, offs = ark
    got = native.read_mat(path, offs[key])
    port = P.read_mat(f"{path}:{offs[key]}")
    jax_py = J.read_mat(f"{path}:{offs[key]}")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, jax_py)
    assert native.mat_shape(path, offs[key]) == got.shape


def test_ark_stream_bits_equal_python(ark):
    path, _ = ark
    got = list(native.ArkStream(path))
    want = list(P.read_mat_ark(path))
    jax_py = list(J.read_mat_ark(path))
    assert [k for k, _ in got] == [k for k, _ in want] == list(KEYS)
    for (_, a), (_, b), (_, c) in zip(got, want, jax_py):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("spec", ["{p}", "ark:{p}", "cat {p} |",
                                  "ark:cat {p} |"])
def test_read_mat_ark_fast_routes(ark, spec):
    """Plain files and pipes go native, both equal the Python reader."""
    path, _ = ark
    got = list(P.read_mat_ark_fast(spec.format(p=path)))
    want = list(J.read_mat_ark(path))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ark_stream_malformed_and_corrupt(tmp_path):
    bad = tmp_path / "bad.ark"
    bad.write_bytes(b"key notbinary")
    with pytest.raises(IOError):
        list(native.ArkStream(str(bad)))
    huge = tmp_path / "huge.ark"
    huge.write_bytes(b"u \x00BFM \x04" + struct.pack("<i", 1 << 30)
                     + b"\x04" + struct.pack("<i", 1 << 30))
    for call in (lambda: native.read_mat(str(huge), 2),
                 lambda: native.mat_shape(str(huge), 2),
                 lambda: list(native.ArkStream(str(huge)))):
        with pytest.raises(IOError):
            call()


def _vector_ark(tmp_path, n=300, dim=16, dtype=np.float32):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "v.ark")
    with open(path, "wb") as f:
        for i in range(n):
            P.write_vec_flt(f, (rng.randn(dim) * 3).astype(dtype),
                            key=f"spk{i % 7}-utt\x1d{i}")
    return path


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("route", ["path", "pipe"])
def test_read_vec_matrix_bits_equal_python(tmp_path, dtype, route):
    path = _vector_ark(tmp_path, dtype=dtype)
    spec = path if route == "path" else f"cat {path} |"
    keys, mat = P.read_vec_flt_matrix(spec, dim_hint=16)
    want = list(J.read_vec_flt_ark(path))
    assert keys == [k for k, _ in want]        # \x1d inside keys survives
    np.testing.assert_array_equal(mat, np.stack([v for _, v in want]))
    # a small batch_rows forces several native batches
    k2, m2 = native.read_vec_matrix(path, dim_hint=16, batch_rows=64)
    assert k2 == keys
    np.testing.assert_array_equal(m2, mat)
    fast = list(P.read_vec_flt_ark_fast(spec))
    assert [k for k, _ in fast] == keys
    np.testing.assert_array_equal(np.stack([v for _, v in fast]), mat)


def test_read_vec_matrix_empty(tmp_path):
    empty = tmp_path / "e.ark"
    empty.write_bytes(b"")
    keys, mat = P.read_vec_flt_matrix(str(empty), dim_hint=7)
    assert keys == [] and mat.shape == (0, 7)


def _f16_edges():
    rng = np.random.RandomState(4)
    k = np.arange(1, 1500, dtype=np.float64)
    ties = ((k + 0.5) * 2.0 ** -24).astype(np.float32)   # subnormal ties
    normal_ties = ((2048 + np.arange(0, 400) * 2 + 1)
                   * 2.0 ** -11).astype(np.float32)      # x.5 ulp at 1..2
    special = np.array([65504, 65519, 65520, 65535, 65536, 1e6, 2 ** -25,
                        2 ** -24, 3 * 2 ** -25, 2 ** -14, 1e-8, 0.0, -0.0,
                        np.inf, -np.inf], np.float32)
    vals = np.concatenate([rng.randn(4000) * 10, rng.randn(2000) * 1e-5,
                           ties, -ties, normal_ties, -normal_ties,
                           special, -special]).astype(np.float32)
    return vals


def test_materialize_chunks_float16_rounding(tmp_path):
    """libxta's float16 cast gives numpy's bits: round to nearest even,
    subnormal ties and overflow included."""
    vals = _f16_edges()
    cols = 5
    vals = vals[: len(vals) // cols * cols].reshape(-1, cols)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    with P.ArkWriter(ark, scp) as w:
        w.write("x", vals)
    path, off = _offsets(scp)["x"]
    n = vals.shape[0]
    sources = [(path, off, 0, n), (path, off, 7, n - 20), (path, off, 3, 1)]
    with np.errstate(over="ignore"):
        want = np.zeros((3, n, cols), np.float16)
        want[0] = vals.astype(np.float16)
        want[1, : n - 20] = vals[7: n - 13].astype(np.float16)
        want[2, :1] = vals[3:4].astype(np.float16)
    got = native.materialize_chunks(sources, n, cols)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("bad", ["past_rows", "longer_than_pad",
                                 "wrong_dim"])
def test_materialize_chunks_rejects_bad_ranges(tmp_path, bad):
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    with P.ArkWriter(ark, scp) as w:
        w.write("u0", np.ones((10, 4), np.float32))
    path, off = _offsets(scp)["u0"]
    src, pad, dim = {"past_rows": ((path, off, 5, 20), 32, 4),
                     "longer_than_pad": ((path, off, 0, 10), 8, 4),
                     "wrong_dim": ((path, off, 0, 4), 8, 5)}[bad]
    with pytest.raises((IOError, ValueError)):
        native.materialize_chunks([src], pad, dim)


def _shorten_cases():
    rng = np.random.default_rng(6)
    x = np.clip(np.cumsum(rng.integers(-300, 300, size=(5000, 2)), axis=0),
                -32768, 32767).astype(np.int64)
    u = rng.integers(0, 256, size=(500, 2)).astype(np.int64)
    return {
        "diff_nmean4": enc.encode(x, blocksize=256, nmean=4),
        "diff_nmean0": enc.encode(x, blocksize=256, nmean=0),
        "qlpc": enc.encode(x, blocksize=128, nmean=4,
                           qlpc_coeffs=[40, -20, 8]),
        "mono_tail": enc.encode(x[:777, :1], blocksize=256, nmean=4),
        "ulaw": enc.encode(u, ftype=enc.TYPE_ULAW, blocksize=64, nmean=4),
        "zeros_verbatim": enc.encode(np.zeros((900, 1), np.int64),
                                     blocksize=256, nmean=4,
                                     verbatim_head=b"hdr\x00"),
    }, {"diff_nmean4": x, "diff_nmean0": x, "qlpc": x,
        "mono_tail": x[:777, :1], "ulaw": u,
        "zeros_verbatim": np.zeros((900, 1), np.int64)}


@pytest.mark.parametrize("case", ["diff_nmean4", "diff_nmean0", "qlpc",
                                  "mono_tail", "ulaw", "zeros_verbatim"])
def test_shorten_decode_bits_equal_python(case):
    streams, samples = _shorten_cases()
    stream = bytes(streams[case])
    port, _, _ = PS.decode(stream)
    jax_py, _, _ = JS.decode(stream)
    for count in (None, port.shape[0], 100):
        nat = native.shorten_decode(stream, count)
        n = port.shape[0] if count is None else count
        np.testing.assert_array_equal(nat, port[:n].astype(np.int32))
        np.testing.assert_array_equal(nat, jax_py[:n].astype(np.int32))
    np.testing.assert_array_equal(
        native.shorten_decode(stream).astype(np.int64), samples[case])


def test_wav_takes_the_native_shorten_route(tmp_path, monkeypatch):
    """io/wav prefers the native decoder; its samples equal the Python
    decoder's."""
    rng = np.random.default_rng(7)
    x = np.clip(np.cumsum(rng.integers(-300, 300, size=(1500, 2)), axis=0),
                -32768, 32767).astype(np.int64)
    p = tmp_path / "call.sph"
    p.write_bytes(enc.sphere_with_shorten(x, sample_rate=8000))
    calls = []
    real = native.shorten_decode
    monkeypatch.setattr(native, "shorten_decode",
                        lambda *a: calls.append(1) or real(*a))
    s1, rate = PW.load_wave(str(p) + "#ch1")
    assert calls and rate == 8000
    np.testing.assert_array_equal(s1.astype(np.int64), x[:, 1])


# ---------------------------------------------------------------------------
# Archives: the plan functions of data/archives.py
# ---------------------------------------------------------------------------

def _plan_corpus(tmp_path, cfg_kw=None):
    rng = np.random.RandomState(5)
    utt2len = {f"s{s}_u{u}": int(rng.randint(120, 260))
               for s in range(4) for u in range(3)}
    utt2label = {u: int(u[1]) for u in utt2len}
    feats = {u: (rng.randn(n, 23) * 3).astype(np.float32)
             for u, n in utt2len.items()}
    ark, scp = str(tmp_path / "egs_feats.ark"), str(tmp_path / "e.scp")
    with P.ArkWriter(ark, scp) as w:
        for u, m in feats.items():
            w.write(u, m)
    kw = dict(min_frames=50, max_frames=110, minibatch_size=4,
              num_repeats=2, frames_per_iter=4_000, seed=3)
    kw.update(cfg_kw or {})
    (pplan,) = PA.allocate_archives(utt2len, utt2label,
                                    PA.AllocatorConfig(**kw), num_archives=1)
    (jplan,) = JA.allocate_archives(utt2len, utt2label,
                                    JA.AllocatorConfig(**kw), num_archives=1)
    return pplan, jplan, feats, _offsets(scp)


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("shuffle", [None, 42])
def test_materialize_archive_byte_identical_to_jax(tmp_path, snap, shuffle):
    pplan, jplan, feats, src = _plan_corpus(tmp_path,
                                            dict(snap_to_bucket=snap))
    port, jax_py = str(tmp_path / "p.xta"), str(tmp_path / "j.xta")
    nat = str(tmp_path / "n.xta")
    PAR.materialize_archive(pplan, port, feats.__getitem__,
                            shuffle_seed=shuffle)
    JAR.materialize_archive(jplan, jax_py, feats.__getitem__,
                            shuffle_seed=shuffle)
    assert PAR.materialize_archive_native(pplan, nat, src,
                                          shuffle_seed=shuffle)
    data = open(port, "rb").read()
    assert data == open(jax_py, "rb").read()
    assert data == open(nat, "rb").read()
    # idempotent: an existing archive is left as it is
    os.utime(nat, (1, 1))
    assert PAR.materialize_archive_native(pplan, nat, src)
    assert os.path.getmtime(nat) == 1


@pytest.mark.parametrize("route", ["fetch", "native", "python_ark"])
def test_streaming_matches_materialized(tmp_path, route, monkeypatch):
    pplan, _, feats, src = _plan_corpus(tmp_path)
    path = str(tmp_path / "egs.0.xta")
    PAR.materialize_archive(pplan, path, feats.__getitem__, shuffle_seed=9)
    stored = list(PAR.ArchiveReader(path))
    if route == "fetch":
        kw = dict(fetch=feats.__getitem__)
    else:
        kw = dict(utt2src=src)
        if route == "python_ark":   # no compiler: the Python ark reader
            monkeypatch.setattr(native, "available", lambda: False)
    streamed = list(PAR.stream_plan_loader(pplan, shuffle_seed=9,
                                           queue_size=2, **kw))
    direct = list(PAR.iter_plan_minibatches(pplan, shuffle_seed=9, **kw))
    assert len(stored) == len(streamed) == len(direct) > 1
    for (xa, ya, ta), (xb, yb, tb), (xc, yc, tc) in zip(stored, streamed,
                                                        direct):
        assert xa.tobytes() == xb.tobytes() == xc.tobytes()
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ya, yc)
        assert ta == tb == tc


def test_iter_plan_needs_a_source():
    pplan = PA.ArchivePlan(0, (PA.MinibatchPlan(
        (PA.ChunkSpec("u", 0, 4, 0),), 4, 32),))
    with pytest.raises(ValueError, match="fetch or utt2src"):
        list(PAR.iter_plan_minibatches(pplan))


# ---------------------------------------------------------------------------
# The build: atomic under concurrency, loud on failure, absent without g++
# ---------------------------------------------------------------------------

_LOAD = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    from xvector_tpu_torch.runtime import native
    native.BUILD_ROOT = Path(sys.argv[1])
    while time.time() < float(sys.argv[2]):
        time.sleep(0.001)
    ok = native.available()
    rows = native.read_mat(sys.argv[3], int(sys.argv[4]))
    print(ok, rows.shape, float(rows.sum()))
""")


def test_six_concurrent_fresh_builds_all_load(tmp_path):
    """Six processes start together on an empty build directory: each
    compiles into its own temporary file and renames it into place, so
    none ever loads half a library."""
    import time
    ark, scp = str(tmp_path / "m.ark"), str(tmp_path / "m.scp")
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)
    with P.ArkWriter(ark, scp) as w:
        w.write("u", mat)
    path, off = _offsets(scp)["u"]
    build = tmp_path / "build"
    start = time.time() + 3.0
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD, str(build), str(start), path,
         str(off)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True (3, 4) 66.0", (out, err)
    libs = list(build.rglob("*.so"))
    assert [p.name for p in libs] == ["libxta.so"]   # no temp file left


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is present but fails: the build raises, it does
    not quietly fall back to Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building libxta failed"):
        native.available()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_toolchain_without_openmp_builds_serial(tmp_path, monkeypatch):
    """A g++ that refuses -fopenmp (no libgomp) still builds libxta,
    without OpenMP: one thread, the same bits."""
    real = native._compiler()
    cxx = tmp_path / "g++-no-openmp"
    cxx.write_text("#!/bin/sh\n"
                   'for a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
                   f'exec {real} "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    assert native.available() and native.threads() == 1
    vals = _f16_edges()[:4000].reshape(-1, 4)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    with P.ArkWriter(ark, scp) as w:
        w.write("x", vals)
    path, off = _offsets(scp)["x"]
    got = native.materialize_chunks([(path, off, 0, len(vals))],
                                    len(vals), 4)[0]
    with np.errstate(over="ignore"):
        want = vals.astype(np.float16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(native.read_mat(path, off), vals)


def test_no_compiler_falls_back_to_python(tmp_path, monkeypatch):
    """Without a compiler the package runs on its Python paths: the
    native materialiser declines, the readers and the shorten decoder
    give the same results."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    assert not native.available()
    pplan, _, feats, src = _plan_corpus(tmp_path)
    assert not PAR.materialize_archive_native(pplan,
                                              str(tmp_path / "x.xta"), src)
    assert not os.path.exists(tmp_path / "x.xta")
    ark = str(tmp_path / "egs_feats.ark")
    got = dict(P.read_mat_ark_fast(ark))
    assert set(got) == set(feats)
    for u in feats:
        np.testing.assert_array_equal(got[u], feats[u])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.read_mat(*src["s0_u0"])
    streams, samples = _shorten_cases()
    np.testing.assert_array_equal(
        PW._shorten_to_samples(bytes(streams["qlpc"]), None),
        samples["qlpc"])
