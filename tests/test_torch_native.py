"""The port's native host runtime (``abnet3_torch/native``) against the
JAX package's (``abnet3_tpu/native``) and its numpy oracles.

JAX's library is built by JAX's own loader, from JAX's source with JAX's
flags, into this module's temporary directory (its ``_LIB_PATH``
patched), so nothing is written under ``abnet3_tpu/`` and no other test
worker builds the same file at once. The port's is built once, by its
own loader, into ``abnet3_torch/build/``."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import abnet3_tpu.dataloader as J
import abnet3_tpu.utils as JU
import abnet3_torch.dataloader as T
import abnet3_torch.utils as TU
from abnet3_tpu import native as jnative
from abnet3_tpu.utils import Features_Accessor as JFeatures
from abnet3_torch import native
from abnet3_torch.utils import Features_Accessor as TFeatures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``abnet3_tpu.native`` with its library loaded from a build of its
    own into a temporary directory (restored after the module)."""
    lib_dir = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH",
                   str(lib_dir / "libabnet3_native.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "AVAILABLE", False)
        assert jnative._load() is not None, "JAX's native library failed"
        yield jnative


def prototype_frames(rng, n, noise, dim=40, n_protos=8, protos=None):
    """``n`` frames, each one of ``n_protos`` prototype frames plus
    Gaussian noise of scale ``noise`` (0: exact repeats), float32."""
    if protos is None:
        protos = rng.randn(n_protos, dim)
    frames = protos[rng.randint(len(protos), size=n)]
    if noise:
        frames = frames + noise * rng.randn(n, dim)
    return frames.astype(np.float32)


def repeated_corpus(noise, n_same=100, n_diff=20, seed=0):
    """Tokens of 20-96 frames repeating 8 prototype frames (digital
    silence, stationary segments, synthetic tones): one file a token,
    the token its whole file. Returns (times, features, grouped pairs)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(8, 40)
    times, feats, toks = {}, {}, []
    for i in range(2 * (n_same + n_diff)):
        n = rng.randint(20, 97)
        name = f"f{i}"
        feats[name] = prototype_frames(rng, n, noise, protos=protos)
        times[name] = np.arange(n) * 0.01 + 0.0025
        toks.append((name, 0.0, round(n * 0.01, 2)))
    pairs = [toks[2 * i] + toks[2 * i + 1] for i in range(n_same + n_diff)]
    return times, feats, {"same": pairs[:n_same], "diff": pairs[n_same:]}


@pytest.mark.parametrize("noise", [0.0, 1e-6])
def test_host_batch_matches_jax_native_on_repeated_frames(jax_native,
                                                          noise):
    """C6: the host backend's batch (``load_frames_from_pairs`` ->
    ``_host_batch``) equals the JAX package's, whose same pairs are
    aligned by its native library, frame for frame, on tokens whose
    distances tie or nearly tie."""
    times, feats, grouped = repeated_corpus(noise)
    jl = J.OriginalDataLoader(None, None, seed=0, align_backend="host")
    jl.features = JFeatures(times, feats)
    tl = T.OriginalDataLoader(None, None, seed=0, align_backend="host",
                              device="cpu")
    tl.features = TFeatures(times, feats)
    X1, X2, y = jl.load_frames_from_pairs(grouped)
    jb = J.Batch(*(np.asarray(a) for a in (X1, X2, y)))
    tb = tl._host_batch(*tl.load_frames_from_pairs(grouped))
    assert dict(tl.statistics_training) == dict(jl.statistics_training)
    assert tb.x1.shape == jb.x1.shape
    for f in ("x1", "x2", "y"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f),
                                                 np.float32), err_msg=f)
    assert torch.equal(tb.weights, torch.ones(len(tb.y)))


@pytest.mark.parametrize("kind", ["repeats", "noise_1e-6", "gaussian"])
def test_dtw_align_matches_jax_native(jax_native, kind):
    """C6 on the alignment alone: 100 pairs of 20-96 frames x 40 dims,
    the index paths equal to the JAX package's native ``dtw_align`` (and
    to its ``get_dtw_alignment``, which goes through it)."""
    rng = np.random.RandomState(len(kind))
    protos = rng.randn(8, 40)
    for _ in range(100):
        n1, n2 = rng.randint(20, 97, size=2)
        if kind == "gaussian":
            a, b = (rng.randn(n, 40).astype(np.float32) for n in (n1, n2))
        else:
            noise = 1e-6 if kind == "noise_1e-6" else 0.0
            a, b = (prototype_frames(rng, n, noise, protos=protos)
                    for n in (n1, n2))
        want = jax_native.dtw_align(a, b)
        for got in (native.dtw_align(a, b), TU.get_dtw_alignment(a, b)):
            for g, w in zip(got, want):
                assert g.dtype == np.int64
                np.testing.assert_array_equal(g, w)
        for g, w in zip(JU.get_dtw_alignment(a, b), want):
            np.testing.assert_array_equal(g, w)


def test_cosine_distance_matches_jax_native(jax_native):
    """Bit for bit, zero-norm rows on both sides (distance 0 between two
    of them, 1 to anything else), repeated rows and random ones."""
    rng = np.random.RandomState(0)
    x = rng.randn(9, 12).astype(np.float32)
    y = rng.randn(7, 12).astype(np.float32)
    x[[3, 5]] = 0.0
    y[2] = 0.0
    y[4] = x[1]
    got = native.cosine_distance(x, y)
    assert got.dtype == np.float64 and got.shape == (9, 7)
    np.testing.assert_array_equal(got, jax_native.cosine_distance(x, y))
    assert got[3, 2] == 0.0 and got[3, 0] == 1.0 and got[0, 2] == 1.0
    # the plain numpy version (float32 products) agrees to rounding
    np.testing.assert_allclose(got, TU.cosine_distance(x, y), atol=1e-6)
    with pytest.raises(ValueError):
        native.cosine_distance(x, y[:, :5])


@pytest.mark.parametrize("kind", ["float", "ties"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (9, 1), (12, 7),
                                   (30, 30), (17, 41)])
def test_dtw_matches_jax(jax_native, kind, shape):
    """``dtw`` on random and tie-heavy integer cost matrices: cost and
    paths bit for bit JAX's native ``dtw``; paths exactly and cost within
    1e-9 the JAX numpy oracle ``dtw_numpy`` and the port's
    ``dtw_numpy_fast``."""
    rng = np.random.RandomState(sum(shape))
    for _ in range(5):
        if kind == "ties":
            dist = rng.randint(0, 3, shape).astype(np.float64)
        else:
            dist = rng.rand(*shape)
        cost, p1, p2 = native.dtw(dist)
        jcost, j1, j2 = jax_native.dtw(dist)
        assert cost == jcost
        np.testing.assert_array_equal(p1, j1)
        np.testing.assert_array_equal(p2, j2)
        for oracle in (JU.dtw_numpy, TU.dtw_numpy_fast):
            ocost, o1, o2 = oracle(dist)
            assert cost == pytest.approx(ocost, abs=1e-9)
            np.testing.assert_array_equal(p1, o1)
            np.testing.assert_array_equal(p2, o2)


def test_pad_batch(jax_native):
    """The JAX package's case (tests/test_native.py), truncation to T
    included, equal to its native ``pad_batch``; a token outside the
    table raises instead of reading past it."""
    rng = np.random.RandomState(3)
    table = rng.randn(50, 5).astype(np.float32)
    offsets = np.array([0, 10, 30], np.int64)
    lens = np.array([10, 20, 7], np.int32)
    out = native.pad_batch(table, offsets, lens, T=16)
    assert out.shape == (3, 16, 5) and out.dtype == np.float32
    np.testing.assert_array_equal(out[0, :10], table[0:10])
    np.testing.assert_array_equal(out[0, 10:], 0)
    np.testing.assert_array_equal(out[1], table[10:26])  # truncated to 16
    np.testing.assert_array_equal(out[2, :7], table[30:37])
    np.testing.assert_array_equal(out[2, 7:], 0)
    np.testing.assert_array_equal(
        out, jax_native.pad_batch(table, offsets, lens, T=16))
    with pytest.raises(ValueError):
        native.pad_batch(table, np.array([45], np.int64),
                         np.array([8], np.int32), T=16)


# -- pair files ------------------------------------------------------------

PAIR_FILES = {
    "plain": b"fa 0.10 0.50 fb 1.00 1.40 same\n"
             b"fa 0.10 0.50 fc 2.00 2.30 diff\n\n"
             b"fb 3.00 3.25 fa 0.70 0.90 same\n",
    "bad_type_line_2": b"fa 0.1 0.5 fb 1.0 1.4 same\n"
                       b"fa 0.1 0.5 fb 1.0 1.4 banana\n",
    "bad_after_blanks_line_4": b"fa 0.1 0.5 fb 1.0 1.4 same\n\n\n"
                               b"fa 0.1 0.5 fb 1.0 1.4 banana\n",
    "crlf_bad_line_3": b"fa 0.1 0.5 fb 1.0 1.4 same\r\n"
                       b"fb 0.2 0.6 fa 1.1 1.5 diff\r\noops\r\n",
    "crlf_blank": b"fa 0.1 0.5 fb 1.0 1.4 same\r\n\r\n"
                  b"fb 0.2 0.6 fa 1.1 1.5 diff\r\n",
    "lone_cr": b"f1 0.1 0.5 f2 0.2 0.6 same\r"
               b"f3 0.0 0.3 f4 0.1 0.4 diff\r",
    "corrupt_numeric": b"f1 abc 0.5 f2 0.2 0.6 same\n",
}
# the JAX package's Python-parity cases: every whitespace and numeric
# shape where strip().split(" ") + float() and a C scanner could part
PARITY_CASES = [
    "f1 0.1 0.2 f2 0.3 0.4 same\n",          # plain valid
    "f1 0.1 0.2 f2 0.3 0.4 diff",            # no trailing newline
    "f1 0.1  0.2 f2 0.3 0.4 same\n",         # double space: 8 tokens
    "a 1 2  3 4 same\n",                     # empty token on a name column
    "  f1 0.1 0.2 f2 0.3 0.4 same\n",        # leading spaces (strip)
    "f1 0.1 0.2 f2 0.3 0.4 same   \n",       # trailing spaces (strip)
    "\tf1 0.1 0.2 f2 0.3 0.4 same\n",        # leading tab (strip)
    "f1 0.1 0.2 f2 0.3 0.4 same\t\n",        # trailing tab (strip)
    "f1 0.1\t 0.2 f2 0.3 0.4 same\n",        # tab inside a numeric token
    "f\t1 0.1 0.2 f2 0.3 0.4 same\n",        # tab inside a name token
    "f1 0x10 0.2 f2 0.3 0.4 same\n",         # hex float: float() rejects
    "f1 1_0 0.2 f2 0.3 0.4 same\n",          # PEP 515 underscore
    "f1 1_ 0.2 f2 0.3 0.4 same\n",           # trailing underscore: bad
    "f1 1__0 0.2 f2 0.3 0.4 same\n",         # double underscore: bad
    "f1 inf 0.2 f2 -inf nan same\n",         # inf/nan accepted by both
    "f1 .5 5. f2 +0.3 -4e-2 diff\n",         # bare dot, sign, exponent
    "f1 1e 0.2 f2 0.3 0.4 same\n",           # dangling exponent: bad
    "f1 1.2.3 0.2 f2 0.3 0.4 same\n",        # double dot: bad
    "f1 abc 0.2 f2 0.3 0.4 same\n",          # corrupt column: bad
    "f1 0.1 0.2 f2 0.3 0.4 Same\n",          # wrong-case type: bad
    "f1 0.1 0.2 f2 0.3 0.4 samex\n",         # type superstring: bad
    "f1 0.1 0.2 f2 0.3 0.4\n",               # 6 columns: bad
    "f1 0.1 0.2 f2 0.3 0.4 same extra\n",    # 8 columns: bad
    "\n\nf1 0.1 0.2 f2 0.3 0.4 same\n\n",    # blank lines skipped
    "   \n",                                 # whitespace-only line
    "",                                      # empty file
    "f1 0.1 0.2 f2 0.3 0.4 same\r\nf3 1 2 f4 3 4 diff\r\n",  # CRLF
]
PAIR_FILES.update({f"parity_{i}": text.encode()
                   for i, text in enumerate(PARITY_CASES)})


def _norm(rows):
    """NaN-safe comparison form (nan != nan under ==)."""
    return [tuple(repr(x) if isinstance(x, float) else x for x in r)
            for r in rows]


def _outcome(read, path):
    try:
        return "ok", _norm(read(path))
    except ValueError as exc:
        return "error", str(exc)


def _check_pair_file(path):
    """The port's ``read_dataset`` (native) equals the JAX package's
    (its native parser) in rows or error message, the port's
    ``read_dataset_python`` equals JAX's, and both port parsers accept
    or reject the file alike, with the same rows; ``parse_pairs``'s
    arrays equal JAX's native ones."""
    got = _outcome(TU.read_dataset, path)
    assert got == _outcome(JU.read_dataset, path)
    py = _outcome(TU.read_dataset_python, path)
    assert py == _outcome(JU.read_dataset_python, path)
    assert got[0] == py[0], (got, py)
    if got[0] == "ok":
        assert got[1] == py[1]
        mine, theirs = native.parse_pairs(path), jnative.parse_pairs(path)
        assert mine[0] == theirs[0]
        for a, b in zip(mine[1:], theirs[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("name", sorted(PAIR_FILES))
def test_pair_file_matches_jax(jax_native, tmp_path, name):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(PAIR_FILES[name])
    kind, value = _check_pair_file(path)
    if "line_" in name:
        line = name.rsplit("_", 1)[1]
        assert kind == "error"
        assert value == f"malformed pairs line {line} in {path}"
    if name == "corrupt_numeric":
        assert value == f"malformed pairs line 1 in {path}"
    if name in ("lone_cr", "crlf_blank"):
        assert kind == "ok" and len(value) == 2


@pytest.mark.parametrize("seed", [1234, 7, 99])
def test_pair_file_fuzz_matches_jax(jax_native, tmp_path, seed):
    """The JAX package's differential fuzz: generated pair files (valid
    lines and whitespace, numeric and column mutations, LF or CRLF) read
    alike by the four parsers."""
    rng = np.random.RandomState(seed)
    names = ["f1", "tok-2", "a.b", "x" * 30, "\u00e9m\u00fc", "f_3"]
    numbers = ["0.1", "-3.25", "1e4", "-4e-2", ".5", "5.", "+2", "inf",
               "nan", "1_000", "0x1p2", "abc", "1e", "1.2.3", "", "7\t"]
    types = ["same", "diff", "Same", "samex", "sam", ""]

    def line(valid):
        if valid:
            toks = [rng.choice(names), f"{rng.rand():.4f}",
                    f"{rng.rand():.4f}", rng.choice(names),
                    f"{rng.rand():.4f}", f"{rng.rand():.4f}",
                    ("same", "diff")[rng.randint(2)]]
        else:
            toks = [rng.choice(names), rng.choice(numbers),
                    rng.choice(numbers), rng.choice(names),
                    rng.choice(numbers), rng.choice(numbers),
                    rng.choice(types)]
            k = rng.randint(4)
            if k == 0:
                toks.pop(rng.randint(len(toks)))         # drop a column
            elif k == 1:
                toks.insert(rng.randint(len(toks)), "9")  # extra column
        s = " ".join(toks)
        if rng.rand() < 0.2:
            s = " " * rng.randint(1, 3) + s              # leading space
        if rng.rand() < 0.2:
            s = s + "\t" * rng.randint(1, 3)             # trailing tabs
        if rng.rand() < 0.15:
            i = rng.randint(len(s))
            s = s[:i] + " " + s[i:]                      # injected space
        return s

    kinds = set()
    for trial in range(40):
        eol = "\r\n" if rng.rand() < 0.2 else "\n"
        body = eol.join(line(rng.rand() < 0.6)
                        for _ in range(rng.randint(0, 6)))
        if rng.rand() < 0.8:
            body += eol
        if rng.rand() < 0.2:
            body = eol + body                            # leading blank
        path = str(tmp_path / f"fuzz{trial}")
        with open(path, "wb") as fh:
            fh.write(body.encode("utf-8"))
        kinds.add(_check_pair_file(path)[0])
    assert kinds == {"ok", "error"}


def test_read_pairs_is_grouped_read_dataset(tmp_path):
    path = str(tmp_path / "pairs")
    with open(path, "wb") as fh:
        fh.write(PAIR_FILES["plain"])
    assert TU.read_pairs(path) == JU.read_pairs(path)
    assert TU.read_dataset(path)[2] == ("fb", 3.0, 3.25, "fa", 0.7, 0.9,
                                        "same")


# -- the build -------------------------------------------------------------

def _tree_state(root):
    """(path, mtime_ns, size) of every file under ``root`` but Python's
    bytecode caches and the JAX loader's own library, which other test
    files build and import."""
    out = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f == "libabnet3_native.so":
                continue
            st = os.stat(os.path.join(d, f))
            out.add((os.path.join(d, f), st.st_mtime_ns, st.st_size))
    return out


def test_library_builds_into_the_port(tmp_path):
    """In a fresh interpreter: importing builds nothing; the first call
    loads the library from ``abnet3_torch/build/`` (named by the hash of
    the source and flags), and the port's build, parser and host DTW
    change no file under ``abnet3_tpu/``."""
    before = _tree_state(os.path.join(REPO, "abnet3_tpu"))
    pairs = tmp_path / "pairs"
    pairs.write_bytes(PAIR_FILES["plain"])
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import abnet3_torch.dataloader\n"
        "from abnet3_torch import native, utils\n"
        "assert native._lib is None and not native.AVAILABLE\n"
        "info = native.build()\n"
        "assert native.AVAILABLE\n"
        f"assert len(utils.read_dataset({str(pairs)!r})) == 3\n"
        "f = np.random.RandomState(0).randn(5, 3).astype(np.float32)\n"
        "p1, p2 = utils.get_dtw_alignment(f, f)\n"
        "assert p1.tolist() == p2.tolist() == list(range(5))\n"
        "assert 'jax' not in sys.modules\n"
        "print(info['path'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = proc.stdout.strip().splitlines()[-1]
    assert path == native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "abnet3_torch",
                                                 "build")
    assert os.path.basename(path).startswith("libabnet3_native-")
    assert os.path.isfile(path)
    assert _tree_state(os.path.join(REPO, "abnet3_tpu")) == before


_RACE = """
import os, sys, time
from abnet3_torch import native
native.BUILD_DIR = sys.argv[1]
open(os.path.join(sys.argv[2], str(os.getpid())), "w").close()
while not os.path.exists(os.path.join(sys.argv[2], "go")):
    time.sleep(0.005)
info = native.build()
import numpy as np
f = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
assert native.dtw_align(f, f)[0].tolist() == [0, 1, 2, 3]
print(info["compiled"], info["path"])
"""


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Two processes building into one empty directory at the same
    moment: each compiles to a file of its own and renames it into
    place, so both load a working library and no partial file stays."""
    build, ready = tmp_path / "build", tmp_path / "ready"
    ready.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, str(build), str(ready)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    try:
        deadline = time.time() + 120
        while len(os.listdir(ready)) < 2 and time.time() < deadline:
            time.sleep(0.01)
        (ready / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    lines = [out.split() for out, _ in outs]
    assert [w[0] for w in lines] == ["True", "True"]  # both compiled
    assert lines[0][1] == lines[1][1]
    assert os.listdir(build) == [os.path.basename(lines[0][1])]


def test_no_compiler_raises(monkeypatch, tmp_path):
    """When no compiler builds the library, the first call raises with
    each compiler's output, and the host paths raise with it: no
    fallback to the numpy DTW or the Python parser, no pair skipped."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "COMPILERS", ("no-such-c++", "false"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "AVAILABLE", False)
    f = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+") as err:
        native.dtw_align(f, f)
    assert "false (exit 1)" in str(err.value)
    path = tmp_path / "pairs"
    path.write_bytes(PAIR_FILES["plain"])
    with pytest.raises(RuntimeError):
        TU.read_dataset(str(path))
    with pytest.raises(RuntimeError):
        TU.get_dtw_alignment(f, f)
    times, feats, grouped = repeated_corpus(0.0, n_same=2, n_diff=1)
    tl = T.OriginalDataLoader(None, None, seed=0, align_backend="host",
                              device="cpu")
    tl.features = TFeatures(times, feats)
    with pytest.raises(RuntimeError):
        tl.load_frames_from_pairs(grouped)
    assert not native.AVAILABLE
    assert not os.listdir(tmp_path / "build")
