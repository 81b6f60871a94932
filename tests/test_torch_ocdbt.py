"""The port's orbax reader (``remfx_tpu_torch/compat/ocdbt.py``) against
orbax itself.

Every vendored checkpoint (``ckpts/*/variables`` and the full TrainState
``ckpts/tcn_distortion_synth/best``) read by the port equals the JAX
package's ``restore_tree`` bit for bit: the same tree paths, shapes and
dtypes, bfloat16 as its bits and, upcast, as orbax's array cast to
float32. OCDBT trees that orbax's writes here never make (B-tree interior
nodes, version tree nodes, zarr arrays of several chunks, a chunk left
out as equal to the fill value) are written with tensorstore and read
back. Damaged copies raise; the reader loads no JAX, orbax, tensorstore
or zstandard.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts

from remfx_tpu.train.checkpoint import restore_tree as jax_restore_tree
from remfx_tpu_torch.compat import ocdbt

ROOT = Path(__file__).resolve().parents[1]
CKPTS = sorted(p.name for p in (ROOT / "ckpts").iterdir() if p.is_dir())
TCN = ROOT / "ckpts" / "tcn_distortion_aug" / "variables"


def _orbax_dir(name: str) -> Path:
    d = ROOT / "ckpts" / name
    return d / "variables" if (d / "variables").is_dir() else d / "best"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _kinds(tree):
    """The tree's structure: dict, list and leaf, by path."""
    if isinstance(tree, dict):
        return {k: _kinds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_kinds(v) for v in tree]
    return None if tree is None else "array"


def test_all_ten_checkpoints_are_vendored():
    assert len(CKPTS) == 10, CKPTS
    assert (ROOT / "ckpts" / "tcn_distortion_synth" / "best").is_dir()


@pytest.mark.parametrize("name", CKPTS)
def test_reader_equals_orbax_bit_for_bit(name):
    got = ocdbt.restore_tree(_orbax_dir(name))
    want = jax_restore_tree(str(_orbax_dir(name)))
    assert _kinds(got) == _kinds(want)
    leaves = dict(_leaves(want))
    for path, a in _leaves(got):
        b = leaves[path]
        if b is None:
            assert a is None, path
            continue
        assert a.shape == b.shape, path
        if str(b.dtype) == "bfloat16":
            assert isinstance(a, ocdbt.Bfloat16Bits), path
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                          b.view(np.uint16))
            up = ocdbt.upcast_bfloat16(a)
            assert up.dtype == np.float32
            assert up.tobytes() == b.astype(np.float32).tobytes(), path
        else:
            assert a.dtype == b.dtype, path
            assert ocdbt.upcast_bfloat16(a) is a
            assert a.tobytes() == b.tobytes(), path


def test_import_and_read_load_no_jax():
    code = (
        "import sys\n"
        "from remfx_tpu_torch.compat import ocdbt\n"
        f"tree = ocdbt.restore_tree({str(TCN)!r})\n"
        "assert tree['params']['output']['kernel'].shape == (1, 64, 1)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'tensorstore', 'zstandard', "
        "'remfx_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _copy(tmp_path) -> Path:
    dst = tmp_path / "variables"
    shutil.copytree(TCN, dst)
    return dst


def _data_file(d: Path) -> Path:
    return max((d / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)


def test_truncated_value_file_raises(tmp_path):
    d = _copy(tmp_path)
    f = _data_file(d)
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])
    with pytest.raises(ValueError, match="beyond its"):
        ocdbt.restore_tree(d)


def test_missing_value_file_raises(tmp_path):
    d = _copy(tmp_path)
    _data_file(d).unlink()
    with pytest.raises(FileNotFoundError, match="data file missing"):
        ocdbt.restore_tree(d)


@pytest.mark.parametrize("offset,match", [(0, "magic"), (5, "header says"),
                                          (20, "CRC-32C")])
def test_damaged_manifest_raises(tmp_path, offset, match):
    d = _copy(tmp_path)
    raw = bytearray((d / "manifest.ocdbt").read_bytes())
    raw[offset] ^= 0x40
    (d / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=match):
        ocdbt.restore_tree(d)


def test_corrupt_chunk_raises(tmp_path):
    """A value's zstd frame cut short inside an intact data file."""
    d = _copy(tmp_path)
    store = ocdbt.OcdbtStore(d)
    key = next(k for k, e in store.entries.items() if e[0] == "file")
    _, path, off, size = store.entries[key]
    f = d / path
    raw = bytearray(f.read_bytes())
    raw[off + size // 2: off + size] = bytes(size - size // 2)
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="zstd"):
        ocdbt.restore_tree(d)


def test_missing_libzstd_raises(monkeypatch):
    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ocdbt, "_zstd", None)
    monkeypatch.setattr(ocdbt.ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libzstd"):
        ocdbt.restore_tree(TCN)


def test_crc32c_known_answer():
    # RFC 3720 B.4: 32 bytes of zeros, and the ASCII digits check value
    assert ocdbt.crc32c(bytes(32)) == 0x8A9136AA
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


def test_interior_nodes_and_version_tree(tmp_path):
    """A B-tree of several levels and a manifest that refers to version
    tree nodes (one version per write; small nodes), written by
    tensorstore: every key and value read back."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 16,
                   "compression": {"id": "zstd"}},
    }).result()
    rng = np.random.default_rng(0)
    want = {}
    for i in range(300):
        key = f"params.layer{i:03d}.{'kernel' if i % 2 else 'bias'}/0.0"
        want[key] = rng.bytes(int(rng.integers(0, 64)))
        kv[key] = want[key]
    for i in range(0, 300, 7):  # later versions overwrite some keys
        key = f"params.layer{i:03d}.{'kernel' if i % 2 else 'bias'}/0.0"
        want[key] = rng.bytes(40)
        kv[key] = want[key]
    store = ocdbt.OcdbtStore(tmp_path)
    assert {k.decode() for k in store.entries} == set(want)
    for key, value in want.items():
        assert store.get(key) == value, key


@pytest.mark.parametrize("dtype,fill", [("bfloat16", 0), ("bfloat16", 1.5),
                                        ("float32", -2.25), ("int32", 0), ("int32", 3)])
def test_zarr_array_of_several_chunks(tmp_path, dtype, fill):
    """Edge chunks, C order, and a chunk equal to the fill value, which
    tensorstore does not store, so that the reader fills it."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((7, 9, 2)) * 8).astype(np.float32)
    a[:3, :4] = fill  # the first chunk is all fill value
    arr = ts.open({
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
        "path": "params.w",
        "metadata": {"shape": [7, 9, 2], "chunks": [3, 4, 2], "dtype": (
            "bfloat16" if dtype == "bfloat16" else np.dtype(dtype).str),
            "compressor": {"id": "zstd", "level": 1}, "fill_value": fill},
        "create": True,
    }).result()
    src = a.astype(arr.dtype.numpy_dtype)
    arr.write(src).result()
    store = ocdbt.OcdbtStore(tmp_path)
    assert store.get("params.w/0.0.0") is None
    assert store.get("params.w/1.1.0") is not None
    got = ocdbt.read_zarr(store, "params.w")
    assert got.shape == (7, 9, 2)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np.asarray(got).view(np.uint16),
                                      src.view(np.uint16))
    else:
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, src)
