"""The port's data path (``remfx_tpu_torch/data``) against the JAX
package's (``remfx_tpu/data``).

Bit for bit: the synthetic sources and ``ChunkSource`` (numpy on both
sides, the same ``np.random.Generator``), the chunks a dynamic batch and
an offline render start from, and the datamodule's order over epochs.
The render itself draws from a ``torch.Generator`` (the two packages'
draws differ), so the port's batches are held to the dataset's contract
instead: shapes, labels of the configured effects, -20 LUFS within 0.01
LU, and the same batch again for the same (seed, epoch, index). Files at
another rate go through the port's resampler, held to JAX's at 1e-6 x the
peak (``tests/test_torch_resample.py``).
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from remfx_tpu.data import datasets as jds
from remfx_tpu.data import sources as jsrc
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.data import datasets as tds
from remfx_tpu_torch.data import sources as tsrc
from remfx_tpu_torch.data.wav import write_wav
from remfx_tpu_torch.ops.loudness import integrated_loudness

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SR = 48000
DEMO = str(ROOT / "demos" / "example_48k_mono.wav")
jres = importlib.import_module("remfx_tpu.ops.resample")
# compression_aug (remfx_tpu/config/experiments.py:144-154): remove the
# compressor; keep 0-4 of the others, shuffled
AUG = dict(effects_to_keep=["distortion", "chorus", "delay", "reverb"],
           effects_to_remove=["compressor"], num_kept_effects=[0, 4],
           num_removed_effects=[1, 1], shuffle_kept_effects=True,
           shuffle_removed_effects=False, sample_rate=SR, chunk_size=8192,
           synthetic=True, seed=7, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_synthetic_chunk_equals_jax(seed):
    for n in (8192, 262144):
        want = jsrc.synthetic_chunk(np.random.default_rng(seed), n, SR)
        got = tsrc.synthetic_chunk(np.random.default_rng(seed), n, SR)
        assert got.dtype == np.float32 and got.shape == (1, n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("real", [False, True])
def test_synthetic_chunk_rich_equals_jax(real):
    files = (DEMO,) if real else ()
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(12):  # every family, the mixtures and the real clip
        want = jsrc.synthetic_chunk_rich(jrng, 16384, SR, files)
        got = tsrc.synthetic_chunk_rich(trng, 16384, SR, files)
        np.testing.assert_array_equal(got, want)


def test_chunk_source_equals_jax(tmp_path):
    kw = dict(chunk_size=4096, sample_rate=SR, synthetic=True, rich=True,
              real_files=(DEMO, str(tmp_path / "absent.wav")))
    jsource, tsource = jsrc.ChunkSource(None, "train", **kw), tsrc.ChunkSource(None, "train", **kw)
    assert tsource.real_files == jsource.real_files == (DEMO,)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        np.testing.assert_array_equal(tsource.sample(trng), jsource.sample(jrng))


def test_select_random_chunk_at_another_rate(tmp_path):
    """A 44.1 kHz file: the same chunk, resampled to 48 kHz by each
    package's resampler."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((1, 44100))).astype(np.float32)
    path = tmp_path / "a.wav"
    write_wav(path, x, 44100)
    want = jsrc.select_random_chunk(np.random.default_rng(1), str(path), 8192, SR)
    got = tsrc.select_random_chunk(np.random.default_rng(1), str(path), 8192, SR)
    assert got.shape == want.shape == (1, 8192)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()


class _Indexed:
    """A map-style dataset whose items name their index."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return (np.full((1, 4), i, np.float32), np.zeros((1, 4), np.float32),
                np.zeros(5, np.float32), np.zeros(5, np.float32))


def _orders(dm, epochs=3):
    out = []
    for _ in range(epochs):
        out.append([int(b[0][:, 0, 0].tolist()[j]) for b in dm.train_dataloader()
                    for j in range(len(b[0]))])
    out.append([int(v) for b in dm.val_dataloader() for v in b[0][:, 0, 0]])
    out.append([int(v) for b in dm.test_dataloader() for v in b[0][:, 0, 0]])
    return out


def test_datamodule_order_equals_jax():
    ds = _Indexed()
    kw = dict(train_batch_size=3, test_batch_size=4, seed=11)
    jdm, tdm = jds.EffectDatamodule(ds, ds, ds, **kw), tds.EffectDatamodule(ds, ds, ds, **kw)
    assert _orders(tdm) == _orders(jdm)
    jdm.set_epoch(7)
    tdm.set_epoch(7)
    assert _orders(tdm, 1) == _orders(jdm, 1)


def test_dynamic_batch_starts_from_the_jax_chunks():
    """The chunks of a dynamic batch come from the same numpy stream as
    the JAX package's (seed, mode salt, epoch, first index)."""
    ds = tds.DynamicEffectDataset(total_chunks=8, mode="train", **AUG)
    ds.set_epoch(3)
    want = np.stack([jsrc.synthetic_chunk(rng, 8192, SR) for rng in
                     [np.random.default_rng([7, 0, 3, 4])] for _ in range(2)])
    got = ds._chunk_batch(np.random.default_rng([7, ds._mode_salt, 3, 4]), 2)
    np.testing.assert_array_equal(got, want)


def test_dynamic_batch_keeps_the_contract():
    ds = tds.DynamicEffectDataset(total_chunks=8, mode="train", **AUG)
    ds.set_epoch(1)
    wet, dry, dl, wl = ds.get_batch(np.arange(4, 8))
    assert wet.shape == dry.shape == (4, 1, 8192) and dl.shape == wl.shape == (4, 5)
    assert all(t.dtype == torch.float32 for t in (wet, dry, dl, wl))
    assert bool((wl[:, ALL_EFFECTS.index("compressor")] == 1).all())
    assert bool((wl.sum(1) == 1).all())
    assert bool((dl[:, ALL_EFFECTS.index("compressor")] == 0).all())
    assert int(dl.sum(1).max()) <= 4
    lufs = torch.cat([integrated_loudness(wet, SR), integrated_loudness(dry, SR)])
    assert (lufs + 20).abs().max().item() <= 0.01
    again = ds.get_batch(np.arange(4, 8))
    assert all(torch.equal(a, b) for a, b in zip(again, (wet, dry, dl, wl)))
    ds.set_epoch(2)
    assert not torch.equal(ds.get_batch(np.arange(4, 8))[0], wet)
    one = ds[4]
    assert isinstance(one[0], np.ndarray) and one[0].shape == (1, 8192)


def test_effect_dataset_layout_and_resume(tmp_path):
    kw = dict(AUG, render_root=tmp_path, render_batch_size=2, total_chunks=5, mode="val")
    ds = tds.EffectDataset(**kw)
    root = tmp_path / "processed" / ds.effects_string / "val"
    assert sorted(int(p.name) for p in root.iterdir()) == list(range(5))
    for i in range(5):
        assert sorted(p.name for p in (root / str(i)).iterdir()) == [
            "dry_effects.pt", "input.wav", "target.wav", "wet_effects.pt"]
    first = [ds[i] for i in range(5)]
    assert first[0][0].shape == (1, 8192)
    assert torch.load(root / "0" / "wet_effects.pt").shape == (5,)
    # a run killed in the third chunk's batch: resume from its batch's start
    (root / "3" / "wet_effects.pt").unlink()
    (root / "4" / "input.wav").unlink()
    again = tds.EffectDataset(**kw)
    for i in range(5):
        for a, b in zip(again[i], first[i]):
            np.testing.assert_array_equal(a, b)
    reuse = tds.EffectDataset(**dict(kw, render_files=False))
    assert len(reuse) == 5
    with pytest.raises(SystemExit):
        tds.EffectDataset(**kw)  # complete render, no opt-in to re-render


def test_inference_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    for sub, n in (("clean", 22050), ("effected", 22000)):
        (tmp_path / sub).mkdir()
        write_wav(tmp_path / sub / "a.wav",
                  (0.3 * rng.standard_normal((2, n))).astype(np.float32), 44100)
    want = jds.InferenceDataset(tmp_path, SR)[0]
    got = tds.InferenceDataset(tmp_path, SR)[0]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-6
