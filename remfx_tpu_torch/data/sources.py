"""Source-dataset scanners, splits, and chunk sampling.

The port's copy of ``remfx_tpu/data/sources.py``: the reference's split
tables + ``locate_files`` (remfx/datasets.py:23-106) and
``select_random_chunk`` (remfx/utils.py:120-135), with numpy wav IO
(data/wav.py) and the port's polyphase resampler (ops/resample.py).
The synthetic sources are numpy, so for the same ``np.random.Generator``
their chunks equal the JAX package's bit for bit
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.ops.resample import resample
from remfx_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Split tables (reference remfx/datasets.py:23-56).
VOCALSET_SPLITS = {
    "train": [f"male{i}" for i in range(1, 10)]
    + [f"female{i}" for i in range(1, 8)],
    "val": ["male10", "female8"],
    "test": ["male11", "female9"],
}
GUITARSET_SPLITS = {"train": ["00", "01", "02", "03"], "val": ["04"], "test": ["05"]}
DSD100_SPLITS = {"train": ["train"], "val": ["val"], "test": ["test"]}
IDMT_DRUMS_SPLITS = {
    "train": ["WaveDrum02", "TechnoDrum01"],
    "val": ["RealDrum01"],
    "test": ["TechnoDrum02", "WaveDrum01"],
}


def locate_files(root, mode: str) -> list[list[str]]:
    """Scan ``root`` for the four starter datasets; one sorted path list
    per dataset found (reference remfx/datasets.py:59-106)."""
    root = Path(root)
    out: list[list[str]] = []

    vocalset = root / "VocalSet1-2"
    if vocalset.is_dir():
        files: list[str] = []
        for singer_dir in (vocalset / "data_by_singer").glob("*"):
            if singer_dir.name in VOCALSET_SPLITS[mode]:
                files += [str(p) for p in singer_dir.glob("*/*/*.wav")]
        log.info("Found %d files in VocalSet %s.", len(files), mode)
        out.append(sorted(files))

    guitarset = root / "audio_mono-mic"
    if guitarset.is_dir():
        files = [
            str(p)
            for p in guitarset.glob("*.wav")
            if p.name.split("_")[0] in GUITARSET_SPLITS[mode]
        ]
        log.info("Found %d files in GuitarSet %s.", len(files), mode)
        out.append(sorted(files))

    dsd = root / "DSD100" / "DSD100"
    if dsd.is_dir():
        files = [str(p) for p in (dsd / mode).rglob("*.wav")]
        log.info("Found %d files in DSD100 %s.", len(files), mode)
        out.append(sorted(files))

    idmt = root / "IDMT-SMT-DRUMS-V2"
    if idmt.is_dir():
        files = [
            str(p)
            for p in (idmt / "audio").glob("*.wav")
            if p.name.split("_")[0] in IDMT_DRUMS_SPLITS[mode]
        ]
        log.info("Found %d files in IDMT-SMT-Drums %s.", len(files), mode)
        out.append(sorted(files))

    return out


def select_random_chunk(
    rng: np.random.Generator, audio_file: str, chunk_size: int, sample_rate: int
) -> np.ndarray | None:
    """Random energy-gated chunk from a file, resampled to ``sample_rate``.

    Returns ``(channels, chunk_size)`` float32 or None when the file is
    too short or the chunk is near-silent (mean |x| < 1e-4), mirroring
    the reference's rejection loop (remfx/utils.py:120-135).
    """
    audio, sr = read_wav(audio_file)
    src_chunk = int(chunk_size * (sr / sample_rate))
    if src_chunk >= audio.shape[-1]:
        return None
    start = int(rng.integers(0, audio.shape[-1] - src_chunk))
    chunk = audio[:, start : start + src_chunk]
    if np.mean(np.abs(chunk)) < 1e-4:
        return None
    if sr != sample_rate:
        chunk = np.asarray(resample(chunk, sr, sample_rate), np.float32)
    return np.asarray(chunk[:, :chunk_size], np.float32)


def synthetic_chunk(
    rng: np.random.Generator, chunk_size: int, sample_rate: int
) -> np.ndarray:
    """Deterministic synthetic source chunk ``(1, chunk_size)``: a few
    enveloped harmonics plus band-limited noise — spectrally rich enough
    for the MRSTFT redraw check and classifier training, with no
    downloads (SURVEY.md §4 test-strategy point (d))."""
    t = np.arange(chunk_size, dtype=np.float32) / sample_rate
    x = np.zeros(chunk_size, np.float32)
    f0 = float(rng.uniform(80.0, 500.0))
    for h in range(1, 5):
        amp = float(rng.uniform(0.1, 0.5)) / h
        phase = float(rng.uniform(0, 2 * np.pi))
        x += amp * np.sin(2 * np.pi * f0 * h * t + phase).astype(np.float32)
    # slow tremolo envelope so energy varies like real material
    env_rate = float(rng.uniform(0.5, 4.0))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * env_rate * t).astype(np.float32)
    x *= env
    noise = rng.standard_normal(chunk_size).astype(np.float32)
    a = float(rng.uniform(0.8, 0.99))  # one-pole lowpass -> band-limited noise
    x += 0.05 * _one_pole(noise, a, float(np.sqrt(1 - a * a)))
    peak = np.max(np.abs(x)) + 1e-9
    return (0.5 * x / peak)[None, :].astype(np.float32)


def _karplus_note(rng: np.random.Generator, n: int, freq: float,
                  sample_rate: int, decay: float) -> np.ndarray:
    """Karplus-Strong plucked string: noise-burst-initialized delay line
    with the classic two-tap averaging loop, iterated period-blockwise
    (vectorized: each period is derived from the previous in one numpy
    op, so synthesis is O(T) small-vector work, not a Python sample loop)."""
    D = max(2, int(round(sample_rate / freq)))
    prev = rng.uniform(-1.0, 1.0, D).astype(np.float32)
    out = np.empty(n, np.float32)
    pos = 0
    while pos < n:
        m = min(D, n - pos)
        out[pos:pos + m] = prev[:m]
        prev = (decay * 0.5) * (prev + np.roll(prev, 1))
        pos += m
    return out


def _pluck_phrase(rng: np.random.Generator, chunk_size: int,
                  sample_rate: int) -> np.ndarray:
    """A phrase of plucked-string notes (guitar-like material — the
    reference trains on GuitarSet; VERDICT r3 #3 asks the synthetic
    source to cover plucked timbres)."""
    x = np.zeros(chunk_size, np.float32)
    n_notes = int(rng.integers(4, 16))
    onsets = np.sort(rng.uniform(0, 0.9 * chunk_size, n_notes).astype(int))
    midi = rng.integers(40, 77, n_notes)  # E2..E5
    for on, m in zip(onsets, midi):
        freq = 440.0 * 2.0 ** ((float(m) - 69.0) / 12.0)
        length = min(chunk_size - on, int(rng.uniform(0.3, 2.0) * sample_rate))
        if length <= 0:
            continue
        note = _karplus_note(rng, length, freq, sample_rate,
                             decay=float(rng.uniform(0.990, 0.999)))
        amp = float(rng.uniform(0.3, 1.0))
        x[on:on + length] += amp * note
    return x


def _drum_pattern(rng: np.random.Generator, chunk_size: int,
                  sample_rate: int) -> np.ndarray:
    """Kick/snare/hat transients on a tempo grid (drum-like material —
    the reference trains on IDMT-SMT-Drums)."""
    x = np.zeros(chunk_size, np.float32)
    bpm = float(rng.uniform(70, 170))
    step = int(sample_rate * 60.0 / bpm / 2.0)  # 8th-note grid
    for pos in range(0, chunk_size, max(step, 1)):
        for kind in ("kick", "snare", "hat"):
            if rng.uniform() > {"kick": 0.45, "snare": 0.35, "hat": 0.6}[kind]:
                continue
            if kind == "kick":
                dur = int(rng.uniform(0.08, 0.3) * sample_rate)
                t = np.arange(dur, dtype=np.float32) / sample_rate
                f = 50.0 + 90.0 * np.exp(-t / 0.03)  # pitch sweep down
                hit = np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
                hit *= np.exp(-t / float(rng.uniform(0.05, 0.15)))
                amp = rng.uniform(0.6, 1.0)
            elif kind == "snare":
                dur = int(rng.uniform(0.06, 0.2) * sample_rate)
                t = np.arange(dur, dtype=np.float32) / sample_rate
                body = np.sin(2 * np.pi * float(rng.uniform(170, 260)) * t)
                noise = rng.standard_normal(dur).astype(np.float32)
                hit = (0.5 * body + 0.7 * noise) * np.exp(
                    -t / float(rng.uniform(0.03, 0.08)))
                amp = rng.uniform(0.4, 0.8)
            else:  # hat: differenced (high-passed) noise, fast decay
                dur = int(rng.uniform(0.02, 0.08) * sample_rate)
                t = np.arange(dur, dtype=np.float32) / sample_rate
                noise = rng.standard_normal(dur + 1).astype(np.float32)
                hit = np.diff(noise) * np.exp(-t / 0.02)
                amp = rng.uniform(0.15, 0.4)
            end = min(chunk_size, pos + dur)
            x[pos:end] += (amp * hit[: end - pos]).astype(np.float32)
    return x


def _real_file_chunk(rng: np.random.Generator, chunk_size: int,
                     sample_rate: int, path: str) -> np.ndarray:
    """A chunk of real recorded material with cheap diversity transforms
    (random resample factor = pitch/tempo shift, wraparound crop, gain):
    one vendored clip (demos/example_48k_mono.wav = the reference's
    example.wav) becomes a family of training sources instead of a
    single point (VERDICT r3 #3: the classifier detected nothing on real
    guitar — pure domain gap)."""
    audio, sr = read_wav(path)
    x = audio.mean(0) if audio.shape[0] > 1 else audio[0]
    rate = float(rng.uniform(0.7, 1.4)) * (sr / sample_rate)
    # linear-interp resample is plenty for *source* material diversity
    n_src = x.shape[-1]
    idx = np.arange(int(n_src / rate), dtype=np.float64) * rate
    idx = idx[idx < n_src - 1]
    lo = idx.astype(int)
    frac = (idx - lo).astype(np.float32)
    y = x[lo] * (1 - frac) + x[lo + 1] * frac
    start = int(rng.integers(0, max(1, y.shape[-1])))
    y = np.roll(y, -start)  # wraparound crop start
    reps = int(np.ceil(chunk_size / max(1, y.shape[-1])))
    y = np.tile(y, reps)[:chunk_size]
    return y.astype(np.float32)


def synthetic_chunk_rich(
    rng: np.random.Generator, chunk_size: int, sample_rate: int,
    real_files: tuple[str, ...] = (),
) -> np.ndarray:
    """Multi-family synthetic source ``(1, chunk_size)``: plucked-string
    phrases, drum patterns, the original harmonic tone, real-file chunks
    (when vendored clips are configured), and two-family mixtures —
    approximating the spread of the reference's VocalSet/GuitarSet/
    DSD100/IDMT starter sets (remfx/datasets.py:23-56) without downloads."""
    families = ["harmonic", "pluck", "drums", "mix"]
    weights = [0.2, 0.3, 0.2, 0.15]
    if real_files:
        families.append("real")
        weights.append(0.15)
    w = np.asarray(weights) / np.sum(weights)
    fam = families[int(rng.choice(len(families), p=w))]

    def draw(f):
        if f == "harmonic":
            return synthetic_chunk(rng, chunk_size, sample_rate)[0]
        if f == "pluck":
            return _pluck_phrase(rng, chunk_size, sample_rate)
        if f == "drums":
            return _drum_pattern(rng, chunk_size, sample_rate)
        if f == "real":
            path = real_files[int(rng.integers(0, len(real_files)))]
            return _real_file_chunk(rng, chunk_size, sample_rate, path)
        raise ValueError(f)

    if fam == "mix":  # DSD100-style two-source mixture
        pool = [f for f in families if f != "mix"]
        a, b = rng.choice(len(pool), 2, replace=False)
        x = draw(pool[int(a)]) + float(rng.uniform(0.3, 1.0)) * draw(pool[int(b)])
    else:
        x = draw(fam)
    peak = np.max(np.abs(x)) + 1e-9
    return (float(rng.uniform(0.25, 0.6)) * x / peak)[None, :].astype(np.float32)


def _one_pole(x: np.ndarray, a: float, b: float) -> np.ndarray:
    """y[n] = a y[n-1] + b x[n] in O(T log T) via FFT of the truncated
    exponential kernel (numerically exact to float32 for |a|<1)."""
    n = x.shape[-1]
    # kernel decays below float32 eps after log(eps)/log(a) taps
    klen = min(n, max(16, int(np.ceil(np.log(1e-9) / np.log(max(a, 1e-6))))))
    k = b * np.power(a, np.arange(klen, dtype=np.float64))
    size = 1 << int(np.ceil(np.log2(n + klen)))
    y = np.fft.irfft(np.fft.rfft(x, size) * np.fft.rfft(k, size), size)[:n]
    return y.astype(np.float32)


class ChunkSource:
    """Uniform interface over starter datasets vs synthetic material.

    ``sample(rng)`` -> mono ``(1, chunk_size)`` float32 chunk, retrying
    on energy-gate rejection like the reference's ``while chunk is
    None`` loop (remfx/datasets.py:428-441).
    """

    def __init__(self, root, mode: str, chunk_size: int, sample_rate: int,
                 synthetic: bool = False, rich: bool = False,
                 real_files: tuple[str, ...] = ()):
        self.chunk_size = int(chunk_size)
        self.sample_rate = int(sample_rate)
        self.synthetic = bool(synthetic) or root is None
        self.rich = bool(rich)
        self.real_files = tuple(
            str(p) for p in real_files if Path(p).is_file()
        )
        self.root = root
        self.mode = mode
        self.files: list[list[str]] = []
        if not self.synthetic:
            self.files = [fl for fl in locate_files(root, mode) if fl]
            # missing source data only matters if a chunk is actually
            # drawn — eval runs over pre-rendered datasets
            # (render_files=False) construct the dataset without any
            # starter audio present, like the reference's glob-only
            # locate_files (remfx/datasets.py:23-56)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        if self.synthetic:
            if self.rich:
                return synthetic_chunk_rich(
                    rng, self.chunk_size, self.sample_rate, self.real_files
                )
            return synthetic_chunk(rng, self.chunk_size, self.sample_rate)
        if not self.files:
            raise FileNotFoundError(
                f"no starter datasets under {self.root!r} for "
                f"mode={self.mode!r}; run scripts/download.py or set "
                "datamodule.synthetic=true"
            )
        chunk = None
        while chunk is None:
            dataset = self.files[int(rng.integers(0, len(self.files)))]
            path = dataset[int(rng.integers(0, len(dataset)))]
            chunk = select_random_chunk(
                rng, path, self.chunk_size, self.sample_rate
            )
        if chunk.shape[0] > 1:  # sum to mono (reference datasets.py:439-441)
            chunk = chunk.sum(0, keepdims=True)
        if chunk.shape[-1] < self.chunk_size:
            chunk = np.pad(chunk, [(0, 0), (0, self.chunk_size - chunk.shape[-1])])
        return chunk.astype(np.float32)
