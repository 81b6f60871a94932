"""The port's entry points (``remfx_tpu_torch/cli``) against the JAX
package's scripts, on the CPU (``accelerator=cpu``).

* ``demo_detect`` on a 32768-sample crop of
  ``demos/synth_distortion_reverb.wav`` (target ``demos/synth_target.wav``)
  with every vendored trained slot and the trained Cnn14: the detected
  effects, the removed ones and the input SI-SDR of the JAX script's
  computation, and the output SI-SDR within 0.05 dB of it; the ``slow``
  test does the same on the whole clip (262144 samples).
* ``remfx_detect`` on 60000 samples streamed in three windows of 32768
  that overlap by the default 16384 (the trained classifier, TCN and
  Large-DCUNet-20 reverb): the wav it writes
  equals JAX's ``stream_chain`` output to 1e-4 x its RMS, and it prints
  JAX's effects.
* ``chain_inference`` on a tiny synthetic test set: finite means of the
  five metrics, written by the CSV logger.
* ``chip_smoke.trained_dirs``: the slots it expects are demo_detect's map
  both in a full checkout (HDemucs' ckpt present) and in the copy that
  ``.chiprunignore`` trims (no HDemucs); a missing admitted ckpt fails.
* ``chip_smoke.eval_matrix_argv`` gives the evaluation matrix every
  vendored slot of both layouts and says whether the compressor slot is
  trained or seeded.
* ``chip_smoke.attention_kernels`` picks the fused-attention or softmax
  kernels out of a trace's names, and ``chip_smoke.tf32`` switches TF32
  on and back.
"""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu.chain.build import build_chain as jax_build_chain
from remfx_tpu.chain.stream import stream_chain as jax_stream_chain
from remfx_tpu.losses import si_sdr as jax_si_sdr
from remfx_tpu.utils.crop import causal_crop as jax_causal_crop
from remfx_tpu_torch.cli import chain_inference, demo_detect, remfx_detect
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.data.wav import read_wav, write_wav

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY_TCN = ("{'model': {'name': 'tcn', 'network': {'nblocks': 3, "
            "'channel_width': 8, 'kernel_size': 3, 'dilation_growth': 2}}}")


@pytest.fixture
def in_repo(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("REMFX_ALLOW_RANDOM_CKPT", raising=False)


def _jax_demo(audio, target):
    """scripts/demo_detect.py's computation on arrays, with its chain."""
    cfg = demo_detect.trained_cfg(parse_cli(["+exp=remfx_detect"]))
    x = jnp.asarray(audio)[None]
    chain = jax_build_chain(copy.deepcopy(cfg), x)
    labels = chain.detect(x)
    y, _ = chain.remove(x, labels)
    lab = np.asarray(labels)[0]
    dry = jnp.asarray(target)[None]
    T = y.shape[-1]
    dry_c = jax_causal_crop(dry, T)
    in_c = jax_causal_crop(x, T)
    return {"detected_effects": [e for e, v in zip(ALL_EFFECTS, lab) if v > 0.5],
            "input_si_sdr_db": float(jnp.mean(jax_si_sdr(in_c, dry_c))),
            "output_si_sdr_db": float(jnp.mean(jax_si_sdr(y, dry_c)))}


def _check_demo(tmp_path, n):
    x, _ = read_wav(ROOT / "demos" / "synth_distortion_reverb.wav")
    d, _ = read_wav(ROOT / "demos" / "synth_target.wav")
    x, d = x[:, :n], d[:, :n]
    write_wav(tmp_path / "in.wav", x, 48000)
    write_wav(tmp_path / "dry.wav", d, 48000)
    out = tmp_path / "out.wav"
    report = demo_detect.main([
        "+exp=remfx_detect", "accelerator=cpu", f"+audio_input={tmp_path / 'in.wav'}",
        f"+target={tmp_path / 'dry.wav'}", f"+output_path={out}"])
    want = _jax_demo(x, d)
    assert report["detected_effects"] == want["detected_effects"]
    if n == 262144:  # the clip's true effects (demos/README.md); a crop
        # shorter than the reverb's tail need not show them
        assert {"distortion", "reverb"} <= set(report["detected_effects"])
    # every detected effect has a vendored remover; all five are vendored
    assert report["removed"] == [e for e in ("distortion", "compressor", "reverb",
                                             "chorus", "delay")
                                 if e in report["detected_effects"]]
    assert abs(report["input_si_sdr_db"] - want["input_si_sdr_db"]) <= 0.0051
    assert abs(report["output_si_sdr_db"] - want["output_si_sdr_db"]) <= 0.05
    y, sr = read_wav(out)
    assert sr == 48000 and y.shape == (1, n - 6138) and np.isfinite(y).all()
    assert set(report["probs"]) == set(ALL_EFFECTS)


def test_demo_detect_matches_jax(in_repo, tmp_path):
    _check_demo(tmp_path, 32768)


@pytest.mark.slow
def test_demo_detect_matches_jax_on_the_whole_clip(in_repo, tmp_path):
    _check_demo(tmp_path, 262144)


def test_remfx_detect_writes_jax_stream_output(in_repo, tmp_path, capsys):
    x, _ = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    x = x[:, :60000]
    write_wav(tmp_path / "in.wav", x, 48000)
    ckpts = ("{'RandomPedalboardDistortion': {'model': 'tcn', 'ckpt_path': "
             "'ckpts/tcn_distortion_aug'}, 'RandomPedalboardReverb': {'model': "
             "'dcunet', 'ckpt_path': 'ckpts/dcunet_reverb_aug_r4'}}")
    args = ["+exp=remfx_detect", f"ckpts={ckpts}",
            "classifier_ckpt=ckpts/classifier_cnn14_r5", "stream_chunk=32768"]
    remfx_detect.main(args + ["accelerator=cpu", f"+audio_input={tmp_path / 'in.wav'}",
                              f"+output_path={tmp_path / 'out.wav'}"])
    printed = capsys.readouterr().out
    got, sr = read_wav(tmp_path / "out.wav")

    cfg = parse_cli(args)
    jc = jax_build_chain(cfg, jnp.zeros((1, 1, 32768)))
    want, labels = jax_stream_chain(jc, x.sum(0, keepdims=True), chunk=32768)
    present = [n for n in jc.effect_order
               if labels[ALL_EFFECTS.index(EFFECT_CLASS_NAMES[n])] > 0.5]
    assert f"Detected effects: {present}" in printed
    assert sr == 48000 and got.shape == want.shape == (1, 60000)
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))


def test_chain_inference_logs_mean_metrics(monkeypatch, tmp_path):
    monkeypatch.setenv("REMFX_ALLOW_RANDOM_CKPT", "1")
    means = chain_inference.main([
        "+exp=remfx_oracle", "accelerator=cpu", "datamodule.synthetic=true",
        "datamodule.dataset_type=dynamic", "datamodule.test_chunks=2",
        "datamodule.test_batch_size=2", "chunk_size=8192",
        "effects_to_remove=['distortion']", "num_removed_effects=[1,1]",
        "render_files=true", f"render_root={tmp_path}/data", f"logs_dir={tmp_path}",
        "ckpts={'RandomPedalboardDistortion': " + TINY_TCN + "}"])
    assert set(means) == {"test_loss", "test_SISDR", "test_STFT", "Input_SISDR",
                          "Input_STFT"}
    assert all(np.isfinite(v) for v in means.values())
    rows = list(tmp_path.rglob("metrics.csv"))
    assert rows and "test_SISDR" in rows[0].read_text()


@pytest.mark.parametrize("with_compressor", [True, False],
                         ids=["full_checkout", "trimmed_copy"])
def test_chip_smoke_trained_slots_follow_demo_detect(monkeypatch, tmp_path,
                                                     with_compressor):
    import chip_smoke

    names = chip_smoke.TRAINED_DIRS + (chip_smoke.COMPRESSOR_DIR,) * with_compressor
    for name in names:
        (tmp_path / "ckpts" / name / "variables").mkdir(parents=True)
        (tmp_path / "ckpts" / name / "hparams.json").write_text("{}")
    monkeypatch.chdir(tmp_path)
    dirs, slots = chip_smoke.trained_dirs(tmp_path)
    cfg = demo_detect.trained_cfg(parse_cli(["+exp=remfx_detect"]))
    assert dirs == names
    assert sorted(cfg["ckpts"]) == sorted(slots)
    assert ("RandomPedalboardCompressor" in slots) == with_compressor
    assert cfg["classifier_ckpt"] == "ckpts/classifier_cnn14_r5"

    (tmp_path / "ckpts" / "dcunet_delay_aug_r5" / "hparams.json").unlink()
    with pytest.raises(RuntimeError, match="dcunet_delay_aug_r5"):
        chip_smoke.trained_dirs(tmp_path)


@pytest.mark.parametrize("with_compressor", [True, False],
                         ids=["full_checkout", "trimmed_copy"])
def test_chip_smoke_eval_matrix_names_every_vendored_slot(monkeypatch, tmp_path,
                                                          with_compressor):
    """The eval_matrix phase hands the CLI every vendored slot of the
    checkout and the trained classifier, and says whether the compressor
    slot is trained (HDemucs' directory present) or seeded."""
    import chip_smoke
    from remfx_tpu_torch.cli import eval_matrix

    names = chip_smoke.TRAINED_DIRS + (chip_smoke.COMPRESSOR_DIR,) * with_compressor
    for name in names:
        (tmp_path / "ckpts" / name / "variables").mkdir(parents=True)
        (tmp_path / "ckpts" / name / "hparams.json").write_text("{}")
    argv, compressor = chip_smoke.eval_matrix_argv(tmp_path / "run", tmp_path)
    assert compressor == ("trained" if with_compressor else "seeded")
    args = eval_matrix.parse_args(argv)
    assert (args.n, args.variants, args.test_chunks, args.batch) == (
        "0,1", "oracle,detect,all", 16, 8)
    assert args.accelerator is None  # the card
    cfg = eval_matrix.build_cfg(args, "remfx_detect", 1)
    vendored = {k: v["ckpt_path"] for k, v in cfg["ckpts"].items()
                if not v["ckpt_path"].endswith(".ckpt")}
    assert vendored == {slot: f"ckpts/{name}" for slot, name in zip(
        chip_smoke.TRAINED_SLOTS + (chip_smoke.COMPRESSOR_SLOT,) * with_compressor,
        names[1:])}
    assert cfg["classifier_ckpt"] == "ckpts/classifier_cnn14_r5"
    assert cfg["chunk_size"] == chip_smoke.T and cfg["num_removed_effects"] == [1, 1]


MEM_EFFICIENT = "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel)"


@pytest.mark.parametrize("counts, want", [
    ({MEM_EFFICIENT: 4, "ampere_sgemm_128x64_nn": 8, "elementwise_kernel": 30},
     {MEM_EFFICIENT: 4}),
    ({"void flash_fwd_kernel<Flash_fwd_kernel_traits>(Flash_fwd_params)": 2, "gemm": 1},
     {"void flash_fwd_kernel<Flash_fwd_kernel_traits>(Flash_fwd_params)": 2}),
    ({"ampere_sgemm_128x64_tn": 4, "void softmax_warp_forward<float>(float*)": 4},
     {"void softmax_warp_forward<float>(float*)": 4}),
    ({"x" * 150 + "_fmha_a": 1, "x" * 150 + "_fmha_b": 2}, {"x" * 100: 3}),
], ids=["mem_efficient", "flash", "math", "name_cut"])
def test_chip_smoke_attention_kernels_name_the_backend(counts, want):
    """The dptnet phase reports which attention backend its sample ran:
    the fused kernels by name, or the math path's softmax."""
    import chip_smoke

    assert chip_smoke.attention_kernels(counts) == want


def test_chip_smoke_tf32_switches_back():
    import chip_smoke

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with chip_smoke.tf32():
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
