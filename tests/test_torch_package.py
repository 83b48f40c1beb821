"""The port stands alone: it imports nothing of JAX or of the JAX package,
its entry points do not run on the CPU unless asked to, and its kernel
wrappers take their plain versions only for tensors that lie on the CPU."""

import pathlib
import subprocess
import sys

import pytest
import torch

import diffbinaural_tpu_torch
from diffbinaural_tpu_torch import ops
from diffbinaural_tpu_torch.core.config import UnetConfig, VocoderConfig
from diffbinaural_tpu_torch.core.device import resolve_device

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = pathlib.Path(diffbinaural_tpu_torch.__file__).resolve().parent


def _sources():
    """The package's Python files; ``build/`` holds what the kernels' build
    leaves behind and is no part of the package."""
    return [p for p in sorted(PACKAGE.rglob("*.py"))
            if "build" not in p.relative_to(PACKAGE).parts]


def _modules():
    names = []
    for path in _sources():
        rel = path.relative_to(PACKAGE.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax():
    names = _modules()
    assert len(names) >= 20
    for sub in ("train", "train.stage1", "train.stage2", "train.stabilizer",
                "data", "data.audio_io", "signal.stft", "signal.cqt",
                "losses", "losses.gan", "losses.multiscale_mel",
                "losses.silence", "losses.binaural_enhanced",
                "models.discriminators", "core.serialization",
                "core.checkpoint", "cli", "cli.common", "models.visual",
                "data.clip_tokenizer", "cli.generate_binaural",
                "cli.inference_e2e", "cli.inference_binaural",
                "cli.inference_diffbinaural_mels", "native",
                "data.meldataset", "data.binaural", "data.stage1",
                "data.loader", "data.video_transforms",
                "data.position_utils", "utils", "utils.helpers",
                "utils.summary", "cli.arguments", "cli.gan_common",
                "cli.train_realbinaural", "cli.train_fairplay",
                "cli.train_binaural_mel", "cli.train_binaural_both",
                "utils.profiling", "evaluation", "evaluation.metrics",
                "evaluation.mel_rmse", "evaluation.pesq", "evaluation.runner",
                "cli.evaluate_binaural_22050",
                "cli.evaluate_mel_spectrogram_rmse", "cli.test_realbinaural",
                "cli.test_fairplay", "cli.test_pos",
                "cli.test_realbinaural_few", "models.norms",
                "core.advanced_diffusion_config", "parallel",
                "parallel.mesh"):
        assert f"diffbinaural_tpu_torch.{sub}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'matplotlib', "
        "'diffbinaural_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('imported', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


def test_sources_name_no_jax_import():
    """No source names JAX, its libraries or the JAX package; none names
    matplotlib (the card's machine has none) except ``utils/helpers.py``,
    whose figure functions import it inside, as the JAX ones do."""
    for path in _sources() + [ROOT / "chip_smoke.py"]:
        forbidden = ("jax", "jaxlib", "flax", "optax", "msgpack",
                     "diffbinaural_tpu")
        if path != PACKAGE / "utils" / "helpers.py":
            forbidden += ("matplotlib",)
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in forbidden, (path, line)


def test_importing_builds_and_loads_nothing():
    from diffbinaural_tpu_torch.ops import _build

    assert _build._loaded == {}
    assert {p.suffix for p in _build.CSRC.iterdir()} <= {".cu", ".cuh"}
    for name, (src, fns) in _build.KERNELS.items():
        text = (_build.CSRC / src).read_text()
        for fn in fns:
            assert f'extern "C" int {fn}(' in text, (name, fn)
        assert "cudaGetLastError()" in text
        assert "torch/extension.h" not in text


def test_tap_header_holds_the_designed_filter():
    from diffbinaural_tpu_torch.ops import _build
    from diffbinaural_tpu_torch.signal.filters import kaiser_sinc_filter1d

    header = _build._taps_header()
    taps = kaiser_sinc_filter1d(0.25, 0.3, 12)
    for i, v in enumerate(taps):
        assert f"#define AFA_H{i} ({float(v)!r}f)" in header


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


@pytest.mark.parametrize("entry", ["build_unet", "build_vocoder",
                                   "build_visual", "pipeline",
                                   "diffusion", "sampler", "vocoder",
                                   "train_step", "build_discriminators",
                                   "stage2_train_step", "generate_binaural",
                                   "inference_e2e", "inference_binaural",
                                   "inference_diffbinaural_mels",
                                   "train_realbinaural", "train_fairplay",
                                   "train_binaural_mel",
                                   "train_binaural_both",
                                   "evaluate_binaural_22050",
                                   "evaluate_mel_spectrogram_rmse",
                                   "test_realbinaural", "test_fairplay",
                                   "test_pos", "test_realbinaural_few",
                                   "evaluate_binaural_dirs",
                                   "evaluate_mel_rmse_dirs", "make_mesh"])
def test_entry_points_do_not_run_on_the_cpu_unasked(entry):
    _no_card()
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
    from diffbinaural_tpu_torch.infer import (BinauralPipeline, Stage1Sampler,
                                              Vocoder)
    from diffbinaural_tpu_torch.models import (build_discriminators,
                                               build_unet, build_visual,
                                               build_vocoder)
    from diffbinaural_tpu_torch.train import (make_stage1_train_step,
                                              make_stage2_train_step)
    from diffbinaural_tpu_torch.cli import (generate_binaural,
                                            inference_binaural,
                                            inference_diffbinaural_mels,
                                            inference_e2e, train_binaural_both,
                                            train_binaural_mel, train_fairplay,
                                            train_realbinaural)
    from diffbinaural_tpu_torch.cli import (evaluate_binaural_22050,
                                            evaluate_mel_spectrogram_rmse,
                                            test_fairplay, test_pos,
                                            test_realbinaural,
                                            test_realbinaural_few)
    from diffbinaural_tpu_torch.evaluation.mel_rmse import \
        evaluate_mel_rmse_dirs
    from diffbinaural_tpu_torch.evaluation.runner import \
        evaluate_binaural_dirs
    from diffbinaural_tpu_torch.parallel import make_mesh

    calls = {
        "build_unet": lambda: build_unet(UnetConfig(dim=16)),
        "build_vocoder": lambda: build_vocoder(VocoderConfig()),
        "build_visual": lambda: build_visual("clip_pos2d"),
        "pipeline": lambda: BinauralPipeline(None, None, 200),
        "diffusion": lambda: GaussianDiffusion(),
        "sampler": lambda: Stage1Sampler(None),
        "vocoder": lambda: Vocoder(),
        "train_step": lambda: make_stage1_train_step(torch.nn.Linear(2, 2)),
        "build_discriminators": lambda: build_discriminators(
            {"sampling_rate": 22050, "use_cqtd_instead_of_mrd": True}),
        "stage2_train_step": lambda: make_stage2_train_step(
            *(torch.nn.Linear(2, 2) for _ in range(3)), mel_fn=None,
            multiscale_mel_loss=lambda y, yh: 0.0),
        # the CLIs resolve the device before they read a file
        "generate_binaural": lambda: generate_binaural.main([
            "--input_wav", "x.wav", "--weights_unet", "u",
            "--vocoder_checkpoint", "g"]),
        "inference_e2e": lambda: inference_e2e.main(["--checkpoint_file",
                                                     "g"]),
        "inference_binaural": lambda: inference_binaural.main(
            ["--checkpoint_file", "g"]),
        "inference_diffbinaural_mels": lambda: inference_diffbinaural_mels.main(
            ["--input_mels_left_dir", "l", "--input_mels_right_dir", "r",
             "--checkpoint_file", "g"]),
        "train_realbinaural": lambda: train_realbinaural.main(
            ["--data_root", "missing"]),
        "train_fairplay": lambda: train_fairplay.main(
            ["--data_root", "missing"]),
        "train_binaural_mel": lambda: train_binaural_mel.main(
            ["--config", "missing.json"]),
        "train_binaural_both": lambda: train_binaural_both.main(
            ["--config", "missing.json"]),
        "evaluate_binaural_22050": lambda: evaluate_binaural_22050.main(
            ["--generated_dir", "missing", "--gt_dir", "missing"]),
        "evaluate_mel_spectrogram_rmse":
            lambda: evaluate_mel_spectrogram_rmse.main(
                ["--pred_left_dir", "l", "--pred_right_dir", "r",
                 "--gt_audio_dir", "g"]),
        "test_realbinaural": lambda: test_realbinaural.main(
            ["--data_root", "missing"]),
        "test_fairplay": lambda: test_fairplay.main(["--data_root", "missing"]),
        "test_pos": lambda: test_pos.main(["--data_root", "missing"]),
        "test_realbinaural_few": lambda: test_realbinaural_few.main(
            ["--data_root", "missing"]),
        "evaluate_binaural_dirs": lambda: evaluate_binaural_dirs("g", "t"),
        "evaluate_mel_rmse_dirs": lambda: evaluate_mel_rmse_dirs("l", "r",
                                                                 "g"),
        "make_mesh": lambda: make_mesh(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrappers_on_cpu_tensors_leave_launch_counts_at_zero():
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 16, 32)
    ops.flash_sdpa(q, q, q, 0.2)
    x = torch.randn(1, 128, 24)
    a = torch.zeros(128)
    ops.fused_alias_free_snake(x, a, a)
    w = torch.randn(128, 128, 3) * 0.02
    ops.fused_snake_conv(x, a, a, w, a, 1)
    ops.flash_sdpa_backward(q, q, q, *ops.flash_sdpa_with_lse(q, q, q, 0.2), q,
                            0.2)
    ops.fused_alias_free_snake_backward(x, x, a, a)
    ops.fused_snake_conv_backward(x, x, a, a, w, a, 1)
    # the autograd Functions on CPU tensors: forward and backward
    leaves = [t.clone().requires_grad_() for t in (x, a, w)]
    ops.fused_alias_free_snake(leaves[0], leaves[1], a).sum().backward()
    ops.fused_snake_conv(leaves[0], leaves[1], a, leaves[2], a).sum().backward()
    ops.snake_conv_dgrad(x, w, 1)
    ops.snake_conv_wgrad(x, x, 3, 1)
    assert ops.launch_counts() == {
        "flash_sdpa": 0, "flash_sdpa_with_lse": 0, "flash_sdpa_backward": 0,
        "fused_alias_free_snake": 0, "fused_alias_free_snake_backward": 0,
        "fused_snake_conv": 0, "fused_snake_conv_backward": 0,
        "snake_conv_dgrad": 0, "snake_conv_wgrad": 0}


def test_wrappers_never_take_the_plain_version_for_another_device():
    """A tensor that is neither on the CPU nor on a card is refused: the
    plain version is not a fallback."""
    q = torch.empty(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_sdpa(q, q, q, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_sdpa_with_lse(q, q, q, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_sdpa_backward(q, q, q, q, torch.empty(1, 2, 16, device="meta"),
                                q, 0.2)
    x = torch.empty(1, 128, 24, device="meta")
    a = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_alias_free_snake(x, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_snake_conv(x, a, a, torch.empty(128, 128, 3, device="meta"), a)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_alias_free_snake_backward(x, x, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_snake_conv_backward(
            x, x, a, a, torch.empty(128, 128, 3, device="meta"), a)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.snake_conv_dgrad(x, torch.empty(128, 128, 3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.snake_conv_wgrad(x, x, 3)
