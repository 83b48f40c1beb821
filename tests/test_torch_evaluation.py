"""The port's evaluation battery (``diffbinaural_tpu_torch/evaluation``) and
the two evaluate CLIs against the JAX package's, float64 on the CPU, on the
JAX tests' signals (``tests/test_evaluation.py``: ``_stereo``, 0.1·N(0, 1)
per channel, and ``_speechy``, two tones under a 3 Hz envelope) at 1–2 s.

Tolerances: the spectral, envelope, SNR, IACC and ILD metrics 1e-10
relative (the two sides' FFTs and sums round differently in the last
digits); ITD the same peaks (the same integer lags) and 1e-10; BSS
SDR / SIR / SAR 1e-8 dB at ``flen`` 512 and the same permutation; PESQ MOS
1e-9; the resampler 1e-12 of ``scipy.signal.resample_poly``.

One deliberate divergence: the port's STFT gives the bins that are real by
symmetry (DC, n_fft / 2, and every bin of the first frame, which the
centred reflect pad makes even) an imaginary part of exactly +0, where
numpy's FFT leaves round-off of either sign that flips a negative bin's
angle between π and −π.  The phase RMSE is therefore held against the JAX
formula on the JAX STFT with the same bins made real
(``_jax_stft_real_bins``)."""

import csv

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from diffbinaural_tpu.cli import evaluate_binaural_22050 as jax_eval_cli
from diffbinaural_tpu.cli import evaluate_mel_spectrogram_rmse as jax_mel_cli
from diffbinaural_tpu.evaluation import mel_rmse as jax_mel_rmse
from diffbinaural_tpu.evaluation import metrics as jax_metrics
from diffbinaural_tpu.evaluation import pesq as jax_pesq
from diffbinaural_tpu.evaluation import runner as jax_runner
from diffbinaural_tpu_torch.cli import evaluate_binaural_22050 as eval_cli
from diffbinaural_tpu_torch.cli import evaluate_mel_spectrogram_rmse as mel_cli
from diffbinaural_tpu_torch.data.audio_io import save_wav
from diffbinaural_tpu_torch.evaluation import mel_rmse, metrics, pesq, runner

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

SR = 22050
REL = 1e-10
BSS_DB = 1e-8
PESQ_TOL = 1e-9
REAL_JAX_STFT = jax_metrics._stft


def _stereo(seed=0, t=SR):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((2, t))).astype(np.float64)


def _speechy(sr, seconds=2.0):
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
            + 0.1 * np.sin(2 * np.pi * 700 * t)).astype(np.float64)


def _pair(seed=0, t=SR):
    """(prediction, ground truth): ground truth 0.1·N(0, 1) with the right
    ear a 7-sample-delayed, attenuated left ear plus noise; the prediction
    the ground truth plus 3 % noise."""
    gt = _stereo(seed, t)
    gt[1] = 0.7 * np.roll(gt[0], 7) + 0.3 * gt[1]
    return gt + 0.03 * _stereo(seed + 1, t), gt


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _jax_stft_real_bins(y, n_fft, hop, win):
    """The JAX package's STFT with the bins that are real by symmetry made
    exactly real (the port's convention; see the module docstring)."""
    spec = REAL_JAX_STFT(y, n_fft, hop, win).copy()
    spec[0] = spec[0].real
    if n_fft % 2 == 0:
        spec[-1] = spec[-1].real
    centres = np.arange(spec.shape[1]) * hop
    spec[:, (centres == 0) | (centres == len(y) - 1)] = spec[
        :, (centres == 0) | (centres == len(y) - 1)].real
    return spec


def _close(got, want, rel=REL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=atol)


@pytest.mark.parametrize("name", [
    "STFT_RMSE_distance", "MEL_RMSE_distance", "Envelope_distance",
    "calculate_snr", "compute_iacc_difference", "compute_ild_error"])
@pytest.mark.parametrize("sr", [22050, 16000])
def test_metric_matches_jax(name, sr):
    pred, gt = _pair()
    args = {"calculate_snr": (gt, pred)}.get(name, (pred, gt))
    kwargs = {"STFT_RMSE_distance": {"sr": sr}, "MEL_RMSE_distance": {"sr": sr},
              "compute_ild_error": {"sr": sr}}.get(name, {})
    want = getattr(jax_metrics, name)(*args, **kwargs)
    got = getattr(metrics, name)(*map(_t, args), **kwargs)
    assert type(got) is type(want)
    _close(got, want)


@pytest.mark.parametrize("sr", [22050, 16000])
def test_stft_and_phase_rmse(sr, monkeypatch):
    """Every STFT bin within 1e-12 of the spectrum's scale; magnitude and
    phase RMSE against the JAX formula on the JAX STFT with the real bins
    made real.  Without that, the JAX phase RMSE of this pair differs:
    its first frame's negative bins fall at π or −π by round-off."""
    pred, gt = _pair()
    n_fft, hop, win = metrics._stft_params(sr)
    want_spec = REAL_JAX_STFT(pred[0], n_fft, hop, win)
    got_spec = metrics._stft(_t(pred[0]), n_fft, hop, win).numpy()
    assert got_spec.shape == want_spec.shape
    scale = np.abs(want_spec).max()
    np.testing.assert_allclose(got_spec, want_spec, rtol=0, atol=1e-12 * scale)
    got = metrics.STFT_phase_and_magnitude_RMSE_distance(_t(pred), _t(gt), sr)
    unsnapped = jax_metrics.STFT_phase_and_magnitude_RMSE_distance(pred, gt, sr)
    monkeypatch.setattr(jax_metrics, "_stft", _jax_stft_real_bins)
    want = jax_metrics.STFT_phase_and_magnitude_RMSE_distance(pred, gt, sr)
    _close(got, want)
    _close(got[0], unsnapped[0])  # the magnitudes do not care


def test_iacc_per_frame_matches_jax():
    pred, _ = _pair()
    want_mean, want = jax_metrics.compute_iacc(pred)
    got_mean, got = metrics.compute_iacc(_t(pred))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    _close(got.numpy(), want)
    _close(got_mean, want_mean)


def test_itd_matches_jax_with_clear_peaks():
    """The JAX test's known delay (right leads left by 10 samples) against
    zero delay, and the 7-sample pair: the same integer peaks, the
    interpolated lags and their errors within 1e-10."""
    rng = np.random.default_rng(0)
    mono = rng.standard_normal(SR)
    sig = np.stack([mono[:-10], mono[10:]])
    zero = np.stack([mono[:-10], mono[:-10]])
    for pred, gt in ((sig, zero), _pair()):
        want = jax_metrics.compute_itd_error(pred, gt)
        got = metrics.compute_itd_error(_t(pred), _t(gt))
        _close(got, want, atol=1e-12)
    assert abs(abs(got[2]) - 7) < 1.0 or abs(abs(got[3]) - 7) < 1.0


def test_align_signals_matches_jax():
    x = _stereo(0, 4000)
    for shifted in (x[:, 100:], np.pad(x, ((0, 0), (37, 0)))):
        g_w, p_w, lag_w = jax_metrics.align_signals(x, shifted)
        g, p, lag = metrics.align_signals(_t(x), _t(shifted))
        assert lag == lag_w
        np.testing.assert_array_equal(g.numpy(), g_w)
        np.testing.assert_array_equal(p.numpy(), p_w)


@pytest.mark.parametrize("case", ["noisy", "swapped"])
def test_bss_eval_sources_matches_jax(case):
    """flen 512 on 1 s of the noisy pair, and on the swapped pair (the
    permutation search picks [1, 0]); both modes of the search."""
    pred, gt = _pair()
    if case == "swapped":
        pred = pred[::-1].copy()
    for perm_search in (True, False):
        want = jax_metrics.bss_eval_sources(gt, pred, 512, perm_search)
        got = metrics.bss_eval_sources(_t(gt), _t(pred), 512, perm_search)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=BSS_DB)
        np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert list(got[3]) == [0, 1]
    if case == "swapped":
        assert list(metrics.bss_eval_sources(_t(gt), _t(pred), 512)[3]) == [1, 0]
    sar_w = jax_metrics.compute_sar_sir_sdr(pred, gt)
    _close(metrics.compute_sar_sir_sdr(_t(pred), _t(gt)), sar_w, rel=0,
           atol=BSS_DB)


def test_bss_rank_deficient_branch_matches_lstsq(monkeypatch):
    """Where the solve fails: the port's least-norm ``pinv`` against the
    JAX package's ``lstsq(rcond=None)``, on the same decomposition."""
    pred, gt = _pair(3, 8000)

    def singular(*a, **k):
        raise np.linalg.LinAlgError("singular")

    def singular_t(*a, **k):
        raise torch.linalg.LinAlgError("singular")

    monkeypatch.setattr(jax_metrics.np.linalg, "solve", singular)
    monkeypatch.setattr(metrics.torch.linalg, "solve", singular_t)
    want = jax_metrics.bss_eval_sources(gt, pred, 64)
    got = metrics.bss_eval_sources(_t(gt), _t(pred), 64)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=BSS_DB)


def test_sar_sir_sdr_scores_numeric_failures_only(monkeypatch, capsys):
    """A numeric failure of the decomposition scores zeros, as the JAX
    package does; any other error (a device fault) propagates."""
    pred, gt = (_t(a) for a in _pair(0, 4000))

    def raising(exc):
        def fn(*a, **k):
            raise exc
        return fn

    for exc in (torch.linalg.LinAlgError("no convergence"), ValueError("x")):
        monkeypatch.setattr(metrics, "bss_eval_sources", raising(exc))
        assert metrics.compute_sar_sir_sdr(pred, gt) == (0.0, 0.0, 0.0)
    assert "Error computing SDR" in capsys.readouterr().out
    monkeypatch.setattr(metrics, "bss_eval_sources",
                        raising(RuntimeError("CUDA error: an illegal memory "
                                             "access was encountered")))
    with pytest.raises(RuntimeError, match="CUDA error"):
        metrics.compute_sar_sir_sdr(pred, gt)


def test_silent_estimate_scores_zeros_as_in_jax():
    """A silent prediction leaves every SIR NaN: no permutation wins, and
    both packages score (0, 0, 0)."""
    _, gt = _pair(0, 4000)
    silent = np.zeros_like(gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = jax_metrics.compute_sar_sir_sdr(silent, gt, flen=64)
        got = metrics.compute_sar_sir_sdr(_t(silent), _t(gt), flen=64)
        with pytest.raises(ValueError, match="finite mean SIR"):
            metrics.bss_eval_sources(_t(gt), _t(silent), 64)
    assert got == want == (0.0, 0.0, 0.0)


def test_metrics_take_tensors_only():
    pred, gt = _pair(0, 4000)
    with pytest.raises(TypeError, match="tensors"):
        metrics.STFT_RMSE_distance(pred, gt)


@pytest.mark.parametrize("n,up,down", [(int(1.5 * SR), 320, 441),
                                       (SR + 7, 320, 441), (1001, 2, 3),
                                       (999, 3, 2)])
def test_resample_poly_matches_scipy(n, up, down):
    x = np.random.default_rng(n).standard_normal(n)
    want = resample_poly(x, up, down)
    got = pesq.resample_poly(_t(x), up, down).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["clean", "snr40", "snr10", "shifted",
                                  "16k"])
def test_pesq_matches_jax(case):
    sr = 16000 if case == "16k" else SR
    clean = _speechy(sr)
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(len(clean))
    noise *= np.sqrt((clean ** 2).mean() / (noise ** 2).mean())
    deg = {"clean": clean, "snr40": clean + 0.01 * noise,
           "snr10": clean + 10 ** -0.5 * noise, "16k": clean + 0.1 * noise,
           "shifted": np.r_[np.zeros(100), clean][: len(clean)]}[case]
    want = jax_pesq.pesq_style_mos(clean, deg, sr)
    got = pesq.pesq_style_mos(_t(clean), _t(deg), sr)
    assert isinstance(got, float)
    assert abs(got - want) < PESQ_TOL


def test_bark_powers_match_jax():
    """Within 1e-10 of the band powers' scale (the quiet bands hold FFT
    round-off, 1e-14 of it)."""
    x = _speechy(16000, 1.0)
    want = jax_pesq._bark_powers(x)
    np.testing.assert_allclose(pesq._bark_powers(_t(x)).numpy(), want,
                               rtol=0, atol=REL * np.abs(want).max())
    with pytest.raises(ValueError, match="shorter than one"):
        pesq._bark_powers(_t(x[:100]))


def test_evaluate_binaural_pair_matches_jax():
    """The whole battery with BSS and PESQ on 1 s of the pair; the phase
    RMSE with the JAX STFT's real bins made real."""
    pred, gt = _pair()
    got = runner.evaluate_binaural_pair(_t(pred), _t(gt), SR, True, True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_metrics, "_stft", _jax_stft_real_bins)
        want = jax_runner.evaluate_binaural_pair(pred, gt, SR, True, True)
    assert list(got) == list(want)
    for k in want:
        tol = {"sar": BSS_DB, "sir": BSS_DB, "sdr": BSS_DB,
               "pesq_mos": PESQ_TOL}.get(k)
        if tol is None:
            _close(got[k], want[k], atol=1e-15)
        else:
            assert abs(got[k] - want[k]) < tol, k


def test_mel_rmse_pair_and_helpers_match_jax():
    rng = np.random.default_rng(5)
    gt = _stereo(2, 40 * 256)
    pl, pr = ((rng.standard_normal((80, 40)) - 4).astype(np.float32)
              for _ in range(2))
    want = jax_mel_rmse.evaluate_mel_rmse_pair(pl, pr, gt)
    got = mel_rmse.evaluate_mel_rmse_pair(torch.from_numpy(pl),
                                          torch.from_numpy(pr), _t(gt))
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    for name in ("basketball_m40_10.npy", "speech_5_2.npy", "x_m3b.npy"):
        assert mel_rmse.map_pred_to_gt_name(name) == \
            jax_mel_rmse.map_pred_to_gt_name(name)
    for values in ([1.0, float("nan"), 3.0], [float("inf")], []):
        got_s = mel_rmse.nan_safe_stats(values)
        want_s = jax_mel_rmse.nan_safe_stats(values)
        assert got_s.keys() == want_s.keys()
        np.testing.assert_equal(list(got_s.values()), list(want_s.values()))


# ---------------------------------------------------------------------------
# the two evaluate CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """Two clips of 1.2 s: GT stereo wavs, generated wavs (the GT delayed by
    3 samples plus noise; ``x_binaural_generated.wav`` has no GT), and
    predicted L/R mels (``{vid}_m40_1.npy`` maps to the GT name)."""
    from diffbinaural_tpu_torch.signal.stft import mel_spectrogram

    root = tmp_path_factory.mktemp("evalworld")
    n = int(1.2 * SR)
    for i, vid in enumerate(("c0", "c1")):
        pred, gt = _pair(10 + i, n)
        save_wav(str(root / "gt" / f"{vid}_0_1.wav"), gt.astype(np.float32),
                 SR)
        save_wav(str(root / "gen" / f"{vid}_0_1_binaural_generated.wav"),
                 np.roll(pred, 3, axis=1).astype(np.float32), SR)
        mels = mel_spectrogram(torch.from_numpy(gt.astype(np.float32)))
        mels = mels.numpy() + 0.2 * np.random.default_rng(i).standard_normal(
            mels.shape).astype(np.float32)
        for side, mel in zip(("left", "right"), mels):
            (root / side).mkdir(exist_ok=True)
            np.save(root / side / f"{vid}_m40_1.npy", mel)
    save_wav(str(root / "gen" / "x_binaural_generated.wav"),
             np.zeros((2, SR), np.float32), SR)
    return root


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_csvs_close(got_path, want_path, tols):
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0] and len(got) == len(want) > 1
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(got[0], g_row, w_row):
            try:
                wv = float(w)
            except ValueError:
                assert g == w, col
                continue
            tol = tols.get(col, tols.get(g_row[0], None))
            if tol is None:
                np.testing.assert_allclose(float(g), wv, rtol=REL, atol=1e-15,
                                           err_msg=f"{g_row[0]} {col}")
            else:
                assert abs(float(g) - wv) <= tol, (g_row[0], col, g, w)


def test_evaluate_binaural_cli_matches_jax(eval_world, tmp_path, monkeypatch,
                                           capsys):
    """``--pesq`` with BSS on: the per-file CSV and ``_summary.csv`` in the
    JAX CLI's columns and order, every value within the metrics'
    tolerances.  The JAX runner reads the wavs in float32 and computes
    the envelope, SNR, IACC and BSS partly in float32 from them; the port
    computes every metric in float64, so the JAX side is given float64
    samples here (``load_wav`` promoted), and its STFT the real bins."""
    argv = ["--generated_dir", str(eval_world / "gen"), "--gt_dir",
            str(eval_world / "gt"), "--pesq"]
    load = jax_runner.load_wav
    monkeypatch.setattr(jax_runner, "load_wav", lambda *a, **k: (
        load(*a, **k)[0].astype(np.float64), load(*a, **k)[1]))
    monkeypatch.setattr(jax_metrics, "_stft", _jax_stft_real_bins)
    jax_eval_cli.main(argv + ["--output_csv", str(tmp_path / "jax.csv")])
    jax_out = capsys.readouterr().out
    eval_cli.main(argv + ["--output_csv", str(tmp_path / "port.csv")],
                  device="cpu")
    port_out = capsys.readouterr().out
    tols = {"sar": BSS_DB, "sir": BSS_DB, "sdr": BSS_DB, "pesq_mos": PESQ_TOL}
    _assert_csvs_close(tmp_path / "port.csv", tmp_path / "jax.csv", tols)
    _assert_csvs_close(tmp_path / "port_summary.csv",
                       tmp_path / "jax_summary.csv", tols)
    rows = _read_csv(tmp_path / "port.csv")
    assert [r[0] for r in rows[1:]] == [
        "c0_0_1_binaural_generated.wav", "c1_0_1_binaural_generated.wav"]
    assert "[WARNING] no GT for x_binaural_generated.wav" in port_out
    assert port_out.count("\n") == jax_out.count("\n")


def test_evaluate_mel_rmse_cli_matches_jax(eval_world, tmp_path, capsys):
    argv = ["--pred_left_dir", str(eval_world / "left"), "--pred_right_dir",
            str(eval_world / "right"), "--gt_audio_dir", str(eval_world / "gt")]
    jax_mel_cli.main(argv + ["--output_csv", str(tmp_path / "jax.csv")])
    jax_out = capsys.readouterr().out
    mel_cli.main(argv + ["--output_csv", str(tmp_path / "port.csv")],
                 device="cpu")
    port_out = capsys.readouterr().out
    _assert_csvs_close(tmp_path / "port.csv", tmp_path / "jax.csv", {})
    assert len(_read_csv(tmp_path / "port.csv")) == 3
    assert port_out == jax_out  # 4 decimals of the same summary
