"""The binaural metric battery on float64 tensors — counterpart of
``diffbinaural_tpu/evaluation/metrics.py``, with the same names and
returns (Python floats; ``compute_iacc`` also the per-frame tensor;
``bss_eval_sources`` tensors).

Every function takes tensors and runs on the device they lie on, in
float64 (inputs of another float type are promoted).  FFTs are
``torch.fft``; frames are ``unfold`` views.

  * STFT-RMSE on real / imaginary parts, magnitude + phase RMSE, MEL-RMSE
    with the canonical ln-mel frontend; their windows (periodic Hann) and
    the mel filterbank are the frontend's float32 arrays promoted to
    float64, as the JAX package computes them
  * Hilbert-envelope distance, SNR
  * IACC and its difference, frequency-weighted ILD error over six
    duplex-theory bands, GCC-PHAT ITD error (±1 ms, parabolic sub-sample
    interpolation); the ILD / ITD frames use the symmetric Hann window
    (``np.hanning``)
  * SDR / SIR / SAR: BSS Eval v3 (512-tap least-squares projections onto
    the reference subspaces) with mir_eval's permutation search
  * cross-correlation alignment
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..signal.stft import hann_window, mel_filterbank

F64 = torch.float64


def _f64(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError("the metrics take tensors, on the device they are to "
                        f"run on; got {type(x).__name__}")
    return x.to(F64)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A host constant as float64 on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64,
                           device=like.device)


def _reflect(y: torch.Tensor, pad: int) -> torch.Tensor:
    """``np.pad(y, pad, mode="reflect")`` along the last axis."""
    shape = y.shape
    out = F.pad(y.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
    return out.reshape(*shape[:-1], out.shape[-1])


def _frames(x: torch.Tensor, frame_size: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_size), ``(T - frame) // hop + 1``
    frames."""
    return x.unfold(-1, frame_size, hop)


# ---------------------------------------------------------------------------
# STFT helpers (librosa-compatible: centred, reflect pad, periodic Hann)
# ---------------------------------------------------------------------------


def _stft(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """librosa ``stft(center=True)`` of (..., T) -> (..., 1 + n_fft / 2,
    frames).

    The bins that are real by symmetry — DC and n_fft / 2, and every bin of
    a frame centred on the first or the last sample, which the reflect pad
    makes even — get an imaginary part of exactly +0.  The FFT leaves
    round-off of either sign there, and its sign decides whether a
    negative bin's angle is π or −π: in the JAX package (numpy's FFT) the
    phase RMSE depends on that round-off, here it does not, on any
    device."""
    window = _const(hann_window(win), y)
    if win < n_fft:
        pad = (n_fft - win) // 2
        window = F.pad(window, (pad, n_fft - win - pad))
    frames = _frames(_reflect(y, n_fft // 2), n_fft, hop)
    spec = torch.fft.rfft(frames * window, dim=-1).transpose(-1, -2)
    bins, n_frames = spec.shape[-2:]
    real = torch.zeros((bins, n_frames), dtype=torch.bool, device=y.device)
    real[0] = True
    if n_fft % 2 == 0:
        real[-1] = True
    centres = torch.arange(n_frames, device=y.device) * hop
    real[:, (centres == 0) | (centres == y.shape[-1] - 1)] = True
    return torch.complex(spec.real, torch.where(real, 0.0, spec.imag))


# ---------------------------------------------------------------------------
# spectral distances
# ---------------------------------------------------------------------------


def _stft_params(sr: int):
    if sr == 16000:
        return 512, 160, 400
    return 512, 256, 512


def _mean_over_channels(values) -> float:
    return float(torch.stack(values).mean())


def STFT_RMSE_distance(predicted, gt, sr: int = 22050) -> float:
    """RMSE of the real and imaginary STFT parts, averaged over L and R."""
    predicted, gt = _f64(predicted), _f64(gt)
    n_fft, hop, win = _stft_params(sr)
    dists = []
    for ch in range(2):
        p = _stft(predicted[ch], n_fft, hop, win)
        g = _stft(gt[ch], n_fft, hop, win)
        ri_p = torch.stack([p.real, p.imag])
        ri_g = torch.stack([g.real, g.imag])
        dists.append(torch.sqrt(torch.mean((ri_p - ri_g) ** 2)))
    return _mean_over_channels(dists)


def STFT_phase_and_magnitude_RMSE_distance(predicted, gt, sr: int = 22050):
    """(magnitude RMSE, phase RMSE), each averaged over L and R."""
    predicted, gt = _f64(predicted), _f64(gt)
    n_fft, hop, win = _stft_params(sr)
    mags, phases = [], []
    for ch in range(2):
        p = _stft(predicted[ch], n_fft, hop, win)
        g = _stft(gt[ch], n_fft, hop, win)
        mags.append(torch.sqrt(torch.mean((p.abs() - g.abs()) ** 2)))
        phases.append(torch.sqrt(torch.mean((p.angle() - g.angle()) ** 2)))
    return _mean_over_channels(mags), _mean_over_channels(phases)


def _ln_mel(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop: int,
            win: int) -> torch.Tensor:
    """The canonical compressed mel: reflect pad (n_fft - hop) / 2,
    center=False, sqrt(|.|² + 1e-9), Slaney mel, ln with a 1e-5 floor."""
    y = _f64(y)
    frames = _frames(_reflect(y, (n_fft - hop) // 2), n_fft, hop)
    spec = torch.fft.rfft(frames * _const(hann_window(win), y), dim=-1)
    spec = spec.transpose(-1, -2)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = _const(mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2), y)
    return torch.log(torch.clamp(basis @ mag, min=1e-5))


def MEL_RMSE_distance(predicted, gt, mel: int = 80, sr: int = 22050) -> float:
    """RMSE of the canonical ln-mels, averaged over L and R."""
    if sr == 16000:
        n_fft, hop, win = 512, 160, 512
    else:
        n_fft, hop, win = 1024, 256, 1024
    dists = []
    for ch in range(2):
        p = _ln_mel(predicted[ch], n_fft, mel, sr, hop, win)
        g = _ln_mel(gt[ch], n_fft, mel, sr, hop, win)
        dists.append(torch.sqrt(torch.mean((p - g) ** 2)))
    return _mean_over_channels(dists)


def _envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| of (T,): ``scipy.signal.hilbert`` as an FFT — the
    positive frequencies doubled, DC (and N/2 for even N) kept once, the
    negative ones zeroed."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=F64, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(x) * h).abs()


def Envelope_distance(predicted, gt) -> float:
    """RMSE of the Hilbert envelopes, averaged over L and R."""
    predicted, gt = _f64(predicted), _f64(gt)
    dists = []
    for ch in range(2):
        pe = _envelope(predicted[ch])
        ge = _envelope(gt[ch])
        n = min(pe.shape[-1], ge.shape[-1])
        dists.append(torch.sqrt(torch.mean((ge[:n] - pe[:n]) ** 2)))
    return _mean_over_channels(dists)


def calculate_snr(clean, noisy) -> float:
    """10·log10(Σ clean² / Σ (noisy − clean)²) over both channels; −inf
    for a silent ``clean``."""
    clean, noisy = _f64(clean), _f64(noisy)
    n = min(clean.shape[1], noisy.shape[1])
    clean, noisy = clean[:, :n], noisy[:, :n]
    sig = float(torch.sum(clean ** 2))
    noise = float(torch.sum((noisy - clean) ** 2))
    if sig == 0:
        return -math.inf
    return float(10 * np.log10(sig / max(noise, 1e-20)))


# ---------------------------------------------------------------------------
# binaural cue metrics
# ---------------------------------------------------------------------------


def compute_iacc(binaural, frame_size: int = 1024, hop_length: int = 512):
    """-> (mean IACC, per-frame IACC tensor), by FFT cross-correlation."""
    binaural = _f64(binaural)
    l, r = binaural[0], binaural[1]
    n = min(l.shape[-1], r.shape[-1])
    lf = _frames(l[:n], frame_size, hop_length)
    rf = _frames(r[:n], frame_size, hop_length)
    nfft = 2 * frame_size
    L = torch.fft.rfft(lf, nfft, dim=-1)
    R = torch.fft.rfft(rf, nfft, dim=-1)
    cross = torch.fft.irfft(L * R.conj(), nfft, dim=-1)
    l_auto = torch.fft.irfft(L * L.conj(), nfft, dim=-1)
    r_auto = torch.fft.irfft(R * R.conj(), nfft, dim=-1)
    max_cross = cross.abs().amax(dim=-1)
    denom = torch.sqrt(l_auto.amax(dim=-1) * r_auto.amax(dim=-1))
    ratio = torch.clamp(max_cross / torch.clamp(denom, min=1e-20), 0.0, 1.0)
    iacc = torch.where(denom > 1e-10, ratio, torch.zeros_like(ratio))
    return float(iacc.mean()), iacc


def compute_iacc_difference(predicted, gt, frame_size: int = 1024,
                            hop_length: int = 512):
    """-> (mean |IACC_pred − IACC_gt| per frame, mean IACC_pred,
    mean IACC_gt)."""
    n = min(predicted.shape[1], gt.shape[1])
    p_mean, p_vals = compute_iacc(predicted[:, :n], frame_size, hop_length)
    g_mean, g_vals = compute_iacc(gt[:, :n], frame_size, hop_length)
    m = min(p_vals.shape[0], g_vals.shape[0])
    diff = float(torch.mean((p_vals[:m] - g_vals[:m]).abs()))
    return diff, p_mean, g_mean


_ILD_WEIGHTS = np.array([0.5, 0.7, 1.0, 1.5, 1.5, 1.3])


def compute_ild_error(predicted, gt, frame_size: int = 1024,
                      hop_length: int = 512, sr: int = 22050):
    """Frequency-weighted ILD over six duplex-theory bands -> (mean |ILD
    error| dB, mean ILD_pred, mean ILD_gt)."""
    predicted, gt = _f64(predicted), _f64(gt)
    n = min(predicted.shape[1], gt.shape[1])
    predicted, gt = predicted[:, :n], gt[:, :n]
    nyq = sr / 2
    bands = [(0, 500), (500, 1000), (1000, 1500), (1500, 3000), (3000, 6000),
             (6000, nyq)]
    weights = _ILD_WEIGHTS / _ILD_WEIGHTS.sum()
    freqs = np.fft.rfftfreq(frame_size, 1 / sr)
    masks, kept = [], []
    for (lo, hi), w in zip(bands, weights):
        m = (freqs >= lo) & (freqs < hi)
        if m.any():
            masks.append(m)
            kept.append(w)
    band = _const(np.stack(masks, axis=1), predicted)  # (bins, bands)
    kept = _const(kept, predicted)
    window = _const(np.hanning(frame_size), predicted)

    def weighted_ild(sig):
        lf = _frames(sig[0], frame_size, hop_length) * window
        rf = _frames(sig[1], frame_size, hop_length) * window
        le = (torch.fft.rfft(lf, dim=-1).abs() ** 2) @ band
        re = (torch.fft.rfft(rf, dim=-1).abs() ** 2) @ band
        eps = 1e-10
        return (kept * 10 * torch.log10((le + eps) / (re + eps))).sum(-1)

    p = weighted_ild(predicted)
    g = weighted_ild(gt)
    return (float(torch.mean((p - g).abs())), float(torch.mean(p)),
            float(torch.mean(g)))


def compute_itd_error(predicted, gt, frame_size: int = 1024,
                      hop_length: int = 512, sr: int = 22050):
    """GCC-PHAT ITD within ±1 ms with parabolic interpolation -> (mean
    |ITD error| samples, the same in ms, mean ITD_pred, mean ITD_gt)."""
    predicted, gt = _f64(predicted), _f64(gt)
    n = min(predicted.shape[1], gt.shape[1])
    predicted, gt = predicted[:, :n], gt[:, :n]
    max_itd = int(0.001 * sr)
    window = _const(np.hanning(frame_size), predicted)

    def gcc_itd(sig):
        lf = _frames(sig[0], frame_size, hop_length) * window
        rf = _frames(sig[1], frame_size, hop_length) * window
        nfft = 2 * frame_size
        L = torch.fft.fft(lf, nfft, dim=-1)
        R = torch.fft.fft(rf, nfft, dim=-1)
        cross = L * R.conj()
        phat = cross / (cross.abs() + 1e-10)
        g = torch.fft.ifft(phat, dim=-1).real
        # zero lag at the centre
        g = torch.cat([g[:, nfft // 2:], g[:, :nfft // 2]], dim=-1)
        centre = nfft // 2
        lo, hi = centre - max_itd, centre + max_itd + 1
        peak = torch.argmax(g[:, lo:hi], dim=-1) + lo
        interior = (peak > 0) & (peak < g.shape[1] - 1)
        at = peak.clamp(1, g.shape[1] - 2)[:, None]
        a = g.gather(1, at - 1)[:, 0]
        b = g.gather(1, at)[:, 0]
        c = g.gather(1, at + 1)[:, 0]
        den = a - 2 * b + c
        curved = den.abs() > 1e-10
        shift = torch.where(curved, 0.5 * (a - c)
                            / torch.where(curved, den, torch.ones_like(den)),
                            torch.zeros_like(den))
        shift = torch.clamp(shift, -0.5, 0.5)
        lag = (peak - centre).to(F64)
        return torch.where(interior, lag + shift, lag)

    p = gcc_itd(predicted)
    g = gcc_itd(gt)
    err = float(torch.mean((p - g).abs()))
    return err, err / sr * 1000, float(torch.mean(p)), float(torch.mean(g))


# ---------------------------------------------------------------------------
# alignment + BSS Eval
# ---------------------------------------------------------------------------


def align_signals(gt, predicted, max_lag: int = 2205):
    """Estimate the lag on channel 0 by cross-correlation, shift the
    prediction, crop both to the common length -> (gt, predicted, lag)."""
    gt, predicted = _f64(gt), _f64(predicted)
    n = min(gt.shape[1], predicted.shape[1])
    g0, p0 = gt[0, :n], predicted[0, :n]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    corr = torch.fft.irfft(torch.fft.rfft(g0, nfft)
                           * torch.fft.rfft(p0, nfft).conj(), nfft)
    corr = torch.cat([corr[-max_lag:], corr[:max_lag + 1]])
    lag = int(torch.argmax(corr)) - max_lag
    if lag > 0:
        gt_a, pred_a = gt[:, lag:], predicted
    elif lag < 0:
        gt_a, pred_a = gt, predicted[:, -lag:]
    else:
        gt_a, pred_a = gt, predicted
    m = min(gt_a.shape[1], pred_a.shape[1])
    return gt_a[:, :m], pred_a[:, :m], lag


def _project(ref_group: torch.Tensor, est: torch.Tensor,
             flen: int) -> torch.Tensor:
    """Least-squares projection of ``est`` onto the span of ``flen``-tap
    delayed versions of each row of ``ref_group`` (BSS Eval v3 core).

    The normal equations G h = d have block-Toeplitz G: block (i, j) holds
    ``cc_ij[(a - b) mod nfft]`` at (a, b), with cc_ij the circular
    cross-correlation of references i and j (one gather for all blocks).
    The filtered references are summed in the frequency domain."""
    nsrc, n = ref_group.shape
    nfft = int(2 ** np.ceil(np.log2(n + flen - 1)))
    RF = torch.fft.rfft(ref_group, nfft, dim=1)
    EF = torch.fft.rfft(est, nfft)

    cc = torch.fft.irfft(RF[:, None, :] * RF[None, :, :].conj(), nfft, dim=-1)
    lags = torch.arange(flen, device=est.device)
    idx = (lags[:, None] - lags[None, :]) % nfft
    G = cc[:, :, idx].permute(0, 2, 1, 3).reshape(nsrc * flen, nsrc * flen)
    d = torch.fft.irfft(RF.conj() * EF, nfft, dim=-1)[:, :flen].reshape(-1)

    eye = torch.eye(G.shape[0], dtype=F64, device=G.device)
    try:
        h = torch.linalg.solve(G + 1e-10 * eye, d)
    except torch.linalg.LinAlgError:
        # rank-deficient: the least-norm solution (rtol as numpy's
        # lstsq(rcond=None)); on CUDA, lstsq solves full-rank systems only
        h = torch.linalg.pinv(G) @ d
    HF = torch.fft.rfft(h.reshape(nsrc, flen), nfft, dim=1)
    return torch.fft.irfft((RF * HF).sum(0), nfft)[:n]


def _bss_ratios(s_true, e_interf, e_artif):
    """(SDR, SIR, SAR) in dB, as Python floats."""
    s2 = float(torch.sum(s_true ** 2))
    sdr = 10 * np.log10(
        s2 / max(float(torch.sum((e_interf + e_artif) ** 2)), 1e-20))
    sir = 10 * np.log10(s2 / max(float(torch.sum(e_interf ** 2)), 1e-20))
    sar = 10 * np.log10(float(torch.sum((s_true + e_interf) ** 2))
                        / max(float(torch.sum(e_artif ** 2)), 1e-20))
    return float(sdr), float(sir), float(sar)


def _bss_decompose(reference_sources, est, j_true, flen):
    """(s_true, e_interf, e_artif) of estimate ``est`` against true source
    ``j_true`` — the BSS Eval v3 decomposition."""
    s_true = _project(reference_sources[j_true:j_true + 1], est, flen)
    e_spat_plus = _project(reference_sources, est, flen)
    return s_true, e_spat_plus - s_true, est - e_spat_plus


def bss_eval_sources(reference_sources, estimated_sources, flen: int = 512,
                     compute_permutation: bool = True):
    """SDR / SIR / SAR per source -> (sdr, sir, sar, perm), float64 tensors
    and an int64 permutation on the inputs' device — mir_eval's
    ``bss_eval_sources``.

    ``compute_permutation=True`` scores every (estimate, true source) pair
    and returns the assignment with the highest mean SIR: ``perm[j]`` is
    the estimate assigned to true source ``j``, and ``sdr[j]`` ... score
    that pair; ValueError where no pairing has a finite mean SIR (the JAX
    function fails with an IndexError there).
    ``compute_permutation=False`` pins the identity pairing."""
    reference_sources = _f64(reference_sources)
    estimated_sources = _f64(estimated_sources)
    device = reference_sources.device
    nsrc = reference_sources.shape[0]

    def out(*rows):
        return tuple(torch.tensor(r, dtype=F64, device=device)
                     for r in rows)

    if not compute_permutation:
        scores = [_bss_ratios(*_bss_decompose(
            reference_sources, estimated_sources[j], j, flen))
            for j in range(nsrc)]
        sdr, sir, sar = zip(*scores)
        return (*out(sdr, sir, sar),
                torch.arange(nsrc, device=device))

    # the whole pairwise matrix: row = estimate, column = true source
    sdr_m = np.empty((nsrc, nsrc))
    sir_m = np.empty((nsrc, nsrc))
    sar_m = np.empty((nsrc, nsrc))
    for jest in range(nsrc):
        # the projection onto all references does not depend on the
        # candidate true source: once per estimate
        est = estimated_sources[jest]
        e_spat_plus = _project(reference_sources, est, flen)
        e_artif = est - e_spat_plus
        for jtrue in range(nsrc):
            s_true = _project(reference_sources[jtrue:jtrue + 1], est, flen)
            sdr_m[jest, jtrue], sir_m[jest, jtrue], sar_m[jest, jtrue] = (
                _bss_ratios(s_true, e_spat_plus - s_true, e_artif))
    best_perm, best_sir = None, -np.inf
    for p in itertools.permutations(range(nsrc)):
        mean_sir = np.mean([sir_m[p[j], j] for j in range(nsrc)])
        if mean_sir > best_sir:
            best_sir, best_perm = mean_sir, p
    if best_perm is None:  # e.g. a silent estimate: every SIR is NaN
        raise ValueError("no permutation has a finite mean SIR")
    perm = np.asarray(best_perm)
    idx = np.arange(nsrc)
    return (*out(sdr_m[perm, idx], sir_m[perm, idx], sar_m[perm, idx]),
            torch.as_tensor(perm, device=device))


def compute_sar_sir_sdr(predicted, gt, flen: int = 512):
    """-> (SAR, SIR, SDR), the means over the two channels.

    A numeric failure of the decomposition (``torch.linalg.LinAlgError``,
    ``ValueError``) scores (0, 0, 0), as the JAX package does; any other
    error, a fault of the device among them, propagates."""
    n = min(predicted.shape[1], gt.shape[1])
    try:
        sdr, sir, sar, _ = bss_eval_sources(gt[:, :n], predicted[:, :n], flen)
    except (torch.linalg.LinAlgError, ValueError) as e:
        print(f"Error computing SDR: {e}")
        return 0.0, 0.0, 0.0
    return float(sar.mean()), float(sir.mean()), float(sdr.mean())
