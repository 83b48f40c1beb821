"""The evaluation battery on float64 tensors — counterpart of
``diffbinaural_tpu/evaluation``, with the same exports."""

from .metrics import (
    MEL_RMSE_distance,
    STFT_RMSE_distance,
    STFT_phase_and_magnitude_RMSE_distance,
    Envelope_distance,
    calculate_snr,
    compute_iacc,
    compute_iacc_difference,
    compute_ild_error,
    compute_itd_error,
    compute_sar_sir_sdr,
    align_signals,
    bss_eval_sources,
)
from .mel_rmse import evaluate_mel_rmse_pair
