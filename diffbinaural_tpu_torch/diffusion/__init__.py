from .gaussian import GaussianDiffusion, ModelPrediction
from .schedules import (
    DiffusionSchedule,
    cosine_beta_schedule,
    linear_alpha_schedule,
    linear_beta_schedule,
    make_schedule,
    sigmoid_beta_schedule,
)
