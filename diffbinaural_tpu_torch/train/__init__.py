from .stabilizer import (
    LearningRateStabilizer,
    LossStabilizer,
    TrainingStabilizer,
)
from .stage1 import Stage1TrainState, make_stage1_train_step
