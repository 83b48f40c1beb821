from .stabilizer import (
    LearningRateStabilizer,
    LossStabilizer,
    TrainingStabilizer,
)
from .stage1 import Stage1TrainState, make_stage1_train_step
from .stage2 import Stage2TrainState, make_stage2_train_step
