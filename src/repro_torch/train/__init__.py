from repro_torch.train.steps import TrainConfig, init_train_state, make_train_step
from repro_torch.train.trainer import SimulatedPreemption, TrainerConfig, train

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "SimulatedPreemption", "TrainerConfig", "train"]
