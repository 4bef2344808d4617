from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             make_sharded_train_step, train)

__all__ = ["TrainConfig", "make_train_step", "make_sharded_train_step",
           "train"]
