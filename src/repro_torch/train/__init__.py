# Training layer on PyTorch: step assembly and the sharding of its state,
# optimizers, the billed data pipeline, checkpointing and the
# fault-tolerant driver loop.
from .checkpoint import latest_step, load_checkpoint, save_checkpoint
from .data import DataPipeline, ShardedTokenDataset
from .driver import DriverConfig, FailureInjector, TrainDriver
from .optim import Optimizer, OptimizerConfig, make_optimizer
from .trainer import (make_decode_step, make_prefill, make_train_step,
                      opt_state_sharding, train_state_shardings)

__all__ = ["make_train_step", "make_decode_step", "make_prefill",
           "train_state_shardings", "opt_state_sharding",
           "OptimizerConfig", "Optimizer", "make_optimizer",
           "ShardedTokenDataset", "DataPipeline",
           "save_checkpoint", "load_checkpoint", "latest_step",
           "DriverConfig", "TrainDriver", "FailureInjector"]
