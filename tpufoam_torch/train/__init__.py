"""Surrogate training (the counterpart of tpufoam/train): block sampling,
the block dataset and the trainer."""

from .sampler import lhs_sample, sample_block_corners, gather_training_blocks
from .trainer import TrainConfig, TrainState, train_surrogate, mse_loss_1e6
from .dataset import BlockDataset, build_block_dataset

__all__ = ["BlockDataset", "TrainConfig", "TrainState", "build_block_dataset",
           "gather_training_blocks", "lhs_sample", "mse_loss_1e6",
           "sample_block_corners", "train_surrogate"]
