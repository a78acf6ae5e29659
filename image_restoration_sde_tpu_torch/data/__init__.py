from . import imresize, io_utils, transforms
from .datasets import GTDataset, LQDataset, LQGTDataset, create_dataset
from .loader import EvalLoader, TrainLoader, create_dataloader

__all__ = [
    "imresize", "io_utils", "transforms",
    "GTDataset", "LQDataset", "LQGTDataset", "create_dataset",
    "EvalLoader", "TrainLoader", "create_dataloader",
]
