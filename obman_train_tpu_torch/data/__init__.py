from obman_train_tpu_torch.data.dataset import HandDataset
from obman_train_tpu_torch.data.loader import BatchLoader, ConcatLoader, collate
from obman_train_tpu_torch.data.queries import BaseQueries, TransQueries, get_trans_queries
from obman_train_tpu_torch.data.synthetic import SyntheticDataset

__all__ = [
    "BaseQueries",
    "BatchLoader",
    "ConcatLoader",
    "HandDataset",
    "SyntheticDataset",
    "TransQueries",
    "collate",
    "get_trans_queries",
]
