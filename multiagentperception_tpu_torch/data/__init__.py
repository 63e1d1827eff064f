"""Data-loader registry (reference: ptsemseg/loader/__init__.py:6-14)."""

from multiagentperception_tpu_torch.data.airsim import AirsimDataset
from multiagentperception_tpu_torch.data.augmentations import get_composed_augmentations
from multiagentperception_tpu_torch.data.pipeline import DataLoader

LOADERS = {
    "airsim": AirsimDataset,
}


def get_loader(name: str):
    try:
        return LOADERS[name]
    except KeyError:
        raise KeyError(f"Dataset {name} not available") from None


__all__ = ["AirsimDataset", "DataLoader", "get_loader", "get_composed_augmentations"]
