"""Dataset registry (counterpart of ``memotr_tpu/data/__init__.py``)."""
from __future__ import annotations

from ..config import cfg_get
from .loader import DataLoader


def build_dataset(config: dict, split: str):
    name = config["DATASET"]
    if name in ("DanceTrack", "SportsMOT"):
        from .dancetrack import build
    elif name in ("MOT17", "MOT17_SPLIT"):
        from .mot17 import build
    elif name == "BDD100K":
        from .bdd100k import build
    else:
        raise ValueError(f"Dataset {name} is not supported!")
    return build(config=config, split=split)


def build_dataloader(dataset, config: dict, shuffle: bool = True,
                     rank: int = 0, world_size: int = 1) -> DataLoader:
    return DataLoader(
        dataset=dataset,
        batch_size=config["BATCH_SIZE"],
        max_gts=cfg_get(config, "MAX_GTS"),
        num_workers=cfg_get(config, "NUM_WORKERS"),
        shuffle=shuffle,
        seed=config.get("SEED", 42),
        rank=rank,
        world_size=world_size,
        fixed_canvas=cfg_get(config, "FIXED_TRAIN_CANVAS"),
    )
