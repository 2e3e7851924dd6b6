"""The paper's own evaluation network, ResNetv1-6 (Fig. 4), over its three
dataset shapes (``repro/configs/microai_resnet.py``): UCI-HAR (128 samples
x 9 channels, 6 classes), SMNIST and GTSRB."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.nn.module import resolve_device
from repro_torch.nn.resnet import ResNetV1_6


@dataclasses.dataclass(frozen=True)
class MicroAIDataset:
    name: str
    in_shape: Tuple[int, ...]     # per sample: (samples, channels) or (H, W, C)
    classes: int
    ndim: int


DATASETS = {
    "uci-har": MicroAIDataset("uci-har", (128, 9), 6, 1),
    "smnist": MicroAIDataset("smnist", (39, 13), 10, 1),
    "gtsrb": MicroAIDataset("gtsrb", (32, 32, 3), 43, 2),
}


def build_resnet(dataset: str = "uci-har", filters: int = 16, device=None) -> ResNetV1_6:
    """ResNetv1-6 for ``dataset`` at ``filters`` width, whose parameters
    :meth:`ResNetV1_6.init` puts on ``device`` (``cuda`` unless given)."""
    ds = DATASETS[dataset]
    return ResNetV1_6(in_channels=ds.in_shape[-1], filters=filters, classes=ds.classes,
                      ndim=ds.ndim, device=str(resolve_device(device)))
