"""Data pipeline of the port (twin of ``hetu_tpu/data/``): datasets,
transforms, ``Dataloader`` and ``DataloaderOp``."""
from .dataloader import Dataloader, DataloaderOp, dataloader_op
from .datasets import (mnist, cifar10, cifar100, normalize_cifar,
                       convert_to_one_hot)
from . import transforms
from .transforms import (Compose, Normalize, RandomHorizontalFlip,
                         RandomCrop, Resize, CenterCrop)
