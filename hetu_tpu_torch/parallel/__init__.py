"""Data parallelism over ``torch.distributed`` (the ported part of
``hetu_tpu/parallel``): the strategies, the collectives, partial reduce,
the batch-axis rules that ``Executor(dist_strategy=DataParallel())``
lowers by, and the ZeRO weight-update sharding (``zero``); of the elastic plane only
the flap-damping gate (``elastic.FlapDamper``).  ``ht.dist`` is this package, as in the JAX package."""
from .strategies import Strategy, DataParallel, ModelParallel
from . import collectives
from .collectives import CommGroup, new_group_comm
from .preduce import (PartialReduce, DistPartialReduce, preduce_mean,
                      preduce_scatter_mean)
from . import batch_axis
from .batch_axis import BatchAxis
from . import zero
from .zero import ZeroPlan, ZeroBucket
from . import elastic
from .elastic import FlapDamper
