"""Data Carousel, the trainer's half of ``repro/carousel``: fine-grained,
incremental data delivery (paper §3.1).

ColdStore (tape) -> Stager (async, hedged, retried) -> DiskCache
(bounded, prompt release) -> on-demand transform -> DeliveryIterator
(training batches as shards land).  The DDM glue (``carousel/ddm.py``)
and the discrete-event simulator belong to the service half and are not
ported.
"""
from repro_torch.carousel.storage import ColdStore, DiskCache, TapeFile  # noqa: F401
from repro_torch.carousel.stager import Stager  # noqa: F401
from repro_torch.carousel.delivery import DeliveryIterator  # noqa: F401
