"""FUSEE core in torch: the region slab lives on a torch device, the client
protocol, scheduler and master stay plain host Python (see each module)."""
from .events import CRASHED, EXISTS, FULL, NOT_FOUND, OK, OpResult  # noqa: F401
from .heap import DMConfig, DMPool, INDEX_REGION, META_REGION  # noqa: F401
from .client import FuseeClient  # noqa: F401
from .master import Master, RecoveryStats  # noqa: F401
from .faults import (ClientCrashed, ClientHealth, ClusterError,  # noqa: F401
                     ClusterHealth, FaultEvent, FaultInjector, FaultPlan,
                     MNHealth, OrderedIndexDisabled, ProtocolViolation,
                     RegionLost, SchedulerStalled)
from . import ordered  # noqa: F401
from .ring import PlacementDirectory  # noqa: F401
from .rng import SimRng  # noqa: F401
from .sim import Scheduler, SimTrace, run_ops_concurrently  # noqa: F401
from .api import KVFuture, KVStore, Op, SimBackend  # noqa: F401
from .fleet import FleetEngine  # noqa: F401
from .store import FuseeCluster  # noqa: F401
from . import codec  # noqa: F401
from .codec import CodecError  # noqa: F401
