"""FUSEE-managed disaggregated KV-cache serving layer on torch devices.

The public KV surface is the unified ``core.api.KVStore`` over
``DeviceBackend``; the device pool itself (kvpool.KVPool) is an internal
substrate.  Counterpart of the JAX package's ``serving/``.
"""
from .backend import DeviceBackend  # noqa: F401
from .engine import Request, ServeEngine  # noqa: F401
from .kvpool import PoolConfig  # noqa: F401
from .snapshot import EpochResult, snapshot_epoch, snapshot_epoch_np  # noqa
from . import slots  # noqa: F401
