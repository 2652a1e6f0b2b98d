"""The paper's own system configuration (FUSEE testbed, §6.1).

Scaled-unit mapping used by the event-level simulator and its network cost
model (benchmarks/netmodel): the paper's testbed is 22 machines (5 MNs +
17 CNs), 56 Gbps ConnectX-3, ~2 us RTT.  The simulator executes *verbs* and
counts RTTs/bytes; the cost model turns those counts into seconds with these
constants so benchmark figures are comparable to the paper's.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FuseePaperConfig:
    # cluster (§6.1)
    num_mns: int = 5
    num_cns: int = 17
    clients_per_cn: int = 8
    # network model
    rtt_us: float = 2.0                 # one-sided verb round trip
    rpc_rtt_us: float = 6.0             # client<->master / ALLOC RPC
    link_gbps: float = 56.0             # per-RNIC bandwidth (IB FDR)
    mn_alloc_ops_per_s: float = 600_000.0   # weak MN cores: ALLOC handling cap
    # Clover metadata-server per-core capacity: an E5-2450 core handling an
    # index-update RPC (hash probe + allocation bookkeeping + reply).  250k
    # ops/s/core reproduces Fig. 2's 6-core saturation point.
    mdserver_ops_per_core_s: float = 250_000.0
    # KV workload defaults (§6.3)
    kv_size_bytes: int = 1024
    ycsb_keys: int = 100_000
    zipf_theta: float = 0.99
    # recovery (Table 1)
    reconnect_ms: float = 163.1
    # replication
    replication: int = 2
    index_replicas: int = 1             # comparison setting of §6.2/6.3
