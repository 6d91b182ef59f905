"""Cluster-of-BNGs: compose N instances into one audited, failover-
capable system (membership + carve plan + HA pairing + one front door).

A copy of `bng_tpu/cluster/` with its imports renamed.
"""

from .coordinator import ClusterCoordinator, InstanceEntity
from .handoff import HandoffManager, StateReceiver, StateSender
from .instance import InlineInstance, InstanceSpec, ProcessInstance
from .member import MemberRuntime, RemoteInstance
from .plan import (CarvedBlock, ClusterPlan, InstancePlan, elect_carver,
                   initial_plan, instance_for_mac, replan, steer_macs_u48)

__all__ = [
    "CarvedBlock", "ClusterCoordinator", "ClusterPlan", "HandoffManager",
    "InlineInstance", "InstanceEntity", "InstancePlan", "InstanceSpec",
    "MemberRuntime", "ProcessInstance", "RemoteInstance", "StateReceiver",
    "StateSender", "elect_carver", "initial_plan", "instance_for_mac",
    "replan", "steer_macs_u48",
]
