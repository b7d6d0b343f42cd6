"""Maintenance of a streaming engine (port of the host-side part of
``repro.search.durability``: the policy; the WAL, recovery and
replication wait for ROADMAP.md item 9)."""
from .policy import Decision, MaintenancePolicy, PolicyConfig

__all__ = ["Decision", "MaintenancePolicy", "PolicyConfig"]
