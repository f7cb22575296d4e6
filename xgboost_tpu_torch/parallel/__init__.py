"""Data-parallel training across ranks (port of xgboost_tpu/parallel/).

``ProcessHistTreeGrower`` (process.py) grows one tree over row shards held
by several ranks (processes, or the threads of the in-memory backend),
reducing each level's histogram through the collective.  The reference's
in-process device mesh (``mesh.py``, ``grower.py``: ``n_devices > 1``) is
not ported: it needs more than one card (ROADMAP Queue 1 item 9).
"""
from .process import HostExchange, ProcessHistTreeGrower

__all__ = ["HostExchange", "ProcessHistTreeGrower"]
