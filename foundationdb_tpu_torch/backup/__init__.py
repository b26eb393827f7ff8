"""Backup, restore and DR: the blob container, the backup agent and the
DR agent with the database lock.

Port of ``foundationdb_tpu/backup/__init__.py``.
"""
from .container import BlobContainer
from .agent import BackupAgent
from .dr import DRAgent, lock_database, unlock_database

__all__ = ["BlobContainer", "BackupAgent", "DRAgent",
           "lock_database", "unlock_database"]
