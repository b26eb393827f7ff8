"""Operator tooling (the fdbcli/fdbbackup analog surface).

Port of ``foundationdb_tpu/tools/__init__.py``.
"""
