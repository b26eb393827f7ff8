"""Server roles of the transaction system.

Port of ``foundationdb_tpu/server/``, role by role. Ported so far: the typed
messages between roles (`messages.py`) and the resolver role
(`resolver.py`), which runs over the port's engines inside the port's
simulator. The master, proxies, tlogs, storage and the cluster assembly
are not ported yet.
"""
