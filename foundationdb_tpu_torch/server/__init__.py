"""Server roles of the transaction system.

Port of ``foundationdb_tpu/server/``, role by role. Ported so far: the typed
messages between roles (`messages.py`), the resolver role (`resolver.py`)
over the port's engines, the elastic resolver group (`reshard.py`), and
the static cluster of the reference's seed mode: the master (`master.py`),
proxies (`proxy.py`), the tlog and its log system (`tlog.py`,
`log_system.py`), storage servers (`storage.py`, with `disk_queue.py` and
`kvstore.py` for the durable branches), the ratekeeper (`ratekeeper.py`),
the system keyspace (`system_keys.py`), `wait_failure.py`, and the
assembly `cluster.py` (`ClusterConfig`, `Cluster`, `build_cluster`). The
dynamic cluster (coordinators, election, recruitment, recovery) is not
ported yet.
"""
