"""Server roles of the transaction system.

Port of ``foundationdb_tpu/server/``, role by role: the typed messages
between roles (`messages.py`), the resolver role (`resolver.py`) over the
port's engines, the elastic resolver group (`reshard.py`), the master
(`master.py`), proxies (`proxy.py`), the tlog and its log system
(`tlog.py`, `log_system.py`), storage servers (`storage.py`, with
`disk_queue.py` and `kvstore.py` for the durable branches), the ratekeeper
(`ratekeeper.py`), the system keyspace (`system_keys.py`),
`wait_failure.py`, and the dynamic cluster's roles: coordinators
(`coordination.py`, `coordinated_state.py`), leader election
(`leader_election.py`), workers (`worker.py`), the cluster controller
(`cluster_controller.py`), the master's epoch recovery and data
distribution (`masterserver.py`), the team policy
(`replication_policy.py`) and the `\\xff/conf/` keys (`management.py`).
`cluster.py` assembles the static cluster (`build_cluster`) and the
dynamic one (`build_dynamic_cluster`).
"""
