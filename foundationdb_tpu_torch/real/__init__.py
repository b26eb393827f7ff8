"""Port of ``foundationdb_tpu/real/__init__.py``."""
from .transport import RealNetwork, RealProcess

__all__ = ["RealNetwork", "RealProcess"]
