"""Distribution layer (``repro.parallel``): logical sharding rules on a
torch ``DeviceMesh``, the compressed all-reduce, and the channel-sharded
FIR filterbank."""
from .filterbank import precode_filterbank, sharded_filterbank

__all__ = ["precode_filterbank", "sharded_filterbank"]
