"""repro_torch.tc — the micro-benchmark suite, the device measurement of
the hand-written kernels' tiles, and the session that fronts them.

The counterpart of the parts of ``repro.tc`` that tile tuning needs; the
contraction (Ch. 6) layer is a later part of the port.
"""

from .device import DEVICE_KERNELS, DeviceRanked, DeviceSuite, device_key
from .session import PredictorSession
from .suite import MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite

__all__ = ["DEVICE_KERNELS", "DeviceRanked", "DeviceSuite", "device_key",
           "PredictorSession", "MicroBenchmark", "MicroBenchmarkKey",
           "MicroBenchmarkSuite"]
