"""One entry point for the prediction stack: :class:`PredictorSession`.

The counterpart of ``repro.tc.session``'s device facet.  The session owns
the shared resources — the :class:`~repro_torch.tc.suite.
MicroBenchmarkSuite` and the :class:`~repro_torch.core.predict.TraceCache`
— and fronts the device measurement facet (:meth:`device_suite`) that the
tile tuner ranks through (:meth:`rank_device_tiles`).  The store,
size-parametric, contraction and chain facets are later parts of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.predict import TraceCache
from .suite import MicroBenchmarkSuite


class PredictorSession:
    """Owns the shared prediction resources and the device facet.

    ``repetitions`` configures a freshly built suite and conflicts with
    passing ``suite=`` (the suite owns its measurement protocol).
    """

    def __init__(self, *, suite: Optional[MicroBenchmarkSuite] = None,
                 cache: Optional[TraceCache] = None,
                 repetitions: Optional[int] = None):
        if suite is not None:
            if repetitions is not None and repetitions != suite.repetitions:
                raise ValueError(
                    f"repetitions={repetitions} conflicts with the supplied "
                    f"suite's repetitions={suite.repetitions}; pass one or "
                    f"the other")
            self.suite = suite
        else:
            self.suite = MicroBenchmarkSuite(
                repetitions=5 if repetitions is None else repetitions)
        self.cache = cache if cache is not None else TraceCache()
        self._device = None

    def device_suite(self, **kwargs):
        """This session's device measurement facet — a
        :class:`repro_torch.tc.device.DeviceSuite` over the shared suite,
        created on first use; ``kwargs`` configure that first
        construction (``device=``, ``passes=``, ``sweep_fn=``,
        ``transfer_measure_fn=``, ...)."""
        if self._device is None:
            from .device import DeviceSuite
            self._device = DeviceSuite(self.suite, **kwargs)
        elif kwargs:
            raise ValueError(
                "the session's device suite is already built; its "
                "configuration kwargs must go to the first device_suite "
                "call")
        return self._device

    def rank_device_tiles(self, kernel: str, problem: Sequence[int],
                          configs: Sequence[Sequence[int]], *,
                          stat: str = "med", transfer: bool = True,
                          itemsize: int = 4):
        """Rank kernel tile configs for one problem from measured device
        models, fastest-predicted total first — each entry carries the
        ``T_h2d + T_compute + T_d2h`` decomposition (see
        :meth:`repro_torch.tc.device.DeviceSuite.rank`).  ``kernel`` is a
        :data:`repro_torch.tc.device.DEVICE_KERNELS` name."""
        return self.device_suite().rank(kernel, problem, configs,
                                        stat=stat, transfer=transfer,
                                        itemsize=itemsize)
