"""Tracing, profiling and metrics (SURVEY.md §5).

The reference's only observability is conditional ``Debug.WriteLine``
(~25 sites, e.g. QTMovieT.cs:105, AlacContext.cs:136).  Here:

  * ``trace_span`` — wall-clock span that also emits a
    ``jax.profiler.TraceAnnotation`` so device timelines captured with
    ``start_trace`` show the pipeline stages;
  * ``DecodeStats`` — process-wide counters (frames, samples, bytes,
    host-parse seconds and device-result *wait* seconds) with Msamples/s
    derivation;
  * ``capture_trace`` — context manager around
    ``jax.profiler.start_trace/stop_trace`` for one-off captures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

logger = logging.getLogger("alacnet_tpu")


@dataclasses.dataclass
class DecodeStats:
    """Cumulative decode counters (thread-safe)."""

    frames: int = 0
    samples: int = 0
    coded_bytes: int = 0
    #: Host wall-clock spent *blocked on* device results (the np.asarray
    #: sync).  Includes the D2H transfer; it is NOT pure device compute
    #: time (use ``capture_trace`` for an on-device timeline).
    result_wait_seconds: float = 0.0
    host_seconds: float = 0.0
    dispatches: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def record(
        self,
        frames: int = 0,
        samples: int = 0,
        coded_bytes: int = 0,
        result_wait_seconds: float = 0.0,
        host_seconds: float = 0.0,
    ) -> None:
        with self._lock:
            self.frames += frames
            self.samples += samples
            self.coded_bytes += coded_bytes
            self.result_wait_seconds += result_wait_seconds
            self.host_seconds += host_seconds
            self.dispatches += 1

    @property
    def msamples_per_second(self) -> float:
        t = self.result_wait_seconds + self.host_seconds
        return self.samples / t / 1e6 if t > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "frames": self.frames,
                "samples": self.samples,
                "coded_bytes": self.coded_bytes,
                "result_wait_seconds": round(self.result_wait_seconds, 6),
                "host_seconds": round(self.host_seconds, 6),
                "dispatches": self.dispatches,
                "msamples_per_second": round(self.msamples_per_second, 3),
            }

    def reset(self) -> None:
        with self._lock:
            self.frames = self.samples = self.coded_bytes = 0
            self.result_wait_seconds = self.host_seconds = 0.0
            self.dispatches = 0


#: Process-wide stats for the decode pipeline.
GLOBAL_STATS = DecodeStats()


@contextlib.contextmanager
def trace_span(name: str, stats_field: str | None = None):
    """Wall-clock + device-timeline span.

    ``stats_field``: 'result_wait_seconds' or 'host_seconds' to
    accumulate the elapsed time into GLOBAL_STATS.
    """
    import jax.profiler

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    logger.debug("span %s: %.3f ms", name, dt * 1e3)
    if stats_field == "result_wait_seconds":
        GLOBAL_STATS.record(result_wait_seconds=dt)
    elif stats_field == "host_seconds":
        GLOBAL_STATS.record(host_seconds=dt)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a device trace viewable in TensorBoard/XProf."""
    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
