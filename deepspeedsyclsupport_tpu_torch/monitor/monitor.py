"""Experiment monitors: the rank-local JSONL backend.

Port of ``deepspeedsyclsupport_tpu/monitor/monitor.py``'s
:class:`JsonlMonitor` (the flight recorder's disk sink, which the request
journal writes through) and its re-export of the resilience counters. The
scalar backends (CSV, TensorBoard, W&B) and ``MonitorMaster`` are not ported
yet (ROADMAP.md A.3.4).
"""
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.logging import logger
# the checkpoint writers, fault injection, the watchdog and the elastic
# agent import the counters from this module, as in the JAX package
from .telemetry import (ResilienceCounters, check_events,  # noqa: F401
                        resilience_counters)

Event = Tuple[str, Any, int]


class Monitor:
    def __init__(self, config: Any = None):
        self.config = config
        self.enabled = True

    def write_events(self, events: List[Event]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlMonitor(Monitor):
    """Rank-local structured JSONL backend — the flight recorder's disk sink.

    Unlike the scalar backends this one exists on EVERY rank (per-host
    telemetry is the point: stragglers and preemptions are per-host
    phenomena). Scalar events become ``{"kind": "metric", ...}`` lines;
    flight-recorder records (spans, compile events, memory samples, dump
    markers) are appended through :meth:`write_record` interleaved in arrival
    order. Lines are buffered and flushed every ``flush_interval`` records —
    ``dump()``/``flush()`` force-drains, which is what the preemption handler
    relies on."""

    def __init__(self, config: Any = None,
                 path: Optional[str] = None, flush_interval: int = 64):
        super().__init__(config)
        if path is None:
            if config is None or not getattr(config, "jsonl_enabled", False):
                raise ValueError("JsonlMonitor needs a path or a config with "
                                 "jsonl_enabled")
            from ..utils.podid import pod_rank

            path = os.path.join(
                config.jsonl_output_path or "telemetry_logs",
                config.jsonl_job_name,
                f"flightrec_rank{pod_rank()}.jsonl")
            flush_interval = getattr(config, "jsonl_flush_interval",
                                     flush_interval)
        self.path = path
        self.flush_interval = max(1, int(flush_interval))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._file = None
        self._recorder = None

    def attach_recorder(self, recorder) -> None:
        """Become the flight recorder's sink; subsequent scalar events are
        routed THROUGH the recorder (one ring, one stream) instead of being
        written directly."""
        if self._recorder is recorder:
            return
        self._recorder = recorder
        recorder.add_sink(self.write_record, flush=self.flush)

    # --------------------------------------------------------------- writing
    def write_events(self, events: List[Event]) -> None:
        if self._recorder is not None:
            for name, value, step in events:
                self._recorder.record("metric", name, step=step,
                                      value=_jsonable_value(value))
            return
        for name, value, step in events:
            self.write_record({"kind": "metric", "name": name,
                               "step": step,
                               "value": _jsonable_value(value)})

    def write_record(self, rec: Dict[str, Any]) -> None:
        import json

        try:
            line = json.dumps(rec, default=_json_default)
        except (TypeError, ValueError) as e:
            logger.warning("JsonlMonitor: unserializable record %r (%s); "
                           "skipped", rec.get("name"), e)
            return
        with self._lock:
            self._buf.append(line)
            should_flush = len(self._buf) >= self.flush_interval
        if should_flush:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._buf:
                return
            lines, self._buf = self._buf, []
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write("\n".join(lines) + "\n")
            self._file.flush()

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def _jsonable_value(value: Any) -> Any:
    """Scalar-ify device arrays / numpy scalars for JSON."""
    try:
        import json

        json.dumps(value)
        return value
    except (TypeError, ValueError):
        try:
            return float(value)
        except (TypeError, ValueError):
            return repr(value)


def _json_default(obj: Any) -> Any:
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)
