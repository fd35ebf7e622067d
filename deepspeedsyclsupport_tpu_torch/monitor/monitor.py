"""Experiment monitors.

Port of ``deepspeedsyclsupport_tpu/monitor/monitor.py`` — ``Monitor`` +
the CSV / TensorBoard / W&B / JSONL backends and :class:`MonitorMaster`
(reference ``deepspeed/monitor/``). Same event contract:
``write_events([(name, value, global_step), ...])``, every name checked
against the telemetry event registry first. The scalar backends write on
``torch.distributed`` rank 0 only (every rank when no process group is
started); the JSONL backend — the flight recorder's disk sink — is
rank-local. TensorBoard and W&B warn and disable themselves when their
package is missing.
"""
import csv
import os
import threading
import urllib.parse
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


def csv_filename_for_event(name: str) -> str:
    """Reversible metric-name → filename mapping: percent-encoding keeps
    every distinct event name on a distinct file and
    :func:`event_for_csv_filename` inverts it exactly."""
    return urllib.parse.quote(name, safe="") + ".csv"


def event_for_csv_filename(fname: str) -> str:
    base = fname[:-4] if fname.endswith(".csv") else fname
    return urllib.parse.unquote(base)


class CsvMonitor(Monitor):
    """CSV backend (reference: ``monitor/csv_monitor.py``): one file per
    metric, ``step,value`` rows. Non-numeric event values are skipped with
    a warning, and files are flushed every ``flush_interval`` write
    batches — a preempted run keeps its metrics. The output directory is
    made at construction; a failure to make it raises."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.base = os.path.join(config.csv_output_path or "csv_logs",
                                 config.csv_job_name)
        os.makedirs(self.base, exist_ok=True)
        self.flush_interval = max(1, int(
            getattr(config, "csv_flush_interval", 10)))
        self._files = {}
        self._writes_since_flush = 0
        self._warned_bad_values = set()

    def _writer(self, name: str):
        if name not in self._files:
            path = os.path.join(self.base, csv_filename_for_event(name))
            f = open(path, "a", newline="")
            self._files[name] = (f, csv.writer(f))
        return self._files[name]

    def write_events(self, events: List[Event]) -> None:
        for name, value, step in events:
            try:
                value = float(value)
            except (TypeError, ValueError):
                if name not in self._warned_bad_values:
                    self._warned_bad_values.add(name)
                    logger.warning(
                        "CsvMonitor: non-numeric value %r for event %r; "
                        "skipped (further occurrences silenced)", value, name)
                continue
            f, w = self._writer(name)
            w.writerow([step, value])
        self._writes_since_flush += 1
        if self._writes_since_flush >= self.flush_interval:
            self.flush()

    def flush(self) -> None:
        self._writes_since_flush = 0
        for f, _ in self._files.values():
            f.flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            f.close()
        self._files.clear()


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


class TensorBoardMonitor(Monitor):
    """TensorBoard backend (reference: ``monitor/tensorboard.py``) through
    ``torch.utils.tensorboard``; warns and disables itself when no writer
    is importable."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.writer = None
        path = os.path.join(config.tensorboard_output_path or "tensorboard",
                            config.tensorboard_job_name)
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self.writer = SummaryWriter(log_dir=path)
        except Exception as e:  # pragma: no cover - env dependent
            logger.warning("tensorboard unavailable (%s); events dropped", e)
            self.enabled = False

    def write_events(self, events: List[Event]) -> None:
        if not self.writer:
            return
        for name, value, step in events:
            self.writer.add_scalar(name, float(value), step)

    def flush(self) -> None:
        if self.writer:
            self.writer.flush()

    def close(self) -> None:
        if self.writer:
            self.writer.close()


class WandbMonitor(Monitor):
    """Weights & Biases backend (reference: ``monitor/wandb.py``); warns
    and disables itself when ``wandb`` is not importable."""

    def __init__(self, config: Any):
        super().__init__(config)
        try:
            import wandb  # type: ignore

            wandb.init(project=config.wandb_project, entity=config.wandb_team,
                       group=config.wandb_group)
            self._wandb = wandb
        except Exception as e:  # pragma: no cover - env dependent
            logger.warning("wandb unavailable (%s); events dropped", e)
            self._wandb = None
            self.enabled = False

    def write_events(self, events: List[Event]) -> None:
        if not self._wandb:
            return
        for name, value, step in events:
            self._wandb.log({name: float(value)}, step=step)


def _process_rank() -> int:
    """The ``torch.distributed`` rank, 0 when no process group is
    started."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MonitorMaster(Monitor):
    """Fan-out to all enabled backends; only ``torch.distributed`` rank 0
    writes the scalar backends (reference: ``monitor/monitor.py``
    MonitorMaster rank gating), while the JSONL flight-recorder backend is
    rank-LOCAL by design.

    Every event batch is validated against the telemetry event-name registry
    first: names must match ``Group/name`` and be declared
    (``monitor/telemetry.py`` ``EVENT_NAMES``/``EVENT_PREFIXES``). Under
    strict mode (``DSTPU_STRICT_EVENTS=1``) an undeclared name raises;
    otherwise it warns once and passes through."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.monitors: List[Monitor] = []
        if _process_rank() == 0:
            if config.tensorboard_enabled:
                self.monitors.append(TensorBoardMonitor(config))
            if config.wandb_enabled:
                self.monitors.append(WandbMonitor(config))
            if config.csv_enabled:
                self.monitors.append(CsvMonitor(config))
        if getattr(config, "jsonl_enabled", False):
            self.monitors.append(JsonlMonitor(config))
        self.enabled = any(m.enabled for m in self.monitors)

    def write_events(self, events: List[Event]) -> None:
        events = check_events(events)
        for m in self.monitors:
            if m.enabled:
                m.write_events(events)

    def flush(self) -> None:
        for m in self.monitors:
            m.flush()

    def close(self) -> None:
        for m in self.monitors:
            m.close()
