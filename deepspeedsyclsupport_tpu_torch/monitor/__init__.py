"""Observability of the port: the telemetry spine (flight recorder,
goodput, heartbeat, metrics), the monitors (CSV, TensorBoard, W&B, JSONL),
the MFU ledger's region registry and trace join, the offline pod report,
and request-time attribution for the serving plane."""
