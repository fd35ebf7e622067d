"""Observability of the port: telemetry spine (serving plane), request-time
attribution and the JSONL monitor."""
