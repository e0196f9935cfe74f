"""Telemetry of the port: the disabled sink only, so that the serving
engine and the adapter cache keep their counter, gauge, histogram and span
calls. The sinks, exporters and ``make_telemetry`` of
``repro/obs`` are a later slice."""
from repro_torch.obs.telemetry import NULL, NullTelemetry

__all__ = ["NULL", "NullTelemetry"]
