from .trace import TIMERS, StageTimers, device_trace, progress_line, span

__all__ = ["TIMERS", "StageTimers", "device_trace", "progress_line", "span"]
